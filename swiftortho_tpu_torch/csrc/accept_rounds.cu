// The greedy cover chain of the device candidate engine, for Hopper
// (sm_90a): one thread walks one segment (a (query, subject, diagonal)
// group of points) in order.
//
// Replaces swiftortho_tpu/search/candidates_device.py:241 _accept_rounds,
// plain JAX and not a Pallas kernel (a jax.lax.while_loop of segmented
// scans, one round a group's accepted point), and its port
// swiftortho_tpu_torch/search/candidates_device.py::accept_rounds (the
// same rounds over two-level scans, one host read a round).  It returns
// what accept_rounds returns, bit for bit, without its rounds: a round
// accepts the first point of each segment that is still a candidate
// (valid and qst > the cover), and a point passed over never becomes one
// later, because the cover only grows.  So the accepted points of a
// segment are those one pass in order accepts; the cover at a point is the
// max E over the accepted points before it (-1 before the first), which
// is qlo_rec; and the number of rounds is the largest number of points one
// segment accepts.  Points not accepted get acc = 0 and qlo_rec = 0, the
// plain version's values; so do points before the first flag, which the
// rounds never accept.  Integers only.
//
// Bound.  The bytes: each point's two flags read once, qst read for a
// valid point and E for an accepted one (int32, the JAX reference's
// width), acc and qlo_rec (int32) written once: 7 bytes a point, and 4
// more a valid point and 4 more an accepted one, over the memory rate.
// A segment's thread runs its points one after another, so a warp runs as
// long as its longest segment, and its loads are not coalesced (each
// thread reads its own run of points).  A later design could give a warp
// to a segment (a shuffle scan of the cover), or coalesce through shared
// memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
accept_rounds_kernel(const uint8_t* __restrict__ new_seg,
                     const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ qst,
                     const int32_t* __restrict__ e_end, int64_t C,
                     uint8_t* __restrict__ acc,
                     int32_t* __restrict__ qlo_rec,
                     int32_t* __restrict__ rounds) {
    const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (p >= C || (p > 0 && !new_seg[p])) return;
    // points before the first flag form a segment from which the rounds
    // never accept (their scanned segment base is -1): a cover above
    // every qst keeps them out
    int32_t cov = new_seg[p] ? -1 : INT32_MAX;
    int n = 0;
    for (int64_t i = p; i < C && (i == p || !new_seg[i]); ++i) {
        if (valid[i] && qst[i] > cov) {
            acc[i] = 1;
            qlo_rec[i] = cov;
            const int32_t e = e_end[i];
            cov = e > cov ? e : cov;
            ++n;
        } else {
            acc[i] = 0;
            qlo_rec[i] = 0;
        }
    }
    if (n > 0) atomicMax(rounds, n);
}

}  // namespace

extern "C" {

// The accept rounds of C points on `stream`.  new_seg, valid (C) bool
// (one byte, 0 or 1); qst, E (C) int32; acc (C) bool and qlo_rec (C)
// int32 written; rounds one int32 that the caller zeroed, raised to the
// largest count of points a segment accepts.  Allocates nothing and does
// not synchronise; returns cudaGetLastError().
int swt_accept_rounds(const void* new_seg, const void* valid,
                      const void* qst, const void* e_end, long long C,
                      void* acc, void* qlo_rec, void* rounds, void* stream) {
    if (C <= 0) return (int)cudaGetLastError();
    const dim3 grid((unsigned)((C + THREADS - 1) / THREADS));
    accept_rounds_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(new_seg),
        static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(qst), static_cast<const int32_t*>(e_end),
        (int64_t)C, static_cast<uint8_t*>(acc),
        static_cast<int32_t*>(qlo_rec), static_cast<int32_t*>(rounds));
    return (int)cudaGetLastError();
}

}  // extern "C"
