// One-direction x-drop walks of the device candidate engine, for Hopper
// (sm_90a): one thread walks one point until its own x-drop.
//
// Replaces swiftortho_tpu/search/candidates_device.py::_walk_chunked, plain
// JAX and not a Pallas kernel, and its port
// swiftortho_tpu_torch/search/candidates_device.py::walk_chunked (torch
// cumsum/cummax over (points, 64) chunks, one host read per chunk).  It
// returns what walk_chunked returns, bit for bit (ungap semantics,
// fsearch.py:2454-2494): from (start_q, start_s) step by `step` (+1 or -1);
// a step is in bounds when qlo < q < qlen and slo < s < slen, and the walk
// stops before the first step that is not, so no byte out of range is
// read; each step adds the BLOSUM62 score of its two bytes to an int32
// running sum that starts at `base`; `best` is the largest sum seen (at
// least `base`) and `best_t` the first step that reached it (strictly
// greater, -1 if none beat `base`); the walk stops after the first step
// whose sum falls more than XDROP below the running max, and after at most
// `wmax` steps.  The running max before step t is max(base, sums before t),
// which is `best`: every step walked so far was in bounds (and XDROP >= 0,
// so a step that raises `best` never ends the walk).  The bounds are also
// held inside the rows, q in [0, L) and s >= 0, as every caller's bounds
// already are (qlen <= L; qlo, slo >= -1 or a walk that only rises).
//
// Scores come from the banded SW kernel's table (ops/banded_sw.py::
// scoring_tables(dev)['codes']): BYTE2CODE, then the 32x32 B62_CODES, 5 KB
// staged in shared memory once a block; it gives B62_BYTES' score for
// every byte pair.
//
// Bound.  A step is a few integer operations on two dependent byte
// gathers (query row, subject), so a walk is latency-bound: each step
// waits for its two loads (L2 hits, as the query batch and the reference
// tokens fit the 50 MB L2), and the loop cannot load ahead past its own
// bounds check.  Walks of unequal length diverge inside a warp: a warp
// runs as long as its longest walk, and most walks end within a few dozen
// steps.  A later design could load 4- or 16-byte words of both rows ahead
// of the bounds check (clamped to the row), sort points by their expected
// length so that a warp's walks end together, or give the long walks a
// warp each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NBYTES = 256;
constexpr int NCODES = 32;

__global__ void __launch_bounds__(THREADS)
xdrop_walk_kernel(const uint8_t* __restrict__ qtok,
                  const uint8_t* __restrict__ db,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ qrow,
                  const int64_t* __restrict__ s_off,
                  const int32_t* __restrict__ start_q,
                  const int32_t* __restrict__ start_s,
                  const int32_t* __restrict__ base,
                  const int32_t* __restrict__ qlo,
                  const int32_t* __restrict__ slo,
                  const int32_t* __restrict__ qlen,
                  const int32_t* __restrict__ slen,
                  int P, int L, int step, int wmax, int xdrop,
                  int32_t* __restrict__ best_out,
                  int32_t* __restrict__ best_t_out,
                  int32_t* __restrict__ steps_out) {
    __shared__ int32_t code[NBYTES];
    __shared__ int32_t sub[NCODES * NCODES];
    for (int i = threadIdx.x; i < NBYTES; i += THREADS)
        code[i] = table[i];
    for (int i = threadIdx.x; i < NCODES * NCODES; i += THREADS)
        sub[i] = table[NBYTES + i];
    __syncthreads();
    const int p = blockIdx.x * THREADS + threadIdx.x;
    if (p >= P) return;

    const uint8_t* qr = qtok + (int64_t)qrow[p] * L;
    const uint8_t* sr = db + s_off[p];
    const int ql = max(qlo[p], -1), qh = min(qlen[p], L);
    const int sl = max(slo[p], -1), sh = slen[p];
    int q = start_q[p], s = start_s[p];
    int sum = base[p], best = sum, bt = -1, t = 0;
    for (; t < wmax; ++t, q += step, s += step) {
        if (!(ql < q && q < qh && sl < s && s < sh)) break;
        sum += sub[code[qr[q]] * NCODES + code[sr[s]]];
        if (sum > best) {
            best = sum;
            bt = t;
        } else if (sum + xdrop < best) {
            ++t;                                // the ending step counts
            break;
        }
    }
    best_out[p] = best;
    best_t_out[p] = bt;
    if (steps_out) steps_out[p] = t;
}

}  // namespace

extern "C" {

// Walk P points on `stream`.  qtok (B*L) and db (N) uint8; table int32
// [256 + 32*32] (byte->code map, then the code-space BLOSUM62); per point
// qrow, start_q, start_s, base, qlo, slo, qlen, slen int32 and s_off
// int64; best, best_t (P) int32, and steps (P) int32 or null: the steps
// each walk read.  Allocates nothing and does not synchronise; returns
// cudaGetLastError().
int swt_xdrop_walk(const void* qtok, const void* db, const void* table,
                   const void* qrow, const void* s_off, const void* start_q,
                   const void* start_s, const void* base, const void* qlo,
                   const void* slo, const void* qlen, const void* slen,
                   int P, int L, int step, int wmax, int xdrop, void* best,
                   void* best_t, void* steps, void* stream) {
    if (P <= 0) return (int)cudaGetLastError();
    if (step != 1 && step != -1) return (int)cudaErrorInvalidValue;
    auto i32 = [](const void* x) {
        return static_cast<const int32_t*>(x);
    };
    const dim3 grid((unsigned)((P + THREADS - 1) / THREADS));
    xdrop_walk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(qtok), static_cast<const uint8_t*>(db),
        i32(table), i32(qrow), static_cast<const int64_t*>(s_off),
        i32(start_q), i32(start_s), i32(base), i32(qlo), i32(slo), i32(qlen),
        i32(slen), P, L, step, wmax, xdrop, static_cast<int32_t*>(best),
        static_cast<int32_t*>(best_t), static_cast<int32_t*>(steps));
    return (int)cudaGetLastError();
}

}  // extern "C"
