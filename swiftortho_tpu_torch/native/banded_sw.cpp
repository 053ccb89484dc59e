// Banded Smith-Waterman (host/CPU reference kernel).
//
// Same behavioral contract as swiftortho_tpu/ops/banded_sw.py (reference
// kswat_st, lib/fsearch.py:1357-1476): pseudo-affine gaps whose extend
// cost depends on the predecessor's winning direction, M>I>D tie
// priority, row-major first-max, augmented path statistics with the
// ceil(m/2) gap-open quirk, border walks to (0,0).
//
// Role in the framework: the CPU analog of the reference's RPython->C
// fsearch kernel (bin/find_hit.py:198-209) — used as the bench.py
// baseline and as a host fallback when no TPU is available.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libswnative.so banded_sw.cpp

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr int STAR = 0, DIAG = 1, DASH = 2, PIPE = 3;

struct Cell {
    int32_t h = 0;
    int8_t tr = STAR;
    int32_t idy = 0, aln = 0, mis = 0, gap = 0;
    int8_t op = -1;
    int32_t sti = 0, stj = 0;
};

}  // namespace

extern "C" {

// One pair. tok0 = column sequence (shorter suffix), tok1 = row sequence.
// out: [score, bi, bj, sti, stj, idy, aln, mis, gap]
void sw_align_one(const uint8_t* tok0, int32_t l0s,
                  const uint8_t* tok1, int32_t l1s,
                  const int8_t* sub256,  // 256x256 BLOSUM62
                  int32_t kbound, int32_t go, int32_t ge,
                  int32_t* out) {
    const int l0 = l0s + 1, l1 = l1s + 1;
    const int w = 2 * kbound + 2;  // slots d = -k-1 .. k
    // band rows: prev (i-1) and cur, indexed by slot = d + k + 1
    std::vector<Cell> prev(w), cur(w);

    auto border = [&](int i, int j) {
        Cell c;
        if (i == 0 && j >= 0 && j <= l0 - 1) {
            c.aln = c.mis = j;
            c.gap = (j + 1) / 2;
            c.op = (j > 0 && (j & 1)) ? 1 : -1;
        } else if (j == 0 && i > 0 && i <= l1 - 1) {
            c.aln = c.mis = i;
            c.gap = (i + 1) / 2;
            c.op = (i & 1) ? 0 : -1;
        }
        return c;
    };

    // init row i=0
    for (int s = 0; s < w; ++s) {
        int d = s - kbound - 1;
        int j = 0 + d;
        prev[s] = border(0, j);
    }

    int32_t best = 0, bi = 0, bj = 0;
    Cell bcell;

    for (int i = 1; i <= l1 - 1; ++i) {
        for (int s = 0; s < w; ++s) {
            int d = s - kbound - 1;
            int j = i + d;
            bool computed = (j >= 1) && (j <= l0 - 1) &&
                            (d >= -kbound) && (d <= kbound - 1);
            if (!computed) {
                cur[s] = border(i, j);
                continue;
            }
            // neighbors: diag prev[s], up prev[s+1], left cur[s-1]
            const Cell& dg = prev[s];
            const Cell& up = (s + 1 < w) ? prev[s + 1] : border(i - 1, j);
            const Cell& lf = cur[s - 1];

            uint8_t c1 = tok1[i - 1], c0 = tok0[j - 1];
            int32_t subv = sub256[(int)c1 * 256 + (int)c0];
            int32_t I = lf.h + (lf.tr == DASH ? ge : go);
            int32_t M = dg.h + subv;
            int32_t D = up.h + (up.tr == PIPE ? ge : go);
            int32_t B = std::max({0, I, M, D});
            Cell c;
            c.h = B;
            if (B == M) {
                c.tr = DIAG;
                bool eq = (c0 == c1);
                c.idy = dg.idy + (eq ? 1 : 0);
                c.aln = dg.aln + 1;
                c.mis = dg.mis + (eq ? 0 : 1);
                c.gap = dg.gap;
                c.op = -1;
                c.sti = dg.sti;
                c.stj = dg.stj;
            } else if (B == I) {
                c.tr = DASH;
                c.idy = lf.idy;
                c.aln = lf.aln + 1;
                c.mis = lf.mis + 1;
                if (lf.op != 1) { c.gap = lf.gap + 1; c.op = 1; }
                else            { c.gap = lf.gap;     c.op = -1; }
                c.sti = lf.sti;
                c.stj = lf.stj;
            } else if (B == D) {
                c.tr = PIPE;
                c.idy = up.idy;
                c.aln = up.aln + 1;
                c.mis = up.mis + 1;
                if (up.op != 0) { c.gap = up.gap + 1; c.op = 0; }
                else            { c.gap = up.gap;     c.op = -1; }
                c.sti = up.sti;
                c.stj = up.stj;
            } else {
                c.tr = STAR;
                c.op = -1;
                c.sti = i;
                c.stj = j;
            }
            cur[s] = c;
            if (B > best || (B == best && B > 0 &&
                             (i < bi || (i == bi && j < bj)))) {
                best = B; bi = i; bj = j; bcell = c;
            }
        }
        std::swap(prev, cur);
    }
    out[0] = best; out[1] = bi; out[2] = bj;
    out[3] = bcell.sti; out[4] = bcell.stj;
    out[5] = bcell.idy; out[6] = bcell.aln;
    out[7] = bcell.mis; out[8] = bcell.gap;
}

// Batch of pairs with padded (B, L0)/(B, L1) token arrays; pair-parallel
// over hardware threads.
void sw_align_batch(const uint8_t* tok0, const uint8_t* tok1,
                    const int32_t* len0, const int32_t* len1,
                    int32_t n_pairs, int32_t pad0, int32_t pad1,
                    const int8_t* sub256, int32_t kbound,
                    int32_t go, int32_t ge, int32_t* out /* (B,9) */) {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        int v = atoi(env);          // e.g. =1 for the bench baseline
        if (v > 0) nt = v;
    }
    if (nt < 1) nt = 1;
    if ((int32_t)nt > n_pairs) nt = n_pairs > 0 ? n_pairs : 1;
    auto work = [&](int32_t lo, int32_t hi) {
        for (int32_t p = lo; p < hi; ++p) {
            sw_align_one(tok0 + (int64_t)p * pad0, len0[p],
                         tok1 + (int64_t)p * pad1, len1[p],
                         sub256, kbound, go, ge, out + (int64_t)p * 9);
        }
    };
    if (nt == 1) {
        work(0, n_pairs);
        return;
    }
    std::vector<std::thread> threads;
    int32_t step = (n_pairs + nt - 1) / nt;
    for (unsigned t = 0; t < nt; ++t) {
        int32_t lo = t * step;
        int32_t hi = std::min(n_pairs, lo + step);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"

extern "C" {

// Fill padded pair rows: dst[row_idx[i], 0:counts[i]] = src[starts[i]:...],
// zeroing the tail. Threaded; used by the search driver's batch prep.
void gather_rows(const uint8_t* src, const int64_t* starts,
                 const int64_t* counts, const int64_t* row_idx,
                 int64_t n_rows, int64_t pad, uint8_t* dst) {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        int v = atoi(env);
        if (v > 0) nt = v;
    }
    if (nt < 1) nt = 1;
    if ((int64_t)nt > n_rows) nt = n_rows > 0 ? n_rows : 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            uint8_t* d = dst + row_idx[i] * pad;
            int64_t c = counts[i];
            if (c > pad) c = pad;
            memcpy(d, src + starts[i], c);
            memset(d + c, 0, pad - c);
        }
    };
    if (nt == 1) { work(0, n_rows); return; }
    std::vector<std::thread> threads;
    int64_t step = (n_rows + nt - 1) / nt;
    for (unsigned t = 0; t < nt; ++t) {
        int64_t lo = t * step, hi = std::min<int64_t>(n_rows, lo + step);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
