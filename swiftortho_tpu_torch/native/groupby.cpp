// Posting expansion + (query, subject, diagonal) grouping for the
// candidate stage — the native counterpart of the numpy block in
// search/candidates.py (reference semantics: fsearch.py:2679-2691, the
// per-query dict keyed by (subject, diagonal) with per-(group, qst)
// dedup of seed points, fsearch.py:554-556 / :2696).
//
// Semantics (must match the numpy path exactly):
//  - expand each kept seed's CSR posting range into (sid, diag, qst)
//    entries, diag = qst - sst;
//  - order entries by (qrow asc, sid asc, diag asc, qst asc); relative
//    order among full duplicates is irrelevant (they are deduped);
//  - drop entries equal to their predecessor in (qrow, sid, diag, qst);
//  - a group = a maximal run of equal (qrow, sid, diag).
//
// Parallelism: queries are independent; threads take contiguous qrow
// ranges balanced by posting counts.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

#if defined(__AVX512BW__) && defined(__AVX512VL__)
#include <immintrin.h>
#define SW_SIMD_WALK 1
#endif

namespace {

struct Entry {
    int32_t sid;
    int32_t diag;
    int32_t qst;
};

inline bool entry_less(const Entry& a, const Entry& b) {
    if (a.sid != b.sid) return a.sid < b.sid;
    if (a.diag != b.diag) return a.diag < b.diag;
    return a.qst < b.qst;
}

unsigned n_threads() {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        long v = atol(env);
        if (v > 0) nt = (unsigned)v;
    }
    if (nt == 0) nt = 1;
    return nt;
}

// LSD radix sort for packed 56-bit (sid, diag, qst) keys: 4 passes of
// 14 bits.  tmp must have n slots; hist is caller-provided per-thread
// scratch of 4 * 16384 counters.  ~2-3x a comparison sort at the
// per-query sizes the candidate engine sees (hundreds to thousands).
void radix56(uint64_t* a, uint64_t* tmp, int64_t n, int64_t* hist) {
    constexpr int RB = 14;
    constexpr int64_t NB = 1 << RB;
    std::memset(hist, 0, sizeof(int64_t) * NB * 4);
    int64_t* h[4] = {hist, hist + NB, hist + 2 * NB, hist + 3 * NB};
    for (int64_t i = 0; i < n; i++) {
        const uint64_t v = a[i];
        h[0][v & (NB - 1)]++;
        h[1][(v >> RB) & (NB - 1)]++;
        h[2][(v >> 2 * RB) & (NB - 1)]++;
        h[3][(v >> 3 * RB) & (NB - 1)]++;
    }
    uint64_t* src = a;
    uint64_t* dst = tmp;
    for (int p = 0; p < 4; p++) {
        int64_t sum = 0;
        for (int64_t b = 0; b < NB; b++) {
            const int64_t c = h[p][b];
            h[p][b] = sum;
            sum += c;
        }
        for (int64_t i = 0; i < n; i++)
            dst[h[p][(src[i] >> p * RB) & (NB - 1)]++] = src[i];
        std::swap(src, dst);
    }
    // 4 passes: result is back in `a`
}

#ifdef SW_SIMD_WALK
// ---- AVX-512 x-drop walks -------------------------------------------
// Bit-identical to the scalar walk loops in the chain sweep below
// (reference ungap semantics, fsearch.py:2454-2494): 16 steps per
// iteration — masked byte loads (fault-suppressed, so array-edge
// blocks never read out of bounds), i32 gather from a padded copy of
// the substitution table, in-register prefix-sum + inclusive max-scan,
// and a mask scan for the reference's stop-after-the-breaking-step
// rule.  SWNATIVE_NO_SIMD=1 forces the scalar path (A/B + debugging).
// tabpad must have 65536 + >=4 readable bytes (gather reads 4 bytes).

// inclusive prefix-sum / max-scan over 16 i32 lanes
static inline __m512i sw_prefix_add(__m512i v) {
    const __m512i z = _mm512_setzero_si512();
    v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, z, 16 - 1));
    v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, z, 16 - 2));
    v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, z, 16 - 4));
    v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, z, 16 - 8));
    return v;
}

static inline __m512i sw_scan_max(__m512i v) {
    const __m512i ninf = _mm512_set1_epi32(INT32_MIN);
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 1));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 2));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 4));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 8));
    return v;
}

// one walk block: scores g (lanes >= nv forced to -2^26 so the walk
// stops at the first invalid lane), running-score carry, best so far.
// Returns kstop (16 = no stop), updates *carry/*best and, when track
// is true, *best_lane (first lane achieving the new best, -1 if none).
static inline int sw_walk_block(__m512i g, int nv, int32_t xdrop,
                                int32_t* carry, int32_t* best,
                                int* best_lane) {
    const __m512i sums =
        _mm512_add_epi32(sw_prefix_add(g), _mm512_set1_epi32(*carry));
    const __m512i runmax = _mm512_max_epi32(
        sw_scan_max(sums), _mm512_set1_epi32(*best));
    const __mmask16 stopm = _mm512_cmplt_epi32_mask(
        _mm512_add_epi32(sums, _mm512_set1_epi32(xdrop)), runmax);
    const int kstop = (int)_tzcnt_u32((uint32_t)stopm | 0x10000u);
    const int nexec = kstop < nv ? kstop + 1 : nv;
    const __mmask16 execm = (__mmask16)((1u << nexec) - 1);
    const int32_t bmax = _mm512_mask_reduce_max_epi32(execm, sums);
    if (best_lane) *best_lane = -1;
    if (bmax > *best) {
        *best = bmax;
        if (best_lane) {
            const __mmask16 eqm = _mm512_mask_cmpeq_epi32_mask(
                execm, sums, _mm512_set1_epi32(bmax));
            *best_lane = (int)_tzcnt_u32((uint32_t)eqm);
        }
    }
    if (kstop >= 16) {
        alignas(64) int32_t lanes[16];
        _mm512_store_si512((__m512i*)lanes, sums);
        *carry = lanes[15];
    }
    return kstop;
}

static inline __m512i sw_gather_scores(__m128i qb, __m128i sb,
                                       __mmask16 lanem,
                                       const int8_t* tabpad) {
    const __m512i qi = _mm512_cvtepu8_epi32(qb);
    const __m512i si = _mm512_cvtepu8_epi32(sb);
    const __m512i idx = _mm512_or_si512(_mm512_slli_epi32(qi, 8), si);
    __m512i g = _mm512_i32gather_epi32(idx, (const void*)tabpad, 1);
    g = _mm512_srai_epi32(_mm512_slli_epi32(g, 24), 24);  // low byte
    return _mm512_mask_mov_epi32(_mm512_set1_epi32(-(1 << 26)), lanem,
                                 g);
}

// right walk: steps t = 0..T-1 at qtok[p + t] / stok[s0 + t].
// Returns best (>= 0); *o_max_qed = query pos of the first best > 0.
static int32_t sw_walk_right(const uint8_t* qtok, const uint8_t* stok,
                             int64_t p, int64_t s0, int64_t T,
                             const int8_t* tabpad, int32_t xdrop,
                             int64_t* o_max_qed, int64_t* blk,
                             int64_t* steps) {
    int32_t best = 0, carry = 0;
    int64_t max_qed = p;
    for (int64_t t = 0; t < T; t += 16) {
        if (blk) (*blk)++;
        const int nv = (int)std::min<int64_t>(16, T - t);
        const __mmask16 lm =
            (__mmask16)(nv >= 16 ? 0xFFFFu : ((1u << nv) - 1));
        const __m128i qb =
            _mm_maskz_loadu_epi8(lm, (const void*)(qtok + p + t));
        const __m128i sb =
            _mm_maskz_loadu_epi8(lm, (const void*)(stok + s0 + t));
        const __m512i g = sw_gather_scores(qb, sb, lm, tabpad);
        int lane;
        const int kstop = sw_walk_block(g, nv, xdrop, &carry, &best,
                                        &lane);
        // executed-lane count, comparable with the scalar path's
        // per-iteration rsteps (SWNATIVE_NO_SIMD A/B parity of the
        // [fused prof] line)
        if (steps) *steps += kstop < nv ? kstop + 1 : nv;
        if (lane >= 0) max_qed = p + t + lane;
        if (kstop < nv) break;
        if (nv < 16) break;
    }
    *o_max_qed = max_qed;
    return best;
}

// left walk: steps t = 0..T-1 at qtok[p0 - t] / stok[sp0 - t], seeded
// with the right walk's best (both carry and max start there).
static int32_t sw_walk_left(const uint8_t* qtok, const uint8_t* stok,
                            int64_t p0, int64_t sp0, int64_t T,
                            const int8_t* tabpad, int32_t xdrop,
                            int32_t seed_best, int64_t* blk,
                            int64_t* steps) {
    static const __m128i rev16 = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7,
                                              8, 9, 10, 11, 12, 13, 14,
                                              15);
    int32_t best = seed_best, carry = seed_best;
    for (int64_t t = 0; t < T; t += 16) {
        if (blk) (*blk)++;
        const int nv = (int)std::min<int64_t>(16, T - t);
        // bytes [hi-15 .. hi] loaded ascending, then byte-reversed so
        // lane i is walk step t + i; invalid (low) bytes masked out of
        // the load (fault-suppressed) and land at lanes >= nv
        const __mmask16 loadm =
            (__mmask16)(nv >= 16 ? 0xFFFFu : (0xFFFFu << (16 - nv)));
        const __mmask16 lanem =
            (__mmask16)(nv >= 16 ? 0xFFFFu : ((1u << nv) - 1));
        const __m128i qb = _mm_shuffle_epi8(
            _mm_maskz_loadu_epi8(loadm,
                                 (const void*)(qtok + p0 - t - 15)),
            rev16);
        const __m128i sb = _mm_shuffle_epi8(
            _mm_maskz_loadu_epi8(loadm,
                                 (const void*)(stok + sp0 - t - 15)),
            rev16);
        const __m512i g = sw_gather_scores(qb, sb, lanem, tabpad);
        const int kstop = sw_walk_block(g, nv, xdrop, &carry, &best,
                                        nullptr);
        if (steps) *steps += kstop < nv ? kstop + 1 : nv;
        if (kstop < nv) break;
        if (nv < 16) break;
    }
    return best;
}
#endif  // SW_SIMD_WALK

}  // namespace

extern "C" {

// Inputs (per kept seed): rows/qst/counts/starts, n_seeds of each;
// sid/sst: the index posting arrays (int32).  n_qrows bounds rows[].
// Outputs: o_qst (>= total entries), o_grp_start / o_grp_size /
// o_g_qrow / o_g_sid / o_g_diag (>= total), out_n[2] = {n_dedup,
// n_groups}.  grp_start indexes into the deduped o_qst array.
void expand_group(const int64_t* rows, const int64_t* qst,
                  const int64_t* counts, const int64_t* starts,
                  int64_t n_seeds, const int32_t* sid, const int32_t* sst,
                  int64_t n_qrows,
                  int64_t* o_qst, int64_t* o_grp_start,
                  int64_t* o_grp_size, int64_t* o_g_qrow,
                  int64_t* o_g_sid, int64_t* o_g_diag, int64_t* out_n) {
    // seeds grouped by qrow (stable counting sort; order within a qrow
    // only affects full-duplicate entries, which are deduped anyway)
    std::vector<int64_t> qcnt(n_qrows + 1, 0);     // postings per qrow
    std::vector<int64_t> scnt(n_qrows + 1, 0);     // seeds per qrow
    for (int64_t i = 0; i < n_seeds; i++) {
        qcnt[rows[i] + 1] += counts[i];
        scnt[rows[i] + 1] += 1;
    }
    for (int64_t q = 0; q < n_qrows; q++) {
        qcnt[q + 1] += qcnt[q];
        scnt[q + 1] += scnt[q];
    }
    const int64_t total = qcnt[n_qrows];
    std::vector<int64_t> seed_of(n_seeds);         // seeds in qrow order
    {
        std::vector<int64_t> cur(scnt.begin(), scnt.end() - 1);
        for (int64_t i = 0; i < n_seeds; i++) seed_of[cur[rows[i]]++] = i;
    }

    std::vector<Entry> buf(total);
    std::vector<int64_t> ndedup(n_qrows, 0), ngroup(n_qrows, 0);

    // balanced qrow ranges by posting count
    unsigned nt = n_threads();
    if (nt > (unsigned)n_qrows && n_qrows > 0) nt = (unsigned)n_qrows;
    std::vector<int64_t> bounds(nt + 1, n_qrows);
    bounds[0] = 0;
    for (unsigned t = 1; t < nt; t++) {
        int64_t want = total * t / nt;
        bounds[t] = std::lower_bound(qcnt.begin(), qcnt.begin() + n_qrows,
                                     want) - qcnt.begin();
        if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
    }

    auto work = [&](int64_t qlo, int64_t qhi) {
        for (int64_t q = qlo; q < qhi; q++) {
            Entry* dst = buf.data() + qcnt[q];
            int64_t n = 0;
            for (int64_t s = scnt[q]; s < scnt[q + 1]; s++) {
                const int64_t i = seed_of[s];
                const int64_t st = starts[i], c = counts[i];
                const int32_t qp = (int32_t)qst[i];
                for (int64_t k = 0; k < c; k++) {
                    dst[n].sid = sid[st + k];
                    dst[n].diag = qp - sst[st + k];
                    dst[n].qst = qp;
                    n++;
                }
            }
            std::sort(dst, dst + n, entry_less);
            // dedup in place + count groups
            int64_t w = 0, g = 0;
            for (int64_t k = 0; k < n; k++) {
                if (k && dst[k].sid == dst[k - 1].sid
                      && dst[k].diag == dst[k - 1].diag
                      && dst[k].qst == dst[k - 1].qst)
                    continue;
                if (w == 0 || dst[w - 1].sid != dst[k].sid
                           || dst[w - 1].diag != dst[k].diag)
                    g++;
                dst[w++] = dst[k];
            }
            ndedup[q] = w;
            ngroup[q] = g;
        }
    };
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back(work, bounds[t], bounds[t + 1]);
        for (auto& th : threads) th.join();
    }

    // prefix offsets of deduped entries / groups per qrow
    std::vector<int64_t> doff(n_qrows + 1, 0), goff(n_qrows + 1, 0);
    for (int64_t q = 0; q < n_qrows; q++) {
        doff[q + 1] = doff[q] + ndedup[q];
        goff[q + 1] = goff[q] + ngroup[q];
    }

    auto emit = [&](int64_t qlo, int64_t qhi) {
        for (int64_t q = qlo; q < qhi; q++) {
            const Entry* src = buf.data() + qcnt[q];
            int64_t d = doff[q], g = goff[q];
            for (int64_t k = 0; k < ndedup[q]; k++) {
                if (k == 0 || src[k].sid != src[k - 1].sid
                           || src[k].diag != src[k - 1].diag) {
                    if (g > goff[q]) o_grp_size[g - 1] = d - o_grp_start[g - 1];
                    o_grp_start[g] = d;
                    o_g_qrow[g] = q;
                    o_g_sid[g] = src[k].sid;
                    o_g_diag[g] = src[k].diag;
                    g++;
                }
                o_qst[d++] = src[k].qst;
            }
            if (g > goff[q]) o_grp_size[g - 1] = d - o_grp_start[g - 1];
        }
    };
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back(emit, bounds[t], bounds[t + 1]);
        for (auto& th : threads) th.join();
    }

    out_n[0] = doff[n_qrows];
    out_n[1] = goff[n_qrows];
}

// Fused candidate engine: posting expansion + (sid, diag) grouping +
// exact chain scoring (reference get_ungap_scores / ungap,
// fsearch.py:2454-2510 driven over chains by find_msav_m :2696-2713) +
// the min-score gate + best-chain-per-(query, subject) selection, in one
// pass with per-thread scratch — no materialized group arrays.
//
// Byte-identical to expand_group + chain_scores + the numpy
// _finish_candidates (search/candidates.py): both tie-break variants are
// emitted — o_diag_fold follows the packed-key path (score desc, then
// 11-bit folded (diag+8192)&0x7FF asc, then diag asc), o_diag_raw the
// lexsort path (score desc, then diag asc) — and the Python wrapper
// picks the column with exactly the numpy path's range conditions
// (gated max sid < 2^21, max qrow < 2^13, max score < 2^17).
//
// Outputs are ordered (qrow asc, sid asc), matching the numpy sort.
// Capacities: o_* must hold one row per distinct gated (qrow, sid)
// (sum(counts) is a safe bound).  out_n[0] = number of rows.
// packed_ok (from the Python wrapper): subject ids < 2^21, qpad and the
// longest db sequence < 2^17 — then (sid, diag, qst) packs into a
// 56-bit key and the per-query sort runs as an LSD radix sort instead
// of a comparison sort on 12-byte structs (same order, entries are
// decoded back before the sweep).
void candidates_fused(const int64_t* rows, const int64_t* qst,
                      const int64_t* counts, const int64_t* starts,
                      int64_t n_seeds, const int32_t* sid,
                      const int32_t* sst, int64_t n_qrows,
                      const uint8_t* qtok, int64_t qpad,
                      const uint8_t* dbtok,
                      const int64_t* db_offsets,
                      const int64_t* q_len,
                      const int8_t* sub256, int32_t xdrop,
                      int64_t min_score, int64_t packed_ok,
                      int64_t* o_qrow, int64_t* o_sid, int64_t* o_score,
                      int64_t* o_diag_fold, int64_t* o_diag_raw,
                      int64_t* out_n) {
    // seeds grouped by qrow (stable counting sort, as in expand_group)
    std::vector<int64_t> qcnt(n_qrows + 1, 0);
    std::vector<int64_t> scnt(n_qrows + 1, 0);
    for (int64_t i = 0; i < n_seeds; i++) {
        qcnt[rows[i] + 1] += counts[i];
        scnt[rows[i] + 1] += 1;
    }
    for (int64_t q = 0; q < n_qrows; q++) {
        qcnt[q + 1] += qcnt[q];
        scnt[q + 1] += scnt[q];
    }
    const int64_t total = qcnt[n_qrows];
    std::vector<int64_t> seed_of(n_seeds);
    {
        std::vector<int64_t> cur(qcnt.size() - 1, 0);
        for (int64_t q = 0; q < n_qrows; q++) cur[q] = scnt[q];
        for (int64_t i = 0; i < n_seeds; i++) seed_of[cur[rows[i]]++] = i;
    }

    unsigned nt = n_threads();
    if (nt > (unsigned)n_qrows && n_qrows > 0) nt = (unsigned)n_qrows;
    if (nt == 0) nt = 1;
    std::vector<int64_t> bounds(nt + 1, n_qrows);
    bounds[0] = 0;
    for (unsigned t = 1; t < nt; t++) {
        int64_t want = total * t / nt;
        bounds[t] = std::lower_bound(qcnt.begin(), qcnt.begin() + n_qrows,
                                     want) - qcnt.begin();
        if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
    }

    struct OutRow {
        int64_t qrow, sid, score, diag_fold, diag_raw;
    };
    std::vector<std::vector<OutRow>> tout(nt);

    // SWNATIVE_PROF=1: per-stage wall accumulated across threads
    // (expand+sort vs chain sweep) printed to stderr per call —
    // profiling only, no behavior change
    const bool prof = [] {
        const char* e = getenv("SWNATIVE_PROF");
        return e && *e && *e != '0';
    }();
    std::vector<double> t_sort(nt, 0.0), t_chain(nt, 0.0);
    std::vector<int64_t> n_walk(nt, 0), n_step(nt, 0);
    std::vector<int64_t> n_blk(nt, 0), n_lstep(nt, 0);
    // per-thread CPU time at thread exit: busy% = cpu / section wall
    // answers "is the engine actually saturating its cores?"
    std::vector<double> t_cpu(nt, 0.0);

#ifdef SW_SIMD_WALK
    const bool use_simd = [] {
        const char* e = getenv("SWNATIVE_NO_SIMD");
        return !(e && *e && *e != '0');
    }();
    // gather reads 4 bytes per lane: pad the 64 KB substitution table
    std::vector<int8_t> tabpad_v(65536 + 64, 0);
    std::memcpy(tabpad_v.data(), sub256, 65536);
    const int8_t* tabpad_ptr = tabpad_v.data();
#endif

    // SWNATIVE_NO_PFETCH=1 disables the sweep's subject-window
    // prefetch (A/B knob: the prefetch wins ~1.5x on an uncontended
    // call but adds bandwidth pressure under producer oversubscription)
    const bool use_pfetch = [] {
        const char* e = getenv("SWNATIVE_NO_PFETCH");
        return !(e && *e && *e != '0');
    }();

    auto fold11 = [](int64_t d) -> int64_t { return (d + 8192) & 0x7FF; };

    auto work = [&](unsigned t, int64_t qlo, int64_t qhi) {
        std::vector<Entry> scratch;
        std::vector<uint64_t> keybuf, keytmp;
        std::vector<int64_t> hist;
        if (packed_ok) hist.resize((int64_t)4 << 14);
        std::vector<OutRow>& out = tout[t];
        out.reserve((size_t)((qcnt[qhi] - qcnt[qlo]) / 8 + 16));
        for (int64_t q = qlo; q < qhi; q++) {
            const int64_t npost = qcnt[q + 1] - qcnt[q];
            if (npost == 0) continue;
            std::chrono::steady_clock::time_point tp0;
            if (prof) tp0 = std::chrono::steady_clock::now();
            scratch.resize(npost);
            Entry* dst = scratch.data();
            int64_t n = 0;
            if (packed_ok) {
                keybuf.resize(npost);
                keytmp.resize(npost);
                uint64_t* kb = keybuf.data();
                for (int64_t s = scnt[q]; s < scnt[q + 1]; s++) {
                    const int64_t i = seed_of[s];
                    const int64_t st = starts[i], c = counts[i];
                    const int32_t qp = (int32_t)qst[i];
                    for (int64_t k = 0; k < c; k++) {
                        const uint64_t sv = (uint64_t)(uint32_t)sid[st + k];
                        const uint64_t dv =
                            (uint64_t)(qp - sst[st + k] + (1 << 17));
                        kb[n++] = (sv << 35) | (dv << 17) | (uint64_t)qp;
                    }
                }
                if (n > 96) radix56(kb, keytmp.data(), n, hist.data());
                else std::sort(kb, kb + n);
                for (int64_t i = 0; i < n; i++) {
                    const uint64_t v = kb[i];
                    dst[i].sid = (int32_t)(v >> 35);
                    dst[i].diag = (int32_t)((v >> 17) & 0x3FFFF)
                        - (1 << 17);
                    dst[i].qst = (int32_t)(v & 0x1FFFF);
                }
            } else {
            for (int64_t s = scnt[q]; s < scnt[q + 1]; s++) {
                const int64_t i = seed_of[s];
                const int64_t st = starts[i], c = counts[i];
                const int32_t qp = (int32_t)qst[i];
                for (int64_t k = 0; k < c; k++) {
                    dst[n].sid = sid[st + k];
                    dst[n].diag = qp - sst[st + k];
                    dst[n].qst = qp;
                    n++;
                }
            }
            std::sort(dst, dst + n, entry_less);
            }
            std::chrono::steady_clock::time_point tp1;
            if (prof) {
                tp1 = std::chrono::steady_clock::now();
                t_sort[t] += std::chrono::duration<double>(tp1 - tp0)
                    .count();
            }
            const int64_t ql = q_len[q];
            const uint8_t* qrow_tok = qtok + q * qpad;
            // sweep runs of equal (sid, diag); per run: dedup qst inline
            // + exact chain score (logic of chain.cpp chain_scores);
            // per run of equal sid: best-of selection under both
            // tie-break variants, emitted when the best clears the gate
            int64_t best_score = -1, best_fold = 0, best_diag_fold = 0;
            int64_t best_raw_score = -1, best_diag_raw = 0;
            int32_t cur_sid = -1;
            auto flush_sid = [&]() {
                if (cur_sid >= 0 && best_score >= min_score)
                    out.push_back({q, (int64_t)cur_sid, best_score,
                                   best_diag_fold, best_diag_raw});
            };
            int64_t k = 0;
            while (k < n) {
                const int32_t gsid = dst[k].sid;
                const int32_t gdiag = dst[k].diag;
                const int64_t s_off = db_offsets[gsid];
                const int64_t sl = db_offsets[gsid + 1] - s_off;
                const uint8_t* s_tok = dbtok + s_off;
                const int64_t diag = (int64_t)gdiag;
                // chain over this run (qst ascending after the sort)
                int64_t total_sc = 0, x = 0;
                bool first = true;
                int32_t prev_qst = -1;
                for (; k < n && dst[k].sid == gsid && dst[k].diag == gdiag;
                     k++) {
                    // the sweep is memory-latency-bound: each new run
                    // lands on a random subject window (measured ~219 ns
                    // per 16-lane walk block at 250k scale — DRAM, not
                    // ALU).  Prefetch the subject bytes a few entries
                    // ahead; a lookahead inside the current run is
                    // harmless (same window, already warm), and
                    // _mm_prefetch cannot fault on stale addresses.
                    if (use_pfetch && k + 8 < n) {
                        const Entry& e = dst[k + 8];
                        const uint8_t* sp = dbtok + db_offsets[e.sid]
                            + ((int64_t)e.qst - (int64_t)e.diag);
                        __builtin_prefetch(sp - 64, 0, 3);
                        __builtin_prefetch(sp, 0, 3);
                        __builtin_prefetch(sp + 64, 0, 3);
                    }
                    const int64_t p = dst[k].qst;
                    if (p == prev_qst) continue;        // (group,qst) dedup
                    prev_qst = (int32_t)p;
                    if (!first && p <= x) continue;     // covered: exactly 0
                    const int64_t qlo_b = first ? 0 : x;
                    const int64_t slo_b = first ? 0 : x - diag;
                    if (prof) n_walk[t]++;
#ifdef SW_SIMD_WALK
                    if (use_simd) {
                        const int64_t s0 = p - diag;
                        int64_t best = 0, max_qed = p;
                        if (qlo_b < p && p < ql && slo_b < s0 && s0 < sl)
                            best = sw_walk_right(
                                qrow_tok, s_tok, p, s0,
                                std::min(ql - p, sl - s0), tabpad_ptr,
                                xdrop, &max_qed,
                                prof ? &n_blk[t] : nullptr,
                                prof ? &n_step[t] : nullptr);
                        int64_t best_l = best;
                        const int64_t p0 = p - 1, sp0 = s0 - 1;
                        if (p0 > qlo_b && p0 < ql && sp0 > slo_b
                            && sp0 < sl)
                            best_l = sw_walk_left(
                                qrow_tok, s_tok, p0, sp0,
                                std::min(p0 - qlo_b, sp0 - slo_b),
                                tabpad_ptr, xdrop, (int32_t)best,
                                prof ? &n_blk[t] : nullptr,
                                prof ? &n_lstep[t] : nullptr);
                        total_sc += best_l;
                        x = max_qed;
                        first = false;
                        continue;
                    }
#endif
                    // right walk from the seed (strict bounds)
                    int64_t qp = p, sp = p - diag;
                    int64_t score = 0, best = 0, max_qed = qp;
                    while (qlo_b < qp && qp < ql && slo_b < sp && sp < sl) {
                        score += sub256[(int)qrow_tok[qp] * 256
                                        + (int)s_tok[sp]];
                        if (score > best) { best = score; max_qed = qp; }
                        else if (score + xdrop < best) break;
                        ++qp; ++sp;
                    }
                    if (prof) n_step[t] += qp - p;
                    // left walk from seed-1, seeded with the right best
                    qp = p - 1; sp = p - diag - 1;
                    score = best;
                    int64_t best_l = best;
                    while (qp > qlo_b && qp < ql && sp > slo_b && sp < sl) {
                        score += sub256[(int)qrow_tok[qp] * 256
                                        + (int)s_tok[sp]];
                        if (score > best_l) best_l = score;
                        else if (score + xdrop < best_l) break;
                        --qp; --sp;
                    }
                    if (prof) n_lstep[t] += (p - 1) - qp;
                    total_sc += best_l;
                    x = max_qed;
                    first = false;
                }
                // fold into the per-sid best (runs arrive diag-ascending)
                if ((int64_t)gsid != (int64_t)cur_sid) {
                    flush_sid();
                    cur_sid = gsid;
                    best_score = total_sc;
                    best_fold = fold11(diag);
                    best_diag_fold = diag;
                    best_raw_score = total_sc;
                    best_diag_raw = diag;
                } else {
                    const int64_t f = fold11(diag);
                    if (total_sc > best_score
                        || (total_sc == best_score && f < best_fold)) {
                        best_score = total_sc;
                        best_fold = f;
                        best_diag_fold = diag;
                    }
                    if (total_sc > best_raw_score) {
                        best_raw_score = total_sc;
                        best_diag_raw = diag;
                    }
                }
            }
            flush_sid();
            if (prof)
                t_chain[t] += std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - tp1).count();
        }
        if (prof) {
            struct timespec tsp;
            if (clock_gettime(CLOCK_THREAD_CPUTIME_ID, &tsp) == 0)
                t_cpu[t] = tsp.tv_sec + tsp.tv_nsec * 1e-9;
        }
    };
    const auto sec0 = std::chrono::steady_clock::now();
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back(work, t, bounds[t], bounds[t + 1]);
        for (auto& th : threads) th.join();
    }
    if (prof) {
        const double wall = std::chrono::duration<double>(
            std::chrono::steady_clock::now() - sec0).count();
        double ts = 0, tc = 0, cpu = 0, bmin = 1e30, bmax = 0;
        int64_t nw = 0, ns = 0, nb = 0, nl = 0;
        for (unsigned t = 0; t < nt; t++) {
            ts += t_sort[t];
            tc += t_chain[t];
            nw += n_walk[t];
            ns += n_step[t];
            nb += n_blk[t];
            nl += n_lstep[t];
            cpu += t_cpu[t];
            bmin = std::min(bmin, t_cpu[t]);
            bmax = std::max(bmax, t_cpu[t]);
        }
        const double sat = wall > 0 ? 100.0 * cpu / (nt * wall) : 0.0;
        fprintf(stderr,
                "[fused prof] postings=%lld sort=%.3fs chain=%.3fs "
                "walks=%lld rsteps=%lld lsteps=%lld blks=%lld "
                "(cpu-s summed over %u threads) wall=%.3fs cpu=%.3fs "
                "sat=%.0f%% thr-busy=%.0f-%.0f%%\n",
                (long long)total, ts, tc, (long long)nw, (long long)ns,
                (long long)nl, (long long)nb, nt, wall, cpu, sat,
                wall > 0 ? 100.0 * bmin / wall : 0.0,
                wall > 0 ? 100.0 * bmax / wall : 0.0);
    }

    int64_t w = 0;
    for (unsigned t = 0; t < nt; t++) {
        for (const OutRow& r : tout[t]) {
            o_qrow[w] = r.qrow;
            o_sid[w] = r.sid;
            o_score[w] = r.score;
            o_diag_fold[w] = r.diag_fold;
            o_diag_raw[w] = r.diag_raw;
            w++;
        }
    }
    out_n[0] = w;
}

// Index-build counting sort (reference build_msav's two passes,
// fsearch.py:2240-2266): histogram of bucket ids -> exclusive scan ->
// stable scatter of postings into CSR slots.  Equivalent to numpy
// bincount + cumsum + stable argsort-take, which is the single-core
// bottleneck of build_index.  Threads own disjoint bucket RANGES and
// each scans the full posting stream, so writes never collide and
// within-bucket order stays the input order (stability).
// csr must have nc+1 slots; csr[0] = 0 on return.
void index_csr_scatter(const int64_t* b, const int64_t* p, int64_t n,
                       int64_t nc, int64_t* csr, int64_t* locus) {
    unsigned nt = n_threads();
    if ((int64_t)nt > nc) nt = nc > 0 ? (unsigned)nc : 1;
    if (nt == 0) nt = 1;
    // bucket-range bounds per thread
    std::vector<int64_t> blo(nt + 1);
    for (unsigned t = 0; t <= nt; t++) blo[t] = nc * t / nt;

    std::vector<int64_t> cnt(nc, 0);
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back([&, t]() {
                const int64_t lo = blo[t], hi = blo[t + 1];
                for (int64_t i = 0; i < n; i++) {
                    const int64_t bi = b[i];
                    if (lo <= bi && bi < hi) cnt[bi]++;
                }
            });
        for (auto& th : threads) th.join();
    }
    csr[0] = 0;
    for (int64_t c = 0; c < nc; c++) csr[c + 1] = csr[c] + cnt[c];
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back([&, t]() {
                const int64_t lo = blo[t], hi = blo[t + 1];
                // cnt becomes the running write cursor per bucket
                for (int64_t c = lo; c < hi; c++) cnt[c] = csr[c];
                for (int64_t i = 0; i < n; i++) {
                    const int64_t bi = b[i];
                    if (lo <= bi && bi < hi) locus[cnt[bi]++] = p[i];
                }
            });
        for (auto& th : threads) th.join();
    }
}

// Posting decode: largest idx with soas[idx] < loc (the reference's
// bisect off-by-one, fsearch.py:134-153 — position-0 seeds land on the
// previous sequence), i.e. numpy searchsorted(soas, loc, 'left') - 1
// clamped at 0.  sid gets idx, sst gets loc - soas[idx].
void decode_locus(const int64_t* soas, int64_t n_soas,
                  const int64_t* loc, int64_t n,
                  int32_t* sid, int32_t* sst) {
    unsigned nt = n_threads();
    if (nt == 0) nt = 1;
    std::vector<std::thread> threads;
    const int64_t step = (n + nt - 1) / (int64_t)nt;
    for (unsigned t = 0; t < nt; t++) {
        const int64_t lo = t * step, hi = std::min<int64_t>(n, lo + step);
        if (lo >= hi) break;
        threads.emplace_back([&, lo, hi]() {
            for (int64_t i = lo; i < hi; i++) {
                const int64_t v = loc[i];
                int64_t l = 0, r = n_soas;      // first idx with soas >= v
                while (l < r) {
                    const int64_t m = (l + r) >> 1;
                    if (soas[m] < v) l = m + 1; else r = m;
                }
                const int64_t idx = l > 0 ? l - 1 : 0;
                sid[i] = (int32_t)idx;
                sst[i] = (int32_t)(v - soas[idx]);
            }
        });
    }
    for (auto& th : threads) th.join();
}

// Per-wave candidate ranking (the reference's chain-score sort +
// vmax cut, fsearch.py:3040-3051): order candidates by (qrow asc,
// chain score desc, subject asc) with ties in input order — identical
// to BOTH numpy branches in blastp._wave_body (the packed-key stable
// argsort and the lexsort express the same ordering) — then emit the
// first vmax per query with their ranks, plus the pre-cut per-query
// hit counts (nhits_of feeds the mmiss clamp).
// Threaded per query-range; outputs are in (qrow, rank) order.
void rank_cut(const int64_t* qrow, const int64_t* subj,
              const int64_t* csc, const int64_t* bq, const int64_t* bs,
              int64_t n, int64_t n_queries, int64_t vmax,
              int64_t* o_qrow, int64_t* o_subj, int64_t* o_csc,
              int64_t* o_bq, int64_t* o_bs, int64_t* o_rank,
              int64_t* o_nhits, int64_t* out_n) {
    std::vector<int64_t> qcnt(n_queries + 1, 0);
    for (int64_t i = 0; i < n; i++) qcnt[qrow[i] + 1]++;
    for (int64_t q = 0; q < n_queries; q++) {
        o_nhits[q] = qcnt[q + 1];
        qcnt[q + 1] += qcnt[q];
    }
    std::vector<int64_t> order(n);
    {
        std::vector<int64_t> cur(qcnt.begin(), qcnt.end() - 1);
        for (int64_t i = 0; i < n; i++) order[cur[qrow[i]]++] = i;
    }
    // output offsets after the vmax cut
    std::vector<int64_t> ocnt(n_queries + 1, 0);
    for (int64_t q = 0; q < n_queries; q++) {
        const int64_t c = qcnt[q + 1] - qcnt[q];
        ocnt[q + 1] = ocnt[q] + (c < vmax ? c : vmax);
    }
    unsigned nt = n_threads();
    if ((int64_t)nt > n_queries && n_queries > 0) nt = (unsigned)n_queries;
    if (nt == 0) nt = 1;
    std::vector<int64_t> bounds(nt + 1, n_queries);
    bounds[0] = 0;
    for (unsigned t = 1; t < nt; t++) {
        int64_t want = n * t / nt;
        bounds[t] = std::lower_bound(qcnt.begin(),
                                     qcnt.begin() + n_queries, want)
            - qcnt.begin();
        if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
    }
    auto work = [&](int64_t qlo, int64_t qhi) {
        for (int64_t q = qlo; q < qhi; q++) {
            int64_t* seg = order.data() + qcnt[q];
            const int64_t c = qcnt[q + 1] - qcnt[q];
            std::stable_sort(seg, seg + c,
                             [&](int64_t a, int64_t b) {
                                 if (csc[a] != csc[b])
                                     return csc[a] > csc[b];
                                 return subj[a] < subj[b];
                             });
            const int64_t keep = c < vmax ? c : vmax;
            int64_t w = ocnt[q];
            for (int64_t r = 0; r < keep; r++, w++) {
                const int64_t i = seg[r];
                o_qrow[w] = q;
                o_subj[w] = subj[i];
                o_csc[w] = csc[i];
                o_bq[w] = bq[i];
                o_bs[w] = bs[i];
                o_rank[w] = r;
            }
        }
    };
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back(work, bounds[t], bounds[t + 1]);
        for (auto& th : threads) th.join();
    }
    out_n[0] = ocnt[n_queries];
}

// Seed-budget keep mask (reference find_msav_m's hit-budget heuristic,
// fsearch.py:2667-2677; semantics of the numpy block in
// search/candidates._self_score_budget): per query row, build the
// posting-count histogram over seed positions, walk the row's
// precomputed position order (self-score desc, pos asc — chunk-
// invariant, computed once per wave by budget_order) accumulating an
// EXCLUSIVE cumsum, keep a position while cum <= threshold * qlen
// (int64 cum compared as double, matching the numpy broadcast), then
// emit keep[i] = keep_pos[rows[i]][qst[i]] per seed.  Rows are
// independent -> threads take row ranges balanced by seed count.
// hist scratch is per-thread (nwin int64), zeroed by touched entries.
void budget_keep(const int64_t* rows, const int64_t* qst,
                 const int64_t* counts, int64_t n_seeds,
                 const int64_t* order, int64_t B, int64_t nwin,
                 const double* budgets, uint8_t* keep) {
    // seeds grouped by row (stable counting sort, as elsewhere)
    std::vector<int64_t> scnt(B + 1, 0);
    for (int64_t i = 0; i < n_seeds; i++) scnt[rows[i] + 1]++;
    for (int64_t q = 0; q < B; q++) scnt[q + 1] += scnt[q];
    std::vector<int64_t> seed_of(n_seeds);
    {
        std::vector<int64_t> cur(scnt.begin(), scnt.end() - 1);
        for (int64_t i = 0; i < n_seeds; i++) seed_of[cur[rows[i]]++] = i;
    }
    unsigned nt = n_threads();
    if ((int64_t)nt > B && B > 0) nt = (unsigned)B;
    if (nt == 0) nt = 1;
    std::vector<int64_t> bounds(nt + 1, B);
    bounds[0] = 0;
    for (unsigned t = 1; t < nt; t++) {
        int64_t want = n_seeds * t / nt;
        bounds[t] = std::lower_bound(scnt.begin(), scnt.begin() + B,
                                     want) - scnt.begin();
        if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
    }
    auto work = [&](int64_t qlo, int64_t qhi) {
        std::vector<int64_t> hist(nwin, 0);
        std::vector<uint8_t> keep_pos(nwin, 0);
        for (int64_t q = qlo; q < qhi; q++) {
            const int64_t s0 = scnt[q], s1 = scnt[q + 1];
            if (s0 == s1) continue;
            for (int64_t s = s0; s < s1; s++)
                hist[qst[seed_of[s]]] += counts[seed_of[s]];
            const double budget = budgets[q];
            const int64_t* ord = order + q * nwin;
            int64_t cum = 0;
            for (int64_t k = 0; k < nwin; k++) {
                const int64_t pos = ord[k];
                keep_pos[pos] = (double)cum <= budget;
                cum += hist[pos];
            }
            for (int64_t s = s0; s < s1; s++) {
                const int64_t i = seed_of[s];
                keep[i] = keep_pos[qst[i]];
                hist[qst[i]] = 0;          // reset touched entries only
            }
        }
    };
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < nt; t++)
        threads.emplace_back(work, bounds[t], bounds[t + 1]);
    for (auto& th : threads) th.join();
}

// Spaced-seed FNV hashing for ONE pattern (reference spseeds_fnv,
// fsearch.py:519-556; semantics of ops/seeds.hash_seeds_flat): a window
// starting at i is valid iff it stays inside one sequence (seq_of[i] ==
// seq_of[i+klen-1]), contains no seg mask byte 'x'/'X' at ANY of the
// klen positions, and (step > 1) starts at an in-sequence offset
// divisible by step.  Hash = FNV-1a over code_tbl[token] at the pattern's
// one-offsets, then mixed with the pattern index; bucket = h % (u32)nc —
// the numpy path computes the modulo in uint32, matched exactly here.
// Two passes (count, emit) so output order is window-position order.
void hash_seeds_pattern(const uint8_t* tokens, const int64_t* seq_of,
                        int64_t T, const uint8_t* code_tbl,
                        const int64_t* ones, int64_t n_ones,
                        int64_t klen, int64_t pat_idx,
                        int64_t nc, int64_t step,
                        int64_t* o_bucket, int64_t* o_pos,
                        int64_t* out_n) {
    const int64_t n = T - klen + 1;
    if (n <= 0) { out_n[0] = 0; return; }
    unsigned nt = n_threads();
    if ((int64_t)nt > n) nt = (unsigned)n;
    if (nt == 0) nt = 1;
    std::vector<int64_t> lo(nt + 1);
    for (unsigned t = 0; t <= nt; t++) lo[t] = n * t / nt;
    std::vector<int64_t> cnt(nt, 0);
    const uint32_t prime = 0x01000193u;
    const uint32_t ncu = (uint32_t)nc;

    auto valid_from = [&](int64_t i, int64_t& seq_start) -> bool {
        if (seq_of[i] != seq_of[i + klen - 1]) return false;
        for (int64_t j = 0; j < klen; j++) {
            const uint8_t c = tokens[i + j];
            if (c == 'x' || c == 'X') return false;
        }
        if (step > 1) {
            if (seq_start < 0 || seq_of[seq_start] != seq_of[i]) {
                seq_start = i;
                while (seq_start > 0
                       && seq_of[seq_start - 1] == seq_of[i])
                    seq_start--;
            }
            if ((i - seq_start) % step != 0) return false;
        }
        return true;
    };

    auto sweep = [&](unsigned t, bool emit, int64_t base) {
        int64_t c = 0;
        int64_t seq_start = -1;
        for (int64_t i = lo[t]; i < lo[t + 1]; i++) {
            if (!valid_from(i, seq_start)) continue;
            if (emit) {
                uint32_t h = 0x811c9dc5u;
                for (int64_t j = 0; j < n_ones; j++) {
                    h ^= (uint32_t)code_tbl[tokens[i + ones[j]]];
                    h *= prime;
                }
                h ^= (uint32_t)pat_idx;
                h *= prime;
                o_bucket[base + c] = (int64_t)(h % ncu);
                o_pos[base + c] = i;
            }
            c++;
        }
        cnt[t] = c;
    };
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back(sweep, t, false, (int64_t)0);
        for (auto& th : threads) th.join();
    }
    std::vector<int64_t> off(nt + 1, 0);
    for (unsigned t = 0; t < nt; t++) off[t + 1] = off[t] + cnt[t];
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++)
            threads.emplace_back(sweep, t, true, off[t]);
        for (auto& th : threads) th.join();
    }
    out_n[0] = off[nt];
}

}  // extern "C"
