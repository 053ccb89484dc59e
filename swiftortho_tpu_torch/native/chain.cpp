// Ungapped x-drop chain scoring over exact diagonals (host/CPU).
//
// Behavioral contract: reference get_ungap_scores / ungap
// (lib/fsearch.py:2454-2510) driven over LIS chains by find_msav_m
// (:2696-2713): per (subject, diagonal) group, chain points in ascending
// query order; the first point gets an unbounded two-way x-drop
// extension; later points are skipped when covered (exactly 0 in the
// reference — the shifted start lands on the strict bound) or extended
// with the left walk bounded by the previous extension end.  Exact — no
// window caps (unlike the vectorized numpy fallback's 1024 cap).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libswnative.so \
//        banded_sw.cpp chain.cpp

#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

void chain_scores(const uint8_t* qtok, int64_t qpad,
                  const uint8_t* dbtok, int64_t dbtok_len,
                  const int64_t* grp_start, const int64_t* grp_size,
                  int64_t n_groups,
                  const int64_t* g_qrow, const int64_t* g_diag,
                  const int64_t* s_off, const int64_t* s_len,
                  const int64_t* q_len,
                  const int64_t* p_qst,
                  const int8_t* sub256, int32_t xdrop,
                  int64_t* out_scores) {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        int v = atoi(env);
        if (v > 0) nt = v;
    }
    if (nt < 1) nt = 1;
    if ((int64_t)nt > n_groups) nt = n_groups > 0 ? n_groups : 1;
    auto work = [&](int64_t glo, int64_t ghi) {
    for (int64_t g = glo; g < ghi; ++g) {
        const uint8_t* q = qtok + g_qrow[g] * qpad;
        const uint8_t* s = dbtok + s_off[g];
        const int64_t diag = g_diag[g];
        const int64_t ql = q_len[g], sl = s_len[g];
        int64_t total = 0;
        int64_t x = 0;          // previous extension end (qlo bound)
        bool first = true;
        const int64_t pst = grp_start[g], ped = pst + grp_size[g];
        for (int64_t pi = pst; pi < ped; ++pi) {
            int64_t p = p_qst[pi];
            if (!first && p <= x) continue;   // covered: exactly 0
            int64_t qlo = first ? 0 : x;
            int64_t slo = first ? 0 : x - diag;

            // right walk from the seed (strict bounds, reference ungap)
            int64_t qst = p, sst = p - diag;
            int64_t score = 0, best = 0, max_qed = qst;
            while (qlo < qst && qst < ql && slo < sst && sst < sl) {
                score += sub256[(int)q[qst] * 256 + (int)s[sst]];
                if (score > best) { best = score; max_qed = qst; }
                else if (score + xdrop < best) break;
                ++qst; ++sst;
            }
            // left walk from seed-1, starting at the right best
            qst = p - 1; sst = p - diag - 1;
            score = best;
            int64_t best_l = best;
            while (qst > qlo && qst < ql && sst > slo && sst < sl) {
                score += sub256[(int)q[qst] * 256 + (int)s[sst]];
                if (score > best_l) best_l = score;
                else if (score + xdrop < best_l) break;
                --qst; --sst;
            }
            total += best_l;
            x = max_qed;
            first = false;
        }
        out_scores[g] = total;
    }
    };
    if (nt == 1) {
        work(0, n_groups);
        return;
    }
    std::vector<std::thread> threads;
    int64_t step = (n_groups + nt - 1) / nt;
    for (unsigned t = 0; t < nt; ++t) {
        int64_t lo = t * step;
        int64_t hi = std::min<int64_t>(n_groups, lo + step);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
