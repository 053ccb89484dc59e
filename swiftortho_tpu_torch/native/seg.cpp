// SEG-like low-complexity masking — native port of the sequential
// oracle ops/seg.py seg_string (reference lib/fsearch.py:2854-2946),
// threaded over batch rows.
//
// Bit-for-bit contract with the oracle (which is the parity arbiter):
//  - the first window's characters are double-counted (reference
//    entropy(), fsearch.py:2857-2859), its entropy summed over distinct
//    characters in FIRST-APPEARANCE order (the oracle's Counter order);
//  - the slide updates the running entropy with the reference's exact
//    incremental expressions, including the Python `X and Y or Z`
//    quirk: when the computed delta is exactly 0.0 the expression falls
//    through to the Z branch (fsearch.py:2895-2907 / seg_string);
//  - equal pre/cur characters copy the previous mask bit;
//  - a set bit at window n-w masks the whole tail;
//  - expansion: a masked start emits twelve 'x' and skips 12 positions.
//
// Output: the uppercased, expanded-mask token row (the pipeline's
// input); the dilate+merge second pass is not used by the search path.
//
// No -ffast-math anywhere in the build: the incremental float
// accumulation must round exactly like CPython's (both use libm).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

unsigned seg_n_threads() {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        long v = atol(env);
        if (v > 0) nt = (unsigned)v;
    }
    if (nt == 0) nt = 1;
    return nt;
}

}  // namespace

extern "C" {

// tokens: (B, L) row-major uint8, padded; lengths: (B,) int64.
// out: (B, L) uint8 — masked uppercased rows (padding copied verbatim).
// window/minent: SEG_WINDOW (12) / SEG_MIN_ENT (2.2).
void seg_batch(const uint8_t* tokens, int64_t B, int64_t L,
               const int64_t* lengths, int64_t window, double minent,
               uint8_t* out) {
    const double LOG2 = std::log(2.0);
    unsigned nt = seg_n_threads();
    if ((int64_t)nt > B && B > 0) nt = (unsigned)B;
    if (nt == 0) nt = 1;

    auto work = [&](int64_t rlo, int64_t rhi) {
        std::vector<uint8_t> s(L);
        std::vector<int8_t> mask(L);
        int32_t counts[256];
        const int64_t w = window;
        const double wf = (double)window;
        for (int64_t r = rlo; r < rhi; r++) {
            const uint8_t* row = tokens + r * L;
            uint8_t* orow = out + r * L;
            const int64_t n = lengths[r];
            // uppercase copy; padding tail passes through unchanged
            for (int64_t i = 0; i < n; i++) {
                uint8_t c = row[i];
                if (c >= 'a' && c <= 'z') c -= 32;
                s[i] = c;
            }
            for (int64_t i = n; i < L; i++) orow[i] = row[i];
            if (n == 0) continue;

            std::memset(counts, 0, sizeof(counts));
            std::memset(mask.data(), 0, (size_t)n);

            // first window: double-counted characters, entropy summed
            // in first-appearance order (Counter iteration order)
            const int64_t w0 = n < w ? n : w;
            uint8_t order[256];
            int n_order = 0;
            bool seen[256] = {false};
            for (int64_t i = 0; i < w0; i++) {
                const uint8_t c = s[i];
                counts[c] += 2;
                if (!seen[c]) {
                    seen[c] = true;
                    order[n_order++] = c;
                }
            }
            const double denom = w0 ? (double)w0 : 1.0;
            double ent = 0.0;
            for (int k = 0; k < n_order; k++) {
                const double f = (double)counts[order[k]] / denom;
                ent -= f * std::log(f);
            }
            ent /= LOG2;
            if (ent < minent) mask[0] = 1;

            // incremental slide (reference expression forms; the
            // `and/or` fallthrough on an exactly-0.0 delta included)
            for (int64_t i = 1; i <= n - w; i++) {
                const uint8_t pre = s[i - 1], cur = s[i + w - 1];
                if (pre == cur) {
                    mask[i] = mask[i - 1];
                    continue;
                }
                const int32_t pre_count = counts[pre];
                counts[pre] -= 1;
                const int32_t cur_count = counts[cur];
                counts[cur] += 1;
                {
                    const double a = (double)pre_count / wf;
                    const double b = (double)counts[pre] / wf;
                    double t;
                    if (b != 0.0) {
                        t = (a * std::log(a) - b * std::log(b)) / LOG2;
                        if (t == 0.0) t = a * std::log(a) / LOG2;
                    } else {
                        t = a * std::log(a) / LOG2;
                    }
                    ent += t;
                }
                {
                    const double a = (double)cur_count / wf;
                    const double b = (double)counts[cur] / wf;
                    double t;
                    if (a != 0.0) {
                        t = (a * std::log(a) - b * std::log(b)) / LOG2;
                        if (t == 0.0) t = -b * std::log(b) / LOG2;
                    } else {
                        t = -b * std::log(b) / LOG2;
                    }
                    ent += t;
                }
                if (ent < minent) mask[i] = 1;
            }
            const int64_t nws = n - w > 0 ? n - w : 0;
            if (mask[nws] == 1)
                for (int64_t i = nws; i < n; i++) mask[i] = 1;

            // expansion: masked start emits twelve 'x', skips 12
            int64_t st = 0, o = 0;
            while (st < n) {
                if (mask[st] == 0) {
                    orow[o++] = s[st++];
                } else {
                    for (int64_t k = 0; k < w && o < n; k++) orow[o++] = 'x';
                    st += w;
                }
            }
            while (o < n) orow[o++] = 'x';   // truncated final block
        }
    };
    if (nt == 1) {
        work(0, B);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t step = (B + nt - 1) / (int64_t)nt;
    for (unsigned t = 0; t < nt; t++) {
        const int64_t lo = t * step;
        const int64_t hi = lo + step < B ? lo + step : B;
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
