// m8 output-row formatting (the 16-column rows of the reference's
// entry_point, lib/fsearch.py:3242-3243), char-for-char the Python
// path in search/blastp.py:
//
//   '%s\t%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%s\t%f\t%d\t%d\t%d\t%s\n'
//    % (qid, sid, fmt_idy(idy), aln, mis, gap, qst1, qed, sst1, sed,
//       f2s(e), float(bit), qlen, slen, qidx, sdesc)
//
// with ops/stats.py's py2_float_str ('%.12g' + '.0' on integral) and
// f2s (custom scientific notation) — both fuzz-verified identical to
// the CPython implementations (libc printf %.12g and libm log10/pow
// round exactly like CPython's).  15M+ rows per large corpus made the
// Python %-formatting chain a measurable single-thread tail; this runs
// threaded with per-thread buffers.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

unsigned fmt_n_threads() {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        long v = atol(env);
        if (v > 0) nt = (unsigned)v;
    }
    if (nt == 0) nt = 1;
    return nt;
}

// Python-2 str(float): %.12g, plus '.0' when integral (ops/stats.py
// py2_float_str; the n/f guards keep nan/inf untouched)
void py2fs(double v, char* buf) {
    snprintf(buf, 64, "%.12g", v);
    if (!strpbrk(buf, "e.nf")) strcat(buf, ".0");
}

// identity percentage: py2 str truncated to 2 decimals — including the
// quirky max(0, find+3) slice when no '.' exists (blastp._fmt_idy)
void fmt_idy(double v, char* out) {
    char s[72];
    py2fs(v, s);
    char* dot = strchr(s, '.');
    size_t end = dot ? (size_t)(dot - s) + 3 : 2;
    size_t n = strlen(s);
    if (end > n) end = n;
    memcpy(out, s, end);
    out[end] = 0;
}

// custom scientific notation (reference f2s, fsearch.py:42-61)
void f2s(double e, char* out) {
    if (e <= 0) { strcpy(out, "0"); return; }
    if (e < 1e-3) {
        double a = log10(e);
        a -= (double)(long long)a;      // int() truncates toward zero
        if (a < 0) a += 1;
        double b = pow(10, a);
        char s[72];
        py2fs(log10(e / b), s);
        char* dot = strchr(s, '.');
        size_t end = dot ? (size_t)(dot - s) : 0;   // max(0, find)
        s[end] = 0;
        char p[72];
        py2fs(b, p);
        dot = strchr(p, '.');
        size_t pend = dot ? (size_t)(dot - p) + 3 : 2;  // max(0, find+3)
        size_t pn = strlen(p);
        if (pend > pn) pend = pn;
        p[pend] = 0;
        sprintf(out, "%se%s", p, s);
    } else {
        py2fs(e, out);
    }
}

}  // namespace

extern "C" {

// Format n rows.  String columns arrive as concatenated utf-8 blobs
// with (len+1) exclusive offsets; per-row indices select the entry.
// out must hold cap bytes (caller bounds it); o_end[i] = exclusive end
// of row i's bytes.  Returns total bytes in out_n[0], or -1 if cap
// would overflow (caller falls back).
void format_rows(int64_t n,
                 const double* idy, const int64_t* aln,
                 const int64_t* mis, const int64_t* gap,
                 const int64_t* qst1, const int64_t* qed,
                 const int64_t* sst1, const int64_t* sed,
                 const double* e, const int64_t* bit,
                 const int64_t* qlen, const int64_t* slen,
                 const int64_t* qidx,
                 const int64_t* qid_i, const uint8_t* qid_blob,
                 const int64_t* qid_off,
                 const int64_t* sid_i, const uint8_t* refid_blob,
                 const int64_t* refid_off,
                 const uint8_t* refdesc_blob, const int64_t* refdesc_off,
                 uint8_t* out, int64_t cap,
                 int64_t* o_end, int64_t* out_n) {
    unsigned nt = fmt_n_threads();
    if ((int64_t)nt > n && n > 0) nt = (unsigned)n;
    if (nt == 0) nt = 1;
    const int64_t step = (n + nt - 1) / (int64_t)nt;
    std::vector<std::vector<char>> bufs(nt);
    std::vector<std::vector<int64_t>> ends(nt);

    auto work = [&](unsigned t) {
        const int64_t lo = t * step;
        const int64_t hi = std::min<int64_t>(n, lo + step);
        if (lo >= hi) return;
        std::vector<char>& buf = bufs[t];
        std::vector<int64_t>& end = ends[t];
        buf.reserve((size_t)(hi - lo) * 160);
        end.reserve((size_t)(hi - lo));
        char sidy[80], sev[160], num[520];
        for (int64_t i = lo; i < hi; i++) {
            const int64_t q = qid_i[i], s = sid_i[i];
            fmt_idy(idy[i], sidy);
            f2s(e[i], sev);
            const int m = snprintf(
                num, sizeof(num),
                "\t%s\t%lld\t%lld\t%lld\t%lld\t%lld\t%lld\t%lld\t%s\t"
                "%f\t%lld\t%lld\t%lld\t",
                sidy, (long long)aln[i], (long long)mis[i],
                (long long)gap[i], (long long)qst1[i], (long long)qed[i],
                (long long)sst1[i], (long long)sed[i], sev,
                (double)bit[i], (long long)qlen[i], (long long)slen[i],
                (long long)qidx[i]);
            const char* qs = (const char*)qid_blob + qid_off[q];
            const int64_t qn = qid_off[q + 1] - qid_off[q];
            const char* ss = (const char*)refid_blob + refid_off[s];
            const int64_t sn = refid_off[s + 1] - refid_off[s];
            const char* ds = (const char*)refdesc_blob + refdesc_off[s];
            const int64_t dn = refdesc_off[s + 1] - refdesc_off[s];
            const size_t base = buf.size();
            buf.resize(base + qn + 1 + sn + m + dn + 1);
            char* w = buf.data() + base;
            memcpy(w, qs, qn); w += qn;
            *w++ = '\t';
            memcpy(w, ss, sn); w += sn;
            memcpy(w, num, m); w += m;
            memcpy(w, ds, dn); w += dn;
            *w++ = '\n';
            end.push_back((int64_t)buf.size());
        }
    };
    {
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; t++) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
    int64_t total = 0;
    for (unsigned t = 0; t < nt; t++) total += (int64_t)bufs[t].size();
    if (total > cap) { out_n[0] = -1; return; }
    int64_t boff = 0, roff = 0;
    for (unsigned t = 0; t < nt; t++) {
        if (!bufs[t].empty())
            memcpy(out + boff, bufs[t].data(), bufs[t].size());
        for (int64_t v : ends[t]) o_end[roff++] = boff + v;
        boff += (int64_t)bufs[t].size();
    }
    out_n[0] = boff;
}

}  // extern "C"
