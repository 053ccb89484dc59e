// Orth output-row formatting: the 'REL\tqid\tsid\tweight\n' lines of
// find_orth (reference bin/find_orth.py:744-749 via the repo's
// orth/inference.py:270-281), char-for-char the Python path
//
//   '%s\t%s\t%s\n' % (qid, sid, weight)     # weight: float -> str()
//
// The weight column is CPython str(float) == repr(float): the SHORTEST
// decimal string that round-trips (pystrtod.c format_float_short, type
// 'r').  std::to_chars(chars_format::scientific) produces the same
// shortest correctly-rounded digit string (both are shortest-round-trip
// with round-half-even digit selection); this file re-applies CPython's
// fixed/exponent presentation rules on top of those digits:
//   decpt = decimal exponent + 1 (digits before the point)
//   fixed form  when -4 < decpt <= 16, with '.0' appended if integral
//   exponent    otherwise: d[.ddd]e[+-]EE, exponent >= 2 digits
// Fuzz-verified identical to str(float) in tests/test_orth.py
// (TestNativeOrthFormat) over random mantissas across the full exponent
// range plus the boundary cases (1e15/1e16/1e-4/1e-5, integral floats,
// subnormals, 0.0/-0.0, inf/nan).
//
// 6.5M output lines at the 250k-seq scale made the per-line Python
// formatting chain (str(float) + %-interpolation + generator yields)
// the orth stage's largest remaining cost; this runs threaded with
// per-thread buffers, same transport as fmtrows.cpp.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

unsigned ofmt_n_threads() {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        long v = atol(env);
        if (v > 0) nt = (unsigned)v;
    }
    if (nt == 0) nt = 1;
    return nt;
}

// CPython repr(float) — see file header.  out must hold >= 32 bytes.
// Returns the byte length.
int py_repr_double(double v, char* out) {
    if (std::isnan(v)) { memcpy(out, "nan", 3); return 3; }
    if (std::isinf(v)) {
        if (v < 0) { memcpy(out, "-inf", 4); return 4; }
        memcpy(out, "inf", 3); return 3;
    }
    char tmp[40];
    auto r = std::to_chars(tmp, tmp + sizeof(tmp) - 1, v,
                           std::chars_format::scientific);
    *r.ptr = '\0';              // to_chars does not NUL-terminate
    // parse [-]d[.ddd]e[+-]E+
    const char* p = tmp;
    char* w = out;
    if (*p == '-') { *w++ = '-'; p++; }
    char digits[24];
    int nd = 0;
    digits[nd++] = *p++;
    if (*p == '.') {
        p++;
        while (p < r.ptr && *p != 'e') digits[nd++] = *p++;
    }
    // p at 'e'
    int E = (int)strtol(p + 1, nullptr, 10);
    int decpt = E + 1;
    if (decpt < -3 || decpt > 16) {
        // exponent form: d[.ddd]e[+-]EE
        *w++ = digits[0];
        if (nd > 1) {
            *w++ = '.';
            memcpy(w, digits + 1, nd - 1);
            w += nd - 1;
        }
        *w++ = 'e';
        int e = decpt - 1;
        *w++ = e < 0 ? '-' : '+';
        if (e < 0) e = -e;
        if (e >= 100) { *w++ = (char)('0' + e / 100); e %= 100; }
        *w++ = (char)('0' + e / 10);
        *w++ = (char)('0' + e % 10);
    } else if (decpt <= 0) {
        // 0.00ddd
        *w++ = '0';
        *w++ = '.';
        for (int i = 0; i < -decpt; i++) *w++ = '0';
        memcpy(w, digits, nd);
        w += nd;
    } else if (decpt >= nd) {
        // ddd000.0
        memcpy(w, digits, nd);
        w += nd;
        for (int i = 0; i < decpt - nd; i++) *w++ = '0';
        *w++ = '.';
        *w++ = '0';
    } else {
        // dd.ddd
        memcpy(w, digits, decpt);
        w += decpt;
        *w++ = '.';
        memcpy(w, digits + decpt, nd - decpt);
        w += nd - decpt;
    }
    return (int)(w - out);
}

}  // namespace

extern "C" {

// Exposed for the fuzz parity test: repr each of n doubles into out as
// concatenated bytes with (n+1) exclusive offsets in o_off.
void py_repr_doubles(int64_t n, const double* v, uint8_t* out,
                     int64_t* o_off) {
    int64_t pos = 0;
    o_off[0] = 0;
    for (int64_t i = 0; i < n; i++) {
        pos += py_repr_double(v[i], (char*)out + pos);
        o_off[i + 1] = pos;
    }
}

// Format n orth rows 'TAG\ta\tb\trepr(w)\n'.  Names arrive as one
// concatenated utf-8 blob with (len+1) exclusive offsets; a_i/b_i are
// per-row indices.  out must hold cap bytes; out_n[0] = total bytes,
// or -1 if cap would overflow (caller falls back to the Python path).
void format_orth_rows(int64_t n, const uint8_t* tag, int64_t tag_len,
                      const int64_t* a_i, const int64_t* b_i,
                      const double* wv,
                      const uint8_t* blob, const int64_t* off,
                      uint8_t* out, int64_t cap, int64_t* out_n) {
    unsigned nt = ofmt_n_threads();
    if ((int64_t)nt > n && n > 0) nt = (unsigned)n;
    if (nt == 0) nt = 1;
    const int64_t step = (n + nt - 1) / (int64_t)nt;
    std::vector<std::vector<char>> bufs(nt);

    auto work = [&](unsigned t) {
        const int64_t lo = t * step;
        const int64_t hi = std::min<int64_t>(n, lo + step);
        if (lo >= hi) return;
        std::vector<char>& buf = bufs[t];
        buf.reserve((size_t)(hi - lo) * 48);
        char num[40];
        for (int64_t i = lo; i < hi; i++) {
            const int64_t a = a_i[i], b = b_i[i];
            const char* as = (const char*)blob + off[a];
            const int64_t an = off[a + 1] - off[a];
            const char* bs = (const char*)blob + off[b];
            const int64_t bn = off[b + 1] - off[b];
            const int wn = py_repr_double(wv[i], num);
            const size_t base = buf.size();
            buf.resize(base + tag_len + 1 + an + 1 + bn + 1 + wn + 1);
            char* w = buf.data() + base;
            memcpy(w, tag, tag_len); w += tag_len;
            *w++ = '\t';
            memcpy(w, as, an); w += an;
            *w++ = '\t';
            memcpy(w, bs, bn); w += bn;
            *w++ = '\t';
            memcpy(w, num, wn); w += wn;
            *w++ = '\n';
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
    int64_t boff = 0;
    for (unsigned t = 0; t < nt; t++) {
        if (!bufs[t].empty())
            memcpy(out + boff, bufs[t].data(), bufs[t].size());
        boff += (int64_t)bufs[t].size();
    }
    out_n[0] = boff;
}

}  // extern "C"
