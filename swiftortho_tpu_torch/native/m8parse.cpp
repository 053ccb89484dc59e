// m8 hit-table block parser for the vectorized orth fast path
// (orth/fast.py).  Mirrors the row handling of reference
// bin/find_orth.py blastparse (:158-234) as reimplemented in
// orth/inference.parse_sc_rows:
//   - a row is a '\n'-terminated line, fields split on '\t' (the final
//     line of a block may omit the '\n');
//   - rows with fewer than 12 fields are skipped silently;
//   - on a >=12-field row, qid (f0) and sid (f1) must contain the
//     taxon separator byte or the parse aborts with that row's index
//     (the Python wrapper raises ValueError like parse_sc_rows);
//   - float fields f2 (idy), f3 (aln), f6 (qst), f7 (qed), f11 (score)
//     and, when >13 fields, f12 (qln): any parse failure skips the row;
//   - rows with 12-13 fields are reported (rc 2) so the caller can fall
//     back to the pure-Python path, which owns the reference's
//     first-seen query-length cache for short rows (inference.py:69-73).
//
// Float parsing deviations from CPython float(), named: PEP-515
// underscore grouping is rejected, and hex-float forms are rejected
// (strtod would accept them); both are unobservable on real m8 tables
// and the pure-Python path remains available (SWIFTORTHO_NATIVE_ORTH=0).
//
// Names are interned in first-seen order across the block; the caller
// merges block-local ids into its global table.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

unsigned m8_n_threads() {
    unsigned nt = std::thread::hardware_concurrency();
    if (const char* env = getenv("SWNATIVE_THREADS")) {
        long v = atol(env);
        if (v > 0) nt = (unsigned)v;
    }
    if (nt == 0) nt = 1;
    return nt;
}

struct SV {
    const char* p;
    size_t n;
    bool operator==(const SV& o) const {
        return n == o.n && std::memcmp(p, o.p, n) == 0;
    }
};
struct SVHash {
    size_t operator()(const SV& s) const {
        // FNV-1a
        uint64_t h = 1469598103934665603ULL;
        for (size_t i = 0; i < s.n; i++) {
            h ^= (unsigned char)s.p[i];
            h *= 1099511628211ULL;
        }
        return (size_t)h;
    }
};

static bool py_float(const char* b, const char* e, double* out) {
    while (b < e && std::isspace((unsigned char)*b)) b++;
    while (e > b && std::isspace((unsigned char)e[-1])) e--;
    if (b == e) return false;
    for (const char* c = b; c < e; c++)
        if (*c == '_' || *c == 'x' || *c == 'X') return false;
    // in-place strtod: after the trim, e points at a '\t'/'\n'/end-of-
    // buffer sentinel (the wrapper appends '\n'), none of which can be
    // part of a number, so strtod stops exactly at or before e; a full
    // parse must consume precisely [b, e)
    char* endp = nullptr;
    double v = std::strtod(b, &endp);
    if (endp != e) return false;
    *out = v;
    return true;
}

}  // namespace

extern "C" {

// Returns 0 ok; 1 = sep-missing id (first offending valid row's line
// start offset in *o_badoff); 2 = a 12/13-field row seen (caller must
// fall back).  Output arrays are caller-allocated with capacity =
// number of '\n' in the block + 1.
//   o_q, o_s      int64[cap]   block-local interned ids per valid row
//   o_f           double[cap*6] idy, aln, qst, qed, score, qln
//   o_nrows       int64[1]
//   o_nameoff     int64[cap*4+2] byte offsets of interned names into
//                 the BLOCK text (start0, end0, start1, end1, ...);
//                 up to 2 fresh names per valid row = 4 offsets
//   o_nnames      int64[1]
int m8parse_block(const char* text, int64_t len, uint8_t sep,
                  int64_t* o_q, int64_t* o_s, double* o_f,
                  int64_t* o_nrows, int64_t* o_nameoff,
                  int64_t* o_nnames, int64_t* o_badoff) {
    // Threaded over newline-aligned sub-ranges; each worker interns
    // into a local table and the ranges are merged in text order, so
    // row order is exactly the sequential parse's.  Block-local id
    // NUMBERING may differ from the sequential first-seen order — the
    // caller (orth/fast.py) treats ids as opaque equality keys (ranks/
    // taxa/output strings all go through the name table), so outputs
    // are unchanged (the parity suite pins them byte-for-byte).
    // Anomaly semantics: the sequential parse stops at the FIRST
    // sep-missing (rc 1) or 12/13-field (rc 2) row; workers record
    // their first anomaly's line offset and the earliest one in text
    // order wins, reproducing the sequential rc exactly (the wrapper
    // discards all partial output on rc != 0).
    struct Part {
        std::vector<int64_t> q, s;
        std::vector<double> f;
        std::vector<SV> names;
        int rc = 0;
        int64_t badoff = 0;
    };
    const char* base = text;
    const char* end = text + len;

    unsigned nt = m8_n_threads();
    if (len < (1 << 20)) nt = 1;
    // newline-aligned range starts
    std::vector<const char*> starts;
    starts.push_back(text);
    for (unsigned t = 1; t < nt; t++) {
        const char* guess = text + (len * t) / nt;
        if (guess <= starts.back()) continue;
        const char* nl = (const char*)std::memchr(
            guess, '\n', (size_t)(end - guess));
        const char* st = nl ? nl + 1 : end;
        if (st > starts.back() && st < end) starts.push_back(st);
    }
    const unsigned np = (unsigned)starts.size();
    std::vector<Part> parts(np);

    auto work = [&](unsigned t) {
        Part& P = parts[t];
        std::unordered_map<SV, int64_t, SVHash> intern;
        intern.reserve(1 << 16);
        const char* line = starts[t];
        const char* lim = (t + 1 < np) ? starts[t + 1] : end;
        const int NEED = 13;  // field starts tracked: f0..f12
        const char* fs[NEED + 1];
        while (line < lim) {
        const char* nl = (const char*)std::memchr(line, '\n',
                                                  (size_t)(lim - line));
        const char* le = nl ? nl : lim;
        // split on '\t' (rstrip('\n') semantics: le excludes the '\n')
        int nf = 0;
        fs[0] = line;
        const char* c = line;
        while (c < le && nf < NEED) {
            const char* t = (const char*)std::memchr(c, '\t',
                                                     (size_t)(le - c));
            if (!t) break;
            nf++;
            fs[nf] = t + 1;
            c = t + 1;
        }
        // nf+1 fields located so far; count remaining tabs for the
        // 12-field minimum / 13-field ("len(f) > 13") decisions
        int extra = 0;
        for (const char* t = c; t < le; t++)
            if (*t == '\t') extra++;
        const int nfields = nf + 1 + (nf == NEED ? extra : 0);
        const char* lstart = line;
        line = nl ? nl + 1 : lim;
        if (nfields < 12) continue;
        // field k spans [fs[k], end of field)
        auto fend = [&](int k) -> const char* {
            if (k < nf) return fs[k + 1] - 1;
            // k == nf: up to next tab or line end
            const char* t = (const char*)std::memchr(
                fs[k], '\t', (size_t)(le - fs[k]));
            return t ? t : le;
        };
        const char* q0 = fs[0];
        const char* q1 = fend(0);
        const char* s0 = fs[1];
        const char* s1 = fend(1);
        if (!std::memchr(q0, sep, (size_t)(q1 - q0))
            || !std::memchr(s0, sep, (size_t)(s1 - s0))) {
            P.rc = 1;
            P.badoff = (int64_t)(lstart - base);
            break;
        }
        if (nfields < 14) {          // python path owns len_dict rows
            P.rc = 2;
            P.badoff = (int64_t)(lstart - base);
            break;
        }
        double idy, aln, qst, qed, sco, qln;
        if (!py_float(fs[2], fend(2), &idy)) continue;
        if (!py_float(fs[3], fend(3), &aln)) continue;
        if (!py_float(fs[6], fend(6), &qst)) continue;
        if (!py_float(fs[7], fend(7), &qed)) continue;
        if (!py_float(fs[11], fend(11), &sco)) continue;
        if (!py_float(fs[12], fend(12), &qln)) continue;
        auto get_id = [&](const char* b, const char* e2) -> int64_t {
            SV key{b, (size_t)(e2 - b)};
            auto it = intern.find(key);
            if (it != intern.end()) return it->second;
            int64_t id = (int64_t)P.names.size();
            intern.emplace(key, id);
            P.names.push_back(key);
            return id;
        };
        P.q.push_back(get_id(q0, q1));
        P.s.push_back(get_id(s0, s1));
        P.f.push_back(idy); P.f.push_back(aln); P.f.push_back(qst);
        P.f.push_back(qed); P.f.push_back(sco); P.f.push_back(qln);
        }
    };
    {
        std::vector<std::thread> threads;
        for (unsigned t = 1; t < np; t++) threads.emplace_back(work, t);
        work(0);
        for (auto& th : threads) th.join();
    }

    // earliest anomaly in text order wins (== the sequential rc)
    int rc = 0;
    int64_t badoff = 0;
    for (unsigned t = 0; t < np; t++) {
        if (parts[t].rc && (!rc || parts[t].badoff < badoff)) {
            rc = parts[t].rc;
            badoff = parts[t].badoff;
        }
    }
    if (rc) {
        *o_badoff = badoff;
        *o_nrows = 0;
        *o_nnames = 0;
        return rc;
    }

    // merge: block intern over per-thread names, rows in text order
    std::unordered_map<SV, int64_t, SVHash> intern;
    intern.reserve(1 << 16);
    int64_t nrows = 0, nnames = 0;
    std::vector<int64_t> lut;
    for (unsigned t = 0; t < np; t++) {
        Part& P = parts[t];
        lut.resize(P.names.size());
        for (size_t i = 0; i < P.names.size(); i++) {
            const SV key = P.names[i];
            auto it = intern.find(key);
            if (it != intern.end()) {
                lut[i] = it->second;
            } else {
                const int64_t id = nnames++;
                intern.emplace(key, id);
                o_nameoff[id * 2] = (int64_t)(key.p - base);
                o_nameoff[id * 2 + 1] = (int64_t)(key.p + key.n - base);
                lut[i] = id;
            }
        }
        const size_t nr = P.q.size();
        for (size_t i = 0; i < nr; i++) {
            o_q[nrows + (int64_t)i] = lut[P.q[i]];
            o_s[nrows + (int64_t)i] = lut[P.s[i]];
        }
        std::memcpy(o_f + nrows * 6, P.f.data(),
                    nr * 6 * sizeof(double));
        nrows += (int64_t)nr;
    }
    *o_nrows = nrows;
    *o_nnames = nnames;
    return 0;
}

}  // extern "C"

extern "C" {

// Sequential (left-fold) segmented sum: o_sum[i] = 0.0 + v[starts[i]]
// + ... in index order.  numpy's reduce/reduceat use pairwise
// summation, which changes low bits vs the reference's dict `+=`
// accumulation; this preserves the exact fold order.
void seg_sum_seq(const double* v, const int64_t* starts, int64_t nseg,
                 int64_t n, double* o_sum) {
    for (int64_t i = 0; i < nseg; i++) {
        const int64_t en = (i + 1 < nseg) ? starts[i + 1] : n;
        double a = 0.0;
        for (int64_t j = starts[i]; j < en; j++) a += v[j];
        o_sum[i] = a;
    }
}

}  // extern "C"
