"""Native (C++) host kernels, loaded via ctypes.

Builds on demand (the reference compiles its RPython kernel on first run
the same way, bin/find_hit.py:198-209).  The shared object is a build
artifact, never committed: it is validated against a sha256 of the
sources + compile command before loading, so a stale or foreign-host
binary is always rebuilt rather than trusted (mtimes are unreliable after
a fresh clone).  -march=native is attempted first and falls back to a
portable -O3 build on compilers/targets that reject it.

Copied from ``swiftortho_tpu/native/__init__.py``, with the eight C++
sources beside it: the port keeps its own copy of this host module,
builds its own ``libswnative.so`` here and imports nothing of the JAX
package.  One repair: the build writes a temporary file and publishes it
with ``os.replace`` under an ``fcntl`` lock on ``libswnative.so.lock``,
so processes that load the library at once (test workers) never race on
a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..constants import B62_BYTES, GAP_EXTEND, GAP_OPEN, KBOUND

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, 'libswnative.so')
_HASH = _SO + '.hash'
_lock = threading.Lock()
_lib = None


_SOURCES = ('banded_sw.cpp', 'chain.cpp', 'groupby.cpp', 'seg.cpp',
            'fmtrows.cpp', 'apclust.cpp', 'm8parse.cpp', 'orthfmt.cpp')
_FLAG_SETS = (['-O3', '-march=native'], ['-O3'])


def _source_hash(flags) -> str:
    h = hashlib.sha256()
    h.update(' '.join(flags).encode())
    for s in _SOURCES:
        with open(os.path.join(_HERE, s), 'rb') as f:
            h.update(f.read())
    return h.hexdigest()


def _build() -> str:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    tmp = '%s.%d.tmp' % (_SO, os.getpid())
    err = None
    for flags in _FLAG_SETS:
        cmd = ['g++'] + flags + ['-shared', '-fPIC', '-o', tmp] + srcs
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, OSError) as e:
            err = e
            continue
        with open(tmp + '.hash', 'w') as f:
            f.write(_source_hash(flags))
        os.replace(tmp, _SO)
        os.replace(tmp + '.hash', _HASH)
        return _SO
    if os.path.exists(tmp):
        os.remove(tmp)
    raise RuntimeError('native build failed: %r' % (err,))


def _valid() -> bool:
    """The .so is trusted only if its recorded build hash matches the
    current sources (for either flag set)."""
    if not os.path.exists(_SO) or not os.path.exists(_HASH):
        return False
    with open(_HASH) as f:
        recorded = f.read().strip()
    return any(recorded == _source_hash(fl) for fl in _FLAG_SETS)


def _build_locked():
    """Check and (re)build under an exclusive lock shared by every process
    that loads the library from this directory."""
    with open(_SO + '.lock', 'w') as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _valid():
                _build()
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build_locked()
        lib = ctypes.CDLL(_SO)
        lib.sw_align_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        lib.sw_align_batch.restype = None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.chain_scores.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            i64p, i64p, ctypes.c_int64,
            i64p, i64p, i64p, i64p, i64p, i64p,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32, i64p]
        lib.chain_scores.restype = None
        lib.gather_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gather_rows.restype = None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.expand_group.argtypes = [
            i64p, i64p, i64p, i64p, ctypes.c_int64,
            i32p, i32p, ctypes.c_int64,
            i64p, i64p, i64p, i64p, i64p, i64p, i64p]
        lib.expand_group.restype = None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.candidates_fused.argtypes = [
            i64p, i64p, i64p, i64p, ctypes.c_int64,
            i32p, i32p, ctypes.c_int64,
            u8p, ctypes.c_int64, u8p, i64p, i64p,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64,
            i64p, i64p, i64p, i64p, i64p, i64p]
        lib.candidates_fused.restype = None
        lib.index_csr_scatter.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
        lib.index_csr_scatter.restype = None
        lib.decode_locus.argtypes = [
            i64p, ctypes.c_int64, i64p, ctypes.c_int64, i32p, i32p]
        lib.decode_locus.restype = None
        lib.budget_keep.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64,
            i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.budget_keep.restype = None
        lib.hash_seeds_pattern.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p]
        lib.hash_seeds_pattern.restype = None
        lib.seg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.seg_batch.restype = None
        lib.apclust_ref.argtypes = [
            i64p, i64p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32, i64p]
        lib.apclust_ref.restype = None
        lib.rank_cut.argtypes = [
            i64p, i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p]
        lib.rank_cut.restype = None
        f64p = ctypes.POINTER(ctypes.c_double)
        u8pp = ctypes.POINTER(ctypes.c_uint8)
        lib.format_rows.argtypes = [
            ctypes.c_int64,
            f64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
            f64p, i64p, i64p, i64p, i64p,
            i64p, u8pp, i64p,
            i64p, u8pp, i64p,
            u8pp, i64p,
            u8pp, ctypes.c_int64, i64p, i64p]
        lib.format_rows.restype = None
        lib.m8parse_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint8,
            i64p, i64p, f64p, i64p, i64p, i64p, i64p]
        lib.m8parse_block.restype = ctypes.c_int
        lib.seg_sum_seq.argtypes = [
            f64p, i64p, ctypes.c_int64, ctypes.c_int64, f64p]
        lib.seg_sum_seq.restype = None
        _lib = lib
        return _lib


_SUB = np.ascontiguousarray(B62_BYTES.astype(np.int8))


def sw_align_batch_native(tok0: np.ndarray, tok1: np.ndarray,
                          len0: np.ndarray, len1: np.ndarray,
                          kbound: int = KBOUND, go: int = GAP_OPEN,
                          ge: int = GAP_EXTEND) -> dict:
    """Same contract as ops.banded_sw.sw_align_batch, on the host CPU."""
    lib = load()
    tok0 = np.ascontiguousarray(tok0, np.uint8)
    tok1 = np.ascontiguousarray(tok1, np.uint8)
    len0 = np.ascontiguousarray(len0, np.int32)
    len1 = np.ascontiguousarray(len1, np.int32)
    B, pad0 = tok0.shape
    _, pad1 = tok1.shape
    out = np.zeros((B, 9), np.int32)
    lib.sw_align_batch(
        tok0.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tok1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, pad0, pad1,
        _SUB.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        kbound, go, ge,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    keys = ('score', 'bi', 'bj', 'sti', 'stj', 'idy', 'aln', 'mis', 'gap')
    return {k: out[:, i].astype(np.int64) for i, k in enumerate(keys)}


def chain_scores_native(q_tokens: np.ndarray, db_tokens: np.ndarray,
                        grp_start: np.ndarray, grp_size: np.ndarray,
                        g_qrow: np.ndarray, g_diag: np.ndarray,
                        s_off: np.ndarray, s_len: np.ndarray,
                        q_len: np.ndarray, p_qst: np.ndarray,
                        xdrop: int = 30) -> np.ndarray:
    """Exact chain scores (reference get_ungap_scores semantics) for
    (subject, diagonal) groups; see native/chain.cpp."""
    lib = load()
    q_tokens = np.ascontiguousarray(q_tokens, np.uint8)
    db_tokens = np.ascontiguousarray(db_tokens, np.uint8)
    arrs = [np.ascontiguousarray(a, np.int64) for a in
            (grp_start, grp_size, g_qrow, g_diag, s_off, s_len, q_len,
             p_qst)]
    n = len(arrs[0])
    out = np.zeros(n, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.chain_scores(
        q_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        q_tokens.shape[1],
        db_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(db_tokens),
        arrs[0].ctypes.data_as(i64p), arrs[1].ctypes.data_as(i64p), n,
        arrs[2].ctypes.data_as(i64p), arrs[3].ctypes.data_as(i64p),
        arrs[4].ctypes.data_as(i64p), arrs[5].ctypes.data_as(i64p),
        arrs[6].ctypes.data_as(i64p), arrs[7].ctypes.data_as(i64p),
        _SUB.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        xdrop, out.ctypes.data_as(i64p))
    return out


def gather_rows(src: np.ndarray, starts: np.ndarray,
                counts: np.ndarray, row_idx: np.ndarray,
                dst: np.ndarray):
    """dst[row_idx[i], :counts[i]] = src[starts[i]:...]; zero tails.

    Uses the native kernel when a compiler / loadable .so is available;
    otherwise an exact (slower) numpy fallback so the search path never
    hard-depends on g++."""
    try:
        gather_rows_native(src, starts, counts, row_idx, dst)
        return
    except Exception:
        from ..utils import warn_fallback
        warn_fallback('gather_rows',
                      'native .so unavailable; exact numpy row copies')
    flat = np.ascontiguousarray(src).reshape(-1)
    for s, c, r in zip(starts, counts, row_idx):
        c = int(c)
        dst[r, :c] = flat[int(s):int(s) + c]
        dst[r, c:] = 0


def expand_group_native(rows: np.ndarray, qst: np.ndarray,
                        counts: np.ndarray, starts: np.ndarray,
                        sid: np.ndarray, sst: np.ndarray, n_qrows: int):
    """Posting expansion + (qrow, sid, diag) grouping with (group, qst)
    dedup — the native counterpart of the numpy block in
    search/candidates.py; see native/groupby.cpp for the contract.

    Returns (p_qst, grp_start, grp_size, g_qrow, g_sid, g_diag), all
    int64; grp_start indexes into p_qst."""
    lib = load()
    r, q, c, s = (np.ascontiguousarray(a, np.int64)
                  for a in (rows, qst, counts, starts))
    sid = np.ascontiguousarray(sid, np.int32)
    sst = np.ascontiguousarray(sst, np.int32)
    total = int(c.sum())
    o_qst = np.empty(total, np.int64)
    o_gs = np.empty(total, np.int64)
    o_gz = np.empty(total, np.int64)
    o_gq = np.empty(total, np.int64)
    o_gsid = np.empty(total, np.int64)
    o_gd = np.empty(total, np.int64)
    out_n = np.zeros(2, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.expand_group(
        r.ctypes.data_as(i64p), q.ctypes.data_as(i64p),
        c.ctypes.data_as(i64p), s.ctypes.data_as(i64p), len(r),
        sid.ctypes.data_as(i32p), sst.ctypes.data_as(i32p),
        int(n_qrows),
        o_qst.ctypes.data_as(i64p), o_gs.ctypes.data_as(i64p),
        o_gz.ctypes.data_as(i64p), o_gq.ctypes.data_as(i64p),
        o_gsid.ctypes.data_as(i64p), o_gd.ctypes.data_as(i64p),
        out_n.ctypes.data_as(i64p))
    nd, ng = int(out_n[0]), int(out_n[1])
    return (o_qst[:nd], o_gs[:ng], o_gz[:ng], o_gq[:ng], o_gsid[:ng],
            o_gd[:ng])


def candidates_fused_native(rows: np.ndarray, qst: np.ndarray,
                            counts: np.ndarray, starts: np.ndarray,
                            sid: np.ndarray, sst: np.ndarray,
                            n_qrows: int, q_tokens: np.ndarray,
                            db_tokens: np.ndarray, db_offsets: np.ndarray,
                            q_len: np.ndarray, xdrop: int,
                            min_score: int):
    """Fused expansion + grouping + exact chain scoring + gate +
    best-per-(query, subject) — see native/groupby.cpp candidates_fused.

    Returns (qrow, sid, score, diag_fold, diag_raw) int64 arrays of the
    gated candidates ordered (qrow asc, sid asc); the caller picks the
    tie-break diagonal column (fold vs raw) with the numpy
    _finish_candidates range conditions so output stays byte-identical.
    """
    lib = load()
    r, q, c, s = (np.ascontiguousarray(a, np.int64)
                  for a in (rows, qst, counts, starts))
    sid = np.ascontiguousarray(sid, np.int32)
    sst = np.ascontiguousarray(sst, np.int32)
    q_tokens = np.ascontiguousarray(q_tokens, np.uint8)
    db_tokens = np.ascontiguousarray(db_tokens, np.uint8)
    db_offsets = np.ascontiguousarray(db_offsets, np.int64)
    q_len = np.ascontiguousarray(q_len, np.int64)
    cap = int(c.sum())              # rows <= groups <= postings
    o_qrow = np.empty(cap, np.int64)
    o_sid = np.empty(cap, np.int64)
    o_score = np.empty(cap, np.int64)
    o_df = np.empty(cap, np.int64)
    o_dr = np.empty(cap, np.int64)
    out_n = np.zeros(1, np.int64)
    # 56-bit packed radix sort preconditions (see groupby.cpp): subject
    # ids < 2^21, query pad and the longest subject < 2^17
    n_db = len(db_offsets) - 1
    max_slen = int((db_offsets[1:] - db_offsets[:-1]).max()) if n_db \
        else 0
    packed_ok = int(n_db < (1 << 21) and q_tokens.shape[1] <= (1 << 17)
                    and max_slen < (1 << 17))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.candidates_fused(
        r.ctypes.data_as(i64p), q.ctypes.data_as(i64p),
        c.ctypes.data_as(i64p), s.ctypes.data_as(i64p), len(r),
        sid.ctypes.data_as(i32p), sst.ctypes.data_as(i32p), int(n_qrows),
        q_tokens.ctypes.data_as(u8p), q_tokens.shape[1],
        db_tokens.ctypes.data_as(u8p),
        db_offsets.ctypes.data_as(i64p), q_len.ctypes.data_as(i64p),
        _SUB.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(xdrop), int(min_score), packed_ok,
        o_qrow.ctypes.data_as(i64p), o_sid.ctypes.data_as(i64p),
        o_score.ctypes.data_as(i64p), o_df.ctypes.data_as(i64p),
        o_dr.ctypes.data_as(i64p), out_n.ctypes.data_as(i64p))
    n = int(out_n[0])
    return o_qrow[:n], o_sid[:n], o_score[:n], o_df[:n], o_dr[:n]


def rank_cut_native(qrow: np.ndarray, subj: np.ndarray, csc: np.ndarray,
                    bq: np.ndarray, bs: np.ndarray, n_queries: int,
                    vmax: int):
    """Per-wave candidate ranking: (qrow asc, score desc, subject asc,
    input order) + vmax cut — identical ordering to the numpy packed-key
    / lexsort paths in blastp._wave_body.  Returns (qrow, subj, csc, bq,
    bs, rank, nhits_of) with nhits_of counted before the cut."""
    lib = load()
    arrs = [np.ascontiguousarray(a, np.int64)
            for a in (qrow, subj, csc, bq, bs)]
    n = len(arrs[0])
    o = [np.empty(n, np.int64) for _ in range(6)]
    o_nhits = np.zeros(n_queries, np.int64)
    out_n = np.zeros(1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rank_cut(*[a.ctypes.data_as(i64p) for a in arrs],
                 n, int(n_queries), int(vmax),
                 *[a.ctypes.data_as(i64p) for a in o],
                 o_nhits.ctypes.data_as(i64p),
                 out_n.ctypes.data_as(i64p))
    m = int(out_n[0])
    return tuple(a[:m] for a in o) + (o_nhits,)


def encode_blob(strings) -> tuple:
    """Concatenate strings into one utf-8 byte blob + exclusive offsets
    (the string-column transport of format_rows_native)."""
    bs = [s.encode() for s in strings]
    off = np.zeros(len(bs) + 1, np.int64)
    np.cumsum([len(b) for b in bs], out=off[1:])
    return np.frombuffer(b''.join(bs), np.uint8), off


def format_rows_native(fields: dict, qid_i, qid_blob, qid_off,
                       sid_i, refid_blob, refid_off,
                       refdesc_blob, refdesc_off):
    """Format n m8 rows char-for-char like the Python path (see
    native/fmtrows.cpp).  Returns (buffer bytes, per-row end offsets)."""
    lib = load()
    n = len(qid_i)
    f64 = [np.ascontiguousarray(fields[k], np.float64)
           for k in ('idy', 'e')]
    i64 = {k: np.ascontiguousarray(fields[k], np.int64)
           for k in ('aln', 'mis', 'gap', 'qst1', 'qed', 'sst1', 'sed',
                     'bit', 'qlen', 'slen', 'qidx')}
    qid_i = np.ascontiguousarray(qid_i, np.int64)
    sid_i = np.ascontiguousarray(sid_i, np.int64)
    qid_blob = np.ascontiguousarray(qid_blob, np.uint8)
    refid_blob = np.ascontiguousarray(refid_blob, np.uint8)
    refdesc_blob = np.ascontiguousarray(refdesc_blob, np.uint8)
    qid_off = np.ascontiguousarray(qid_off, np.int64)
    refid_off = np.ascontiguousarray(refid_off, np.int64)
    refdesc_off = np.ascontiguousarray(refdesc_off, np.int64)
    # capacity: strings + a generous 200 bytes of numeric columns per row
    cap = int((qid_off[qid_i + 1] - qid_off[qid_i]).sum()
              + (refid_off[sid_i + 1] - refid_off[sid_i]).sum()
              + (refdesc_off[sid_i + 1] - refdesc_off[sid_i]).sum()
              + n * 200 + 64)
    out = np.empty(cap, np.uint8)
    o_end = np.empty(max(n, 1), np.int64)
    out_n = np.zeros(1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.format_rows(
        n, f64[0].ctypes.data_as(f64p),
        *[i64[k].ctypes.data_as(i64p)
          for k in ('aln', 'mis', 'gap', 'qst1', 'qed', 'sst1', 'sed')],
        f64[1].ctypes.data_as(f64p),
        *[i64[k].ctypes.data_as(i64p)
          for k in ('bit', 'qlen', 'slen', 'qidx')],
        qid_i.ctypes.data_as(i64p), qid_blob.ctypes.data_as(u8p),
        qid_off.ctypes.data_as(i64p),
        sid_i.ctypes.data_as(i64p), refid_blob.ctypes.data_as(u8p),
        refid_off.ctypes.data_as(i64p),
        refdesc_blob.ctypes.data_as(u8p), refdesc_off.ctypes.data_as(i64p),
        out.ctypes.data_as(u8p), cap,
        o_end.ctypes.data_as(i64p), out_n.ctypes.data_as(i64p))
    total = int(out_n[0])
    if total < 0:
        raise RuntimeError('format_rows capacity overflow')
    return out[:total].tobytes(), o_end[:n]


def py_repr_doubles_native(vals) -> list:
    """CPython repr(float) of each value via native/orthfmt.cpp —
    fuzz-parity-tested against str(float) (the orth weight column's
    formatting contract, orth/inference.py:270-281)."""
    lib = load()
    v = np.ascontiguousarray(vals, np.float64)
    n = len(v)
    out = np.empty(max(n, 1) * 32, np.uint8)
    off = np.empty(n + 1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.py_repr_doubles(ctypes.c_int64(n), v.ctypes.data_as(f64p),
                        out.ctypes.data_as(u8p),
                        off.ctypes.data_as(i64p))
    buf = out.tobytes()
    return [buf[off[i]:off[i + 1]].decode() for i in range(n)]


def format_orth_rows_native(tag: str, a_i, b_i, w,
                            blob, off) -> bytes:
    """Format n orth output rows 'TAG\\ta\\tb\\tstr(w)\\n' char-for-char
    like the Python path (see native/orthfmt.cpp).  Names arrive as an
    encode_blob() pair; returns the concatenated row bytes."""
    lib = load()
    a_i = np.ascontiguousarray(a_i, np.int64)
    b_i = np.ascontiguousarray(b_i, np.int64)
    w = np.ascontiguousarray(w, np.float64)
    blob = np.ascontiguousarray(blob, np.uint8)
    off = np.ascontiguousarray(off, np.int64)
    n = len(a_i)
    if len(b_i) != n or len(w) != n:
        raise ValueError('format_orth_rows: length mismatch')
    if n and (int(a_i.max()) >= len(off) - 1 or int(b_i.max()) >= len(off) - 1
              or int(a_i.min()) < 0 or int(b_i.min()) < 0):
        raise ValueError('format_orth_rows: name index out of range')
    tagb = np.frombuffer(tag.encode(), np.uint8)
    cap = int((off[a_i + 1] - off[a_i]).sum()
              + (off[b_i + 1] - off[b_i]).sum()
              + n * (len(tagb) + 4 + 32) + 64)
    out = np.empty(cap, np.uint8)
    out_n = np.zeros(1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.format_orth_rows(
        ctypes.c_int64(n), tagb.ctypes.data_as(u8p),
        ctypes.c_int64(len(tagb)),
        a_i.ctypes.data_as(i64p), b_i.ctypes.data_as(i64p),
        w.ctypes.data_as(f64p),
        blob.ctypes.data_as(u8p), off.ctypes.data_as(i64p),
        out.ctypes.data_as(u8p), ctypes.c_int64(cap),
        out_n.ctypes.data_as(i64p))
    total = int(out_n[0])
    if total < 0:
        raise RuntimeError('format_orth_rows capacity overflow')
    return out[:total].tobytes()


def seg_batch_native(tokens: np.ndarray, lengths: np.ndarray,
                     window: int, minent: float) -> np.ndarray:
    """SEG masking of a padded (B, L) batch — bit-for-bit the sequential
    oracle ops/seg.seg_string (native/seg.cpp), threaded over rows."""
    lib = load()
    tokens = np.ascontiguousarray(tokens, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    B, L = tokens.shape
    out = np.empty((B, L), np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.seg_batch(
        tokens.ctypes.data_as(u8p), B, L, lengths.ctypes.data_as(i64p),
        int(window), float(minent), out.ctypes.data_as(u8p))
    return out


def budget_keep_native(rows: np.ndarray, qst: np.ndarray,
                       counts: np.ndarray, order: np.ndarray,
                       budgets: np.ndarray, B: int,
                       nwin: int) -> np.ndarray:
    """Seed-budget keep mask — identical to the numpy block in
    search/candidates._self_score_budget (see groupby.cpp budget_keep).
    ``order`` is the (B, nwin) per-row position ranking from
    candidates.budget_order."""
    lib = load()
    r, q, c = (np.ascontiguousarray(a, np.int64)
               for a in (rows, qst, counts))
    order = np.ascontiguousarray(order, np.int64)
    budgets = np.ascontiguousarray(budgets, np.float64)
    if order.shape != (B, nwin):
        # the C++ kernel reads order[B*nwin] unchecked; this is the
        # trust boundary (asserts vanish under python -O)
        raise ValueError('order shape %r != (B=%d, nwin=%d)'
                         % (order.shape, B, nwin))
    keep = np.empty(len(r), np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.budget_keep(
        r.ctypes.data_as(i64p), q.ctypes.data_as(i64p),
        c.ctypes.data_as(i64p), len(r),
        order.ctypes.data_as(i64p), int(B), int(nwin),
        budgets.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)


def hash_seeds_pattern_native(tokens: np.ndarray, seq_of: np.ndarray,
                              code_tbl: np.ndarray, ones: np.ndarray,
                              klen: int, pat_idx: int, nc: int,
                              step: int):
    """Spaced-seed FNV hashing for one pattern — identical to the numpy
    block in ops/seeds.hash_seeds_flat (see groupby.cpp for the
    contract).  Returns (bucket, pos) int64 arrays in window order."""
    lib = load()
    tokens = np.ascontiguousarray(tokens, np.uint8)
    seq_of = np.ascontiguousarray(seq_of, np.int64)
    code_tbl = np.ascontiguousarray(code_tbl, np.uint8)
    ones = np.ascontiguousarray(ones, np.int64)
    n = max(0, len(tokens) - int(klen) + 1)
    o_b = np.empty(n, np.int64)
    o_p = np.empty(n, np.int64)
    out_n = np.zeros(1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hash_seeds_pattern(
        tokens.ctypes.data_as(u8p), seq_of.ctypes.data_as(i64p),
        len(tokens), code_tbl.ctypes.data_as(u8p),
        ones.ctypes.data_as(i64p), len(ones), int(klen), int(pat_idx),
        int(nc), int(step),
        o_b.ctypes.data_as(i64p), o_p.ctypes.data_as(i64p),
        out_n.ctypes.data_as(i64p))
    m = int(out_n[0])
    return o_b[:m], o_p[:m]


def index_csr_scatter_native(b: np.ndarray, p: np.ndarray, nc: int):
    """Stable counting sort of postings into CSR slots (the index-build
    bottleneck): returns (csr offsets (nc+1,), locus (n,)) identical to
    numpy bincount + cumsum + stable argsort-take."""
    lib = load()
    b = np.ascontiguousarray(b, np.int64)
    p = np.ascontiguousarray(p, np.int64)
    csr = np.empty(nc + 1, np.int64)
    locus = np.empty(len(b), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.index_csr_scatter(
        b.ctypes.data_as(i64p), p.ctypes.data_as(i64p), len(b), int(nc),
        csr.ctypes.data_as(i64p), locus.ctypes.data_as(i64p))
    return csr, locus


def decode_locus_native(soas: np.ndarray, loc: np.ndarray):
    """Reference-bisect posting decode (largest idx with soas[idx] < loc,
    clamped at 0); returns (sid, sst) int32."""
    lib = load()
    soas = np.ascontiguousarray(soas, np.int64)
    loc = np.ascontiguousarray(loc, np.int64)
    sid = np.empty(len(loc), np.int32)
    sst = np.empty(len(loc), np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.decode_locus(
        soas.ctypes.data_as(i64p), len(soas),
        loc.ctypes.data_as(i64p), len(loc),
        sid.ctypes.data_as(i32p), sst.ctypes.data_as(i32p))
    return sid, sst


def apclust_ref_native(ei: np.ndarray, ek: np.ndarray, s: np.ndarray,
                       n_nodes: int, damp: float = 0.5,
                       itr: int = 100) -> np.ndarray:
    """Reference-faithful streaming AP labels (see native/apclust.cpp for
    the emulated quirks; contract bin/find_cluster.py:406-513)."""
    lib = load()
    ei = np.ascontiguousarray(ei, np.int64)
    ek = np.ascontiguousarray(ek, np.int64)
    s = np.ascontiguousarray(s, np.float32)
    lab = np.empty(n_nodes, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.apclust_ref(
        ei.ctypes.data_as(i64p), ek.ctypes.data_as(i64p),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(ei), int(n_nodes), float(damp), int(itr),
        lab.ctypes.data_as(i64p))
    return lab


def gather_rows_native(src: np.ndarray, starts: np.ndarray,
                       counts: np.ndarray, row_idx: np.ndarray,
                       dst: np.ndarray):
    """dst[row_idx[i], :counts[i]] = src[starts[i]:...]; zero tails."""
    lib = load()
    src = np.ascontiguousarray(src.reshape(-1), np.uint8)
    a = [np.ascontiguousarray(x, np.int64) for x in (starts, counts, row_idx)]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gather_rows(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a[0].ctypes.data_as(i64p), a[1].ctypes.data_as(i64p),
        a[2].ctypes.data_as(i64p), len(a[0]), dst.shape[1],
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))


class M8SepError(ValueError):
    """A >=12-field row whose qid/sid lacks the taxon separator —
    parse_sc_rows raises ValueError for these (inference.py:54-55)."""


class M8ShortRows(Exception):
    """Block contains a 12/13-field row: only the pure-Python path
    implements the reference's first-seen query-length cache
    (inference.py:69-73), so the fast path must fall back."""


def m8parse_block_native(text: bytes, sep: bytes = b'|'):
    """Parse one block of m8 text (see native/m8parse.cpp contract).
    Returns (q_local, s_local, floats (n, 6), names list[str])."""
    lib = load()
    cap = text.count(b'\n') + 1
    q = np.empty(cap, np.int64)
    s = np.empty(cap, np.int64)
    f = np.empty((cap, 6), np.float64)
    nrows = np.zeros(1, np.int64)
    # names <= 2 per valid row, 2 offsets per name -> up to 4*cap
    nameoff = np.empty(cap * 4 + 2, np.int64)
    nnames = np.zeros(1, np.int64)
    badoff = np.zeros(1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.m8parse_block(
        ctypes.c_char_p(text), len(text), ord(sep),
        q.ctypes.data_as(i64p), s.ctypes.data_as(i64p),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nrows.ctypes.data_as(i64p), nameoff.ctypes.data_as(i64p),
        nnames.ctypes.data_as(i64p), badoff.ctypes.data_as(i64p))
    if rc == 1:
        off = int(badoff[0])
        qid = text[off:text.find(b'\t', off)].decode(errors='replace')
        raise M8SepError('id without taxon separator: %r' % qid)
    if rc == 2:
        raise M8ShortRows()
    n = int(nrows[0])
    m = int(nnames[0])
    names = [text[nameoff[i * 2]:nameoff[i * 2 + 1]].decode('latin-1')
             for i in range(m)]
    return q[:n], s[:n], f[:n], names


def seg_sum_seq_native(vals: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Left-fold segmented sums (see m8parse.cpp seg_sum_seq): exact
    accumulation order of a per-key dict `+=` over sorted-by-key rows."""
    lib = load()
    vals = np.ascontiguousarray(vals, np.float64)
    starts = np.ascontiguousarray(starts, np.int64)
    out = np.empty(len(starts), np.float64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.seg_sum_seq(vals.ctypes.data_as(f64p),
                    starts.ctypes.data_as(i64p),
                    len(starts), len(vals),
                    out.ctypes.data_as(f64p))
    return out
