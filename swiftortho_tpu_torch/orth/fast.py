"""Vectorized ortholog-inference fast path (native m8 parse + numpy).

Byte-identical to the streaming reference-parity implementation in
``orth.inference`` — same quirks, same line order — pinned by
tests/test_orth.py (fast vs ``SWIFTORTHO_NATIVE_ORTH=0``) and the
ref-parity suite.  The contract being reproduced is reference
bin/find_orth.py :158-234 (blastparse), :298-376 (get_qIPO/get_IPO),
:505-608 (IP weights, CO probing), :673-743 (get_sam_tax/n_co_ot); see
``orth.inference`` for the prose version.

Strategy: parse with native/m8parse.cpp into interned-id arrays; run
blastparse's filters/normalization/dedup, get_qIPO classification and
get_IPO reciprocal detection as numpy segment operations on integer
codes (string sort order preserved via lexicographic rank arrays);
keep the small tail stages (IP means, CO probing, sam_tax output) as
loops over codes with the exact accumulation order of the streaming
path.  Falls back to the pure path (replaying the buffered input) for
rows only it supports: any row with <14 columns (the reference's
first-seen query-length cache, inference.py:69-73).

Deviations from the streaming path, named:
- a mid-file ValueError (id without taxon separator) is raised before
  ANY output is emitted; the streaming path emits preceding groups
  first;
- native float parsing rejects PEP-515 underscores and hex floats that
  CPython float() would accept (such rows are skipped; never seen in
  m8 data).

Copied from ``swiftortho_tpu/orth/fast.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import io
from typing import Iterable, Iterator, List

import numpy as np

from ..config import OrthConfig

_CHUNK_BYTES = 64 << 20


def _segments(*keys):
    """Row mask marking the first row of each run of equal key tuples
    (arrays must already be sorted by those keys)."""
    b = np.zeros(len(keys[0]), bool)
    if len(b):
        b[0] = True
        for k in keys:
            b[1:] |= k[1:] != k[:-1]
    return b


def _reduceat_max(vals, starts):
    return np.maximum.reduceat(vals, starts) if len(vals) else vals


def _reciprocal_vec(a, b, w, rank):
    """get_IPO (inference._reciprocal) on code arrays: sort by the pair's
    STRING order (via rank), runs of length exactly 2 are reciprocal
    with mean score — except a length-2 run that ends the sorted list,
    which takes max (the reference tail path, find_orth.py:372).  The
    intra-run str(score) sort key of the reference cannot affect the
    output (mean and max are symmetric)."""
    if not len(a):
        return a, b, w
    # single packed-key argsort beats a 2-key lexsort at this scale;
    # rank < len(names) so rank_a * len(rank) + rank_b fits int64
    order = np.argsort(rank[a] * np.int64(len(rank)) + rank[b],
                       kind='stable')
    a, b, w = a[order], b[order], w[order]
    first = _segments(a, b)
    starts = np.flatnonzero(first)
    ends = np.r_[starts[1:], len(a)]
    two = (ends - starts) == 2
    s0 = w[starts[two]]
    s1 = w[starts[two] + 1]
    out_w = (s0 + s1) / 2.0
    if len(out_w) and ends[two][-1] == len(a):
        out_w[-1] = max(s0[-1], s1[-1])
    return a[starts[two]], b[starts[two]], out_w


class _ShortRows(Exception):
    pass


def _parse_all(sc_lines: Iterable[str], sep: str):
    """Consume the whole input, returning (names, q, s, F) with global
    interned codes.  Raises _ShortRows (with the buffered text attached
    plus a replay of the unconsumed remainder) when a 12/13-column row
    requires the pure-Python path.

    File-like inputs (anything with a callable ``read``) are consumed
    by bulk reads re-aligned to newline boundaries — ~4x cheaper than
    iterating 15M+ line objects; iterables fall back to line batching.
    The remainder replay reproduces the exact line stream either way
    (a partial read tail is rejoined with the rest of its line)."""
    from ..native import M8ShortRows, m8parse_block_native

    names: List[str] = []
    gid = {}
    chunks_text: List[str] = []
    parts_q, parts_s, parts_f = [], [], []

    read = getattr(sc_lines, 'read', None)
    if callable(read):
        def texts():
            tail = ''
            while True:
                block = read(_CHUNK_BYTES)
                if not block:
                    if tail:
                        yield tail, ''
                    return
                if tail:
                    block = tail + block
                cut = block.rfind('\n')
                if cut < 0:
                    tail = block
                    continue
                tail = block[cut + 1:]
                yield block[:cut + 1], tail

        def rest_after(tail):
            line = tail + (sc_lines.readline() if tail else '')
            if line:
                yield line
            yield from sc_lines
    else:
        it = iter(sc_lines)

        def texts():
            done = False
            while not done:
                buf: List[str] = []
                size = 0
                for line in it:
                    buf.append(line)
                    size += len(line)
                    if size >= _CHUNK_BYTES:
                        break
                else:
                    done = True
                if buf:
                    yield ''.join(buf), None

        def rest_after(_tail):
            return it

    for text, tail in texts():
        chunks_text.append(text)
        try:
            q, s, f, local = m8parse_block_native(
                text.encode('utf-8'), sep.encode('utf-8'))
        except M8ShortRows:
            raise _ShortRows(chunks_text, rest_after(tail))
        lmap = np.empty(len(local), np.int64)
        for i, name in enumerate(local):
            j = gid.get(name)
            if j is None:
                j = gid[name] = len(names)
                names.append(name)
            lmap[i] = j
        parts_q.append(lmap[q])
        parts_s.append(lmap[s])
        parts_f.append(f)
    if parts_q:
        q = np.concatenate(parts_q)
        s = np.concatenate(parts_s)
        F = np.concatenate(parts_f)
    else:
        q = s = np.empty(0, np.int64)
        F = np.empty((0, 6), np.float64)
    return names, q, s, F


def try_fast(sc_lines: Iterable[str], cfg: OrthConfig, blocks: bool = False):
    """Returns (True, output iterator) when the fast path applies, else
    (False, replay iterable) for the pure path.  Never partially
    consumes the input without returning an equivalent replay.  With
    ``blocks=True`` the iterator yields large multi-line str blocks
    (native bulk row formatting) instead of single lines; the
    concatenated bytes are identical either way (pinned by
    tests/test_orth.py)."""
    import os
    if os.environ.get('SWIFTORTHO_NATIVE_ORTH', '1') == '0':
        return False, sc_lines
    try:
        from ..native import load
        load()
    except Exception:
        from ..utils import warn_fallback
        warn_fallback('m8parse', 'native .so unavailable; streaming orth')
        return False, sc_lines
    try:
        names, q, s, F = _parse_all(sc_lines, cfg.sep)
    except _ShortRows as e:
        chunks, it = e.args

        def replay():
            for text in chunks:
                yield from io.StringIO(text)
            yield from it
        return False, replay()
    emit = _infer_blocks if blocks else _infer
    return True, emit(names, q, s, F, cfg)


def _infer(names, q, s, F, cfg) -> Iterator[str]:
    """Per-line emission (the ``find_orth_stream`` contract)."""
    for tag, a, b, w in _sections(names, q, s, F, cfg):
        na = [names[i] for i in a.tolist()]
        nb = [names[i] for i in b.tolist()]
        fmt = tag + '\t%s\t%s\t%s\n'
        for t in zip(na, nb, w.tolist()):
            yield fmt % t


def _infer_blocks(names, q, s, F, cfg) -> Iterator[str]:
    """Multi-line block emission: rows formatted in bulk by
    native/orthfmt.cpp (threaded, CPython-repr weights); chunked so no
    single block exceeds ~2M rows.  Falls back to joining the per-line
    path if the native formatter is unavailable."""
    secs = _sections(names, q, s, F, cfg)
    try:
        from ..native import encode_blob, format_orth_rows_native
        blob, off = encode_blob(names)
    except Exception:
        from ..utils import warn_fallback
        warn_fallback('orthfmt', 'native formatter unavailable')
        for tag, a, b, w in secs:
            na = [names[i] for i in a.tolist()]
            nb = [names[i] for i in b.tolist()]
            fmt = tag + '\t%s\t%s\t%s\n'
            yield ''.join(fmt % t for t in zip(na, nb, w.tolist()))
        return
    chunk = 1 << 21
    for tag, a, b, w in secs:
        for st in range(0, len(a), chunk):
            yield format_orth_rows_native(
                tag, a[st:st + chunk], b[st:st + chunk],
                w[st:st + chunk], blob, off).decode()


def _sections(names, q, s, F, cfg):
    sep = cfg.sep
    n = len(q)
    idy, aln, qst, qed, sco, qln = (F[:, i] for i in range(6))

    # blastparse coverage/identity filters (inference.py:74-76); the
    # streaming path's plain-float division raises ZeroDivisionError on
    # a zero query length — reproduce rather than emit inf
    if np.any(qln == 0.0):
        raise ZeroDivisionError('float division by zero')
    with np.errstate(invalid='ignore'):
        qcv = (1.0 + np.abs(qed - qst)) / qln
        keep = ~(qcv < cfg.coverage) & ~(idy < cfg.identity)
    q, s, aln, sco = q[keep], s[keep], aln[keep], sco[keep]
    n = len(q)

    # normalization (post-filter, like the streaming path)
    if cfg.norm == 'bsr':
        # mbsc[qid] = score of the globally first SURVIVING row of that
        # query (a dict persisting across groups, inference.py:47,82-85)
        _, first_idx = np.unique(q, return_index=True)
        mbsc = np.empty(len(names), np.float64)
        mbsc[q[first_idx]] = sco[first_idx]
        div = mbsc[q]
        if np.any(div == 0.0):
            raise ZeroDivisionError('float division by zero')
        w = sco / div
    elif cfg.norm == 'bal':
        if np.any(aln == 0.0):
            raise ZeroDivisionError('float division by zero')
        w = sco / aln
    else:
        w = sco

    # groups = runs of consecutive equal qid in the FILTERED stream
    # (a query whose rows all fail filters never breaks a run)
    gb = np.zeros(n, bool)
    if n:
        gb[0] = True
        gb[1:] = q[1:] != q[:-1]
    gidx = np.cumsum(gb) - 1

    # per-(group, sid) dedup: keep max w, first-occurrence order
    # (inference.py:90-94)
    pos = np.arange(n)
    o1 = np.lexsort((pos, s, gidx))
    segs = _segments(gidx[o1], s[o1])
    starts = np.flatnonzero(segs)
    wmax = _reduceat_max(w[o1], starts)
    firstpos = pos[o1][starts]          # stable: first occurrence
    back = np.argsort(firstpos, kind='stable')
    qd = q[o1][starts][back]
    sd = s[o1][starts][back]
    wd = wmax[back]
    gd = gidx[o1][starts][back]
    m = len(qd)

    # taxon code + lexicographic rank per name
    taxname = {}
    taxcode = np.empty(len(names), np.int64)
    for i, nm in enumerate(names):
        t = nm.split(sep)[0]
        j = taxname.get(t)
        if j is None:
            j = taxname[t] = len(taxname)
        taxcode[i] = j
    rank = np.empty(len(names), np.int64)
    rank[np.argsort(np.asarray(names, object))] = np.arange(len(names))

    # ---- get_qIPO classification (inference.classify_qipo) ----
    qtx = taxcode[qd]
    stx = taxcode[sd]
    # sco_max per (group, subject taxon), seeded at 0.0
    o2 = np.lexsort((stx, gd))
    seg2 = _segments(gd[o2], stx[o2])
    st2 = np.flatnonzero(seg2)
    smax_seg = np.maximum(_reduceat_max(wd[o2], st2), 0.0)
    segid2 = np.cumsum(seg2) - 1
    smax_row = np.empty(m, np.float64)
    smax_row[o2] = smax_seg[segid2]
    # out_max per group over inter-taxon rows, seeded at 0.0.  gd is
    # nondecreasing (rows are in group order) and every group has >= 1
    # deduped row, so run index == group id and omax_seg[gd] maps back.
    inter = qtx != stx
    winter = np.where(inter, wd, -np.inf)
    gstart = np.flatnonzero(_segments(gd))
    omax_seg = (np.maximum(_reduceat_max(winter, gstart), 0.0)
                if m else winter)
    omax_row = omax_seg[gd]

    same = ~inter
    ips_mask = same & (wd >= omax_row) & (qd != sd)
    ots_mask = inter & (wd >= smax_row)
    cos_mask = inter & ~ots_mask

    swap = rank[qd] > rank[sd]
    a_all = np.where(swap, sd, qd)
    b_all = np.where(swap, qd, sd)

    iw = wd[ips_mask]
    aa, ab = a_all[ips_mask], b_all[ips_mask]
    # both directions, interleaved like the streaming appends
    # (inference.py:116-117)
    ips_a = np.empty(2 * len(aa), np.int64)
    ips_b = np.empty_like(ips_a)
    ips_w = np.empty(2 * len(aa), np.float64)
    ips_a[0::2], ips_b[0::2] = aa, ab
    ips_a[1::2], ips_b[1::2] = ab, aa
    ips_w[0::2] = ips_w[1::2] = iw

    ot_a, ot_b, ot_w = (a_all[ots_mask], b_all[ots_mask], wd[ots_mask])
    co_a, co_b, co_w = (a_all[cos_mask], b_all[cos_mask], wd[cos_mask])

    # ---- OT / IP reciprocals ----
    Oa, Ob, Ow = _reciprocal_vec(ot_a, ot_b, ot_w, rank)
    inots = np.zeros(len(names), bool)
    inots[Oa] = True
    inots[Ob] = True
    Ia, Ib, Iw = _reciprocal_vec(ips_a, ips_b, ips_w, rank)

    # ---- IP per-taxon means (inference.py:209-225: iterate reciprocal
    # rows, qid < sid only; the dict `+=` left folds are reproduced
    # bit-exactly by native seg_sum_seq — numpy's pairwise reduce/
    # reduceat change low bits) ----
    from ..native import seg_sum_seq_native

    def _seq_sums(keys, vals):
        """(unique keys, left-fold sums, counts): per-key dict `+=`
        over rows in their current order."""
        order = np.argsort(keys, kind='stable')
        k, v = keys[order], vals[order]
        starts = np.flatnonzero(_segments(k))
        sums = seg_sum_seq_native(v, starts)
        counts = np.diff(np.r_[starts, len(k)]).astype(np.float64)
        return k[starts], sums, counts

    lo_idx = np.flatnonzero(rank[Ia] < rank[Ib])
    tax_lo = taxcode[Ia[lo_idx]]
    w_lo = Iw[lo_idx]
    inv_lo = inots[Ia[lo_idx]] | inots[Ib[lo_idx]]
    ip_avg_arr = np.zeros(len(taxname), np.float64)
    if len(lo_idx):
        kA, sA, cA = _seq_sums(tax_lo, w_lo)
        ip_avg_arr[kA] = sA / cA
        if inv_lo.any():
            kI, sI, cI = _seq_sums(tax_lo[inv_lo], w_lo[inv_lo])
            ip_avg_arr[kI] = sI / cI

    # ---- CO candidates: max score per sorted pair (order-free in the
    # streaming path too), probed by IP-partner cross products ----
    N = np.int64(len(names))
    if len(co_a):
        # numerically sorted (key, max score) table for searchsorted
        ckey = co_a * N + co_b
        o3 = np.argsort(ckey, kind='stable')
        ck = ckey[o3]
        st3 = np.flatnonzero(_segments(ck))
        co_keys = ck[st3]
        co_vals = _reduceat_max(co_w[o3], st3)
    else:
        co_keys = np.empty(0, np.int64)
        co_vals = np.empty(0, np.float64)

    # partners of a = IP partners sorted by STRING order (the streaming
    # path's partners[k].sort(), inference.py:234-238), as one flat
    # array + per-name spans.  Every (a, b) reciprocal pair is unique
    # and both directions are present, so partner lists have no
    # duplicates — which makes the streaming path's per-OT-row `visit`
    # set a no-op (cross products of duplicate-free lists are
    # duplicate-free); the vectorized probe below relies on that.
    plen = np.zeros(len(names) + 1, np.int64)
    if len(Ia):
        op = np.argsort(Ia * N + rank[Ib], kind='stable')
        pflat = Ib[op]
        np.add.at(plen[1:], Ia, 1)
    else:
        pflat = np.empty(0, np.int64)
    poff = np.cumsum(plen)

    # vectorized cross-product probe, preserving the streaming append
    # order exactly: OT rows in order; qip-major over (qips + [qid]),
    # sip-minor over (sips + [sid]); the (qid, sid) self pair skipped
    ql = plen[1:][Oa] + 1
    sl = plen[1:][Ob] + 1
    any_p = (ql + sl) > 2            # streaming skips rows with no
    ra_ = Oa[any_p]                  # partners on either side
    rb_ = Ob[any_p]
    qln_ = ql[any_p]
    sln_ = sl[any_p]
    tot = qln_ * sln_
    row = np.repeat(np.arange(len(ra_)), tot)
    rowst = np.cumsum(tot) - tot
    ppos = np.arange(int(tot.sum())) - rowst[row]
    qi = ppos // sln_[row]
    si = ppos - qi * sln_[row]
    # qip: partner qi of ra_, or ra_ itself when qi == last
    qip = np.where(qi < qln_[row] - 1,
                   pflat[np.minimum(poff[ra_[row]] + qi,
                                    len(pflat) - 1 if len(pflat)
                                    else 0)],
                   ra_[row])
    sip = np.where(si < sln_[row] - 1,
                   pflat[np.minimum(poff[rb_[row]] + si,
                                    len(pflat) - 1 if len(pflat)
                                    else 0)],
                   rb_[row])
    not_self = ~((qip == ra_[row]) & (sip == rb_[row]))
    pkey = qip * N + sip
    idx = np.searchsorted(co_keys, pkey)
    idx_c = np.minimum(idx, max(len(co_keys) - 1, 0))
    found = not_self & (len(co_keys) > 0)
    if len(co_keys):
        found &= co_keys[idx_c] == pkey
    ca2 = qip[found]
    cb2 = sip[found]
    cw2 = co_vals[idx_c[found]] if len(co_keys) else np.empty(
        0, np.float64)

    # ---- output sections (inference.py:258-269 on codes): the row
    # arrays for IP, then OT, then CO, in emission order; _infer /
    # _infer_blocks turn them into lines/blocks ----
    secs = [('IP', Ia[lo_idx], Ib[lo_idx],
             w_lo / ip_avg_arr[tax_lo] if len(lo_idx)
             else np.empty(0, np.float64))]

    def _weighted_rows(ra, rb, rw):
        """get_sam_tax + n_co_ot (inference.py:148-183) vectorized:
        consecutive same-query-taxon runs; within a run, repeat pairs
        are dropped after their first occurrence — EXCEPT the run's
        first pair, whose first repeat also survives (the reference's
        `visit = set((qid, sid))` seeds the visit set with the two id
        STRINGS, so the tuple probe misses once, find_orth.py:688);
        weights = score / per-(run, subject-taxon) left-fold mean."""
        nrows = len(ra)
        if not nrows:
            return ra, rb, np.empty(0, np.float64)
        qtx_r = taxcode[ra]
        run_first = _segments(qtx_r)
        run_id = np.cumsum(run_first) - 1
        key = ra * N + rb
        first_key = key[np.flatnonzero(run_first)][run_id]
        pos = np.arange(nrows)
        o = np.lexsort((pos, key, run_id))
        seg = _segments(run_id[o], key[o])
        segst = np.flatnonzero(seg)
        occ = pos - segst[np.cumsum(seg) - 1]   # occurrence idx within
        keep_sorted = (occ == 0) | ((occ == 1)  # (run, pair) segment
                                    & (key[o] == first_key[o]))
        keep = np.zeros(nrows, bool)
        keep[o[keep_sorted]] = True
        ka, kb, kw = ra[keep], rb[keep], rw[keep]
        krun = run_id[keep]
        kstx = taxcode[kb]
        o2 = np.lexsort((np.arange(len(ka)), kstx, krun))
        seg2 = _segments(krun[o2], kstx[o2])
        st2 = np.flatnonzero(seg2)
        sums = seg_sum_seq_native(kw[o2], st2)
        cnts = np.diff(np.r_[st2, len(ka)]).astype(np.float64)
        avg_row = np.empty(len(ka), np.float64)
        avg_row[o2] = (sums / cnts)[np.cumsum(seg2) - 1]
        return ka, kb, kw / avg_row

    for tag, ra, rb, rw in (('OT', Oa, Ob, Ow), ('CO', ca2, cb2, cw2)):
        ka, kb, kw = _weighted_rows(ra, rb, rw)
        secs.append((tag, ka, kb, kw))
    return secs
