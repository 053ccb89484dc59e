"""OrthoMCL-style ortholog / in-paralog / co-ortholog inference.

Behavioral contract: reference bin/find_orth.py (script body, :42-769):

- blastparse (:158-234): rows grouped by consecutive qid; query coverage
  (1+|qed-qst|)/qlen >= -c and identity >= -y filters; optional bsr
  (score / first-filtered-row score of the query) or bal (score/aln)
  normalization; per (qid,sid) keep the max score, first-occurrence order.
- get_qIPO (:298-348): per query, sco_max per subject taxon and out_max
  over inter-taxon hits; same-taxon hits with sco >= out_max and qid != sid
  become candidate in-paralogs (both line directions emitted!); inter-taxon
  hits with sco >= sco_max[taxon] candidate orthologs (sorted pair), the
  rest candidate co-orthologs (sorted pair).
- get_IPO (:351-376) over the lex-sorted candidate files: a key seen twice
  is reciprocal; its score is the *mean* of the two — except the lex-last
  key of the file, which gets the *max* (the reference's tail path).
- IP weights: score / per-taxon mean, where the mean is restricted to IP
  pairs with an orthologed member when any exist (:505-541).
- CO detection (:569-608): for every final OT pair, the cross product of
  the two members' IP partner sets (+ themselves) is probed — in exact
  (qip, sip) order — against the sorted qCO pairs; max matching score.
- OT/CO weights: per consecutive same-first-taxon run of the output file,
  score / per-subject-taxon mean (get_sam_tax/n_co_ot :673-743), with
  get_sam_tax's first-line dedup quirk: the first pair of a run is added
  to the visit set as two *strings*, so a later duplicate of that exact
  pair is not removed (:688).

Output: "REL\\tqid\\tsid\\tweight" lines, REL in {IP, OT, CO}.

Copied from ``swiftortho_tpu/orth/inference.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations


from typing import Dict, Iterable, Iterator, List, Tuple

from ..config import OrthConfig


def parse_sc_rows(lines: Iterable[str], cfg: OrthConfig
                  ) -> Iterator[List[Tuple[str, str, float]]]:
    """blastparse: yield per-query [(qid, sid, score)] lists (filtered,
    deduped, first-occurrence order)."""
    sep = cfg.sep
    output: Dict[str, List] = {}
    order: List[str] = []
    flag = None
    mbsc: Dict[str, float] = {}
    len_dict: Dict[str, float] = {}
    for line in lines:
        f = line.rstrip('\n').split('\t')
        if len(f) < 12:
            continue
        qid, sid = f[0], f[1]
        if sep not in qid or sep not in sid:
            raise ValueError('id without taxon separator: %r' % qid)
        try:
            idy = float(f[2])
            aln = float(f[3])
            qst, qed = float(f[6]), float(f[7])
            score = float(f[11])
        except ValueError:
            continue
        if len(f) > 13:
            try:
                qln = float(f[12])
            except ValueError:
                continue
        else:
            # 12-col m8 input: the reference caches the first-seen value
            # per query (find_orth.py:187-192)
            if qid not in len_dict:
                len_dict[qid] = max(qst, qed)
            qln = len_dict[qid]
        qcv = (1.0 + abs(qed - qst)) / qln
        if qcv < cfg.coverage or idy < cfg.identity:
            continue
        if flag != qid:
            if output:
                yield [output[k] for k in order]
            output, order = {}, []
            flag = qid
        if cfg.norm == 'bsr':
            if qid not in mbsc:
                mbsc[qid] = score
            sc = score / mbsc[qid]
        elif cfg.norm == 'bal':
            sc = score / aln
        else:
            sc = score
        if sid not in output:
            output[sid] = (qid, sid, sc)
            order.append(sid)
        elif output[sid][2] < sc:
            output[sid] = (qid, sid, sc)
    if output:
        yield [output[k] for k in order]


def classify_qipo(group, sep='|'):
    """get_qIPO: candidate (IP both-direction, OT sorted, CO sorted) pairs."""
    sco_max: Dict[str, float] = {}
    out_max = 0.0
    for qid, sid, sco in group:
        stx = sid.split(sep)[0]
        qtx = qid.split(sep)[0]
        sco_max[stx] = max(sco_max.get(stx, 0.0), sco)
        if qtx != stx:
            out_max = max(out_max, sco)
    ips, ots, cos = [], [], []
    for qid, sid, sco in group:
        qtx = qid.split(sep)[0]
        stx = sid.split(sep)[0]
        a, b = (qid, sid) if qid < sid else (sid, qid)
        if qtx == stx:
            if sco >= out_max and qid != sid:
                ips.append((a, b, sco))
                ips.append((b, a, sco))
        else:
            if sco >= sco_max[stx]:
                ots.append((a, b, sco))
            else:
                cos.append((a, b, sco))
    return ips, ots, cos


def _reciprocal(pairs: List[Tuple[str, str, float]]
                ) -> List[Tuple[str, str, float]]:
    """get_IPO over the lex-sorted pair list: keys seen twice are
    reciprocal with mean score; the lex-last key gets max instead."""
    pairs = sorted(pairs, key=lambda x: (x[0], x[1], str(x[2])))
    out = []
    i, n = 0, len(pairs)
    while i < n:
        j = i
        while j < n and pairs[j][:2] == pairs[i][:2]:
            j += 1
        if j - i == 2:
            a, b = pairs[i][0], pairs[i][1]
            s0, s1 = pairs[i][2], pairs[i + 1][2]
            if j == n:                       # tail path: max (ref :372)
                out.append((a, b, max(s0, s1)))
            else:                            # mid-stream: mean (ref :359)
                out.append((a, b, (s0 + s1) / 2.0))
        i = j
    return out


def _sam_tax_groups(rows, sep='|'):
    """get_sam_tax: consecutive same-first-taxon runs with the reference's
    first-line string-set dedup quirk (find_orth.py:673-694)."""
    flag = None
    out = []
    visit = None
    for qid, sid, sco in rows:
        qtx = qid.split(sep)[0]
        if qtx != flag:
            if out:
                yield out
            flag = qtx
            out = [(qid, sid, sco)]
            visit = set((qid, sid))          # quirk: two strings, not a tuple
        else:
            if (qid, sid) not in visit:
                out.append((qid, sid, sco))
                visit.add((qid, sid))
    if out:
        yield out


def _n_co_ot(group, sep='|'):
    sums: Dict[str, List[float]] = {}
    for qid, sid, sco in group:
        stx = sid.split(sep)[0]
        if stx in sums:
            sums[stx][0] += sco
            sums[stx][1] += 1.0
        else:
            sums[stx] = [sco, 1.0]
    avgs = {k: a / b for k, (a, b) in sums.items()}
    for qid, sid, sco in group:
        stx = sid.split(sep)[0]
        yield qid, sid, sco / avgs[stx]


def find_orth_stream(sc_lines: Iterable[str],
                     cfg: OrthConfig | None = None) -> Iterator[str]:
    """Full inference: .sc lines in, 'REL\\tq\\ts\\tweight' lines out.

    Dispatches to the byte-identical vectorized fast path (orth/fast.py,
    native m8 parse + numpy segment ops) when the native library is
    available and the input is 14+ columns; SWIFTORTHO_NATIVE_ORTH=0
    forces this streaming implementation (the reference-parity oracle —
    tests pin fast == streaming)."""
    cfg = cfg or OrthConfig()
    from .fast import try_fast
    ok, it = try_fast(sc_lines, cfg)
    if ok:
        yield from it
        return
    yield from _stream_pure(it, cfg)


def find_orth_blocks(sc_lines: Iterable[str],
                     cfg: OrthConfig | None = None) -> Iterator[str]:
    """``find_orth_stream`` yielded as large multi-line str blocks:
    ``''.join(find_orth_blocks(x))`` is byte-identical to
    ``''.join(find_orth_stream(x))`` (pinned by tests/test_orth.py).
    On the fast path the rows are formatted in bulk by
    native/orthfmt.cpp (threaded; CPython-repr weights, fuzz-verified
    == str(float)); otherwise streaming lines are joined into ~4 MiB
    blocks.  Writers (find_orth_file, run_all, the find_orth CLI) use
    this; per-line consumers keep ``find_orth_stream``."""
    cfg = cfg or OrthConfig()
    from .fast import try_fast
    ok, it = try_fast(sc_lines, cfg, blocks=True)
    if ok:
        yield from it
        return
    buf: List[str] = []
    size = 0
    for line in _stream_pure(it, cfg):
        buf.append(line)
        size += len(line)
        if size >= (1 << 22):
            yield ''.join(buf)
            buf, size = [], 0
    if buf:
        yield ''.join(buf)


def _stream_pure(sc_lines: Iterable[str],
                 cfg: OrthConfig) -> Iterator[str]:
    """The streaming reference-parity oracle (the body behind
    ``find_orth_stream`` when the fast path does not apply)."""
    sep = cfg.sep

    q_ips: List[Tuple[str, str, float]] = []
    q_ots: List[Tuple[str, str, float]] = []
    q_cos: List[Tuple[str, str, float]] = []
    for group in parse_sc_rows(sc_lines, cfg):
        ips, ots, cos = classify_qipo(group, sep)
        q_ips.extend(ips)
        q_ots.extend(ots)
        q_cos.extend(cos)

    # ---- OT: reciprocal candidates ----
    ots = _reciprocal(q_ots)
    inots = set()
    for a, b, _ in ots:
        inots.add(a)
        inots.add(b)

    # ---- IP: reciprocal (both directions present) + taxon means ----
    ips = _reciprocal(q_ips)
    ipqa: Dict[str, List[float]] = {}
    IPqA: Dict[str, List[float]] = {}
    for qid, sid, sco in ips:
        if qid < sid:
            qtx = qid.split(sep)[0]
            if qid in inots or sid in inots:
                ipqa.setdefault(qtx, [0.0, 0.0])
                ipqa[qtx][0] += sco
                ipqa[qtx][1] += 1.0
            IPqA.setdefault(qtx, [0.0, 0.0])
            IPqA[qtx][0] += sco
            IPqA[qtx][1] += 1.0
    ip_avg = {}
    for k, (a, b) in IPqA.items():
        if k in ipqa:
            a, b = ipqa[k]
        ip_avg[k] = a / b

    # ---- CO: probe IP-partner cross products against sorted qCOs ----
    q_cos_sorted = sorted(q_cos, key=lambda x: (x[0], x[1]))
    co_index: Dict[Tuple[str, str], float] = {}
    for a, b, sco in q_cos_sorted:
        key = (a, b)
        if key not in co_index or co_index[key] < sco:
            co_index[key] = sco
    partners: Dict[str, List[str]] = {}
    for qid, sid, _ in ips:                    # both directions present,
        partners.setdefault(qid, []).append(sid)  # lex order preserved
    for k in partners:
        partners[k].sort()

    cos_rows: List[Tuple[str, str, float]] = []
    for qid, sid, _ in ots:
        qips = partners.get(qid, [])
        sips = partners.get(sid, [])
        if not qips and not sips:
            continue
        visit = set()
        for qip in qips + [qid]:
            for sip in sips + [sid]:
                if qip == qid and sip == sid:
                    continue
                if (qip, sip) in visit:
                    continue
                visit.add((qip, sip))
                sco = co_index.get((qip, sip))
                if sco is not None:
                    cos_rows.append((qip, sip, sco))

    # ---- output ----
    for qid, sid, sco in ips:
        if qid >= sid:
            continue
        tax = qid.split(sep)[0]
        yield 'IP\t%s\t%s\t%s\n' % (qid, sid, sco / ip_avg[tax])
    for group in _sam_tax_groups(ots, sep):
        for qid, sid, w in _n_co_ot(group, sep):
            yield 'OT\t%s\t%s\t%s\n' % (qid, sid, w)
    for group in _sam_tax_groups(cos_rows, sep):
        for qid, sid, w in _n_co_ot(group, sep):
            yield 'CO\t%s\t%s\t%s\n' % (qid, sid, w)


def find_orth_file(sc_path: str, out, cfg: OrthConfig | None = None):
    close = False
    if isinstance(out, str):
        out = open(out, 'w')
        close = True
    try:
        with open(sc_path) as fh:
            for block in find_orth_blocks(fh, cfg):
                out.write(block)
    finally:
        if close:
            out.close()
