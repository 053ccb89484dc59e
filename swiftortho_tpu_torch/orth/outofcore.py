"""Out-of-core orthology inference for hit tables larger than RAM.

Same behavioral contract as orth.inference (reference bin/find_orth.py),
but staged through temp files exactly like the reference: candidate
qIP/qOT/qCO pairs spill to disk, are sorted with GNU sort (LC_ALL=C,
find_orth.py:478-479), reciprocal pairs stream from the sorted files
(get_IPO semantics incl. the mean-mid/max-tail quirk, which falls out
naturally here since the tail group of the file IS the lex-last key),
and co-ortholog probing binary-searches the sorted qCO file through an
mmap (find_orth.py:415-468).

Memory: O(per-query hits + per-taxon tables + IP partner lists).

Copied from ``swiftortho_tpu/orth/outofcore.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import mmap
import os
import subprocess
import tempfile
from typing import Dict, Iterable, Iterator, List, Tuple

from ..config import OrthConfig
from .inference import (classify_qipo, parse_sc_rows, _n_co_ot,
                        _sam_tax_groups)


def _sort_file(path: str, tmpdir: str):
    out = path + '.srt'
    env = dict(os.environ, LC_ALL='C')
    subprocess.run(['sort', '-T', tmpdir, '-o', out, path],
                   check=True, env=env)
    os.replace(out, path)


def _stream_reciprocal(path: str) -> Iterator[Tuple[str, str, float, bool]]:
    """get_IPO over a sorted pair file: yields (a, b, score, reciprocal)."""
    with open(path) as fh:
        key = None
        scores: List[float] = []
        for line in fh:
            f = line.rstrip('\n').split('\t')
            if len(f) < 3:
                continue
            k = (f[0], f[1])
            if k != key:
                if key is not None and len(scores) == 2:
                    yield key[0], key[1], sum(scores) / 2.0, True
                elif key is not None and len(scores) == 1:
                    yield key[0], key[1], scores[0], False
                key = k
                scores = [float(f[2])]
            else:
                scores.append(float(f[2]))
        if key is not None and len(scores) == 2:
            yield key[0], key[1], max(scores), True       # tail: max
        elif key is not None and len(scores) == 1:
            yield key[0], key[1], scores[0], False


def _bisect_pairs(buf, prefix: bytes) -> List[bytes]:
    """All lines of the sorted file starting with prefix (prefix must end
    with a field separator so matches are exact keys).  lo/hi are kept
    line-aligned; compare lines as C-locale byte strings, like the
    reference's mmap binary_search (find_orth.py:415-468)."""
    n = len(buf)
    if n == 0:
        return []

    def line_end(pos):
        e = buf.find(b'\n', pos)
        return n if e < 0 else e

    lo, hi = 0, n                 # invariant: lo is line-aligned
    while lo < hi:
        mid = buf.rfind(b'\n', 0, (lo + hi) // 2) + 1
        if mid < lo:
            mid = lo
        if mid == lo:             # ensure progress on tiny ranges
            e = line_end(lo)
            if buf[lo:e] < prefix:
                lo = e + 1
            else:
                hi = lo
            continue
        e = line_end(mid)
        if buf[mid:e] < prefix:
            lo = e + 1
        else:
            hi = mid
    out = []
    pos = lo
    while pos < n:
        e = line_end(pos)
        line = buf[pos:e]
        if not line.startswith(prefix):
            break
        out.append(line)
        pos = e + 1
    return out


def find_orth_stream_ooc(sc_lines: Iterable[str],
                         cfg: OrthConfig | None = None,
                         tmpdir: str | None = None) -> Iterator[str]:
    cfg = cfg or OrthConfig()
    sep = cfg.sep
    own_tmp = tempfile.mkdtemp(prefix='orth_', dir=tmpdir)
    qip_p = os.path.join(own_tmp, 'qIPs.txt')
    qot_p = os.path.join(own_tmp, 'qOTs.txt')
    qco_p = os.path.join(own_tmp, 'qCOs.txt')
    try:
        with open(qip_p, 'w') as fip, open(qot_p, 'w') as fot, \
                open(qco_p, 'w') as fco:
            for group in parse_sc_rows(sc_lines, cfg):
                ips, ots, cos = classify_qipo(group, sep)
                for a, b, s in ips:
                    fip.write('%s\t%s\t%s\n' % (a, b, s))
                for a, b, s in ots:
                    fot.write('%s\t%s\t%s\n' % (a, b, s))
                for a, b, s in cos:
                    fco.write('%s\t%s\t%s\n' % (a, b, s))
        for p in (qip_p, qot_p, qco_p):
            _sort_file(p, own_tmp)

        # OT pass
        ots_p = os.path.join(own_tmp, 'OTs.txt')
        inots = set()
        with open(ots_p, 'w') as out:
            for a, b, s, rec in _stream_reciprocal(qot_p):
                if rec:
                    out.write('%s\t%s\t%s\n' % (a, b, s))
                    inots.add(a)
                    inots.add(b)

        # IP pass (+ taxon means, orth-restricted)
        ips_p = os.path.join(own_tmp, 'IPs.txt')
        ipqa: Dict[str, List[float]] = {}
        IPqA: Dict[str, List[float]] = {}
        partners: Dict[str, List[str]] = {}
        with open(ips_p, 'w') as out:
            for a, b, s, rec in _stream_reciprocal(qip_p):
                if not rec:
                    continue
                out.write('%s\t%s\t%s\n' % (a, b, s))
                partners.setdefault(a, []).append(b)
                if a < b:
                    qtx = a.split(sep)[0]
                    if a in inots or b in inots:
                        ipqa.setdefault(qtx, [0.0, 0.0])
                        ipqa[qtx][0] += s
                        ipqa[qtx][1] += 1.0
                    IPqA.setdefault(qtx, [0.0, 0.0])
                    IPqA[qtx][0] += s
                    IPqA[qtx][1] += 1.0
        ip_avg = {}
        for k, ab in IPqA.items():
            a_, b_ = ipqa.get(k, ab)
            ip_avg[k] = a_ / b_

        # CO pass: probe IP-partner cross products in the sorted qCO file
        cos_p = os.path.join(own_tmp, 'COs.txt')
        with open(qco_p, 'rb') as fq, open(cos_p, 'w') as out:
            try:
                buf = mmap.mmap(fq.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError:            # empty file
                buf = b''
            with open(ots_p) as fot:
                for line in fot:
                    if not buf:
                        break
                    qid, sid, _ = line.rstrip('\n').split('\t')[:3]
                    qips = partners.get(qid, []) + [qid]
                    sips = partners.get(sid, []) + [sid]
                    visit = set()
                    for qip in qips:
                        for sip in sips:
                            if qip == qid and sip == sid:
                                continue
                            if (qip, sip) in visit:
                                continue
                            visit.add((qip, sip))
                            pre = ('%s\t%s\t' % (qip, sip)).encode()
                            lines = _bisect_pairs(buf, pre)
                            if lines:
                                sco = max(float(l.split(b'\t')[2])
                                          for l in lines)
                                out.write('%s\t%s\t%s\n' % (qip, sip, sco))
            if hasattr(buf, 'close'):
                buf.close()       # release the mapping before rmtree

        # output: normalized IP / OT / CO
        with open(ips_p) as fh:
            for line in fh:
                a, b, s = line.rstrip('\n').split('\t')
                if a >= b:
                    continue
                tax = a.split(sep)[0]
                yield 'IP\t%s\t%s\t%s\n' % (a, b, float(s) / ip_avg[tax])

        def rows_of(path):
            with open(path) as fh:
                for line in fh:
                    a, b, s = line.rstrip('\n').split('\t')
                    yield a, b, float(s)

        for group in _sam_tax_groups(rows_of(ots_p), sep):
            for a, b, w in _n_co_ot(group, sep):
                yield 'OT\t%s\t%s\t%s\n' % (a, b, w)
        for group in _sam_tax_groups(rows_of(cos_p), sep):
            for a, b, w in _n_co_ot(group, sep):
                yield 'CO\t%s\t%s\t%s\n' % (a, b, w)
    finally:
        import shutil
        shutil.rmtree(own_tmp, ignore_errors=True)
