"""Small pipeline utilities.

Behavioral contracts:
- nr_collapse: scripts/nr_flt.py — one record per unique sequence, ids
  joined by ';;;' (first-occurrence order).
- nr_expand: scripts/nr2full.py — cross-product re-expansion of ';;;'
  ids in hit tables; emits cols [q, r] + j[2:-2] + [qd, rd], grouped by
  the expanded query id within each input query block.
- extract_core: scripts/extract_core.py — zip .pan data rows with .clsr
  rows; for Core groups take the lexicographically first member.
- cluster_compare: scripts/mcl_cmp.py — % of identical sorted group rows
  in both directions.
- merge_fastas: scripts/merge.py — concatenate fastas in a directory,
  prefixing headers with a numeric taxon label 'N|'.

Copied from ``swiftortho_tpu/analysis/misc.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Tuple


def nr_collapse(records: Iterable[Tuple[str, str]]) -> Iterator[Tuple[str, str]]:
    seqs: Dict[str, List[str]] = {}
    order: List[str] = []
    for head, seq in records:
        rid = head.split(' ')[0]
        if seq not in seqs:
            seqs[seq] = []
            order.append(seq)
        seqs[seq].append(rid)
    for seq in order:
        yield ';;;'.join(seqs[seq]), seq


def nr_expand(sc_lines: Iterable[str]) -> Iterator[str]:
    block: List[List[str]] = []
    flag = None
    for line in sc_lines:
        f = line.rstrip('\n').split('\t')
        if block and flag != f[0]:
            yield from _expand_block(block)
            block = []
        flag = f[0]
        block.append(f)
    if block:
        yield from _expand_block(block)


def _expand_block(block: List[List[str]]) -> Iterator[str]:
    outs: Dict[str, List[str]] = {}
    for f in block:
        qds, rds = f[0], f[1]
        for qd in qds.split(';;;'):
            for rd in rds.split(';;;'):
                q = qd.split(' ')[0]
                r = rd.split(' ')[0]
                row = [q, r] + f[2:-2] + [qd, rd]
                outs.setdefault(q, []).append('\t'.join(row) + '\n')
    for rows in outs.values():
        yield from rows


def extract_core(pan_lines: Iterable[str], clsr_lines: Iterable[str],
                 records: Iterable[Tuple[str, str]]) -> Iterator[Tuple[str, str]]:
    pan_res = []
    for line in pan_lines:
        if line.startswith('#'):
            continue
        f = line.rstrip('\n').split('\t', 3)
        if len(f) >= 2:
            pan_res.append((f[0], f[1]))
    core_genes = set()
    for (grp, typ), row in zip(pan_res, clsr_lines):
        if typ.lower() == 'core':
            members = sorted(row.rstrip('\n').split('\t'))
            core_genes.add(members[0])
    for head, seq in records:
        if head.split(' ')[0] in core_genes:
            yield head, seq


def cluster_compare(qry_lines: Iterable[str],
                    ref_lines: Iterable[str]) -> Tuple[float, float]:
    """(% of qry rows found in ref, % of ref rows found in qry)."""
    def norm(line):
        s = line.rstrip('\n').strip()
        parts = s.split('\t') if '\t' in s else s.split(' ')
        return tuple(sorted(parts))

    qset = set()
    qn = 0
    for line in qry_lines:
        qset.add(norm(line))
        qn += 1
    rn = sn = 0
    for line in ref_lines:
        if norm(line) in qset:
            sn += 1
        rn += 1
    return (100.0 * sn / max(qn, 1), 100.0 * sn / max(rn, 1))


def merge_fastas(dirname: str) -> Iterator[str]:
    flag = 0
    for name in os.listdir(dirname):
        path = os.path.join(dirname, name)
        if not os.path.isfile(path):
            continue
        with open(path) as fh:
            for line in fh:
                if line.startswith('>'):
                    yield '>%d|%s\n' % (flag, line[1:].rstrip('\n'))
                else:
                    yield line.rstrip('\n') + '\n'
        flag += 1
