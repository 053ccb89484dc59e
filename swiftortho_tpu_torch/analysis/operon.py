"""Operon clustering edges.

Behavioral contract: reference scripts/operon_cluster.py:102-170:
- gene -> group index from the cluster file (row number);
- operon strings 'a-->b-->c' / 'a<--b<--c'; a line whose first column
  starts with 'gene_id' is a header and skipped;
- the inverted operondb maps group -> operon indices, but only for truthy
  group ids (`if k:` drops group 0 — reference quirk, reproduced);
- for each operon, candidate partners share >= 3 groups (N_shr > 2) and
  max coverage > .5; score = harmonic mean of the two coverages;
- output: 'operon0\\toperon1\\tscore' edges (self-pairs included, both
  directions appear as in the reference's loop).

Copied from ``swiftortho_tpu/analysis/operon.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List


def gene_fam_idx(cluster_lines: Iterable[str]) -> Dict[str, int]:
    groups: Dict[str, int] = {}
    for flag, line in enumerate(cluster_lines):
        for g in line.rstrip('\n').split('\t'):
            groups[g] = flag
    return groups


def operon_cluster_edges(operon_lines: Iterable[str],
                         groups: Dict[str, int]) -> Iterator[str]:
    operondb: Dict[int, List[int]] = {}
    operons: List[str] = []
    for line in operon_lines:
        op = line.rstrip('\n').split('\t')[0]
        if op.startswith('gene_id'):
            continue
        operons.append(op)
        parts = op.split('-->') if '-->' in op else op.split('<--')
        flag = len(operons) - 1
        for g in parts:
            k = groups.get(g)
            if k:                       # reference quirk: group 0 dropped
                operondb.setdefault(k, []).append(flag)

    for i0, op_str in enumerate(operons):
        sp0 = '-->' if '-->' in op_str else '<--'
        op0 = op_str.split(sp0)
        idxs: List[int] = []
        for g in op0:
            if g in groups:
                idxs.extend(operondb.get(groups[g], []))
        group0 = [groups[g] for g in op0 if g in groups]
        for j0 in sorted(set(idxs)):
            op1_str = operons[j0]
            sp1 = '-->' if '-->' in op1_str else '<--'
            op1 = op1_str.split(sp1)
            group1 = [groups[g] for g in op1 if g in groups]
            share = set(group0).intersection(group1)
            n_shr = float(len(share))
            if not op0 or not op1:
                continue
            cv0 = n_shr / len(op0)
            cv1 = n_shr / len(op1)
            if n_shr > 2 and max(cv0, cv1) > 0.5:
                score = 2.0 * cv0 * cv1 / (cv0 + cv1)
                yield '%s\t%s\t%s\n' % (op_str, op1_str, score)
