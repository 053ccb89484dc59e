"""Phylogenetic tree construction (replaces the reference's external
fasttree call, scripts/run_all.py:220).

Distance = Kimura-corrected protein p-distance over the concatenated
alignment; tree = neighbor-joining with midpointish negative-branch
clamping; output = newick.

Copied from ``swiftortho_tpu/analysis/phylo.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from math import log
from typing import Dict, List

import numpy as np


def pdistance_matrix(names: List[str], rows: List[str]) -> np.ndarray:
    """Pairwise Kimura-corrected p-distances over aligned rows."""
    arr = np.array([np.frombuffer(r.encode('latin-1'), np.uint8)
                    for r in rows])
    gap = arr == ord('-')
    n = len(names)
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            ok = ~gap[i] & ~gap[j]
            tot = int(ok.sum())
            if tot == 0:
                d = 3.0
            else:
                p = float((arr[i][ok] != arr[j][ok]).mean())
                p = min(p, 0.85)
                # Kimura (1983) protein distance approximation
                d = -log(1.0 - p - 0.2 * p * p)
            D[i, j] = D[j, i] = d
    return D


def neighbor_joining(names: List[str], D: np.ndarray) -> str:
    """Classic NJ; returns a newick string (branch lengths clamped >= 0)."""
    n = len(names)
    if n == 0:
        return ';'
    if n == 1:
        return '(%s);' % names[0]
    nodes = list(names)
    D = D.copy().astype(float)
    active = list(range(n))
    labels: Dict[int, str] = {i: names[i] for i in range(n)}

    while len(active) > 2:
        m = len(active)
        sub = D[np.ix_(active, active)]
        r = sub.sum(axis=1)
        Q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(Q, np.inf)
        ai, aj = np.unravel_index(np.argmin(Q), Q.shape)
        i, j = active[ai], active[aj]
        dij = D[i, j]
        li = 0.5 * dij + (r[ai] - r[aj]) / (2.0 * (m - 2))
        lj = dij - li
        li, lj = max(li, 0.0), max(lj, 0.0)
        new_label = '(%s:%.6f,%s:%.6f)' % (labels[i], li, labels[j], lj)
        # distances to the new node
        dnew = 0.5 * (D[i, active] + D[j, active] - dij)
        k = D.shape[0]
        D = np.pad(D, ((0, 1), (0, 1)))
        D[k, active] = dnew
        D[active, k] = dnew
        labels[k] = new_label
        active = [x for x in active if x not in (i, j)] + [k]

    i, j = active
    d = max(D[i, j], 0.0)
    return '(%s:%.6f,%s:%.6f);' % (labels[i], d / 2, labels[j], d / 2)


def tree_from_alignment(names: List[str], rows: List[str]) -> str:
    return neighbor_joining(names, pdistance_matrix(names, rows))
