"""Clustering driver on PyTorch: parse the ortholog graph, decompose,
cluster, print.

Copied from ``swiftortho_tpu/cluster/driver.py`` (whose module imports the
JAX clustering engines) with a ``device`` argument; same contract:
reference bin/find_cluster.py entry (:1764-1793) with fc2mat parsing
(:767-858): 3-col xyz or 4-col (REL x y w) input; rows with x > y
skipped (the graph is already two-directional upstream); duplicate
(x, y) rows: last weight wins (reference lil_matrix assignment).

The mcl path partitions the graph with the reference's exact cnc
decomposition (components.cnc_labels).  The JAX package's documented
deviation holds: the component the reference drops as falsy id 0
(find_cluster.py:1611-1612) is clustered here too.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np
import torch

from ..config import ClusterConfig
from .apc import apc_cluster, apc_cluster_blocked
from .mcl import mcl_cluster


def parse_graph(lines: Iterable[str], sep: str = '|'):
    """Returns (n2l names, ei, ej, w, n_taxa)."""
    l2n = {}
    names: List[str] = []
    ei: List[int] = []
    ej: List[int] = []
    wt: List[float] = []
    last: dict = {}
    for line in lines:
        f = line.rstrip('\n').split('\t')
        if len(f) == 4:
            x, y, z = f[1], f[2], f[3]
        elif len(f) >= 3:
            x, y, z = f[0], f[1], f[2]
        else:
            continue
        if x > y:
            continue
        try:
            zf = float(z)
        except ValueError:
            z2 = z.split('rm')[0]           # reference's salvage (:800-804)
            try:
                zf = float(z2)
            except ValueError:
                continue
        for t in (x, y):
            if t not in l2n:
                l2n[t] = len(names)
                names.append(t)
        last[(l2n[x], l2n[y])] = zf
    for (a, b), z in last.items():
        ei.append(a)
        ej.append(b)
        wt.append(z)
    taxa = {t.split(sep)[0] for t in names}
    return (names, np.asarray(ei, np.int64), np.asarray(ej, np.int64),
            np.asarray(wt, np.float64), len(taxa))


def parse_graph_ordered(lines: Iterable[str], sep: str = '|'):
    """fc2mat-exact parse for the faithful APC mode (find_cluster.py:
    767-848): edges in input-line order WITH duplicates retained (fc2mat
    writes every surviving line to the .npy), node ids assigned in
    first-seen order BEFORE the weight parse (an unparsable-z line still
    registers its nodes), and every line read as ``i[:-1]`` — a final
    line without a trailing newline loses its last byte, exactly like
    the reference (and scripts/fsfdp.py:227)."""
    l2n = {}
    names: List[str] = []
    ei: List[int] = []
    ej: List[int] = []
    wt: List[float] = []
    for line in lines:
        f = line[:-1].split('\t')
        if len(f) == 4:
            x, y, z = f[1], f[2], f[3]
        elif len(f) >= 3:
            x, y, z = f[0], f[1], f[2]
        else:
            continue
        if x > y:
            continue
        for t in (x, y):
            if t not in l2n:
                l2n[t] = len(names)
                names.append(t)
        try:
            zf = float(z)
        except ValueError:
            z2 = z.split('rm')[0]           # reference's salvage (:800-804)
            try:
                zf = float(z2)
            except ValueError:
                continue
        ei.append(l2n[x])
        ej.append(l2n[y])
        wt.append(zf)
    taxa = {t.split(sep)[0] for t in names}
    return (names, np.asarray(ei, np.int64), np.asarray(ej, np.int64),
            np.asarray(wt, np.float64), len(taxa))


def find_cluster_stream(lines: Iterable[str],
                        cfg: ClusterConfig | None = None,
                        device: torch.device | None = None
                        ) -> Iterator[str]:
    """Clusters of the graph in ``lines``, one tab-joined line each.
    mcl, textbook apc and sap run on ``device`` (default: the CPU);
    faithful apc runs on the host."""
    import os

    cfg = cfg or ClusterConfig()
    # faithful (reference-quirk-exact) APC is the default; the env var
    # overrides the config field in either direction ('0' selects the
    # textbook fast mode, anything else forces faithful)
    env = os.environ.get('SWIFTORTHO_APC_FAITHFUL', '')
    faithful = cfg.faithful if env == '' else env != '0'
    # the reference's sap branch has no runnable counterpart, so -a sap
    # always takes the sparse-AP contract path below
    if faithful and cfg.algorithm == 'apc':
        from .apc import apc_cluster_faithful
        names, ei, ej, w, n_taxa = parse_graph_ordered(lines)
        if len(names) == 0:
            return
        clusters = apc_cluster_faithful(len(names), ei, ej, w, n_taxa,
                                        damp=cfg.damping)
        for cl in clusters:
            yield '\t'.join(names[i] for i in cl) + '\n'
        return
    names, ei, ej, w, n_taxa = parse_graph(lines)
    n = len(names)
    if n == 0:
        return
    if cfg.algorithm == 'mcl':
        from .components import cnc_labels
        labels = cnc_labels(n, ei, ej, w)
        clusters = mcl_cluster(n, ei, ej, w, inflation=cfg.inflation,
                               prune=cfg.prune, max_dense=cfg.max_dense,
                               labels=labels, ckpt_dir=cfg.ckpt_dir,
                               device=device)
    elif cfg.algorithm == 'sap':
        # reference SAP branch (find_cluster.py:1725-1751): min-max
        # normalized weights, preference -10 * n_taxa, sparse AP
        from .apc import sap_cluster
        clusters = sap_cluster(n, ei, ej, w, n_taxa, device=device)
    elif cfg.algorithm == 'apc':
        # Reference: -b > 0 selects the blocked apclust_blk
        # (find_cluster.py:1705-1711); the blocked sweeps run only when
        # the symmetrized edge table exceeds one block.
        if 0 < cfg.component_batch < 2 * len(ei) + n:
            clusters = apc_cluster_blocked(n, ei, ej, w, n_taxa,
                                           damp=cfg.damping,
                                           block=cfg.component_batch,
                                           device=device)
        else:
            clusters = apc_cluster(n, ei, ej, w, n_taxa, damp=cfg.damping,
                                   device=device)
    else:
        raise ValueError('unknown algorithm %r' % cfg.algorithm)
    for cl in clusters:
        yield '\t'.join(names[i] for i in cl) + '\n'


def find_cluster_file(path: str, out, cfg: ClusterConfig | None = None,
                      device: torch.device | None = None):
    close = False
    if isinstance(out, str):
        out = open(out, 'w')
        close = True
    try:
        with open(path) as fh:
            for line in find_cluster_stream(fh, cfg, device=device):
                out.write(line)
    finally:
        if close:
            out.close()
