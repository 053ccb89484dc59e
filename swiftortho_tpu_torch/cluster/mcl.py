"""Markov Clustering on PyTorch: size-bucketed batches of dense
per-component matrices, multiplied with ``torch.matmul``.

Port of ``swiftortho_tpu/cluster/mcl.py``; the same contract
(reference ``mcl``, bin/find_cluster.py:652-689, and ``mcl_xyz``,
:1425-1466):

- float32 matrices; self-loop of every node = its max incident weight;
- loop <= 100: column L1-normalize (denominator += 1e-8); snapshot every
  5 iters; expansion x <- x @ x; inflation x.data **= I; stop when
  max(|x - x_old| - rtol|x_old|) <= atol at a check iter; prune < 1e-5;
- clusters = connected components of the surviving entries > 1e-5.

``_mcl_dense_batch`` runs on whatever device its tensor is on, with the
matmuls at full float32 precision (``numerics.highest_matmul_precision``).
The host code (``mcl_cluster``, ``_run_dense_batch``, ``_mcl_sparse``,
``_run_sparse_comp``) is copied from the JAX package with a ``device``
argument.  Components larger than ``max_dense`` go to the block-sparse
engine (``mcl_blocksparse.py``), or to scipy with ``SWIFTORTHO_MCL=scipy``.
"""

from __future__ import annotations

from time import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils import log_event
from .components import connected_components
from .numerics import highest_matmul_precision

_SIZE_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _mcl_dense_batch(x: torch.Tensor,
                     inflation: float = 1.5, expansion: int = 2,
                     prune: float = 1e-5, rtol: float = 1e-5,
                     atol: float = 1e-8, itr: int = 100,
                     check: int = 5) -> Tuple[torch.Tensor, int]:
    """Run the MCL loop on a (B, s, s) float32 batch; padding nodes carry
    identity self-loops (they normalize to themselves and never
    interact).  Returns the final batch and the iterations run.

    Convergence is tracked PER COMPONENT (a (B,) done mask): a converged
    component's matrix is frozen while batch-mates keep iterating, so
    each component stops at the iteration the reference's
    one-matrix-at-a-time loop would.  ``done`` changes only at check
    iterations, so the host reads it only there: one device sync per
    ``check`` iterations."""
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    x_old = torch.zeros_like(x)
    i = -1
    with highest_matmul_precision():
        for i in range(itr):
            frozen = done[:, None, None]
            y = x / (x.sum(dim=1, keepdim=True) + 1e-8)     # column sums
            is_check = i % check == 0
            if is_check:
                x_old = torch.where(frozen, x_old, y)
            for _ in range(expansion - 1):
                y = torch.matmul(y, y)
            y = torch.pow(y, inflation)
            if is_check and i > 0:
                conv = ((y - x_old).abs() - rtol * x_old.abs()).amax(
                    dim=(1, 2)) <= atol
            y = torch.where(y < prune, 0.0, y)
            x = torch.where(frozen, x, y)
            if is_check and i > 0:
                done = done | conv
                if bool(done.all()):
                    break
    return x, i + 1


def _mcl_sparse(mat, inflation, prune=1e-5, rtol=1e-5, atol=1e-8,
                itr=100, check=5):
    """scipy CSR fallback for oversize components (same loop)."""
    import scipy.sparse as sp
    x = mat.tocsr().astype(np.float32)
    x_old = None
    for i in range(itr):
        y = np.asarray(x.sum(axis=0)).ravel() + 1e-8
        x = x @ sp.diags(1.0 / y)
        if i % check == 0:
            x_old = x.copy()
        x = x @ x
        x = x.power(1.0)  # keep csr
        x.data **= inflation
        if i % check == 0 and i > 0:
            d = abs(x - x_old)
            if (d - rtol * abs(x_old)).max() <= atol:
                break
        x.data[x.data < prune] = 0.0
        x.eliminate_zeros()
    return x


def mcl_cluster(n: int, ei: np.ndarray, ej: np.ndarray, w: np.ndarray,
                inflation: float = 1.5, prune: float = 1e-5,
                max_dense: int = 4096,
                labels: np.ndarray | None = None,
                ckpt_dir: str | None = None,
                device: torch.device | None = None) -> List[List[int]]:
    """Cluster an undirected weighted edge list (node ids 0..n-1) on
    ``device`` (default: the CPU).

    ``labels``: optional precomputed per-node component labels (e.g. the
    reference-faithful ``components.cnc_labels``); edges whose endpoints
    carry different labels are dropped, exactly like the reference's
    `cx == cy` filter (find_cluster.py:1611-1612).  Default: plain
    connected components (every edge kept).

    ``ckpt_dir``: when given, every finished bucket batch / oversize
    component persists its clusters there
    (``swiftortho_tpu/cluster/checkpoint.py``), and oversize components
    additionally checkpoint iteration state — a rerun over the same
    graph+parameters skips finished work and resumes the interrupted
    component mid-run.

    Returns clusters as lists of node ids (ascending), ordered by their
    smallest member.  Isolated nodes are not reported (the reference only
    prints nodes that appear in some surviving component).
    """
    device = torch.device('cpu') if device is None else device
    if len(ei) == 0:
        return []
    ckpt = None
    if ckpt_dir is not None:
        from .checkpoint import ClusterCheckpoint, graph_signature
        sig = graph_signature(n, ei, ej, w, labels, inflation=inflation,
                              prune=prune, max_dense=max_dense)
        ckpt = ClusterCheckpoint(ckpt_dir, sig)
    if labels is None:
        labels = connected_components(n, ei, ej)
    else:
        keep = labels[ei] == labels[ej]
        ei, ej, w = ei[keep], ej[keep], w[keep]
        if len(ei) == 0:
            return []
        # renumber labels to dense 0..k-1 (cnc labels include -1 and may
        # skip ids once cross-label edges are dropped)
        _, labels = np.unique(labels, return_inverse=True)
    ncomp = labels.max() + 1

    comp_nodes: Dict[int, np.ndarray] = {}
    order = np.argsort(labels, kind='stable')
    bounds = np.searchsorted(labels[order], np.arange(ncomp + 1))
    for c in range(ncomp):
        comp_nodes[c] = order[bounds[c]:bounds[c + 1]]

    e_comp = labels[ei]
    e_order = np.argsort(e_comp, kind='stable')
    e_bounds = np.searchsorted(e_comp[e_order], np.arange(ncomp + 1))

    clusters: List[List[int]] = []

    # group components into dense size buckets
    by_bucket: Dict[int, List[int]] = {}
    big: List[int] = []
    for c in range(ncomp):
        sz = len(comp_nodes[c])
        if sz > max_dense:
            big.append(c)
            continue
        for b in _SIZE_BUCKETS:
            if sz <= b and b <= max_dense:
                by_bucket.setdefault(b, []).append(c)
                break

    for b, comps in sorted(by_bucket.items()):
        # batch in groups to bound memory: B*s*s*4 <= ~256MB
        max_batch = max(1, (256 << 20) // (b * b * 4))
        for gstart in range(0, len(comps), max_batch):
            key = 'dense_b%d_g%d' % (b, gstart)
            cached = ckpt.load_batch(key) if ckpt is not None else None
            if cached is not None:
                clusters.extend(cached)
                continue
            batch = comps[gstart:gstart + max_batch]
            got = _run_dense_batch(
                batch, comp_nodes, ei, ej, w, e_order, e_bounds, b,
                inflation, prune, device)
            if ckpt is not None:
                ckpt.save_batch(key, got)
            clusters.extend(got)

    for c in big:
        key = 'big_c%d' % c
        cached = ckpt.load_batch(key) if ckpt is not None else None
        if cached is not None:
            clusters.extend(cached)
            continue
        got = _run_sparse_comp(
            c, comp_nodes, ei, ej, w, e_order, e_bounds, inflation, prune,
            ckpt=ckpt, ckpt_key=key, device=device)
        if ckpt is not None:
            ckpt.save_batch(key, got)
            ckpt.clear_state(key)
        clusters.extend(got)

    clusters.sort(key=lambda cl: cl[0])
    return clusters


def _run_dense_batch(batch, comp_nodes, ei, ej, w, e_order, e_bounds, s,
                     inflation, prune, device) -> List[List[int]]:
    """One bucket batch: host build, device MCL, host extraction; logs
    an ``mcl_dense_batch`` event with the seconds of each part."""
    t0 = time()
    B = len(batch)
    x = np.zeros((B, s, s), dtype=np.float32)
    locals_of = []
    for r, c in enumerate(batch):
        nodes = comp_nodes[c]
        loc = {int(g): i for i, g in enumerate(nodes)}
        locals_of.append((nodes, loc))
        sel = e_order[e_bounds[c]:e_bounds[c + 1]]
        li = np.fromiter((loc[int(g)] for g in ei[sel]), np.int64, len(sel))
        lj = np.fromiter((loc[int(g)] for g in ej[sel]), np.int64, len(sel))
        # symmetric assignment; duplicate pairs: last wins (reference lil)
        x[r, li, lj] = w[sel]
        x[r, lj, li] = w[sel]
        # self-loop = max incident weight (mcl_xyz, find_cluster.py:1450)
        m = len(nodes)
        selfw = np.zeros(m, np.float32)
        np.maximum.at(selfw, li, w[sel].astype(np.float32))
        np.maximum.at(selfw, lj, w[sel].astype(np.float32))
        x[r, np.arange(m), np.arange(m)] = selfw
        # identity self-loops for padding nodes
        if m < s:
            idx = np.arange(m, s)
            x[r, idx, idx] = 1.0

    t1 = time()
    xr, iters = _mcl_dense_batch(torch.from_numpy(x).to(device),
                                 inflation=float(inflation),
                                 prune=float(prune))
    xr = xr.cpu().numpy()
    t2 = time()
    out = []
    for r, (nodes, _) in enumerate(locals_of):
        m = len(nodes)
        sub = xr[r, :m, :m]
        ri, rj = np.nonzero(sub > prune)
        if len(ri):
            sub_labels = connected_components(m, ri, rj)
            # only nodes that appear in a surviving edge (ref builds the
            # graph from nonzero entries; isolated nodes drop out)
            present = np.zeros(m, bool)
            present[ri] = True
            present[rj] = True
            for lab in np.unique(sub_labels[present]):
                members = np.flatnonzero((sub_labels == lab) & present)
                out.append(sorted(int(nodes[i]) for i in members))
    log_event('mcl_dense_batch', s=s, batch=B, iterations=iters,
              build_s=round(t1 - t0, 4), device_s=round(t2 - t1, 4),
              extract_s=round(time() - t2, 4))
    return out


def _run_sparse_comp(c, comp_nodes, ei, ej, w, e_order, e_bounds,
                     inflation, prune, ckpt=None, ckpt_key: str = '',
                     device: torch.device | None = None) -> List[List[int]]:
    """Oversize component (> max_dense nodes): block-sparse MCL
    (``mcl_blocksparse.py``, dense-tile products on ``device``) by
    default; SWIFTORTHO_MCL=scipy selects the host csr loop (same math,
    used as the parity oracle in tests).  SWIFTORTHO_MCL_MESH=1 shards
    the expansion over the local devices of ``device``'s platform when
    there is more than one (identical partitions)."""
    import os

    nodes = comp_nodes[c]
    loc = {int(g): i for i, g in enumerate(nodes)}
    sel = e_order[e_bounds[c]:e_bounds[c + 1]]
    m = len(nodes)
    li = np.fromiter((loc[int(g)] for g in ei[sel]), np.int64, len(sel))
    lj = np.fromiter((loc[int(g)] for g in ej[sel]), np.int64, len(sel))
    selfw = np.zeros(m, np.float32)
    np.maximum.at(selfw, li, w[sel].astype(np.float32))
    np.maximum.at(selfw, lj, w[sel].astype(np.float32))

    if os.environ.get('SWIFTORTHO_MCL', '') == 'scipy':
        import scipy.sparse as sp
        mat = sp.lil_matrix((m, m), dtype=np.float32)
        mat[li, lj] = w[sel]
        mat[lj, li] = w[sel]
        mat.setdiag(selfw)
        xr = _mcl_sparse(mat, inflation, prune)
        ri, rj = (xr > prune).nonzero()
    else:
        from .mcl_blocksparse import mcl_blocksparse

        # SWIFTORTHO_MCL_MESH=1: shard the expansion matmuls over every
        # local device (mcl_blocksparse mesh mode); identical partitions
        mesh = None
        if os.environ.get('SWIFTORTHO_MCL_MESH', '') not in ('', '0'):
            from ..parallel.distributed import local_devices
            from ..parallel.mesh import make_mesh
            devs = local_devices(device if device is not None else 'cpu')
            if len(devs) > 1:
                mesh = make_mesh(devices=devs)
        ri, rj = mcl_blocksparse(m, li, lj, w[sel].astype(np.float32),
                                 selfw, float(inflation), prune,
                                 ckpt=ckpt, ckpt_key=ckpt_key,
                                 device=device, mesh=mesh)
    out = []
    if len(ri):
        sub_labels = connected_components(m, ri, rj)
        present = np.zeros(m, bool)
        present[ri] = True
        present[rj] = True
        for lab in np.unique(sub_labels[present]):
            members = np.flatnonzero((sub_labels == lab) & present)
            out.append(sorted(int(nodes[i]) for i in members))
    return out
