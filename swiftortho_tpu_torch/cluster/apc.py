"""Affinity-propagation clustering as edge-list segment ops on PyTorch.

Port of ``swiftortho_tpu/cluster/apc.py``; the same contract (reference
``apclust``, bin/find_cluster.py:517-617, and ``fc2mat``, :767-858):
edge rows (i, k, s) for both directions of every pair plus
self-preference rows s = -20 * n_taxa; damped R/A updates; exemplar per
node = argmax_k(R+A); converged after 15 unchanged sweeps; clusters =
connected components of the node->exemplar graph.

The textbook modes (``_apclust_core``, ``apc_cluster_blocked``,
``apc_cluster``, ``sap_cluster``) run on the device their tensors are on,
in float32 as the JAX package does (no x64: ``jnp.zeros(E)`` is float32
and the float64 ``s`` it is handed is narrowed).  ``.at[].max/.min``
become ``scatter_reduce`` with ``amax``/``amin``; the column sums use
``numerics.SegmentSum``, whose fixed addition order makes a CUDA run
bitwise repeatable.  The JAX package's documented deviation from the
reference's numba row-max artifacts applies unchanged: the exact row max
and runner-up are computed.

``apc_cluster_faithful`` (the driver default) and ``_apclust_ref_py`` are
host code copied from the JAX package: the native C++ streaming emulation
of the reference ``apclust_blk`` (``native/apclust.cpp``, copied from the
JAX package),
with the named pure-Python fallback.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .components import connected_components
from .numerics import SegmentSum

NEG = -3.4e38
_FAR = 2 ** 62                   # `first` sentinel of the blocked sweeps


def _blk_max_by(acc, idx, val):
    return acc.scatter_reduce(0, idx, val, 'amax', include_self=True)


def _seg_max(n: int, idx: torch.Tensor, val: torch.Tensor,
             init: float = NEG) -> torch.Tensor:
    return _blk_max_by(torch.full((n,), init, dtype=val.dtype,
                                  device=val.device), idx, val)


def _seg_min(init: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    return init.scatter_reduce(0, idx, val, 'amin', include_self=True)


def _apclust_core(ei: torch.Tensor, ek: torch.Tensor, s: torch.Tensor,
                  n_nodes: int, damp: float = 0.5, convit: int = 15,
                  itr: int = 100) -> torch.Tensor:
    """Exemplar label per node; ei/ek int64 and s float32 on one device.
    The host reads the change flag once per sweep."""
    dev = ei.device
    E = ei.shape[0]
    beta = 1.0 - damp
    is_self = ei == ek
    eidx = torch.arange(E, device=dev)
    no_edge = torch.full((n_nodes,), E, dtype=torch.int64, device=dev)
    nodes = torch.arange(n_nodes, device=dev)
    colsum_of = SegmentSum(ek.cpu().numpy(), n_nodes, dev)
    r = torch.zeros(E, dtype=torch.float32, device=dev)
    a = torch.zeros(E, dtype=torch.float32, device=dev)
    lab = nodes
    mconv = 0
    for _ in range(itr):
        ra = r + a
        # per-row max and runner-up (exact)
        m1 = _seg_max(n_nodes, ei, ra)
        # arg of the max: smallest edge index achieving it
        hit = ra >= m1[ei] - 0.0
        first = _seg_min(no_edge, ei, torch.where(hit, eidx, E))
        is_arg = eidx == first[ei]
        m2 = _seg_max(n_nodes, ei, torch.where(is_arg, NEG, ra))
        r_new = s - torch.where(is_arg, m2[ei], m1[ei])
        r = damp * r + beta * r_new

        rkk = _seg_max(n_nodes, ei, torch.where(is_self, r, NEG),
                       init=0.0)                  # R_kk per node
        pos_r = torch.clamp_min(r, 0.0)
        colsum = colsum_of(torch.where(is_self, 0.0, pos_r))
        a_new = torch.where(is_self, colsum[ek],
                            torch.clamp_max(rkk[ek] + colsum[ek] - pos_r,
                                            0.0))
        a = damp * a + beta * a_new

        ra = r + a
        m = _seg_max(n_nodes, ei, ra)
        hit = ra >= m[ei]
        firstk = _seg_min(no_edge, ei, torch.where(hit, eidx, E))
        new_lab = torch.where(firstk < E, ek[torch.clamp(firstk, 0, E - 1)],
                              nodes)
        changed = bool((new_lab != lab).any())
        mconv = 0 if changed else mconv + 1
        lab = new_lab
        if mconv > convit:
            break
    return lab


def _blk_first(acc, idx, val, thresh_by_idx, base: int):
    hit = val >= thresh_by_idx[idx]
    eidx = base + torch.arange(val.shape[0], dtype=torch.int64,
                               device=val.device)
    return _seg_min(acc, idx, torch.where(hit, eidx, _FAR))


def _blk_r_update(r, s, ei, ek, m1, m2, first, base: int, n1: int,
                  damp: float, colsum_of: SegmentSum):
    """Damped R update for one block + partial rkk/colsum contributions."""
    beta = 1.0 - damp
    eidx = base + torch.arange(r.shape[0], device=r.device)
    is_arg = eidx == first[ei]
    r_new = s - torch.where(is_arg, m2[ei], m1[ei])
    r = damp * r + beta * r_new
    is_self = ei == ek
    rkk_part = _seg_max(n1, ei, torch.where(is_self, r, NEG))
    col_part = colsum_of(torch.where(is_self, 0.0, torch.clamp_min(r, 0.0)))
    return r, rkk_part, col_part


def _blk_a_update(r, a, ei, ek, rkk, colsum, n1: int, damp: float):
    """Damped A update for one block + partial row-max of R+A."""
    beta = 1.0 - damp
    is_self = ei == ek
    a_new = torch.where(is_self, colsum[ek],
                        torch.clamp_max(rkk[ek] + colsum[ek]
                                        - torch.clamp_min(r, 0.0), 0.0))
    a = damp * a + beta * a_new
    m_part = _seg_max(n1, ei, r + a)
    return a, m_part


def apc_cluster_blocked(n: int, ei: np.ndarray, ej: np.ndarray,
                        w: np.ndarray, n_taxa: int, damp: float = 0.5,
                        convit: int = 15, itr: int = 100,
                        block: int = 25_000_000,
                        spill_dir: str | None = None,
                        device: torch.device | None = None
                        ) -> List[List[int]]:
    """Blocked / out-of-core affinity propagation — the reference's
    ``apclust_blk`` (bin/find_cluster.py:405-513): the (i, k, s, R, A)
    edge table is swept in `block`-row blocks (reference -b default
    25e6), so device and host memory are bounded by one block plus the
    (n,) accumulators.  With ``spill_dir`` the R/A columns live in disk
    memmaps (the reference's cffi-mmapped .npy, :36-77).  Blocks go to
    ``device`` (default: the CPU) one at a time.

    Same math per sweep as ``_apclust_core``.  Block-partial reductions
    are combined with max/sum, so results match the in-memory path up to
    float addition order in colsum.
    """
    device = torch.device('cpu') if device is None else device
    if len(ei) == 0:
        return []
    pref = -20.0 * n_taxa
    i_all = np.concatenate([ei, ej, np.arange(n)]).astype(np.int64)
    k_all = np.concatenate([ej, ei, np.arange(n)]).astype(np.int64)
    s_all = np.concatenate([w, w, np.full(n, pref)]).astype(np.float32)
    E = len(i_all)
    n1 = n + 1                                   # slot n = padding sink

    if spill_dir:
        import os
        os.makedirs(spill_dir, exist_ok=True)
        r = np.memmap(os.path.join(spill_dir, 'R.f32'), np.float32,
                      'w+', shape=(E,))
        a = np.memmap(os.path.join(spill_dir, 'A.f32'), np.float32,
                      'w+', shape=(E,))
        r[:] = 0.0
        a[:] = 0.0
    else:
        r = np.zeros(E, np.float32)
        a = np.zeros(E, np.float32)

    nb = -(-E // block)
    blocks = [(b * block, min((b + 1) * block, E)) for b in range(nb)]

    def pad_blk(x, lo, hi, fill):
        out = x[lo:hi]
        if hi - lo < min(block, E):
            out = np.concatenate(
                [out, np.full(min(block, E) - (hi - lo), fill, x.dtype)])
        return out

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    ei_b = [dev(pad_blk(i_all, lo, hi, n)) for lo, hi in blocks]
    ek_h = [pad_blk(k_all, lo, hi, n) for lo, hi in blocks]
    ek_b = [dev(x) for x in ek_h]
    s_b = [dev(pad_blk(s_all, lo, hi, 0.0)) for lo, hi in blocks]
    colsum_of = [SegmentSum(x, n1, device) for x in ek_h]

    def blk_ra(b):
        lo, hi = blocks[b]
        return dev(pad_blk(r, lo, hi, NEG)) + dev(pad_blk(a, lo, hi, 0.0))

    def full(fill, dtype):
        return torch.full((n1,), fill, dtype=dtype, device=device)

    lab = np.arange(n, dtype=np.int64)
    mconv = 0
    for it in range(itr):
        # sweep 1: per-row max of R+A
        m1 = full(NEG, torch.float32)
        for b in range(nb):
            m1 = _blk_max_by(m1, ei_b[b], blk_ra(b))
        # sweep 2: first edge index achieving the row max
        first = full(_FAR, torch.int64)
        for b, (lo, hi) in enumerate(blocks):
            first = _blk_first(first, ei_b[b], blk_ra(b), m1, lo)
        # sweep 3: runner-up excluding the arg edge
        m2 = full(NEG, torch.float32)
        for b, (lo, hi) in enumerate(blocks):
            eidx = lo + torch.arange(ei_b[b].shape[0], device=device)
            is_arg = eidx == first[ei_b[b]]
            m2 = _blk_max_by(m2, ei_b[b],
                             torch.where(is_arg, NEG, blk_ra(b)))
        # sweep 4: R update + rkk/colsum accumulation
        rkk = full(NEG, torch.float32)
        colsum = full(0.0, torch.float32)
        for b, (lo, hi) in enumerate(blocks):
            rb, rkk_p, col_p = _blk_r_update(
                dev(pad_blk(r, lo, hi, 0.0)), s_b[b], ei_b[b], ek_b[b],
                m1, m2, first, lo, n1, float(damp), colsum_of[b])
            r[lo:hi] = rb.cpu().numpy()[:hi - lo]
            rkk = torch.maximum(rkk, rkk_p)
            colsum = colsum + col_p
        rkk = torch.clamp_min(rkk, 0.0)  # core inits its rkk scatter at 0
        # sweep 5: A update + row max of new R+A
        m = full(NEG, torch.float32)
        for b, (lo, hi) in enumerate(blocks):
            ab, m_p = _blk_a_update(
                dev(pad_blk(r, lo, hi, 0.0)), dev(pad_blk(a, lo, hi, 0.0)),
                ei_b[b], ek_b[b], rkk, colsum, n1, float(damp))
            a[lo:hi] = ab.cpu().numpy()[:hi - lo]
            m = torch.maximum(m, m_p)
        # sweep 6: exemplar = k of the first max edge per row
        firstk = full(_FAR, torch.int64)
        for b, (lo, hi) in enumerate(blocks):
            firstk = _blk_first(firstk, ei_b[b], blk_ra(b), m, lo)
        fk = firstk[:n].cpu().numpy()
        new_lab = np.where(fk < E, k_all[np.minimum(fk, E - 1)],
                           np.arange(n))
        if np.array_equal(new_lab, lab):
            mconv += 1
        else:
            mconv = 0
        lab = new_lab
        if mconv > convit:
            break

    return _groups(n, lab)


def _groups(n: int, lab: np.ndarray) -> List[List[int]]:
    """Clusters = components of the node -> exemplar graph, as ascending
    id lists ordered by smallest member."""
    labels = connected_components(n, np.arange(n), lab)
    out: List[List[int]] = []
    order = np.argsort(labels, kind='stable')
    bounds = np.searchsorted(labels[order], np.arange(labels.max() + 2))
    for c in range(labels.max() + 1):
        out.append(sorted(int(x) for x in order[bounds[c]:bounds[c + 1]]))
    out.sort(key=lambda cl: cl[0])
    return out


def _apclust_ref_py(ei: np.ndarray, ek: np.ndarray, s: np.ndarray,
                    n_nodes: int, damp: float = 0.5,
                    itr: int = 100) -> np.ndarray:
    """Pure-Python fallback of native/apclust.cpp apclust_ref — the same
    streaming emulation of the reference apclust_blk (find_cluster.py:
    406-513): never-reset/never-demoted row-max registers, float64 math
    with float32 R/A stores per pass, dead convergence check (full itr
    iterations), streaming exemplar updates."""
    beta = 1.0 - damp
    nr = len(ei)
    s64 = s.astype(np.float32).astype(np.float64)
    R = np.zeros(nr, np.float32)
    A = np.zeros(nr, np.float32)
    diag = np.zeros((n_nodes, 6))
    lab = np.arange(n_nodes, dtype=np.int64)
    eil = ei.tolist()
    ekl = ek.tolist()
    sl = s64.tolist()
    labl = lab.tolist()
    for _ in range(itr):
        Rl = R.astype(np.float64).tolist()
        Al = A.astype(np.float64).tolist()
        d0 = diag[:, 0].tolist(); d1 = diag[:, 1].tolist()
        d2 = diag[:, 2].tolist(); d3 = diag[:, 3].tolist()
        d5 = diag[:, 5].tolist()
        for n_ in range(nr):
            i = eil[n_]
            ra = Rl[n_] + Al[n_]
            if d0[i] < ra:
                d0[i] = ra
                d1[i] = float(ekl[n_])
            elif d2[i] < ra:
                d2[i] = ra
                d3[i] = float(ekl[n_])
        for n_ in range(nr):
            i, k = eil[n_], ekl[n_]
            r = sl[n_] - (d0[i] if float(k) != d1[i] else d2[i])
            r3 = Rl[n_] * damp + beta * r
            if i == k:
                d5[i] = r3
            Rl[n_] = r3
        R = np.asarray(Rl, np.float32)         # float32 store per pass
        Rl = R.astype(np.float64).tolist()
        d4 = [0.0] * n_nodes
        for n_ in range(nr):
            if eil[n_] != ekl[n_]:
                r = Rl[n_]
                if r > 0.0:
                    d4[ekl[n_]] += r
        for n_ in range(nr):
            i, k = eil[n_], ekl[n_]
            a4 = Al[n_] * damp
            if i != k:
                a4 += beta * min(0.0, d5[k] + d4[k] - max(0.0, Rl[n_]))
            else:
                a4 += beta * d4[k]
            Al[n_] = a4
        A = np.asarray(Al, np.float32)
        Al = A.astype(np.float64).tolist()
        ras = [float('-inf')] * n_nodes
        for n_ in range(nr):
            i = eil[n_]
            ra = Rl[n_] + Al[n_]
            if ras[i] < ra:
                ras[i] = ra
                if labl[i] != ekl[n_]:
                    labl[i] = ekl[n_]
        diag[:, 0] = d0; diag[:, 1] = d1; diag[:, 2] = d2
        diag[:, 3] = d3; diag[:, 4] = d4; diag[:, 5] = d5
    return np.asarray(labl, np.int64)


def apc_cluster_faithful(n: int, ei: np.ndarray, ej: np.ndarray,
                         w: np.ndarray, n_taxa: int, damp: float = 0.5,
                         itr: int = 100) -> List[List[int]]:
    """Reference-faithful AP: identical partitions to the runnable
    reference `find_cluster.py -a apc` (apclust_blk path, the -b default).

    Row order matters (the streaming quirks are order-dependent), so the
    caller must pass edges in input-line order WITH duplicates retained;
    this builds the fc2mat row stream — (x, y), (y, x) interleaved per
    line, then the n preference diagonal rows (find_cluster.py:806-848) —
    and runs the streaming kernel (native C++, pure-Python fallback,
    bit-identical; pinned by tests/test_fallbacks.py)."""
    if n == 0:
        return []
    # zero edges still cluster: every node gets its preference diagonal
    # row and becomes its own exemplar (singletons), like the reference
    pref = np.float32(-20.0 * n_taxa)
    i_all = np.empty(2 * len(ei) + n, np.int64)
    k_all = np.empty_like(i_all)
    s_all = np.empty(len(i_all), np.float32)
    i_all[0:2 * len(ei):2] = ei
    k_all[0:2 * len(ei):2] = ej
    i_all[1:2 * len(ei):2] = ej
    k_all[1:2 * len(ei):2] = ei
    s_all[0:2 * len(ei):2] = w
    s_all[1:2 * len(ei):2] = w
    i_all[2 * len(ei):] = np.arange(n)
    k_all[2 * len(ei):] = np.arange(n)
    s_all[2 * len(ei):] = pref
    try:
        from ..native import apclust_ref_native
        lab = apclust_ref_native(i_all, k_all, s_all, n, damp=damp,
                                 itr=itr)
    except Exception:
        from ..utils import warn_fallback
        warn_fallback('apclust_ref',
                      'native .so unavailable; pure-Python streaming AP')
        lab = _apclust_ref_py(i_all, k_all, s_all, n, damp=damp, itr=itr)
    labels = connected_components(n, np.arange(n), lab)
    out: List[List[int]] = []
    order = np.argsort(labels, kind='stable')
    bounds = np.searchsorted(labels[order], np.arange(labels.max() + 2))
    for c in range(labels.max() + 1):
        out.append(sorted(int(x) for x in order[bounds[c]:bounds[c + 1]]))
    out.sort(key=lambda cl: cl[0])
    return out


def apc_cluster(n: int, ei: np.ndarray, ej: np.ndarray, w: np.ndarray,
                n_taxa: int, damp: float = 0.5, convit: int = 15,
                itr: int = 100, pref: float | None = None,
                device: torch.device | None = None) -> List[List[int]]:
    """AP over an undirected edge list on ``device`` (default: the CPU);
    returns clusters (>= 1 member) as ascending id lists ordered by
    smallest member."""
    device = torch.device('cpu') if device is None else device
    if len(ei) == 0:
        return []
    if pref is None:
        pref = -20.0 * n_taxa                # fc2mat preference (:840-848)
    i_all = np.concatenate([ei, ej, np.arange(n)]).astype(np.int64)
    k_all = np.concatenate([ej, ei, np.arange(n)]).astype(np.int64)
    s_all = np.concatenate([w, w, np.full(n, pref)]).astype(np.float32)
    lab = _apclust_core(torch.from_numpy(i_all).to(device),
                        torch.from_numpy(k_all).to(device),
                        torch.from_numpy(s_all).to(device),
                        n_nodes=n, damp=float(damp), convit=convit,
                        itr=itr)
    return _groups(n, lab.cpu().numpy())


def sap_cluster(n: int, ei: np.ndarray, ej: np.ndarray, w: np.ndarray,
                n_taxa: int, damp: float = 0.9, convit: int = 15,
                itr: int = 200,
                device: torch.device | None = None) -> List[List[int]]:
    """Sparse-AP clustering with the reference SAP branch's contract
    (find_cluster.py:1725-1751): edge weights min-max normalized to
    [0, 1] (``(z - min) / (max - min)``), per-node preference
    ``-10 * n_taxa`` (:1737-1738 — half the APC branch's -20), sparse AP
    over exactly the edge support, damping 0.9, converged after 15 stable
    sweeps.  The JAX package's named deviations hold: (a) uniform-weight
    input (max == min) normalizes to 0.0; (b) exemplar chains are closed
    with connected components like the APC branch."""
    if len(ei) == 0:
        return []
    lo, hi = float(w.min()), float(w.max())
    wn = (w - lo) / (hi - lo) if hi > lo else np.zeros_like(w)
    return apc_cluster(n, ei, ej, wn, n_taxa, damp=damp, convit=convit,
                       itr=itr, pref=-10.0 * n_taxa, device=device)
