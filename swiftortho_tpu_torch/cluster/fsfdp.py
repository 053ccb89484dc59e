"""Density-peaks clustering (Rodriguez & Laio) over an xyz edge list.

Behavioral contract: reference scripts/fsfdp.py (experimental in the
reference): z column treated as a *distance*; dc comes from
`len(d) < di and d[-di] or d[-1]` (:58) which, since d holds all N edge
distances and di = 0.02*N, always takes d[-1] — the MAXIMUM distance;
Gaussian density rho[x] += exp(-(z/dc)^2) per incident edge; delta[x] =
min distance to a higher-density neighbor along an edge, nn[x] = that
neighbor; the global density peak gets delta = max(delta); centers =
nodes with rho > mean(rho) and delta > sd(delta), where sd() runs over
only the delta-dict members (nodes that HAVE a higher-rho neighbor, plus
the global peak — component-local peaks are excluded, :145-146); members
are assigned by flooding the reversed nearest-higher-neighbor forest
from each center (:148-209). Deviations (guarded reference crashes):
dc == 0 would ZeroDivisionError (:68) -> we use 1.0; an all-equal-rho
input would ValueError on max(delta.values()) (:113) -> mx_delta = 1.0;
lines with <3 tab fields would ValueError on unpack -> skipped.

`fsfdp_report` reproduces the script's ACTUAL stdout byte-for-byte
(:106,148,183,214,223-260): the four diagnostic lines plus one
halo/core line per assigned node, including the reference's quirks —
the halo line prints the stale loop variable `x` (the first column of
the file's last line) instead of the node id (:259), and a cluster
with no border edge prints its bord_rho as the int `0` default (:258).
The group listing (`fsfdp_groups`) is our addition: the reference
raises SystemExit before its group-output code (:263).

Vectorized numpy implementation.

Copied from ``swiftortho_tpu/cluster/fsfdp.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from math import exp as _math_exp
from typing import Dict, Iterable, Iterator, List

import numpy as np


def _fsfdp_state(lines: Iterable[str]) -> dict:
    l2n: Dict[str, int] = {}
    ei: List[int] = []
    ej: List[int] = []
    w: List[float] = []
    last_x = ''
    for line in lines:
        # reference :227 does i[:-1].split('\t') — it UNCONDITIONALLY
        # drops the last character, so a final line with no trailing
        # newline loses its last data byte (e.g. z '0.35' parses as
        # '0.3').  Quirks are the spec: replicate exactly.
        f = line[:-1].split('\t')
        if len(f) < 3:
            continue
        # reference :227 assigns x before the x==y skip, so the stale
        # variable the halo lines print is the LAST line's first column
        last_x = f[0]
        if f[0] == f[1]:
            continue
        for t in (f[0], f[1]):
            if t not in l2n:
                l2n[t] = len(l2n)
        ei.append(l2n[f[0]])
        ej.append(l2n[f[1]])
        w.append(float(f[2]))
    n = len(l2n)
    if n == 0:
        return {'n': 0, 'l2n': l2n, 'assign': {}}
    ei = np.asarray(ei)
    ej = np.asarray(ej)
    z = np.asarray(w)
    m = len(z)

    # reference :58: `len(d) < di and d[-di] or d[-1]` with len(d) == m
    # and di = int(.02*m) <= m, so the conditional is always False and
    # dc is the maximum distance.
    dc = z.max()
    dc = dc if dc > 0 else 1.0

    # math.exp, not np.exp: the two libm paths differ in the last ulp
    # and the reference (:72) uses math.exp — rho must match bit-for-bit
    gauss = np.asarray([_math_exp(-((v / dc) ** 2)) for v in z])
    rho = np.zeros(n)
    # interleave x/y increments in file order so float accumulation
    # matches the reference's rho[x]+=g; rho[y]+=g loop bit-for-bit
    # (np.add.at is unbuffered and applies updates sequentially).
    np.add.at(rho, np.stack([ei, ej], 1).ravel(), np.repeat(gauss, 2))

    # delta[x] = min distance to a higher-rho neighbor; nn = that neighbor
    # (first minimal edge in file order on ties, like the reference)
    delta = np.full(n, np.inf)
    nn = np.full(n, -1, np.int64)
    lower_i = rho[ei] < rho[ej]
    lower_j = rho[ej] < rho[ei]
    eidx = np.arange(m)
    cand_a = np.concatenate([ei[lower_i], ej[lower_j]])
    cand_b = np.concatenate([ej[lower_i], ei[lower_j]])
    cand_z = np.concatenate([z[lower_i], z[lower_j]])
    cand_o = np.concatenate([eidx[lower_i], eidx[lower_j]])
    # ins[x] = index of the edge that first inserted x into the delta
    # dict (the reference's dict preserves insertion order, which sets
    # both the sd() accumulation order and center numbering).
    ins = np.full(n, np.iinfo(np.int64).max)
    if len(cand_a):
        np.minimum.at(ins, cand_a, cand_o)
        order = np.lexsort((cand_o, cand_z, cand_a))
        aa, bb, zz = cand_a[order], cand_b[order], cand_z[order]
        first = np.ones(len(aa), bool)
        first[1:] = aa[1:] != aa[:-1]
        delta[aa[first]] = zz[first]
        nn[aa[first]] = bb[first]

    peak = int(np.argmax(rho))
    member = np.isfinite(delta)  # nodes in the reference's delta dict
    nn_size = int(member.sum())  # len(nn) printed at :106, pre-peak
    finite = delta[member]
    mx_delta = finite.max() if len(finite) else 1.0
    delta[peak] = mx_delta
    member[peak] = True  # appended last (ins[peak] stays at int64 max)
    delta[~np.isfinite(delta)] = 0.0

    def _seqsum(v):
        # left-to-right sequential float fold, like the reference sd()'s
        # reduce(lambda a, b: a + b, ...) (:25)
        return float(np.cumsum(v)[-1]) if len(v) else 0.0

    def _pysum(v):
        # builtins.sum, like the reference's mean() (:19): CPython >=3.12
        # sums floats with Neumaier compensation, which differs from a
        # plain fold in the last ulps — and these thresholds gate centers
        return sum(v.tolist())

    rho_min = _pysum(rho) / n
    # sd() over the delta dict only (:145-146), in insertion order:
    # component-local peaks that never entered delta are excluded.
    midx = np.flatnonzero(member)
    midx = midx[np.argsort(ins[midx], kind='stable')]
    vals = delta[midx]
    mu = _pysum(vals) / len(vals)
    dmin = (_seqsum((vals - mu) ** 2) / len(vals)) ** 0.5

    cl = np.full(n, -1, np.int64)
    centers = [int(x) for x in midx
               if rho[x] > rho_min and delta[x] > dmin]
    for c, node in enumerate(centers):
        cl[node] = c

    # the rebuilt nn dict of :158-183 (nearest-cluster map, printed then
    # discarded): non-center nodes with an edge to a strictly-higher-rho
    # center
    is_center = cl >= 0
    to_c = ((rho[ei] < rho[ej]) & is_center[ej] & ~is_center[ei])
    from_c = ((rho[ej] < rho[ei]) & is_center[ei] & ~is_center[ej])
    total_nn = len(np.unique(np.concatenate([ei[to_c], ej[from_c]])))

    # flood the reversed nn forest from centers, with the reference's
    # exact dict/list semantics (:107-115,187-205): rnn children lists
    # are built by nn.popitem() (reverse delta-insertion order), the
    # flood's `stack = rnn[i]` DRAINS the center's own list in place —
    # so a later ancestor-center flood cannot descend past an
    # already-flooded center — and `c = cl[i]` is read once at flood
    # start (a center overwritten by an earlier flood spreads the
    # overwriting id, not its own).
    order_nodes = [int(i) for i in midx if nn[i] >= 0]
    rnn: Dict[int, List[int]] = {}
    for k in reversed(order_nodes):
        rnn.setdefault(int(nn[k]), []).append(k)
    for node in centers:
        c = int(cl[node])
        stack = rnn.get(int(node))
        if stack is None:
            continue
        visit = set()
        while stack:
            x = stack.pop()
            if x not in visit:
                visit.add(x)
                cl[x] = c
                stack.extend(rnn.get(x, []))

    n2l = {v: k for k, v in l2n.items()}
    return {
        'n': n, 'l2n': l2n, 'ei': ei, 'ej': ej, 'z': z, 'dc': dc,
        'rho': rho, 'delta': delta, 'member': member, 'cl': cl,
        'centers': centers, 'nn_size': nn_size, 'rho_min': rho_min,
        'dmin': dmin, 'total_nn': total_nn, 'last_x': last_x,
        'assign': {n2l[i]: int(cl[i]) for i in range(n) if cl[i] >= 0},
    }


def fsfdp_cluster(lines: Iterable[str]) -> Dict[str, int]:
    return _fsfdp_state(lines)['assign']


def fsfdp_report(lines: Iterable[str]) -> Iterator[str]:
    """The reference script's stdout, byte-for-byte (:106-260)."""
    st = _fsfdp_state(lines)
    if st['n'] == 0:
        return
    yield 'nn size %s\n' % st['nn_size']
    yield 'rho_min %s delta_min %s\n' % (st['rho_min'], st['dmin'])
    yield 'total_nn_cl %s %s\n' % (len(st['centers']), st['total_nn'])
    cl = st['cl']
    n_assigned = int((cl >= 0).sum())
    yield 'flag is %s %s\n' % (len(st['centers']), n_assigned)

    # border density per cluster (:224-246): max mean-rho over
    # cross-cluster edges with z <= dc
    ei, ej, z, rho = st['ei'], st['ej'], st['z'], st['rho']
    cx, cy = cl[ei], cl[ej]
    cross = (cx >= 0) & (cy >= 0) & (cx != cy) & (z <= st['dc'])
    bord = np.full(len(st['centers']), -np.inf)
    if cross.any():
        avg = (rho[ei[cross]] + rho[ej[cross]]) / 2.0
        np.maximum.at(bord, cx[cross], avg)
        np.maximum.at(bord, cy[cross], avg)

    n_member = int(st['member'].sum())
    x = st['last_x']  # the reference prints this stale variable (:259)
    for i in range(st['n']):
        c = int(cl[i])
        if c == -1:
            continue
        rhoi = float(rho[i])
        # bord_rho.get(c, 0): the int 0 default prints as `0` (:258)
        bdi = float(bord[c]) if np.isfinite(bord[c]) else 0
        yield '%s cluster %s %s %s %s %s %s %s\n' % (
            x, c, rhoi, bdi, rhoi < bdi and 'halo' or 'core',
            n_assigned, st['n'], n_member)


def fsfdp_groups(lines: Iterable[str]) -> Iterator[str]:
    assign = fsfdp_cluster(lines)
    groups: Dict[int, List[str]] = {}
    for g, c in assign.items():
        groups.setdefault(c, []).append(g)
    for c in sorted(groups):
        yield '\t'.join(sorted(groups[c])) + '\n'
