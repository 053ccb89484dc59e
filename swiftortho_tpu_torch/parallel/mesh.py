"""Multi-device sharding of the search on PyTorch.

Port of ``swiftortho_tpu/parallel/mesh.py`` (:28-238: ``use_search_mesh``
:40, ``make_mesh`` :53, ``sw_align_sharded`` :83, ``sharded_search_step``
:138, ``blastp_sharded`` :180, ``demo_multichip`` :206; ``sharded_align_fn``
:64 is ``sw_align_sharded`` here).  The reference's parallelism
(SURVEY.md 2.5) maps as in the JAX package:
- P1 (query data-parallelism; reference mp.Pool over query chunks,
  bin/find_hit.py:107-146) -> the 'data' mesh axis;
- P2/P3 (reference DB chunk passes + sort-merge of per-part hit tables,
  find_hit.py:286-351) -> the 'db' mesh axis, merged by a gather and a
  per-query max.

What replaces JAX's shardings:
- ``Mesh`` is a small grid of ``torch.device`` with named axes (default
  ``('data', 'db')``) and the rank that owns each entry.  An explicit
  device list may repeat a device: a mesh over ``[cpu] * 4`` runs the
  sharded code on the CPU, and a mesh over one card is what one H100
  gives.
- A sharded call splits the pair axis into one contiguous shard per mesh
  entry, in mesh order, moves each shard to its device, runs the device
  work there (``ops.banded_sw.sw_align_local``: the CUDA kernel on a card,
  the plain version on the CPU) and joins the results in order.  Launches
  on different cards overlap: every shard is queued before any is read.
- Nothing is padded: the JAX version pads batches to powers of two for
  its compile cache (:89-105), which eager torch does not have.
- A mesh that spans processes (``distributed.global_mesh``) gathers the
  ranks' shards with ``torch.distributed.all_gather`` (gloo for CPU
  tensors, NCCL for CUDA tensors; ``distributed.collective_group``).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ..constants import KA_GAPPED_LAMBDA, KA_GAPPED_LNK, LN2
from ..ops.banded_sw import FIELDS, sw_align_local
from ..ops.seg import seg_batch

# The active search mesh: when set (via use_search_mesh), the search
# pipeline's device batches (sw_align_auto) run sharded over it instead
# of on one device.  Module-global rather than threaded through every
# call because the mesh is a per-run execution property, not a per-batch
# argument; global (not a context variable) so the search's producer and
# pipeline threads see it.
_ACTIVE_MESH = None


class Mesh:
    """Devices on a grid with named axes.

    ``devices``: an object array of ``torch.device`` (any shape);
    ``procs``: the rank that owns each entry (default: this process).
    """

    def __init__(self, devices, axis_names=('data', 'db'), procs=None):
        devs = np.asarray(devices, dtype=object)
        self.devices = np.empty(devs.shape, dtype=object)
        for ix, d in np.ndenumerate(devs):
            self.devices[ix] = torch.device(d)
        self.axis_names = tuple(axis_names)
        assert self.devices.ndim == len(self.axis_names), \
            (self.devices.shape, self.axis_names)
        if procs is None:
            from .distributed import process_index
            procs = np.full(self.devices.shape, process_index(), np.int64)
        self.procs = np.asarray(procs, np.int64).reshape(self.devices.shape)
        flat = self.procs.reshape(-1)
        assert (np.diff(flat) >= 0).all(), 'mesh entries must be rank-major'

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The devices in mesh (row-major) order."""
        return list(self.devices.reshape(-1))

    def spans_processes(self) -> bool:
        return len(set(self.procs.reshape(-1).tolist())) > 1

    def owned(self) -> list:
        """Flat indices of the entries this process computes."""
        from .distributed import process_index
        return [int(k) for k in
                np.flatnonzero(self.procs.reshape(-1) == process_index())]

    def __repr__(self):
        return 'Mesh(%s, axis_names=%s)' % (
            [[str(d) for d in row] for row in
             self.devices.reshape(self.devices.shape[0], -1)],
            self.axis_names)


def active_search_mesh():
    return _ACTIVE_MESH


@contextmanager
def use_search_mesh(mesh: Mesh):
    """Run the search pipeline's device compute sharded over `mesh`."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def make_mesh(n_data: int | None = None, n_db: int = 1,
              devices=None) -> Mesh:
    """('data', 'db') mesh over ``devices`` (default: this process's
    devices of the platform, ``distributed.local_devices``)."""
    if devices is None:
        from .distributed import local_devices
        devices = local_devices()
    devices = list(devices)
    n = len(devices)
    if n_data is None:
        n_data = n // n_db
    assert n_data * n_db <= n, (n_data, n_db, n)
    grid = np.empty(n_data * n_db, dtype=object)
    for i, d in enumerate(devices[:n_data * n_db]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(n_data, n_db), axis_names=('data', 'db'))


def shard_bounds(n: int, parts: int) -> list:
    """``parts`` contiguous [lo, hi) slices of range(n), in order, the
    first n % parts one longer (``numpy.array_split``'s split)."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for k in range(parts):
        hi = lo + q + (k < r)
        out.append((lo, hi))
        lo = hi
    return out


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _gather_ranks(mesh: Mesh, local: torch.Tensor, sizes: list
                  ) -> torch.Tensor:
    """Rows of every rank of a multi-process mesh, in rank order:
    ``local`` holds this rank's rows, ``sizes[r]`` the row count of rank
    r.  One all_gather of equal-size (padded) pieces."""
    import torch.distributed as dist

    from .distributed import collective_group, process_index
    me = process_index()
    assert local.shape[0] == sizes[me], (local.shape, sizes, me)
    width = max(sizes)
    pad = torch.zeros((width - local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    piece = torch.cat([local, pad]).contiguous()
    bufs = [torch.empty_like(piece) for _ in sizes]
    dist.all_gather(bufs, piece, group=collective_group(piece.device))
    return torch.cat([b[:s] for b, s in zip(bufs, sizes)])


def _rank_rows(mesh: Mesh, bounds: list, keys: list) -> list:
    """Rows per rank when the flat entries ``keys[i]`` cover the slices
    ``bounds[i]``."""
    ranks = mesh.procs.reshape(-1)
    sizes = [0] * (int(ranks.max()) + 1)
    for k, (lo, hi) in zip(keys, bounds):
        sizes[int(ranks[k])] += hi - lo
    return sizes


def sw_align_sharded(mesh: Mesh, tok0, tok1, len0, len1,
                     score_only: bool = False) -> dict:
    """Batch alignment with the pair axis sharded over every mesh device
    (('data','db') flattened: pure data parallelism over pairs, the mesh
    analog of the reference's mp.Pool over per-range fsearch-c processes,
    bin/find_hit.py:127-132).

    Takes tensors (any device) or numpy arrays; returns a dict of (B,)
    int32 tensors keyed by ``FIELDS`` on ``tok0``'s device (the CPU for
    numpy input), equal to ``sw_align_local`` on the whole batch.  On a
    multi-process mesh every rank gets the whole result.
    """
    tok0, tok1, len0, len1 = (_tensor(x) for x in (tok0, tok1, len0, len1))
    out_dev = tok0.device
    B = tok0.shape[0]
    flat = mesh.flat()
    bounds = shard_bounds(B, len(flat))
    parts = []
    for k in mesh.owned():
        lo, hi = bounds[k]
        if hi > lo:
            d = flat[k]
            args = [x[lo:hi].to(d).contiguous()
                    for x in (tok0, tok1, len0, len1)]
            best = sw_align_local(*args, score_only=score_only)
            parts.append(torch.stack([best[f] for f in FIELDS], 1))
    if parts:
        rows = torch.cat([p.to(out_dev) for p in parts])
    else:
        rows = torch.zeros((0, len(FIELDS)), dtype=torch.int32,
                           device=out_dev)
    if mesh.spans_processes():
        sizes = _rank_rows(mesh, bounds, range(len(flat)))
        rows = _gather_ranks(mesh, rows, sizes).to(out_dev)
    return {f: rows[:, i].contiguous() for i, f in enumerate(FIELDS)}


def _bits(score: torch.Tensor) -> torch.Tensor:
    """Bit score trunc((lambda * score - lnK) / ln2) in float32, as the
    JAX step computes it (:163-165)."""
    return torch.trunc((KA_GAPPED_LAMBDA * score.to(torch.float32)
                        - KA_GAPPED_LNK) / LN2).to(torch.int32)


def sharded_search_step(mesh: Mesh):
    """The full per-wave device step, sharded over a 2-D mesh:

    queries  (Bq, L)  split over 'data' (each row of the mesh masks its
             block on its first device)
    pairs    (Bp, L)  split over ('data', 'db') flattened
    output:  per-query best bit score after a gather of every pair's bits
             and a per-query max (the reference's sort -m merge,
             find_hit.py:350).

    Returns fn(q_tokens, q_lens, t0, t1, l0, l1, pair_query, nq) ->
    (masked queries, per-pair bits, merged per-query best bit) as numpy
    arrays, whole on every rank.  The JAX version's ``replicate_out`` has
    no counterpart: a rank can always read the gathered result.
    """
    n_data = mesh.shape[0]
    n_db = mesh.size // n_data

    def step(q_tokens, q_lens, t0, t1, l0, l1, pair_query, nq: int):
        q_tokens, q_lens, t0, t1, l0, l1, pair_query = (
            _tensor(x) for x in (q_tokens, q_lens, t0, t1, l0, l1,
                                 pair_query))
        flat = mesh.flat()
        owned = mesh.owned()
        # seg on the first device of each 'data' row
        q_bounds = shard_bounds(q_tokens.shape[0], n_data)
        rows_of = sorted({k // n_db for k in owned})
        masked = [seg_batch(q_tokens[lo:hi].to(flat[r * n_db]),
                            q_lens[lo:hi].to(flat[r * n_db])).cpu()
                  for r in rows_of for lo, hi in [q_bounds[r]]]
        masked = torch.cat(masked) if masked else q_tokens[:0].clone()
        # align + bit score on every device, all queued before any read
        p_bounds = shard_bounds(t0.shape[0], len(flat))
        bits = []
        for k in owned:
            lo, hi = p_bounds[k]
            d = flat[k]
            best = sw_align_local(*(x[lo:hi].to(d).contiguous()
                                    for x in (t0, t1, l0, l1)))
            bits.append(_bits(best['score']))
        bits = torch.cat([b.cpu() for b in bits]) if bits else \
            torch.zeros(0, dtype=torch.int32)
        if mesh.spans_processes():
            first = flat[owned[0]] if owned else torch.device('cpu')
            on = first if first.type == 'cuda' else torch.device('cpu')
            masked = _gather_ranks(mesh, masked.to(on), _rank_rows(
                mesh, [q_bounds[k // n_db] for k in range(0, mesh.size,
                                                          n_db)],
                range(0, mesh.size, n_db))).cpu()
            bits = _gather_ranks(mesh, bits.to(on), _rank_rows(
                mesh, p_bounds, range(len(flat)))).cpu()
        # per-query max over the gathered pair axis, on the first device
        dev = flat[0] if not mesh.spans_processes() else bits.device
        merged = torch.full((nq,), -1, dtype=torch.int32, device=dev)
        merged = merged.scatter_reduce(0, pair_query.to(dev).to(torch.int64),
                                       bits.to(dev), 'amax',
                                       include_self=True)
        return masked.numpy(), bits.numpy(), merged.cpu().numpy()

    return step


def blastp_sharded(qry, ref, cfg, mesh: Mesh | None = None,
                   q_start: int = 0, q_end: int = -1,
                   device: torch.device | None = None):
    """All-vs-all search with the device compute sharded over `mesh` (the
    multi-device analog of the reference's process fan-out + merge,
    bin/find_hit.py:107-151, :286-351): every alignment batch splits its
    pairs over the mesh devices, and under SWIFTORTHO_DEVICE_PACK=force
    the pair packing does too.  Rows are byte-identical to the
    single-device ``blastp_stream``.  ``device``: where the rest of the
    search runs (default ``get_device()``).

    Yields m8 rows in query order.
    """
    from ..search.blastp import blastp_stream

    mesh = mesh or make_mesh()
    with use_search_mesh(mesh):
        yield from blastp_stream(qry, ref, cfg, q_start=q_start,
                                 q_end=q_end, device=device)


def demo_multichip(n_queries: int = 16, pad: int = 64,
                   mesh: Mesh | None = None):
    """Build tiny inputs (the JAX ``demo_multichip``'s, from the same
    seed) and run one sharded step; returns (masked, bits, merged)."""
    mesh = mesh or make_mesh()
    ndev = mesh.size
    nq = max(n_queries, ndev * 2)
    nq -= nq % (mesh.shape[0])                  # divisible over 'data'
    rng = np.random.default_rng(0)
    AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
    q = AA[rng.integers(0, 20, (nq, pad))]
    ql = np.full(nq, pad - 8, np.int32)
    npair = nq * 2
    npair -= npair % ndev
    t0 = AA[rng.integers(0, 20, (npair, pad))]
    t1 = AA[rng.integers(0, 20, (npair, pad))]
    l0 = np.full(npair, pad - 8, np.int32)
    l1 = np.full(npair, pad - 8, np.int32)
    pq = (np.arange(npair) % nq).astype(np.int32)
    step = sharded_search_step(mesh)
    return step(q, ql, t0, t1, l0, l1, pq, nq)
