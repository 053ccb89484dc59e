"""Multi-process scale-out: rank-split query ranges + ordered part merge.

Port of ``swiftortho_tpu/parallel/distributed.py`` (:49-245) onto
``torch.distributed``.  The reference scales past one machine by fanning
independent find_hit workers over contiguous query ranges and
concatenating their outputs in range order (bin/find_hit.py:107-151), and
the JAX package keeps that shape:

- every rank loads the same inputs and takes its contiguous 1/N slice of
  the query range (``rank_query_range``); the host work of the search
  (seeding, candidates, policy, formatting) is 1/N per rank;
- within a rank, device pair batches shard over the rank's own devices
  only (``parallel.mesh``): ranks run different wave schedules, so no
  collective crosses ranks during the search;
- the merged hit table is the rank-ordered concatenation of per-rank
  outputs (``fleet_search_to_file``), byte-identical to the
  single-process ``blastp_stream`` over the full range.

The only cross-rank operation of the fleet is its barrier, which is host
coordination: it runs on a gloo group of its own, so two ranks may share
one card.  The default group is ``cpu:gloo,cuda:nccl`` where NCCL exists
(CUDA tensors of a spanning mesh gather over NCCL) and ``gloo`` elsewhere.

The process identity comes from arguments or SWIFTORTHO_COORD
(host:port of rank 0's store), SWIFTORTHO_NPROCS and SWIFTORTHO_PROC_ID;
SWIFTORTHO_DIST_TIMEOUT (seconds, default 1800) bounds the join and every
collective, so a lost rank fails the others instead of hanging them.
A rank on ``cuda`` uses its share of its host's cards
(``local_devices``) and makes the first current.

Left out: ``host_to_global`` and ``is_multiprocess`` (JAX :105-115) build
``jax.Array``s across processes; torch tensors need no such step (a
spanning mesh records each entry's rank instead, ``mesh.Mesh.procs``).
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from ..device import get_device
from ..device import local_devices as _platform_devices
from .mesh import Mesh, make_mesh, use_search_mesh

_GLOO = None              # the gloo group of the fleet's barriers
_HOST = {'rank': 0, 'size': 1}    # this rank's place among its host's ranks
_SHARED_CARD = False      # two ranks of the group use one card


def _dist():
    import torch.distributed as dist
    return dist


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices(device=None) -> list:
    """This rank's devices of ``device``'s platform (default
    ``get_device()``): on ``cuda``, a contiguous share of its host's
    cards by its place among the host's ranks (a rank shares a card only
    when its host has fewer cards than ranks); the CPU otherwise."""
    device = get_device() if device is None else torch.device(device)
    devs = _platform_devices(device)
    if device.type != 'cuda' or _HOST['size'] == 1:
        return devs
    n, r, k = len(devs), _HOST['rank'], _HOST['size']
    return devs[n * r // k:n * (r + 1) // k] or [devs[r % n]]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: Optional[float] = None) -> bool:
    """Join the fleet if configured; returns True when this process is
    part of a multi-process fleet.

    Reads SWIFTORTHO_COORD (host:port), SWIFTORTHO_NPROCS and
    SWIFTORTHO_PROC_ID where an argument is not given.  No-op (returns
    False) when neither arguments nor env are present.
    """
    global _GLOO, _SHARED_CARD
    coord = coordinator_address or os.environ.get('SWIFTORTHO_COORD')
    nproc = num_processes if num_processes is not None else \
        int(os.environ.get('SWIFTORTHO_NPROCS', '0')) or None
    pid = process_id if process_id is not None else \
        (int(os.environ['SWIFTORTHO_PROC_ID'])
         if 'SWIFTORTHO_PROC_ID' in os.environ else None)
    if coord is None and nproc is None:
        return False
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coord is None or nproc is None or pid is None:
        raise ValueError('a fleet needs SWIFTORTHO_COORD (host:port), '
                         'SWIFTORTHO_NPROCS and SWIFTORTHO_PROC_ID; got '
                         '%r, %r, %r' % (coord, nproc, pid))
    secs = timeout if timeout is not None else float(
        os.environ.get('SWIFTORTHO_DIST_TIMEOUT', '1800'))
    nccl = torch.cuda.is_available() and dist.is_nccl_available()
    dist.init_process_group(
        'cpu:gloo,cuda:nccl' if nccl else 'gloo',
        init_method='tcp://%s' % coord, world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=secs))
    atexit.register(_shutdown)
    _GLOO = dist.new_group(backend='gloo') if nccl else dist.group.WORLD
    # place among this host's ranks, and which card each rank uses
    host = socket.gethostname()
    names = [None] * nproc
    dist.all_gather_object(names, host, group=_GLOO)
    _HOST.update(rank=names[:pid].count(host), size=names.count(host))
    card = None
    if (os.environ.get('SWIFTORTHO_PLATFORM', 'cuda').strip().lower()
            == 'cuda' and torch.cuda.is_available()):
        card = local_devices('cuda')[0]
        torch.cuda.set_device(card)
        card = card.index
    cards = [None] * nproc
    dist.all_gather_object(cards, (host, card), group=_GLOO)
    used = [c for c in cards if c[1] is not None]
    _SHARED_CARD = len(set(used)) < len(used)
    return nproc > 1


def _shutdown():
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def collective_group(device: torch.device):
    """The group a cross-rank collective on ``device``'s tensors runs on:
    the gloo group for CPU tensors, the default group (NCCL) for CUDA
    tensors.  Raises when two ranks use one card: NCCL cannot run that."""
    if torch.device(device).type != 'cuda':
        return _GLOO
    if _SHARED_CARD:
        raise RuntimeError('two ranks of this fleet use one card, which '
                           'NCCL cannot run; gather CPU tensors (gloo) '
                           'or give each rank its own card')
    return None


def rank_query_range(q_start: int, q_end: int, nproc: int,
                     pid: int) -> tuple:
    """Rank ``pid``'s contiguous query slice [lo, hi) of the global
    range [q_start, q_end) — the reference's per-worker ``-l/-u``
    assignment (bin/find_hit.py:107-127), balanced to within one query.
    """
    total = max(0, q_end - q_start)
    lo = q_start + (total * pid) // nproc
    hi = q_start + (total * (pid + 1)) // nproc
    return lo, hi


def global_mesh(n_db: Optional[int] = None, devices=None) -> Mesh:
    """('data', 'db') mesh over every device of every rank, rank-major:
    'data' crosses ranks, 'db' stays within one.  ``devices``: this
    rank's devices (default ``local_devices()``; every rank must give
    the same count).

    Used by the lockstep demo (``mesh.sharded_search_step``); the fleet
    search shards only over each rank's own devices, because rank-split
    query ranges give each rank its own wave schedule.  n_db defaults to
    the per-rank device count (one 'data' row per rank) and must divide
    it, so no 'db' group straddles two ranks.
    """
    local = list(devices) if devices is not None else local_devices()
    if n_db is None:
        n_db = len(local)
    assert len(local) % n_db == 0, (len(local), n_db)
    names = [[str(d) for d in local]]
    if process_count() > 1:
        names = [None] * process_count()
        _dist().all_gather_object(names, [str(d) for d in local],
                                  group=_GLOO)
    assert len({len(x) for x in names}) == 1, names
    devs = np.empty(sum(len(x) for x in names), dtype=object)
    devs[:] = [torch.device(d) for x in names for d in x]
    procs = np.repeat(np.arange(len(names)), len(local))
    return Mesh(devs.reshape(-1, n_db), ('data', 'db'),
                procs.reshape(-1, n_db))


def local_search_mesh(n_db: Optional[int] = None) -> Mesh:
    """('data', 'db') mesh over THIS rank's devices only — the per-rank
    device parallelism inside the fleet's query-range split."""
    return make_mesh(n_db=n_db or 1, devices=local_devices())


def search_mesh_context(n_db: Optional[int] = None):
    """Context manager the CLIs wrap their search in: shard device pair
    batches over this process's devices when it is part of a fleet or
    SWIFTORTHO_MESH=1 asks for local multi-device sharding; no-op when
    the process has one device of its platform (one card, or the CPU).

    Fleet ranks never share a search mesh: cross-host parallelism comes
    from the query-range split (each rank has its own wave schedule), so
    per-wave work stays within a rank.
    """
    want = (process_count() > 1
            or os.environ.get('SWIFTORTHO_MESH', '') not in ('', '0'))
    if want and len(local_devices()) > 1:
        return use_search_mesh(local_search_mesh(n_db=n_db))
    return nullcontext()


def resolve_query_range(qry, ref, q_start: int, q_end: int) -> tuple:
    """The reference's range defaulting (fsearch.py:2980-2981): the end
    defaults to the REFERENCE-set size clamped to the query count."""
    nq, D = len(qry), len(ref)
    q_start = min(max(0, q_start), nq)
    q_end = min(D, nq) if q_end < 0 else min(q_end, nq)
    return q_start, q_end


def blastp_distributed(qry, ref, cfg, n_db: Optional[int] = None,
                       q_start: int = 0, q_end: int = -1,
                       indexes=None, spill_dir: Optional[str] = None,
                       device: Optional[torch.device] = None):
    """This rank's share of the all-vs-all search: the global query range
    splits into process_count contiguous slices (the reference's ``-l/-u``
    fan-out, bin/find_hit.py:107-151), and each rank's device batches
    shard over its own devices only.  ``device``: the rank's device
    (default ``get_device()``).

    Yields THIS RANK'S m8 rows (queries [lo, hi) in query order).  The
    full table is the rank-ordered concatenation of every rank's rows
    (``fleet_search_to_file``), byte-identical to the single-process
    ``blastp_stream`` over the full range.
    """
    from ..search.blastp import blastp_stream
    from ..utils import log_event

    q_start, q_end = resolve_query_range(qry, ref, q_start, q_end)
    lo, hi = rank_query_range(q_start, q_end, process_count(),
                              process_index())
    log_event('fleet_rank_range', rank=process_index(),
              nproc=process_count(), q_lo=lo, q_hi=hi)
    ctx = (use_search_mesh(local_search_mesh(n_db=n_db))
           if len(local_devices(device)) > 1 else nullcontext())
    with ctx:
        yield from blastp_stream(qry, ref, cfg, indexes=indexes,
                                 q_start=lo, q_end=hi,
                                 spill_dir=spill_dir, device=device)


def barrier(name: str):
    """Cross-rank barrier on the gloo group (no-op single-process).
    ``name`` labels the sync point for the reader; a rank that does not
    arrive within the group's timeout fails the others."""
    if process_count() > 1:
        _dist().barrier(group=_GLOO)


def fleet_search_to_file(qry, ref, cfg, out: str,
                         q_start: int = 0, q_end: int = -1,
                         db_prefix: str = '', append: bool = False,
                         spill_dir: Optional[str] = None,
                         r_start: int = 0, r_end: int = -1,
                         device: Optional[torch.device] = None) -> str:
    """Fleet all-vs-all search into one output file: every rank writes
    its slice to ``out.partNNNNN``, a barrier, then rank 0 concatenates
    the parts in rank order and removes them — the reference's ordered
    write-back of per-range worker outputs (bin/find_hit.py:135-146).

    Returns ``out``.  The merged file is byte-identical to a
    single-process blastp_to_file over the same range.
    """
    pid, nproc = process_index(), process_count()
    from ..search.blastp import IndexSource

    if db_prefix:
        indexes = IndexSource.from_disk(db_prefix)
    elif r_start > 0 or r_end >= 0:
        indexes = IndexSource.from_build(ref, cfg, r_start=r_start,
                                         r_end=r_end, device=device)
    else:
        indexes = None
    from time import time as _now

    from ..utils import log_event
    t0 = _now()
    part = '%s.part%05d' % (out, pid)
    with open(part, 'w') as fh:
        buf = []
        for row in blastp_distributed(qry, ref, cfg, q_start=q_start,
                                      q_end=q_end, indexes=indexes,
                                      spill_dir=spill_dir, device=device):
            buf.append(row)
            if len(buf) >= 10000:
                fh.write(''.join(buf))
                buf = []
        fh.write(''.join(buf))
    t1 = _now()
    barrier('swiftortho_fleet_parts')
    t2 = _now()
    if pid == 0:
        import shutil
        with open(out, 'ab' if append else 'wb') as dst:
            for r in range(nproc):
                p = '%s.part%05d' % (out, r)
                with open(p, 'rb') as src:
                    shutil.copyfileobj(src, dst)
                os.remove(p)
    t3 = _now()
    barrier('swiftortho_fleet_merge')
    # per-rank wall decomposition: search includes this rank's index
    # loads + host pipeline + device waits; barrier_s is straggler skew
    # (time blocked waiting for slower ranks)
    log_event('fleet_rank_phases', rank=pid, nproc=nproc,
              search_s=round(t1 - t0, 3), barrier_s=round(t2 - t1, 3),
              merge_s=round(t3 - t2, 3),
              total_s=round(_now() - t0, 3))
    return out
