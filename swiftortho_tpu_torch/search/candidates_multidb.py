"""P2 reference sharding: chunk indexes as per-device shards on the 'db'
mesh axis, candidate generation fanned out across them.

Port of ``swiftortho_tpu/search/candidates_multidb.py`` (:36-76).  The
reference shards the subject set as disk chunk passes (>4.2 GB DB split
+ per-part hit tables merged by ordered sort, bin/find_hit.py:286-351;
fsearch.py:2727-2805 keeps one part resident).  A DB shard is a chunk
index over a subject subrange, so K shards live device-resident, one per
'db' device in turn, and one query wave's candidate generation runs on
every shard: ``search.candidates_device.generate_candidates_device``
pinned to the shard's device (its copies of the db and of each chunk's
CSR are cached per device, so a shard stays resident).  The cross-shard
merge is the per-wave candidate concatenation in shard (= chunk =
subject) order that the streamed host pipeline already uses, so the
output is byte-identical to the serial chunk sweep.

The device engine keeps its fallback: a shard whose packed-key ranges
do not hold, or whose largest query's postings exceed the cap, runs the
host engine and logs ``device_candidates_fallback``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..io_fasta import SeqDB
from ..ops.index import SeedIndex
from .candidates import Candidates


def shard_devices(n_shards: int, devices: Sequence | None = None,
                  platform: torch.device | None = None) -> list:
    """One device per shard, round-robin over the 'db' axis of the active
    search mesh (this process's entries of its first 'data' row), or over
    this process's devices of ``platform`` (default ``get_device()``)."""
    if devices is None:
        from ..parallel import mesh as _meshmod
        from ..parallel.distributed import local_devices, process_index
        m = _meshmod.active_search_mesh()
        if m is not None and 'db' in m.axis_names:
            row = m.devices.reshape(-1, m.devices.shape[-1])[0]
            procs = m.procs.reshape(-1, m.devices.shape[-1])[0]
            devices = [d for d, p in zip(row, procs)
                       if p == process_index()] or local_devices(platform)
        else:
            devices = local_devices(platform)
    return [devices[i % len(devices)] for i in range(n_shards)]


def generate_candidates_multidb(q_tokens: np.ndarray,
                                q_lengths: np.ndarray,
                                db: SeqDB, indexes: List[SeedIndex],
                                alphabets: list, ssps: str,
                                devices: Sequence | None = None,
                                platform: torch.device | None = None
                                ) -> List[Candidates]:
    """One query wave against K device-resident index shards: per-shard
    candidate lists in shard order, exactly what the chunk-major host
    sweep produces per wave, so ``CandidateSpill.append`` order (and
    therefore every downstream byte) is unchanged.  Each shard runs the
    one device engine pinned to its device."""
    from .candidates_device import generate_candidates_device

    devs = shard_devices(len(indexes), devices, platform)
    return [generate_candidates_device(q_tokens, q_lengths, db, index,
                                       alphabets, ssps, device=dev)
            for index, dev in zip(indexes, devs)]
