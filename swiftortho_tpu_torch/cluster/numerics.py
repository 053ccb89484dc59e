"""Float rules the clustering port holds on every device.

- ``highest_matmul_precision``: the JAX package runs every MCL product at
  ``Precision.HIGHEST`` (``cluster/mcl.py:63``,
  ``mcl_blocksparse.py:78-79``).  Torch may use TF32 for float32 matmuls
  on a card; inside this context it may not.
- ``SegmentSum``: a segment sum whose addition order is fixed, so a run
  on CUDA gives the same bits every time and the same bits as on the
  CPU.  The JAX package sums with ``.at[].add`` (``apc.py:65-66,117-118``,
  ``mcl_blocksparse.py:63,80``), which XLA's CPU backend runs as one
  sequential loop over the updates.  ``index_add_`` on CUDA adds with
  atomics in no fixed order.  Here the updates of one segment are added
  in their input order, one rank at a time: step k adds, to every
  segment, its k-th update; no two updates of a step share a segment.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch


@contextlib.contextmanager
def highest_matmul_precision():
    """float32 matmuls at full precision (TF32 off) inside the block."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def rank_groups(seg: np.ndarray) -> List[np.ndarray]:
    """Positions of ``seg`` split by their rank within their segment:
    group k holds, for every segment with more than k entries, the
    position of its k-th entry in input order."""
    seg = np.asarray(seg)
    if len(seg) == 0:
        return []
    order = np.argsort(seg, kind='stable')
    s = seg[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    run_len = np.diff(np.r_[starts, len(s)])
    rank = np.arange(len(s)) - np.repeat(starts, run_len)
    by_rank = order[np.argsort(rank, kind='stable')]
    return np.split(by_rank, np.cumsum(np.bincount(rank))[:-1])


class SegmentSum:
    """``out[seg[e]] += val[e]`` for every e, in input order per segment.

    Built once per segment layout; ``__call__`` then costs one gather and
    one collision-free ``index_add_`` per rank (the largest segment's
    size)."""

    def __init__(self, seg: np.ndarray, n_seg: int, device: torch.device):
        self.n_seg = n_seg
        self.steps = [(torch.from_numpy(p).to(device),
                       torch.from_numpy(np.asarray(seg)[p]).to(device))
                      for p in rank_groups(seg)]

    def __call__(self, val: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n_seg,) + tuple(val.shape[1:]),
                          dtype=val.dtype, device=val.device)
        for pos, seg in self.steps:
            out.index_add_(0, seg, val.index_select(0, pos))
        return out
