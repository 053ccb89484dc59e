"""Inclusive scans of long 1-D tensors as two-level scans.

torch scans a 1-D tensor as one row, and on CUDA one row runs in one
thread block: a ``cummax`` over 14M int64 values took 20 ms on an H100
(torch.profiler, the device candidate engine's accept rounds).  Here the
tensor is cut into rows of ``ROW`` values, the rows are scanned in
parallel, the row totals are scanned (recursively) and folded back in.
Integer results are exact, so they equal ``torch.cumsum``/``torch.cummax``.
"""

from __future__ import annotations

import torch

ROW = 1024


def _rows(x: torch.Tensor, fill: int) -> torch.Tensor:
    n = x.shape[0]
    pad = -n % ROW
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.view(-1, ROW)


def cumsum_1d(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, 0)`` of a 1-D integer tensor, as int64."""
    x = x.long()
    n = x.shape[0]
    if n <= ROW:
        return torch.cumsum(x, 0)
    m = torch.cumsum(_rows(x, 0), 1)
    tot = m[:, -1].contiguous()
    m[1:] += (cumsum_1d(tot) - tot)[1:, None]
    return m.view(-1)[:n]


def cummax_1d(x: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(x, 0).values`` of a 1-D int64 tensor."""
    n = x.shape[0]
    if n <= ROW:
        return torch.cummax(x, 0).values
    m = torch.cummax(_rows(x, torch.iinfo(x.dtype).min), 1).values
    carry = cummax_1d(m[:, -1].contiguous())
    m[1:] = torch.maximum(m[1:], carry[:-1, None])
    return m.view(-1)[:n]
