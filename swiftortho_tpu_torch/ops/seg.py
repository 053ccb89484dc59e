"""SEG-like low-complexity masking of query batches.

Contract: reference lib/fsearch.py:2854-2946, quirks in the docstring of
``swiftortho_tpu/ops/seg.py``.

- ``seg_batch_vec`` (port of ``swiftortho_tpu/ops/seg.py::seg_batch_vec``)
  is the search's masking.  It is host work: the threaded C++ port of the
  sequential oracle (the port's copy of ``swiftortho_tpu/native/seg.cpp``),
  bit for bit ``seg_string``.
- ``seg_batch`` (port of the JAX ``seg_batch``, :139-183) is the batched
  tensor version that the mesh step (``parallel.mesh``) runs on each
  device: 64 bins, windows of 12, a float32 entropy per window recomputed
  from counts, then the 12-residue countdown.  The JAX package names its
  deviation from the oracle (a knife-edge window can round differently
  across 2.2); it holds here too.

Each entropy term ``-f * log2(f)`` is read from a float32 table keyed by
the count (counts are integers, 0..24 in a window), built once on the CPU,
and the terms are added in bin order as the JAX version adds them.  So the
mask does not depend on the device's log2: a card writes the CPU's bytes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import SEG_MIN_ENT, SEG_WINDOW
from ..native import seg_batch_native

_X = ord('x')
_NBINS = 64


def seg_batch_vec(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Mask a padded (B, L) uint8 batch; returns a new (B, L) uint8 batch
    with low-complexity runs set to 'x' and lowercase letters raised."""
    return seg_batch_native(tokens, lengths, SEG_WINDOW, SEG_MIN_ENT)


def _gent(c: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Entropy contribution -f*log2(f) with f = c/denom, in float32 (the
    JAX ``_gent``)."""
    f = c.to(torch.float32) / denom
    return torch.where(c > 0, -f * torch.log2(torch.clamp(f, min=1e-30)),
                       torch.zeros((), dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(window terms by count 0..2w, whole-sequence terms by (n, count)
    for n < w) on ``device``, computed on the CPU."""
    w = SEG_WINDOW
    c = torch.arange(2 * w + 1)
    win = _gent(c, torch.tensor(float(w)))
    n = torch.arange(w)[:, None]
    whole = _gent(c[None, :].expand(w, -1),
                  torch.clamp(n.to(torch.float32), min=1.0))
    whole = torch.where(c[None, :] <= 2 * n, whole, 0.0)
    return win.to(device), whole.to(device)


def _tok_bins(tok_u: torch.Tensor) -> torch.Tensor:
    """A..Z -> 1..26, any other byte -> 27 + b % 37 (the JAX ``_tok_bins``)."""
    t = tok_u.to(torch.int64)
    return torch.where((t >= 65) & (t <= 90), t - 64, 27 + t % 37)


def seg_batch(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Vectorized seg over a padded (B, L) uint8 batch on its device;
    returns masked, uppercased tokens (the reference's first output).  The
    padding tail is left untouched."""
    B, L = tokens.shape
    dev = tokens.device
    w = SEG_WINDOW
    win_t, whole_t = _tables(dev)
    tok_u = torch.where((tokens >= 97) & (tokens <= 122), tokens - 32,
                        tokens)
    n = lengths.to(torch.int64)
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < n[:, None]
    bins = torch.where(valid, _tok_bins(tok_u), _NBINS - 1)

    ent = torch.zeros((B, L), dtype=torch.float32, device=dev)
    ent_whole = torch.zeros(B, dtype=torch.float32, device=dev)
    n_short = n.clamp(max=w - 1)                 # whole-table row (n < w)
    nwin = L - w + 1
    for b in range(_NBINS):
        oh = ((bins == b) & valid).to(torch.int64)
        cs0 = torch.nn.functional.pad(torch.cumsum(oh, 1), (1, 0))
        if nwin > 0:
            ci = cs0[:, w:] - cs0[:, :-w]        # count in window i
            c0 = cs0[:, w][:, None]              # first-window count
            ent[:, :nwin] += win_t[c0 + ci]
        c2 = (2 * cs0[:, -1]).clamp(max=2 * w)
        ent_whole += whole_t[n_short, c2]        # doubled counts

    if nwin > 0:
        mask = ((ent < SEG_MIN_ENT) & (pos <= (n - w)[:, None])
                & (n[:, None] >= w))
    else:
        mask = torch.zeros((B, L), dtype=torch.bool, device=dev)
    mask |= (n < w)[:, None] & (ent_whole < SEG_MIN_ENT)[:, None] & valid
    nws = (n - w).clamp(min=0)
    tail_bit = mask.gather(1, nws[:, None].clamp(max=L - 1))
    mask |= tail_bit & (pos >= nws[:, None]) & (n[:, None] >= w) & valid

    # the 12-residue countdown: a masked start emits w 'x' and skips
    cd = torch.zeros(B, dtype=torch.int64, device=dev)
    x_cols = []
    for p in range(L):
        m = mask[:, p]
        x_cols.append((cd > 0) | m)
        cd = torch.where(cd > 0, cd - 1, torch.where(m, w - 1, 0))
    x_out = torch.stack(x_cols, 1) & valid if L else mask
    return torch.where(x_out, torch.tensor(_X, dtype=torch.uint8, device=dev),
                       tok_u)
