"""Pair packing on the device: the banded SW's (B, L) pair arrays built
from device-resident token tables and per-pair integers.

Port of ``swiftortho_tpu/ops/device_pack.py`` (``_pack`` :56-73,
``_packed_align`` :76-114, ``DevicePackContext`` :160-392).  The reference
set lives on the device as one zero-padded row per sequence (uploaded
once per search, or a hot subset under ``SWIFTORTHO_PACK_CAP``), the
wave's padded query rows as a second tensor; a pair crosses PCIe as six
integers (row, suffix offset, suffix length for each side) and its tokens
are gathered on the device.  The output equals the host gather path's
(``search.blastp._align_pairs``): both feed the same kernel.

``DevicePackContext`` subclasses the JAX package's class, whose host
logic is jax-free at import, so the routing (the row stride, the byte
cap, the hot-set pick of ``maybe_select``, ``fits`` and ``row_of``) is
the JAX package's own.  What this module replaces:
- ``_pack``: one direct gather per side, in place of the TPU's barrel
  roll (element gathers are cheap on the card).  Query rows
  (``idx >= n_db``) come from the wave tensor and the rest from the
  resident table: the two are never concatenated, so no table is copied
  per call;
- the aligner: ``ops.banded_sw.sw_align_auto`` on the packed, contiguous
  tensors, i.e. the hand-written CUDA kernel (``csrc/banded_sw.cu``, the
  port of ``banded_sw_pallas.py::sw_align_batch_pallas``) on a card and
  the plain version on the CPU;
- no mesh (``_mesh`` is None), no power-of-two chunk counts and no
  padding of the wave to a fixed capacity (XLA compile-cache shapes).

``SWIFTORTHO_DEVICE_PACK``: ``0`` off, ``force`` on; the default "auto"
means TPU backends in the JAX package, so it is off here.  ``PROF``
counts the route's calls and pairs per kernel variant and the seconds
spent packing and aligning.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from swiftortho_tpu.ops import device_pack as _jax_pack

from ..device import synchronize
from .banded_sw import FIELDS, sw_align_auto

PROF = {'calls': {'full': 0, 'score_only': 0},
        'pairs': {'full': 0, 'score_only': 0},
        'pack_s': 0.0, 'align_s': 0.0}
_prof_lock = threading.Lock()


def reset_prof():
    with _prof_lock:
        for v in ('full', 'score_only'):
            PROF['calls'][v] = 0
            PROF['pairs'][v] = 0
        PROF['pack_s'] = PROF['align_s'] = 0.0


def _pack(db_table: torch.Tensor, wave: torch.Tensor, idx: torch.Tensor,
          off: torch.Tensor, n: torch.Tensor, L: int) -> torch.Tensor:
    """(B,) rows/offsets/lengths -> (B, L) uint8 tokens.

    Row ``idx < n_db`` reads ``db_table[idx]``, row ``idx >= n_db`` reads
    ``wave[idx - n_db]``: out[b, l] = row[off[b] + l] for l < n[b], else
    0.  Callers guarantee 0 <= off and off + n <= the row's width."""
    n_db, w_db = db_table.shape
    n_q, w_q = wave.shape
    lane = torch.arange(L, device=idx.device)
    cols = off[:, None] + lane[None, :]
    from_db = db_table[idx.clamp(0, n_db - 1)[:, None],
                       cols.clamp(0, w_db - 1)]
    from_q = wave[(idx - n_db).clamp(0, n_q - 1)[:, None],
                  cols.clamp(0, w_q - 1)]
    x = torch.where((idx >= n_db)[:, None], from_q, from_db)
    return torch.where(lane[None, :] < n[:, None], x, 0)


class DevicePackContext(_jax_pack.DevicePackContext):
    """Per-search device token tables and the packed align entry on
    ``device``."""

    def __init__(self, db, device: torch.device):
        super().__init__(db)
        self.device = torch.device(device)
        self._waves: list = []       # [(host toks, device rows)]

    @staticmethod
    def _mesh():
        return None

    def _put(self, arr, mesh=None):
        return torch.from_numpy(np.ascontiguousarray(arr).copy()) \
            .to(self.device)

    def wave_table(self, toks: np.ndarray):
        """Upload a wave's padded query rows; returns (device rows,
        width).  Cached by array identity; the last four are kept."""
        for ref, dev in self._waves:
            if ref is toks:
                return dev, toks.shape[1]
        dev = self._put(toks)
        self._waves.append((toks, dev))
        del self._waves[:-4]
        return dev, toks.shape[1]

    def active(self) -> bool:
        return (self.ok
                and os.environ.get('SWIFTORTHO_DEVICE_PACK', '') == 'force')

    def run(self, wave, i0, o0, n0, i1, o1, n1, L0: int, L1: int,
            score_only: bool = False) -> dict:
        """Align B pairs whose tokens are packed on the device.  Returns
        {field: np.ndarray(B) int32} keyed by ``FIELDS``; with
        ``score_only`` the fields after ``bj`` are 0."""
        wave_dev, wave_width = wave
        # the pair arrays cannot be wider than the wider table; results
        # depend only on the lengths, so clamping the width is neutral
        W = max(self.stride, wave_width)
        L0, L1 = min(L0, W), min(L1, W)
        B = len(i0)
        t_a = time.perf_counter()
        vec = torch.from_numpy(np.stack([i0, o0, n0, i1, o1, n1])
                               .astype(np.int64)).to(self.device)
        table = self._table()
        t0 = _pack(table, wave_dev, vec[0], vec[1], vec[2], L0)
        t1 = _pack(table, wave_dev, vec[3], vec[4], vec[5], L1)
        n0_d, n1_d = vec[2].int(), vec[5].int()
        synchronize(self.device)
        t_b = time.perf_counter()
        best = sw_align_auto(t0, t1, n0_d, n1_d, score_only=score_only)
        host = torch.stack([best[k] for k in FIELDS]).cpu().numpy()
        t_c = time.perf_counter()
        variant = 'score_only' if score_only else 'full'
        with _prof_lock:
            PROF['calls'][variant] += 1
            PROF['pairs'][variant] += B
            PROF['pack_s'] += t_b - t_a
            PROF['align_s'] += t_c - t_b
        return dict(zip(FIELDS, host))
