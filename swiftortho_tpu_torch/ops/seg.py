"""SEG-like low-complexity masking of query batches.

Port of ``swiftortho_tpu/ops/seg.py::seg_batch_vec`` (contract: reference
lib/fsearch.py:2854-2946, quirks in that module's docstring).  Masking is
host work: it calls the threaded C++ port of the sequential oracle
(the port's copy of ``swiftortho_tpu/native/seg.cpp``), bit for bit
``seg_string``.
"""

from __future__ import annotations

import numpy as np

from ..constants import SEG_MIN_ENT, SEG_WINDOW
from ..native import seg_batch_native


def seg_batch_vec(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Mask a padded (B, L) uint8 batch; returns a new (B, L) uint8 batch
    with low-complexity runs set to 'x' and lowercase letters raised."""
    return seg_batch_native(tokens, lengths, SEG_WINDOW, SEG_MIN_ENT)
