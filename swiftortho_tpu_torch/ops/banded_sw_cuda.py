"""ctypes wrapper of the Hopper banded Smith-Waterman kernel
(``csrc/banded_sw.cu``), the port of
``swiftortho_tpu/ops/banded_sw_pallas.py::sw_align_batch_pallas``.

``sw_align_batch_cuda`` takes CUDA tensors only and launches the kernel
on the current stream of the tensors' card, with that card made current
for the launch (a mesh shard may live on another card than the current
one), or raises: there is no fallback to the plain version.  ``launches`` counts the launches per variant (``full``,
``score_only``) so a run can show that its path went through the kernel;
``pairs`` counts the pairs those launches aligned, and ``shapes`` the
launch shapes: per variant, ``'<pad0>x<pad1>'`` -> [launches, pairs,
largest B].
"""

from __future__ import annotations

import threading

import torch

from .._build import load_kernels
from ..constants import GAP_EXTEND, GAP_OPEN
from .banded_sw import FIELDS, check_batch, scoring_tables

launches = {'full': 0, 'score_only': 0}
pairs = {'full': 0, 'score_only': 0}
shapes: dict = {'full': {}, 'score_only': {}}
_count_lock = threading.Lock()


def reset_counters():
    with _count_lock:
        for k in launches:
            launches[k] = 0
            pairs[k] = 0
            shapes[k].clear()


def sw_align_batch_cuda(tok0: torch.Tensor, tok1: torch.Tensor,
                        len0: torch.Tensor, len1: torch.Tensor,
                        score_only: bool = False) -> torch.Tensor:
    """Align B pairs on the card.  Same inputs as
    ``banded_sw.sw_align_batch``, which must be contiguous CUDA tensors;
    returns a (9, B) int32 tensor whose rows follow ``FIELDS``.  With
    ``score_only`` the rows after ``bj`` are 0."""
    check_batch(tok0, tok1, len0, len1)
    dev = tok0.device
    if dev.type != 'cuda':
        raise ValueError('sw_align_batch_cuda needs CUDA tensors, got %s'
                         % dev)
    for name, x in (('tok0', tok0), ('tok1', tok1), ('len0', len0),
                    ('len1', len1)):
        if not x.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    B, L0 = tok0.shape
    L1 = tok1.shape[1]
    out = torch.empty((len(FIELDS), B), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = load_kernels()
    table = scoring_tables(dev)['codes']
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swt_banded_sw(tok0.data_ptr(), tok1.data_ptr(),
                               len0.data_ptr(), len1.data_ptr(), B, L0, L1,
                               table.data_ptr(), GAP_OPEN, GAP_EXTEND,
                               int(bool(score_only)), out.data_ptr(),
                               stream)
    if rc != 0:
        raise RuntimeError('banded SW kernel launch failed: CUDA error %d '
                           '(%s)' % (rc, lib.swt_cuda_error_string(rc)
                                     .decode(errors='replace')))
    variant = 'score_only' if score_only else 'full'
    with _count_lock:
        launches[variant] += 1
        pairs[variant] += B
        row = shapes[variant].setdefault('%dx%d' % (L0, L1), [0, 0, 0])
        row[0] += 1
        row[1] += B
        row[2] = max(row[2], B)
    return out
