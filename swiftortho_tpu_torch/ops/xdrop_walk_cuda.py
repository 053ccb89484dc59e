"""ctypes wrapper of the Hopper x-drop walk kernel (``csrc/xdrop_walk.cu``),
which replaces the device candidate engine's chunked torch walks
(``search/candidates_device.py::walk_chunked``, the port of the plain-JAX
``swiftortho_tpu/search/candidates_device.py::_walk_chunked``).

``xdrop_walk_cuda`` takes CUDA tensors only and launches the kernel on the
current stream of the tensors' card, with that card made current for the
launch, or raises: there is no fallback to the plain version.  It checks
its arguments before it loads the kernels' library.  ``launches`` counts
its launches and ``points`` the points those launches walked, so a run
can show that its path went through the kernel; the engine calls it from
several producer threads, so both are updated under a lock.
"""

from __future__ import annotations

import threading

import torch

from .._build import load_kernels
from ..constants import XDROP
from .banded_sw import scoring_tables

launches = 0
points = 0
_count_lock = threading.Lock()

_POINT_ARGS = ('qrow', 's_off', 'start_q', 'start_s', 'base', 'qlo', 'slo',
               'qlen', 'slen')


def reset_counters():
    global launches, points
    with _count_lock:
        launches = 0
        points = 0


def check_walk(qtok_flat, db_tokens, per_point: dict, step: int):
    """Validate a walk: 1-D contiguous tensors on one device, uint8
    tokens, int64 ``s_off``, int32 for the other per-point arrays, one
    length P for all of them, ``step`` +1 or -1.  Raises ValueError."""
    dev = qtok_flat.device
    named = {'qtok_flat': qtok_flat, 'db_tokens': db_tokens, **per_point}
    P = per_point['qrow'].shape[0]
    for name, x in named.items():
        if x.device != dev:
            raise ValueError('%s is on %s, qtok_flat on %s'
                             % (name, x.device, dev))
        want = (torch.uint8 if name in ('qtok_flat', 'db_tokens')
                else torch.int64 if name == 's_off' else torch.int32)
        if x.dtype != want:
            raise ValueError('%s must be %s, got %s' % (name, want, x.dtype))
        if x.dim() != 1:
            raise ValueError('%s must be 1-D, got %s'
                             % (name, tuple(x.shape)))
        if name in per_point and x.shape[0] != P:
            raise ValueError('%s has %d points, qrow %d'
                             % (name, x.shape[0], P))
        if not x.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    if step not in (1, -1):
        raise ValueError('step must be 1 or -1, got %r' % (step,))


def xdrop_walk_cuda(qtok_flat: torch.Tensor, db_tokens: torch.Tensor, L: int,
                    Wmax: int, qrow, s_off, start_q, start_s, step: int,
                    base, qlo, slo, qlen, slen, steps: bool = False):
    """Walk every point on the card; ``walk_chunked``'s arguments but its
    table and chunk width.  Returns (best, best_t) int32, and with
    ``steps`` also the steps each walk read (int32), which measurements
    use; the engine does not ask for them."""
    per_point = dict(zip(_POINT_ARGS, (qrow, s_off, start_q, start_s, base,
                                       qlo, slo, qlen, slen)))
    check_walk(qtok_flat, db_tokens, per_point, step)
    dev = qtok_flat.device
    if dev.type != 'cuda':
        raise ValueError('xdrop_walk_cuda needs CUDA tensors, got %s' % dev)
    P = qrow.shape[0]
    best = torch.empty(P, dtype=torch.int32, device=dev)
    best_t = torch.empty(P, dtype=torch.int32, device=dev)
    n_steps = torch.empty(P, dtype=torch.int32, device=dev) if steps \
        else None
    out = (best, best_t, n_steps) if steps else (best, best_t)
    if P == 0:
        return out
    lib = load_kernels()
    table = scoring_tables(dev)['codes']
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swt_xdrop_walk(
            qtok_flat.data_ptr(), db_tokens.data_ptr(), table.data_ptr(),
            *(x.data_ptr() for x in per_point.values()), P, L, step, Wmax,
            XDROP, best.data_ptr(), best_t.data_ptr(),
            n_steps.data_ptr() if steps else None, stream)
    if rc != 0:
        raise RuntimeError('x-drop walk kernel launch failed: CUDA error %d '
                           '(%s)' % (rc, lib.swt_cuda_error_string(rc)
                                     .decode(errors='replace')))
    global launches, points
    with _count_lock:
        launches += 1
        points += P
    return out
