"""ctypes wrapper of the Hopper accept-rounds kernel
(``csrc/accept_rounds.cu``), which replaces the device candidate engine's
accept rounds (``search/candidates_device.py::accept_rounds``, the port of
the plain-JAX ``swiftortho_tpu/search/candidates_device.py::
_accept_rounds``).

``accept_rounds_cuda`` takes CUDA tensors only and launches the kernel on
the current stream of the tensors' card, with that card made current for
the launch, or raises: there is no fallback to the plain version.  It
checks its arguments before it loads the kernels' library, and reads
nothing back to the host: the round count stays on the card as a 0-d
tensor.  ``launches`` counts its launches and ``points`` the points those
launches covered, so a run can show that its path went through the
kernel; the engine calls it from several producer threads, so both are
updated under a lock.
"""

from __future__ import annotations

import threading

import torch

from .._build import load_kernels

launches = 0
points = 0
_count_lock = threading.Lock()


def reset_counters():
    global launches, points
    with _count_lock:
        launches = 0
        points = 0


def check_accept(new_seg, valid_s, p_qst, E):
    """Validate the accept rounds' inputs: 1-D contiguous tensors on one
    device, one length C, bool ``new_seg`` and ``valid_s``, int32 ``p_qst``
    and ``E`` (the JAX reference's width).  Raises ValueError."""
    dev = p_qst.device
    C = p_qst.shape[0] if p_qst.dim() == 1 else -1
    for name, x, want in (('p_qst', p_qst, torch.int32),
                          ('E', E, torch.int32),
                          ('new_seg', new_seg, torch.bool),
                          ('valid_s', valid_s, torch.bool)):
        if x.device != dev:
            raise ValueError('%s is on %s, p_qst on %s'
                             % (name, x.device, dev))
        if x.dtype != want:
            raise ValueError('%s must be %s, got %s' % (name, want, x.dtype))
        if x.dim() != 1:
            raise ValueError('%s must be 1-D, got %s'
                             % (name, tuple(x.shape)))
        if x.shape[0] != C:
            raise ValueError('%s has %d points, p_qst %d'
                             % (name, x.shape[0], C))
        if not x.is_contiguous():
            raise ValueError('%s must be contiguous' % name)


def accept_rounds_cuda(new_seg: torch.Tensor, valid_s: torch.Tensor,
                       p_qst: torch.Tensor, E: torch.Tensor):
    """``accept_rounds`` on the card in one launch: returns (accepted
    bool, qlo_rec int32, rounds), ``rounds`` a 0-d int32 tensor on the
    card.  C = 0 launches nothing."""
    check_accept(new_seg, valid_s, p_qst, E)
    dev = p_qst.device
    if dev.type != 'cuda':
        raise ValueError('accept_rounds_cuda needs CUDA tensors, got %s'
                         % dev)
    C = p_qst.shape[0]
    acc = torch.empty(C, dtype=torch.bool, device=dev)
    qlo_rec = torch.empty(C, dtype=torch.int32, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    if C == 0:
        return acc, qlo_rec, rounds
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swt_accept_rounds(
            new_seg.data_ptr(), valid_s.data_ptr(), p_qst.data_ptr(),
            E.data_ptr(), C, acc.data_ptr(), qlo_rec.data_ptr(),
            rounds.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('accept-rounds kernel launch failed: CUDA error '
                           '%d (%s)' % (rc, lib.swt_cuda_error_string(rc)
                                        .decode(errors='replace')))
    global launches, points
    with _count_lock:
        launches += 1
        points += C
    return acc, qlo_rec, rounds
