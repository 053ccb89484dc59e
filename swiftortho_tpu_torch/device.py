"""Device selection for the port.

Counterpart of ``swiftortho_tpu/cli/_args.py::apply_platform_env``: the
platform comes from ``SWIFTORTHO_PLATFORM`` and nothing else.  ``cuda``
(the default) requires a card and raises without one: a run that asked
for the GPU never continues on the CPU.  ``cpu`` runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import os
import time

import torch

PLATFORMS = ('cuda', 'cpu')


def get_device() -> torch.device:
    """The device named by ``SWIFTORTHO_PLATFORM`` (default ``cuda``)."""
    plat = os.environ.get('SWIFTORTHO_PLATFORM', 'cuda').strip().lower()
    if plat not in PLATFORMS:
        raise ValueError('SWIFTORTHO_PLATFORM=%r: expected one of %s'
                         % (plat, ', '.join(PLATFORMS)))
    if plat == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'SWIFTORTHO_PLATFORM=cuda but torch.cuda.is_available() is '
            'False; set SWIFTORTHO_PLATFORM=cpu to run the plain PyTorch '
            'path on the CPU')
    return torch.device(plat)


def indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names the current card
    (``cuda:N``), so ``cuda`` and ``cuda:0`` key one cache entry on one
    card.  Other devices are returned as they are."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def local_devices(device) -> list:
    """The devices of ``device``'s platform that this process may use:
    every card for ``cuda`` (raises without one), the one CPU for
    ``cpu``.  A fleet rank narrows this to its own cards
    (``parallel.distributed.local_devices``)."""
    kind = torch.device(device).type
    if kind == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA card: torch.cuda.is_available() is '
                               'False')
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def synchronize(device: torch.device):
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class StageClock:
    """Seconds per named stage of device work.  ``mark(name)`` waits for
    the device to finish what was queued so far and charges the time
    since the previous mark to ``name``, so a stage's seconds are its
    device time plus the host time spent between the two marks."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def mark(self, name: str):
        synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now

    def rounded(self, digits: int = 4) -> dict:
        return {k + '_s': round(v, digits) for k, v in self.seconds.items()}
