"""Reference-compatible flag parsing.

The reference accepts both '-k value' and '-kvalue' forms with a defaults
dict (bin/find_hit.py:227-242 et al.); we reproduce that surface so the
CLIs are drop-in replacements.

Copied from ``swiftortho_tpu/cli/_args.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.  ``parse_args`` is
the original; ``apply_platform_env`` is the port's counterpart of the
JAX one (:31-59): the platform itself is read by ``device.get_device``
and there is no compilation cache to set up, so what is left is joining
a fleet under SWIFTORTHO_COORD (JAX :44-48).
"""

from __future__ import annotations

from typing import Dict, List


def parse_args(argv: List[str], defaults: Dict[str, str]) -> Dict[str, str]:
    args = dict(defaults)
    i = 1
    n = len(argv)
    while i < n:
        k = argv[i]
        if k in args:
            if i + 1 < n:
                args[k] = argv[i + 1]
                i += 2
                continue
            break
        elif k[:2] in args and len(k) > 2:
            args[k[:2]] = k[2:]
        i += 1
    return args


def apply_platform_env():
    """Join a multi-process fleet when SWIFTORTHO_COORD is set
    (parallel/distributed.py); every rank runs the same CLI invocation.
    SWIFTORTHO_PLATFORM is read where the device is chosen
    (``device.get_device``)."""
    import os
    if os.environ.get('SWIFTORTHO_COORD'):
        from ..parallel.distributed import init_distributed
        init_distributed()
