"""Reference-compatible flag parsing.

The reference accepts both '-k value' and '-kvalue' forms with a defaults
dict (bin/find_hit.py:227-242 et al.); we reproduce that surface so the
CLIs are drop-in replacements.

Copied from ``swiftortho_tpu/cli/_args.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.  Only
``parse_args``: ``apply_platform_env`` configures JAX and has no
counterpart here (``device.get_device`` reads SWIFTORTHO_PLATFORM).
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
