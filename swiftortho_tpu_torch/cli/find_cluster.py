"""Graph clustering CLI on PyTorch (drop-in for reference
bin/find_cluster.py).

Usage: python -m swiftortho_tpu_torch.cli.find_cluster -i out.orth
       [-a mcl|apc|sap] [-I 1.5] [-d 0.5] [-b 25000000] > groups.txt

The same flags, defaults (``-a apc``, reference-faithful) and output as
``swiftortho_tpu.cli.find_cluster``.  mcl, textbook apc
(``SWIFTORTHO_APC_FAITHFUL=0``) and sap run on the device named by
``SWIFTORTHO_PLATFORM`` (``cuda`` by default, or ``cpu``); faithful apc
runs on the host.
"""

from __future__ import annotations

import os
import sys

from ..cluster.driver import find_cluster_stream
from ..config import ClusterConfig
from ..device import get_device
from ._args import apply_platform_env, parse_args

DEFAULTS = {'-i': '', '-d': '0.5', '-p': '-10000', '-I': '1.5',
            '-a': 'apc', '-t': '2', '-b': '25000000'}


def main(argv=None):
    apply_platform_env()
    args = parse_args(argv or sys.argv, DEFAULTS)
    if not args['-i']:
        print('Usage: python -m swiftortho_tpu_torch.cli.find_cluster '
              '-i foo.orth [-a mcl|apc|sap] [-I 1.5] [-d 0.5]')
        return 1
    cfg = ClusterConfig(algorithm=args['-a'].lower(),
                        inflation=float(args['-I']),
                        damping=float(args['-d']),
                        component_batch=int(args['-b']),
                        ckpt_dir=os.environ.get('SWIFTORTHO_CKPT_DIR')
                        or None)
    device = get_device()
    with open(args['-i']) as fh:
        for line in find_cluster_stream(fh, cfg, device=device):
            sys.stdout.write(line)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
