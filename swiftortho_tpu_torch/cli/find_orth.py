"""Orthology inference CLI (drop-in for reference bin/find_orth.py).

Usage: python -m swiftortho_tpu_torch.cli.find_orth -i out.sc [-c .5]
       [-y 0] [-n no|bsr|bal] [-s |] [-L y] > out.orth

Orthology inference has no device work: this CLI runs the port's copy
of the JAX package's host code (``orth.inference``, or ``orth.outofcore``
with ``-L y``), with the same flags and output as
``swiftortho_tpu.cli.find_orth``.
"""

from __future__ import annotations

import sys

from ..config import OrthConfig
from ._args import apply_platform_env, parse_args

DEFAULTS = {'-i': '', '-c': '0.5', '-y': '0', '-n': 'no',
            '-t': 'n', '-a': '4', '-T': './tmp/', '-s': '|',
            '-L': 'n'}   # -L y: out-of-core (GNU-sort spill) mode


def main(argv=None):
    apply_platform_env()
    args = parse_args(argv or sys.argv, DEFAULTS)
    if not args['-i']:
        print('Usage: python -m swiftortho_tpu_torch.cli.find_orth -i foo.sc '
              '[-c .5] [-y 0] [-n no|bsr|bal] [-s |]')
        return 1
    cfg = OrthConfig(coverage=float(args['-c']), identity=float(args['-y']),
                     norm=args['-n'], sep=args['-s'])
    if args['-L'].lower().startswith('y'):
        from ..orth.outofcore import find_orth_stream_ooc as stream
    else:
        from ..orth.inference import find_orth_blocks as stream
    with open(args['-i']) as fh:
        for chunk in stream(fh, cfg):
            sys.stdout.write(chunk)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
