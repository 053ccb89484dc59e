"""The analysis/utility scripts (reference scripts/*.py) for users of the
port: the same commands as ``swiftortho_tpu.cli.scripts``, which are host
code and import no jax.

Run as: python -m swiftortho_tpu_torch.cli.scripts <name> [args...]
names: pan_genome rbh2phy orth2phy get_rbh operon_cluster nr_flt nr2full
       extract_core mcl_cmp merge pan_goterm fsfdp
"""

from __future__ import annotations

import sys

from swiftortho_tpu.cli.scripts import COMMANDS


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 1
    try:
        return COMMANDS[argv[0]](argv[1:])
    except BrokenPipeError:      # e.g. piped into head
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == '__main__':
    raise SystemExit(main())
