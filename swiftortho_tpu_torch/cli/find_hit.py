"""All-vs-all search CLI on PyTorch (drop-in for reference bin/find_hit.py).

Usage: python -m swiftortho_tpu_torch.cli.find_hit -p blastp -i qry.fsa
       -d ref.fsa -o out.sc [-e 1e-3] [-v 500] [-s 11111111] [-r aa9] ...

The same flags and output as ``swiftortho_tpu.cli.find_hit``.  The
device comes from ``SWIFTORTHO_PLATFORM`` (``cuda`` by default, ``cpu``
for the plain PyTorch path).

Fleet: with SWIFTORTHO_COORD (host:port), SWIFTORTHO_NPROCS and
SWIFTORTHO_PROC_ID set, every rank runs this same command; each searches
its contiguous 1/N query slice on its own device(s) and rank 0 merges the
parts into ``-o`` in rank order (``parallel.distributed``), the JAX
``find_hit``'s fleet branch (:67-86).  SWIFTORTHO_MESH=1 shards the
alignment batches over this process's devices when it has more than one
card (``parallel.distributed.search_mesh_context``).
"""

from __future__ import annotations

import sys

from ..config import SearchConfig
from ..device import get_device
from ..search.blastp import blastp_to_file
from ._args import apply_platform_env, parse_args

DEFAULTS = {
    '-p': 'blastp', '-v': '500', '-s': '11111111', '-i': '', '-d': '',
    '-e': '1e-3', '-l': '-1', '-u': '-1', '-m': '1e-3', '-t': '-1',
    '-r': 'aa9', '-j': '1', '-F': 'T', '-o': '', '-D': '', '-O': 'wb',
    '-L': '-1', '-U': '-1', '-M': '120000000', '-c': '50000', '-a': '1',
    '-T': '',
}


def manual_print():
    print('Usage:')
    print('  python -m swiftortho_tpu_torch.cli.find_hit -p blastp '
          '-i qry.fsa -d db.fsa -o out.sc')
    print('Parameters (reference-compatible):')
    print('  -i query fasta   -d reference fasta   -o output .sc file')
    print('  -e expect value  -v max hits/query    -s spaced seed(s)')
    print('  -r alphabet: aa9 | aa20 | custom comma groups')
    print('  -m max miss ratio  -t kmer count threshold  -j seed stride')
    print('  -F T|F filter query  -M hash buckets  -c ref chunk size')
    print('  -p makedb -i ref.fsa : persist chunk indexes (ref.fsa.N.npz)')
    print('  -D prefix : search against indexes persisted by makedb')
    print('  -l/-u query index range; -L/-U reference index range')
    print('  -O a : append to the output file (restartable sharded runs)')
    print('Device: SWIFTORTHO_PLATFORM=cuda (default) | cpu')
    print('Fleet: SWIFTORTHO_COORD=host:port SWIFTORTHO_NPROCS=N '
          'SWIFTORTHO_PROC_ID=i on every rank (needs -o); SWIFTORTHO_MESH=1 '
          'shards over local cards')


def main(argv=None):
    apply_platform_env()
    args = parse_args(argv or sys.argv, DEFAULTS)
    if args['-p'] == 'makedb':
        if not args['-i']:
            manual_print()
            return 1
        from ..io_fasta import SeqDB
        from ..ops.index import save_index

        from ..search.blastp import IndexSource
        cfg = SearchConfig(seeds=args['-s'], alphabet=args['-r'],
                           step=int(args['-j']), nc=int(args['-M']),
                           chunk=int(args['-c']))
        src = IndexSource.from_build(SeqDB.from_path(args['-i']), cfg)
        for ci, ix in enumerate(src):          # one chunk resident at a time
            save_index('%s.%d.npz' % (args['-i'], ci), ix)
        return 0
    if args['-p'] != 'blastp' or not args['-i'] or not args['-d']:
        manual_print()
        return 1
    cfg = SearchConfig(
        expect=float(args['-e']), v=int(args['-v']),
        max_miss=max(float(args['-m']), 1e-3),
        seeds=args['-s'], alphabet=args['-r'], step=int(args['-j']),
        filter_query=args['-F'].upper() == 'T',
        threshold=int(args['-t']), nc=int(args['-M']),
        chunk=int(args['-c']))
    out = args['-o']
    from ..parallel.distributed import process_count
    if process_count() > 1:
        # fleet (SWIFTORTHO_COORD): each rank searches its contiguous
        # 1/N query slice over its own devices, rank 0 merges the parts
        # in rank order — the reference's -l/-u worker fan-out + ordered
        # write-back (bin/find_hit.py:107-151)
        if not out:
            print('fleet mode requires -o <file> (rank parts are merged '
                  'on disk)')
            return 1
        from ..io_fasta import SeqDB
        from ..parallel.distributed import fleet_search_to_file
        fleet_search_to_file(
            SeqDB.from_path(args['-i']), SeqDB.from_path(args['-d']),
            cfg, out, q_start=int(args['-l']), q_end=int(args['-u']),
            db_prefix=args['-D'], append=args['-O'].startswith('a'),
            spill_dir=args['-T'] or None,
            r_start=int(args['-L']), r_end=int(args['-U']),
            device=get_device())
        return 0
    # local multi-device (SWIFTORTHO_MESH=1) runs shard the device
    # batches over the local mesh
    from ..parallel.distributed import search_mesh_context
    device = get_device()
    with search_mesh_context():
        blastp_to_file(args['-i'], args['-d'], out or sys.stdout, cfg,
                       db_prefix=args['-D'],
                       q_start=int(args['-l']), q_end=int(args['-u']),
                       r_start=int(args['-L']), r_end=int(args['-U']),
                       append=args['-O'].startswith('a'),
                       spill_dir=args['-T'] or None, device=device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
