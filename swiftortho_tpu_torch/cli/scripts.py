"""CLI wrappers for the analysis/utility scripts (reference scripts/*.py).

Run as: python -m swiftortho_tpu_torch.cli.scripts <name> [args...]
names: pan_genome rbh2phy orth2phy get_rbh operon_cluster nr_flt nr2full
       extract_core mcl_cmp merge pan_goterm fsfdp
"""

# Copied from ``swiftortho_tpu/cli/scripts.py``, with its own COMMANDS
# table over the port's copies of ``analysis/`` and ``cluster/fsfdp.py``;
# ``apply_platform_env`` is the port's (``cli/_args.py``).

from __future__ import annotations

import sys

from ..io_fasta import SeqDB, iter_fasta
from ._args import apply_platform_env, parse_args


def cmd_pan_genome(argv):
    from ..analysis.pan_genome import pan_report
    args = parse_args(['x'] + argv, {'-i': '', '-g': '', '-l': '.05',
                                     '-u': '.95', '-r': ''})
    if not args['-i'] or not args['-g']:
        print('usage: pan_genome -i foo.fsa -g foo.clsr [-l .05] [-u .95] '
              '[-r taxon_file]')
        return 1
    db = SeqDB.from_path(args['-i'])
    allow = None
    if args['-r']:
        allow = {l.strip() for l in open(args['-r'])}
    with open(args['-g']) as fh:
        # drop-in side effects of the reference script: <g>_xy.txt (the
        # rarefaction medians, pan_genome.py:384-389) plus plot_pan.rs
        # (kept, not executed — no Rscript in this env, :630-637)
        pan_report(db, fh, sys.stdout, ts=float(args['-l']),
                   tc=float(args['-u']), tax_allow=allow,
                   plot_prefix=args['-g'])
    return 0


def cmd_rbh2phy(argv):
    from ..analysis.rbh import rbh2phy
    args = parse_args(['x'] + argv, {'-i': '', '-f': '', '-r': ''})
    if not args['-i'] or not args['-f']:
        print('usage: rbh2phy -f foo.fsa -i foo.sc [-r taxon]')
        return 1
    db = SeqDB.from_path(args['-f'])
    with open(args['-i']) as fh:
        for tax, seq in rbh2phy(fh, db, ref_taxon=args['-r']):
            sys.stdout.write('>%s\n%s\n' % (tax, seq))
    return 0


def cmd_orth2phy(argv):
    from ..analysis.orth2phy import orth2phy
    args = parse_args(['x'] + argv, {'-i': '', '-g': '', '-r': ''})
    if not args['-i'] or not args['-g']:
        print('usage: orth2phy -i foo.fsa -g foo.orth [-r taxon]')
        return 1
    db = SeqDB.from_path(args['-i'])
    with open(args['-g']) as fh:
        for tax, seq in orth2phy(fh, db, ref_taxon=args['-r']):
            sys.stdout.write('>%s\n%s\n' % (tax, seq))
    return 0


def cmd_get_rbh(argv):
    from ..analysis.rbh import get_rbh_pairs
    if not argv:
        print('usage: get_rbh foo.sc')
        return 1
    with open(argv[0]) as fh:
        for line in get_rbh_pairs(fh):
            sys.stdout.write(line)
    return 0


def cmd_operon_cluster(argv):
    from ..analysis.operon import gene_fam_idx, operon_cluster_edges
    args = parse_args(['x'] + argv, {'-g': '', '-p': ''})
    if not args['-g'] or not args['-p']:
        print('usage: operon_cluster -g foo.clsr -p foo.operon')
        return 1
    with open(args['-g']) as fh:
        groups = gene_fam_idx(fh)
    with open(args['-p']) as fh:
        for line in operon_cluster_edges(fh, groups):
            sys.stdout.write(line)
    return 0


def cmd_nr_flt(argv):
    from ..analysis.misc import nr_collapse
    fh = open(argv[0]) if argv else sys.stdin
    for rid, seq in nr_collapse(iter_fasta(fh)):
        sys.stdout.write('>%s\n%s\n' % (rid, seq))
    return 0


def cmd_nr2full(argv):
    from ..analysis.misc import nr_expand
    if not argv:
        print('usage: nr2full foo.sc')
        return 1
    with open(argv[0]) as fh:
        for line in nr_expand(fh):
            sys.stdout.write(line)
    return 0


def cmd_extract_core(argv):
    from ..analysis.misc import extract_core
    if len(argv) < 3:
        print('usage: extract_core foo.pan foo.clsr input.fsa')
        return 1
    with open(argv[0]) as p, open(argv[1]) as c, open(argv[2]) as f:
        for head, seq in extract_core(p, c, iter_fasta(f)):
            sys.stdout.write('>%s\n%s\n' % (head, seq))
    return 0


def cmd_mcl_cmp(argv):
    from ..analysis.misc import cluster_compare
    if len(argv) < 2:
        print('usage: mcl_cmp qry.groups ref.groups')
        return 1
    with open(argv[0]) as q, open(argv[1]) as r:
        pq, pr = cluster_compare(q, r)
    print('qry %f%% %s' % (pq, argv[0]))
    print('ref %f%% %s' % (pr, argv[1]))
    return 0


def cmd_merge(argv):
    from ..analysis.misc import merge_fastas
    if not argv:
        print('usage: merge dir_name > merged.fsa')
        return 1
    for line in merge_fastas(argv[0]):
        sys.stdout.write(line)
    return 0


def _ensure_obo(path):
    """Reference auto-fetch (scripts/pan_goterm.py:62-66): when go.obo
    is absent the reference runs ``wget -c http://current.geneontology
    .org/ontology/go.obo``.  Same behavior here via urllib, preserving
    the flag surface; zero-egress environments get a clear actionable
    failure instead of a FileNotFoundError."""
    import os
    if os.path.isfile(path):
        return True
    url = 'http://current.geneontology.org/ontology/go.obo'
    print('pan_goterm: %s not found; fetching %s' % (path, url),
          file=sys.stderr)
    try:
        import urllib.request
        with urllib.request.urlopen(url, timeout=30) as r, \
                open(path, 'wb') as out:
            while True:
                blk = r.read(1 << 20)
                if not blk:
                    break
                out.write(blk)
        return True
    except Exception as exc:
        print('pan_goterm: download failed (%s); this environment may '
              'have no network egress — pass a local obo file with '
              '-o path/to/go.obo' % exc, file=sys.stderr)
        try:
            os.remove(path)                      # no partial files
        except OSError:
            pass
        return False


def cmd_pan_goterm(argv):
    from ..analysis.goterm import (GoDag, goterm_profile, pan_type_map)
    args = parse_args(['x'] + argv, {'-i': '', '-t': '', '-o': 'go.obo',
                                     '-p': '', '-c': ''})
    if not args['-i'] or not (args['-t'] or (args['-p'] and args['-c'])):
        print('usage: pan_goterm -i annot.txt (-t type.txt | -p foo.pan '
              '-c foo.clsr) [-o go.obo]')
        return 1
    if not _ensure_obo(args['-o']):
        return 1
    with open(args['-o']) as fh:
        dag = GoDag(fh)
    if args['-t']:
        type_of = {}
        for line in open(args['-t']):
            f = line.rstrip('\n').split('\t')
            for g in f[2:]:
                type_of[g] = f[1]
    else:
        with open(args['-p']) as p, open(args['-c']) as c:
            type_of = pan_type_map(p, c)
    with open(args['-i']) as fh:
        for line in goterm_profile(fh, type_of, dag):
            sys.stdout.write(line)
    return 0


def cmd_fsfdp(argv):
    # default prints one tab-joined group per line (our addition: the
    # reference exits before its group code, scripts/fsfdp.py:263);
    # --report emits the reference script's stdout byte-for-byte
    # (diagnostics + per-node halo/core lines, quirks included).
    from ..cluster.fsfdp import fsfdp_groups, fsfdp_report
    if not argv:
        print('usage: fsfdp foo.xyz [--report]')
        return 1
    emit = fsfdp_report if '--report' in argv[1:] else fsfdp_groups
    with open(argv[0]) as fh:
        for line in emit(fh):
            sys.stdout.write(line)
    return 0


COMMANDS = {name[4:]: fn for name, fn in list(globals().items())
            if name.startswith('cmd_')}


def main(argv=None):
    apply_platform_env()
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 1
    try:
        return COMMANDS[argv[0]](argv[1:])
    except BrokenPipeError:      # e.g. piped into head
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == '__main__':
    raise SystemExit(main())
