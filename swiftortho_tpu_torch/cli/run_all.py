"""Full pipeline CLI on PyTorch (drop-in for reference scripts/run_all.py).

search -> orthology -> clustering -> pan-genome -> RBH species tree
[-> operon clustering], all in-process.  The same flags and outputs as
``swiftortho_tpu.cli.run_all``: stage 1 is the port's search
(``search.blastp.blastp_to_file``), stage 3 the port's clustering driver,
both on the device named by ``SWIFTORTHO_PLATFORM`` (``cuda`` by default,
or ``cpu``); stages 2 and 4-6 are the port's copies of the JAX
package's host code (``orth/``, ``analysis/``).

Fleet (SWIFTORTHO_COORD, as ``cli.find_hit``): the search is rank-split
(``parallel.distributed.fleet_search_to_file``) and the later stages run
on rank 0 only; every other rank returns after the search (the JAX
``run_all``'s fleet branches, :63-126).

Usage: python -m swiftortho_tpu_torch.cli.run_all -i merged.fsa [-p operons] ...
Outputs in <input>_results/: .sc .opc .clsr .pan .aln.trim .nwk
"""

from __future__ import annotations

import os
import sys
from time import time

from ..analysis.exttools import (tree_from_file,
                                 trim_alignment_file)
from ..analysis.misc import nr_collapse, nr_expand
from ..analysis.msa import trim_alignment
from ..analysis.operon import gene_fam_idx, operon_cluster_edges
from ..analysis.pan_genome import pan_report
from ..analysis.phylo import tree_from_alignment
from ..analysis.rbh import rbh2phy
from ..cluster.driver import find_cluster_stream
from ..config import ClusterConfig, OrthConfig, SearchConfig
from ..device import get_device
from ..io_fasta import SeqDB, iter_fasta, write_fasta
from ..ops.index import save_index
from ..orth.inference import find_orth_blocks
from ..parallel.distributed import (barrier, fleet_search_to_file,
                                    process_count, process_index,
                                    search_mesh_context)
from ..search.blastp import IndexSource, blastp_to_file
from ..utils import fresh, log_event, stage
from ._args import apply_platform_env, parse_args

DEFAULTS = {'-i': '', '-r': '', '-p': '', '-s': '1111111', '-c': '.5',
            '-y': '50', '-n': 'no', '-l': '.05', '-u': '.95', '-a': '1',
            '-A': 'apc', '-I': '1.5', '-v': '1000', '-M': '120000000',
            '-z': '',   # -z fast = run_all_fast nr-dedup variant
            '-R': 'n'}  # -R y = resume: skip stages with fresh outputs


def main(argv=None):
    apply_platform_env()
    args = parse_args(argv or sys.argv, DEFAULTS)
    if not args['-i']:
        print('Usage: python -m swiftortho_tpu_torch.cli.run_all -i '
              'foo.pep.fsa [-r taxon] [-p foo.operon] [-s seed] [-c cov] '
              '[-y idy] [-n norm] [-l spec-thr] [-u core-thr] [-A mcl|apc] '
              '[-I infl] [-v hits]')
        return 1
    device = get_device()
    pid, fleet = process_index(), process_count() > 1
    fas = args['-i']
    sfx = fas.split(os.sep)[-1]
    res = '%s_results' % fas
    os.makedirs(res, exist_ok=True)

    resume = args['-R'].lower().startswith('y')

    # 1. all-vs-all search (reference: -e 1e-5 -m 5e-2, run_all.py:104)
    t0 = time()
    sc_path = '%s/%s.sc' % (res, sfx)
    scfg = SearchConfig(expect=1e-5, v=int(args['-v']), max_miss=5e-2,
                        seeds=args['-s'], nc=int(args['-M']))
    if resume and fresh(sc_path, fas):
        log_event('search', skipped=True)
    elif args.get('-z') == 'fast':
        # run_all_fast variant (scripts/run_all_fast.py): collapse exact
        # duplicates, search the nr set, re-expand the hit table.  In a
        # fleet, only rank 0 writes the shared nr fasta and the expanded
        # table (concurrent same-path writes would corrupt them); the nr
        # search itself is rank-split like the plain branch.
        nr_path = '%s/%s.nr.fsa' % (res, sfx)
        if not fleet or pid == 0:
            with open(fas) as fh:
                write_fasta(nr_path, list(nr_collapse(iter_fasta(fh))))
        nr_sc = '%s/%s.nr.sc' % (res, sfx)
        if fleet:
            barrier('swiftortho_runall_nr')
            db = SeqDB.from_path(nr_path)
            fleet_search_to_file(db, db, scfg, nr_sc, device=device)
        else:
            blastp_to_file(nr_path, nr_path, nr_sc, scfg, device=device)
        if not fleet or pid == 0:
            with open(nr_sc) as fh, open(sc_path, 'w') as out:
                for line in nr_expand(fh):
                    out.write(line)
    elif fleet:
        # fleet: rank-split query ranges + rank-0 ordered merge; rank 0
        # builds the chunk indexes ONCE (one chunk resident, persisted
        # like `-p makedb`) so the N ranks stream a shared prebuilt db
        # instead of each rebuilding every chunk — the reference's
        # formatdb-then-fan-out (find_hit.py:282-283)
        db = SeqDB.from_path(fas)
        db_prefix = '%s/%s.fleetdb' % (res, sfx)
        if pid == 0:
            # drop stale chunk files first: IndexSource.from_disk globs
            # 'prefix.*.npz', so leftovers from a previous run with more
            # chunks would be loaded alongside the fresh ones
            import glob as _glob
            for stale in _glob.glob('%s.*.npz' % db_prefix):
                os.remove(stale)
            for ci, ix in enumerate(IndexSource.from_build(db, scfg)):
                save_index('%s.%d.npz' % (db_prefix, ci), ix)
        barrier('swiftortho_runall_db')
        fleet_search_to_file(db, db, scfg, sc_path, db_prefix=db_prefix,
                             device=device)
    else:
        with search_mesh_context():
            blastp_to_file(fas, fas, sc_path, scfg, device=device)
    if fleet and pid != 0:
        log_event('fleet_rank_done', rank=pid)
        return 0
    log_event('search', seconds=round(time() - t0, 3))
    print('all to all homologous searching time:', time() - t0)

    # 2. orthology inference
    t0 = time()
    opc_path = '%s/%s.opc' % (res, sfx)
    ocfg = OrthConfig(coverage=float(args['-c']), identity=float(args['-y']),
                      norm=args['-n'])
    if resume and fresh(opc_path, sc_path):
        log_event('orth', skipped=True)
    else:
        with stage('orth'):
            with open(sc_path) as fh, open(opc_path, 'w') as out:
                for block in find_orth_blocks(fh, ocfg):
                    out.write(block)
    print('orthomcl algorithm time:', time() - t0)

    # 3. clustering
    t0 = time()
    clsr_path = '%s/%s.clsr' % (res, sfx)
    # MCL runs checkpoint finished component batches + iteration state
    # here; a rerun (with or without -R y) skips completed work
    ccfg = ClusterConfig(algorithm=args['-A'].lower(),
                         inflation=float(args['-I']),
                         ckpt_dir='%s/%s.clsr.ckpt' % (res, sfx))
    if resume and fresh(clsr_path, opc_path):
        log_event('cluster', skipped=True)
    else:
        with stage('cluster', algorithm=ccfg.algorithm):
            with open(opc_path) as fh, open(clsr_path, 'w') as out:
                for line in find_cluster_stream(fh, ccfg, device=device):
                    out.write(line)
    print('use %s to group protein family time:' % args['-A'], time() - t0)

    # 4. pan-genome statistics
    t0 = time()
    db = SeqDB.from_path(fas)
    pan_path = '%s/%s.pan' % (res, sfx)
    with open(clsr_path) as fh, open(pan_path, 'w') as out:
        pan_report(db, fh, out, ts=float(args['-l']), tc=float(args['-u']))
    print('pan-genome analysis time:', time() - t0)

    # 5. RBH species tree: MSA (external famsa/mafft/muscle via rbh2phy
    # when on PATH) -> trim (trimal -automated1 | built-in gap-fraction
    # trim) -> tree (fasttree, reference flag set | built-in NJ).
    # Reference: scripts/run_all.py:207-221.
    t0 = time()
    with open(sc_path) as fh:
        recs = rbh2phy(fh, db, ref_taxon=args['-r'])
    raw_path = '%s/%s.aln' % (res, sfx)
    aln_path = '%s/%s.aln.trim' % (res, sfx)
    nwk_path = '%s/%s.nwk' % (res, sfx)
    if recs:
        names = [t for t, _ in recs]
        with open(raw_path, 'w') as out:
            for t_, s_ in zip(names, (s for _, s in recs)):
                out.write('>%s\n%s\n' % (t_, s_))
        if trim_alignment_file(raw_path, aln_path):
            with open(aln_path) as fh:
                trimmed = {h.split()[0]: s for h, s in iter_fasta(fh)}
            rows = [trimmed[t_] for t_ in names]
        else:
            rows = trim_alignment([s for _, s in recs])
            with open(aln_path, 'w') as out:
                for t_, s_ in zip(names, rows):
                    out.write('>%s\n%s\n' % (t_, s_))
        nwk = tree_from_file(aln_path)
        if nwk is None:
            nwk = tree_from_alignment(names, rows)
        with open(nwk_path, 'w') as out:
            out.write(nwk + '\n')
    print('species tree construction time:', time() - t0)

    # 6. operon clustering (optional)
    if args['-p'] and os.path.isfile(args['-p']):
        t0 = time()
        sfxo = args['-p'].split(os.sep)[-1]
        with open(clsr_path) as fh:
            groups = gene_fam_idx(fh)
        xyz_path = '%s/%s.xyz' % (res, sfxo)
        with open(args['-p']) as fh, open(xyz_path, 'w') as out:
            for line in operon_cluster_edges(fh, groups):
                out.write(line)
        with open(xyz_path) as fh, open('%s/%s.clsr' % (res, sfxo),
                                        'w') as out:
            for line in find_cluster_stream(fh, ccfg, device=device):
                out.write(line)
        print('operon clustering time:', time() - t0)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
