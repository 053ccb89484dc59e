"""Fleet scaling-efficiency harness.

Measures the rank-split fleet search (``parallel.distributed``) at 1/2/4
processes on one corpus and prints a table of wall time, output rows/s
and scaling efficiency against the 1-rank run (BASELINE.md's aim: >= 80%
at small fleet sizes).

Usage:
    python -m swiftortho_tpu_torch.tools.scaling_bench [--fsa path]
        [--seqs 2000] [--procs 1,2,4]
    SWIFTORTHO_PLATFORM=cpu python -m \\
        swiftortho_tpu_torch.tools.scaling_bench --seqs 60 --procs 1,2

Counterpart of the JAX package's ``tools/scaling_bench.py``, with its
corpus (``make_corpus(n_taxa=10, n_families=seqs//10, seed=7,
min_len=120, max_len=240)``) and ``SearchConfig(expect=1e-5, nc=262144,
query_batch=16)``.  The chunk index is built once (``make_db``) and
shared through disk, so the work each rank repeats is an npz load.  Each
rank is one process with one native thread (``SWNATIVE_THREADS=1``,
``SWIFTORTHO_PRODUCERS=1``) that joins through ``init_distributed`` and
runs ``fleet_search_to_file``; before its clock starts it warms the
device (context, kernel build, one launch), which its ``RANKINIT`` line
counts.

Devices: the ranks run on ``SWIFTORTHO_PLATFORM``'s device (the card
unless ``cpu`` is asked for).  A fleet gets one card a rank
(``CUDA_VISIBLE_DEVICES``) when the machine has at least as many cards as
ranks; otherwise all its ranks share the first card.  Each result says
which (``cards``, ``ranks_per_card``; 0 and null on the CPU).  The
merged ``.sc`` must be byte-equal across fleet sizes.

Writes its corpus and outputs under a new ``tempfile`` directory and the
index beside the fasta (``<fsa>.<chunk>.npz``); prints one table and,
last, one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WORKER = textwrap.dedent("""
    import sys, time
    tproc = time.time()
    pid, nproc, port, fsa, out, dbprefix = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5], sys.argv[6])
    from swiftortho_tpu_torch.config import SearchConfig
    from swiftortho_tpu_torch.device import get_device
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    from swiftortho_tpu_torch.parallel.distributed import (
        fleet_search_to_file, init_distributed)
    from swiftortho_tpu_torch.tools.run_scale import device_warm
    init_distributed('127.0.0.1:%d' % port, nproc, pid)
    device = get_device()
    device_warm(device)
    db = SeqDB.from_path(fsa)
    cfg = SearchConfig(expect=1e-5, nc=262144, query_batch=16)
    import resource
    cu.reset_counters()
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.time()
    fleet_search_to_file(db, db, cfg, out, db_prefix=dbprefix, device=device)
    t1 = time.time()
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    print('RANKTIME %d %f' % (pid, t1 - t0), flush=True)
    print('RANKINIT %d %f' % (pid, t0 - tproc), flush=True)
    print('RANKCPU %d %f %f' % (pid,
          (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime),
          t1 - t0), flush=True)
    print('RANKLAUNCH %d %d %d' % (pid, cu.launches['full'],
          cu.launches['score_only']), flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _md5(path):
    with open(path, 'rb') as fh:
        return hashlib.md5(fh.read()).hexdigest()


def card_ids(device, nproc):
    """Each rank's card (its CUDA_VISIBLE_DEVICES value): card r for rank
    r when there are at least ``nproc`` cards, else the first card for
    all; None on the CPU."""
    if device.type != 'cuda':
        return None
    import torch
    visible = os.environ.get('CUDA_VISIBLE_DEVICES', '').strip()
    ids = ([v.strip() for v in visible.split(',') if v.strip()] if visible
           else [str(i) for i in range(torch.cuda.device_count())])
    return ids[:nproc] if len(ids) >= nproc else ids[:1] * nproc


def run_fleet(nproc, fsa, out, dbprefix, workdir, cards):
    """One fleet of ``nproc`` ranks; returns (its wall: the slowest rank's
    search seconds, each rank's phases)."""
    worker = os.path.join(workdir, 'worker.py')
    with open(worker, 'w') as fh:
        fh.write(WORKER)
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    env['SWNATIVE_THREADS'] = '1'
    env['SWIFTORTHO_PRODUCERS'] = '1'
    port = _free_port()
    procs = []
    try:
        for pid in range(nproc):
            penv = dict(env)
            if cards is not None:
                penv['CUDA_VISIBLE_DEVICES'] = cards[pid]
            procs.append(subprocess.Popen(
                [sys.executable, worker, str(pid), str(nproc), str(port),
                 fsa, out, dbprefix], env=penv, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=3600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    times = {}
    phases = {}
    for p, (sout, serr) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError('fleet rank exited %s: %s'
                               % (p.returncode, serr.decode()[-2000:]))
        for line in sout.decode().splitlines():
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'RANKTIME':
                times[int(parts[1])] = float(parts[2])
            elif parts[0] == 'RANKINIT':
                phases.setdefault(int(parts[1]), {})['init_s'] = \
                    float(parts[2])
            elif parts[0] == 'RANKCPU':
                phases.setdefault(int(parts[1]), {})['cpu_s'] = \
                    float(parts[2])
            elif parts[0] == 'RANKLAUNCH':
                phases.setdefault(int(parts[1]), {})['launches'] = {
                    'full': int(parts[2]), 'score_only': int(parts[3])}
        # per-rank phase decomposition from the structured log
        for line in serr.decode().splitlines():
            if not line.startswith('[swiftortho] {'):
                continue
            rec = json.loads(line[len('[swiftortho] '):])
            if rec.get('stage') == 'fleet_rank_phases':
                d = phases.setdefault(rec['rank'], {})
                for k in ('search_s', 'barrier_s', 'merge_s'):
                    d[k] = rec[k]
    if sorted(times) != list(range(nproc)):
        raise RuntimeError('ranks %s of %d reported no time'
                           % (sorted(times), nproc))
    for pid in sorted(phases):
        d = phases[pid]
        print('    rank %d: init %.2f  search %.2f  barrier %.2f  '
              'merge %.2f  cpu %.2f' % (pid, d.get('init_s', 0),
                                        d.get('search_s', 0),
                                        d.get('barrier_s', 0),
                                        d.get('merge_s', 0),
                                        d.get('cpu_s', 0)), flush=True)
    return max(times.values()), [dict(phases[p], rank=p)
                                 for p in sorted(phases)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--fsa', default='')
    ap.add_argument('--seqs', type=int, default=2000)
    ap.add_argument('--procs', default='1,2,4')
    args = ap.parse_args(argv)

    from ..config import SearchConfig
    from ..device import get_device
    from ..io_fasta import SeqDB
    from ..search.blastp import make_db

    device = get_device()          # raises when cuda is asked for, absent
    workdir = tempfile.mkdtemp(prefix='swortho_scale_')
    fsa = args.fsa
    if not fsa:
        from ..corpus import make_corpus, write_corpus
        fsa = os.path.join(workdir, 'scale.fsa')
        n_fam = max(1, args.seqs // 10)
        write_corpus(fsa, make_corpus(n_taxa=10, n_families=n_fam, seed=7,
                                      min_len=120, max_len=240))
    cfg = SearchConfig(expect=1e-5, nc=262144, query_batch=16)
    make_db(SeqDB.from_path(fsa), cfg, out_prefix=fsa)

    results = []
    base_t = base_md5 = None
    for nproc in [int(x) for x in args.procs.split(',')]:
        out = os.path.join(workdir, 'out_%d.sc' % nproc)
        cards = card_ids(device, nproc)
        t, ranks = run_fleet(nproc, fsa, out, fsa, workdir, cards)
        with open(out, 'rb') as fh:
            nrows = sum(1 for _ in fh)
        digest = _md5(out)
        if base_t is None:
            base_t, base_md5 = t, digest
        if digest != base_md5:
            raise RuntimeError('the %d-rank fleet wrote other bytes than the '
                               'first fleet: md5 %s != %s'
                               % (nproc, digest, base_md5))
        eff = base_t / (t * nproc)
        ncards = len(set(cards)) if cards is not None else 0
        results.append({'procs': nproc, 'seconds': t,
                        'rows_per_s': nrows / t, 'efficiency': eff,
                        'cards': ncards,
                        'ranks_per_card': nproc // ncards if ncards else None,
                        'rows': nrows, 'ranks': ranks})
        print('procs=%d  wall=%.2fs  rows/s=%.1f  efficiency=%.1f%%'
              % (nproc, t, nrows / t, 100 * eff), flush=True)
    print(json.dumps({'metric': 'fleet_scaling', 'fsa': fsa,
                      'device': str(device), 'sc_md5': base_md5,
                      'results': results}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
