"""End-to-end scale run of the port: synthesize an N-proteome corpus, run
the search -> orthology -> MCL pipeline on one device, and report stage
seconds, pairs/s, output counts and peak memory.

Usage:
    python -m swiftortho_tpu_torch.tools.run_scale --taxa 25 \\
        --families 4000 --max-len 400 --workdir scale_102k
    SWIFTORTHO_PLATFORM=cpu python -m swiftortho_tpu_torch.tools.run_scale \\
        --taxa 3 --families 30 --workdir tiny

Counterpart of the JAX package's ``tools/run_scale.py``, with its
settings: ``SearchConfig(expect=1e-5, nc=--nc)``, ``find_orth_blocks``
with ``OrthConfig()`` and ``find_cluster_stream`` with
``ClusterConfig(algorithm='mcl', inflation=1.5)``, so the workdir's
``c.sc``, ``c.opc`` and ``c.clsr`` are the JAX script's bytes for the same
arguments.  The device is ``SWIFTORTHO_PLATFORM``'s (the card unless
``cpu`` is asked for); the MCL runs there too.  Before the search a device
warm (CUDA context, kernel library build, one kernel launch) is timed and
logged apart from it.  Two flags are for cross-checks:

- ``--route device`` runs the search on the three device routes
  (``SWIFTORTHO_INDEX=device``, ``SWIFTORTHO_CANDIDATES=device``,
  ``SWIFTORTHO_DEVICE_PACK=force``); ``default`` leaves the environment;
- ``--orth-out-of-core`` also runs ``find_orth -L y``'s out-of-core path
  and fails unless its ``.opc`` equals the in-memory one byte for byte.

The structured ``[swiftortho]`` log lines on stderr carry the per-wave
and per-phase decomposition; the last line of standard output is one
JSON object that sums them up.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

DEVICE_ROUTE = {'SWIFTORTHO_INDEX': 'device',
                'SWIFTORTHO_CANDIDATES': 'device',
                'SWIFTORTHO_DEVICE_PACK': 'force'}


class _EventTee:
    """A stderr stand-in that writes through and keeps the structured
    events of the given stages."""

    def __init__(self, stream, stages):
        self.stream = stream
        self.stages = stages
        self.events: list = []

    def write(self, text):
        for line in text.splitlines():
            if line.startswith('[swiftortho] {'):
                ev = json.loads(line.split(' ', 1)[1])
                if ev.get('stage') in self.stages:
                    self.events.append(ev)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def device_warm(device):
    """The device's one-off costs, before anything is timed: the CUDA
    context, the kernel library's build and one launch of each variant
    (on the CPU, one call of the plain version)."""
    import numpy as np
    import torch

    from ..ops.banded_sw import sw_align_auto
    t0 = time.time()
    if device.type == 'cuda':
        from .._build import load_kernels
        torch.cuda.init()
        load_kernels()
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(65, 90, (8, 64), dtype=np.uint8))
    lens = torch.full((8,), 64, dtype=torch.int32)
    args = [x.to(device) for x in (toks, toks, lens, lens)]
    for score_only in (False, True):
        sw_align_auto(*args, score_only=score_only)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return time.time() - t0


def family_purity(fsa, clsr):
    """(single-family groups, genes clustered): the family is the fasta
    description ("tax0|g0000 fam000")."""
    from ..io_fasta import iter_fasta
    fam_of = {}
    with open(fsa) as fh:
        for head, _ in iter_fasta(fh):
            parts = head.split()
            fam_of[parts[0]] = parts[1] if len(parts) > 1 else '?'
    pure = clustered = 0
    with open(clsr) as fh:
        for line in fh:
            genes = line.rstrip('\n').split('\t')
            clustered += len(genes)
            pure += len({fam_of.get(g, '?') for g in genes}) == 1
    return pure, clustered


def count_lines(path):
    with open(path, 'rb') as fh:
        return sum(1 for _ in fh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--taxa', type=int, default=25)
    ap.add_argument('--families', type=int, default=4000)
    ap.add_argument('--seed', type=int, default=7)
    ap.add_argument('--min-len', type=int, default=80)
    ap.add_argument('--max-len', type=int, default=600,
                    help='the 252,608-sequence corpus is --taxa 60 '
                         '--families 4100 --max-len 400')
    ap.add_argument('--nc', type=int, default=1 << 24,
                    help='hash bucket count (default 2^24)')
    ap.add_argument('--workdir', default='')
    ap.add_argument('--skip-downstream', action='store_true')
    ap.add_argument('--route', choices=('default', 'device'),
                    default='default',
                    help='device: index, candidates and pair packing on '
                         'the device')
    ap.add_argument('--orth-out-of-core', action='store_true',
                    help='also run find_orth -L y and require equal bytes')
    args = ap.parse_args(argv)

    import torch

    from ..config import ClusterConfig, OrthConfig, SearchConfig
    from ..corpus import make_corpus, write_corpus
    from ..device import get_device
    from ..io_fasta import SeqDB
    from ..ops import banded_sw_cuda
    from ..utils import log_event

    device = get_device()
    td = args.workdir or tempfile.mkdtemp(prefix='run_scale_')
    os.makedirs(td, exist_ok=True)
    fsa = os.path.join(td, 'c.fsa')
    t0 = time.time()
    if not os.path.exists(fsa):
        write_corpus(fsa, make_corpus(n_taxa=args.taxa,
                                      n_families=args.families,
                                      seed=args.seed,
                                      min_len=args.min_len,
                                      max_len=args.max_len))
    n = len(SeqDB.from_path(fsa))
    corpus_s = time.time() - t0
    print('corpus: %d seqs (%d taxa x %d families) %.1fs  dir=%s'
          % (n, args.taxa, args.families, corpus_s, td), flush=True)

    warm_s = device_warm(device)
    print('device warm (%s): %.1fs' % (device, warm_s), flush=True)
    log_event('run_scale_warm', device=str(device), seconds=round(warm_s, 3))

    if args.route == 'device':
        os.environ.update(DEVICE_ROUTE)
    banded_sw_cuda.reset_counters()
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)

    from ..search.blastp import blastp_to_file
    cfg = SearchConfig(expect=1e-5, nc=args.nc)
    sc = os.path.join(td, 'c.sc')
    tee = _EventTee(sys.stderr, ('search_phaseA', 'search_wave'))
    t0 = time.time()
    sys.stderr = tee
    try:
        blastp_to_file(fsa, fsa, sc, cfg, device=device)
    finally:
        sys.stderr = tee.stream
    t_search = time.time() - t0
    pairs = float(n) * n
    nrows = count_lines(sc)
    print('SEARCH: %.1fs  %.2fM pairs/s  %d hit rows'
          % (t_search, pairs / t_search / 1e6, nrows), flush=True)
    log_event('run_scale_search', seconds=round(t_search, 3),
              pairs_per_s=round(pairs / t_search), rows=nrows)
    pa = [e for e in tee.events if e['stage'] == 'search_phaseA']
    waves = [e for e in tee.events if e['stage'] == 'search_wave']
    if not pa:
        raise RuntimeError('the search logged no search_phaseA event')
    pa = pa[0]
    kernel = {'launches': dict(banded_sw_cuda.launches),
              'pairs': dict(banded_sw_cuda.pairs),
              'shapes': {k: dict(v)
                         for k, v in banded_sw_cuda.shapes.items()}}
    log_event('run_scale_kernel', **kernel)
    stage_s = {'index': pa['idx_wait_s'], 'phase_a': pa['cand_s'],
               'align': round(sum(w['align1_s'] for w in waves), 3),
               'policy': round(sum(w['policy_s'] for w in waves), 3),
               'search': round(t_search, 3)}
    res = {'sequences': n, 'taxa': args.taxa, 'families': args.families,
           'seed': args.seed, 'max_len': args.max_len, 'nc': args.nc,
           'device': str(device), 'route': args.route,
           'chunks': pa['chunks'], 'waves': pa['waves'],
           'blocks': pa.get('blocks'),
           'max_resident_indexes': pa.get('max_resident_indexes'),
           'corpus_s': round(corpus_s, 3), 'warm_s': round(warm_s, 3),
           'stage_s': stage_s, 'pairs_per_s': pairs / t_search,
           'sc_rows': nrows,
           'candidate_pairs': sum(w['pairs'] for w in waves),
           'long_pairs': sum(w.get('long_pairs', 0) for w in waves),
           'long_tiles': sum(w.get('long_tiles', 0) for w in waves),
           'kernel': kernel}

    if not args.skip_downstream:
        from ..orth.inference import find_orth_blocks
        opc = os.path.join(td, 'c.opc')
        t0 = time.time()
        with open(sc) as fh, open(opc, 'w') as out:
            for block in find_orth_blocks(fh, OrthConfig()):
                out.write(block)
        stage_s['orth'] = round(time.time() - t0, 3)
        res['opc_edges'] = count_lines(opc)
        print('ORTH: %.1fs  %d edges' % (stage_s['orth'], res['opc_edges']),
              flush=True)
        if args.orth_out_of_core:
            from ..orth.outofcore import find_orth_stream_ooc
            ooc = os.path.join(td, 'c.ooc.opc')
            t0 = time.time()
            with open(sc) as fh, open(ooc, 'w') as out:
                for block in find_orth_stream_ooc(fh, OrthConfig(),
                                                  tmpdir=td):
                    out.write(block)
            stage_s['orth_out_of_core'] = round(time.time() - t0, 3)
            with open(opc, 'rb') as a, open(ooc, 'rb') as b:
                same = a.read() == b.read()
            if not same:
                raise RuntimeError('find_orth -L y wrote other bytes than '
                                   'the in-memory find_orth: %s vs %s'
                                   % (ooc, opc))
            res['orth_out_of_core_equal'] = True
            print('ORTH -L y: %.1fs  byte-equal'
                  % stage_s['orth_out_of_core'], flush=True)

        from ..cluster.driver import find_cluster_stream
        clsr = os.path.join(td, 'c.clsr')
        t0 = time.time()
        with open(opc) as fh, open(clsr, 'w') as out:
            for line in find_cluster_stream(
                    fh, ClusterConfig(algorithm='mcl', inflation=1.5),
                    device=device):
                out.write(line)
        stage_s['mcl'] = round(time.time() - t0, 3)
        res['clsr_groups'] = count_lines(clsr)
        print('MCL: %.1fs  %d groups' % (stage_s['mcl'],
                                         res['clsr_groups']), flush=True)
        pure, clustered = family_purity(fsa, clsr)
        res.update(pure_groups=pure, genes_clustered=clustered)
        print('purity: %d/%d groups single-family, %d/%d genes clustered'
              % (pure, res['clsr_groups'], clustered, n), flush=True)
        print('TOTAL: %.1f min (search %.1fs orth %.1fs mcl %.1fs)'
              % ((t_search + stage_s['orth'] + stage_s['mcl']) / 60,
                 t_search, stage_s['orth'], stage_s['mcl']), flush=True)

    res['peak_rss_bytes'] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    res['peak_device_bytes'] = (torch.cuda.max_memory_allocated(device)
                                if device.type == 'cuda' else None)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
