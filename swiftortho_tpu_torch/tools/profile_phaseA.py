"""Split phase A (host candidate generation) of the search by (wave, chunk),
and compare runs with and without the chunk-invariant ``WaveSeeds`` cache.

Usage:
    python -m swiftortho_tpu_torch.tools.profile_phaseA [--taxa 25]
        [--families 4000] [--waves 2] [--nc 16777216] [--workdir DIR]

Counterpart of the JAX package's ``tools/profile_phaseA.py``, with its
corpus (``make_corpus(seed=7, min_len=80, max_len=600)``),
``SearchConfig(expect=1e-5, nc=--nc)`` and index cache
(``<workdir>/idx_nc<nc>.<chunk>.npz``, reused when present, as is the
corpus ``<workdir>/c.fsa``), on the port's copies of ``IndexSource``,
``load_index``/``save_index``, ``seg_batch_vec``, ``make_wave_seeds`` and
``generate_candidates``.  The default workdir is ``scale102`` under the
temporary directory.  ``--waves 0`` only writes the corpus and the index
cache.

Phase A is host work: this tool touches no device.  For each wave it
prints the seg and seed-context seconds, then each chunk's seconds and
candidate count with the cached context and without it (the two must
give the same candidates), and, last, one JSON line with all of them.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--taxa', type=int, default=25)
    ap.add_argument('--families', type=int, default=4000)
    ap.add_argument('--workdir',
                    default=os.path.join(tempfile.gettempdir(), 'scale102'))
    ap.add_argument('--waves', type=int, default=2)
    ap.add_argument('--nc', type=int, default=1 << 24,
                    help='hash buckets (default 2^24)')
    args = ap.parse_args(argv)

    from ..config import SearchConfig
    from ..corpus import make_corpus, write_corpus
    from ..io_fasta import SeqDB
    from ..ops.index import load_index, save_index
    from ..ops.seg import seg_batch_vec
    from ..search.blastp import IndexSource
    from ..search.candidates import generate_candidates, make_wave_seeds

    os.makedirs(args.workdir, exist_ok=True)
    fsa = os.path.join(args.workdir, 'c.fsa')
    corpus_s = None
    if not os.path.exists(fsa):
        t0 = time.time()
        write_corpus(fsa, make_corpus(n_taxa=args.taxa,
                                      n_families=args.families,
                                      seed=7, min_len=80, max_len=600))
        corpus_s = time.time() - t0
        print('corpus gen %.1fs' % corpus_s, flush=True)
    db = SeqDB.from_path(fsa)
    n = len(db)
    cfg = SearchConfig(expect=1e-5, nc=args.nc)
    print('corpus %d seqs, chunk=%d -> %d chunks'
          % (n, cfg.effective_chunk(),
             -(-n // cfg.effective_chunk())), flush=True)

    t0 = time.time()
    idx_prefix = os.path.join(args.workdir, 'idx_nc%d' % args.nc)
    cached = sorted(glob.glob(idx_prefix + '.*.npz'),
                    key=lambda p: int(p.rsplit('.', 2)[-2]))
    if cached:
        indexes = [load_index(p) for p in cached]
    else:
        src = IndexSource.from_build(db, cfg)
        indexes = [src.get(ci) for ci in range(len(src))]
        for ci, ix in enumerate(indexes):
            save_index('%s.%d.npz' % (idx_prefix, ci), ix)
    index_s = time.time() - t0
    print('index: %.1fs (%d chunks)' % (index_s, len(indexes)), flush=True)

    alphabets = cfg.resolved_alphabets()
    pad = 1
    maxq = int(db.lengths.max())
    while pad < maxq:
        pad *= 2
    pad = max(pad, 64)

    waves = []
    for wi in range(args.waves):
        wst = wi * cfg.query_batch
        wend = min(wst + cfg.query_batch, n)
        idx = np.arange(wst, wend, dtype=np.int64)
        t0 = time.time()
        toks, lens = db.padded_batch(idx, pad)
        toks = seg_batch_vec(toks, lens)
        t_seg = time.time() - t0

        t0 = time.time()
        ws = make_wave_seeds(toks, lens, alphabets, cfg.seeds,
                             indexes[0].nc, indexes[0].mink)
        t_ctx = time.time() - t0
        print('wave %d (%d q): seg %.2fs  ctx(hash+order) %.2fs'
              % (wi, wend - wst, t_seg, t_ctx), flush=True)

        cached_s, cands, got = [], [], []
        for ci, index in enumerate(indexes):
            t0 = time.time()
            c = generate_candidates(toks, lens, db, index, alphabets,
                                    cfg.seeds, wave_seeds=ws)
            dt = time.time() - t0
            cached_s.append(dt)
            cands.append(len(c.qrow))
            got.append(c)
            print('  [cached ctx] chunk %d: %.2fs  (cands %d)'
                  % (ci, dt, len(c.qrow)), flush=True)
        plain_s = []
        for ci, index in enumerate(indexes):
            t0 = time.time()
            c = generate_candidates(toks, lens, db, index, alphabets,
                                    cfg.seeds)
            dt = time.time() - t0
            plain_s.append(dt)
            print('  [plain]      chunk %d: %.2fs' % (ci, dt), flush=True)
            for f in ('qrow', 'subject', 'score', 'band_q', 'band_s'):
                if not np.array_equal(getattr(c, f), getattr(got[ci], f)):
                    raise RuntimeError(
                        'wave %d chunk %d: the cached seed context changed '
                        'the candidates (%s)' % (wi, ci, f))
        print('wave %d: ctx+cached %.2fs  vs plain %.2fs  (%.2fx)'
              % (wi, t_ctx + sum(cached_s), sum(plain_s),
                 sum(plain_s) / max(t_ctx + sum(cached_s), 1e-9)),
              flush=True)
        waves.append({'wave': wi, 'queries': wend - wst, 'seg_s': t_seg,
                      'ctx_s': t_ctx, 'cached_s': cached_s,
                      'plain_s': plain_s, 'cands': cands})
    print(json.dumps({'metric': 'phaseA_profile', 'sequences': n,
                      'chunks': len(indexes), 'nc': args.nc,
                      'query_batch': cfg.query_batch,
                      'corpus_s': corpus_s, 'index_s': index_s,
                      'index_cached': bool(cached), 'host_cpus':
                      os.cpu_count(), 'waves': waves}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
