"""Device against host candidate generation on a 40k corpus: time both
engines on two real 4,096-query waves, require their candidates to be
exactly equal, and climb the stage-2 posting cap
(``SWIFTORTHO_DEVICE_CAND_CAP``) from 2^20 to 2^23.

Usage:
    python -m swiftortho_tpu_torch.tools.bench_device_cand

Counterpart of the JAX package's ``tools/bench_device_cand.py``, with its
corpus (``make_corpus(n_taxa=10, n_families=4000, seed=7, min_len=80,
max_len=600)``), ``SearchConfig(expect=1e-5, nc=2^24)``, one ``aa9``
index over the whole corpus and the waves [0, 4096) and [4096, 8192).
The host engine (``search.candidates.generate_candidates``) runs first;
then, for each cap in ascending order, the device engine
(``search.candidates_device.generate_candidates_device``) on
``SWIFTORTHO_PLATFORM``'s device (the card unless ``cpu`` is asked for)
runs a cold wave (the first at this cap) and a warm one.  Every field of
``qrow, subject, score, band_q, band_s`` must equal the host engine's,
and the device engine must not fall back to the host: either fails the
run.  The JAX script also set ``SWIFTORTHO_DEVICE_CAND_UNSAFE``; neither
package reads that variable, so it is gone.

Prints one line per engine and cap and, last, one JSON line.  ``bench``
does the work; its corpus parameters default to the values above.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

FIELDS = ('qrow', 'subject', 'score', 'band_q', 'band_s')
CAPS = tuple(1 << k for k in (20, 21, 22, 23))


def _events(text):
    return [json.loads(ln.split(' ', 1)[1]) for ln in text.splitlines()
            if ln.startswith('[swiftortho] {')]


def bench(n_taxa=10, n_families=4000, seed=7, min_len=80, max_len=600,
          nc=1 << 24, wave=4096, caps=CAPS, device=None, out=sys.stdout):
    """Run the comparison; returns the result object of the JSON line.
    ``device``: the device engine's (default ``get_device()``)."""
    import torch

    from ..config import SearchConfig
    from ..corpus import make_corpus, write_corpus
    from ..device import get_device
    from ..io_fasta import SeqDB
    from ..ops.index import build_index
    from ..ops.seg import seg_batch_vec
    from ..search.candidates import generate_candidates
    from ..search.candidates_device import generate_candidates_device

    device = get_device() if device is None else torch.device(device)

    def say(msg):
        print(msg, file=out, flush=True)

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix='bench_cand_') as td:
        fsa = os.path.join(td, 'c.fsa')
        write_corpus(fsa, make_corpus(n_taxa=n_taxa, n_families=n_families,
                                      seed=seed, min_len=min_len,
                                      max_len=max_len))
        db = SeqDB.from_path(fsa)
    corpus_s = time.time() - t0
    say('corpus: %d seqs %.1fs' % (len(db), corpus_s))
    cfg = SearchConfig(expect=1e-5, nc=nc)
    t0 = time.time()
    index = build_index(db, 0, len(db), ['aa9'], cfg.seeds, cfg.nc)
    index_s = time.time() - t0
    say('index: %d postings %.1fs' % (len(index.locus), index_s))

    maxq = int(db.lengths.max())
    pad = 1
    while pad < maxq:
        pad *= 2
    waves = []
    for wst in (0, wave):
        idx = np.arange(wst, min(wst + wave, len(db)), dtype=np.int64)
        toks, lens = db.padded_batch(idx, pad)
        waves.append((seg_batch_vec(toks, lens), lens))

    host, host_s = [], []
    for toks, lens in waves:
        t0 = time.time()
        host.append(generate_candidates(toks, lens, db, index, ['aa9'],
                                        cfg.seeds))
        host_s.append(time.time() - t0)
    say('HOST: %d+%d candidates in %.1f+%.1fs'
        % (len(host[0].qrow), len(host[1].qrow), *host_s))

    rows = []
    old = os.environ.get('SWIFTORTHO_DEVICE_CAND_CAP')
    try:
        for cap in caps:
            os.environ['SWIFTORTHO_DEVICE_CAND_CAP'] = str(cap)
            secs, blocks, stages = [], [], []
            for (toks, lens), want in zip(waves, host):
                buf = io.StringIO()
                t0 = time.time()
                with contextlib.redirect_stderr(buf):
                    got = generate_candidates_device(
                        toks, lens, db, index, ['aa9'], cfg.seeds,
                        device=device)
                secs.append(time.time() - t0)
                ev = _events(buf.getvalue())
                fell = [e for e in ev
                        if e['stage'] == 'device_candidates_fallback']
                done = [e for e in ev if e['stage'] == 'device_candidates']
                if fell or not done:
                    raise RuntimeError('cap %d: the device engine fell back '
                                       'to the host: %s' % (cap, fell))
                bad = [f for f in FIELDS if not np.array_equal(
                    getattr(got, f), getattr(want, f))]
                if bad:
                    raise RuntimeError('cap %d: device candidates != host '
                                       'in %s' % (cap, bad))
                blocks.append(done[0]['blocks'])
                stages.append({k: v for k, v in done[0].items()
                               if k.endswith('_s')})
            say('DEVICE cap=2^%d: cold %.1fs warm %.1fs parity=True '
                'blocks=%s' % (cap.bit_length() - 1, secs[0], secs[1],
                               blocks))
            rows.append({'cap': cap, 'cold_s': secs[0], 'warm_s': secs[1],
                         'parity': True, 'blocks': blocks,
                         'stages': stages})
    finally:
        if old is None:
            os.environ.pop('SWIFTORTHO_DEVICE_CAND_CAP', None)
        else:
            os.environ['SWIFTORTHO_DEVICE_CAND_CAP'] = old
    return {'metric': 'device_candidates', 'device': str(device),
            'sequences': len(db), 'nc': nc, 'postings': len(index.locus),
            'corpus_s': corpus_s, 'index_s': index_s,
            'waves': [list(w[0].shape) for w in waves],
            'host_s': host_s, 'host_candidates': [len(h.qrow) for h in host],
            'caps': rows}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.parse_args(argv)
    print(json.dumps(bench()), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
