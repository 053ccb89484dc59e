"""Time the device seed-index build of one chunk in a fresh process: the
first build against the later ones.

Usage:
    python -m swiftortho_tpu_torch.tools.index_cold [--taxa 10]
        [--families 4000] [--seed 42] [--min-len 80] [--max-len 400]
        [--builds 3] [--profile] [--workdir DIR]

Writes ``make_corpus(n_taxa, n_families, seed, min_len, max_len)`` (by
default the corpus of the ``search_10g_41k_device`` benchmark cell) to
``<workdir>/c.fsa`` unless it is there, then builds the first chunk's
index (``SearchConfig()``'s alphabets, seeds, ``nc`` and chunk) with
``ops.index_device.build_index_device`` on ``SWIFTORTHO_PLATFORM``'s
device (the card unless ``cpu`` is asked for), ``--builds`` times.  The
first build of the process pays each kernel's first launch and the
caching allocator's first blocks; the later ones show the build's own
work.  ``--profile`` runs the first build under ``torch.profiler`` and
prints its top host events by total time.  Prints one line per build
with its seconds and ``device_index`` stages and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--taxa', type=int, default=10)
    ap.add_argument('--families', type=int, default=4000)
    ap.add_argument('--seed', type=int, default=42)
    ap.add_argument('--min-len', type=int, default=80)
    ap.add_argument('--max-len', type=int, default=400)
    ap.add_argument('--builds', type=int, default=3)
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--workdir',
                    default=os.path.join(tempfile.gettempdir(), 'index_cold'))
    args = ap.parse_args(argv)

    import torch

    from ..config import SearchConfig
    from ..corpus import make_corpus, write_corpus
    from ..device import get_device, synchronize
    from ..io_fasta import SeqDB
    from ..ops import index_device

    os.makedirs(args.workdir, exist_ok=True)
    fsa = os.path.join(args.workdir, 'c.fsa')
    if not os.path.exists(fsa):
        write_corpus(fsa, make_corpus(
            n_taxa=args.taxa, n_families=args.families, seed=args.seed,
            min_len=args.min_len, max_len=args.max_len))
    db = SeqDB.from_path(fsa)
    cfg = SearchConfig()
    device = get_device()
    if device.type == 'cuda':         # the context, outside the timings
        torch.zeros(1, device=device)
        synchronize(device)
    events = []
    call = (db, 0, min(cfg.effective_chunk(), len(db)),
            cfg.resolved_alphabets(), cfg.seeds, cfg.nc, cfg.step)
    builds, top = [], None
    log_event = index_device.log_event
    index_device.log_event = lambda stage, **kw: events.append(kw)
    try:
        for i in range(args.builds):
            builds.append(_build(index_device, call, cfg, device,
                                 args.profile and i == 0, events))
            top = top or builds[-1].pop('top', None)
            print('build %d: %s' % (i, builds[-1]), flush=True)
    finally:
        index_device.log_event = log_event
    for e in top or ():
        print('  %-50s %5d calls %10.3f ms' % (e['name'][:50], e['calls'],
                                               e['cpu_ms']))
    print(json.dumps({'device': str(device), 'sequences': len(db),
                      'T': events[-1]['T'],
                      'postings': events[-1]['postings'], 'builds': builds,
                      'first_build_top_host_events': top}), flush=True)


def _build(index_device, call, cfg, device, profiled, events):
    """One timed build: its seconds and stages, and with ``profiled`` its
    top host events (``top``)."""
    from ..device import synchronize
    prof = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
        prof = profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    index_device.build_index_device(*call, threshold_override=cfg.threshold,
                                    device=device)
    synchronize(device)
    out = {'seconds': round(time.perf_counter() - t0, 4),
           **{k: v for k, v in events[-1].items() if k.endswith('_s')}}
    if prof is not None:
        prof.stop()
        out['top'] = [{'name': e.key, 'calls': e.count,
                       'cpu_ms': round(e.cpu_time_total / 1e3, 3)}
                      for e in sorted(prof.key_averages(),
                                      key=lambda e: -e.cpu_time_total)[:12]]
    return out


if __name__ == '__main__':
    main()
