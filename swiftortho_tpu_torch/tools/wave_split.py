"""Seconds by part of find_hit's waves on the three device routes.

Usage:
    python -m swiftortho_tpu_torch.tools.wave_split [--searches 3]
        [--taxa 10] [--families 4000] [--seed 42] [--min-len 80]
        [--max-len 400] [--fasta PATH] [--workdir DIR]

Writes ``make_corpus(n_taxa, n_families, seed, min_len, max_len)`` (by
default the corpus of the ``search_10g_41k_device`` benchmark cell) to
``<workdir>/c.fsa`` unless ``--fasta`` names one, then searches it
against itself (``SearchConfig()``, query = reference) with
``SWIFTORTHO_INDEX=device``, ``SWIFTORTHO_CANDIDATES=device`` and
``SWIFTORTHO_DEVICE_PACK=force`` on ``SWIFTORTHO_PLATFORM``'s device,
``--searches`` times in this process (the first pays the process's first
kernel launches and allocations).  Other ``SWIFTORTHO_*`` settings, such
as ``SWIFTORTHO_WAVE_PIPELINE``, are left as they are.

Prints one JSON line a search: its seconds, rows and rows' md5, phase
A's seconds, and per part the seconds summed over the waves: from
``search_wave``, ``rank_s``, ``align1_s``, ``policy_s`` and each wave's
``host_syncs``; from the device wave's ``device_wave`` events their
split; and from timers this tool puts around module functions of the
numpy wave body, ``align_pairs_s`` (``blastp._align_pairs``),
``postprocess_s`` (``blastp.postprocess_batch``), ``format_native_s``
(``native.format_rows_native``), ``pack_s`` and ``sw_fetch_s``
(``ops.device_pack.PROF``) and ``emit_s`` (from a wave's
``search_wave`` event to its first row); ``cand_stages``, the device
candidate engine's stage seconds summed over its calls (both producer
threads), and ``index_stages``, the device index build's; on a card,
the search's peak device bytes.  With two searches or more, a last line
``{"first_search_excess": {...}}`` gives, for the search's seconds, phase
A's, each index and engine stage's and ``walks_s`` (both walks), the
first search's seconds less the median of the later ones: what a fresh
process's first kernels and allocations add to each stage.  The package is
imported by its absolute name, so ``PYTHONPATH=<another tree> python
<this file>`` measures that tree's search, an older numpy wave
included.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import tempfile
import threading
import time

ROUTES = {'SWIFTORTHO_INDEX': 'device', 'SWIFTORTHO_CANDIDATES': 'device',
          'SWIFTORTHO_DEVICE_PACK': 'force'}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--searches', type=int, default=3)
    ap.add_argument('--taxa', type=int, default=10)
    ap.add_argument('--families', type=int, default=4000)
    ap.add_argument('--seed', type=int, default=42)
    ap.add_argument('--min-len', type=int, default=80)
    ap.add_argument('--max-len', type=int, default=400)
    ap.add_argument('--fasta', default=None)
    ap.add_argument('--workdir',
                    default=os.path.join(tempfile.gettempdir(), 'wave_split'))
    args = ap.parse_args(argv)
    os.environ.update(ROUTES)

    from swiftortho_tpu_torch import native, utils
    from swiftortho_tpu_torch.config import SearchConfig
    from swiftortho_tpu_torch.corpus import make_corpus, write_corpus
    from swiftortho_tpu_torch.device import get_device
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.ops import device_pack, index_device
    from swiftortho_tpu_torch.search import blastp, candidates_device

    fsa = args.fasta
    if fsa is None:
        os.makedirs(args.workdir, exist_ok=True)
        fsa = os.path.join(args.workdir, 'c.fsa')
        if not os.path.exists(fsa):
            write_corpus(fsa, make_corpus(
                n_taxa=args.taxa, n_families=args.families, seed=args.seed,
                min_len=args.min_len, max_len=args.max_len))
    db = SeqDB.from_path(fsa)
    device = get_device()

    lock = threading.Lock()
    timers: dict = {}
    events: list = []

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    timers[name] = (timers.get(name, 0.0)
                                    + time.perf_counter() - t)
        return run

    log = utils.log_event

    def spy(stage, **kw):
        with lock:
            events.append((stage, kw, time.time()))
        log(stage, **kw)

    patches = [(blastp, '_align_pairs', timed('align_pairs_s',
                                              blastp._align_pairs)),
               (blastp, 'postprocess_batch',
                timed('postprocess_s', blastp.postprocess_batch)),
               (native, 'format_rows_native',
                timed('format_native_s', native.format_rows_native)),
               (utils, 'log_event', spy),
               (candidates_device, 'log_event', spy),
               (index_device, 'log_event', spy)]
    try:
        from swiftortho_tpu_torch.search import device_wave
        patches.append((device_wave, 'log_event', spy))
    except ImportError:          # a tree without the device wave
        pass
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        lines = [_search(k, db, device, blastp, device_pack, SearchConfig,
                         timers, events, lock)
                 for k in range(args.searches)]
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if len(lines) >= 2:
        print(json.dumps({'first_search_excess': first_search_excess(lines)}),
              flush=True)


def _stage_seconds(line: dict) -> dict:
    """A search's seconds by stage: the search, phase A, each index and
    engine stage, and both walks together."""
    out = {'wall_s': line['wall_s'], 'phase_a_s': line['phase_a_s']}
    out.update({'index_' + k: v for k, v in line['index_stages'].items()})
    out.update(line['cand_stages'])
    out['walks_s'] = (line['cand_stages'].get('right_walk_s', 0.0)
                      + line['cand_stages'].get('left_walk_s', 0.0))
    return out


def first_search_excess(lines: list) -> dict:
    """Per stage, the first search's seconds less the median of the
    later searches' (a stage missing from a search counts 0)."""
    first, *warm = [_stage_seconds(ln) for ln in lines]
    return {k: round(v - statistics.median(w.get(k) or 0.0 for w in warm), 4)
            for k, v in first.items() if v is not None}


def _search(k, db, device, blastp, device_pack, SearchConfig, timers,
            events, lock):
    """One search; prints its JSON line and returns it."""
    import torch
    device_pack.reset_prof()
    timers.clear()
    events.clear()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    digest, rows, emit, seen = hashlib.md5(), 0, 0.0, 0
    t0 = time.time()
    for row in blastp.blastp_stream(db, db, SearchConfig(), device=device):
        now = time.time()
        with lock:
            waves = [ts for st, _, ts in events if st == 'search_wave']
        if len(waves) > seen:
            emit += now - waves[-1]
            seen = len(waves)
        digest.update(row.encode())
        rows += 1
    wall = time.time() - t0
    waves = [kw for st, kw, _ in events if st == 'search_wave']
    split = [kw for st, kw, _ in events if st == 'device_wave']
    phase_a = [kw for st, kw, _ in events if st == 'search_phaseA']
    out = {'search': k, 'device': str(device), 'wall_s': round(wall, 4),
           'rows': rows, 'sc_md5': digest.hexdigest(),
           'waves': len(waves),
           'phase_a_s': phase_a[0]['cand_s'] if phase_a else None}
    for key in ('rank_s', 'align1_s', 'policy_s'):
        out[key] = round(sum(w[key] for w in waves), 4)
    out['host_syncs'] = [w.get('host_syncs') for w in waves]
    out['esc_rounds'] = [w['esc_rounds'] for w in waves]
    out['device_wave'] = {
        key: round(sum(e[key] for e in split), 4)
        for key in (split[0] if split else ()) if key.endswith('_s')}
    out.update({key: round(v, 4) for key, v in sorted(timers.items())})
    out.update(pack_s=round(device_pack.PROF['pack_s'], 4),
               sw_fetch_s=round(device_pack.PROF['align_s'], 4),
               emit_s=round(emit, 4))
    cand = [kw for st, kw, _ in events if st == 'device_candidates']
    out['cand_stages'] = {
        key: round(sum(e.get(key, 0.0) for e in cand), 4)
        for key in (cand[0] if cand else ()) if key.endswith('_s')}
    index = [kw for st, kw, _ in events if st == 'device_index']
    out['index_stages'] = {
        key: round(sum(e.get(key, 0.0) for e in index), 4)
        for key in (index[0] if index else ()) if key.endswith('_s')}
    out['peak_device_bytes'] = (torch.cuda.max_memory_allocated(device)
                                if device.type == 'cuda' else None)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
