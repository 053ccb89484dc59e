"""End-to-end all-vs-all protein search (single device, PyTorch).

Behavioral contract: the reference ``blastp`` driver (lib/fsearch.py:2968-3121)
and its output format (fsearch.py:3230-3256):

- the reference set is indexed in chunks (-c sequences each); every query
  collects candidates from every chunk, merged and ranked by chain score;
- vmax = max(100, v+100, v*1.1) candidates are aligned per query with the
  banded SW kernel; E-filter at -e; early-stop after ``mmiss`` consecutive
  misses (mmiss = clamp(len(hits)*max_miss+1 vs 100/that, [10,120]),
  fsearch.py:3052-3054) or v+mmiss hits;
- pairs with a side >= 4096 are aligned in 4096x4096 diagonal tiles, one
  m8 row per passing tile (kswat_st_long, fsearch.py:1480-1498);
- survivors sorted by bit desc, top v emitted as 16 tab columns:
  qid sid idy aln mis gap qst+1 qed sst+1 sed E bit qlen slen qidx sdesc.

Device mapping: queries are seg-masked and seeded in batches; candidate
pairs from a whole query wave are length-bucketed and aligned in big
parallel batches on device; the sequential early-stop policy is *simulated
post-hoc* per query (alignment of candidates the reference would have
skipped costs extra FLOPs but changes nothing observable).

Port of ``swiftortho_tpu/search/blastp.py`` onto PyTorch; the output is
byte-identical to it.  What differs is the schedule and the device:
- by default every bucket is gathered on the host (``gather_rows``) and
  copied to ``device``; the banded SW runs there
  (``ops.banded_sw.sw_align_auto``: the CUDA kernel on a card, the plain
  version on the CPU);
- the score-only prepass runs when ``use_prepass(device)`` says so (on
  CUDA), the wave pipeline is ``SWIFTORTHO_WAVE_PIPELINE`` wide (default
  1);
- three opt-in routes move the search onto ``device``, each writing the
  same rows: ``SWIFTORTHO_INDEX=device`` builds the chunk indexes there
  (``ops.index_device``), ``SWIFTORTHO_CANDIDATES=device`` runs the
  candidate engine there (``search.candidates_device``) and
  ``SWIFTORTHO_DEVICE_PACK=force`` packs the pair tokens there from
  resident tables (``ops.device_pack``); with the last two, no search
  mesh and no spill directory, the wave body runs there as well
  (``search.device_wave``, logging ``host_syncs`` in ``search_wave``)
  and the numpy body below serves every other route;
- ``SWIFTORTHO_CANDIDATES=multidb`` holds every chunk index resident
  and fans each wave's candidate generation out over them, one device
  engine per chunk, round-robin over the active mesh's 'db' devices
  (``search.candidates_multidb``); under a search mesh
  (``parallel.mesh``) every alignment batch, and the pair packing, split
  over the mesh devices.  Both write the same rows;
- each ``search_wave`` event counts the banded SW kernel launches of its
  wave (``sw_launches``, per variant; the counter of
  ``ops.banded_sw_cuda``, exact at the default pipeline width 1), and
  the pairs and 4096-wide tiles of the long-pair path (``long_pairs``,
  ``long_tiles``).

Named deviation (tie order): the reference ranks candidates and final m8
rows with seeded UNSTABLE quicksorts (fsearch.py qsort :189-327, final sort
:3108-3110), so its order among equal chain scores / equal bit scores is an
artifact of pivot choices and not reproducible.  Here candidate ranking is
a deterministic lexsort (chain score desc, subject asc) and the final row
sort is stable by bit desc — rows at the vmax cut, the early-stop window,
and the top-v boundary can therefore differ from the reference when scores
tie.
"""

from __future__ import annotations

import threading
from typing import IO, Iterator, List

import numpy as np
import torch

from ..config import SearchConfig
from ..constants import LONG_SEQ_TILE
from ..device import get_device
from ..io_fasta import SeqDB
from ..ops.banded_sw import FIELDS, postprocess_batch, sw_align_auto
from ..ops.index import build_index
from ..ops.seg import seg_batch_vec
from ..ops.stats import f2s
from .candidates import Candidates, generate_candidates


def _fmt_idy(idy: float) -> str:
    # py2 12-digit float str, then truncate to 2 decimals (the reference's
    # runtime printed floats with py2 semantics; see ops.stats.py2_float_str)
    from ..ops.stats import py2_float_str
    s = py2_float_str(idy)
    end = max(0, s.find('.') + 3)
    return s[:end]


def _mask_queries(qry: SeqDB, idx: np.ndarray, pad: int, flt: bool):
    toks, lens = qry.padded_batch(idx, pad)
    if flt:
        toks = seg_batch_vec(toks, lens)
    return toks, lens


def use_prepass(device: torch.device) -> bool:
    """Whether to run the score-only prepass: on CUDA, where it skips the
    path statistics for the ~97% of pairs that fail the E-value filter.
    On the CPU the plain version would pay a second pass for the few that
    pass.  Schedule only: the output is the same either way."""
    return device.type == 'cuda'


_batches = threading.local()


def host_batches() -> int:
    """The host batches (``_align_on`` calls, one device-to-host copy
    each) this thread has aligned so far."""
    return getattr(_batches, 'n', 0)


def _align_on(device, t0, t1, l0, l1, score_only: bool = False) -> dict:
    """Align one padded host batch on ``device``, or over the active
    search mesh's devices (each shard goes straight from the host to its
    device); returns numpy arrays keyed by ``FIELDS`` (one stacked
    device-to-host copy)."""
    from ..parallel.mesh import active_search_mesh
    args = [torch.from_numpy(x) for x in (t0, t1, l0, l1)]
    if active_search_mesh() is None:
        args = [x.to(device) for x in args]
    best = sw_align_auto(*args, score_only=score_only)
    host = torch.stack([best[k] for k in FIELDS]).cpu().numpy()
    _batches.n = host_batches() + 1
    return dict(zip(FIELDS, host))


def _align_pairs(q_tokens, q_lengths, db: SeqDB, qrow, subject,
                 band_q, band_s, buckets, device: torch.device,
                 score_only: bool = False, pack_ctx=None,
                 route: dict | None = None) -> dict:
    """Align candidate pairs with the reference swap rule, bucketed by
    padded suffix length, on ``device``.  Returns reference-coordinate
    results.

    ``pack_ctx`` (ops.device_pack.DevicePackContext): when active, pairs
    whose subject fits the device token table are packed on the device
    from per-pair integers; the rest, and every pair when inactive, go
    through the host gather.  Both feed the same kernel and give the same
    results.  ``route`` ({'packed', 'gathered'}) counts the pairs of each.
    """
    n = len(qrow)
    lq = q_lengths[qrow].astype(np.int64)
    ls = (db.offsets[subject + 1] - db.offsets[subject]).astype(np.int64)
    sufq = lq - band_q
    sufs = ls - band_s
    swapped = ~(sufq < sufs)          # reference: no swap iff |q| < |s|
    col_len = np.where(swapped, sufs, sufq)
    row_len = np.where(swapped, sufq, sufs)
    pad_need = np.maximum(col_len, row_len)

    out = {k: np.zeros(n, dtype=np.int64)
           for k in ('aln', 'mis', 'gap', 'qst', 'qed', 'sst',
                     'sed', 'score')}
    out['idy'] = np.zeros(n, dtype=np.float64)
    out['bit'] = np.zeros(n, dtype=np.int64)

    order = np.argsort(pad_need, kind='stable')
    L = q_tokens.shape[1]
    route = {'packed': 0, 'gathered': 0} if route is None else route

    pack_on = pack_ctx is not None and pack_ctx.active()
    if pack_on:
        # first wave with a partial table: pick the hot resident set
        # from this wave's merged-across-chunks subject sample
        pack_ctx.maybe_select(subject)
        wave_handle = pack_ctx.wave_table(q_tokens)

    def run_bucket_dev(sel, bucket):
        sw = swapped[sel]
        sid = pack_ctx.row_of[subject[sel]]   # device table rows
        qr = pack_ctx.n_db + qrow[sel]
        q_n = np.minimum(sufq[sel], bucket).astype(np.int64)
        s_n = np.minimum(sufs[sel], bucket).astype(np.int64)
        best = pack_ctx.run(
            wave_handle,
            np.where(sw, sid, qr), np.where(sw, band_s[sel], band_q[sel]),
            np.where(sw, s_n, q_n),
            np.where(sw, qr, sid), np.where(sw, band_q[sel], band_s[sel]),
            np.where(sw, q_n, s_n),
            L0=bucket, L1=bucket, score_only=score_only)
        route['packed'] += len(sel)
        res = postprocess_batch(best, band_q[sel], band_s[sel], sw)
        for k in ('aln', 'mis', 'gap', 'qst', 'qed', 'sst', 'sed',
                  'score', 'bit'):
            out[k][sel] = res[k]
        out['idy'][sel] = res['idy']

    def run_bucket(sel, bucket):
        if pack_on:
            fit = pack_ctx.fits[subject[sel]]
            if fit.any():
                run_bucket_dev(sel[fit], bucket)
            sel = sel[~fit]
            if len(sel) == 0:
                return
        B = len(sel)
        route['gathered'] += B
        # vectorized suffix gather: query suffixes come from the padded
        # q_tokens rows, subject suffixes from the flat db token array
        q_st = band_q[sel]
        s_st = db.offsets[subject[sel]] + band_s[sel]
        q_n = np.minimum(sufq[sel], bucket).astype(np.int64)
        s_n = np.minimum(sufs[sel], bucket).astype(np.int64)
        sw = swapped[sel]
        t0 = np.empty((B, bucket), np.uint8)
        t1 = np.empty((B, bucket), np.uint8)

        from ..native import gather_rows
        qr = qrow[sel]
        q_flat_st = qr * L + q_st          # q_tokens rows, flattened
        all_rows = np.arange(B, dtype=np.int64)

        def fill(dst, rows_mask, src, starts, counts):
            rows = all_rows[rows_mask]
            if len(rows):
                gather_rows(src, starts[rows_mask],
                            counts[rows_mask], rows, dst)

        # columns (t0): query unless swapped; rows (t1): the other one
        fill(t0, ~sw, q_tokens, q_flat_st, q_n)
        fill(t0, sw, db.tokens, s_st, s_n)
        fill(t1, sw, q_tokens, q_flat_st, q_n)
        fill(t1, ~sw, db.tokens, s_st, s_n)
        l0 = np.where(sw, s_n, q_n).astype(np.int32)
        l1 = np.where(sw, q_n, s_n).astype(np.int32)
        best = _align_on(device, t0, t1, l0, l1, score_only=score_only)
        res = postprocess_batch(best, band_q[sel], band_s[sel], swapped[sel])
        for k in ('aln', 'mis', 'gap', 'qst', 'qed', 'sst', 'sed',
                  'score', 'bit'):
            out[k][sel] = res[k]
        out['idy'][sel] = res['idy']

    done = 0
    for bucket in buckets:
        hi = np.searchsorted(pad_need[order], bucket, side='right')
        sel = order[done:hi]
        done = hi
        if len(sel):
            run_bucket(sel, int(bucket))
    rest = order[done:]
    if len(rest):
        # catch-all: pairs longer than the largest configured bucket
        # (possible when align_buckets maxes out below LONG_SEQ_TILE) —
        # never silently skip; pad to the actual need.
        cap = int(pad_need[rest].max())
        run_bucket(rest, -(-cap // 128) * 128)
    return out


def _rungs(nhits_of: np.ndarray, cfg: SearchConfig):
    """A wave's staged-alignment schedule: (the per-query miss bound
    ``mm``, the first rung ``rung0``, the escalation ``ladder``).

    Staged alignment: the reference's sequential loop stops after mmiss
    (<=120) consecutive misses, so most queries never look past their
    first ~160 candidates; align that rung first and climb the ladder
    only for queries whose stop condition is unresolved.  Rung sizes are
    tunable (SWIFTORTHO_ALIGN_STAGES="160" default); measured on the 40k
    corpus, a lower first rung (64) makes ~60% of queries escalate (stop
    ranks are deep when corpora are dense) and the extra dispatch rounds
    cost more than the saved cells."""
    import os
    _stages_env = os.environ.get('SWIFTORTHO_ALIGN_STAGES', '160')
    STAGES = tuple(int(s) for s in _stages_env.split(',') if s)
    # the per-query miss bound (the reference's mmiss clamp,
    # fsearch.py:3052-3054) — needed here because the first rung
    # must cover the typical stop rank (~true hits + mmiss): on
    # dense corpora (many taxa) mmiss clamps to 120 and stops land
    # past a fixed 160, which would send almost every query to the
    # full-tail rung.  Schedule-only: output never depends on rungs.
    mm = nhits_of * max(cfg.max_miss, 1e-3) + 1.0
    mm = np.maximum(mm, 100.0 / mm)
    mm = np.minimum(np.maximum(mm, 10), 120)
    rung0 = int(max(STAGES[0],
                    (mm.max() if len(mm) else 0) + STAGES[0] / 2))
    ladder = [s for s in STAGES[1:] if s > rung0] + [None]
    return mm, rung0, ladder


def _fast_policy(qrow, rank, pass_all, is_long, nq_w: int, mm, rung0: int,
                 v: int):
    """The policy's vectorised fast path over a wave's ranked pairs
    (``qrow`` sorted).  For queries without long pairs, the sequential
    accept/stop loop reduces to segment ops — miss-run length is rank
    minus the last passing rank (segmented cummax), the stop position is
    the first rank where the miss-run or the hit count crosses its bound,
    and the emitted rows are exactly the passing ranks up to the stop.  A
    query is resolved by the fast path only when its stop falls inside
    the aligned prefix (``rung0``); everything else (long pairs,
    unresolved stops) runs the exact loop (``_policy_rows``).  Returns
    (fast, emit, q_lo, q_hi, present): per query whether the fast path
    resolved it, per pair whether it is emitted, and each query's pairs
    [q_lo, q_hi)."""
    n_pairs = len(qrow)
    q_lo = np.searchsorted(qrow, np.arange(nq_w))
    q_hi = np.searchsorted(qrow, np.arange(nq_w), side='right')
    seg_len = q_hi - q_lo
    present = seg_len > 0
    has_long = np.zeros(nq_w, dtype=bool)
    if is_long.any():
        has_long[qrow[is_long]] = True

    csum = np.cumsum(pass_all)
    base = np.zeros(nq_w, dtype=np.int64)
    if present.any():
        base[present] = (csum[q_lo[present]]
                         - pass_all[q_lo[present]])
    hits_cum = csum - base[qrow] if n_pairs else csum
    BIGR = np.int64(1) << 40
    val = np.where(pass_all, rank, -1)
    gv = qrow * (BIGR * 2) + val
    last_hit = np.maximum.accumulate(gv) - qrow * (BIGR * 2)
    miss_run = rank - last_hit
    stop = ((miss_run >= mm[qrow])
            | (hits_cum >= v + mm[qrow]))
    s_idx = np.where(stop, rank, BIGR)
    first_stop = np.full(nq_w, BIGR, dtype=np.int64)
    if present.any():
        first_stop[present] = np.minimum.reduceat(s_idx, q_lo[present])
    prefix = np.minimum(seg_len, rung0)
    fast = present & ~has_long & (
        (first_stop < prefix)
        | ((first_stop == BIGR) & (seg_len <= prefix)))
    emit = pass_all & fast[qrow] & (rank <= first_stop[qrow])
    return fast, emit, q_lo, q_hi, present


def _policy_rows(sel, qlen: int, nhits: int, subj, ls_all, is_long,
                 aligned, full: dict, long_rows: dict, D: int,
                 cfg: SearchConfig):
    """Run the reference's sequential accept/stop loop over the pairs
    ``sel`` of one query (``qlen`` long, ``nhits`` candidates before the
    cut); returns (rows, resolved) — unresolved when an unaligned
    candidate is reached before the stop condition triggers.  The pair
    arrays are indexed by the entries of ``sel``."""
    # the reference clamps max_miss itself before use
    # (fsearch.py:2970: max_miss = max(max_miss, 1e-3))
    mmiss = nhits * max(cfg.max_miss, 1e-3) + 1
    mmiss = max(mmiss, 100.0 / mmiss)
    mmiss = min(max(mmiss, 10), 120)
    unmch = 0
    bv = 0
    rows = []
    for p in sel:
        j = int(subj[p])
        slen = int(ls_all[p])
        if not is_long[p]:
            if not aligned[p]:
                return rows, False
            bit = int(full['bit'][p])
            e = D * qlen * slen * (2.0 ** -bit)
            if e <= cfg.expect:
                rows.append((
                    float(full['idy'][p]), int(full['aln'][p]),
                    int(full['mis'][p]), int(full['gap'][p]),
                    int(full['qst'][p]) + 1, int(full['qed'][p]),
                    int(full['sst'][p]) + 1, int(full['sed'][p]),
                    e, bit, j, slen))
                unmch = 0
                bv += 1
            else:
                unmch += 1
        else:
            hit_any = False
            for tile in long_rows[p]:
                bit = tile['bit']
                e = D * qlen * slen * (2.0 ** -bit)
                if e <= cfg.expect:
                    rows.append((tile['idy'], tile['aln'],
                                 tile['mis'], tile['gap'],
                                 tile['qst'] + 1, tile['qed'],
                                 tile['sst'] + 1, tile['sed'],
                                 e, bit, j, slen))
                    hit_any = True
                    bv += 1
            if hit_any:
                unmch = 0
            else:
                unmch += 1
        if unmch >= mmiss or bv >= cfg.v + mmiss:
            break
    return rows, True


def _format_fast(emitted: dict, lens, wst: int, wend: int, qry: SeqDB,
                 ref_blobs, cfg: SearchConfig):
    """The fast path's rows as formatted bytes: per query by bit desc
    (stable = acceptance order on ties, like list.sort), top v, one
    threaded call of the native formatter (fmtrows.cpp, char-for-char
    the Python path).  ``emitted`` holds the emitted pairs' fields in
    pair order (``qrow``, ``subj``, ``slen``, ``e`` and the kernel's
    fields).  Returns (buffer, row ends, query row of each row)."""
    from ..native import encode_blob, format_rows_native
    eb = emitted['bit']
    eq = emitted['qrow']
    if (len(eb) == 0 or (eb.min() >= 0 and eb.max() < (1 << 40)
                         and (wend - wst) <= (1 << 22))):
        key = (eq.astype(np.int64) << 40) | ((1 << 40) - 1 - eb)
        order = np.argsort(key, kind='stable')
    else:
        order = np.lexsort((np.arange(len(eb)), -eb, eq))
    eqs = eq[order]
    newq = np.ones(len(eqs), dtype=bool)
    newq[1:] = eqs[1:] != eqs[:-1]
    pos = np.arange(len(eqs)) - np.maximum.accumulate(
        np.where(newq, np.arange(len(eqs)), 0))
    keepv = pos < max(0, cfg.v)
    sel, eqs = order[keepv], eqs[keepv]
    fields = {
        'idy': emitted['idy'][sel], 'aln': emitted['aln'][sel],
        'mis': emitted['mis'][sel], 'gap': emitted['gap'][sel],
        'qst1': emitted['qst'][sel] + 1, 'qed': emitted['qed'][sel],
        'sst1': emitted['sst'][sel] + 1, 'sed': emitted['sed'][sel],
        'e': emitted['e'][sel], 'bit': emitted['bit'][sel],
        'qlen': lens[eqs].astype(np.int64),
        'slen': emitted['slen'][sel], 'qidx': wst + eqs}
    qid_blob, qid_off = encode_blob(
        [qry.ids[wst + r] for r in range(wend - wst)])
    buf, ends = format_rows_native(
        fields, eqs, qid_blob, qid_off, emitted['subj'][sel],
        ref_blobs[0], ref_blobs[1], ref_blobs[2], ref_blobs[3])
    return buf, ends, eqs


def _emit_rows(fast_fmt, fast, rows_of: dict, lens, wst: int, wend: int,
               qry: SeqDB, ref: SeqDB, cfg: SearchConfig) -> List[str]:
    """A wave's m8 rows in query order: the fast path's formatted bytes
    (``fast_fmt``, for the queries where ``fast``), and the policy loop's
    rows (``rows_of``: query row -> row tuples), sorted by bit desc and
    cut at v."""
    out_rows = []
    if fast_fmt is not None:
        buf, ends, eqs = fast_fmt
        starts_b = np.zeros(len(ends), dtype=np.int64)
        starts_b[1:] = ends[:-1]
        f_lo = np.searchsorted(eqs, np.arange(wend - wst))
        f_hi = np.searchsorted(eqs, np.arange(wend - wst),
                               side='right')
    for r in range(wend - wst):
        if fast_fmt is not None and fast[r]:
            for i in range(f_lo[r], f_hi[r]):
                out_rows.append(
                    buf[starts_b[i]:ends[i]].decode())
            continue
        if r not in rows_of:
            continue
        rows = rows_of[r]
        gi = wst + r
        qlen = int(lens[r])
        hid = qry.ids[gi]
        rows.sort(key=lambda x: -x[9])
        for row in rows[:max(0, cfg.v)]:
            (idy, aln, mis, gap, qst1, qed, sst1, sed,
             e, bit, j, slen) = row
            out_rows.append(
                '%s\t%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%s\t%f'
                '\t%d\t%d\t%d\t%s\n' % (
                    hid, ref.ids[j], _fmt_idy(idy), aln, mis, gap,
                    qst1, qed, sst1, sed, f2s(e), float(bit),
                    qlen, slen, gi, ref.headers[j]))
    return out_rows


class IndexSource:
    """Chunk-index provider that materializes ONE chunk index per
    ``get()`` — the TPU analog of the reference's disk-resident
    ``find_msav_dsk`` (lib/fsearch.py:2727-2805): every iteration
    materializes one chunk, hands it out, and drops it before the next.
    Under the default one-ahead prefetch in ``blastp_stream``
    (``SWIFTORTHO_PREFETCH_INDEX=1``) the stream holds at most TWO
    chunks resident in steady state; ``SWIFTORTHO_PREFETCH_INDEX=0``
    restores the strict at-most-one discipline.

    ``max_resident`` is instrumented so tests can assert bounded memory.
    """

    def __init__(self, n_chunks: int, get, track: bool = True,
                 cheap_reget: bool = False):
        import threading
        self.n_chunks = n_chunks
        self._get = get
        self._track = track
        # get() may run on the prefetch thread while _dec fires on the
        # phase-A thread; += / -= are not atomic in Python
        self._lock = threading.Lock()
        # re-materializing a chunk is cheap for disk loads / resident
        # lists; a from_build source pays a full rebuild, so the block
        # scheduler disk-caches it instead of re-getting
        self.cheap_reget = cheap_reget
        self.resident = 0 if track else n_chunks
        self.max_resident = self.resident

    def __len__(self):
        return self.n_chunks

    def get(self, ci: int):
        """Materialize chunk ci (residency-tracked like iteration)."""
        import weakref
        ix = self._get(ci)
        if self._track:
            with self._lock:
                self.resident += 1
                self.max_resident = max(self.max_resident, self.resident)
            weakref.finalize(ix, self._dec)
        return ix

    def __iter__(self):
        for ci in range(self.n_chunks):
            ix = self.get(ci)
            yield ix
            del ix

    def _dec(self):
        with self._lock:
            self.resident -= 1

    @classmethod
    def from_list(cls, indexes: list) -> 'IndexSource':
        # all chunks already resident in the caller's list: nothing to
        # stream, instrumentation reports the honest worst case
        return cls(len(indexes), lambda ci: indexes[ci], track=False,
                   cheap_reget=True)

    @classmethod
    def from_build(cls, ref: SeqDB, cfg: SearchConfig,
                   r_start: int = 0, r_end: int = -1,
                   device: torch.device | None = None) -> 'IndexSource':
        """Build chunk indexes on demand: on the host, or on ``device``
        (default ``get_device()``) under ``SWIFTORTHO_INDEX=device``."""
        alphabets = cfg.resolved_alphabets()
        chunk = cfg.effective_chunk()
        D = len(ref)
        r_start = min(max(0, r_start), D)
        r_end = D if r_end < 0 else min(r_end, D)
        starts = list(range(r_start, r_end, chunk))

        # SWIFTORTHO_INDEX=device: the index built and kept on the
        # device, the threshold's sums on the host (same index)
        import os as _os
        if _os.environ.get('SWIFTORTHO_INDEX', '') == 'device':
            from functools import partial

            from ..ops.index_device import build_index_device
            _build = partial(build_index_device, device=device)
        else:
            _build = build_index

        def get(ci):
            cst = starts[ci]
            return _build(ref, cst, min(cst + chunk, r_end), alphabets,
                          cfg.seeds, cfg.nc, cfg.step,
                          threshold_override=cfg.threshold)

        return cls(len(starts), get)

    @classmethod
    def from_disk(cls, prefix: str) -> 'IndexSource':
        import glob

        from ..ops.index import load_index

        paths = sorted(glob.glob(prefix + '.*.npz'),
                       key=lambda p: int(p.rsplit('.', 2)[-2]))
        if paths:
            return cls(len(paths), lambda ci: load_index(paths[ci]),
                       cheap_reget=True)
        # reference on-disk layout (.idx/.soas/.bin + params footer,
        # fsearch.py:2298-2349): chunked `name.%d.*` as written by its
        # makedb (:2283-2295), or a single unnumbered `name.*`
        from ..ops.index import load_index_ref
        rpaths = sorted(glob.glob(prefix + '.*.bin'),
                        key=lambda p: int(p.rsplit('.', 2)[-2]))
        if not rpaths and glob.glob(prefix + '.bin'):
            rpaths = [prefix + '.bin']
        if not rpaths:
            raise FileNotFoundError(
                'no index files match %s.*.npz or %s.*.bin — check the '
                '-D prefix (indexes are written by -p makedb)'
                % (prefix, prefix))
        return cls(len(rpaths),
                   lambda ci: load_index_ref(rpaths[ci][:-len('.bin')])[0],
                   cheap_reget=True)


def make_db(ref: SeqDB, cfg: SearchConfig, out_prefix: str = '',
            r_start: int = 0, r_end: int = -1) -> list:
    """Build (and optionally persist) chunk indexes over reference
    sequences [r_start, r_end) — the reference's `-p makedb` / formatted-db
    role with the -L/-U range (find_hit.py:282-283, fsearch.py
    Fasta.makedb :2283-2295).  Materializes every chunk; prefer
    ``IndexSource.from_build`` for bounded-memory streaming."""
    from ..ops.index import save_index

    src = IndexSource.from_build(ref, cfg, r_start, r_end)
    indexes = []
    for ci, ix in enumerate(src):
        if out_prefix:
            save_index('%s.%d.npz' % (out_prefix, ci), ix)
        indexes.append(ix)
    return indexes


def load_db(prefix: str) -> list:
    """Load chunk indexes persisted by make_db (the reference's -D path).
    Materializes every chunk; prefer ``IndexSource.from_disk``."""
    return list(IndexSource.from_disk(prefix))


class CandidateSpill:
    """Per-wave candidate accumulator for the chunk-major search phase —
    the analog of the reference's packed tmp.array spill + KDB offset
    table (fsearch.py:3006-3022).  RAM-backed by default; pass a
    directory to spill each (wave, chunk) batch to an .npz on disk so
    host memory stays bounded by one wave's candidates."""

    FIELDS = ('qrow', 'subject', 'score', 'band_q', 'band_s')

    def __init__(self, spill_dir: str | None = None):
        self.dir = spill_dir
        self._ram: dict = {}
        self._paths: dict = {}
        if spill_dir:
            import os
            os.makedirs(spill_dir, exist_ok=True)

    def append(self, wave: int, cand: Candidates):
        if self.dir is None:
            self._ram.setdefault(wave, []).append(cand)
        else:
            import os
            path = os.path.join(
                self.dir, 'cand.%06d.%06d.npz'
                % (wave, len(self._paths.setdefault(wave, []))))
            np.savez(path, **{f: getattr(cand, f) for f in self.FIELDS})
            self._paths[wave].append(path)

    def take(self, wave: int) -> List[Candidates]:
        """Return and release this wave's candidate batches."""
        if self.dir is None:
            return self._ram.pop(wave, [])
        import os
        out = []
        for path in self._paths.pop(wave, []):
            z = np.load(path)
            out.append(Candidates(**{f: z[f] for f in self.FIELDS}))
            os.remove(path)
        return out


def blastp_stream(qry: SeqDB, ref: SeqDB, cfg: SearchConfig,
                  indexes: 'list | IndexSource | None' = None,
                  q_start: int = 0, q_end: int = -1,
                  spill_dir: str | None = None,
                  device: torch.device | None = None) -> Iterator[str]:
    """Yield m8 rows for queries [q_start, q_end) in index order (the
    reference's -l/-u range, fsearch.py:2980-2981).

    ``device``: where the banded SW runs (default ``get_device()``, which
    reads ``SWIFTORTHO_PLATFORM``).

    Chunk-major two-phase structure, mirroring the reference driver
    (fsearch.py:2988-3051): phase A iterates reference chunk indexes one
    at a time (at most TWO resident — the swept chunk plus the one the
    prefetch thread is materializing; SWIFTORTHO_PREFETCH_INDEX=0
    restores the reference's strict one-resident find_msav_dsk
    discipline), generating candidates for every query wave against that
    chunk and spilling them per wave; phase B merges each wave's
    candidates across chunks, ranks, aligns, applies the accept/early-
    stop policy, and emits rows in query order.  Output is byte-identical
    to the old wave-major loop (the per-wave merge across chunks is
    unchanged).

    ``spill_dir``: spill candidates (and masked wave tokens) to disk so
    phase A's memory is bounded by one chunk index + one wave.

    Phase A runs on a producer thread overlapped with phase B's device
    work (a wave is consumed only once the final chunk has contributed
    its candidates, so results are byte-identical to the serial
    schedule; SWIFTORTHO_OVERLAP=0 disables).
    """
    device = get_device() if device is None else torch.device(device)
    alphabets = cfg.resolved_alphabets()
    D = len(ref)
    nq = len(qry)
    q_start = min(max(0, q_start), nq)
    # the reference defaults the end to the REFERENCE-set size clamped to
    # the query count (fsearch.py:2980-2981) — queries beyond len(ref) are
    # silently skipped when no -u is given
    q_end = min(D, nq) if q_end < 0 else min(q_end, nq)
    maxq = int(qry.lengths.max()) if nq else 0
    pad = 1
    while pad < maxq:
        pad *= 2
    pad = max(pad, 64)

    vmax = int(max(100, max(cfg.v + 100, cfg.v * 1.1)))

    # string-column blobs for the native row formatter (encoded once
    # per search; encode_blob is a pure-numpy helper)
    from ..native import encode_blob as _encode_blob
    _rid = _encode_blob(ref.ids)
    _rdesc = _encode_blob(ref.headers)
    ref_blobs = (_rid[0], _rid[1], _rdesc[0], _rdesc[1])

    # device-resident token tables for the pair-packing route
    # (ops.device_pack): built lazily, used under SWIFTORTHO_DEVICE_PACK
    from ..ops.device_pack import DevicePackContext
    pack_ctx = DevicePackContext(ref, device)

    if indexes is None:
        source = IndexSource.from_build(ref, cfg, device=device)
    elif isinstance(indexes, IndexSource):
        source = indexes
    else:
        source = IndexSource.from_list(indexes)

    import time as _time

    from ..utils import log_event

    waves = [(wst, min(wst + cfg.query_batch, q_end))
             for wst in range(q_start, q_end, cfg.query_batch)]

    # ---- phase A: chunk-major candidate generation ----
    spill = CandidateSpill(spill_dir)
    masked: dict = {}            # wave -> (toks, lens) | path

    def wave_tokens(wi):
        wst, wend = waves[wi]
        if wi in masked:
            v = masked[wi]
            if isinstance(v, str):
                z = np.load(v)
                return z['toks'], z['lens']
            return v
        idx = np.arange(wst, wend, dtype=np.int64)
        toks, lens = _mask_queries(qry, idx, pad, cfg.filter_query)
        if spill_dir is not None:
            import os
            path = os.path.join(spill_dir, 'wave.%06d.npz' % wi)
            np.savez(path, toks=toks, lens=lens)
            masked[wi] = path
        else:
            masked[wi] = (toks, lens)
        return toks, lens

    # candidate engine: host (vectorized numpy + native C++ chain) by
    # default; SWIFTORTHO_CANDIDATES=device runs it on ``device`` (same
    # Candidates); =multidb fans it out over resident shards (phase A)
    import os as _os
    _cand_mode = _os.environ.get('SWIFTORTHO_CANDIDATES', '')
    # the device wave (search.device_wave): candidates, rank, packing,
    # alignment and the policy's fast path stay on ``device``, with the
    # pair-packing route, no search mesh and no spill directory
    from ..parallel.mesh import active_search_mesh
    dwave = None
    if _cand_mode == 'device':
        from functools import partial

        from .candidates_device import (generate_candidates_device,
                                        generate_candidates_tensors)
        if (pack_ctx.active() and spill_dir is None
                and active_search_mesh() is None):
            from .device_wave import DeviceWave
            dwave = DeviceWave(qry, ref, cfg, pack_ctx, vmax, ref_blobs,
                               use_prepass(device))
            _gen_cands = partial(generate_candidates_tensors, device=device)
        else:
            _gen_cands = partial(generate_candidates_device, device=device)
    else:
        _gen_cands = generate_candidates

    # Overlap: phase A runs on a producer thread while phase B consumes
    # waves as they complete (a wave is complete once the LAST chunk has
    # generated its candidates — earlier chunks only append to the spill).
    # Phase A is host work (numpy + the GIL-releasing native chain
    # engine); phase B mostly waits on device fetches — the two pipeline
    # cleanly and the output is unchanged (phase B reads a wave only
    # after every chunk contributed, exactly as the serial order did).
    # SWIFTORTHO_OVERLAP=0 restores the serial schedule.
    import threading as _threading

    overlap = _os.environ.get('SWIFTORTHO_OVERLAP', '1') != '0'
    wave_ready = [_threading.Event() for _ in waves]
    phaseA_err: list = []

    def _signal(wi):
        wave_ready[wi].set()

    def _phaseA():
        pf = None       # one-ahead index prefetch executor (set below)
        try:
            _tA0 = _time.time()
            n_chunks = len(source)
            if _cand_mode == 'multidb':
                # P2 reference sharding: every chunk index device-
                # resident as a 'db'-axis shard, one wave fanned out
                # over all shards (candidates_multidb).  Spill order =
                # shard order = chunk order, so output is byte-identical
                # to the serial chunk sweep.
                from .candidates_multidb import generate_candidates_multidb
                indexes_all = [source.get(ci) for ci in range(n_chunks)]
                for wi in range(len(waves)):
                    toks, lens = wave_tokens(wi)
                    for cand in generate_candidates_multidb(
                            toks, lens, ref, indexes_all, alphabets,
                            cfg.seeds, platform=device):
                        spill.append(wi, cand)
                    _signal(wi)
                log_event('search_phaseA', chunks=n_chunks,
                          waves=len(waves), mode='multidb',
                          shards_resident=n_chunks,
                          cand_s=round(_time.time() - _tA0, 2))
                return
            # candidate generation is single-thread numpy + a
            # GIL-releasing native engine; a small wave pool overlaps
            # the numpy of one wave with the native part of another
            # (SWIFTORTHO_PRODUCERS=1 restores the serial sweep)
            nprod = max(1, int(_os.environ.get('SWIFTORTHO_PRODUCERS',
                                               '2')))
            # Block scheduling (multi-chunk only): a wave is consumable
            # only once EVERY chunk has contributed, so a plain
            # chunk-major sweep starves phase B until the last chunk.
            # Waves are processed in blocks of K: per block, every chunk
            # is materialized (one at a time) and swept over the block's
            # waves, then the block's waves are signaled — phase B
            # starts after block 0 instead of after chunk n-1.  Chunk
            # indexes are disk-cached after the first block when
            # re-materializing them is expensive (from_build sources).
            K = max(1, int(_os.environ.get('SWIFTORTHO_WAVE_BLOCK', '8')))
            if n_chunks <= 1 or len(waves) <= K:
                wave_blocks = [range(len(waves))]
            else:
                wave_blocks = [range(b, min(b + K, len(waves)))
                               for b in range(0, len(waves), K)]

            cache_dir = None
            cache_paths: dict = {}

            # chunk-invariant per-wave seed context (hash + budget
            # order), shared across the block's chunk sweep — only the
            # host engine consumes it, and only when >1 chunk makes the
            # reuse worthwhile (candidates.WaveSeeds; identical output,
            # guarded by matches(index) per chunk)
            from .candidates import make_wave_seeds
            use_ws = (_gen_cands is generate_candidates and n_chunks > 1)
            wave_seeds: dict = {}

            def seeds_for(wi, toks, lens, index):
                if not use_ws:
                    return None
                ws = wave_seeds.get(wi)
                if ws is None or not ws.matches(index):
                    ws = make_wave_seeds(toks, lens, alphabets, cfg.seeds,
                                         index.nc, index.mink)
                    wave_seeds[wi] = ws
                return ws

            def chunk_for(bi, ci):
                nonlocal cache_dir
                if bi == 0 or source.cheap_reget:
                    ix = source.get(ci)
                    if (bi == 0 and len(wave_blocks) > 1
                            and not source.cheap_reget):
                        # uncompressed npz: load >> rebuild
                        import tempfile
                        if cache_dir is None:
                            cache_dir = (spill_dir if spill_dir is not None
                                         else tempfile.mkdtemp(
                                             prefix='swortho_idx_'))
                        path = _os.path.join(cache_dir,
                                             'idxcache.%05d.npz' % ci)
                        np.savez(path, start=ix.start, locus=ix.locus,
                                 soas=ix.soas,
                                 params=np.array(
                                     [ix.nc, ix.seq_offset, ix.threshold,
                                      ix.mink], dtype=np.int64))
                        cache_paths[ci] = path
                    return ix
                from ..ops.index import load_index
                return load_index(cache_paths[ci])

            # One-ahead index prefetch: while the main producer sweeps
            # chunk k over the block's waves, a single helper thread
            # materializes chunk k+1 (block-0 build + npz spill, or a
            # cache reload on later blocks) — the build/load latency
            # rides under sweep compute instead of serializing with it.
            # Exactly two chunk indexes are resident in steady state (the
            # one being swept + the one being prefetched); the sweep
            # order is untouched, so output stays byte-identical.
            # SWIFTORTHO_PREFETCH_INDEX=0 restores strict one-resident
            # streaming (the reference's find_msav_dsk discipline,
            # fsearch.py:2727-2805).
            sched = [(bi, ci) for bi in range(len(wave_blocks))
                     for ci in range(n_chunks)]
            use_pf = (_os.environ.get('SWIFTORTHO_PREFETCH_INDEX', '1')
                      != '0' and len(sched) > 1)
            idx_wait = idx_bg = 0.0
            if use_pf:
                from concurrent.futures import ThreadPoolExecutor
                pf = ThreadPoolExecutor(1, thread_name_prefix='idxpf')

                def _bg(bi, ci):
                    nonlocal idx_bg
                    t0 = _time.time()
                    ix = chunk_for(bi, ci)
                    idx_bg += _time.time() - t0
                    return ix

                fut = pf.submit(_bg, *sched[0])

            for k, (bi, ci) in enumerate(sched):
                block = wave_blocks[bi]
                if use_pf:
                    t0 = _time.time()
                    index = fut.result()
                    idx_wait += _time.time() - t0
                    fut = (pf.submit(_bg, *sched[k + 1])
                           if k + 1 < len(sched) else None)
                else:
                    t0 = _time.time()
                    index = chunk_for(bi, ci)
                    idx_wait += _time.time() - t0
                last = ci == n_chunks - 1
                if nprod > 1 and len(block) > 1:
                    from concurrent.futures import ThreadPoolExecutor

                    def work(wi, _ix=index):
                        toks, lens = wave_tokens(wi)
                        if use_ws:
                            ws = seeds_for(wi, toks, lens, _ix)
                            return wi, _gen_cands(toks, lens, ref,
                                                  _ix, alphabets,
                                                  cfg.seeds,
                                                  wave_seeds=ws)
                        return wi, _gen_cands(toks, lens, ref, _ix,
                                              alphabets, cfg.seeds)

                    with ThreadPoolExecutor(nprod) as ex:
                        for wi, cand in ex.map(work, block):
                            spill.append(wi, cand)
                            if last:
                                _signal(wi)
                    # drop the closure (its _ix default pins the
                    # chunk index) before the next chunk is handed
                    # out, preserving the residency bound
                    work = None
                else:
                    for wi in block:
                        toks, lens = wave_tokens(wi)
                        if use_ws:
                            cand = _gen_cands(
                                toks, lens, ref, index, alphabets,
                                cfg.seeds,
                                wave_seeds=seeds_for(wi, toks, lens,
                                                     index))
                        else:
                            cand = _gen_cands(toks, lens, ref, index,
                                              alphabets, cfg.seeds)
                        spill.append(wi, cand)
                        if last:
                            _signal(wi)
                del index
                if last:
                    # the block's contexts die with the block
                    # (bounded memory)
                    wave_seeds.clear()
            if pf is not None:
                pf.shutdown(wait=False, cancel_futures=True)
            if n_chunks == 0:
                for wi in range(len(waves)):
                    _signal(wi)
            for path in cache_paths.values():
                try:
                    _os.remove(path)
                except OSError:
                    pass
            if cache_dir is not None and spill_dir is None:
                try:
                    _os.rmdir(cache_dir)
                except OSError:
                    pass
            log_event('search_phaseA', chunks=n_chunks, waves=len(waves),
                      blocks=len(wave_blocks),
                      max_resident_indexes=source.max_resident,
                      overlap=overlap, prefetch=use_pf,
                      idx_wait_s=round(idx_wait, 2),
                      idx_bg_s=round(idx_bg, 2),
                      cand_s=round(_time.time() - _tA0, 2))
        except BaseException as e:          # propagate into the consumer
            try:        # don't leak the prefetch worker on failure
                if pf is not None:
                    pf.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass
            phaseA_err.append(e)
            for ev in wave_ready:
                ev.set()

    if overlap:
        _prod = _threading.Thread(target=_phaseA, name='phaseA',
                                  daemon=True)
        _prod.start()
    else:
        _phaseA()
        if phaseA_err:
            raise phaseA_err[0]

    # ---- phase B: per-wave merge, rank, align, policy, emit ----
    from ..ops import banded_sw_cuda as _cu

    def _wave_body(wi):
        """Merge, rank, align, policy and format one wave; returns its
        output rows.  Wave bodies are independent (each owns its tokens
        and candidate arrays), so a small pipeline pool can run the host
        side of wave N+1 while wave N waits on device fetches — emission
        order is preserved by consuming results in wave order."""
        wst, wend = waves[wi]
        if overlap:
            wave_ready[wi].wait()
            if phaseA_err:
                raise phaseA_err[0]
        _t0 = _time.time()
        _launch0 = dict(_cu.launches)
        toks, lens = wave_tokens(wi)
        if isinstance(masked.get(wi), str):
            import os
            os.remove(masked[wi])
        masked.pop(wi, None)
        _t_seg = _time.time()

        cands: List[Candidates] = spill.take(wi)
        _t_cand = _time.time()
        if dwave is not None:
            return dwave.run(wst, wend, toks, lens, cands, _t0, _t_seg,
                             _t_cand, _launch0)

        qrow = np.concatenate([c.qrow for c in cands])
        subj = np.concatenate([c.subject for c in cands])
        csc = np.concatenate([c.score for c in cands])
        bq = np.concatenate([c.band_q for c in cands])
        bs = np.concatenate([c.band_s for c in cands])

        # per query: rank by chain score desc (ties: subject asc, then
        # input order), cut vmax.  Native engine (groupby.cpp rank_cut,
        # GIL-free) when available; the numpy paths below express the
        # same ordering (packed-key stable argsort when ranges allow —
        # chain scores are bounded by ~15x the query length, far under
        # 2^26 — else lexsort).
        ranked = False
        try:
            from ..native import rank_cut_native
            qrow, subj, csc, bq, bs, rank, nhits_of = rank_cut_native(
                qrow, subj, csc, bq, bs, wend - wst, vmax)
            ranked = True
        except Exception:
            pass        # no compiler: numpy below
        if not ranked:
            if (len(qrow) and qrow.max() < (1 << 13)
                    and subj.max() < (1 << 21)
                    and csc.max() < (1 << 26) and csc.min() >= 0):
                key = ((qrow.astype(np.uint64) << 47)
                       | ((np.uint64((1 << 26) - 1) - csc.astype(np.uint64))
                          << 21)
                       | subj.astype(np.uint64))
                order = np.argsort(key, kind='stable')
            else:
                order = np.lexsort((subj, -csc, qrow))
            qrow, subj, csc, bq, bs = (qrow[order], subj[order], csc[order],
                                       bq[order], bs[order])
            new_q = np.ones(len(qrow), dtype=bool)
            new_q[1:] = qrow[1:] != qrow[:-1]
            rank = np.arange(len(qrow)) - np.maximum.accumulate(
                np.where(new_q, np.arange(len(qrow)), 0))
            nhits_of = np.zeros(wend - wst, dtype=np.int64)
            np.add.at(nhits_of, qrow, 1)
            cut = rank < vmax
            qrow, subj, csc, bq, bs = (qrow[cut], subj[cut], csc[cut],
                                       bq[cut], bs[cut])
            rank = rank[cut]

        # long-pair split: either side >= 4096 goes to the tiled path
        lq_all = lens[qrow].astype(np.int64)
        ls_all = (ref.offsets[subj + 1] - ref.offsets[subj]).astype(np.int64)
        is_long = (lq_all >= LONG_SEQ_TILE) | (ls_all >= LONG_SEQ_TILE)
        n_pairs = len(qrow)

        mm, rung0, ladder = _rungs(nhits_of, cfg)
        aligned = np.zeros(n_pairs, dtype=bool)
        full = {k: np.zeros(n_pairs, dtype=np.int64)
                for k in ('aln', 'mis', 'gap', 'qst', 'qed', 'sst', 'sed',
                          'score', 'bit')}
        full['idy'] = np.zeros(n_pairs, dtype=np.float64)

        # A score-only prepass filters by E-value first: only the few
        # percent of pairs that pass need the full path statistics (the
        # policy loop reads nothing but `bit` from misses).  Scores from
        # the prepass and the full kernel are the same DP, so the output
        # is unchanged (see use_prepass).
        prepass = use_prepass(device)
        route = {'packed': 0, 'gathered': 0}

        def align_subset(mask):
            mask = mask & ~is_long & ~aligned
            sel_idx = np.flatnonzero(mask)
            if len(sel_idx) == 0:
                return
            if prepass:
                resA = _align_pairs(toks, lens, ref, qrow[sel_idx],
                                    subj[sel_idx], bq[sel_idx],
                                    bs[sel_idx], cfg.align_buckets, device,
                                    score_only=True, pack_ctx=pack_ctx,
                                    route=route)
                e = (D * lq_all[sel_idx] * ls_all[sel_idx]
                     * np.power(2.0, -resA['bit'].astype(np.float64)))
                passing = e <= cfg.expect
                sel2 = sel_idx[passing]
                for k in ('bit', 'score'):
                    full[k][sel_idx] = resA[k]
                aligned[sel_idx] = True
                if len(sel2) == 0:
                    return
                sel_idx = sel2
            res = _align_pairs(toks, lens, ref, qrow[sel_idx],
                               subj[sel_idx], bq[sel_idx], bs[sel_idx],
                               cfg.align_buckets, device, pack_ctx=pack_ctx,
                               route=route)
            for k in res:
                full[k][sel_idx] = res[k]
            aligned[sel_idx] = True

        _t_prep = _time.time()
        align_subset(rank < rung0)
        _t_align1 = _time.time()

        # tiled long pairs: ALL tiles of the wave in one kernel batch
        long_rows = _align_long_tiles(
            toks, lens, ref, np.flatnonzero(is_long), qrow, subj, bq, bs,
            cfg.align_buckets, device)
        long_tiles = sum(len(t) for t in long_rows.values())
        route['gathered'] += long_tiles

        def policy_rows(sel, r):
            return _policy_rows(sel, int(lens[r]), int(nhits_of[r]), subj,
                                ls_all, is_long, aligned, full, long_rows,
                                D, cfg)

        # --- per-query policy + output (qrow is sorted): the vectorised
        # fast path, then the exact loop for the queries it leaves ---
        e_all = (D * lq_all * ls_all
                 * np.power(2.0, -full['bit'].astype(np.float64)))
        pass_all = (e_all <= cfg.expect) & aligned
        fast, emit, q_lo, q_hi, present = _fast_policy(
            qrow, rank, pass_all, is_long, wend - wst, mm, rung0, cfg.v)

        rows_of = {}
        emit_idx = np.flatnonzero(emit)
        # fast-path rows go straight from arrays to formatted bytes via
        # the native formatter (fmtrows.cpp, char-for-char the Python
        # path): per-query final sort by bit desc (stable = acceptance
        # order on ties, like list.sort), top-v cut, one threaded call.
        fast_fmt = None
        try:
            emitted = {k: full[k][emit_idx] for k in full}
            emitted.update(qrow=qrow[emit_idx], subj=subj[emit_idx],
                           e=e_all[emit_idx], slen=ls_all[emit_idx])
            fast_fmt = _format_fast(emitted, lens, wst, wend, qry,
                                    ref_blobs, cfg)
        except Exception:
            # no compiler: fast rows fall back to python tuples below
            for p in emit_idx:
                r = int(qrow[p])
                rows_of.setdefault(r, []).append((
                    float(full['idy'][p]), int(full['aln'][p]),
                    int(full['mis'][p]), int(full['gap'][p]),
                    int(full['qst'][p]) + 1, int(full['qed'][p]),
                    int(full['sst'][p]) + 1, int(full['sed'][p]),
                    float(e_all[p]), int(full['bit'][p]), int(subj[p]),
                    int(ls_all[p])))
            for r in np.flatnonzero(fast):
                rows_of.setdefault(int(r), [])

        need_more = []
        for r in np.flatnonzero(present & ~fast):
            r = int(r)
            rows, ok = policy_rows(np.arange(q_lo[r], q_hi[r]), r)
            if ok:
                rows_of[r] = rows
            else:
                need_more.append(r)
        # escalation visibility: queries whose stop condition was not
        # resolved inside the first rung (mis-tuned rungs on unusual
        # corpora show up here; rungs are schedule-only, never output)
        esc_queries = len(need_more)
        esc_rounds = 0
        for stage in ladder:
            if not need_more:
                break
            esc_rounds += 1
            tail_mask = np.zeros(n_pairs, dtype=bool)
            for r in need_more:
                tail_mask[q_lo[r]:q_hi[r]] = True
            if stage is not None:
                tail_mask &= rank < stage
            align_subset(tail_mask)
            still = []
            for r in need_more:
                rows, ok = policy_rows(np.arange(q_lo[r], q_hi[r]), r)
                if ok:
                    rows_of[r] = rows
                else:
                    still.append(r)
            assert stage is not None or not still, \
                'policy unresolved after full alignment'
            need_more = still

        _t_align2 = _time.time()
        log_event('search_wave', wave=int(wst), queries=int(wend - wst),
                  pairs=int(n_pairs),
                  seg_s=round(_t_seg - _t0, 2),
                  cand_s=round(_t_cand - _t_seg, 2),
                  rank_s=round(_t_prep - _t_cand, 2),
                  align1_s=round(_t_align1 - _t_prep, 2),
                  policy_s=round(_t_align2 - _t_align1, 2),
                  esc_queries=esc_queries, esc_rounds=esc_rounds,
                  rung0=rung0, packed_pairs=route['packed'],
                  gathered_pairs=route['gathered'],
                  long_pairs=len(long_rows), long_tiles=long_tiles,
                  sw_launches={k: _cu.launches[k] - v
                               for k, v in _launch0.items()})
        return _emit_rows(fast_fmt, fast, rows_of, lens, wst, wend, qry,
                          ref, cfg)

    # wave pipeline width: >1 overlaps wave N+1's host work with wave
    # N's device waits (results still emitted in wave order).  Serial by
    # default until a measurement on the card asks for more;
    # SWIFTORTHO_WAVE_PIPELINE overrides.
    pipe_n = max(1, int(_os.environ.get('SWIFTORTHO_WAVE_PIPELINE', '1')))
    if pipe_n > 1 and len(waves) > 1:
        from concurrent.futures import ThreadPoolExecutor as _TPE
        with _TPE(pipe_n) as _bex:
            for _rows in _bex.map(_wave_body, range(len(waves))):
                for _r in _rows:
                    yield _r
    else:
        for wi in range(len(waves)):
            for _r in _wave_body(wi):
                yield _r

    if overlap:
        _prod.join()
        if phaseA_err:
            raise phaseA_err[0]


def _align_long_tiles(q_tokens, q_lengths, ref: SeqDB, long_idx,
                      qrow, subj, bq, bs, buckets, device: torch.device,
                      tile: int = LONG_SEQ_TILE) -> dict:
    """Reference kswat_st_long: pairs with a side >= 4096 are aligned in
    4096x4096 diagonal tiles, one result row per tile (fsearch.py
    :1480-1498).  Every tile of every long pair in the wave rides ONE
    batched kernel pass (VERDICT item 6: no sequential Python DP) —
    per-tile results are bit-identical to the oracle (the round-1
    kernel/oracle parity tests cover the shared kernel).

    Returns {pair_index: [tile-result dict, ...]} in tile order.
    """
    long_idx = np.asarray(long_idx)
    if len(long_idx) == 0:
        return {}
    # enumerate tiles: i walks the query from the band anchor in `tile`
    # steps; j advances in lockstep (the reference's shared loop var)
    t_pair, t_i0, t_j0 = [], [], []
    for p in long_idx:
        lq = int(q_lengths[qrow[p]])
        i, j = int(bq[p]), int(bs[p])
        while i < lq:
            t_pair.append(int(p))
            t_i0.append(max(0, i))
            t_j0.append(max(0, j))
            i += tile
            j += tile
    t_pair = np.asarray(t_pair, dtype=np.int64)
    t_i0 = np.asarray(t_i0, dtype=np.int64)
    t_j0 = np.asarray(t_j0, dtype=np.int64)

    n = len(t_pair)
    t_qrow = qrow[t_pair]
    t_sid = subj[t_pair]
    lq = q_lengths[t_qrow].astype(np.int64)
    s_off0 = ref.offsets[t_sid]
    ls = (ref.offsets[t_sid + 1] - s_off0).astype(np.int64)
    l0q = np.clip(lq - t_i0, 0, tile)              # query tile length
    l1s = np.clip(ls - t_j0, 0, tile)              # subject tile length
    # reference swap rule per tile (kswat_st :1364-1369): the shorter
    # tile becomes the column sequence; no swap iff |q| < |s|
    swapped = ~(l0q < l1s)
    col_len = np.where(swapped, l1s, l0q)
    row_len = np.where(swapped, l0q, l1s)
    pad_need = np.maximum(col_len, row_len)

    out = {k: np.zeros(n, dtype=np.int64)
           for k in ('aln', 'mis', 'gap', 'qst', 'qed', 'sst', 'sed',
                     'score', 'bit')}
    out['idy'] = np.zeros(n, dtype=np.float64)
    order = np.argsort(pad_need, kind='stable')
    L = q_tokens.shape[1]

    def run_bucket(sel, bucket):
        B = len(sel)
        t0 = np.empty((B, bucket), np.uint8)
        t1 = np.empty((B, bucket), np.uint8)
        from ..native import gather_rows
        q_flat_st = t_qrow[sel] * L + t_i0[sel]
        s_st = s_off0[sel] + t_j0[sel]
        q_n = np.minimum(l0q[sel], bucket).astype(np.int64)
        s_n = np.minimum(l1s[sel], bucket).astype(np.int64)
        sw = swapped[sel]
        rows = np.arange(B, dtype=np.int64)

        def fill(dst, mask, src, starts, counts):
            r = rows[mask]
            if len(r):
                gather_rows(src, starts[mask], counts[mask], r, dst)

        fill(t0, ~sw, q_tokens, q_flat_st, q_n)
        fill(t0, sw, ref.tokens, s_st, s_n)
        fill(t1, sw, q_tokens, q_flat_st, q_n)
        fill(t1, ~sw, ref.tokens, s_st, s_n)
        l0 = np.where(sw, s_n, q_n).astype(np.int32)
        l1 = np.where(sw, q_n, s_n).astype(np.int32)
        best = _align_on(device, t0, t1, l0, l1)
        res = postprocess_batch(best, t_i0[sel], t_j0[sel], swapped[sel])
        for k in out:
            out[k][sel] = res[k]

    done = 0
    for bucket in buckets:
        hi = np.searchsorted(pad_need[order], bucket, side='right')
        sel = order[done:hi]
        done = hi
        if len(sel):
            run_bucket(sel, int(bucket))
    rest = order[done:]
    if len(rest):
        cap = int(pad_need[rest].max())
        run_bucket(rest, -(-cap // 128) * 128)

    rows_of: dict = {int(p): [] for p in long_idx}
    for t in range(n):
        rows_of[int(t_pair[t])].append(
            {'idy': float(out['idy'][t]), 'aln': int(out['aln'][t]),
             'mis': int(out['mis'][t]), 'gap': int(out['gap'][t]),
             'qst': int(out['qst'][t]), 'qed': int(out['qed'][t]),
             'sst': int(out['sst'][t]), 'sed': int(out['sed'][t]),
             'bit': int(out['bit'][t])})
    return rows_of


def blastp_to_file(qry_path: str, ref_path: str, out: IO[str] | str,
                   cfg: SearchConfig | None = None,
                   db_prefix: str = '', q_start: int = 0, q_end: int = -1,
                   r_start: int = 0, r_end: int = -1, append: bool = False,
                   spill_dir: str | None = None,
                   device: torch.device | None = None):
    cfg = cfg or SearchConfig()
    qry = SeqDB.from_path(qry_path)
    ref = SeqDB.from_path(ref_path)
    if db_prefix:
        indexes = IndexSource.from_disk(db_prefix)
    elif r_start > 0 or r_end >= 0:
        indexes = IndexSource.from_build(ref, cfg, r_start=r_start,
                                         r_end=r_end, device=device)
    else:
        indexes = None
    fh = open(out, 'a' if append else 'w') if isinstance(out, str) else out
    try:
        buf = []
        for row in blastp_stream(qry, ref, cfg, indexes=indexes,
                                 q_start=q_start, q_end=q_end,
                                 spill_dir=spill_dir, device=device):
            buf.append(row)
            if len(buf) >= 10000:
                fh.write(''.join(buf))
                buf = []
        fh.write(''.join(buf))
    finally:
        if isinstance(out, str):
            fh.close()
