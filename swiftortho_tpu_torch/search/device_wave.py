"""The wave body of the device routes: rank and cut, pair preparation,
packing, the banded SW, postprocessing, the E-value filter and the
vectorised policy as torch code on the search's device.

Counterpart of ``search.blastp``'s wave body (the rank and vmax cut,
``_align_pairs`` on the pair-packing route, the E-value filter of
``align_subset``, the policy's fast path), which serves every other route
and is the reference for this one: the rows are the same.
``blastp_stream`` runs this body when the candidates come from the
device engine (``SWIFTORTHO_CANDIDATES=device``), pairs are packed on the
device (``SWIFTORTHO_DEVICE_PACK=force``), no search mesh is active and
no candidate spill directory is set.  On a card every step runs there;
on CPU tensors the same torch code runs on the CPU.

The wave's arrays stay on the device from the candidate engine
(``candidates_device.generate_candidates_tensors``) to the emitted rows.
The host reads (``search_wave``'s ``host_syncs`` counts them, with the
one wait that closes the first rung's alignment):
- the candidates per query and the rank key's ranges;
- per alignment call, the pairs per length bucket (and, once per search
  with a partial pair table, the subjects for the hot-set pick);
- after the policy, which queries the fast path resolved, the number of
  emitted rows and of long pairs;
- in one stacked copy, the emitted rows' fields and the pairs of the
  queries the fast path left;
- only when there are some, the long pairs, the pairs whose subject is
  not in a partial pair table, and the results of their host batches;
- per escalation round, its alignment's buckets and its queries' pairs.
What stays on the host: the rung schedule (``blastp._rungs``), the row
formatter (``blastp._format_fast``), the sequential policy loop for the
queries the fast path leaves (``blastp._policy_rows``), the long pairs'
tiles (``blastp._align_long_tiles``) and the host gather of pairs whose
subject a partial table does not hold (``blastp._align_pairs``).

Exactness.  Integers are exact.  The bit score and 2^-bit come from
tables indexed by the SW score and by the bit score
(``evalue_tables``), built on the host with ``postprocess_batch``'s
formula and ``np.ldexp``, so E = D * lq * ls * 2^-bit is one float64
product of exact factors, as numpy takes it, and the identity is the
float64 division numpy takes.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..constants import (KA_GAPPED_LAMBDA, KA_GAPPED_LNK, LN2,
                         LONG_SEQ_TILE)
from ..device import indexed, synchronize
from ..ops import banded_sw_cuda as _cu
from ..ops.device_pack import DeviceSpans, charge
from ..ops.scan import cummax_1d, cumsum_1d
from ..utils import log_event
from . import blastp
from .candidates_device import stable_lexsort

BIGR = 1 << 40
# the SW score of a pair is at most 11 a residue of a side <= 8191
SCORE_LIMIT = 1 << 17
# the fields a wave keeps per pair (the score-only pass writes 'bit')
INT_FIELDS = ('aln', 'mis', 'gap', 'qst', 'qed', 'sst', 'sed', 'bit')
# what the host reads of a pair: its index, query row, subject, subject
# length, flags, the fields in reference coordinates and its E-value
READ_FIELDS = ('p', 'qrow', 'subj', 'slen', 'is_long', 'aligned', 'bit',
               'idy', 'aln', 'mis', 'gap', 'qst', 'qed', 'sst', 'sed', 'e')


class HostReads:
    """A wave's device-to-host reads, counted."""

    def __init__(self):
        self.n = 0

    def __call__(self, x: torch.Tensor) -> np.ndarray:
        self.n += 1
        return x.to('cpu', copy=True).numpy()

    def wait(self, device: torch.device):
        """Wait for the device's queued work (counted as a read)."""
        self.n += 1
        synchronize(device)


def compact(mask: torch.Tensor, m: int) -> torch.Tensor:
    """The indices of the ``m`` set entries of ``mask``, ascending,
    without a host read (the caller knows ``m``)."""
    dst = torch.where(mask, cumsum_1d(mask) - 1, m)
    out = torch.empty(m + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dst, torch.arange(mask.shape[0], device=mask.device))
    return out[:m]


def evalue_tables(device) -> tuple:
    """(bit score by SW score, 2^-bit by bit score), int64 and float64
    tensors on ``device``, built once per device from
    ``postprocess_batch``'s formula (numpy, float64) and ``np.ldexp``."""
    return _evalue_tables(indexed(device))


@functools.lru_cache(maxsize=None)
def _evalue_tables(device: torch.device) -> tuple:
    score = np.arange(SCORE_LIMIT, dtype=np.int64)
    bit = np.trunc((KA_GAPPED_LAMBDA * score - KA_GAPPED_LNK)
                   / LN2).astype(np.int64)
    pow2 = np.ldexp(1.0, -np.arange(int(bit.max()) + 1))
    return (torch.as_tensor(bit, device=device),
            torch.as_tensor(pow2, device=device))


def postprocess_tensors(best: dict, qst: torch.Tensor, sst: torch.Tensor,
                        swapped: torch.Tensor) -> dict:
    """``ops.banded_sw.postprocess_batch`` on the kernel's output tensors:
    the same fields in reference coordinates, int64 (``idy`` float64), on
    their device."""
    score = best['score'].long()
    bi, bj, sti, stj = (best[k].long() for k in ('bi', 'bj', 'sti', 'stj'))
    aln = best['aln'].long()
    idy = torch.where(aln > 0, best['idy'].double() * 100.0
                      / aln.clamp(min=1).double(), 0.0)
    q_lo = torch.where(swapped, sti, stj)
    q_hi = torch.where(swapped, bi, bj)
    s_lo = torch.where(swapped, stj, sti)
    s_hi = torch.where(swapped, bj, bi)
    return {'idy': idy, 'aln': aln, 'mis': best['mis'].long(),
            'gap': best['gap'].long(), 'qst': q_lo + qst, 'qed': q_hi + qst,
            'sst': s_lo + sst, 'sed': s_hi + sst,
            'bit': evalue_tables(score.device)[0][score], 'score': score}


def evalues(D: int, lq: torch.Tensor, ls: torch.Tensor,
            bit: torch.Tensor) -> torch.Tensor:
    """E = D * lq * ls * 2^-bit, float64, as numpy computes it."""
    return (D * lq * ls).double() * evalue_tables(bit.device)[1][bit]


def rank_cut_tensors(qrow, subj, csc, bq, bs, n_queries: int, vmax: int,
                     reads: HostReads):
    """``native.rank_cut_native`` on int64 tensors: per query, rank by
    chain score desc (ties: subject asc, then input order), cut at vmax.
    Returns (qrow, subj, csc, bq, bs, rank) on the device and nhits_of,
    the candidates per query before the cut, on the host.  One read."""
    dev = qrow.device
    n = qrow.shape[0]
    nhits = torch.zeros(n_queries, dtype=torch.int64, device=dev) \
        .scatter_add_(0, qrow, torch.ones_like(qrow))
    if n == 0:
        return (qrow, subj, csc, bq, bs, qrow.clone(),
                np.zeros(n_queries, np.int64))
    h = reads(torch.cat([nhits, torch.stack(
        [qrow.max(), subj.max(), csc.min(), csc.max()])]))
    nhits_of = h[:n_queries]
    qmax, smax, cmin, cmax = h[n_queries:]
    if (qmax < (1 << 13) and smax < (1 << 21) and cmin >= 0
            and cmax < (1 << 26)):
        key = (qrow << 47) | ((((1 << 26) - 1) - csc) << 21) | subj
        order = torch.sort(key, stable=True).indices
    else:
        order = stable_lexsort((subj, -csc, qrow))
    start = torch.cumsum(nhits, 0) - nhits
    rank = torch.arange(n, device=dev) - start[qrow[order]]
    keep = compact(rank < vmax, int(np.minimum(nhits_of, vmax).sum()))
    sel = order[keep]
    return (qrow[sel], subj[sel], csc[sel], bq[sel], bs[sel], rank[keep],
            nhits_of)


def fast_policy_tensors(qrow, rank, pass_all, is_long, seg_len: np.ndarray,
                        mm: np.ndarray, rung0: int, v: int) -> tuple:
    """``blastp._fast_policy`` on the device: (fast, emit), per query
    whether the fast path resolved it and per pair whether it is emitted,
    from a wave's ranked pairs (``qrow`` sorted) and, on the host, each
    query's pair count ``seg_len`` and miss bound ``mm``.  The running
    sum and maximum are ``ops.scan``'s two-level scans."""
    dev = qrow.device
    nq, n_pairs = len(seg_len), qrow.shape[0]
    if n_pairs == 0:
        return (torch.zeros(nq, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    seg_d = torch.as_tensor(seg_len, device=dev)
    present = seg_d > 0
    csum = cumsum_1d(pass_all)
    lo = torch.as_tensor(np.cumsum(seg_len) - seg_len,
                         device=dev).clamp(max=n_pairs - 1)
    base = torch.where(present, csum[lo] - pass_all[lo].long(), 0)
    hits_cum = csum - base[qrow]
    gv = qrow * (BIGR * 2) + torch.where(pass_all, rank, -1)
    last_hit = cummax_1d(gv) - qrow * (BIGR * 2)
    miss_run = rank - last_hit
    mm_q = torch.as_tensor(mm, device=dev)[qrow]
    stop = (miss_run >= mm_q) | (hits_cum >= mm_q + v)
    first_stop = torch.full((nq,), BIGR, dtype=torch.int64,
                            device=dev).scatter_reduce_(
        0, qrow, torch.where(stop, rank, BIGR), 'amin')
    has_long = torch.zeros(nq, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, qrow, is_long.long(), 'amax') > 0
    prefix = seg_d.clamp(max=rung0)
    fast = present & ~has_long & (
        (first_stop < prefix) | ((first_stop == BIGR) & (seg_d <= prefix)))
    return fast, pass_all & fast[qrow] & (rank <= first_stop[qrow])


class DeviceWave:
    """The device wave body of one search (``blastp_stream``).  ``run``
    takes one wave's masked tokens and its candidates (tensors on the
    pack context's device), logs its ``search_wave`` and ``device_wave``
    events and returns its m8 rows."""

    def __init__(self, qry, ref, cfg, pack_ctx, vmax: int, ref_blobs,
                 prepass: bool):
        self.qry, self.ref, self.cfg, self.pack = qry, ref, cfg, pack_ctx
        self.device = pack_ctx.device
        self.vmax, self.ref_blobs, self.prepass = vmax, ref_blobs, prepass
        self.D = len(ref)
        self.slen = torch.as_tensor(
            (ref.offsets[1:] - ref.offsets[:-1]).astype(np.int64),
            device=self.device)
        self.buckets = torch.as_tensor(
            np.asarray(cfg.align_buckets, np.int64), device=self.device)
        self._routing = None

    def routing(self) -> tuple:
        """The pair table's (row_of, fits) on the device; uploaded again
        after a hot-set pick."""
        if self._routing is None:
            self._routing = tuple(torch.as_tensor(a, device=self.device)
                                  for a in (self.pack.row_of,
                                            self.pack.fits))
        return self._routing

    def run(self, wst: int, wend: int, toks: np.ndarray, lens: np.ndarray,
            cands: list, t0: float, t_seg: float, t_cand: float,
            launch0: dict) -> list:
        dev, cfg, D, ref = self.device, self.cfg, self.D, self.ref
        nq = wend - wst
        reads, spans = HostReads(), DeviceSpans(dev)
        host0 = blastp.host_batches()
        # host seconds by part ('run': packing and SW calls, whose device
        # time ``spans`` takes)
        split = dict.fromkeys(('prep', 'run', 'postprocess', 'policy',
                               'format'), 0.0)

        cols = [torch.cat([torch.as_tensor(getattr(c, f), device=dev).long()
                           for c in cands]) if cands else
                torch.zeros(0, dtype=torch.int64, device=dev)
                for f in ('qrow', 'subject', 'score', 'band_q', 'band_s')]
        qrow, subj, _, bq, bs, rank, nhits_of = rank_cut_tensors(
            *cols, nq, self.vmax, reads)
        del cols
        n_pairs = qrow.shape[0]
        lq_all = torch.as_tensor(lens.astype(np.int64), device=dev)[qrow]
        ls_all = self.slen[subj]
        is_long = (lq_all >= LONG_SEQ_TILE) | (ls_all >= LONG_SEQ_TILE)
        mm, rung0, ladder = blastp._rungs(nhits_of, cfg)
        seg_len = np.minimum(nhits_of, self.vmax)
        seg_len_d = torch.as_tensor(seg_len, device=dev)
        sufq, sufs = lq_all - bq, ls_all - bs
        swapped = ~(sufq < sufs)          # reference: no swap iff |q| < |s|
        pad_need = torch.maximum(sufq, sufs)
        bucket_of = torch.searchsorted(self.buckets, pad_need)
        aligned = torch.zeros(n_pairs, dtype=torch.bool, device=dev)
        full = {k: torch.zeros(n_pairs, dtype=torch.int64, device=dev)
                for k in INT_FIELDS}
        full['idy'] = torch.zeros(n_pairs, dtype=torch.float64, device=dev)
        route = {'packed': 0, 'gathered': 0}
        wave = self.pack.wave_table(toks)
        t_prep = time.time()

        def pack_align(idx, width, score_only):
            row_of = self.routing()[0]
            sw, b_q, b_s = swapped[idx], bq[idx], bs[idx]
            sid, qr = row_of[subj[idx]], self.pack.n_db + qrow[idx]
            q_n = sufq[idx].clamp(max=width)
            s_n = sufs[idx].clamp(max=width)
            t = time.perf_counter()
            best = self.pack.run_tensors(
                wave, torch.where(sw, sid, qr), torch.where(sw, b_s, b_q),
                torch.where(sw, s_n, q_n), torch.where(sw, qr, sid),
                torch.where(sw, b_q, b_s), torch.where(sw, q_n, s_n),
                L0=width, L1=width, spans=spans, score_only=score_only)
            route['packed'] += idx.shape[0]
            t_post = time.perf_counter()
            split['run'] += t_post - t
            res = postprocess_tensors(best, b_q, b_s, sw)
            for k in ('bit',) if score_only else full:
                full[k][idx] = res[k]
            split['postprocess'] += time.perf_counter() - t_post

        def host_gather(idx, score_only):
            h = reads(torch.stack([qrow[idx], subj[idx], bq[idx], bs[idx]]))
            res = blastp._align_pairs(toks, lens, ref, *h, cfg.align_buckets,
                                      dev, score_only=score_only,
                                      route=route)
            for k in ('bit',) if score_only else full:
                full[k][idx] = torch.as_tensor(res[k], device=dev)

        def align_masked(mask, score_only) -> bool:
            """Align the pairs of ``mask`` (none long) by length bucket,
            writing their fields into ``full``; False when it is empty."""
            if n_pairs == 0:
                return False
            t = time.perf_counter()
            inner0 = split['postprocess'] + split['run']
            if not self.pack.selected:
                # partial table, first call: the hot-set pick
                h = reads(torch.stack([subj, mask.long()]))
                if self.pack.maybe_select(h[0][h[1] > 0]):
                    self._routing = None
            fits = self.routing()[1]
            nb = len(cfg.align_buckets)
            # groups: buckets 0..nb (nb: the catch-all), nb + 1: not in
            # the table (host gather), nb + 2: not asked
            grp = torch.where(mask, torch.where(fits[subj], bucket_of,
                                                nb + 1), nb + 2)
            counts = torch.zeros(nb + 3, dtype=torch.int64, device=dev) \
                .scatter_add_(0, grp, torch.ones_like(grp))
            top = torch.where(grp == nb, pad_need, 0).max()
            h = reads(torch.cat([counts, top.view(1)]))
            counts, top = h[:-1], int(h[-1])
            if not counts[:nb + 2].any():
                split['prep'] += time.perf_counter() - t
                return False
            order = torch.sort(grp, stable=True).indices
            widths = list(cfg.align_buckets) + [-(-top // 128) * 128]
            off = 0
            for g, c in enumerate(counts[:nb + 2].tolist()):
                idx = order[off:off + c]
                off += c
                if not c:
                    continue
                if g <= nb:
                    pack_align(idx, widths[g], score_only)
                else:
                    host_gather(idx, score_only)
            split['prep'] += (time.perf_counter() - t - split['postprocess']
                              - split['run'] + inner0)
            return True

        def align_subset(mask):
            mask = mask & ~is_long & ~aligned
            if self.prepass:
                # score-only first; the full statistics for the pairs
                # whose E-value passes
                if not align_masked(mask, True):
                    return
                aligned.logical_or_(mask)
                mask = mask & (evalues(D, lq_all, ls_all, full['bit'])
                               <= cfg.expect)
            align_masked(mask, False)
            aligned.logical_or_(mask)

        align_subset(rank < rung0)
        reads.wait(dev)
        t_align1 = time.time()

        # --- the policy's fast path, then the exact loop for the rest ---
        t = time.perf_counter()
        pass_all = (evalues(D, lq_all, ls_all, full['bit'])
                    <= cfg.expect) & aligned
        fast, emit = fast_policy_tensors(qrow, rank, pass_all, is_long,
                                         seg_len, mm, rung0, cfg.v)
        h = reads(torch.cat([fast.long(), torch.stack(
            [emit.sum(), is_long.sum()])]))
        fast_h = h[:nq] > 0
        m_emit, n_long = int(h[nq]), int(h[nq + 1])

        long_rows: dict = {}
        if n_long:
            li = compact(is_long, n_long)
            h = reads(torch.stack([li, qrow[li], subj[li], bq[li], bs[li]]))
            tiles = blastp._align_long_tiles(
                toks, lens, ref, np.arange(n_long), h[1], h[2], h[3], h[4],
                cfg.align_buckets, dev)
            long_rows = {int(h[0][k]): v for k, v in tiles.items()}
        long_tiles = sum(len(t) for t in long_rows.values())
        route['gathered'] += long_tiles

        def read_pairs(idx) -> dict:
            """The host's copy of pairs ``idx``, by ``READ_FIELDS``."""
            e = evalues(D, lq_all[idx], ls_all[idx], full['bit'][idx])
            h = reads(torch.stack(
                [idx, qrow[idx], subj[idx], ls_all[idx], is_long[idx].long(),
                 aligned[idx].long(), full['bit'][idx],
                 full['idy'][idx].view(torch.int64)]
                + [full[k][idx] for k in READ_FIELDS[8:15]]
                + [e.view(torch.int64)]))
            got = dict(zip(READ_FIELDS, h))
            for k in ('idy', 'e'):
                got[k] = got[k].view(np.float64)
            for k in ('is_long', 'aligned'):
                got[k] = got[k] > 0
            return got

        rows_of: dict = {}

        def resolve(queries, got) -> list:
            """The policy loop over the read pairs of ``queries`` (each
            query's pairs contiguous, in query order); returns the
            unresolved queries."""
            long_local = {k: long_rows[int(p)]
                          for k, p in enumerate(got['p']) if got['is_long'][k]}
            still, lo = [], 0
            for r in queries:
                c = int(seg_len[r])
                rows, ok = blastp._policy_rows(
                    np.arange(lo, lo + c), int(lens[r]), int(nhits_of[r]),
                    got['subj'], got['slen'], got['is_long'],
                    got['aligned'], got, long_local, D, cfg)
                lo += c
                if ok:
                    rows_of[r] = rows
                else:
                    still.append(r)
            return still

        slow = np.flatnonzero(~fast_h & (seg_len > 0))
        si = compact(((seg_len_d > 0) & ~fast)[qrow],
                     int(seg_len[slow].sum()))
        got = read_pairs(torch.cat([compact(emit, m_emit), si]))
        split['policy'] += time.perf_counter() - t
        t = time.perf_counter()
        fast_fmt = blastp._format_fast(
            {k: v[:m_emit] for k, v in got.items()}, lens, wst, wend,
            self.qry, self.ref_blobs, cfg)
        split['format'] += time.perf_counter() - t
        t = time.perf_counter()
        need_more = resolve(slow, {k: v[m_emit:] for k, v in got.items()})
        # escalation: queries whose stop condition was not resolved
        # inside the first rung climb the ladder
        esc_queries, esc_rounds = len(need_more), 0
        for stage in ladder:
            if not need_more:
                break
            esc_rounds += 1
            need = torch.zeros(nq, dtype=torch.bool, device=dev)
            need[torch.as_tensor(need_more, device=dev)] = True
            tail = need[qrow]
            align_subset(tail if stage is None else tail & (rank < stage))
            still = resolve(need_more, read_pairs(
                compact(need[qrow], int(seg_len[need_more].sum()))))
            assert stage is not None or not still, \
                'policy unresolved after full alignment'
            need_more = still
        split['policy'] += time.perf_counter() - t
        charge(spans.settle())
        t_align2 = time.time()
        host_syncs = reads.n + blastp.host_batches() - host0
        log_event('search_wave', wave=int(wst), queries=int(nq),
                  pairs=int(n_pairs),
                  seg_s=round(t_seg - t0, 2),
                  cand_s=round(t_cand - t_seg, 2),
                  rank_s=round(t_prep - t_cand, 2),
                  align1_s=round(t_align1 - t_prep, 2),
                  policy_s=round(t_align2 - t_align1, 2),
                  esc_queries=esc_queries, esc_rounds=esc_rounds,
                  rung0=rung0, packed_pairs=route['packed'],
                  gathered_pairs=route['gathered'],
                  long_pairs=len(long_rows), long_tiles=long_tiles,
                  sw_launches={k: _cu.launches[k] - v
                               for k, v in launch0.items()},
                  host_syncs=host_syncs)
        t = time.perf_counter()
        out = blastp._emit_rows(fast_fmt, fast_h, rows_of, lens, wst, wend,
                                self.qry, ref, cfg)
        log_event('device_wave', wave=int(wst),
                  rank_s=round(t_prep - t_cand, 4),
                  **{k + '_s': round(v, 4) for k, v in split.items()},
                  pack_s=round(spans.seconds.get('pack', 0.0), 4),
                  sw_s=round(spans.seconds.get('align', 0.0), 4),
                  emit_s=round(time.perf_counter() - t, 4),
                  host_syncs=host_syncs, emitted=m_emit)
        return out
