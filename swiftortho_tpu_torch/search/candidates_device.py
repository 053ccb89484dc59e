"""Candidate generation on the device: seed hashing, the self-score seed
budget, posting expansion, diagonal grouping and x-drop chain scoring as
torch code.

Port of ``swiftortho_tpu/search/candidates_device.py`` (``_stage1_seeds``
:83-166, ``_walk_chunked`` :169-227, ``_seg_max_scan``/``_accept_rounds``
:230-271, ``_stage2_expand_chain`` :309-471, the device caches :474-520,
``generate_candidates_device`` :536-673).  Same contract: the Candidates
equal the host ``swiftortho_tpu.search.candidates.generate_candidates``
(the reference ``find_msav_m``, lib/fsearch.py:2645-2724), array for
array; the min-score gate and the best-per-subject pick run on the host
in the shared ``_finish_candidates``, or, for the device wave
(``generate_candidates_tensors``, ``search.device_wave``), on the device
in ``finish_candidates_tensors``.

Where torch differs from XLA, and what this module does:
- FNV-1a in int64 with a 32-bit mask (``ops.index_device.fnv_step``);
- the segmented max-scan (``jax.lax.associative_scan``) packs
  (segment << 32) | (value + 2^31) into int64 and takes ``torch.cummax``:
  segments are contiguous, so the running max of the packed word is the
  max within the current segment;
- every gather index is clipped to its array: an index past the end
  raises on the CPU and is a device-side assert on CUDA;
- group starts are the positions of the new-group flags in the sorted
  keys (groups are contiguous runs of one key prefix), which is the
  JAX module's ``.at[gid].min`` segment minimum;
- the key sort may be unstable (equal keys are equal postings); the
  walks' first-maximum rule uses ``torch.argmax``, which returns the
  first maximum;
- the running sums of the walks are int32 (``NEG_STEP`` is sized so that
  a chunk of invalid steps stays in range);
- no power-of-two posting capacity and no row padding (both served XLA's
  compile cache): stage 2 runs on exactly the postings of a row block.
  The posting cap ``SWIFTORTHO_DEVICE_CAND_CAP`` still cuts a wave into
  query-row blocks, and a query whose own postings exceed it falls back
  to the host engine with a ``device_candidates_fallback`` event;
- the x-drop walks (``walk``) run on CUDA tensors in a hand-written
  kernel (``ops/xdrop_walk_cuda.py``, ``csrc/xdrop_walk.cu``): one thread
  walks one point until its own x-drop, with no scan, no temporary and
  no host read; it raises on any build or launch error.  On CPU tensors
  they run ``walk_chunked``, the plain version the kernel is held
  against: all points of a stage-2 call at once, in blocks only as large
  as ``WALK_BYTES`` of (points, WC) temporaries allow, dropping ended
  points after every WC-step chunk (one host read per chunk).  The
  points are independent, so both equal the lockstep walk.
- the accept rounds (``accept``) run on CUDA tensors in a hand-written
  kernel (``ops/accept_rounds_cuda.py``, ``csrc/accept_rounds.cu``): one
  thread walks one group's points in order, which gives the rounds'
  result in one launch with no host read (the round count stays on the
  device until the engine logs its event).  On CPU tensors they run
  ``accept_rounds``, the plain version: the JAX module's rounds over
  two-level scans, with one host read a round.

Each call logs a ``device_candidates`` event with the seconds of stage 1,
expansion and sort, the right walk, the accept rounds, the left walk and
the fetch.  An index built on the engine's device
(``ops.index_device.DeviceSeedIndex``) is used as it lies there; the
device copies of the reference tokens and of any other chunk index's CSR
are cached under a lock: phase A calls the engine from
``SWIFTORTHO_PRODUCERS`` threads.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from functools import lru_cache

import numpy as np
import torch

from ..constants import B62_BYTES, MIN_CHAIN_SCORE, XDROP
from ..device import StageClock, get_device, indexed
from ..io_fasta import SeqDB
from ..ops.accept_rounds_cuda import accept_rounds_cuda
from ..ops.banded_sw import scoring_tables
from ..ops.index import SeedIndex
from ..ops.index_device import (BASIS, DeviceSeedIndex, fnv_step, shifted,
                                streams, tables)
from ..ops.scan import cummax_1d, cumsum_1d
from ..ops.xdrop_walk_cuda import xdrop_walk_cuda
from ..utils import log_event
from .candidates import (Candidates, _finish_candidates,
                         generate_candidates)

_XL, _XU = ord('x'), ord('X')
NEG_STEP = -(1 << 19)       # invalid-step sentinel: int32 sums stay in range
NEG_INF = -(1 << 29)
DEFAULT_CAP = 1 << 23       # postings per stage-2 call
# bytes of (points, WC) temporaries one walk block may hold, and the
# bytes a (point, step) cell takes at the peak of a chunk (int64 gather
# indices, int32 positions and sums, boolean masks)
WALK_BYTES = 4 << 30
CELL_BYTES = 64
# steps per chunk of the plain walk: 64 was the fastest of
# 8/16/32/64/128 on an H100 (PERF.md); the JAX module's 32 was a TPU
# sweep's
WALK_CHUNK = 64


@lru_cache(maxsize=None)
def _b62_diag_np() -> np.ndarray:
    return np.array([int(B62_BYTES[i, i]) for i in range(256)], np.int32)


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def stage1_seeds(q_tok: torch.Tensor, q_len: torch.Tensor,
                 code_tbls: torch.Tensor, start: torch.Tensor, nc: int,
                 threshold: int, strms: tuple):
    """Dense seed hashing, dedup within alphabets and the self-score
    budget (reference :2645-2677).  Returns (buckets (S,B,L) int64,
    counts (S,B,L) int64): the posting count of every kept seed, 0
    elsewhere."""
    dev = q_tok.device
    B, L = q_tok.shape
    toks = q_tok.long()
    is_x = (toks == _XL) | (toks == _XU)
    lens = q_len.long()
    pos = torch.arange(L, device=dev)

    buckets, valid = [], []
    for (ai, s, klen, ones) in strms:
        codes = code_tbls[ai][toks]
        h = torch.full((B, L), BASIS, dtype=torch.int64, device=dev)
        for j in ones:
            h = fnv_step(h, shifted(codes, j, 0))
        h = fnv_step(h, s)
        bad = torch.zeros((B, L), dtype=torch.bool, device=dev)
        for j in range(klen):
            bad |= shifted(is_x, j, True)
        buckets.append(h % nc)
        valid.append(~bad & (pos[None, :] <= lens[:, None] - klen))

    # dedup (bucket, pos) across patterns within one alphabet, keep the
    # earliest stream (reference visit dict, fsearch.py:554-556)
    kept = list(valid)
    for i2, (a2, _, _, _) in enumerate(strms):
        for i1, (a1, _, _, _) in enumerate(strms[:i2]):
            if a1 == a2:
                kept[i2] = kept[i2] & ~(valid[i1]
                                        & (buckets[i1] == buckets[i2]))
    buckets = torch.stack(buckets)
    kept = torch.stack(kept)
    bk = torch.where(kept, buckets, 0)
    counts = torch.where(kept, (start[bk + 1] - start[bk]).long(), 0)

    # self-score budget: per-position posting counts, ranked by the
    # mink-window BLOSUM62 self-score desc (ties: position asc), kept
    # while the exclusive cumsum <= thr*len (integers on both sides, so
    # the host's float64 comparison is this integer one)
    mink = min(k for (_, _, k, _) in strms)
    diag_self = _on(_b62_diag_np(), dev)[toks]
    cs = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
    cs[:, 1:] = torch.cumsum(diag_self, 1, dtype=torch.int32)
    w = max(L + 1 - mink, 0)
    ksc = torch.zeros((B, L), dtype=torch.int32, device=dev)
    ksc[:, :w] = cs[:, mink:mink + w] - cs[:, :w]
    hist = counts.sum(0)
    order = torch.argsort((4096 - ksc) * 8192 + pos[None, :].int(), dim=1)
    sorted_hist = hist.gather(1, order)
    excl = torch.cumsum(sorted_hist, 1) - sorted_hist
    keep_sorted = excl <= threshold * lens[:, None]
    keep_pos = torch.zeros((B, L), dtype=torch.bool, device=dev) \
        .scatter_(1, order, keep_sorted)
    return buckets, torch.where(keep_pos[None], counts, 0)


def _walk_block(qtok_flat, db_tokens, b62, L, WC, Wmax, qrow, s_off,
                start_q, start_s, step, base, qlo, slo, qlen, slen):
    """``walk_chunked`` over one block of points: every WC-step chunk
    walks the points still alive, then drops the ones that ended."""
    dev = qrow.device
    P = qrow.shape[0]
    best = base.clone()
    best_t = torch.full((P,), -1, dtype=torch.int32, device=dev)
    if P == 0:
        return best, best_t
    t_rel = torch.arange(WC, dtype=torch.int32, device=dev)[None, :]
    n_db = db_tokens.shape[0]
    lane = torch.arange(P, device=dev)
    run_sum = base.clone()
    run_max = torch.full((P,), NEG_INF, dtype=torch.int32, device=dev)
    b, bt = best.clone(), best_t.clone()
    t0 = 0
    while True:
        t = t0 + t_rel
        qpos = start_q[:, None] + step * t
        spos = start_s[:, None] + step * t
        valid = ((qpos > qlo[:, None]) & (qpos < qlen[:, None])
                 & (spos > slo[:, None]) & (spos < slen[:, None]))
        qi = qtok_flat[qrow[:, None].long() * L
                       + qpos.clamp(0, L - 1).long()].long()
        sj = db_tokens[(s_off[:, None] + spos.long()).clamp(0, n_db - 1)]
        d = torch.where(valid, b62[qi * 256 + sj.long()], NEG_STEP)
        sums = run_sum[:, None] + torch.cumsum(d, 1, dtype=torch.int32)
        prev = torch.cat([run_sum[:, None], sums[:, :-1]], 1)
        runmax = torch.maximum(run_max[:, None],
                               torch.cummax(prev, 1).values)
        ended = (sums + XDROP < runmax) | ~valid
        # dead: a step after the first ended one (argmax finds the first)
        ends = ended.any(1)
        first_end = torch.where(ends, ended.to(torch.uint8).argmax(1), WC)
        dead = t_rel > first_end[:, None]
        alive_sums = torch.where(dead | ~valid, NEG_INF, sums)
        bc = alive_sums.amax(1)
        tc = alive_sums.argmax(1).int() + t0   # first maximum
        better = bc > b             # strict: keeps the FIRST global argmax
        b = torch.where(better, bc, b)
        bt = torch.where(better, tc, bt)
        best[lane] = b
        best_t[lane] = bt
        if t0 + WC >= Wmax:
            break
        keep = (~ends).nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        run_sum = sums[keep, -1]
        run_max = torch.maximum(run_max[keep], prev[keep].amax(1))
        (lane, qrow, s_off, start_q, start_s, qlo, slo, qlen, slen, b,
         bt) = (x[keep] for x in (lane, qrow, s_off, start_q, start_s, qlo,
                                  slo, qlen, slen, b, bt))
        t0 += WC
    return best, best_t


def walk_chunked(qtok_flat, db_tokens, b62, L, WC, Wmax, qrow, s_off,
                 start_q, start_s, step, base, qlo, slo, qlen, slen):
    """One-direction windowed x-drop walk for every point (ungap
    semantics, fsearch.py:2454-2494): each in-bounds step adds its
    substitution score; the walk stops after the first step whose running
    total drops more than XDROP below the running max, and before an
    out-of-bounds step.  Returns (best, best_t) int32: the best running
    total (at least ``base``) and the step that first reached it (-1 if
    none beat ``base``).  Equal to the JAX ``_walk_chunked`` for any WC.

    qtok_flat (B*L,) uint8, db_tokens (N,) uint8, b62 (65536,) int32;
    per point: qrow, start_q, start_s, base, qlo, slo, qlen, slen int32,
    s_off int64."""
    P = qrow.shape[0]
    pb = max(1, WALK_BYTES // (WC * CELL_BYTES))
    if P <= pb:
        return _walk_block(qtok_flat, db_tokens, b62, L, WC, Wmax, qrow,
                           s_off, start_q, start_s, step, base, qlo, slo,
                           qlen, slen)
    parts = [_walk_block(qtok_flat, db_tokens, b62, L, WC, Wmax,
                         *(x[i:i + pb] for x in (qrow, s_off, start_q,
                                                 start_s)),
                         step,
                         *(x[i:i + pb] for x in (base, qlo, slo, qlen,
                                                 slen)))
             for i in range(0, P, pb)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def walk(qtok_flat, db_tokens, b62, L, WC, Wmax, qrow, s_off, start_q,
         start_s, step, base, qlo, slo, qlen, slen):
    """``walk_chunked``'s results, by the tensors' device: CPU tensors go
    to ``walk_chunked``, every other device to the x-drop walk kernel
    (``xdrop_walk_cuda``, which reads the SW kernel's code table, not
    ``b62``, and raises on anything but CUDA tensors).  Nothing falls
    back from one to the other."""
    if qrow.device.type == 'cpu':
        return walk_chunked(qtok_flat, db_tokens, b62, L, WC, Wmax, qrow,
                            s_off, start_q, start_s, step, base, qlo, slo,
                            qlen, slen)
    return xdrop_walk_cuda(qtok_flat, db_tokens, L, Wmax, qrow, s_off,
                           start_q, start_s, step, base, qlo, slo, qlen,
                           slen)


def seg_max_scan(flags: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive max-scan of int32-range ``vals``; ``flags``
    mark segment starts (values before the first flag form a segment)."""
    packed = (cumsum_1d(flags) << 32) | (vals.long() + (1 << 31))
    return (cummax_1d(packed) & 0xFFFFFFFF) - (1 << 31)


def accept_rounds(new_seg, valid_s, p_qst, E):
    """The greedy cover chain (reference get_ungap_scores drain,
    fsearch.py:2679-2724) as parallel rounds: each round accepts the
    first still-uncovered point of every group, and the cover becomes
    its right-walk end E.  Returns (accepted, qlo_rec, rounds): qlo_rec
    is the cover at acceptance (-1 marks a group's first point), in
    ``p_qst``'s integer type."""
    dev = p_qst.device
    C = p_qst.shape[0]
    acc = torch.zeros(C, dtype=torch.bool, device=dev)
    cov = torch.full((C,), -1, dtype=p_qst.dtype, device=dev)
    qlo_rec = torch.zeros(C, dtype=p_qst.dtype, device=dev)
    rounds = 0
    while True:
        cand = valid_s & ~acc & (p_qst > cov)
        ci = cand.long()
        excl = cumsum_1d(ci) - ci
        segbase = seg_max_scan(new_seg, torch.where(new_seg, excl, -1))
        firstc = cand & (excl == segbase)
        if not bool(firstc.any()):
            return acc, qlo_rec, rounds
        rounds += 1
        covE = seg_max_scan(new_seg, torch.where(firstc, E, -1))
        acc |= firstc
        qlo_rec = torch.where(firstc, cov, qlo_rec)
        cov = torch.maximum(cov, covE.to(cov.dtype))


def accept(new_seg, valid_s, p_qst, E):
    """``accept_rounds``' results by the tensors' device, with ``rounds``
    a 0-d int32 tensor there: CPU tensors go to ``accept_rounds``, every
    other device to the accept-rounds kernel (``accept_rounds_cuda``, one
    launch and no host read; it raises on anything but CUDA tensors).
    Nothing falls back from one to the other."""
    if p_qst.device.type == 'cpu':
        acc, qlo_rec, rounds = accept_rounds(new_seg, valid_s, p_qst, E)
        return acc, qlo_rec, torch.tensor(rounds, dtype=torch.int32)
    return accept_rounds_cuda(new_seg, valid_s, p_qst, E)


def stage2_expand_chain(buckets, counts, q_tok, q_len, start, sid, sst,
                        db_tokens, db_offsets, total: int, WC: int,
                        clock: StageClock, stats: dict) -> torch.Tensor:
    """Posting expansion, packed-key grouping and chain scoring for one
    row block.  Returns a (4, n) int64 tensor of (qrow, sid, diag, chain
    score) for the (query, subject, diagonal) groups whose score passes
    ``MIN_CHAIN_SCORE`` (the first step of ``_finish_candidates``, taken
    here so that only those cross PCIe).  Adds its group, walk and round
    counts to ``stats``."""
    dev = q_tok.device
    S, B, L = buckets.shape
    c_flat = counts.reshape(-1)
    cum = cumsum_1d(c_flat)                              # inclusive
    excl = cum - c_flat
    o = torch.arange(total, dtype=torch.int64, device=dev)
    seed_of = torch.searchsorted(cum, o, right=True).clamp_(0, S * B * L - 1)
    within = o - excl[seed_of]
    slot = (start[buckets.reshape(-1)[seed_of]].long() + within) \
        .clamp_(0, sid.shape[0] - 1)
    qst_o = seed_of % L
    # packed 61-bit key: qrow(13) sid(21) diag+8192(14) qst(13)
    key = (((((seed_of % (B * L)) // L) << 21 | sid[slot].long()) << 14)
           | (qst_o - sst[slot].long() + 8192)) << 13 | qst_o
    del seed_of, within, slot, o, excl, cum
    key_s = torch.sort(key).values
    del key
    gkey = key_s >> 13
    new_group = torch.ones(total, dtype=torch.bool, device=dev)
    new_group[1:] = gkey[1:] != gkey[:-1]
    del gkey
    gid = cumsum_1d(new_group) - 1
    fkey = key_s[new_group]
    n_groups = fkey.shape[0]

    # chain scoring over points: (1) one right walk for every point (its
    # bounds never depend on the cover, except a group's first point's);
    # (2) the greedy cover as parallel rounds over the right ends; (3)
    # one left walk for every accepted point from its recorded cover
    qtok_flat = q_tok.reshape(-1)
    b62 = scoring_tables(dev)['sub_flat']
    p_qrow = (key_s >> 48).int().clamp_(0, B - 1)
    last_sid = db_offsets.shape[0] - 2
    p_sid = ((key_s >> 27) & ((1 << 21) - 1)).clamp_(0, last_sid)
    p_diag = (((key_s >> 13) & ((1 << 14) - 1)) - 8192).int()
    p_qst = (key_s & 8191).int()
    p_soff = db_offsets[p_sid]
    p_slen = (db_offsets[p_sid + 1] - p_soff).int()
    p_qlen = q_len[p_qrow.long()].int()
    first = new_group
    # duplicate (group, qst) postings contribute exactly 0 (the twin's
    # cover always absorbs them): only the first of equal keys walks
    live = first.clone()
    live[1:] |= key_s[1:] != key_s[:-1]
    s0 = p_qst - p_diag
    clock.mark('expand_sort')

    W = L + 1
    li = live.nonzero().squeeze(1)
    zero = torch.zeros(li.shape[0], dtype=torch.int32, device=dev)
    fl = first[li]
    # right-walk lower bounds: 0 for a group's first point (position 0 is
    # excluded, the reference's 1-based walk); vacuous otherwise
    br, tr = walk(qtok_flat, db_tokens, b62, L, WC, W, p_qrow[li],
                  p_soff[li], p_qst[li], s0[li], 1, zero,
                  torch.where(fl, 0, -1).int(),
                  torch.where(fl, 0, -(1 << 30)).int(),
                  p_qlen[li], p_slen[li])
    best_r = torch.zeros(total, dtype=torch.int32, device=dev)
    t_r = torch.full((total,), -1, dtype=torch.int32, device=dev)
    best_r[li] = br
    t_r[li] = tr
    E = torch.where(t_r >= 0, p_qst + t_r, p_qst)
    clock.mark('right_walk')

    acc, qlo_rec, rounds = accept(new_group, live, p_qst, E)
    clock.mark('accept')

    # left walks for the accepted points only (``nonzero`` keeps them in
    # ascending order: the JAX module's stable compaction)
    ai = acc.nonzero().squeeze(1)
    qlo_a = qlo_rec[ai]
    best_c, _ = walk(
        qtok_flat, db_tokens, b62, L, WC, W, p_qrow[ai], p_soff[ai],
        p_qst[ai] - 1, s0[ai] - 1, -1, best_r[ai],
        qlo_a.clamp(min=0), torch.where(qlo_a < 0, 0, qlo_a - p_diag[ai]),
        p_qlen[ai], p_slen[ai])
    totals = torch.zeros(n_groups, dtype=torch.int32, device=dev) \
        .index_add_(0, gid[ai], best_c)
    ok = totals >= MIN_CHAIN_SCORE
    fkey = fkey[ok]
    out = torch.stack([fkey >> 48, (fkey >> 27) & ((1 << 21) - 1),
                       ((fkey >> 13) & ((1 << 14) - 1)) - 8192,
                       totals[ok].long()])
    clock.mark('left_walk')
    for k, v in (('groups', n_groups), ('right_walks', li.shape[0]),
                 ('left_walks', ai.shape[0])):
        stats[k] = stats.get(k, 0) + v
    # the most rounds over the row blocks, kept on the engine's device
    # and read once, where the engine logs its event
    stats['accept_rounds'] = (torch.maximum(stats['accept_rounds'], rounds)
                              if 'accept_rounds' in stats else rounds)
    return out


_CACHE_LOCK = threading.Lock()
_DB_CACHE: dict = {}


def _device_db(db: SeqDB, device: torch.device):
    """The reference tokens and offsets on ``device``; one db is held, on
    each device that asked for it (the multi-db shards' devices)."""
    key = (id(db), str(device))
    with _CACHE_LOCK:
        ent = _DB_CACHE.get(key)
        if ent is None or ent[0]() is not db:
            ent = (weakref.ref(db), _on(db.tokens, device),
                   _on(db.offsets.astype(np.int64), device))
            for k in [k for k, v in _DB_CACHE.items() if v[0]() is not db]:
                del _DB_CACHE[k]
            _DB_CACHE[key] = ent
        return ent[1], ent[2]


def _device_index(index: SeedIndex, device: torch.device):
    """(start, sid, sst) int32 on ``device``: the tensors a device build
    left on the index when it lies on ``device``, else copies of its host
    arrays, cached on the index."""
    device = indexed(device)
    if isinstance(index, DeviceSeedIndex) and indexed(index.device) == device:
        return tuple(index.tensors[k] for k in ('start', 'sid', 'sst'))
    with _CACHE_LOCK:
        ent = getattr(index, '_torch_arrays', None)
        if ent is None or ent[0] != device:
            ent = (device, tuple(
                _on(a.astype(np.int32), device)
                for a in (index.start, index.sid, index.sst)))
            index._torch_arrays = ent
        return ent[1]


def device_path_supported(q_tokens: np.ndarray, db: SeqDB,
                          index: SeedIndex) -> bool:
    """Packed-key range: query batch and padded length < 2^13, subject
    ids < 2^21, and |diagonal| < 2^13 — the longest db sequence must stay
    <= 8192 residues."""
    B, L = q_tokens.shape
    max_slen = int((db.offsets[1:] - db.offsets[:-1]).max()) if len(db) \
        else 0
    return (B < (1 << 13) and L <= (1 << 13) and len(db) < (1 << 21)
            and max_slen <= 8192)


def row_blocks(row_tot: np.ndarray, cap: int) -> list:
    """Greedy contiguous query-row blocks of at most ``cap`` postings
    (a single row over the cap is its own block)."""
    blocks, lo, B = [], 0, len(row_tot)
    while lo < B:
        hi, acc = lo, 0
        while hi < B and acc + row_tot[hi] <= cap:
            acc += int(row_tot[hi])
            hi += 1
        hi = max(hi, lo + 1)
        blocks.append((lo, hi))
        lo = hi
    return blocks


def generate_candidates_device(q_tokens: np.ndarray, q_lengths: np.ndarray,
                               db: SeqDB, index: SeedIndex,
                               alphabets: list, ssps: str,
                               device: torch.device | None = None
                               ) -> Candidates:
    """Drop-in replacement for ``candidates.generate_candidates`` that
    runs on ``device`` (default ``get_device()``).  Falls back to the
    host engine, with a ``device_candidates_fallback`` event, when the
    packed-key ranges do not hold or one query's postings exceed the
    cap."""
    out = _chain_groups(q_tokens, q_lengths, db, index, alphabets, ssps,
                        device, fetch=True)
    if isinstance(out, Candidates):
        return out
    return _finish_candidates(*out)


def generate_candidates_tensors(q_tokens: np.ndarray,
                                q_lengths: np.ndarray, db: SeqDB,
                                index: SeedIndex, alphabets: list,
                                ssps: str,
                                device: torch.device | None = None
                                ) -> Candidates:
    """``generate_candidates_device`` without the fetch: the same
    Candidates as int64 tensors on ``device``, finished there
    (``finish_candidates_tensors``).  A host fallback's arrays are
    copied to ``device``."""
    device = get_device() if device is None else torch.device(device)
    out = _chain_groups(q_tokens, q_lengths, db, index, alphabets, ssps,
                        device, fetch=False)
    if isinstance(out, Candidates):
        return Candidates(*(
            torch.as_tensor(np.asarray(getattr(out, f.name), np.int64),
                            device=device)
            for f in dataclasses.fields(out)))
    return finish_candidates_tensors(*out)


def finish_candidates_tensors(g_qrow: torch.Tensor, g_sid: torch.Tensor,
                              g_diag: torch.Tensor, totalsc: torch.Tensor
                              ) -> Candidates:
    """``candidates._finish_candidates`` in torch, on the tensors' device:
    the min-score gate, the best chain per (query, subject) by the same
    packed 62-bit key and a stable sort (or, where the key's ranges do
    not hold, successive stable sorts in ``np.lexsort``'s order), and the
    band anchor.  Equal to the numpy function, array for array."""
    ok = totalsc >= MIN_CHAIN_SCORE
    g_qrow, g_sid, g_diag, totalsc = (g_qrow[ok].long(), g_sid[ok].long(),
                                      g_diag[ok].long(), totalsc[ok].long())
    if totalsc.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int64, device=totalsc.device)
        return Candidates(z, z, z, z, z)
    cap = 1 << 17
    lims = torch.stack([g_sid.max(), g_qrow.max(), totalsc.max()]).tolist()
    if lims[0] < (1 << 21) and lims[1] < (1 << 13) and lims[2] < cap:
        key = ((((g_qrow << 21) | g_sid) << 17) | (cap - 1 - totalsc)
               ) << 11 | ((g_diag + 8192) & 0x7FF)
        order = torch.sort(key, stable=True).indices
    else:
        order = stable_lexsort((g_diag, -totalsc, g_sid, g_qrow))
    g_qrow, g_sid, g_diag, totalsc = (g_qrow[order], g_sid[order],
                                      g_diag[order], totalsc[order])
    first = torch.ones(g_qrow.shape[0], dtype=torch.bool,
                       device=g_qrow.device)
    first[1:] = (g_qrow[1:] != g_qrow[:-1]) | (g_sid[1:] != g_sid[:-1])
    g_qrow, g_sid, g_diag, totalsc = (g_qrow[first], g_sid[first],
                                      g_diag[first], totalsc[first])
    band_q = torch.where(g_diag > 0, g_diag, 0)
    band_s = torch.where(g_diag > 0, 0, -g_diag)
    return Candidates(g_qrow, g_sid, totalsc, band_q, band_s)


def stable_lexsort(keys) -> torch.Tensor:
    """``np.lexsort(keys)`` of 1-D tensors (the last key primary): one
    stable sort a key, from the first (least significant) to the last."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _chain_groups(q_tokens, q_lengths, db, index, alphabets, ssps, device,
                  fetch: bool):
    """Stages 1 and 2 of the engine for one wave and chunk: the
    (qrow, sid, diag, chain score) groups that pass the min-score gate,
    numpy arrays when ``fetch`` else int64 tensors on ``device``, or the
    finished host ``Candidates`` of a fallback or of a wave without
    postings.  Logs the ``device_candidates`` event."""
    if not device_path_supported(q_tokens, db, index):
        log_event('device_candidates_fallback', reason='range',
                  shape=list(q_tokens.shape))
        return generate_candidates(q_tokens, q_lengths, db, index,
                                   alphabets, ssps)
    device = get_device() if device is None else torch.device(device)
    clock = StageClock(device)
    B, L = q_tokens.shape
    strms = streams(tuple(alphabets), ssps)
    start, sid, sst = _device_index(index, device)
    db_tokens, db_offsets = _device_db(db, device)
    q_dev = _on(q_tokens, device)
    qlen_dev = _on(q_lengths.astype(np.int32), device)
    clock.mark('upload')
    buckets, counts = stage1_seeds(q_dev, qlen_dev,
                                   tables(tuple(alphabets), device), start,
                                   index.nc, int(index.threshold), strms)
    row_tot = counts.sum((0, 2)).cpu().numpy()
    clock.mark('stage1')
    total = int(row_tot.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return Candidates(z, z, z, z, z)

    cap = int(os.environ.get('SWIFTORTHO_DEVICE_CAND_CAP', str(DEFAULT_CAP)))
    if int(row_tot.max()) > cap:
        log_event('device_candidates_fallback', reason='cap',
                  max_query_postings=int(row_tot.max()), cap=cap)
        return generate_candidates(q_tokens, q_lengths, db, index,
                                   alphabets, ssps)
    blocks = row_blocks(row_tot, cap)
    if len(blocks) > 1:
        log_event('device_candidates_chunked', blocks=len(blocks),
                  postings=total, cap=cap)

    parts, stats = [], {}
    for (blo, bhi) in blocks:
        btot = int(row_tot[blo:bhi].sum())
        if btot == 0:
            continue
        out4 = stage2_expand_chain(
            buckets[:, blo:bhi], counts[:, blo:bhi], q_dev[blo:bhi],
            qlen_dev[blo:bhi], start, sid, sst, db_tokens, db_offsets,
            btot, WALK_CHUNK, clock, stats)
        if fetch:
            out4 = out4.cpu().numpy()
        out4[0] += blo
        parts.append(out4)
        clock.mark('fetch')
    groups = (np.concatenate(parts, axis=1) if fetch
              else torch.cat(parts, 1))
    stats['accept_rounds'] = int(stats['accept_rounds'])
    log_event('device_candidates', device=str(device), queries=B, L=L,
              postings=total, max_row_postings=int(row_tot.max()),
              blocks=len(blocks), passing_groups=int(groups.shape[1]),
              **stats, **clock.rounded())
    return tuple(groups)
