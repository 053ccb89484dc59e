"""Candidate generation: query seeding, posting expansion, diagonal
chaining, ungapped x-drop scoring.

Behavioral contract: reference ``Fasta.find_msav_m`` (lib/fsearch.py:2645-2724)
with ``ungap``/``get_ungap_scores`` (fsearch.py:2454-2510):

- per-position self-score windows of length mink (rolling BLOSUM62 diagonal);
- seed-budget heuristic: positions sorted by self-score desc, kept while the
  exclusive cumulative posting count <= threshold * len(query);
- postings grouped by (subject, diagonal) — the live path passes kbound=1 to
  find_msav_m so groups are *exact* diagonals, and the LIS over a sorted
  exact diagonal is just per-position dedup;
- chain score = sum of two-way ungapped x-drop extensions over the chain
  points, each left-bounded by the previous extension's end
  (get_ungap_scores); a seed at query/subject position 0 contributes 0
  (ungap's strict `lo < pos` bound, fsearch.py:2466);
- candidates gated at chain score >= 25, best chain per subject, band
  anchor = the chain diagonal (guess_start over same-diagonal points),
  ranked by score desc.

Chain points already covered by a previous extension contribute exactly 0
in the reference (the off-shift at fsearch.py:2460-2462 moves the start onto
the strict qlo bound, so neither walk runs) — skipping them is exact.

Chain scoring runs in the native C++ engine (native/chain.cpp — exact,
unbounded extensions, ~13x faster) when a compiler is available; the
vectorized numpy fallback here windows extensions at EXT_CAP=1024 residues
per direction and caps extension rounds at MAX_ROUNDS per group, which can
only lower the chain score of ultra-long or highly fragmented diagonals
and perturb candidate *ranking* in rare cases.

All heavy steps are vectorized numpy over every (query, chunk) batch at
once; a lockstep sweep handles the sequential point-chaining.

Copied from ``swiftortho_tpu/search/candidates.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import B62_BYTES, MIN_CHAIN_SCORE, XDROP
from ..io_fasta import SeqDB
from ..ops.index import SeedIndex
from ..ops.seeds import hash_seeds_batch

EXT_CAP = 1024      # max residues per x-drop direction (see docstring)
MAX_ROUNDS = 256    # fallback-path cap on extension rounds per group
                    # (native path is uncapped; see module docstring)

_B62_I16 = B62_BYTES.astype(np.int16)


@dataclass
class Candidates:
    """Ranked alignment candidates for a query batch (flat arrays)."""
    qrow: np.ndarray      # (N,) query row in the batch
    subject: np.ndarray   # (N,) global subject id
    score: np.ndarray     # (N,) chain score
    band_q: np.ndarray    # (N,) band start in query  (guess_start qi)
    band_s: np.ndarray    # (N,) band start in subject (guess_start qj)


@dataclass
class WaveSeeds:
    """Chunk-invariant per-wave precomputes, shared across the reference
    chunk sweep (fsearch.py:2988-3021 re-derives them per chunk because
    each fsearch-c process owns one chunk; here one wave visits every
    chunk, so hashing the wave's seeds and sorting its budget windows
    once per CHUNK is pure redundancy — both depend only on the wave's
    masked tokens plus (nc, mink), which are identical across chunks of
    one search).  Callers must check ``matches(index)`` before reuse; a
    mismatched chunk (e.g. foreign on-disk DB with its own nc) falls
    back to a fresh computation."""
    nc: int
    mink: int
    rows: np.ndarray      # (S,) seed query rows (concatenated alphabets)
    buckets: np.ndarray   # (S,) hash buckets (h % nc)
    qst: np.ndarray       # (S,) seed query positions
    order: np.ndarray     # (B, nwin) budget sort order (see budget_order)

    def matches(self, index: SeedIndex) -> bool:
        return self.nc == index.nc and self.mink == index.mink


def budget_order(tokens: np.ndarray, mink: int) -> np.ndarray:
    """Per-row sort order of seed positions by (self-score desc, pos asc)
    — the chunk-invariant half of the reference's seed-budget heuristic
    (fsearch.py:2667-2677; the ranking depends only on the query)."""
    B, L = tokens.shape
    diag_self = _B62_I16[tokens, tokens].astype(np.int64)   # (B, L)
    cs = np.zeros((B, L + 1), dtype=np.int64)
    np.cumsum(diag_self, axis=1, out=cs[:, 1:])
    nwin = L - mink + 1
    kscs = cs[:, mink:] - cs[:, :-mink] if nwin > 0 else np.zeros((B, 0))
    if nwin <= 0:
        return np.zeros((B, 1), dtype=np.int64)
    return np.lexsort((np.broadcast_to(np.arange(nwin), kscs.shape),
                       -kscs))


def make_wave_seeds(q_tokens: np.ndarray, q_lengths: np.ndarray,
                    alphabets: list, ssps: str, nc: int,
                    mink: int) -> WaveSeeds:
    """Build the chunk-invariant wave context (seed hashes + budget
    order) once; generate_candidates reuses it for every chunk."""
    from ..constants import reduced_alphabet_table

    rows_l, buckets_l, qst_l = [], [], []
    for alpha in alphabets:
        tbl = reduced_alphabet_table(alpha)
        r, b, p = hash_seeds_batch(q_tokens, q_lengths, tbl, ssps, nc)
        rows_l.append(r)
        buckets_l.append(b)
        qst_l.append(p)
    return WaveSeeds(nc=nc, mink=mink,
                     rows=np.concatenate(rows_l),
                     buckets=np.concatenate(buckets_l),
                     qst=np.concatenate(qst_l),
                     order=budget_order(q_tokens, mink))


def _self_score_budget(tokens: np.ndarray, lengths: np.ndarray,
                       rows: np.ndarray, qst: np.ndarray,
                       counts: np.ndarray, mink: int,
                       threshold: float,
                       order: np.ndarray | None = None) -> np.ndarray:
    """Reference's seed-budget heuristic (fsearch.py:2645-2677).

    Returns a bool keep-mask over the seed arrays (rows/qst/counts).
    Positions are ranked per query by the BLOSUM62 self-score of their
    mink-window (desc; ties by position asc — the reference's qsort is
    unstable here), kept while the exclusive cumsum of posting counts
    stays <= threshold * qlen.

    ``order``: optional precomputed ``budget_order(tokens, mink)`` —
    the chunk-invariant ranking, cached per wave by WaveSeeds.
    """
    B, L = tokens.shape
    nwin = L - mink + 1
    if nwin <= 0:
        return np.zeros(len(rows), dtype=bool)
    if order is None:
        order = budget_order(tokens, mink)
    budgets = threshold * lengths.astype(np.float64)

    try:
        # threaded native sweep (groupby.cpp budget_keep): per row, hist
        # fill + ordered exclusive cumsum + keep mask — identical to the
        # numpy block below (tests pin it)
        from ..native import budget_keep_native
        return budget_keep_native(rows, qst, counts, order, budgets, B,
                                  nwin)
    except Exception:
        pass        # no compiler: vectorized numpy

    # per-seed position histogram: total postings at each (row, qst)
    hist = np.zeros((B, nwin), dtype=np.int64)
    np.add.at(hist, (rows, qst), counts)

    keep_pos = np.zeros((B, nwin), dtype=bool)
    sorted_hist = np.take_along_axis(hist, order, axis=1)
    excl = np.zeros_like(sorted_hist)
    np.cumsum(sorted_hist[:, :-1], axis=1, out=excl[:, 1:])
    keep_sorted = excl <= budgets[:, None]
    np.put_along_axis(keep_pos, order, keep_sorted, axis=1)
    return keep_pos[rows, qst]


def _xdrop_window(dvals: np.ndarray, valid: np.ndarray, base: np.ndarray):
    """Vectorized one-direction x-drop over (G, W) windows.

    dvals: substitution scores in walk order; valid: in-bounds mask;
    base: (G,) starting score (0 for the right phase, best_r for left).
    Returns (best, best_t, alive): running max (>= base), index of the max
    step (-1 if the max is the base itself), and whether the walk reached
    the window end without stopping (candidate for re-run with a longer
    window).  Walk semantics match ungap (fsearch.py:2454-2494): each
    in-bounds step adds its score; stop *after* the first step whose
    total drops more than XDROP below the running max; out-of-bounds
    stops before the step.
    """
    G, W = dvals.shape
    d = np.where(valid, dvals.astype(np.int64), np.int64(-10 ** 9))
    sums = base[:, None] + np.cumsum(d, axis=1)
    runmax = np.maximum.accumulate(
        np.concatenate([base[:, None], sums[:, :-1]], axis=1), axis=1)
    stopped = sums + XDROP < runmax          # true at the breaking step
    ended = stopped | ~valid
    dead = np.concatenate([np.zeros((G, 1), bool),
                           np.logical_or.accumulate(ended,
                                                    axis=1)[:, :-1]], axis=1)
    alive_sums = np.where(dead | ~valid, np.int64(-10 ** 9), sums)
    best = np.maximum(base, alive_sums.max(axis=1))
    best_t = np.where(best > base, np.argmax(alive_sums, axis=1), -1)
    alive = ~ended.any(axis=1)
    return best, best_t, alive


def generate_candidates(q_tokens: np.ndarray, q_lengths: np.ndarray,
                        db: SeqDB, index: SeedIndex, alphabets: list,
                        ssps: str,
                        wave_seeds: WaveSeeds | None = None) -> Candidates:
    """Candidates for a padded query batch against one index chunk.

    ``wave_seeds``: chunk-invariant precomputes (make_wave_seeds); used
    only when it matches this chunk's (nc, mink) — output is identical
    either way."""
    import os as _os
    import time as _time
    _prof = _os.environ.get('SWIFTORTHO_PROF_CAND', '') not in ('', '0')
    _t0 = _time.time() if _prof else 0.0
    B, L = q_tokens.shape

    if wave_seeds is not None and wave_seeds.matches(index):
        rows, buckets, qst = (wave_seeds.rows, wave_seeds.buckets,
                              wave_seeds.qst)
        order = wave_seeds.order
    else:
        ws = make_wave_seeds(q_tokens, q_lengths, alphabets, ssps,
                             index.nc, index.mink)
        rows, buckets, qst, order = ws.rows, ws.buckets, ws.qst, ws.order

    _t1 = _time.time() if _prof else 0.0
    counts = index.bucket_counts(buckets)
    _t2 = _time.time() if _prof else 0.0
    keep = _self_score_budget(q_tokens, q_lengths, rows, qst, counts,
                              index.mink, index.threshold, order=order)
    _t3 = _time.time() if _prof else 0.0
    rows, buckets, qst = rows[keep], buckets[keep], qst[keep]
    counts = counts[keep]

    # ---- posting expansion (CSR ranges -> flat posting list) ----
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return Candidates(z, z, z, z, z)
    starts, _ = index.posting_range(buckets)
    if _prof:
        _t4 = _time.time()
        import sys as _sys
        print('[cand prof] ctx %.2f counts %.2f budget %.2f '
              'filter+ranges %.2f' % (_t1 - _t0, _t2 - _t1, _t3 - _t2,
                                      _t4 - _t3), file=_sys.stderr,
              flush=True)

    try:
        # fused native engine (groupby.cpp candidates_fused): expansion +
        # grouping + exact chain scoring + gate + best-per-subject in one
        # threaded pass, returning only surviving candidates — byte-
        # identical to the staged paths below (which remain as fallbacks
        # and as independent oracles for the parity tests)
        from ..native import candidates_fused_native
        _t5 = _time.time() if _prof else 0.0
        g_qrow, g_sid, g_score, d_fold, d_raw = candidates_fused_native(
            rows, qst, counts, starts, index.sid, index.sst, B,
            q_tokens, db.tokens, db.offsets,
            q_lengths.astype(np.int64), XDROP, MIN_CHAIN_SCORE)
        if _prof:
            import sys as _sys
            print('[cand prof] engine %.2f (wall)'
                  % (_time.time() - _t5), file=_sys.stderr, flush=True)
        if len(g_score) == 0:
            z = np.zeros(0, dtype=np.int64)
            return Candidates(z, z, z, z, z)
        # tie-break column choice: exactly _finish_candidates' conditions
        if (g_sid.max() < (1 << 21) and g_qrow.max() < (1 << 13)
                and g_score.max() < (1 << 17)):
            g_diag = d_fold
        else:
            g_diag = d_raw
        band_q = np.where(g_diag > 0, g_diag, 0)
        band_s = np.where(g_diag > 0, 0, -g_diag)
        return Candidates(g_qrow, g_sid, g_score, band_q, band_s)
    except Exception:
        pass        # no compiler: staged native / numpy paths below

    grouped = False
    try:
        # native expansion + sort + dedup + grouping (groupby.cpp):
        # identical semantics, threaded over queries
        from ..native import expand_group_native
        (p_qst, grp_start, grp_size, g_qrow, g_sid, g_diag) = \
            expand_group_native(rows, qst, counts, starts,
                                index.sid, index.sst, B)
        n_groups = len(g_qrow)
        grouped = True
    except Exception:
        pass        # no compiler: vectorized numpy below

    if not grouped:
        seed_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        excl = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=excl[1:])
        within = np.arange(total, dtype=np.int64) - excl[seed_of]
        slot = starts[seed_of] + within
        sid = index.sid[slot].astype(np.int64)
        sst = index.sst[slot].astype(np.int64)
        p_qrow = rows[seed_of]
        p_qst = qst[seed_of]

        # ---- exact-diagonal grouping + dedup ----
        diag = p_qst - sst
        # single packed sort key: (qrow, sid, diag+8192, qst) — bounds:
        # qrow < 2^13 (driver batch size), sid < 2^21, |diag| < 2^13,
        # qst < 2^13 (padded query length); lexsort fallback otherwise
        if (len(sid) and sid.max() < (1 << 21) and p_qrow.max() < (1 << 13)
                and q_tokens.shape[1] <= (1 << 13)
                and diag.min() >= -8192 and diag.max() < 8192):
            key = ((((p_qrow << 21) | sid) << 14 | (diag + 8192)) << 13
                   | p_qst)
            order = np.argsort(key, kind='stable')
        else:
            order = np.lexsort((p_qst, diag, sid, p_qrow))
        p_qrow, sid, diag, p_qst, sst = (
            p_qrow[order], sid[order], diag[order], p_qst[order],
            sst[order])
        same = np.zeros(total, dtype=bool)
        same[1:] = ((p_qrow[1:] == p_qrow[:-1]) & (sid[1:] == sid[:-1])
                    & (diag[1:] == diag[:-1]))
        new_group = ~same
        dup = same.copy()
        dup[1:] &= (p_qst[1:] == p_qst[:-1])
        keep = ~dup
        p_qrow, sid, diag, p_qst, sst = (
            p_qrow[keep], sid[keep], diag[keep], p_qst[keep], sst[keep])
        new_group = new_group[keep]
        gid = np.cumsum(new_group) - 1
        n_groups = int(gid[-1]) + 1

        grp_start = np.flatnonzero(new_group)
        grp_size = np.diff(np.append(grp_start, len(gid)))
        g_qrow = p_qrow[grp_start]
        g_sid = sid[grp_start]
        g_diag = diag[grp_start]

    # ---- chain scoring over groups ----
    s_off = db.offsets[g_sid]
    s_len = (db.offsets[g_sid + 1] - s_off).astype(np.int64)
    q_len = q_lengths[g_qrow].astype(np.int64)

    try:
        from ..native import chain_scores_native
        totalsc = chain_scores_native(
            q_tokens, db.tokens, grp_start, grp_size, g_qrow, g_diag,
            s_off, s_len, q_len, p_qst, XDROP)
        return _finish_candidates(g_qrow, g_sid, g_diag, totalsc)
    except Exception:   # no compiler / build failure: vectorized fallback
        from ..utils import warn_fallback
        warn_fallback(
            'chain_scores',
            'native chain engine unavailable; numpy x-drop windows capped '
            'at EXT_CAP=%d residues / MAX_ROUNDS=%d' % (EXT_CAP, MAX_ROUNDS),
            exact=False)

    totalsc = np.zeros(n_groups, dtype=np.int64)
    cover_x = np.full(n_groups, -2 ** 60, dtype=np.int64)  # qlo bound (excl)
    ptr = grp_start.copy()
    grp_end = grp_start + grp_size
    first_ext = np.ones(n_groups, dtype=bool)

    W = EXT_CAP
    tok = db.tokens
    for _ in range(MAX_ROUNDS):
        # drain covered points first (they contribute exactly 0): cheap
        # pointer advances, no windows — so every walk round below works
        # on a real extension and round counts stay near the number of
        # distinct homologous segments per diagonal
        while True:
            act = ptr < grp_end
            if not act.any():
                break
            p_now = np.where(act, p_qst[np.minimum(ptr, len(p_qst) - 1)], 0)
            covered = act & ~first_ext & (p_now <= cover_x)
            if not covered.any():
                break
            ptr[covered] += 1
        act = ptr < grp_end
        if not act.any():
            break
        ga_all = np.flatnonzero(act)
        if len(ga_all) == 0:
            continue
        for gs in range(0, len(ga_all), 1 << 18):   # bound window memory
            ga = ga_all[gs:gs + (1 << 18)]
            p0 = p_qst[ptr[ga]]
            s0 = p0 - g_diag[ga]                 # subject position of seed
            qlo = np.where(first_ext[ga], 0, cover_x[ga])
            slo = np.where(first_ext[ga], 0, qlo - g_diag[ga])
            qlen, slen = q_len[ga], s_len[ga]

            def walk(rows, start_q, start_s, step, base, width):
                """One-direction windowed x-drop for group rows `rows`."""
                t = np.arange(width, dtype=np.int64)[None, :]
                qpos = start_q[:, None] + step * t
                spos = start_s[:, None] + step * t
                valid = ((qpos > qlo[rows][:, None])
                         & (qpos < qlen[rows][:, None])
                         & (spos > slo[rows][:, None])
                         & (spos < slen[rows][:, None]))
                qi = q_tokens[g_qrow[ga[rows]][:, None],
                              np.clip(qpos, 0, L - 1)]
                sj = tok[np.clip(s_off[ga[rows]][:, None] + spos, 0,
                                 len(tok) - 1)]
                return _xdrop_window(_B62_I16[qi, sj], valid, base)

            def walk_escalated(start_q, start_s, step, base):
                rows = np.arange(len(ga))
                best, t_at, alive = walk(rows, start_q, start_s, step,
                                         base, 64)
                esc = np.flatnonzero(alive)
                if len(esc):      # rare: true homologs extending far
                    b2, t2, _ = walk(esc, start_q[esc], start_s[esc],
                                     step, base[esc], W)
                    best[esc] = b2
                    t_at[esc] = t2
                return best, t_at

            zero = np.zeros(len(ga), dtype=np.int64)
            best_r, t_r = walk_escalated(p0, s0, 1, zero)
            max_qed = np.where(t_r >= 0, p0 + t_r, p0)
            best, _ = walk_escalated(p0 - 1, s0 - 1, -1, best_r)

            totalsc[ga] += best
            cover_x[ga] = max_qed
            first_ext[ga] = False
            ptr[ga] += 1

    return _finish_candidates(g_qrow, g_sid, g_diag, totalsc)


def _finish_candidates(g_qrow, g_sid, g_diag, totalsc) -> Candidates:
    """Gate at min chain score, keep best chain per (query, subject),
    derive the band anchor."""
    ok = totalsc >= MIN_CHAIN_SCORE
    g_qrow, g_sid, g_diag, totalsc = (g_qrow[ok], g_sid[ok], g_diag[ok],
                                      totalsc[ok])
    if len(totalsc) == 0:
        z = np.zeros(0, dtype=np.int64)
        return Candidates(z, z, z, z, z)
    # keep max score per (qrow, subject); reference keeps the first
    # encountered on ties (dict iteration) — we keep the smallest diagonal
    cap = np.int64(1 << 17)
    if (g_sid.max() < (1 << 21) and g_qrow.max() < (1 << 13)
            and totalsc.max() < cap):
        # packed 62-bit key: (qrow:13, sid:21, score-desc:17, diag:11);
        # the diag component only breaks score ties (folded to 11 bits —
        # any deterministic tie-break is valid here, the reference's own
        # dict-iteration order is not reproducible)
        key = ((((g_qrow << 21) | g_sid) << 17) | (cap - 1 - totalsc)
               ) << 11 | ((g_diag + 8192) & 0x7FF)
        order = np.argsort(key, kind='stable')
    else:
        order = np.lexsort((g_diag, -totalsc, g_sid, g_qrow))
    g_qrow, g_sid, g_diag, totalsc = (g_qrow[order], g_sid[order],
                                      g_diag[order], totalsc[order])
    first = np.ones(len(g_qrow), dtype=bool)
    first[1:] = (g_qrow[1:] != g_qrow[:-1]) | (g_sid[1:] != g_sid[:-1])
    g_qrow, g_sid, g_diag, totalsc = (g_qrow[first], g_sid[first],
                                      g_diag[first], totalsc[first])

    # band anchor: guess_start over the chain diagonal (fsearch.py:2544-2553)
    # dist = mean(sst - qst) = -diag; dist > 0 -> (0, dist) else (-dist, 0)
    band_q = np.where(g_diag > 0, g_diag, 0)
    band_s = np.where(g_diag > 0, 0, -g_diag)
    return Candidates(g_qrow, g_sid, totalsc, band_q, band_s)
