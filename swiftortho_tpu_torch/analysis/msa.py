"""Multiple sequence alignment (center-star, built on global pairwise DP).

The reference shells out to famsa/mafft/muscle for family alignments
(scripts/rbh2phy.py:203-214); this framework ships its own aligner so the
phylogeny path has no external dependencies.  Center-star MSA: the center
is the member with the highest summed pairwise score; every other member
is globally aligned to the center and gap-merged into the star profile.

Global pairwise alignment is affine-gap Needleman-Wunsch (Gotoh) over
BLOSUM62 with free end-gaps disabled — suitable for the single-family,
similar-length protein sets this is used on.

Copied from ``swiftortho_tpu/analysis/msa.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..constants import B62_BYTES, GAP_EXTEND, GAP_OPEN

_NEG = -10 ** 9


def global_align(a: str, b: str, go: int = GAP_OPEN,
                 ge: int = GAP_EXTEND) -> Tuple[str, str, int]:
    """Affine-gap global alignment; returns (aligned_a, aligned_b, score)."""
    A = np.frombuffer(a.encode('latin-1'), np.uint8)
    B = np.frombuffer(b.encode('latin-1'), np.uint8)
    n, m = len(A), len(B)
    sub = B62_BYTES[A[:, None], B[None, :]].astype(np.int64)

    M = np.full((n + 1, m + 1), _NEG, np.int64)
    X = np.full((n + 1, m + 1), _NEG, np.int64)   # gap in b (up moves)
    Y = np.full((n + 1, m + 1), _NEG, np.int64)   # gap in a (left moves)
    M[0, 0] = 0
    for i in range(1, n + 1):
        X[i, 0] = go + (i - 1) * ge
    for j in range(1, m + 1):
        Y[0, j] = go + (j - 1) * ge

    # row-wise DP with numpy inner ops where possible
    for i in range(1, n + 1):
        X[i, 1:] = np.maximum(M[i - 1, 1:] + go, X[i - 1, 1:] + ge)
        diag = np.maximum(np.maximum(M[i - 1, :-1], X[i - 1, :-1]),
                          Y[i - 1, :-1]) + sub[i - 1]
        M[i, 1:] = diag
        # Y has an intra-row dependency; sequential but cheap
        for j in range(1, m + 1):
            best_prev = max(M[i, j - 1], X[i, j - 1])
            Y[i, j] = max(best_prev + go, Y[i, j - 1] + ge)

    # traceback (X may follow M or X; Y may follow M, X or Y — matching
    # the forward recurrences above)
    i, j = n, m
    state = int(np.argmax([M[i, j], X[i, j], Y[i, j]]))
    score = int(max(M[i, j], X[i, j], Y[i, j]))
    ra, rb = [], []
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            ra.append(a[i - 1])
            rb.append(b[j - 1])
            prev = [M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1]]
            i, j = i - 1, j - 1
            state = int(np.argmax(prev))
        elif state == 1 and i > 0:
            ra.append(a[i - 1])
            rb.append('-')
            state = 1 if X[i, j] == X[i - 1, j] + ge else 0
            i -= 1
        elif state == 2 and j > 0:
            ra.append('-')
            rb.append(b[j - 1])
            if Y[i, j] == Y[i, j - 1] + ge:
                state = 2
            elif Y[i, j] == M[i, j - 1] + go:
                state = 0
            else:
                state = 1
            j -= 1
        else:
            if i > 0:
                ra.append(a[i - 1])
                rb.append('-')
                state = 1
                i -= 1
            else:
                ra.append('-')
                rb.append(b[j - 1])
                state = 2
                j -= 1
    return ''.join(reversed(ra)), ''.join(reversed(rb)), score


def center_star_msa(seqs: Sequence[str]) -> List[str]:
    """Center-star MSA; returns aligned strings (same order as input)."""
    n = len(seqs)
    if n == 0:
        return []
    if n == 1:
        return [seqs[0]]

    # pick center: highest summed pairwise score
    scores = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            _, _, s = global_align(seqs[i], seqs[j])
            scores[i, j] = scores[j, i] = s
    center = int(scores.sum(1).argmax())

    # align everything to the center; merge gaps into a master gap profile
    master = list(seqs[center])          # center columns
    # ins_before[k] = max insertions before center column k (k=len -> end)
    ins = [0] * (len(master) + 1)
    pairs = []
    for i in range(n):
        if i == center:
            pairs.append(None)
            continue
        ac, ai, _ = global_align(seqs[center], seqs[i])
        pairs.append((ac, ai))
        k = 0
        run = 0
        for ch in ac:
            if ch == '-':
                run += 1
            else:
                ins[k] = max(ins[k], run)
                run = 0
                k += 1
        ins[len(master)] = max(ins[len(master)], run)

    out = []
    for i in range(n):
        if i == center:
            cols = []
            for k, ch in enumerate(master):
                cols.append('-' * ins[k])
                cols.append(ch)
            cols.append('-' * ins[len(master)])
            out.append(''.join(cols))
            continue
        ac, ai = pairs[i]
        cols = []
        k = 0            # center column index
        run_chars: List[str] = []
        for cch, ich in zip(ac, ai):
            if cch == '-':
                run_chars.append(ich)
            else:
                cols.append('-' * (ins[k] - len(run_chars))
                            + ''.join(run_chars))
                cols.append(ich)
                run_chars = []
                k += 1
        cols.append('-' * (ins[len(master)] - len(run_chars))
                    + ''.join(run_chars))
        out.append(''.join(cols))
    assert len({len(s) for s in out}) == 1, 'ragged MSA'
    return out


def trim_alignment(rows: List[str], max_gap_frac: float = 0.5) -> List[str]:
    """Drop columns with more than max_gap_frac gaps (trimal-lite)."""
    if not rows:
        return rows
    arr = np.array([list(r) for r in rows])
    gapfrac = (arr == '-').mean(axis=0)
    keep = gapfrac <= max_gap_frac
    if not keep.any():
        return rows
    return [''.join(r) for r in arr[:, keep]]
