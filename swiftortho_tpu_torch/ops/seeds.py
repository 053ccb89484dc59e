"""Spaced-seed FNV hashing.

Behavioral contract: reference ``spseeds_fnv`` (lib/fsearch.py:519-556):
- For each reduced-alphabet code table and each comma-separated 0/1 pattern:
  slide a window over the sequence; windows containing 'x'/'X' are skipped
  (seg mask); FNV-1a over the *reduced codes* of residues at '1' positions;
  then mix in the pattern index (h ^= s; h *= prime), mask to 32 bits, and
  bucket with h % NC.
- (bucket, position) pairs are deduplicated within one code table across
  patterns (the reference's ``visit`` dict).

Vectorized: shifted slices per pattern position; the FNV chain is a static
unroll of XOR/MUL uint32 ops.  Works on numpy (host index build) and can be
jitted later for on-device hashing.

Copied from ``swiftortho_tpu/ops/seeds.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

FNV_BASIS = np.uint32(0x811c9dc5)
FNV_PRIME = np.uint32(0x01000193)

_XL, _XU = ord('x'), ord('X')


def parse_patterns(ssps: str) -> List[np.ndarray]:
    """'11010,111' -> [array of '1' offsets per pattern]."""
    pats = []
    for pat in ssps.split(','):
        ones = np.array([i for i, c in enumerate(pat) if c != '0'],
                        dtype=np.int64)
        pats.append((len(pat), ones))
    return pats


def min_pattern_len(ssps: str) -> int:
    return min(len(p) for p in ssps.split(','))


def max_weight(ssps: str) -> int:
    return max(p.count('1') for p in ssps.split(','))


def _fnv_chain(cols: Sequence[np.ndarray], pat_idx: int) -> np.ndarray:
    """FNV-1a over per-position code columns, then mix in the pattern index."""
    h = np.full(cols[0].shape, FNV_BASIS, dtype=np.uint32)
    for c in cols:
        h ^= c.astype(np.uint32)
        h *= FNV_PRIME
    h ^= np.uint32(pat_idx)
    h *= FNV_PRIME
    return h


def hash_seeds_flat(tokens: np.ndarray, seq_of: np.ndarray,
                    code_tbl: np.ndarray, ssps: str, nc: int,
                    step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Hash every valid seed window of a *concatenated* token array.

    tokens: (T,) uint8 concatenated residues of many sequences
    seq_of: (T,) int32/int64 sequence id of each position (windows must not
        cross sequence boundaries)
    code_tbl: 256-entry reduced-alphabet map (constants.reduced_alphabet_table)
    Returns (bucket, flat_pos) int64 arrays, deduplicated on
    (sequence-local window, bucket) like the reference's visit dict.
    """
    T = len(tokens)
    codes = None        # numpy-fallback precomputes, built lazily

    all_b: List[np.ndarray] = []
    all_p: List[np.ndarray] = []
    # per-sequence window stride (the reference strides from position 0 of
    # each sequence, fsearch.py:534): seq_start[p] = first flat index of
    # p's sequence
    if step > 1:
        change = np.ones(T, dtype=bool)
        change[1:] = seq_of[1:] != seq_of[:-1]
        starts_flat = np.maximum.accumulate(
            np.where(change, np.arange(T, dtype=np.int64), 0))
    pats = parse_patterns(ssps)
    for s, (klen, ones) in enumerate(pats):
        n = T - klen + 1
        if n <= 0:
            continue
        try:
            # threaded native sweep (groupby.cpp hash_seeds_pattern):
            # identical (bucket, pos) stream to the numpy block below
            from ..native import hash_seeds_pattern_native
            bb, pp = hash_seeds_pattern_native(tokens, seq_of, code_tbl,
                                               ones, klen, s, nc, step)
            if len(bb):
                all_b.append(bb)
                all_p.append(pp)
            continue
        except Exception:
            pass        # no compiler: vectorized numpy
        if codes is None:
            is_x = (tokens == _XL) | (tokens == _XU)
            codes = code_tbl[tokens]
        # validity masks from contiguous slices (no index gathers):
        # window inside one sequence, no masked residue at any of the
        # klen positions (the reference's char loop), window stride
        ok = seq_of[:n] == seq_of[klen - 1:klen - 1 + n]
        bad = is_x[:n].copy()
        for j in range(1, klen):
            bad |= is_x[j:j + n]
        ok &= ~bad
        if step > 1:
            ok &= ((np.arange(n, dtype=np.int64) - starts_flat[:n])
                   % step == 0)
        if not ok.any():
            continue
        # FNV over full-width slices, filtered afterwards: hashing the
        # ~10% invalid windows too is far cheaper than gathering the
        # valid ones through index arrays
        cols = [codes[int(j):int(j) + n] for j in ones]
        h = _fnv_chain(cols, s)[ok]
        all_b.append((h % np.uint32(nc)).astype(np.int64))
        all_p.append(np.flatnonzero(ok))

    if not all_b:
        return (np.zeros(0, dtype=np.int64),) * 2
    b = np.concatenate(all_b)
    p = np.concatenate(all_p)
    if len(all_b) == 1:
        # single pattern: positions are distinct, so (bucket, pos) pairs
        # are already unique and in order — the dedup is a no-op
        return b, p
    # dedup (bucket, pos) across patterns (reference fsearch.py:554-556)
    key = b * np.int64(T + 1) + p
    _, first = np.unique(key, return_index=True)
    first.sort()
    return b[first], p[first]


def hash_seeds_batch(tokens: np.ndarray, lengths: np.ndarray,
                     code_tbl: np.ndarray, ssps: str, nc: int,
                     step: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hash seeds of a padded (B, L) batch (query side).

    Returns (row, bucket, pos) arrays, deduplicated per row on (bucket, pos).
    """
    B, L = tokens.shape
    flat = tokens.reshape(-1)
    seq_of = np.repeat(np.arange(B, dtype=np.int64), L)
    # mark padding as its own "sequence" so windows never cross it; also
    # respect true lengths by masking tail positions
    posL = np.tile(np.arange(L, dtype=np.int64), B)
    valid = posL < np.repeat(lengths.astype(np.int64), L)
    seq_mark = np.where(valid, seq_of, -1 - np.arange(B * L, dtype=np.int64))
    b, p = hash_seeds_flat(flat, seq_mark, code_tbl, ssps, nc, step)
    return (p // L).astype(np.int64), b, (p % L).astype(np.int64)
