"""Seed-index build on the device: spaced-seed FNV hashing and one sort of
packed keys in torch, the CSR and the threshold on the host.

Port of ``swiftortho_tpu/ops/index_device.py`` (``_hash_sort_device``
:78-136, ``build_index_device`` :145-201); same contract: the SeedIndex
equals ``swiftortho_tpu.ops.index.build_index``'s (``start``, ``locus``,
``soas``, ``threshold``), which reads the reference's counting sort
``Fasta.build_msav`` (lib/fsearch.py:2240-2266).

- hashing: the FNV-1a chain of ``ops.seeds`` over reduced codes at the
  pattern's '1' offsets, then the pattern index.  torch has no full
  uint32 arithmetic, so ``fnv_step`` keeps the 32-bit state in int64 and
  masks after each multiply: the product of a value below 2^32 and the
  25-bit prime is below 2^57, so nothing overflows;
- masks: windows holding an x/X residue, crossing a sequence boundary,
  or off the per-sequence stride (``step``) are dropped;
- dedup: within one alphabet, a (bucket, position) seen by an earlier
  pattern is dropped (the reference's ``visit`` dict, fsearch.py:554-556);
- order: one ``torch.sort`` of the kept keys bucket * S(T+1) + stream *
  (T+1) + position reproduces the host's stable argsort over the
  alphabet-major stream concatenation, so ``locus`` matches element for
  element.

The bincount/cumsum CSR and the float64 ``ref_mu_sd`` threshold stay on
the host over the fetched sorted stream, as in the JAX package, so the
integer gate cannot drift by a summation-order ulp.  Deviation from the
JAX module: no {2^k, 3*2^k} padding of T (it served XLA's compile cache);
the key layout uses the true T.  Falls back to the host build, with a
``device_index_fallback`` log event, when the key range does not hold.
Selected by ``SWIFTORTHO_INDEX=device`` (``search.blastp.IndexSource``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..constants import reduced_alphabet_table
from ..device import StageClock, get_device
from ..io_fasta import SeqDB
from ..utils import log_event
from .index import SeedIndex, build_index, ref_mu_sd
from .scan import cummax_1d
from .seeds import (FNV_BASIS, FNV_PRIME, min_pattern_len,
                    parse_patterns)

_XL, _XU = ord('x'), ord('X')
FNV_MASK = 0xFFFFFFFF
_PRIME = int(FNV_PRIME)
BASIS = int(FNV_BASIS)


def fnv_step(h: torch.Tensor, c) -> torch.Tensor:
    """One FNV-1a step on uint32 values held in int64:
    ``(h ^ c) * FNV_PRIME mod 2^32``.  ``h`` and ``c`` lie in [0, 2^32),
    so the product stays below 2^57."""
    return ((h ^ c) * _PRIME) & FNV_MASK


@lru_cache(maxsize=None)
def _tables_np(alphabets: tuple) -> np.ndarray:
    return np.stack([reduced_alphabet_table(a) for a in alphabets]) \
        .astype(np.int64)


def tables(alphabets: tuple, device: torch.device) -> torch.Tensor:
    """(A, 256) int64 reduced-code tables on ``device``."""
    return torch.from_numpy(_tables_np(alphabets).copy()).to(device)


def streams(alphabets: tuple, ssps: str) -> tuple:
    """(alpha_idx, pattern_idx, klen, ones) in the host concatenation
    order (alphabet-major, pattern within — ops.index.build_index)."""
    out = []
    pats = parse_patterns(ssps)
    for ai in range(len(alphabets)):
        for s, (klen, ones) in enumerate(pats):
            out.append((ai, s, klen, tuple(int(x) for x in ones)))
    return tuple(out)


def shifted(a: torch.Tensor, j: int, fill) -> torch.Tensor:
    """``a[..., p + j]`` for every p along the last axis, ``fill`` past
    the end."""
    if not j:
        return a
    n = a.shape[-1]
    tail = a.new_full(a.shape[:-1] + (min(j, n),), fill)
    return torch.cat([a[..., j:], tail], dim=-1)


def _hash_sort(tokens: torch.Tensor, seq_of: torch.Tensor,
               code_tbls: torch.Tensor, nc: int, strms: tuple,
               step: int) -> torch.Tensor:
    """Hash every stream over the flat chunk tokens, dedup within
    alphabets, and return the ascending packed keys of the kept postings
    (bucket * S(T+1) + stream * (T+1) + position), on the device."""
    T = tokens.shape[0]
    S = len(strms)
    toks = tokens.long()
    is_x = (toks == _XL) | (toks == _XU)
    pos = torch.arange(T, dtype=torch.int64, device=tokens.device)
    if step > 1:
        # per-sequence window stride from position 0 of each sequence
        # (fsearch.py:534): starts_flat[p] = first flat index of p's seq
        change = torch.ones(T, dtype=torch.bool, device=tokens.device)
        change[1:] = seq_of[1:] != seq_of[:-1]
        starts_flat = cummax_1d(torch.where(change, pos, 0))

    buckets, valid = [], []
    for (ai, s, klen, ones) in strms:
        codes = code_tbls[ai][toks]
        h = torch.full((T,), BASIS, dtype=torch.int64, device=tokens.device)
        for j in ones:
            h = fnv_step(h, shifted(codes, j, 0))
        h = fnv_step(h, s)
        bad = torch.zeros(T, dtype=torch.bool, device=tokens.device)
        for j in range(klen):
            bad |= shifted(is_x, j, True)
        ok = (~bad) & (seq_of == shifted(seq_of, klen - 1, -1)) \
            & (pos + (klen - 1) < T)
        if step > 1:
            ok &= (pos - starts_flat) % step == 0
        buckets.append(h % nc)
        valid.append(ok)

    M = S * (T + 1)
    keys = []
    for i2, (a2, _, _, _) in enumerate(strms):
        kept = valid[i2]
        for i1, (a1, _, _, _) in enumerate(strms[:i2]):
            if a1 == a2:
                kept = kept & ~(valid[i1] & (buckets[i1] == buckets[i2]))
        # keys are distinct (stream and position), so sorting the kept
        # ones alone gives the JAX module's sorted-then-cut stream
        keys.append((buckets[i2] * M + (i2 * (T + 1) + pos))[kept])
    return torch.sort(torch.cat(keys)).values


def device_index_supported(T: int, nc: int, n_streams: int) -> bool:
    """Packed-key range: bucket * S(T+1) + rank must stay < 2^62."""
    return nc * (n_streams * (max(T, 1) + 1) + 1) < (1 << 62)


def build_index_device(db: SeqDB, start: int, end: int,
                       alphabets: List[str], ssps: str, nc: int,
                       step: int = 1, threshold_override: int = -1,
                       device: torch.device | None = None) -> SeedIndex:
    """Drop-in replacement for ``ops.index.build_index`` with the hashing
    and the sort on ``device`` (default ``get_device()``).  Logs a
    ``device_index`` event with the device and host seconds."""
    end = min(end, len(db))
    lens = db.lengths[start:end].astype(np.int64)
    soas = np.zeros(end - start + 1, dtype=np.int64)
    np.cumsum(lens, out=soas[1:])
    chunk_tokens = db.tokens[db.offsets[start]:db.offsets[end]]
    T = len(chunk_tokens)
    strms = streams(tuple(alphabets), ssps)
    if not strms or not device_index_supported(T, nc, len(strms)):
        log_event('device_index_fallback', T=T, nc=nc)
        return build_index(db, start, end, alphabets, ssps, nc, step,
                           threshold_override)
    device = get_device() if device is None else torch.device(device)

    clock = StageClock(device)
    tok_dev = torch.from_numpy(np.array(chunk_tokens)).to(device)
    seq_of = torch.repeat_interleave(
        torch.arange(end - start, device=device),
        torch.from_numpy(lens).to(device), output_size=T)
    key = _hash_sort(tok_dev, seq_of, tables(tuple(alphabets), device), nc,
                     strms, int(step))
    clock.mark('hash_sort')
    key = key.cpu().numpy()
    clock.mark('fetch')

    M = np.int64(len(strms)) * (T + 1)
    b = key // M
    p = (key % M) % np.int64(T + 1)
    counts = np.bincount(b, minlength=nc) if len(key) else \
        np.zeros(nc, np.int64)
    csr = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(counts, out=csr[1:])
    mu, sd = ref_mu_sd(counts)
    threshold = int(mu + 2 * sd)
    if threshold_override >= 1:
        threshold = threshold_override
    ix = SeedIndex(nc=nc, start=csr, locus=p.astype(np.int64),
                   soas=soas, seq_offset=start, threshold=threshold,
                   mink=min_pattern_len(ssps))
    clock.mark('host')
    log_event('device_index', device=str(device), T=T, postings=len(key),
              **clock.rounded())
    return ix

