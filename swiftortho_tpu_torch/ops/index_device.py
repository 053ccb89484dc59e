"""Seed-index build on the device: spaced-seed FNV hashing, one sort of
packed keys, the CSR and the locus decode in torch, on the device; only
the positive bucket counts come to the host, for the threshold.

Port of ``swiftortho_tpu/ops/index_device.py`` (``_hash_sort_device``
:78-136, ``build_index_device`` :145-201); same contract: the SeedIndex
equals ``swiftortho_tpu.ops.index.build_index``'s (``start``, ``locus``,
``soas``, ``threshold``, ``sid``, ``sst``), which reads the reference's
counting sort ``Fasta.build_msav`` (lib/fsearch.py:2240-2266).

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
  element;
- CSR and decode: the runs of the sorted buckets give the positive
  bucket counts, scattered and summed into the CSR; the reference's
  bisect (``SeedIndex.decode_locus``, its off-by-one kept) is a
  ``torch.searchsorted`` over ``soas``;
- threshold: the positive bucket counts, in bucket order, are fetched
  and passed to the host's float64 ``ref_mu_sd``, so the sums run in the
  same order as the host build's and the integer gate cannot drift by
  an ulp.

The result is a ``DeviceSeedIndex``: ``start``, ``sid`` and ``sst`` stay
on the device as int32 tensors (the device candidate engine's layout)
beside ``locus``, and the host arrays are fetched only when a host
consumer first reads them.

Deviations from the JAX module: it fetches the sorted keys and builds the
CSR, the threshold and the decode on the host (its :145-201); here they
stay on the device.  No {2^k, 3*2^k} padding of T (it served XLA's
compile cache); the key layout uses the true T.  Falls back to the host
build, with a ``device_index_fallback`` log event, when the key range
does not hold; raises when the postings do not fit int32.  Selected by
``SWIFTORTHO_INDEX=device`` (``search.blastp.IndexSource``).
"""

from __future__ import annotations

import threading
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


def _fetch(t: torch.Tensor) -> np.ndarray:
    """One tensor as a host array (the only device-to-host copies of a
    device index)."""
    return t.cpu().numpy()


def csr_of(b: torch.Tensor, nc: int) -> tuple:
    """The CSR offsets (``nc + 1``, int32) of the ascending bucket ids
    ``b``, and the positive bucket counts in bucket order: the lengths of
    the runs of ``b``, found without a pass over all ``nc`` buckets."""
    bucket, counts = torch.unique_consecutive(b, return_counts=True)
    csr = torch.zeros(nc + 1, dtype=torch.int32, device=b.device)
    csr[bucket + 1] = counts.int()
    torch.cumsum(csr, 0, dtype=torch.int32, out=csr)
    return csr, counts


def threshold_of(counts: torch.Tensor) -> int:
    """``int(mu + 2 sd)`` of the positive bucket counts, in bucket order:
    they go to the host's ``ref_mu_sd``, which sums the same array in the
    same order as the host build (its mask of the zero counts keeps
    every entry)."""
    mu, sd = ref_mu_sd(_fetch(counts.int()))
    return int(mu + 2 * sd)


# host dtype of each array of the SeedIndex contract
HOST_DTYPES = {'start': np.int64, 'locus': np.int64, 'sid': np.int32,
               'sst': np.int32}


class DeviceSeedIndex(SeedIndex):
    """A SeedIndex whose CSR (``start``), postings (``locus``) and decoded
    postings (``sid``, ``sst``) stay on the device that built them:
    ``tensors`` holds ``start``, ``sid`` and ``sst`` as int32 and
    ``locus`` as int64.  Reading one of those four attributes fetches
    that array to the host once, under a lock (phase A's producer and
    prefetch threads may race for it), in the dtype of ``SeedIndex``.
    The properties shadow the dataclass's field defaults."""

    def __init__(self, nc: int, tensors: dict, soas: np.ndarray,
                 seq_offset: int, threshold: int, mink: int):
        self.nc, self.soas, self.seq_offset = nc, soas, seq_offset
        self.threshold, self.mink = threshold, mink
        self.tensors = tensors
        self.device = tensors['start'].device
        self._host: dict = {}
        self._lock = threading.Lock()

    def host(self, name: str) -> np.ndarray:
        with self._lock:
            a = self._host.get(name)
            if a is None:
                a = _fetch(self.tensors[name]).astype(HOST_DTYPES[name],
                                                      copy=False)
                self._host[name] = a
            return a

    start = property(lambda self: self.host('start'))
    locus = property(lambda self: self.host('locus'))
    sid = property(lambda self: self.host('sid'))
    sst = property(lambda self: self.host('sst'))


def build_index_device(db: SeqDB, start: int, end: int,
                       alphabets: List[str], ssps: str, nc: int,
                       step: int = 1, threshold_override: int = -1,
                       device: torch.device | None = None) -> SeedIndex:
    """Drop-in replacement for ``ops.index.build_index`` that builds on
    ``device`` (default ``get_device()``) and leaves the index there (a
    ``DeviceSeedIndex``).  Logs a ``device_index`` event whose ``*_s``
    fields split the build's seconds."""
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
    del tok_dev, seq_of
    clock.mark('hash_sort')
    n = key.numel()
    if n >= 1 << 31:
        raise OverflowError('%d postings: the device index keeps its CSR '
                            'in int32' % n)

    M = len(strms) * (T + 1)
    locus = key % M % (T + 1)
    csr, counts = csr_of(key // M, nc)
    del key
    clock.mark('csr')

    # SeedIndex.decode_locus: the largest idx with soas[idx] < locus
    soas_dev = torch.from_numpy(soas).to(device)
    idx = (torch.searchsorted(soas_dev, locus, side='left') - 1) \
        .clamp_min(0)
    sid = (idx + start).int()
    sst = (locus - soas_dev[idx]).int()
    clock.mark('decode')

    threshold = threshold_override if threshold_override >= 1 else \
        threshold_of(counts)
    ix = DeviceSeedIndex(nc, {'start': csr, 'locus': locus, 'sid': sid,
                              'sst': sst}, soas, start, threshold,
                         min_pattern_len(ssps))
    clock.mark('threshold')
    log_event('device_index', device=str(device), T=T, postings=n,
              **clock.rounded())
    return ix
