"""Banded Smith-Waterman-Gotoh: plain PyTorch version, scoring tables and
the device dispatch.

Port of ``swiftortho_tpu/ops/banded_sw.py`` (contract: reference
``kswat_st``, lib/fsearch.py:1357-1476; see that module's docstring).
Every implementation here and there gives the same nine (B,) int32
fields bit for bit: ``score, bi, bj`` (best cell), ``sti, stj``
(traceback end), ``idy, aln, mis, gap`` (path statistics).

- ``sw_align_batch`` is the plain version: the parity-split anti-diagonal
  wavefront of the JAX ``sw_align_batch`` with per-cell path statistics,
  a Python loop over anti-diagonal pairs on (9, 17, B) state tensors.
  It is what runs on the CPU and what the CUDA kernel is held against.
- ``sw_align_local`` dispatches by the tensors' device: CUDA tensors go
  to the hand-written kernel (``banded_sw_cuda``), which raises on any
  build or launch error; CPU tensors go to the plain version.  Nothing
  falls back from one to the other.
- ``sw_align_auto`` is the search's entry: with a search mesh active
  (``parallel.mesh.use_search_mesh``) the batch is split over the mesh
  devices (``parallel.mesh.sw_align_sharded``, as the JAX
  ``sw_align_auto`` does at :419-425), else ``sw_align_local``.

Both take lengths clamped to the padded widths, which must lie in
[1, MAX_LEN]: the kernel packs the best cell as ``i * 8192 + j``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (B62_BYTES, B62_CODES, BYTE2CODE,
                         GAP_EXTEND, GAP_OPEN, KA_GAPPED_LAMBDA,
                         KA_GAPPED_LNK, KBOUND, LN2)
from ..device import indexed

FIELDS = ('score', 'bi', 'bj', 'sti', 'stj', 'idy', 'aln', 'mis', 'gap')
MAX_LEN = 8191

_STAR, _DIAG, _DASH, _PIPE = 0, 1, 2, 3
# state rows: score, trace, then the path statistics
_H, _TR, _IDY, _ALN, _MIS, _GAP, _OP, _STI, _STJ = range(9)
_NEUTRAL = (0, 0, 0, 0, 0, 0, -1, 0, 0)     # an empty cell (op = -1)


def scoring_tables(device) -> dict:
    """The scoring parameters as int32 tensors on ``device``, built once
    per card: a bare ``cuda`` is keyed as the current ``cuda:N``.

    ``sub_flat``: the 256x256 raw-byte BLOSUM62 (``B62_BYTES``) flattened,
    read by the plain version at ``c1 * 256 + c0``.
    ``codes``: ``BYTE2CODE`` (256 entries) followed by the 32x32
    ``B62_CODES``, read by the kernel.  Both give the same score for
    every byte pair (case-folded letters, -4 for everything else).
    """
    return _scoring_tables(indexed(device))


@functools.lru_cache(maxsize=None)
def _scoring_tables(device: torch.device) -> dict:
    codes = np.concatenate([BYTE2CODE.astype(np.int32),
                            B62_CODES.astype(np.int32).reshape(-1)])
    return {
        'sub_flat': torch.as_tensor(B62_BYTES.astype(np.int32).reshape(-1),
                                    device=device),
        'codes': torch.as_tensor(codes, device=device),
    }


def check_batch(tok0, tok1, len0, len1):
    """Validate a batch: (B, L0)/(B, L1) uint8 tokens, (B,) int32 lengths,
    one device, 1 <= L <= MAX_LEN.  Raises ValueError otherwise."""
    dev = tok0.device
    if any(x.device != dev for x in (tok1, len0, len1)):
        raise ValueError('tok0, tok1, len0, len1 must share one device')
    if tok0.dtype != torch.uint8 or tok1.dtype != torch.uint8:
        raise ValueError('tokens must be uint8, got %s/%s'
                         % (tok0.dtype, tok1.dtype))
    if len0.dtype != torch.int32 or len1.dtype != torch.int32:
        raise ValueError('lengths must be int32, got %s/%s'
                         % (len0.dtype, len1.dtype))
    if tok0.dim() != 2 or tok1.dim() != 2 or tok0.shape[0] != tok1.shape[0]:
        raise ValueError('tokens must be (B, L0) and (B, L1), got %s/%s'
                         % (tuple(tok0.shape), tuple(tok1.shape)))
    B = tok0.shape[0]
    if tuple(len0.shape) != (B,) or tuple(len1.shape) != (B,):
        raise ValueError('lengths must be (%d,), got %s/%s'
                         % (B, tuple(len0.shape), tuple(len1.shape)))
    for L in (tok0.shape[1], tok1.shape[1]):
        if not 1 <= L <= MAX_LEN:
            raise ValueError('padded width %d outside [1, %d]' % (L, MAX_LEN))


def sw_align_batch(tok0: torch.Tensor, tok1: torch.Tensor,
                   len0: torch.Tensor, len1: torch.Tensor,
                   score_only: bool = False, go: int = GAP_OPEN,
                   ge: int = GAP_EXTEND) -> dict:
    """Align B pairs (plain PyTorch, any device).

    tok0 (B, L0) uint8: column sequences (the shorter suffix; callers do
        the reference's swap and re-add offsets afterwards)
    tok1 (B, L1) uint8: row sequences
    len0/len1 (B,) int32: suffix lengths (clamped to L0/L1)
    score_only: skip the path statistics; ``score/bi/bj`` stay exact and
        the other six fields are 0.

    Returns a dict of (B,) int32 tensors keyed by ``FIELDS``.
    """
    check_batch(tok0, tok1, len0, len1)
    dev = tok0.device
    B, L0 = tok0.shape
    L1 = tok1.shape[1]
    k = KBOUND
    assert k % 2 == 0, 'kbound must be even for the parity-class layout'
    ns = k + 1
    nf = 2 if score_only else 9
    i64 = torch.int64
    sub_flat = scoring_tables(dev)['sub_flat'].to(i64)
    t0 = tok0.t().to(i64)                          # (L0, B)
    t1 = tok1.t().to(i64)                          # (L1, B)
    l0 = len0.to(i64).clamp(0, L0)[None, :]        # (1, B)
    l1 = len1.to(i64).clamp(0, L1)[None, :]

    # class c slot e covers diagonal offset d = j - i = -k-1 + c + 2e
    d_of = [(-k - 1 + c + 2 * torch.arange(ns, dtype=i64, device=dev))[:, None]
            for c in (0, 1)]
    band = [(d >= -k) & (d <= k - 1) for d in d_of]
    neutral = torch.tensor(_NEUTRAL[:nf], dtype=i64,
                           device=dev)[:, None, None].expand(nf, 1, B)

    def shift_down(S):          # slot e <- slot e-1
        return torch.cat([neutral, S[:, :-1]], dim=1)

    def shift_up(S):            # slot e <- slot e+1
        return torch.cat([S[:, 1:], neutral], dim=1)

    def substep(cls, a, m1, m2, best):
        d = d_of[cls]
        ii = ((a - d) // 2).expand(ns, B)           # exact: parity matches
        jj = ((a + d) // 2).expand(ns, B)
        computed = ((ii >= 1) & (jj >= 1) & (ii <= l1) & (jj <= l0)
                    & band[cls])
        diag = m2
        left, up = (shift_down(m1), m1) if cls == 0 else (m1, shift_up(m1))

        c1 = t1.gather(0, (ii - 1).clamp(0, L1 - 1))
        c0 = t0.gather(0, (jj - 1).clamp(0, L0 - 1))
        sub = sub_flat[c1 * 256 + c0]

        I = left[_H] + torch.where(left[_TR] == _DASH, ge, go)
        M = diag[_H] + sub
        D = up[_H] + torch.where(up[_TR] == _PIPE, ge, go)
        Bv = torch.maximum(I.clamp(min=0), torch.maximum(M, D))
        is_m = Bv == M
        is_i = ~is_m & (Bv == I)
        is_d = ~is_m & ~is_i & (Bv == D)
        tr = torch.where(is_m, _DIAG, torch.where(
            is_i, _DASH, torch.where(is_d, _PIPE, _STAR)))

        # border cells: row 0 carries the I-chain statistics, column 0
        # the D-chain ones; an m-column border run counts ceil(m/2) gap
        # openings, with op set only after an odd column
        inmat = (ii >= 0) & (jj >= 0) & (ii <= l1) & (jj <= l0)
        is_row0 = inmat & (ii == 0)
        is_col0 = inmat & (jj == 0) & (ii > 0)
        rows = [torch.where(computed, Bv, 0), torch.where(computed, tr, 0)]
        if not score_only:
            eq = (c1 == c0).to(i64)
            # statistics of the winning predecessor, then this cell's step
            src = torch.where(is_m, diag[2:], torch.where(is_i, left[2:],
                                                           up[2:]))
            s_idy, s_aln, s_mis, s_gap, s_op, s_sti, s_stj = src
            star = ~(is_m | is_i | is_d)
            opens_i = is_i & (s_op != 1)
            opens_d = is_d & (s_op != 0)
            # op resets to -1 on gap continuation (reference quirk: an
            # m-column gap run counts ceil(m/2) openings)
            new = [s_idy + is_m * eq,
                   s_aln + 1,
                   s_mis + torch.where(is_m, 1 - eq, 1),
                   s_gap + (opens_i | opens_d),
                   torch.where(opens_i, 1, torch.where(opens_d, 0, -1)),
                   torch.where(star, ii, s_sti),
                   torch.where(star, jj, s_stj)]
            new = [torch.where(star, 0, v) for v in new[:4]] + new[4:]
            bd_aln = torch.where(is_row0, jj, torch.where(is_col0, ii, 0))
            bd_odd = (bd_aln % 2) == 1
            border = [torch.zeros_like(bd_aln), bd_aln, bd_aln,
                      (bd_aln + 1) // 2,
                      torch.where(is_row0 & (jj > 0) & bd_odd, 1,
                                  torch.where(is_col0 & bd_odd, 0, -1)),
                      torch.zeros_like(bd_aln), torch.zeros_like(bd_aln)]
            rows += [torch.where(computed, n, b) for n, b in zip(new, border)]
        out = torch.stack(rows)

        # running best cell: strictly greater, ties to the smallest (i, j)
        # in row-major order (the reference's first-occurrence rule); the
        # keys of computed slots are distinct (one i per slot)
        key = torch.where(computed, Bv * 8192 - ii, -(1 << 40))
        pick = key.argmax(0, keepdim=True)                     # (1, B)
        Hc = torch.where(computed, Bv, 0).gather(0, pick)[0]
        ic = ii.gather(0, pick)[0]
        jc = jj.gather(0, pick)[0]
        better = (Hc > best['score']) | (
            (Hc == best['score']) & (Hc > 0)
            & ((ic < best['bi']) | ((ic == best['bi']) & (jc < best['bj']))))
        nbest = dict(best)
        nbest.update(score=torch.where(better, Hc, best['score']),
                     bi=torch.where(better, ic, best['bi']),
                     bj=torch.where(better, jc, best['bj']))
        if not score_only:
            for nm, r in (('idy', _IDY), ('aln', _ALN), ('mis', _MIS),
                          ('gap', _GAP), ('sti', _STI), ('stj', _STJ)):
                nbest[nm] = torch.where(better, out[r].gather(0, pick)[0],
                                        best[nm])
        return out, nbest

    zero = torch.zeros(B, dtype=i64, device=dev)
    best = {nm: zero for nm in FIELDS}
    init = neutral.expand(nf, ns, B)
    m1 = m2 = init
    # k even => odd anti-diagonals live in class 0, even ones in class 1
    for t in range((L0 + L1) // 2 + 1):
        a_odd = 2 * t + 1
        s_odd, best = substep(0, a_odd, m1, m2, best)
        s_even, best = substep(1, a_odd + 1, s_odd, m1, best)
        m2, m1 = s_odd, s_even
    return {nm: best[nm].to(torch.int32) for nm in FIELDS}


def sw_align_auto(tok0: torch.Tensor, tok1: torch.Tensor,
                  len0: torch.Tensor, len1: torch.Tensor,
                  score_only: bool = False) -> dict:
    """Align a batch: over the active search mesh's devices when one is
    set, else on the tensors' device (``sw_align_local``).  Results are on
    ``tok0``'s device either way; same contract as ``sw_align_batch``."""
    # lazy import: parallel.mesh imports this module at load time
    from ..parallel import mesh as _meshmod
    m = _meshmod.active_search_mesh()
    if m is not None:
        return _meshmod.sw_align_sharded(m, tok0, tok1, len0, len1,
                                         score_only=score_only)
    return sw_align_local(tok0, tok1, len0, len1, score_only=score_only)


def sw_align_local(tok0: torch.Tensor, tok1: torch.Tensor,
                   len0: torch.Tensor, len1: torch.Tensor,
                   score_only: bool = False) -> dict:
    """Align a batch on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Same contract as
    ``sw_align_batch``."""
    kind = tok0.device.type
    if kind == 'cuda':
        from .banded_sw_cuda import sw_align_batch_cuda
        out = sw_align_batch_cuda(tok0, tok1, len0, len1,
                                  score_only=score_only)
        return dict(zip(FIELDS, out))
    if kind == 'cpu':
        return sw_align_batch(tok0, tok1, len0, len1, score_only=score_only)
    raise ValueError('no banded SW for device type %r' % kind)


def postprocess_batch(best: dict, qst: np.ndarray, sst: np.ndarray,
                      swapped: np.ndarray) -> dict:
    """Map kernel outputs back to reference coordinates (numpy, host).

    qst/sst: per-pair suffix offsets in the *original* (query, subject)
    order; swapped: True where the subject ran as the column sequence.
    Returns dict with idy (float %), aln, mis, gap, qst, qed, sst, sed,
    bit, score (all numpy arrays).  Start coords are the traceback end
    (reference returns them 0-based; the driver prints +1).
    """
    score = np.asarray(best['score'])
    bi, bj = np.asarray(best['bi']), np.asarray(best['bj'])
    sti, stj = np.asarray(best['sti']), np.asarray(best['stj'])
    aln = np.asarray(best['aln'])
    idy_n = np.asarray(best['idy'])
    with np.errstate(divide='ignore', invalid='ignore'):
        idy = np.where(aln > 0, 100.0 * idy_n / np.maximum(aln, 1), 0.0)

    # column seq indices (jj) belong to s0 = query when not swapped.
    q_lo = np.where(swapped, sti, stj)
    q_hi = np.where(swapped, bi, bj)
    s_lo = np.where(swapped, stj, sti)
    s_hi = np.where(swapped, bj, bi)
    return {
        'idy': idy, 'aln': aln, 'mis': np.asarray(best['mis']),
        'gap': np.asarray(best['gap']),
        'qst': q_lo + qst, 'qed': q_hi + qst,
        'sst': s_lo + sst, 'sed': s_hi + sst,
        'bit': np.trunc((KA_GAPPED_LAMBDA * score - KA_GAPPED_LNK)
                        / LN2).astype(np.int64),
        'score': score,
    }
