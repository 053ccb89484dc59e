"""Karlin-Altschul bit scores / E-values and E-value text formatting.

Behavioral contract: reference lib/fsearch.py:1066-1086 (score2bit/bit2e)
and lib/fsearch.py:42-61 (f2s custom scientific notation).

Copied from ``swiftortho_tpu/ops/stats.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from math import log10

import numpy as np

from ..constants import (KA_GAPPED_LAMBDA, KA_GAPPED_LNK, KA_UNGAPPED_LAMBDA,
                         KA_UNGAPPED_LNK, LN2)


def score2bit(score, gapped: bool = True):
    """Raw alignment score -> truncated integer NCBI bit score.

    Works elementwise on numpy/jax arrays; truncation-toward-zero matches the
    reference's int() cast (fsearch.py:1071).
    """
    if gapped:
        bit = (KA_GAPPED_LAMBDA * score - KA_GAPPED_LNK) / LN2
    else:
        bit = (KA_UNGAPPED_LAMBDA * score - KA_UNGAPPED_LNK) / LN2
    if isinstance(bit, (int, float)):
        return int(bit)
    return np.trunc(bit).astype(np.int64) if isinstance(bit, np.ndarray) else bit.astype('int32')


def bit2e(db_size, qlen, slen, bit):
    """E = D * m * n * 2**-bit (fsearch.py:1086; D = #sequences in the ref)."""
    return db_size * qlen * slen * np.power(2.0, -np.asarray(bit, dtype=np.float64))


def py2_float_str(v: float) -> str:
    """Python-2 ``str(float)``: 12-significant-digit shortest form with a
    trailing ``.0`` on integral values.  The reference ran under RPython
    (py2 semantics), so values like 3.0999999999999996 printed as '3.1' —
    py3's shortest-repr would truncate to '3.09' downstream."""
    s = '%.12g' % v
    if 'e' not in s and '.' not in s and 'n' not in s and 'f' not in s:
        s += '.0'
    return s


def f2s(e: float) -> str:
    """Custom scientific-notation formatter, char-for-char compatible with the
    reference's f2s (fsearch.py:42-61): mantissa truncated to 2 decimals,
    plain str() for e >= 1e-3, '0' for e <= 0.  All str(float) sites use the
    py2 12-digit form the reference's runtime produced."""
    if e <= 0:
        return '0'
    if e < 1e-3:
        a = log10(e)
        a -= int(a)
        if a < 0:
            a += 1
        b = pow(10, a)
        s = py2_float_str(log10(e / b))
        end = max(0, s.find('.'))
        s = s[:end]
        p = py2_float_str(b)
        end = max(0, p.find('.') + 3)
        p = p[:end]
        return '%se%s' % (p, s)
    return py2_float_str(e)
