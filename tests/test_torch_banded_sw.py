"""Banded SW port (swiftortho_tpu_torch.ops.banded_sw*): the plain PyTorch
version against the JAX package and its oracles on the CPU, and the CUDA
kernel against the plain version on a card (``cuda`` marker).

Inputs are numpy arrays made from fixed seeds; both packages get the same
arrays.  Tolerance is 0: every output is an integer.  The JAX package is
imported inside the tests that use it, so the card tests of this file
also collect where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu.constants import B62_BYTES
from swiftortho_tpu.native import sw_align_batch_native
from swiftortho_tpu_torch.ops import banded_sw as tsw
from swiftortho_tpu_torch.ops import banded_sw_cuda as tcu

AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
JUNK = np.frombuffer(b'acdefghiklmnpqrstvwyXJ*-', np.uint8)
FIELDS = tsw.FIELDS
CASES = ('mixed', 'asymmetric', 'tiny_empty', 'lowercase_junk')


def _case(name, B=100, L=80, seed=0):
    """A seeded batch of the named kind (the test_pallas_sw.py kinds);
    B = 100 is deliberately not a multiple of 128."""
    rng = np.random.default_rng([seed, CASES.index(name)])
    if name == 'mixed':             # half identical pairs, mixed lengths
        t0 = AA[rng.integers(0, 20, (B, L))]
        t1 = t0.copy()
        t1[B // 2:] = AA[rng.integers(0, 20, (B - B // 2, L))]
        l0 = rng.integers(10, L, B)
        l1 = rng.integers(10, L, B)
    elif name == 'asymmetric':
        t0 = AA[rng.integers(0, 20, (B, 48))]
        t1 = AA[rng.integers(0, 20, (B, 144))]
        t1[:B // 2, 8:48] = t0[:B // 2, :40]
        l0 = np.full(B, 40)
        l1 = np.full(B, 140)
    elif name == 'tiny_empty':
        t0 = AA[rng.integers(0, 20, (B, 32))]
        t1 = AA[rng.integers(0, 20, (B, 32))]
        l0 = rng.integers(0, 5, B)
        l1 = rng.integers(0, 5, B)
    else:                           # lowercase letters and junk bytes
        t0 = JUNK[rng.integers(0, len(JUNK), (B, 64))]
        t1 = JUNK[rng.integers(0, len(JUNK), (B, 64))]
        t1[:B // 2] = t0[:B // 2]
        l0 = np.full(B, 60)
        l1 = np.full(B, 60)
    return t0, t1, l0.astype(np.int32), l1.astype(np.int32)


def _torch(arrays, device='cpu'):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _np(res):
    return {k: np.asarray(res[k].cpu() if torch.is_tensor(res[k])
                          else res[k]).astype(np.int64) for k in FIELDS}


def _assert_same(got, want, fields=FIELDS):
    for k in fields:
        a, b = got[k], want[k]
        assert np.array_equal(a, b), (k, np.flatnonzero(a != b)[:5])


# ---------------------------------------------------------------- CPU ----

@pytest.mark.parametrize('name', CASES)
def test_plain_matches_jax_and_native(name):
    from swiftortho_tpu.ops.banded_sw import sw_align_batch as jax_sw
    batch = _case(name)
    got = _np(tsw.sw_align_batch(*_torch(batch)))
    _assert_same(got, _np(jax_sw(*batch)))
    _assert_same(got, _np(sw_align_batch_native(*batch)))


@pytest.mark.parametrize('name', CASES)
def test_score_only_matches_full(name):
    args = _torch(_case(name, seed=1))
    full = _np(tsw.sw_align_batch(*args))
    so = _np(tsw.sw_align_batch(*args, score_only=True))
    _assert_same(so, full, ('score', 'bi', 'bj'))
    for k in FIELDS[3:]:
        assert not so[k].any(), k


def _mutate(s, rng, sub=0.15, ind=0.05):
    out = []
    for c in s:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out += [c, AA[rng.integers(0, 20)]]
        elif r < ind + sub:
            out.append(AA[rng.integers(0, 20)])
        else:
            out.append(c)
    return np.array(out, np.uint8)


def test_matches_kswat_oracle():
    """Reference coordinates through the swap rule and postprocess_batch
    equal the sequential oracle's (test_banded_sw.py::TestBatchVsOracle)."""
    from swiftortho_tpu.ops.banded_sw import kswat_oracle
    rng = np.random.default_rng(7)
    pairs = []
    for t in range(24):
        s0 = AA[rng.integers(0, 20, int(rng.integers(5, 110)))]
        s1 = (_mutate(s0, rng) if t % 3 else
              AA[rng.integers(0, 20, int(rng.integers(5, 110)))])
        pairs.append((s0, s1, int(rng.integers(0, min(len(s0), 8))),
                      int(rng.integers(0, min(len(s1), 8)))))
    B, pad = len(pairs), 128
    tok0 = np.zeros((B, pad), np.uint8)
    tok1 = np.zeros((B, pad), np.uint8)
    len0 = np.zeros(B, np.int32)
    len1 = np.zeros(B, np.int32)
    swapped = np.zeros(B, bool)
    qst = np.array([p[2] for p in pairs], np.int64)
    sst = np.array([p[3] for p in pairs], np.int64)
    for r, (s0, s1, q, s) in enumerate(pairs):
        swapped[r] = not len(s0) - q < len(s1) - s
        c, w = (s1[s:], s0[q:]) if swapped[r] else (s0[q:], s1[s:])
        tok0[r, :len(c)], tok1[r, :len(w)] = c, w
        len0[r], len1[r] = len(c), len(w)
    best = _np(tsw.sw_align_batch(*_torch((tok0, tok1, len0, len1))))
    res = tsw.postprocess_batch(best, qst, sst, swapped)
    for r, (s0, s1, q, s) in enumerate(pairs):
        o = kswat_oracle(s0.tobytes().decode(), s1.tobytes().decode(), q, s)
        got = (round(float(res['idy'][r]), 6), int(res['aln'][r]),
               int(res['mis'][r]), int(res['gap'][r]), int(res['qst'][r]),
               int(res['qed'][r]), int(res['sst'][r]), int(res['sed'][r]),
               int(res['bit'][r]), int(res['score'][r]))
        want = (round(o.idy, 6), o.aln, o.mis, o.gap, o.qst, o.qed, o.sst,
                o.sed, o.bit, o.raw_score)
        assert got == want, r


def test_matches_pallas_interpret():
    """One B = 128 batch against the Pallas kernel in interpret mode, the
    way test_pallas_sw.py runs it on the CPU."""
    from swiftortho_tpu.ops.banded_sw_pallas import sw_align_batch_pallas
    batch = _case('mixed', B=128, L=64, seed=2)
    pal = sw_align_batch_pallas(*batch, interpret=True)
    _assert_same(_np(tsw.sw_align_batch(*_torch(batch))), _np(pal))


def test_postprocess_matches_jax():
    from swiftortho_tpu.ops.banded_sw import postprocess_batch as jax_post
    batch = _case('mixed', seed=3)
    best = sw_align_batch_native(*batch)
    rng = np.random.default_rng(3)
    B = len(batch[0])
    qst = rng.integers(0, 9, B)
    sst = rng.integers(0, 9, B)
    swapped = rng.random(B) < 0.5
    got = tsw.postprocess_batch(best, qst, sst, swapped)
    want = jax_post(best, qst, sst, swapped)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_scoring_tables_agree():
    """The kernel's byte->code map and code table give B62_BYTES for every
    byte pair; the plain version reads B62_BYTES itself."""
    tab = tsw.scoring_tables('cpu')
    codes = tab['codes'].numpy()
    b2c, sub = codes[:256], codes[256:].reshape(32, 32)
    assert np.array_equal(sub[b2c[:, None], b2c[None, :]], B62_BYTES)
    assert np.array_equal(tab['sub_flat'].numpy(), B62_BYTES.reshape(-1))


def test_auto_on_cpu_is_plain():
    args = _torch(_case('mixed', B=40, seed=4))
    for so in (False, True):
        _assert_same(_np(tsw.sw_align_auto(*args, score_only=so)),
                     _np(tsw.sw_align_batch(*args, score_only=so)))


def test_auto_rejects_other_devices():
    args = _torch(_case('tiny_empty', B=4), device='meta')
    with pytest.raises(ValueError, match='meta'):
        tsw.sw_align_auto(*args)


def test_kernel_wrapper_rejects_cpu_tensors():
    before = dict(tcu.launches)
    with pytest.raises(ValueError, match='CUDA'):
        tcu.sw_align_batch_cuda(*_torch(_case('tiny_empty', B=4)))
    assert tcu.launches == before


def test_kernel_wrapper_checks_the_batch_first():
    """A malformed batch is refused before the device is looked at, and
    nothing is counted."""
    t0, t1, l0, l1 = _case('tiny_empty', B=4)
    before = dict(tcu.launches)
    with pytest.raises(ValueError, match=r'\(B, L0\)'):
        tcu.sw_align_batch_cuda(*_torch((t0, t1[:3], l0, l1)))
    with pytest.raises(ValueError, match='uint8'):
        tcu.sw_align_batch_cuda(*_torch((t0.astype(np.int32), t1, l0, l1)))
    assert tcu.launches == before


@pytest.mark.parametrize('bad', ['dtype', 'width0', 'width_max', 'rows',
                                 'len_shape'])
def test_batch_checks(bad):
    t0, t1, l0, l1 = _case('tiny_empty', B=6)
    if bad == 'dtype':
        t0 = t0.astype(np.int32)
    elif bad == 'width0':
        t0 = t0[:, :0]
    elif bad == 'width_max':
        t1 = np.zeros((6, tsw.MAX_LEN + 1), np.uint8)
    elif bad == 'rows':
        t1 = t1[:5]
    else:
        l1 = l1[:5]
    with pytest.raises(ValueError):
        tsw.sw_align_batch(*_torch((t0, t1, l0, l1)))


# --------------------------------------------------------------- card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('score_only', [False, True])
@pytest.mark.parametrize('name', CASES)
def test_kernel_matches_plain(cuda_device, name, score_only):
    batch = _case(name, seed=5)
    args = _torch(batch, cuda_device)
    before = dict(tcu.launches)
    got = tcu.sw_align_batch_cuda(*args, score_only=score_only)
    torch.cuda.synchronize()
    variant = 'score_only' if score_only else 'full'
    assert tcu.launches[variant] == before[variant] + 1
    got = dict(zip(FIELDS, got.cpu().numpy().astype(np.int64)))
    _assert_same(got, _np(tsw.sw_align_batch(*args, score_only=score_only)))
    want = _np(sw_align_batch_native(*batch))
    if score_only:
        want.update({k: np.zeros_like(want[k]) for k in FIELDS[3:]})
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [300, 8192])
@pytest.mark.parametrize('L', [500, 1536, 501])
def test_kernel_long_mixed_batch(cuda_device, L, B):
    """Both lane counts of score-only (8 lanes a pair under 8,192 pairs,
    4 from there); a width that is no multiple of 4 stages its rows by
    plain loads instead of cp.async."""
    rng = np.random.default_rng(L)
    t0 = AA[rng.integers(0, 20, (B, L))]
    t1 = t0.copy()
    t1[B // 3:] = AA[rng.integers(0, 20, (B - B // 3, L))]
    l0 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    l1 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    want = _np(sw_align_batch_native(t0, t1, l0, l1))
    for so in (False, True):
        got = tcu.sw_align_batch_cuda(*_torch((t0, t1, l0, l1), cuda_device),
                                      score_only=so)
        got = dict(zip(FIELDS, got.cpu().numpy().astype(np.int64)))
        if so:
            want = dict(want, **{k: np.zeros_like(want[k])
                                 for k in FIELDS[3:]})
        _assert_same(got, want)


@pytest.mark.cuda
def test_auto_on_cuda_never_runs_plain(cuda_device, monkeypatch):
    def plain(*a, **k):
        raise AssertionError('plain version called for CUDA tensors')
    monkeypatch.setattr(tsw, 'sw_align_batch', plain)
    batch = _case('mixed', B=20, seed=6)
    got = tsw.sw_align_auto(*_torch(batch, cuda_device))
    _assert_same(_np(got), _np(sw_align_batch_native(*batch)))


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    t0, t1, l0, l1 = _torch(_case('mixed', B=8), cuda_device)
    with pytest.raises(ValueError, match='contiguous'):
        tcu.sw_align_batch_cuda(t0[:, ::2], t1, l0, l1)
