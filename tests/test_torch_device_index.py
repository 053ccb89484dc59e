"""Device index build on the port (swiftortho_tpu_torch.ops.index_device)
against the JAX package's ``build_index_device`` and the host
``build_index``: the same CSR, postings, soas and threshold, exactly
(mirrors tests/test_device_index.py).  The FNV step in int64 is held
against numpy's uint32 arithmetic where the products wrap past 2^32.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu.config import SearchConfig
from swiftortho_tpu.corpus import make_corpus, write_corpus
from swiftortho_tpu.io_fasta import SeqDB
from swiftortho_tpu.ops.index import build_index
from swiftortho_tpu.ops.seeds import FNV_BASIS, FNV_PRIME
from swiftortho_tpu_torch.ops import index_device as port
from swiftortho_tpu_torch.search import blastp as port_blastp

CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp('tdix')
    fsa = str(p / 'c.fsa')
    write_corpus(fsa, make_corpus(n_taxa=3, n_families=30, seed=9,
                                  min_len=40, max_len=180))
    return SeqDB.from_path(fsa)


@pytest.fixture(scope='module')
def masked_db(tmp_path_factory):
    fsa = str(tmp_path_factory.mktemp('tdix_x') / 'x.fsa')
    with open(fsa, 'w') as fh:
        fh.write('>t|a\nMKVLAWDERTYHxxxxXXACDEFGHIKLMNPQRSTVWY\n'
                 '>t|b\nACDxFGHIKLMNPQRSTVWYACDEFGHIK\n')
    return SeqDB.from_path(fsa)


def _assert_same(a, b):
    for f in ('start', 'locus', 'soas', 'sid', 'sst'):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.nc, a.seq_offset, a.threshold, a.mink) == \
        (b.nc, b.seq_offset, b.threshold, b.mink)


CASES = {
    'single_pattern': (0, None, ['aa9'], '11111111', 262144, 1),
    # several alphabets x patterns: the dedup within an alphabet and the
    # alphabet-major order
    'multi_alphabet_multi_pattern': (0, None, ['aa9', 'aa20'],
                                     '1110101,11011', 65536, 1),
    # a mid-corpus chunk (seq_offset != 0) with a window stride
    'chunk_range_step': (1 / 3, 2 / 3, ['aa9'], '111111', 32768, 3),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_host_and_jax(corpus, case):
    from swiftortho_tpu.ops.index_device import build_index_device as jax_b
    lo, hi, alphabets, ssps, nc, step = CASES[case]
    n = len(corpus)
    start, end = int(lo * n), (n if hi is None else int(hi * n))
    args = (corpus, start, end, alphabets, ssps, nc, step)
    got = port.build_index_device(*args, device=CPU)
    _assert_same(got, build_index(*args))
    _assert_same(got, jax_b(*args))


def test_masked_residues(masked_db):
    # seg-masked x/X residues invalidate every window that covers them
    from swiftortho_tpu.ops.index_device import build_index_device as jax_b
    args = (masked_db, 0, 2, ['aa9'], '11011', 4096)
    got = port.build_index_device(*args, device=CPU)
    _assert_same(got, build_index(*args))
    _assert_same(got, jax_b(*args))


def test_threshold_override(corpus):
    args = (corpus, 0, len(corpus), ['aa9'], '11111111', 262144, 1, 7)
    got = port.build_index_device(*args, device=CPU)
    assert got.threshold == 7
    _assert_same(got, build_index(*args))


def test_fnv_step_wraps_like_uint32():
    """Products of the 32-bit state and the prime pass 2^32 (up to
    2^57): the int64 step masked to 32 bits equals numpy's wrapping
    uint32 multiply."""
    rng = np.random.default_rng(3)
    h = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    h[:3] = [0xFFFFFFFF, FNV_BASIS, 0x80000000]
    c = rng.integers(0, 256, 4096).astype(np.uint32)
    assert (h.astype(np.uint64) * int(FNV_PRIME)).max() >= 1 << 56
    want = h.copy()
    for _ in range(3):
        want = (want ^ c) * FNV_PRIME                 # wraps mod 2^32
    got = torch.from_numpy(h.astype(np.int64))
    for _ in range(3):
        got = port.fnv_step(got, torch.from_numpy(c.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) < 1 << 32 and int(got.min()) >= 0


def test_range_fallback_logs_and_matches(corpus, monkeypatch):
    supported = port.device_index_supported
    assert supported(10 ** 6, 120_000_000, 2)
    assert not supported(1 << 40, 1 << 24, 1)
    events = []
    monkeypatch.setattr(port, 'device_index_supported', lambda *a: False)
    monkeypatch.setattr(port, 'log_event',
                        lambda stage, **kw: events.append(stage))
    args = (corpus, 0, len(corpus), ['aa9'], '11111111', 262144)
    got = port.build_index_device(*args, device=CPU)
    assert events == ['device_index_fallback']
    _assert_same(got, build_index(*args))


def test_search_end_to_end_identical(corpus, monkeypatch):
    """find_hit rows with SWIFTORTHO_INDEX=device (several chunks) equal
    the JAX package's host-index rows."""
    from swiftortho_tpu.search.blastp import blastp_stream
    cfg = SearchConfig(expect=1e-5, nc=262144, chunk=17, query_batch=32)
    jax_rows = list(blastp_stream(corpus, corpus, cfg))
    assert jax_rows
    monkeypatch.setenv('SWIFTORTHO_INDEX', 'device')
    events = []
    monkeypatch.setattr(port, 'log_event',
                        lambda stage, **kw: events.append(stage))
    rows = list(port_blastp.blastp_stream(corpus, corpus, cfg, device=CPU))
    assert rows == jax_rows
    assert events.count('device_index') == -(-len(corpus) // 17)


@pytest.mark.cuda
def test_cuda_index_matches_cpu(corpus):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    for case in sorted(CASES):
        lo, hi, alphabets, ssps, nc, step = CASES[case]
        n = len(corpus)
        args = (corpus, int(lo * n), n if hi is None else int(hi * n),
                alphabets, ssps, nc, step)
        _assert_same(port.build_index_device(*args,
                                             device=torch.device('cuda')),
                     build_index(*args))
