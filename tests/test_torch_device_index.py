"""Device index build on the port (swiftortho_tpu_torch.ops.index_device)
against the JAX package's ``build_index_device`` and the host
``build_index``: the same CSR, postings, soas and threshold, exactly
(mirrors tests/test_device_index.py).  The FNV step in int64 is held
against numpy's uint32 arithmetic where the products wrap past 2^32.
The index stays on the device: its host arrays are fetched once, on
first read, and the device candidate engine uses its tensors without a
host round trip.
"""

import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from swiftortho_tpu.config import SearchConfig
from swiftortho_tpu.corpus import make_corpus, write_corpus
from swiftortho_tpu.io_fasta import SeqDB
from swiftortho_tpu.ops.index import build_index
from swiftortho_tpu.ops.seeds import FNV_BASIS, FNV_PRIME
from swiftortho_tpu_torch.ops import index_device as port
from swiftortho_tpu_torch.ops.index import ref_mu_sd
from swiftortho_tpu_torch.search import blastp as port_blastp
from swiftortho_tpu_torch.search import candidates_device as port_cd

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


def _case_args(corpus, case):
    lo, hi, alphabets, ssps, nc, step = CASES[case]
    n = len(corpus)
    return (corpus, int(lo * n), n if hi is None else int(hi * n),
            alphabets, ssps, nc, step)


@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_host_and_jax(corpus, case):
    from swiftortho_tpu.ops.index_device import build_index_device as jax_b
    args = _case_args(corpus, case)
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


def test_no_postings(tmp_path):
    # every window holds an x: an empty CSR and threshold 0, as the host's
    fsa = str(tmp_path / 'n.fsa')
    with open(fsa, 'w') as fh:
        fh.write('>t|a\nMKVxLAWxDERxTYH\n>t|b\nACDxFG\n')
    db = SeqDB.from_path(fsa)
    args = (db, 0, 2, ['aa9'], '11011', 4096)
    got = port.build_index_device(*args, device=CPU)
    assert len(got.locus) == 0 and got.threshold == 0
    _assert_same(got, build_index(*args))


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


def _count_fetches(monkeypatch, delay=0.0):
    """Replace the device index's one device-to-host copy by a counting
    one; returns the list it appends each fetched tensor's size to."""
    fetched = []
    real = port._fetch

    def fetch(t):
        fetched.append(t.numel())
        time.sleep(delay)
        return real(t)
    monkeypatch.setattr(port, '_fetch', fetch)
    return fetched


@pytest.mark.parametrize('case', sorted(CASES))
def test_host_arrays_fetched_lazily(corpus, case, monkeypatch):
    """The build leaves start/sid/sst (int32) and locus on the device and
    fetches nothing; each host array is fetched on its first read, once,
    in the host build's dtype, and equals build_index's and the JAX
    build_index_device's."""
    from swiftortho_tpu.ops.index_device import build_index_device as jax_b
    args = _case_args(corpus, case)
    got = port.build_index_device(*args, device=CPU)
    assert isinstance(got, port.DeviceSeedIndex)
    assert {k: t.dtype for k, t in got.tensors.items()} == {
        'start': torch.int32, 'sid': torch.int32, 'sst': torch.int32,
        'locus': torch.int64}
    fetched = _count_fetches(monkeypatch)
    host, jax_ix = build_index(*args), jax_b(*args)
    for f in ('start', 'locus', 'sid', 'sst'):
        for _ in range(2):
            a = getattr(got, f)
            assert a.dtype == getattr(host, f).dtype, f
            np.testing.assert_array_equal(a, getattr(host, f), err_msg=f)
            np.testing.assert_array_equal(a, getattr(jax_ix, f), err_msg=f)
    assert fetched == [args[5] + 1] + [len(host.locus)] * 3
    _assert_same(got, host)


def test_engine_uses_device_tensors(corpus, monkeypatch):
    """One device engine call on a device-built index fetches no host
    array and uploads none of start/sid/sst (``_on`` sees no array of
    the CSR's or the postings' length); the candidates equal the host
    engine's on the host index.  An index asked for on another
    device is copied from its host arrays."""
    from swiftortho_tpu.search.blastp import _mask_queries
    from swiftortho_tpu.search.candidates import generate_candidates
    args = (corpus, 0, len(corpus), ['aa9'], '11111111', 1 << 18)
    ix = port.build_index_device(*args, device=CPU)
    fetched = _count_fetches(monkeypatch)
    uploads = []
    real_on = port_cd._on

    def on(a, device):
        uploads.append(np.shape(a))
        return real_on(a, device)
    monkeypatch.setattr(port_cd, '_on', on)
    port_cd._DB_CACHE.clear()
    toks, lens = _mask_queries(corpus, np.arange(40, dtype=np.int64), 256,
                               True)
    got = port_cd.generate_candidates_device(toks, lens, corpus, ix,
                                             ['aa9'], '11111111',
                                             device=CPU)
    host = build_index(*args)
    assert fetched == [] and ix._host == {}
    assert uploads and (1 << 18) + 1 not in [u[0] for u in uploads]
    assert (len(host.locus),) not in uploads
    want = generate_candidates(toks, lens, corpus, host, ['aa9'],
                               '11111111')
    for f in ('qrow', 'subject', 'score', 'band_q', 'band_s'):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert all(a is b for a, b in zip(port_cd._device_index(ix, CPU),
                                      (ix.tensors['start'],
                                       ix.tensors['sid'],
                                       ix.tensors['sst'])))
    other = port_cd._device_index(ix, torch.device('meta'))
    assert [t.device.type for t in other] == ['meta'] * 3
    assert sorted(ix._host) == ['sid', 'sst', 'start']


def test_concurrent_first_reads_fetch_once(corpus, monkeypatch):
    """Two threads reading ``.start`` at once (phase A's producer and
    prefetch threads) get one fetch and equal arrays."""
    ix = port.build_index_device(corpus, 0, len(corpus), ['aa9'],
                                 '11111111', 1 << 16, device=CPU)
    fetched = _count_fetches(monkeypatch, delay=0.2)
    gate = threading.Barrier(2)
    seen = []

    def read():
        gate.wait(timeout=30)
        seen.append(ix.start)
    threads = [threading.Thread(target=read) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert fetched == [(1 << 16) + 1]
    assert len(seen) == 2 and seen[0] is seen[1]
    np.testing.assert_array_equal(seen[0], build_index(
        corpus, 0, len(corpus), ['aa9'], '11111111', 1 << 16).start)


# Positive bucket counts whose threshold lies on an integer: mu = 154.5
# (6,643 over 43 + 1, the reference's divisor) and sd = 91.75, so
# mu + 2 sd = 338 exactly, and a sum that ran in another order and
# rounded down by one ulp would truncate to 337.
EDGE_COUNTS = [37, 245, 78, 200, 122, 27, 290, 160, 49, 298, 257, 6, 49, 31,
               102, 121, 203, 220, 185, 133, 286, 112, 124, 121, 281, 296,
               278, 176, 214, 124, 6, 177, 239, 33, 270, 163, 157, 256, 59,
               290, 55, 230, 38]


def test_threshold_keeps_the_host_sums(monkeypatch):
    """The CSR and the threshold from the sorted bucket ids on the device
    equal the host's cumsum and ``ref_mu_sd`` over its full bincount, on
    a count vector whose mu + 2 sd lies within 1e-9 of an integer; the
    host sums get the positive counts in bucket order, as the host
    build's ``ref_mu_sd`` does."""
    pos = [Fraction(c) for c in EDGE_COUNTS]
    mu = sum(pos) / (len(pos) + 1)
    var = sum((c - mu) ** 2 for c in pos) / (len(pos) + 1)
    assert (mu, var) == (Fraction(309, 2), Fraction(367, 4) ** 2)
    nc = 5000
    rng = np.random.default_rng(12)
    counts = np.zeros(nc, np.int64)
    counts[np.sort(rng.choice(nc, len(EDGE_COUNTS), replace=False))] = \
        EDGE_COUNTS
    b = rng.permutation(np.repeat(np.arange(nc), counts))
    host = np.bincount(b, minlength=nc)
    mu_h, sd_h = ref_mu_sd(host)
    assert abs(mu_h + 2 * sd_h - 338) < 1e-9
    csr, pos = port.csr_of(torch.from_numpy(np.sort(b)), nc)
    np.testing.assert_array_equal(csr.numpy(), np.cumsum(np.r_[0, host]))
    seen = []
    monkeypatch.setattr(port, 'ref_mu_sd',
                        lambda c: seen.append(c) or ref_mu_sd(c))
    assert port.threshold_of(pos) == int(mu_h + 2 * sd_h) == 338
    np.testing.assert_array_equal(seen[0], counts[counts > 0])


def test_event_splits_the_build(corpus, monkeypatch):
    """One ``device_index`` event a build; its ``*_s`` fields are the
    build's stages and nothing else (the benchmark sums them into the
    build's span)."""
    events = []
    monkeypatch.setattr(port, 'log_event',
                        lambda stage, **kw: events.append((stage, kw)))
    port.build_index_device(corpus, 0, len(corpus), ['aa9'], '11111111',
                            1 << 16, device=CPU)
    assert [st for st, _ in events] == ['device_index']
    assert sorted(k for k in events[0][1] if k.endswith('_s')) == \
        ['csr_s', 'decode_s', 'hash_sort_s', 'threshold_s']


def test_postings_past_int32_raise(corpus, monkeypatch):
    """The device CSR is int32: a chunk with 2^31 postings or more
    raises instead of wrapping or falling back."""
    monkeypatch.setattr(port, '_hash_sort', lambda *a: torch.empty(
        1 << 31, dtype=torch.int64, device='meta'))
    with pytest.raises(OverflowError):
        port.build_index_device(corpus, 0, len(corpus), ['aa9'],
                                '11111111', 1 << 16, device=CPU)


@pytest.mark.cuda
def test_cuda_index_matches_cpu(corpus):
    """On the card: the device tensors themselves (start, sid, sst int32,
    locus) equal the host build_index's arrays, and so do the fetched
    host arrays."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    for case in sorted(CASES):
        args = _case_args(corpus, case)
        host = build_index(*args)
        dev = port.build_index_device(*args, device=torch.device('cuda'))
        assert dev.device.type == 'cuda'
        for f in ('start', 'locus', 'sid', 'sst'):
            t = dev.tensors[f]
            want = torch.from_numpy(getattr(host, f)).to(t.device, t.dtype)
            assert torch.equal(t, want), (case, f)
        _assert_same(dev, host)
