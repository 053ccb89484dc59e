"""Pair packing on the device (swiftortho_tpu_torch.ops.device_pack)
against numpy, the JAX package's ``_pack`` and its ``DevicePackContext``
routing, and the whole search under ``SWIFTORTHO_DEVICE_PACK=force``
against the JAX package's rows (mirrors tests/test_device_pack.py without
the mesh classes).  One test turns on all three device routes at once.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu.config import SearchConfig
from swiftortho_tpu.corpus import make_corpus, write_corpus
from swiftortho_tpu.io_fasta import SeqDB
from swiftortho_tpu.ops import device_pack as jax_pack
from swiftortho_tpu_torch.ops import device_pack as port
from swiftortho_tpu_torch.search import blastp as port_blastp

CPU = torch.device('cpu')
CFG = dict(expect=1e-5, nc=262144, query_batch=96)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    fsa = str(tmp_path_factory.mktemp('tdpack') / 'c.fsa')
    write_corpus(fsa, make_corpus(n_taxa=3, n_families=45, seed=5,
                                  min_len=60, max_len=200))
    return SeqDB.from_path(fsa)


@pytest.fixture(scope='module')
def jax_rows(corpus):
    from swiftortho_tpu.search.blastp import blastp_stream
    rows = list(blastp_stream(corpus, corpus, SearchConfig(**CFG)))
    assert len(rows) > 100
    return rows


def _search(corpus, cfg=None, waves=None):
    """The port's rows on the CPU; ``waves`` collects search_wave events
    (``search.blastp`` logs through the port's own ``utils``)."""
    import swiftortho_tpu_torch.utils as U
    orig = U.log_event

    def spy(stage, **kw):
        if stage == 'search_wave' and waves is not None:
            waves.append(kw)
    U.log_event = spy
    try:
        return list(port_blastp.blastp_stream(
            corpus, corpus, cfg or SearchConfig(**CFG), device=CPU))
    finally:
        U.log_event = orig


def test_pack_matches_numpy_and_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    n_db, w_db, n_q, w_q, B, L = 37, 256, 11, 128, 300, 96
    db_tab = rng.integers(0, 24, (n_db, w_db), dtype=np.uint8)
    wave = rng.integers(0, 24, (n_q, w_q), dtype=np.uint8)
    idx = rng.integers(0, n_db + n_q, B)
    width = np.where(idx < n_db, w_db, w_q)
    off = rng.integers(0, width)
    n = np.minimum(rng.integers(0, L + 1, B), width - off)
    want = np.zeros((B, L), np.uint8)
    for b in range(B):
        row = db_tab[idx[b]] if idx[b] < n_db else wave[idx[b] - n_db]
        seg = row[off[b]:off[b] + n[b]]
        want[b, :len(seg)] = seg
    got = port._pack(*(torch.from_numpy(x) for x in (db_tab, wave, idx,
                                                      off, n)), L)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    table = np.zeros((n_db + n_q, w_db), np.uint8)     # the JAX layout
    table[:n_db] = db_tab
    table[n_db:, :w_q] = wave
    jx = jax_pack._pack(jnp.asarray(table), jnp.asarray(idx),
                        jnp.asarray(off.astype(np.int32)),
                        jnp.asarray(n.astype(np.int32)), L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx))


def test_forced_pack_byte_identical(corpus, jax_rows, monkeypatch):
    """Every pair packed on the device, with the score-only prepass
    forced on so both kernel variants run through the packed route."""
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    monkeypatch.setattr(port_blastp, 'use_prepass', lambda device: True)
    port.reset_prof()
    waves = []
    assert _search(corpus, waves=waves) == jax_rows
    assert sum(w['packed_pairs'] for w in waves) > 0
    assert sum(w['gathered_pairs'] for w in waves) == 0
    assert port.PROF['pairs']['score_only'] > port.PROF['pairs']['full'] > 0


def test_default_route_unchanged(corpus, jax_rows, monkeypatch):
    """Unset (auto means TPU backends only) and '0' keep the host gather."""
    monkeypatch.delenv('SWIFTORTHO_DEVICE_PACK', raising=False)
    assert not port.DevicePackContext(corpus, CPU).active()
    waves = []
    assert _search(corpus, waves=waves) == jax_rows
    assert sum(w['packed_pairs'] for w in waves) == 0
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', '0')
    assert not port.DevicePackContext(corpus, CPU).active()
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    assert port.DevicePackContext(corpus, CPU).active()


def test_mixed_fit_split(corpus, jax_rows, monkeypatch):
    """Subjects longer than the table stride take the host gather inside
    the same bucket; the merged rows are unchanged."""
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    monkeypatch.setattr(port, 'STRIDE_CAP', 128)
    assert int((corpus.lengths > 128).sum()) > 0
    waves = []
    assert _search(corpus, waves=waves) == jax_rows
    assert sum(w['packed_pairs'] for w in waves) > 0
    assert sum(w['gathered_pairs'] for w in waves) > 0


def test_multi_chunk_pack(corpus, monkeypatch):
    """The device table spans the whole reference, so every chunk's
    candidates reuse it."""
    from swiftortho_tpu.search.blastp import blastp_stream
    cfg = SearchConfig(expect=1e-5, nc=262144, chunk=40, query_batch=96)
    want = list(blastp_stream(corpus, corpus, cfg))
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    assert len(corpus) > 80 and _search(corpus, cfg) == want


def test_score_only_fields(corpus, monkeypatch):
    """score_only gives the full run's score/bi/bj and zero statistics."""
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    ctx = port.DevicePackContext(corpus, CPU)
    toks = np.zeros((4, 128), np.uint8)
    wv = ctx.wave_table(toks)
    assert ctx.wave_table(toks)[0] is wv[0]       # cached by identity
    rng = np.random.default_rng(1)
    n = 64
    i0 = rng.integers(0, len(corpus), n)
    i1 = rng.integers(0, len(corpus), n)
    ln0 = np.minimum(corpus.lengths[i0], 96).astype(np.int64)
    ln1 = np.minimum(corpus.lengths[i1], 96).astype(np.int64)
    z = np.zeros(n, np.int64)
    full = ctx.run(wv, i0, z, ln0, i1, z, ln1, L0=96, L1=96)
    sc = ctx.run(wv, i0, z, ln0, i1, z, ln1, L0=96, L1=96, score_only=True)
    for k in ('score', 'bi', 'bj'):
        np.testing.assert_array_equal(sc[k], full[k])
    assert full['aln'].any() and not any(sc[k].any() for k in
                                         ('idy', 'aln', 'mis', 'gap'))


def _partial(corpus, monkeypatch, rows):
    """A port context and a JAX context over a table of ``rows`` rows."""
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    probe = jax_pack.DevicePackContext(corpus)
    monkeypatch.setenv('SWIFTORTHO_PACK_CAP', str(rows * probe.stride))
    return (port.DevicePackContext(corpus, CPU),
            jax_pack.DevicePackContext(corpus))


def _same_routing(a, b):
    for f in ('sel', 'row_of', 'fits'):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.n_db, a.stride, a.selected) == (b.n_db, b.stride, b.selected)


def test_partial_table_byte_identical(corpus, jax_rows, monkeypatch):
    """Half the reference fits: the resident rows pack on the device,
    the rest take the host gather per pair."""
    ctx, jctx = _partial(corpus, monkeypatch, len(corpus) // 2)
    assert 0 < ctx.n_db < len(corpus)
    assert ctx.fits[:ctx.n_db].any() and not ctx.fits[ctx.n_db:].any()
    _same_routing(ctx, jctx)
    waves = []
    assert _search(corpus, waves=waves) == jax_rows
    assert sum(w['packed_pairs'] for w in waves) > 0
    assert sum(w['gathered_pairs'] for w in waves) > 0


def test_hot_set_selection_matches_jax(corpus, monkeypatch):
    """The most-hit subjects become resident (ties by id), as in the JAX
    package: the same sel, row_of and fits, and the same table rows."""
    import jax.numpy as jnp  # noqa: F401 - the JAX table is a jax array
    n = len(corpus)
    ctx, jctx = _partial(corpus, monkeypatch, 4)
    assert ctx.n_db == 4 and not ctx.selected
    sample = np.array([n - 1] * 9 + [n - 2] * 5 + [5, 7, 7, 5])
    assert ctx.maybe_select(sample) and jctx.maybe_select(sample)
    _same_routing(ctx, jctx)
    np.testing.assert_array_equal(ctx.sel, np.sort([n - 1, n - 2, 5, 7]))
    assert not ctx.maybe_select(np.array([0, 1, 2]))      # one-shot
    tab = ctx._table()
    assert tab.device == CPU and tab.dtype == torch.uint8
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jctx._table()))
    for r, sid in enumerate(ctx.sel):
        s = corpus.tokens[corpus.offsets[sid]:corpus.offsets[sid + 1]]
        np.testing.assert_array_equal(tab[r, :len(s)].numpy(), s)


def test_overlong_rows_never_selected(corpus, monkeypatch):
    monkeypatch.setattr(port, 'STRIDE_CAP', 128)
    monkeypatch.setattr(jax_pack, 'STRIDE_CAP', 128)
    ctx, jctx = _partial(corpus, monkeypatch, 6)
    long_id = int(np.argmax(corpus.lengths))
    sample = np.array([long_id] * 50 + [2, 3])
    ctx.maybe_select(sample)
    jctx.maybe_select(sample)
    assert long_id not in ctx.sel and not ctx.fits[long_id]
    _same_routing(ctx, jctx)


def test_partial_with_selection_byte_identical(corpus, jax_rows,
                                               monkeypatch):
    """A quarter-size table with the hot-set pick on the first wave."""
    seen = {}
    orig = port.DevicePackContext.maybe_select

    def spy(self, subjects):
        r = orig(self, subjects)
        if r:
            seen['sel'] = self.sel.copy()
            seen['n_db'] = self.n_db
        return r
    monkeypatch.setattr(port.DevicePackContext, 'maybe_select', spy)
    _partial(corpus, monkeypatch, len(corpus) // 4)
    assert _search(corpus) == jax_rows
    assert 'sel' in seen and len(seen['sel']) == seen['n_db']


def test_all_three_routes_match_jax(corpus, jax_rows, monkeypatch):
    """The device index, the device candidate engine and the packed
    pairs together write the JAX package's default rows."""
    monkeypatch.setenv('SWIFTORTHO_INDEX', 'device')
    monkeypatch.setenv('SWIFTORTHO_CANDIDATES', 'device')
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    waves = []
    assert _search(corpus, waves=waves) == jax_rows
    assert sum(w['gathered_pairs'] for w in waves) == 0


@pytest.mark.cuda
def test_cuda_pack_route_matches_cpu(corpus, jax_rows, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from swiftortho_tpu_torch.ops import banded_sw_cuda
    monkeypatch.setenv('SWIFTORTHO_INDEX', 'device')
    monkeypatch.setenv('SWIFTORTHO_CANDIDATES', 'device')
    monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    banded_sw_cuda.reset_counters()
    port.reset_prof()
    rows = list(port_blastp.blastp_stream(corpus, corpus,
                                          SearchConfig(**CFG),
                                          device=torch.device('cuda')))
    assert rows == jax_rows
    assert banded_sw_cuda.launches['score_only'] > 0
    assert banded_sw_cuda.launches['full'] > 0
    assert port.PROF['pairs']['score_only'] > port.PROF['pairs']['full'] > 0
