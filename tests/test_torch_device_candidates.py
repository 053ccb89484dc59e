"""Device candidate engine on the port (swiftortho_tpu_torch.search.
candidates_device) against the JAX package's ``generate_candidates_device``
and the host ``generate_candidates``: identical Candidates arrays (mirrors
tests/test_device_candidates.py), plus units of the pieces where torch
differs from XLA (the segmented max-scan, the accept rounds, the chunked
x-drop walk) against the JAX functions on seeded random inputs.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu.config import SearchConfig
from swiftortho_tpu.constants import AA9, AA20
from swiftortho_tpu.corpus import make_corpus, write_corpus
from swiftortho_tpu.io_fasta import SeqDB
from swiftortho_tpu.ops.index import build_index
from swiftortho_tpu.search.candidates import generate_candidates
from swiftortho_tpu_torch.search import blastp as port_blastp
from swiftortho_tpu_torch.search import candidates_device as port
from swiftortho_tpu_torch.search.blastp import _mask_queries

CPU = torch.device('cpu')
FIELDS = ('qrow', 'subject', 'score', 'band_q', 'band_s')
CASES = [([AA9], '11111111'), ([AA20], '1111111'), ([AA9, AA20], '11111111'),
         ([AA9], '1101011,111111')]


def _assert_same(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.fixture(scope='module')
def corpus_db(tmp_path_factory):
    corpus = make_corpus(n_taxa=3, n_families=25, seed=21,
                         min_len=60, max_len=200)
    p = tmp_path_factory.mktemp('tdevc') / 'c.fsa'
    write_corpus(str(p), corpus)
    return SeqDB.from_path(str(p))


def _events(monkeypatch):
    events = []
    monkeypatch.setattr(port, 'log_event',
                        lambda stage, **kw: events.append((stage, kw)))
    return events


@pytest.mark.parametrize('case', range(len(CASES)))
def test_parity_batches(corpus_db, case):
    from swiftortho_tpu.search.candidates_device import \
        generate_candidates_device as jax_gen
    alpha, ssps = CASES[case]
    db = corpus_db
    ix = build_index(db, 0, min(40, len(db)), alpha, ssps, 1 << 18)
    for wst in (0, 32):
        idx = np.arange(wst, min(wst + 32, len(db)), dtype=np.int64)
        toks, lens = _mask_queries(db, idx, 256, True)
        host = generate_candidates(toks, lens, db, ix, alpha, ssps)
        got = port.generate_candidates_device(toks, lens, db, ix, alpha,
                                              ssps, device=CPU)
        assert len(host.subject) > 0
        _assert_same(got, host)
        _assert_same(got, jax_gen(toks, lens, db, ix, alpha, ssps))


def test_parity_second_chunk(corpus_db):
    """A chunk with seq_offset > 0: the locus decode and global ids."""
    from swiftortho_tpu.search.candidates_device import \
        generate_candidates_device as jax_gen
    db = corpus_db
    ix = build_index(db, 30, 60, [AA9], '11111111', 1 << 18)
    toks, lens = _mask_queries(db, np.arange(16, dtype=np.int64), 256, True)
    host = generate_candidates(toks, lens, db, ix, [AA9], '11111111')
    got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                          '11111111', device=CPU)
    assert len(host.subject) > 0
    _assert_same(got, host)
    _assert_same(got, jax_gen(toks, lens, db, ix, [AA9], '11111111'))


def test_empty_queries(corpus_db):
    db = corpus_db
    ix = build_index(db, 0, 20, [AA9], '11111111', 1 << 18)
    toks = np.full((4, 64), ord('x'), np.uint8)       # fully masked
    lens = np.full(4, 60, np.int64)
    got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                          '11111111', device=CPU)
    assert all(len(getattr(got, f)) == 0 for f in FIELDS)


def test_posting_cap_falls_back(corpus_db, monkeypatch):
    """A query whose postings exceed the cap sends the wave to the host
    engine (identical results) and says so in a log event."""
    monkeypatch.setenv('SWIFTORTHO_DEVICE_CAND_CAP', '1')
    events = _events(monkeypatch)
    db = corpus_db
    ix = build_index(db, 0, 20, [AA9], '11111111', 1 << 18)
    toks, lens = _mask_queries(db, np.arange(8, dtype=np.int64), 128, True)
    got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                          '11111111', device=CPU)
    host = generate_candidates(toks, lens, db, ix, [AA9], '11111111')
    assert len(host.subject) > 0
    _assert_same(got, host)
    assert [(s, kw['reason']) for s, kw in events] == [
        ('device_candidates_fallback', 'cap')]


def test_unsupported_ranges_fall_back(corpus_db, monkeypatch):
    events = _events(monkeypatch)
    db = corpus_db
    ix = build_index(db, 0, 10, [AA9], '11111111', 1 << 18)
    assert not port.device_path_supported(np.zeros((1, 1 << 14), np.uint8),
                                          db, ix)
    toks, lens = _mask_queries(db, np.arange(4, dtype=np.int64), 1 << 14,
                               True)
    got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                          '11111111', device=CPU)
    _assert_same(got, generate_candidates(toks, lens, db, ix, [AA9],
                                          '11111111'))
    assert [(s, kw['reason']) for s, kw in events] == [
        ('device_candidates_fallback', 'range')]


def test_chunked_stage2_identical(corpus_db, monkeypatch):
    """A cap that forces several query-row blocks gives the host
    engine's Candidates (chain groups are per query, so row blocks never
    split a group), and logs the chunking, not a fallback."""
    db = corpus_db
    ix = build_index(db, 0, 40, [AA9], '11111111', 1 << 18)
    toks, lens = _mask_queries(db, np.arange(24, dtype=np.int64), 256, True)
    host = generate_candidates(toks, lens, db, ix, [AA9], '11111111')
    q = torch.from_numpy(toks)
    _, counts = port.stage1_seeds(
        q, torch.from_numpy(lens.astype(np.int32)),
        port.tables((AA9,), CPU), torch.from_numpy(ix.start.astype(np.int32)),
        ix.nc, ix.threshold, port.streams((AA9,), '11111111'))
    row_tot = counts.sum((0, 2)).numpy()
    assert row_tot.sum() > row_tot.max() > 0
    cap = int(row_tot.max())
    assert len(port.row_blocks(row_tot, cap)) >= 2
    monkeypatch.setenv('SWIFTORTHO_DEVICE_CAND_CAP', str(cap))
    events = _events(monkeypatch)
    got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                          '11111111', device=CPU)
    stages = [s for s, _ in events]
    assert 'device_candidates_chunked' in stages
    assert 'device_candidates_fallback' not in stages
    ev = [kw for s, kw in events if s == 'device_candidates'][0]
    assert ev['blocks'] >= 2
    for k in ('stage1_s', 'expand_sort_s', 'right_walk_s', 'accept_s',
              'left_walk_s'):
        assert ev[k] >= 0
    assert len(host.subject) > 0
    _assert_same(got, host)


def test_device_caches_under_threads(corpus_db):
    """Phase A calls the engine from several threads: the per-index and
    per-db device copies are made once and shared (a lost check-then-act
    would hand threads different copies), and every thread gets the host
    engine's Candidates."""
    import sys
    import threading
    db = corpus_db
    ix = build_index(db, 0, 40, [AA9], '11111111', 1 << 18)
    toks, lens = _mask_queries(db, np.arange(24, dtype=np.int64), 256, True)
    want = generate_candidates(toks, lens, db, ix, [AA9], '11111111')
    seen, errors = [], []
    gate = threading.Barrier(16)

    def work():
        try:
            gate.wait(timeout=60)
            arrs = port._device_index(ix, CPU) + port._device_db(db, CPU)
            got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                                  '11111111', device=CPU)
            _assert_same(got, want)
            seen.append(tuple(id(a) for a in arrs))
        except Exception as e:          # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(seen) == 16 and len(set(seen)) == 1


def test_row_blocks():
    assert port.row_blocks(np.array([3, 4, 0, 9, 1, 1]), 7) == [
        (0, 3), (3, 4), (4, 6)]
    assert port.row_blocks(np.array([5, 5]), 100) == [(0, 2)]


def test_blastp_rows_identical(corpus_db, monkeypatch):
    """find_hit rows with SWIFTORTHO_CANDIDATES=device equal the JAX
    package's (host engine) rows."""
    from swiftortho_tpu.search.blastp import blastp_stream
    db = corpus_db
    cfg = SearchConfig(expect=1e-5, nc=262144, chunk=30, query_batch=32)
    want = list(blastp_stream(db, db, cfg))
    monkeypatch.setenv('SWIFTORTHO_CANDIDATES', 'device')
    events = _events(monkeypatch)
    got = list(port_blastp.blastp_stream(db, db, cfg, device=CPU))
    assert want and got == want
    assert sum(s == 'device_candidates' for s, _ in events) > 2


# ---- units against the JAX functions, seeded random inputs ----

def test_seg_max_scan_matches_jax():
    import jax
    import jax.numpy as jnp
    from swiftortho_tpu.search.candidates_device import _seg_max_scan
    rng = np.random.default_rng(11)
    n = 3000
    # sparse flags, then dense ones; small values, then the full int32
    # range
    flags = rng.random(n) < np.where(np.arange(n) < n // 2, 0.02, 0.3)
    vals = rng.integers(-1, 50, n).astype(np.int32)
    vals[n // 3:] = rng.integers(-(1 << 31), (1 << 31) - 1, n - n // 3)
    want = np.asarray(jax.jit(_seg_max_scan)(jnp.asarray(flags),
                                            jnp.asarray(vals)))
    got = port.seg_max_scan(torch.from_numpy(flags), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    one = port.seg_max_scan(torch.tensor([False]), torch.tensor([-7]))
    assert one.tolist() == [-7]


@pytest.mark.parametrize('n', [1, 1024, 1025, 3 * 1024 * 1024 + 17])
def test_two_level_scans(n):
    from swiftortho_tpu_torch.ops.scan import cummax_1d, cumsum_1d
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    flags = torch.from_numpy(rng.random(n) < 0.3)
    assert torch.equal(cummax_1d(x), torch.cummax(x, 0).values)
    assert torch.equal(cumsum_1d(x), torch.cumsum(x, 0))
    assert torch.equal(cumsum_1d(flags), torch.cumsum(flags.long(), 0))


def test_accept_rounds_matches_jax():
    import jax.numpy as jnp
    from swiftortho_tpu.search.candidates_device import _accept_rounds
    rng = np.random.default_rng(12)
    sizes = rng.integers(1, 8, 400)
    C = int(sizes.sum())
    new_seg = np.zeros(C, bool)
    new_seg[np.concatenate([[0], np.cumsum(sizes)[:-1]])] = True
    qst = np.concatenate([np.sort(rng.integers(0, 300, s)) for s in sizes])
    E = qst + rng.integers(0, 40, C)
    valid = rng.random(C) < 0.9
    acc_j, qlo_j = _accept_rounds(jnp.asarray(new_seg), jnp.asarray(valid),
                                  jnp.asarray(qst.astype(np.int32)),
                                  jnp.asarray(E.astype(np.int32)))
    acc, qlo, rounds = port.accept_rounds(torch.from_numpy(new_seg),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(qst.astype(np.int64)),
                                  torch.from_numpy(E.astype(np.int64)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(qlo.numpy(), np.asarray(qlo_j))
    assert acc.any() and (~acc.numpy() & valid).any() and rounds >= 2


def _walk_inputs(seed, step):
    """Queries and related subjects (mutated copies) so walks run long;
    points on and off the shared diagonal."""
    rng = np.random.default_rng(seed)
    AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWYx', np.uint8)
    B, L, P = 6, 96, 400
    q = AA[rng.integers(0, 20, (B, L))]
    q[rng.random((B, L)) < 0.02] = ord('x')
    qlen = rng.integers(30, L + 1, B)
    subs = []
    for j in range(9):
        s = q[j % B, :qlen[j % B]].copy()
        mut = rng.random(len(s)) < 0.25
        s[mut] = AA[rng.integers(0, 20, int(mut.sum()))]
        subs.append(s[rng.integers(0, 5):])
    lens = np.array([len(s) for s in subs])
    offs = np.concatenate([[0], np.cumsum(lens)])
    db = np.concatenate(subs)
    qrow = rng.integers(0, B, P)
    sid = rng.integers(0, len(subs), P)
    p_qlen, p_slen = qlen[qrow], lens[sid]
    start_q = rng.integers(0, p_qlen)
    start_s = np.where(rng.random(P) < 0.7, np.minimum(start_q, p_slen - 1),
                       rng.integers(0, p_slen))
    if step == 1:
        first = rng.random(P) < 0.5
        base = np.zeros(P, np.int64)
        qlo = np.where(first, 0, -1)
        slo = np.where(first, 0, -(1 << 30))
    else:
        base = rng.integers(0, 60, P)
        qlo = rng.integers(-1, 5, P)
        slo = rng.integers(-1, 5, P)
    ints = [qrow, offs[sid], start_q, start_s, base, qlo, slo, p_qlen,
            p_slen]
    return q.reshape(-1), db, L, [x.astype(np.int32) for x in ints]


@pytest.mark.parametrize('wc', [1, 7, 32])
@pytest.mark.parametrize('step', [1, -1])
def test_walk_chunked_matches_jax(wc, step, monkeypatch):
    import jax.numpy as jnp
    from swiftortho_tpu.search.candidates_device import (_b62_flat,
                                                         _walk_chunked)
    qtok, db, L, ints = _walk_inputs(100 + wc, step)
    qrow, s_off, sq, ss, base, qlo, slo, qlen, slen = ints
    bj, tj = _walk_chunked(jnp.asarray(qtok.astype(np.int32)),
                           jnp.asarray(db), jnp.asarray(_b62_flat()), L, wc,
                           L + 1, *(jnp.asarray(x) for x in (qrow, s_off,
                                                             sq, ss)),
                           step, *(jnp.asarray(x) for x in (base, qlo, slo,
                                                            qlen, slen)))
    T = torch.from_numpy
    b62 = port.scoring_tables(CPU)['sub_flat']
    args = (T(qtok), T(db), b62, L, wc, L + 1, T(qrow),
            T(s_off.astype(np.int64)), T(sq), T(ss), step, T(base), T(qlo),
            T(slo), T(qlen), T(slen))
    best, best_t = port.walk_chunked(*args)
    np.testing.assert_array_equal(best.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(tj))
    assert (best_t.numpy() > 20).any()          # some walks run long
    # blocks of 37 points: the same results
    monkeypatch.setattr(port, 'WALK_BYTES', 37 * wc * port.CELL_BYTES)
    best2, best_t2 = port.walk_chunked(*args)
    assert torch.equal(best2, best) and torch.equal(best_t2, best_t)


@pytest.mark.cuda
def test_cuda_candidates_match_host(corpus_db):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    db = corpus_db
    for alpha, ssps in CASES:
        ix = build_index(db, 0, min(40, len(db)), alpha, ssps, 1 << 18)
        toks, lens = _mask_queries(db, np.arange(32, dtype=np.int64), 256,
                                   True)
        got = port.generate_candidates_device(toks, lens, db, ix, alpha,
                                              ssps,
                                              device=torch.device('cuda'))
        _assert_same(got, generate_candidates(toks, lens, db, ix, alpha,
                                              ssps))
