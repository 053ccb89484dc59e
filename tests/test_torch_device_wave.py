"""The device wave body (swiftortho_tpu_torch.search.device_wave) on the
CPU against the numpy wave body of ``search.blastp``, the port's native
``rank_cut_native`` and the JAX package: rank and cut, the candidates'
finish, postprocessing and E-values over every bit score in range, the
policy's fast path on waves with unresolved and long-pair queries, and
whole searches through the three device routes whose bytes must be the
JAX package's.  Tolerance 0 throughout: every field is an integer, or a
float64 made from integers by the same operations.  One ``cuda`` test
holds the device wave on the card to the numpy wave there and on the
CPU.  The JAX package is imported inside the tests that use it, so the
card test also collects where JAX is not installed.
"""

import json

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch.config import SearchConfig
from swiftortho_tpu_torch.corpus import make_corpus, write_corpus
from swiftortho_tpu_torch.io_fasta import SeqDB
from swiftortho_tpu_torch.native import rank_cut_native
from swiftortho_tpu_torch.ops.banded_sw import postprocess_batch
from swiftortho_tpu_torch.search import blastp as port_blastp
from swiftortho_tpu_torch.search import candidates_device as cd
from swiftortho_tpu_torch.search import device_wave as dw
from swiftortho_tpu_torch.search.candidates import _finish_candidates

CPU = torch.device('cpu')
ROUTES = {'SWIFTORTHO_INDEX': 'device', 'SWIFTORTHO_CANDIDATES': 'device',
          'SWIFTORTHO_DEVICE_PACK': 'force'}
CAND_FIELDS = ('qrow', 'subject', 'score', 'band_q', 'band_s')


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- rank and cut ----------------------------------------------------------

def rank_cut_numpy(qrow, subj, csc, bq, bs, n_queries, vmax):
    """The numpy branch of blastp's wave body (its spec when the native
    library is missing)."""
    if (len(qrow) and qrow.max() < (1 << 13) and subj.max() < (1 << 21)
            and csc.max() < (1 << 26) and csc.min() >= 0):
        key = ((qrow.astype(np.uint64) << 47)
               | ((np.uint64((1 << 26) - 1) - csc.astype(np.uint64)) << 21)
               | subj.astype(np.uint64))
        order = np.argsort(key, kind='stable')
    else:
        order = np.lexsort((subj, -csc, qrow))
    qrow, subj, csc, bq, bs = (qrow[order], subj[order], csc[order],
                               bq[order], bs[order])
    new_q = np.ones(len(qrow), dtype=bool)
    new_q[1:] = qrow[1:] != qrow[:-1]
    rank = np.arange(len(qrow)) - np.maximum.accumulate(
        np.where(new_q, np.arange(len(qrow)), 0))
    nhits_of = np.zeros(n_queries, dtype=np.int64)
    np.add.at(nhits_of, qrow, 1)
    cut = rank < vmax
    return (qrow[cut], subj[cut], csc[cut], bq[cut], bs[cut], rank[cut],
            nhits_of)


# (queries, subjects, score range, vmax): many ties in score and subject,
# so input order decides; a cut that bites; scores past the packed key
# (the successive stable sorts)
RANK_CASES = {'ties': (40, 60, (25, 33), 600),
              'cut': (16, 3000, (25, 90), 100),
              'wide_scores': (30, 200, (0, 1 << 30), 150),
              'negative_scores': (30, 200, (-40, 40), 150)}


@pytest.mark.parametrize('case', sorted(RANK_CASES))
def test_rank_cut_matches_native_and_numpy(case):
    nq, ns, (lo, hi), vmax = RANK_CASES[case]
    rng = np.random.default_rng(len(case))
    n = 20000
    qrow = rng.integers(0, nq, n)
    qrow[qrow == 3] = 4                      # a query without candidates
    arrs = (qrow, rng.integers(0, ns, n), rng.integers(lo, hi, n),
            rng.integers(0, 300, n), rng.integers(0, 300, n))
    want = rank_cut_native(*arrs, nq, vmax)
    spec = rank_cut_numpy(*arrs, nq, vmax)
    reads = dw.HostReads()
    got = dw.rank_cut_tensors(*_t(*arrs), nq, vmax, reads)
    assert reads.n == 1
    for k in range(6):
        np.testing.assert_array_equal(spec[k], want[k], err_msg=str(k))
        np.testing.assert_array_equal(got[k].numpy(), want[k],
                                      err_msg=str(k))
    np.testing.assert_array_equal(got[6], want[6])
    assert want[6][3] == 0
    assert (want[6] > vmax).any()          # the cut bites


def test_rank_cut_without_candidates():
    z = np.zeros(0, np.int64)
    reads = dw.HostReads()
    got = dw.rank_cut_tensors(*_t(z, z, z, z, z), 5, 600, reads)
    assert reads.n == 0 and all(g.shape == (0,) for g in got[:6])
    np.testing.assert_array_equal(got[6], np.zeros(5, np.int64))


# -- the candidates' finish ------------------------------------------------

@pytest.mark.parametrize('wide', [False, True], ids=['packed', 'lexsort'])
def test_finish_candidates_matches_numpy(wide):
    """Duplicate (query, subject) groups with tied scores and diagonals
    that alias in the packed key's 11 folded bits; ``wide`` puts scores
    past the key's 17 bits, so both take ``np.lexsort``'s order."""
    from swiftortho_tpu.search.candidates import \
        _finish_candidates as jax_finish
    rng = np.random.default_rng(7 + wide)
    n = 30000
    g = (rng.integers(0, 60, n), rng.integers(0, 50, n),
         rng.integers(-5000, 5000, n), rng.integers(0, 60, n))
    if wide:
        g[3][::7] += 1 << 17
    want = _finish_candidates(*g)
    jax_want = jax_finish(*g)
    got = cd.finish_candidates_tensors(*_t(*g))
    assert len(want.qrow) > 1000
    for f in CAND_FIELDS:
        np.testing.assert_array_equal(getattr(want, f),
                                      np.asarray(getattr(jax_want, f)))
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    gated = cd.finish_candidates_tensors(*_t(g[0], g[1], g[2], g[3] * 0))
    assert all(getattr(gated, f).shape == (0,) for f in CAND_FIELDS)


def test_stable_lexsort_is_np_lexsort():
    rng = np.random.default_rng(3)
    keys = [rng.integers(0, k, 5000) for k in (4, 9, 3)]
    np.testing.assert_array_equal(
        cd.stable_lexsort(_t(*keys)).numpy(), np.lexsort(keys))


# -- postprocessing and E-values -------------------------------------------

def test_postprocess_matches_numpy_over_every_score():
    """Every SW score below ``SCORE_LIMIT`` (so every bit score the
    kernel can give), random coordinates, identities and swaps."""
    from swiftortho_tpu.ops.banded_sw import \
        postprocess_batch as jax_postprocess
    scores = np.arange(dw.SCORE_LIMIT, dtype=np.int32)
    B = len(scores)
    rng = np.random.default_rng(11)
    aln = rng.integers(0, 700, B).astype(np.int32)
    aln[::9] = 0
    best = {'score': scores, 'aln': aln,
            'idy': (aln * rng.random(B)).astype(np.int32),
            'mis': rng.integers(0, 50, B).astype(np.int32),
            'gap': rng.integers(0, 50, B).astype(np.int32)}
    for k in ('bi', 'bj', 'sti', 'stj'):
        best[k] = rng.integers(0, 4000, B).astype(np.int32)
    qst, sst = rng.integers(0, 4000, B), rng.integers(0, 4000, B)
    swapped = rng.random(B) < 0.5
    want = postprocess_batch(best, qst, sst, swapped)
    jax_want = jax_postprocess(best, qst, sst, swapped)
    got = dw.postprocess_tensors({k: torch.from_numpy(v)
                                  for k, v in best.items()},
                                 *_t(qst, sst, swapped))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_array_equal(np.asarray(jax_want[k]), w)
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert got['idy'].dtype == torch.float64
    np.testing.assert_array_equal(got['idy'].numpy().view(np.int64),
                                  want['idy'].view(np.int64))


def test_evalues_match_numpy_over_every_bit():
    """E = D * lq * ls * 2^-bit for every bit score of the table, with
    lengths up to 8191 (products in the subnormal range and underflows
    to 0 included), as the fast path (numpy) and the loop (Python
    floats) compute it."""
    bit_of, pow2 = dw.evalue_tables(CPU)
    bits = np.arange(len(pow2))
    assert int(bit_of.max()) == bits[-1] and int(bit_of.min()) >= 0
    np.testing.assert_array_equal(pow2.numpy(), np.power(2.0, -bits * 1.0))
    rng = np.random.default_rng(5)
    n = len(bits)
    for D in (41168, 7):
        lq = rng.integers(1, 8192, n)
        ls = rng.integers(1, 8192, n)
        want = D * lq * ls * np.power(2.0, -bits.astype(np.float64))
        got = dw.evalues(D, *_t(lq, ls, bits)).numpy()
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
        for i in rng.integers(0, n, 2000):
            e = D * int(lq[i]) * int(ls[i]) * (2.0 ** -int(bits[i]))
            assert got[i] == e
    assert (want == 0).any() and ((want > 0) & (want < 2.3e-308)).any()


# -- the policy's fast path ------------------------------------------------

def synthetic_wave(seed, nq=300, v=500, max_miss=1e-3):
    """A ranked wave: per query a run of pairs (some queries without
    any), pass flags from dense to sparse (stops inside and past the
    first rung), only ranks below the first rung aligned, a few long
    pairs."""
    rng = np.random.default_rng(seed)
    cfg = SearchConfig(v=v, max_miss=max_miss)
    seg = rng.integers(0, 400, nq)
    seg[::7] = 0
    mm, rung0, _ = port_blastp._rungs(seg, cfg)
    qrow = np.repeat(np.arange(nq), seg)
    rank = np.concatenate([np.arange(s) for s in seg])
    density = rng.random(nq)[qrow] ** 3
    pass_all = (rng.random(len(qrow)) < density) & (rank < rung0)
    is_long = np.zeros(len(qrow), bool)
    is_long[rng.choice(len(qrow), 6, replace=False)] = True
    pass_all &= ~is_long
    return qrow, rank, pass_all, is_long, seg, mm, rung0, cfg.v


@pytest.mark.parametrize('seed,v', [(0, 500), (1, 500), (2, 3), (3, 40)])
def test_fast_policy_matches_numpy(seed, v):
    qrow, rank, pass_all, is_long, seg, mm, rung0, v = synthetic_wave(
        seed, v=v)
    nq = len(seg)
    fast, emit, q_lo, q_hi, present = port_blastp._fast_policy(
        qrow, rank, pass_all, is_long, nq, mm, rung0, v)
    np.testing.assert_array_equal(q_hi - q_lo, seg)
    got_fast, got_emit = dw.fast_policy_tensors(
        *_t(qrow, rank, pass_all, is_long), seg, mm, rung0, v)
    np.testing.assert_array_equal(got_fast.numpy(), fast)
    np.testing.assert_array_equal(got_emit.numpy(), emit)
    has_long = np.zeros(nq, bool)
    has_long[qrow[is_long]] = True
    # the wave has resolved queries, unresolved ones and long-pair ones
    assert fast.any() and emit.any() and has_long.any()
    assert (present & ~fast & ~has_long).any()


def test_fast_policy_of_an_empty_wave():
    z = np.zeros(0, np.int64)
    seg = np.zeros(4, np.int64)
    fast, emit = dw.fast_policy_tensors(*_t(z, z, z > 0, z > 0), seg,
                                        np.full(4, 10.0), 160, 500)
    assert fast.shape == (4,) and not fast.any() and emit.shape == (0,)


def test_compact():
    rng = np.random.default_rng(2)
    for n in (0, 1, 5000):
        mask = rng.random(n) < 0.3
        got = dw.compact(torch.from_numpy(mask), int(mask.sum()))
        np.testing.assert_array_equal(got.numpy(), np.flatnonzero(mask))


# -- whole searches ----------------------------------------------------------

@pytest.fixture(scope='module')
def fsa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('tdwave') / 'c.fsa')
    write_corpus(path, make_corpus(n_taxa=3, n_families=40, seed=13,
                                   min_len=60, max_len=220))
    return path


@pytest.fixture(scope='module')
def jax_sc(fsa, tmp_path_factory):
    """The JAX find_hit CLI's bytes on ``fsa`` (defaults, -c 50)."""
    import os

    from swiftortho_tpu.cli import find_hit as jax_cli
    out = str(tmp_path_factory.mktemp('tdwave_jax') / 'j.sc')
    old = os.environ.get('SWIFTORTHO_JAX_CACHE')
    os.environ['SWIFTORTHO_JAX_CACHE'] = '0'
    try:
        assert jax_cli.main(['find_hit', '-p', 'blastp', '-i', fsa, '-d',
                             fsa, '-o', out, '-c', '50']) == 0
    finally:
        if old is None:
            del os.environ['SWIFTORTHO_JAX_CACHE']
        else:
            os.environ['SWIFTORTHO_JAX_CACHE'] = old
    with open(out, 'rb') as f:
        data = f.read()
    assert data.count(b'\n') > 200
    return data


def _events(stderr):
    return [json.loads(ln.split(' ', 1)[1]) for ln in stderr.splitlines()
            if ln.startswith('[swiftortho] {')]


# beside the three routes: the score-only prepass and the E-value filter
# between the passes; a partial pair table (the hot-set pick and the
# host gather of the other subjects)
SEARCH_CASES = ('routes', 'prepass', 'partial_table')


@pytest.mark.parametrize('case', SEARCH_CASES)
def test_find_hit_device_routes_write_jax_bytes(case, fsa, jax_sc, tmp_path,
                                               monkeypatch, capfd):
    from swiftortho_tpu_torch.cli import find_hit as port_cli
    from swiftortho_tpu_torch.ops import device_pack
    for k, v in dict(ROUTES, SWIFTORTHO_PLATFORM='cpu').items():
        monkeypatch.setenv(k, v)
    if case == 'prepass':
        monkeypatch.setattr(port_blastp, 'use_prepass', lambda device: True)
    if case == 'partial_table':
        stride = device_pack.DevicePackContext(SeqDB.from_path(fsa),
                                               CPU).stride
        monkeypatch.setenv('SWIFTORTHO_PACK_CAP',
                           str(len(SeqDB.from_path(fsa)) // 3 * stride))
    device_pack.reset_prof()
    out = str(tmp_path / 'p.sc')
    capfd.readouterr()
    assert port_cli.main(['find_hit', '-p', 'blastp', '-i', fsa, '-d', fsa,
                          '-o', out, '-c', '50']) == 0
    events = _events(capfd.readouterr().err)
    with open(out, 'rb') as f:
        assert f.read() == jax_sc
    waves = [e for e in events if e['stage'] == 'search_wave']
    split = [e for e in events if e['stage'] == 'device_wave']
    assert waves and len(split) == len(waves)
    assert not [e for e in events if e['stage'].endswith('_fallback')]
    packed = sum(w['packed_pairs'] for w in waves)
    gathered = sum(w['gathered_pairs'] for w in waves)
    assert packed > 0 and (gathered > 0) == (case == 'partial_table')
    for w in waves:
        # rank 1, the first rung's buckets 1-2 and its wait, the policy
        # 2, each round 2-3; a partial table adds the hot-set pick, the
        # host gather's read and its host batches
        assert 5 <= w['host_syncs'] <= 7 + 3 * w['esc_rounds'] + (
            4 if case == 'partial_table' else 0), w
    calls = device_pack.PROF['calls']
    assert calls['full'] > 0 and (calls['score_only'] > 0) == (
        case == 'prepass')
    assert device_pack.PROF['align_s'] > 0 and device_pack.PROF['pack_s'] > 0


def test_escalation_and_long_pairs_write_jax_rows(tmp_path, monkeypatch):
    """Deep families send queries up the rung ladder, and proteins past
    4,096 residues take the long tiles, in two waves two wide: the
    device wave reads their pairs each round and writes the JAX
    package's rows."""
    from swiftortho_tpu.config import SearchConfig as JaxConfig
    from swiftortho_tpu.io_fasta import SeqDB as JaxDB
    from swiftortho_tpu.search.blastp import blastp_stream as jax_stream
    corpus = make_corpus(n_taxa=24, n_families=4, seed=3, min_len=60,
                         max_len=120)
    rng = np.random.default_rng(1)
    AA = 'ACDEFGHIKLMNPQRSTVWY'
    big = ''.join(AA[i] for i in rng.integers(0, 20, 4300))
    records = list(corpus.records) + [('z|big1', big),
                                      ('z|big2', big[:4200] + 'W' * 50)]
    path = str(tmp_path / 'deep.fsa')
    with open(path, 'w') as f:
        for h, s in records:
            f.write('>%s\n%s\n' % (h, s))
    cfg = dict(expect=1e-5, nc=262144, chunk=40, query_batch=64, v=6,
               max_miss=0.6)
    monkeypatch.setenv('SWIFTORTHO_ALIGN_STAGES', '1')
    want = list(jax_stream(JaxDB.from_path(path), JaxDB.from_path(path),
                           JaxConfig(**cfg)))
    for k, v in dict(ROUTES, SWIFTORTHO_WAVE_PIPELINE='2').items():
        monkeypatch.setenv(k, v)
    events = []
    monkeypatch.setattr(dw, 'log_event',
                        lambda stage, **kw: events.append((stage, kw)))
    db = SeqDB.from_path(path)
    got = list(port_blastp.blastp_stream(db, db, SearchConfig(**cfg),
                                         device=CPU))
    assert got == want
    waves = [kw for st, kw in events if st == 'search_wave']
    assert len(waves) == 2 and sum(w['esc_rounds'] for w in waves) > 0
    assert sum(w['long_pairs'] for w in waves) > 0
    assert sum(w['long_tiles'] for w in waves) > 0


@pytest.mark.cuda
def test_cuda_device_wave_matches_numpy_wave(fsa, tmp_path, monkeypatch):
    """On the card: the device wave's rows equal the numpy wave's there
    (kept by a spill directory) and the default route's on the CPU; both
    SW variants launch, every pair is packed, the host reads stay few."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from swiftortho_tpu_torch.ops import banded_sw_cuda
    db = SeqDB.from_path(fsa)
    cfg = SearchConfig(chunk=50)
    want = list(port_blastp.blastp_stream(db, db, cfg, device=CPU))
    assert len(want) > 200
    for k, v in ROUTES.items():
        monkeypatch.setenv(k, v)
    events = []
    monkeypatch.setattr(dw, 'log_event',
                        lambda stage, **kw: events.append((stage, kw)))
    cuda = torch.device('cuda')
    banded_sw_cuda.reset_counters()
    rows = list(port_blastp.blastp_stream(db, db, cfg, device=cuda))
    assert banded_sw_cuda.launches['full'] > 0
    assert banded_sw_cuda.launches['score_only'] > 0
    waves = [kw for st, kw in events if st == 'search_wave']
    assert waves and all(w['gathered_pairs'] == 0 for w in waves)
    assert all(6 <= w['host_syncs'] <= 7 + 3 * w['esc_rounds']
               for w in waves)
    numpy_rows = list(port_blastp.blastp_stream(
        db, db, cfg, device=cuda, spill_dir=str(tmp_path / 'spill')))
    # the numpy wave ran: no more device wave events
    assert len(events) == 2 * len(waves)
    assert rows == numpy_rows == want


def test_wave_split_tool(tmp_path, monkeypatch, capsys):
    """``tools.wave_split`` on the CPU: one line a search with the device
    wave's split and host reads, the same rows each time, then the first
    search's excess by stage over the later ones, and the module
    functions it times restored afterwards."""
    from swiftortho_tpu_torch import utils
    from swiftortho_tpu_torch.tools import wave_split
    for k in wave_split.ROUTES:
        monkeypatch.setenv(k, 'off')
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    align_pairs, log = port_blastp._align_pairs, utils.log_event
    wave_split.main(['--searches', '2', '--taxa', '3', '--families', '15',
                     '--max-len', '120', '--workdir', str(tmp_path)])
    *lines, last = [json.loads(ln)
                    for ln in capsys.readouterr().out.splitlines()]
    assert [ln['search'] for ln in lines] == [0, 1]
    assert lines[0]['sc_md5'] == lines[1]['sc_md5'] and lines[0]['rows']
    for ln in lines:
        assert ln['waves'] == 1 and ln['host_syncs'] == [5]
        assert {'rank_s', 'prep_s', 'sw_s', 'format_s', 'emit_s'} <= set(
            ln['device_wave'])
        assert ln['sw_fetch_s'] > 0 and ln['pack_s'] > 0
        assert 'accept_s' in ln['cand_stages']
        assert {'hash_sort_s', 'csr_s', 'decode_s'} <= set(
            ln['index_stages'])
        assert ln['peak_device_bytes'] is None
    excess = last['first_search_excess']
    assert {'wall_s', 'phase_a_s', 'index_csr_s', 'accept_s',
            'expand_sort_s', 'walks_s'} <= set(excess)
    walks = [ln['cand_stages']['right_walk_s'] + ln['cand_stages'][
        'left_walk_s'] for ln in lines]
    assert excess['walks_s'] == round(walks[0] - walks[1], 4)
    assert excess['wall_s'] == round(lines[0]['wall_s'] - lines[1]['wall_s'],
                                     4)
    assert port_blastp._align_pairs is align_pairs
    assert utils.log_event is log
