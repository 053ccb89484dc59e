"""The x-drop walk kernel of the port's device candidate engine
(``csrc/xdrop_walk.cu`` through ``ops/xdrop_walk_cuda.py``) and its
dispatch (``search/candidates_device.py::walk``).

Here, without a card: a numpy model of the kernel's one-thread loop (the
same bounds, table and stopping rule, step by step) is held equal to the
port's ``walk_chunked`` and to the JAX package's ``_walk_chunked`` on
seeded random points and on edge points; the kernel's code table is held
to the byte table for every byte pair; ``walk`` on CPU tensors is
``walk_chunked``, and on any other device it never reaches it; the
wrapper rejects bad arguments before it loads the library.  On a card
(``cuda`` marker) the kernel itself is held equal to ``walk_chunked``
and to the model's step counts.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch.constants import B62_CODES, BYTE2CODE, XDROP
from swiftortho_tpu_torch.ops import xdrop_walk_cuda as xw
from swiftortho_tpu_torch.search import candidates_device as port

CPU = torch.device('cpu')
AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWYx', np.uint8)
INT_ARGS = ('qrow', 's_off', 'start_q', 'start_s', 'base', 'qlo', 'slo',
            'qlen', 'slen')


def model_walk(qtok_flat, db, L, Wmax, step, qrow, s_off, start_q, start_s,
               base, qlo, slo, qlen, slen):
    """The kernel's loop for each point, in Python integers: returns
    (best, best_t, steps) as int32 arrays."""
    code = BYTE2CODE.astype(np.int64)
    sub = B62_CODES.reshape(-1).astype(np.int64)
    P = len(qrow)
    out = np.zeros((3, P), np.int64)
    for p in range(P):
        qr, sr = int(qrow[p]) * L, int(s_off[p])
        ql, qh = max(int(qlo[p]), -1), min(int(qlen[p]), L)
        sl, sh = max(int(slo[p]), -1), int(slen[p])
        q, s = int(start_q[p]), int(start_s[p])
        total = best = int(base[p])
        bt, t = -1, 0
        while t < Wmax:
            if not (ql < q < qh and sl < s < sh):
                break
            total += int(sub[code[qtok_flat[qr + q]] * 32
                             + code[db[sr + s]]])
            t += 1
            if total > best:
                best, bt = total, t - 1
            elif total + XDROP < best:
                break
            q += step
            s += step
        out[:, p] = best, bt, t
    return out.astype(np.int32)


def random_points(seed, step, P=400):
    """Queries, related subjects (mutated copies, so walks run long) and
    points on and off the shared diagonal; a group's first point has
    bounds 0 on the right walk, the left walk a base and recorded
    bounds."""
    rng = np.random.default_rng(seed)
    B, L = 6, 96
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
    ints = dict(zip(INT_ARGS, (qrow, offs[sid], start_q, start_s, base, qlo,
                               slo, p_qlen, p_slen)))
    return q.reshape(-1), np.concatenate(subs), L, ints


def edge_points(step):
    """Hand-made points: a group's first point at start_q = 0, bounds at
    0 and at the length (a query as wide as its row), walks that run to
    the end of their sequence (identical subjects), base > 0, starts past
    the end, a subject shorter than its query, junk bytes."""
    L = 16
    q0 = np.frombuffer(b'ACDEFGHIKLMNPQRS', np.uint8)
    q1 = np.frombuffer(b'WWYCHMxa*Jkpppp-', np.uint8)
    qtok = np.concatenate([q0, q1])
    subs = [q0.copy(), np.frombuffer(b'WWWWWWWWWWWWWWWW', np.uint8),
            q0[:9].copy(), q1[:10].copy()]
    offs = np.concatenate([[0], np.cumsum([len(s) for s in subs])])
    slens = np.diff(offs)
    NEG = -(1 << 30)
    if step == 1:
        # (qrow, sid, start_q, start_s, base, qlo, slo, qlen)
        pts = [(0, 0, 0, 0, 0, 0, 0, 16),      # first point at 0: out
               (0, 0, 1, 1, 0, 0, 0, 16),      # first point, runs to L
               (0, 0, 0, 0, 0, -1, NEG, 16),   # from position 0 to L
               (0, 1, 3, 3, 40, -1, NEG, 16),  # base > 0, x-drops
               (0, 0, 16, 16, 5, -1, NEG, 16),  # starts past the end
               (0, 2, 2, 2, 0, -1, NEG, 16),   # subject ends first
               (0, 0, 4, 4, 0, -1, NEG, 10),   # query bound below L
               (1, 3, 0, 0, 0, 0, 0, 10),      # junk, first point
               (1, 3, 1, 1, 7, -1, NEG, 10),   # junk from 1
               (1, 0, 0, 5, 0, -1, NEG, 10)]   # off the diagonal
    else:
        pts = [(0, 0, 15, 15, 30, 0, 0, 16),   # down to the bound 0
               (0, 0, 15, 15, 30, -1, -1, 16),  # down through 0
               (0, 0, 0, 0, 9, 0, 0, 16),      # first point at 0: out
               (0, 0, 9, 9, 12, 3, 3, 16),     # recorded cover 3
               (0, 1, 12, 12, 50, -1, -1, 16),  # base > 0, x-drops
               (0, 2, 8, 8, 20, -1, 2, 16),    # subject bound first
               (0, 0, 15, 10, 0, -1, -1, 16),  # off the diagonal
               (1, 3, 9, 9, 3, -1, -1, 10),    # junk
               (1, 0, 9, 9, 0, 6, -1, 10)]     # query bound first
    a = np.array(pts, np.int64)
    ints = dict(qrow=a[:, 0], s_off=offs[a[:, 1]], start_q=a[:, 2],
                start_s=a[:, 3], base=a[:, 4], qlo=a[:, 5], slo=a[:, 6],
                qlen=a[:, 7], slen=slens[a[:, 1]])
    return qtok, np.concatenate(subs), L, ints


def on(ints, device=CPU):
    return {k: torch.from_numpy(v.astype(np.int64 if k == 's_off'
                                          else np.int32)).to(device)
            for k, v in ints.items()}


def chunked(qtok, db, L, WC, Wmax, step, ints, device=CPU):
    t = on(ints, device)
    best, best_t = port.walk_chunked(
        torch.from_numpy(qtok).to(device), torch.from_numpy(db).to(device),
        port.scoring_tables(device)['sub_flat'], L, WC, Wmax, t['qrow'],
        t['s_off'], t['start_q'], t['start_s'], step, t['base'], t['qlo'],
        t['slo'], t['qlen'], t['slen'])
    return best.cpu().numpy(), best_t.cpu().numpy()


def jax_walk(qtok, db, L, WC, Wmax, step, ints):
    import jax.numpy as jnp
    from swiftortho_tpu.search.candidates_device import (_b62_flat,
                                                         _walk_chunked)
    j = {k: jnp.asarray(v.astype(np.int32)) for k, v in ints.items()}
    best, best_t = _walk_chunked(
        jnp.asarray(qtok.astype(np.int32)), jnp.asarray(db),
        jnp.asarray(_b62_flat()), L, WC, Wmax, j['qrow'], j['s_off'],
        j['start_q'], j['start_s'], step, j['base'], j['qlo'], j['slo'],
        j['qlen'], j['slen'])
    return np.asarray(best), np.asarray(best_t)


def model(qtok, db, L, Wmax, step, ints):
    return model_walk(qtok, db, L, Wmax, step,
                      *(ints[k] for k in INT_ARGS))


@pytest.mark.parametrize('step', [1, -1])
@pytest.mark.parametrize('seed', [3, 4])
def test_model_matches_chunked_and_jax(seed, step):
    qtok, db, L, ints = random_points(seed, step)
    best, best_t, steps = model(qtok, db, L, L + 1, step, ints)
    for wc in (7, port.WALK_CHUNK):
        got = chunked(qtok, db, L, wc, L + 1, step, ints)
        np.testing.assert_array_equal(best, got[0])
        np.testing.assert_array_equal(best_t, got[1])
    want = jax_walk(qtok, db, L, 32, L + 1, step, ints)
    np.testing.assert_array_equal(best, want[0])
    np.testing.assert_array_equal(best_t, want[1])
    # walks that never beat their base, and walks of 50 steps and more
    assert (best_t == -1).any() and (best_t >= 0).any()
    assert (steps > best_t).all() and steps.max() >= 50


@pytest.mark.parametrize('step', [1, -1])
def test_model_edge_points(step):
    qtok, db, L, ints = edge_points(step)
    best, best_t, steps = model(qtok, db, L, L + 1, step, ints)
    for wc in (1, 5, port.WALK_CHUNK):
        got = chunked(qtok, db, L, wc, L + 1, step, ints)
        np.testing.assert_array_equal(best, got[0])
        np.testing.assert_array_equal(best_t, got[1])
    want = jax_walk(qtok, db, L, 4, L + 1, step, ints)
    np.testing.assert_array_equal(best, want[0])
    np.testing.assert_array_equal(best_t, want[1])
    if step == 1:
        # first point at 0 reads nothing; walks to the row's end
        assert (best[0], best_t[0], steps[0]) == (0, -1, 0)
        assert steps[1] == 15 and best_t[1] == 14
        assert steps[2] == 16 and best_t[2] == 15
        assert best[3] == 40 and best_t[3] == -1 and 0 < steps[3] < 16
        assert (best[4], best_t[4], steps[4]) == (5, -1, 0)
        assert steps[5] == 7 and steps[6] == 6
    else:
        # the bound 0 stops before position 0; qlo = -1 walks through it
        assert steps[0] == 15 and steps[1] == 16
        assert best[1] > best[0] > 30
        assert (best[2], best_t[2], steps[2]) == (9, -1, 0)
        assert steps[3] == 6 and best[4] == 50 and best_t[4] == -1
        assert steps[5] == 6 and steps[8] == 3


@pytest.mark.parametrize('step', [1, -1])
def test_model_wmax_cap(step):
    """A cap below the walks' length ends them at Wmax steps; the
    chunked versions walk whole chunks, so the cap is a multiple of
    theirs."""
    qtok, db, L, ints = edge_points(step)
    for wmax, wc in ((8, 4), (8, 8), (4, 1)):
        best, best_t, steps = model(qtok, db, L, wmax, step, ints)
        assert steps.max() == wmax
        got = chunked(qtok, db, L, wc, wmax, step, ints)
        np.testing.assert_array_equal(best, got[0])
        np.testing.assert_array_equal(best_t, got[1])
        want = jax_walk(qtok, db, L, wc, wmax, step, ints)
        np.testing.assert_array_equal(best, want[0])
        np.testing.assert_array_equal(best_t, want[1])


@pytest.mark.parametrize('step', [1, -1])
def test_no_points(step):
    qtok, db, L, ints = edge_points(step)
    empty = {k: v[:0] for k, v in ints.items()}
    out = model(qtok, db, L, L + 1, step, empty)
    assert out.shape == (3, 0)
    for fn in (port.walk_chunked, port.walk):
        t = on(empty)
        best, best_t = fn(torch.from_numpy(qtok), torch.from_numpy(db),
                          port.scoring_tables(CPU)['sub_flat'], L, 64, L + 1,
                          t['qrow'], t['s_off'], t['start_q'], t['start_s'],
                          step, t['base'], t['qlo'], t['slo'], t['qlen'],
                          t['slen'])
        assert best.shape == best_t.shape == (0,)
        assert best.dtype == best_t.dtype == torch.int32


def test_codes_table_matches_b62_flat():
    """The kernel's table (byte->code map, then the 32x32 code-space
    BLOSUM62) gives the byte table's score for every byte pair, as the
    JAX package's walks read it."""
    from swiftortho_tpu.search.candidates_device import _b62_flat
    tables = port.scoring_tables(CPU)
    codes = tables['codes'].numpy().astype(np.int64)
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing='ij')
    score = codes[256 + codes[a] * 32 + codes[b]]
    np.testing.assert_array_equal(score.reshape(-1), _b62_flat())
    np.testing.assert_array_equal(tables['sub_flat'].numpy(), _b62_flat())
    assert codes[:256].min() >= 0 and codes[:256].max() < 32


@pytest.mark.parametrize('step', [1, -1])
def test_walk_on_cpu_is_walk_chunked(step, monkeypatch):
    qtok, db, L, ints = random_points(9, step)
    t = on(ints)
    args = (torch.from_numpy(qtok), torch.from_numpy(db),
            port.scoring_tables(CPU)['sub_flat'], L, port.WALK_CHUNK, L + 1,
            t['qrow'], t['s_off'], t['start_q'], t['start_s'], step,
            t['base'], t['qlo'], t['slo'], t['qlen'], t['slen'])
    want = port.walk_chunked(*args)
    monkeypatch.setattr(port, 'xdrop_walk_cuda', None)   # never called
    got = port.walk(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_walk_off_cpu_never_reaches_walk_chunked(monkeypatch):
    """A tensor on any other device than the CPU goes to the kernel's
    wrapper, which raises for anything but CUDA; ``walk_chunked`` is not
    called."""
    def refuse(*a, **k):
        raise AssertionError('walk_chunked called off the CPU')
    monkeypatch.setattr(port, 'walk_chunked', refuse)
    monkeypatch.setattr(xw, 'load_kernels', refuse)
    meta = torch.device('meta')
    qtok, db, L, ints = edge_points(1)
    t = on(ints, meta)
    with pytest.raises(ValueError, match='needs CUDA tensors'):
        port.walk(torch.from_numpy(qtok).to(meta),
                  torch.from_numpy(db).to(meta), None, L, 64, L + 1,
                  t['qrow'], t['s_off'], t['start_q'], t['start_s'], 1,
                  t['base'], t['qlo'], t['slo'], t['qlen'], t['slen'])


def _wrapper_args(step=1):
    qtok, db, L, ints = edge_points(step)
    return dict(qtok_flat=torch.from_numpy(qtok),
                db_tokens=torch.from_numpy(db), L=L, Wmax=L + 1, step=step,
                **on(ints))


@pytest.mark.parametrize('case', ['cpu', 'dtype', 'offsets', 'tokens',
                                  'strided', 'length', 'step', 'devices'])
def test_cuda_wrapper_rejects_before_loading(case, monkeypatch):
    def refuse():
        raise AssertionError('library loaded before the checks')
    monkeypatch.setattr(xw, 'load_kernels', refuse)
    kw = _wrapper_args()
    match = {'cpu': 'needs CUDA tensors', 'dtype': 'base must be',
             'offsets': 's_off must be', 'tokens': 'db_tokens must be',
             'strided': 'qlo must be contiguous', 'length': 'slen has',
             'step': 'step must be', 'devices': 'qlen is on'}[case]
    if case == 'dtype':
        kw['base'] = kw['base'].long()
    elif case == 'offsets':
        kw['s_off'] = kw['s_off'].int()
    elif case == 'tokens':
        kw['db_tokens'] = kw['db_tokens'].int()
    elif case == 'strided':
        kw['qlo'] = torch.stack([kw['qlo'], kw['qlo']], 1)[:, 0]
    elif case == 'length':
        kw['slen'] = kw['slen'][1:]
    elif case == 'step':
        kw['step'] = 2
    elif case == 'devices':
        kw['qlen'] = kw['qlen'].to('meta')
    with pytest.raises(ValueError, match=match):
        xw.xdrop_walk_cuda(**kw)


def test_engine_on_cpu_launches_nothing():
    """The CPU engine walks with walk_chunked: the kernel's counters do
    not move."""
    from swiftortho_tpu_torch.constants import AA9
    from swiftortho_tpu_torch.corpus import make_corpus
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.ops.index import build_index
    from swiftortho_tpu_torch.search.blastp import _mask_queries
    from swiftortho_tpu_torch.search.candidates import generate_candidates
    corpus = make_corpus(n_taxa=2, n_families=8, seed=5, min_len=40,
                         max_len=90)
    db = SeqDB.from_records(corpus.records)
    ix = build_index(db, 0, len(db), [AA9], '11111111', 1 << 16)
    toks, lens = _mask_queries(db, np.arange(len(db), dtype=np.int64), 128,
                               True)
    xw.reset_counters()
    got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                          '11111111', device=CPU)
    want = generate_candidates(toks, lens, db, ix, [AA9], '11111111')
    assert len(want.subject) > 0
    for f in ('qrow', 'subject', 'score', 'band_q', 'band_s'):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert xw.launches == 0 and xw.points == 0


@pytest.mark.cuda
def test_cuda_kernel_matches_walk_chunked():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cuda = torch.device('cuda')
    for step in (1, -1):
        for qtok, db, L, ints in (random_points(21, step, P=5000),
                                  edge_points(step)):
            want = chunked(qtok, db, L, port.WALK_CHUNK, L + 1, step, ints,
                           cuda)
            t = on(ints, cuda)
            before = xw.launches
            best, best_t, steps = xw.xdrop_walk_cuda(
                torch.from_numpy(qtok).to(cuda),
                torch.from_numpy(db).to(cuda), L, L + 1, t['qrow'],
                t['s_off'], t['start_q'], t['start_s'], step, t['base'],
                t['qlo'], t['slo'], t['qlen'], t['slen'], steps=True)
            torch.cuda.synchronize()
            assert xw.launches == before + 1
            np.testing.assert_array_equal(best.cpu().numpy(), want[0])
            np.testing.assert_array_equal(best_t.cpu().numpy(), want[1])
            np.testing.assert_array_equal(
                steps.cpu().numpy(), model(qtok, db, L, L + 1, step, ints)[2])
        qtok, db, L, ints = edge_points(step)
        for wmax in (4, 8):
            t = on(ints, cuda)
            best, best_t = port.walk(
                torch.from_numpy(qtok).to(cuda),
                torch.from_numpy(db).to(cuda), None, L, 0, wmax, t['qrow'],
                t['s_off'], t['start_q'], t['start_s'], step, t['base'],
                t['qlo'], t['slo'], t['qlen'], t['slen'])
            want = model(qtok, db, L, wmax, step, ints)
            np.testing.assert_array_equal(best.cpu().numpy(), want[0])
            np.testing.assert_array_equal(best_t.cpu().numpy(), want[1])
        before = xw.launches
        empty = on({k: v[:0] for k, v in ints.items()}, cuda)
        best, _ = port.walk(torch.from_numpy(qtok).to(cuda),
                            torch.from_numpy(db).to(cuda), None, L, 0, L + 1,
                            empty['qrow'], empty['s_off'], empty['start_q'],
                            empty['start_s'], step, empty['base'],
                            empty['qlo'], empty['slo'], empty['qlen'],
                            empty['slen'])
        assert best.shape == (0,) and xw.launches == before
