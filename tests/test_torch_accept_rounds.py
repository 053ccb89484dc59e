"""The accept-rounds kernel of the port's device candidate engine
(``csrc/accept_rounds.cu`` through ``ops/accept_rounds_cuda.py``) and its
dispatch (``search/candidates_device.py::accept``).

Here, without a card: a numpy model of the kernel's loop (one pass in
order over each segment's points) is held equal to the port's plain
``accept_rounds`` and to the JAX package's ``_accept_rounds`` on seeded
inputs (``ops/accept_rounds_cases.py``, which ``chip_smoke.py`` holds
the kernel to on the card at a larger scale): engine-shaped segments,
unsorted ``qst`` with ``E < qst`` and no flag at 0,
``E == qst``, no valid point, one-point segments, one long segment and no
points.  ``accept`` on CPU tensors is ``accept_rounds``, and on any other
device it never reaches it; the wrapper rejects bad arguments before it
loads the library; the engine on the CPU launches nothing and logs the
plain version's round count.  On a card (``cuda`` marker) the kernel is
held equal to ``accept_rounds``, with no host read inside its call.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch.ops import accept_rounds_cuda as ar
from swiftortho_tpu_torch.ops.accept_rounds_cases import CASES, make_case
from swiftortho_tpu_torch.search import candidates_device as port

CPU = torch.device('cpu')


def model_accept(new_seg, valid, qst, E):
    """The kernel's loop in Python integers: each segment's thread walks
    its points in order, accepts a valid point past the cover, records
    the cover and raises it to the point's E.  Index 0 starts a segment
    even without its flag, one that accepts nothing.  Returns (acc,
    qlo_rec, rounds)."""
    C = len(qst)
    acc = np.zeros(C, bool)
    qlo = np.zeros(C, np.int32)
    rounds = 0
    for p in range(C):
        if p > 0 and not new_seg[p]:
            continue
        # points before the first flag are never accepted
        cov, n, i = (-1 if new_seg[p] else 1 << 62), 0, p
        while i < C and (i == p or not new_seg[i]):
            if valid[i] and int(qst[i]) > cov:
                acc[i], qlo[i] = True, cov
                cov = max(cov, int(E[i]))
                n += 1
            i += 1
        rounds = max(rounds, n)
    return acc, qlo, rounds


def on(case, device=CPU):
    new_seg, valid, qst, E = case
    return (torch.from_numpy(new_seg).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(qst).to(device),
            torch.from_numpy(E).to(device))


def jax_accept(new_seg, valid, qst, E):
    import jax.numpy as jnp
    from swiftortho_tpu.search.candidates_device import _accept_rounds
    acc, qlo = _accept_rounds(jnp.asarray(new_seg), jnp.asarray(valid),
                              jnp.asarray(qst.astype(np.int32)),
                              jnp.asarray(E.astype(np.int32)))
    return np.asarray(acc), np.asarray(qlo)


@pytest.mark.parametrize('name', CASES)
def test_model_matches_plain_and_jax(name):
    case = make_case(name, seed=len(name))
    acc, qlo, rounds = model_accept(*case)
    got = port.accept_rounds(*on(case))
    np.testing.assert_array_equal(got[0].numpy(), acc)
    np.testing.assert_array_equal(got[1].numpy(), qlo)
    assert got[2] == rounds
    if name != 'no_points':
        acc_j, qlo_j = jax_accept(*case)
        np.testing.assert_array_equal(acc_j, acc)
        np.testing.assert_array_equal(qlo_j, qlo)
    # each case reaches what it is named for
    expect = {'all_invalid': 0, 'no_points': 0, 'one_point_segments': 1}
    if name in expect:
        assert rounds == expect[name]
    else:
        assert rounds >= 3 and acc.any() and (~acc & case[1]).any()
    if name == 'one_long_segment':
        assert rounds == int(acc.sum()) and (qlo[acc] == -1).sum() == 1


@pytest.mark.parametrize('seed', range(6))
def test_model_matches_plain_random(seed):
    """Segmented inputs of the engine's shape and unsorted ones, many
    seeds: the kernel's one pass gives what the rounds give."""
    for name in ('engine', 'unsorted'):
        case = make_case(name, seed=100 + seed)
        acc, qlo, rounds = model_accept(*case)
        got = port.accept_rounds(*on(case))
        np.testing.assert_array_equal(got[0].numpy(), acc)
        np.testing.assert_array_equal(got[1].numpy(), qlo)
        assert got[2] == rounds


@pytest.mark.parametrize('name', ['engine', 'no_points'])
def test_accept_on_cpu_is_accept_rounds(name, monkeypatch):
    case = on(make_case(name, seed=3))
    want = port.accept_rounds(*case)
    monkeypatch.setattr(port, 'accept_rounds_cuda', None)   # never called
    acc, qlo, rounds = port.accept(*case)
    assert torch.equal(acc, want[0]) and torch.equal(qlo, want[1])
    assert rounds.shape == () and rounds.dtype == torch.int32
    assert int(rounds) == want[2]


def test_accept_off_cpu_never_reaches_accept_rounds(monkeypatch):
    """A tensor on any other device than the CPU goes to the kernel's
    wrapper, which raises for anything but CUDA; ``accept_rounds`` is not
    called, and a wrapper put in its place receives the tensors."""
    def refuse(*a, **k):
        raise AssertionError('accept_rounds called off the CPU')
    monkeypatch.setattr(port, 'accept_rounds', refuse)
    monkeypatch.setattr(ar, 'load_kernels', refuse)
    meta = on(make_case('engine'), torch.device('meta'))
    with pytest.raises(ValueError, match='needs CUDA tensors'):
        port.accept(*meta)
    seen = []
    monkeypatch.setattr(port, 'accept_rounds_cuda',
                        lambda *a: seen.append(a) or 'kernel')
    assert port.accept(*meta) == 'kernel'
    assert len(seen) == 1 and all(x is y for x, y in zip(seen[0], meta))


@pytest.mark.parametrize('case', ['cpu', 'qst_dtype', 'flag_dtype',
                                  'length', 'strided', 'devices', 'dims'])
def test_cuda_wrapper_rejects_before_loading(case, monkeypatch):
    def refuse():
        raise AssertionError('library loaded before the checks')
    monkeypatch.setattr(ar, 'load_kernels', refuse)
    new_seg, valid, qst, E = on(make_case('engine'))
    match = {'cpu': 'needs CUDA tensors', 'qst_dtype': 'p_qst must be',
             'flag_dtype': 'valid_s must be', 'length': 'E has',
             'strided': 'new_seg must be contiguous',
             'devices': 'E is on', 'dims': 'p_qst must be 1-D'}[case]
    if case == 'qst_dtype':
        qst = qst.long()
    elif case == 'flag_dtype':
        valid = valid.to(torch.uint8)
    elif case == 'length':
        E = E[1:]
    elif case == 'strided':
        new_seg = torch.stack([new_seg, new_seg], 1)[:, 0]
    elif case == 'devices':
        E = E.to('meta')
    elif case == 'dims':
        qst = qst[None]
    with pytest.raises(ValueError, match=match):
        ar.accept_rounds_cuda(new_seg, valid, qst, E)


def test_engine_on_cpu_launches_nothing(monkeypatch):
    """The CPU engine runs the plain rounds: the kernel's counters do not
    move, and the event's ``accept_rounds`` is an int, the most rounds
    the plain version took over the row blocks."""
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
    plain, rounds, events = port.accept_rounds, [], []

    def recorded(*a):
        out = plain(*a)
        rounds.append(out[2])
        return out
    monkeypatch.setattr(port, 'accept_rounds', recorded)
    monkeypatch.setattr(port, 'log_event',
                        lambda stage, **kw: events.append((stage, kw)))
    # a cap that cuts stage 2 into row blocks
    monkeypatch.setenv('SWIFTORTHO_DEVICE_CAND_CAP', '300')
    ar.reset_counters()
    got = port.generate_candidates_device(toks, lens, db, ix, [AA9],
                                          '11111111', device=CPU)
    want = generate_candidates(toks, lens, db, ix, [AA9], '11111111')
    assert len(want.subject) > 0
    for f in ('qrow', 'subject', 'score', 'band_q', 'band_s'):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert ar.launches == 0 and ar.points == 0
    ev = [kw for s, kw in events if s == 'device_candidates']
    assert len(ev) == 1 and ev[0]['blocks'] == len(rounds) >= 2
    assert type(ev[0]['accept_rounds']) is int
    assert ev[0]['accept_rounds'] == max(rounds) >= 2


@pytest.mark.cuda
def test_cuda_kernel_matches_accept_rounds():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cuda = torch.device('cuda')
    for name in CASES:
        case = on(make_case(name, seed=7), cuda)
        want = port.accept_rounds(*case)
        before = ar.launches
        torch.cuda.set_sync_debug_mode('error')     # no host read inside
        try:
            acc, qlo, rounds = port.accept(*case)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        assert ar.launches == before + (name != 'no_points')
        assert acc.device == qlo.device == rounds.device == case[0].device
        assert torch.equal(acc, want[0]) and torch.equal(qlo, want[1])
        assert rounds.shape == () and int(rounds) == want[2]
