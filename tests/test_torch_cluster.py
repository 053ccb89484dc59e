"""Clustering on the port (swiftortho_tpu_torch.cluster) against the JAX
package: the same inputs, made by numpy from a seed, through both.

Tolerances: ``_mcl_dense_batch`` final matrices within atol 1e-6; the
block-sparse engine's surviving (row, col) sets equal; AP labels, cluster
lists and ``find_cluster_stream`` output bytes equal.

CPU tests run the port on the CPU.  The ``cuda`` tests hold the card
against the CPU run of the port, show two card runs bitwise equal and
check the matmul precision there.  The JAX package is imported inside
the tests that use it, so the card tests also collect where JAX is not
installed.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu.cluster.checkpoint import ClusterCheckpoint
from swiftortho_tpu.config import ClusterConfig
from swiftortho_tpu_torch.cluster import apc as port_apc
from swiftortho_tpu_torch.cluster import driver as port_driver
from swiftortho_tpu_torch.cluster import mcl as port_mcl
from swiftortho_tpu_torch.cluster import mcl_blocksparse as port_bs
from swiftortho_tpu_torch.cluster.numerics import SegmentSum, rank_groups

CPU = torch.device('cpu')
DENSE_ATOL = 1e-6


def clique_chain(n_cliques, csize, rng, bridge_w=0.05, base=0):
    """Chain of cliques linked by weak bridges: ONE component whose MCL
    partition is the cliques."""
    ei, ej, w = [], [], []
    for c in range(n_cliques):
        off = base + c * csize
        a, b = np.triu_indices(csize, 1)
        ei.append(off + a)
        ej.append(off + b)
        w.append(1.0 + 0.1 * rng.random(len(a)))
        if c:
            ei.append(np.array([off - 1]))
            ej.append(np.array([off]))
            w.append(np.array([bridge_w]))
    return (np.concatenate(ei).astype(np.int64),
            np.concatenate(ej).astype(np.int64), np.concatenate(w))


def noisy_families(seed, n_fam=14, csize=7, noise=50):
    """Families with missing edges, uneven weights and random weak
    cross-family edges: several components, near ties, AP chains."""
    rng = np.random.default_rng(seed)
    ei, ej, w = [], [], []
    for f in range(n_fam):
        a, b = np.triu_indices(csize, 1)
        keep = rng.random(len(a)) < 0.8
        ei.append(f * csize + a[keep])
        ej.append(f * csize + b[keep])
        w.append(1.0 + 3.0 * rng.random(int(keep.sum())))
    n = n_fam * csize
    x, y = rng.integers(0, n, (2, noise))
    ok = x != y
    ei.append(np.minimum(x, y)[ok])
    ej.append(np.maximum(x, y)[ok])
    w.append(0.5 * rng.random(int(ok.sum())))
    return (n, np.concatenate(ei).astype(np.int64),
            np.concatenate(ej).astype(np.int64), np.concatenate(w))


def self_loops(m, li, lj, w):
    selfw = np.zeros(m, np.float32)
    np.maximum.at(selfw, li, w.astype(np.float32))
    np.maximum.at(selfw, lj, w.astype(np.float32))
    return selfw


def dense_batch(seed, B=6, s=32):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, s, s), np.float32)
    for b in range(B):
        m = int(rng.integers(8, s + 1))
        a = (rng.random((m, m)) < 0.3) * rng.random((m, m)) * 3
        a = np.triu(a, 1)
        a = a + a.T
        np.fill_diagonal(a, a.max(axis=1))
        x[b, :m, :m] = a
        x[b, range(m, s), range(m, s)] = 1.0
    return x


def ap_rows(n, ei, ej, w, pref):
    i_all = np.concatenate([ei, ej, np.arange(n)]).astype(np.int64)
    k_all = np.concatenate([ej, ei, np.arange(n)]).astype(np.int64)
    s_all = np.concatenate([w, w, np.full(n, pref)]).astype(np.float32)
    return i_all, k_all, s_all


def graph_text(n, ei, ej, w):
    """An .opc-like 4-column graph, both directions per pair (as find_orth
    writes it)."""
    names = ['t%d|g%d' % (i % 3, i) for i in range(n)]
    rows = []
    for a, b, z in zip(ei.tolist(), ej.tolist(), w.tolist()):
        rows.append('OT\t%s\t%s\t%.6f\n' % (names[a], names[b], z))
        rows.append('OT\t%s\t%s\t%.6f\n' % (names[b], names[a], z))
    return rows


# -- numerics -------------------------------------------------------------

def test_segment_sum_is_sequential():
    rng = np.random.default_rng(42)
    seg = rng.integers(0, 7, 500)
    val = rng.standard_normal((500, 3)).astype(np.float32) * 1e3
    want = np.zeros((7, 3), np.float32)
    for s, v in zip(seg, val):               # the sequential scatter
        want[s] += v
    got = SegmentSum(seg, 7, CPU)(torch.from_numpy(val)).numpy()
    assert np.array_equal(got, want)
    groups = rank_groups(seg)
    assert sorted(np.concatenate(groups).tolist()) == list(range(500))
    assert all(len(np.unique(seg[g])) == len(g) for g in groups)


def test_matmul_precision_is_highest(monkeypatch):
    """Every MCL product runs with float32 matmuls at 'highest' (TF32
    off), whatever the caller set, and the caller's setting comes back."""
    seen = []
    for name in ('matmul', 'bmm'):
        orig = getattr(torch, name)

        def spy(*a, _orig=orig, **k):
            seen.append((torch.get_float32_matmul_precision(),
                         torch.backends.cuda.matmul.allow_tf32))
            return _orig(*a, **k)
        monkeypatch.setattr(torch, name, spy)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('medium')
    try:
        port_mcl._mcl_dense_batch(torch.from_numpy(dense_batch(0, B=2)))
        li, lj, w = clique_chain(6, 8, np.random.default_rng(0))
        w = w.astype(np.float32)
        port_bs.mcl_blocksparse(48, li, lj, w, self_loops(48, li, lj, w),
                                1.5, mb=16)
        assert torch.get_float32_matmul_precision() == 'medium'
    finally:
        torch.set_float32_matmul_precision(old)
    assert len(seen) > 10
    assert set(seen) == {('highest', False)}


# -- dense MCL ------------------------------------------------------------

@pytest.mark.parametrize('seed,B,s', [(0, 6, 32), (1, 3, 64)])
def test_mcl_dense_batch_matches_jax(seed, B, s):
    import jax.numpy as jnp

    from swiftortho_tpu.cluster.mcl import _mcl_dense_batch
    x = dense_batch(seed, B, s)
    want = np.asarray(_mcl_dense_batch(jnp.asarray(x)))
    got = port_mcl._mcl_dense_batch(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DENSE_ATOL)


@pytest.mark.parametrize('max_dense', [4096, 32])
def test_mcl_cluster_matches_jax(max_dense, monkeypatch):
    """Dense buckets only, and with max_dense 32 the 40-node components
    through the block-sparse engine (64-wide tiles in both packages)."""
    import functools

    import swiftortho_tpu.cluster.mcl_blocksparse as jax_bs
    from swiftortho_tpu.cluster.mcl import mcl_cluster
    for mod in (jax_bs, port_bs):
        monkeypatch.setattr(mod, 'mcl_blocksparse', functools.partial(
            mod.mcl_blocksparse, mb=64))
    rng = np.random.default_rng(3)
    parts = [clique_chain(5, 8, rng, base=40 * k) for k in range(4)]
    ei, ej, w = (np.concatenate(p) for p in zip(*parts))
    n, fi, fj, fw = noisy_families(4, n_fam=6, csize=6, noise=0)
    ei = np.concatenate([ei, fi + 160])
    ej = np.concatenate([ej, fj + 160])
    w = np.concatenate([w, fw])
    want = mcl_cluster(160 + n, ei, ej, w, max_dense=max_dense)
    got = port_mcl.mcl_cluster(160 + n, ei, ej, w, max_dense=max_dense,
                               device=CPU)
    assert got == want
    assert len(got) >= 20 + 6


def test_mcl_scipy_and_mesh_branches(monkeypatch):
    rng = np.random.default_rng(5)
    ei, ej, w = clique_chain(4, 10, rng)
    bs = port_mcl.mcl_cluster(40, ei, ej, w, max_dense=16, device=CPU)
    monkeypatch.setenv('SWIFTORTHO_MCL', 'scipy')
    assert port_mcl.mcl_cluster(40, ei, ej, w, max_dense=16,
                                device=CPU) == bs
    assert [len(c) for c in bs] == [10] * 4
    monkeypatch.setenv('SWIFTORTHO_MCL', '')
    monkeypatch.setenv('SWIFTORTHO_MCL_MESH', '1')
    # one local device (the CPU): the mesh branch runs single-device
    assert port_mcl.mcl_cluster(40, ei, ej, w, max_dense=16,
                                device=CPU) == bs


# -- block-sparse MCL -----------------------------------------------------

@pytest.mark.parametrize('mb', [128, 256])
def test_mcl_blocksparse_matches_jax(mb):
    from swiftortho_tpu.cluster.mcl_blocksparse import mcl_blocksparse
    rng = np.random.default_rng(mb)
    m = 600
    li, lj, w = clique_chain(40, 15, rng)
    w = w.astype(np.float32)
    selfw = self_loops(m, li, lj, w)
    want = mcl_blocksparse(m, li, lj, w, selfw, 1.5, mb=mb)
    got = port_bs.mcl_blocksparse(m, li, lj, w, selfw, 1.5, mb=mb,
                                  device=CPU)
    assert set(zip(*got)) == set(zip(*want))
    assert len(got[0]) >= m


def test_mcl_blocksparse_resumes_from_checkpoint(tmp_path, monkeypatch):
    """A run killed after 7 expansions resumes at the checkpointed
    iteration 5 and ends with the uninterrupted run's entries."""
    rng = np.random.default_rng(9)
    m = 600
    li, lj, w = clique_chain(40, 15, rng)
    w = w.astype(np.float32)
    selfw = self_loops(m, li, lj, w)
    ref = port_bs.mcl_blocksparse(m, li, lj, w, selfw, 1.5, mb=128)
    ck = ClusterCheckpoint(str(tmp_path), 'sig')
    orig = port_bs._expand_device
    calls = {'n': 0}

    def crashing(*a, **k):
        calls['n'] += 1
        if calls['n'] > 7:
            raise RuntimeError('simulated kill')
        return orig(*a, **k)
    monkeypatch.setattr(port_bs, '_expand_device', crashing)
    with pytest.raises(RuntimeError):
        port_bs.mcl_blocksparse(m, li, lj, w, selfw, 1.5, mb=128, ckpt=ck,
                                ckpt_key='c')
    assert int(ck.load_state('c')['i_next']) == 5
    calls['n'] = -1000
    got = port_bs.mcl_blocksparse(m, li, lj, w, selfw, 1.5, mb=128,
                                  ckpt=ck, ckpt_key='c')
    assert calls['n'] > -1000
    assert [a.tolist() for a in got] == [a.tolist() for a in ref]


# -- affinity propagation -------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_apclust_core_matches_jax(seed):
    import jax.numpy as jnp

    from swiftortho_tpu.cluster.apc import _apclust_core
    n, ei, ej, w = noisy_families(seed)
    i_all, k_all, s_all = ap_rows(n, ei, ej, w, -60.0)
    want = np.asarray(_apclust_core(
        jnp.asarray(i_all), jnp.asarray(k_all),
        jnp.asarray(s_all.astype(np.float64)), n_nodes=n))
    got = port_apc._apclust_core(torch.from_numpy(i_all),
                                 torch.from_numpy(k_all),
                                 torch.from_numpy(s_all), n).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize('block,spill', [(97, False), (251, True),
                                         (10 ** 6, False)])
def test_apc_blocked_matches_jax(block, spill, tmp_path):
    from swiftortho_tpu.cluster.apc import apc_cluster_blocked
    n, ei, ej, w = noisy_families(7)
    kw = {'spill_dir': str(tmp_path / 'ap')} if spill else {}
    want = apc_cluster_blocked(n, ei, ej, w, 3, block=block)
    got = port_apc.apc_cluster_blocked(n, ei, ej, w, 3, block=block,
                                       device=CPU, **kw)
    assert got == want
    assert 1 < len(got) < n


@pytest.mark.parametrize('fn', ['apc_cluster', 'sap_cluster',
                                'apc_cluster_faithful'])
def test_ap_entry_points_match_jax(fn):
    from swiftortho_tpu.cluster import apc as jax_apc
    n, ei, ej, w = noisy_families(11)
    want = getattr(jax_apc, fn)(n, ei, ej, w, 3)
    kw = {} if fn == 'apc_cluster_faithful' else {'device': CPU}
    got = getattr(port_apc, fn)(n, ei, ej, w, 3, **kw)
    assert got == want
    assert 1 < len(got) < n


# -- driver ---------------------------------------------------------------

STREAM_CASES = {'mcl': ('mcl', ''), 'apc_textbook': ('apc', '0'),
                'apc_faithful': ('apc', ''), 'sap': ('sap', '')}


@pytest.mark.parametrize('case', sorted(STREAM_CASES))
def test_find_cluster_stream_matches_jax(case, monkeypatch):
    from swiftortho_tpu.cluster.driver import find_cluster_stream
    algo, faithful = STREAM_CASES[case]
    monkeypatch.setenv('SWIFTORTHO_APC_FAITHFUL', faithful)
    n, ei, ej, w = noisy_families(13, n_fam=20, noise=40)
    lines = graph_text(n, ei, ej, w)
    cfg = ClusterConfig(algorithm=algo)
    want = ''.join(find_cluster_stream(lines, cfg))
    got = ''.join(port_driver.find_cluster_stream(lines, cfg, device=CPU))
    assert got == want
    assert got.count('\n') > 5


def test_find_cluster_file_and_unknown_algorithm(tmp_path):
    n, ei, ej, w = noisy_families(2)
    path = tmp_path / 'g.opc'
    path.write_text(''.join(graph_text(n, ei, ej, w)))
    out = tmp_path / 'g.clsr'
    port_driver.find_cluster_file(str(path), str(out),
                                  ClusterConfig(algorithm='mcl'),
                                  device=CPU)
    assert out.read_text().count('\n') > 5
    with pytest.raises(ValueError, match='nope'):
        list(port_driver.find_cluster_stream(
            path.read_text().splitlines(True),
            ClusterConfig(algorithm='nope'), device=CPU))


# -- the card -------------------------------------------------------------

@pytest.fixture(scope='module')
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(STREAM_CASES))
def test_cuda_find_cluster_stream_matches_cpu(cuda_device, case,
                                              monkeypatch):
    algo, faithful = STREAM_CASES[case]
    monkeypatch.setenv('SWIFTORTHO_APC_FAITHFUL', faithful)
    n, ei, ej, w = noisy_families(13, n_fam=20, noise=40)
    lines = graph_text(n, ei, ej, w)
    cfg = ClusterConfig(algorithm=algo)
    cpu = ''.join(port_driver.find_cluster_stream(lines, cfg, device=CPU))
    runs = [''.join(port_driver.find_cluster_stream(lines, cfg,
                                                    device=cuda_device))
            for _ in range(2)]
    assert runs[0] == runs[1] == cpu


@pytest.mark.cuda
def test_cuda_runs_are_bitwise_repeatable(cuda_device):
    x = torch.from_numpy(dense_batch(1, 3, 64))
    d = [port_mcl._mcl_dense_batch(x.to(cuda_device))[0].cpu()
         for _ in range(2)]
    assert torch.equal(d[0], d[1])
    np.testing.assert_allclose(d[0].numpy(),
                               port_mcl._mcl_dense_batch(x)[0].numpy(),
                               rtol=0, atol=DENSE_ATOL)
    rng = np.random.default_rng(4)
    m = 600
    li, lj, w = clique_chain(40, 15, rng)
    w = w.astype(np.float32)
    selfw = self_loops(m, li, lj, w)
    b = [port_bs.mcl_blocksparse(m, li, lj, w, selfw, 1.5, mb=128,
                                 device=cuda_device) for _ in range(2)]
    assert all(np.array_equal(p, q) for p, q in zip(b[0], b[1]))
    n, ei, ej, w = noisy_families(0)
    i_all, k_all, s_all = ap_rows(n, ei, ej, w, -60.0)
    args = [torch.from_numpy(v) for v in (i_all, k_all, s_all)]
    labs = [port_apc._apclust_core(*(v.to(cuda_device) for v in args),
                                   n).cpu() for _ in range(2)]
    assert torch.equal(labs[0], labs[1])
    assert torch.equal(labs[0], port_apc._apclust_core(*args, n))
    seg = rng.integers(0, 50, 100_000)
    val = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    ss = SegmentSum(seg, 50, cuda_device)
    sums = [ss(val.to(cuda_device)).cpu() for _ in range(2)]
    assert torch.equal(sums[0], sums[1])
    assert torch.equal(sums[0], SegmentSum(seg, 50, CPU)(val))


@pytest.mark.cuda
def test_cuda_matmul_precision(cuda_device, monkeypatch):
    seen = []
    orig = torch.matmul

    def spy(*a, **k):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return orig(*a, **k)
    monkeypatch.setattr(torch, 'matmul', spy)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        port_mcl._mcl_dense_batch(
            torch.from_numpy(dense_batch(0, 2)).to(cuda_device))
    finally:
        torch.set_float32_matmul_precision(old)
    assert seen and set(seen) == {('highest', False)}
