"""The port's multi-device search (``swiftortho_tpu_torch.parallel.mesh``,
``ops.seg.seg_batch``, the mesh route of ``ops.device_pack`` and the
sharded block-sparse MCL expansion) against the JAX package, whose side
runs on the conftest's 8-device CPU mesh as tests/test_parallel.py runs
it.  The port's meshes repeat the CPU device (``[cpu] * 8``), so every
shard runs the plain PyTorch SW.

Integer outputs and m8 rows must be equal; MCL is compared by partitions.
The ``cuda`` tests hold the card's launch device and mesh dispatch; they
skip without a card.  The JAX package is imported inside the tests that
use it, so the card tests also collect where JAX is not installed.
"""

import json

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch import device as port_device
from swiftortho_tpu_torch.cluster import mcl_blocksparse as port_bs
from swiftortho_tpu_torch.cluster.components import connected_components
from swiftortho_tpu_torch.ops import banded_sw as port_sw
from swiftortho_tpu_torch.ops import device_pack as port_pack
from swiftortho_tpu_torch.ops.seg import seg_batch
from swiftortho_tpu_torch.parallel import mesh as port_mesh

CPU = torch.device('cpu')
AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)


@pytest.fixture(scope='module')
def meshes():
    import jax

    from swiftortho_tpu.parallel import mesh as jax_mesh
    assert len(jax.devices()) == 8
    return (jax_mesh.make_mesh(n_data=4, n_db=2),
            port_mesh.make_mesh(n_data=4, n_db=2, devices=[CPU] * 8))


def events(err, stage):
    out = []
    for line in err.splitlines():
        if line.startswith('[swiftortho] {'):
            rec = json.loads(line[len('[swiftortho] '):])
            if rec.get('stage') == stage:
                out.append(rec)
    return out


# -- mesh ------------------------------------------------------------------

def test_make_mesh(meshes, monkeypatch):
    jm, pm = meshes
    assert pm.shape == jm.devices.shape == (4, 2)
    assert pm.axis_names == jm.axis_names == ('data', 'db')
    assert pm.flat() == [CPU] * 8 and pm.size == 8
    assert not pm.spans_processes() and pm.owned() == list(range(8))
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    assert port_mesh.make_mesh().shape == (1, 1)      # the one CPU
    assert port_mesh.active_search_mesh() is None
    with port_mesh.use_search_mesh(pm):
        assert port_mesh.active_search_mesh() is pm
    assert port_mesh.active_search_mesh() is None


def test_shard_bounds():
    for n, parts in ((21, 8), (3, 8), (16, 4), (0, 2)):
        got = port_mesh.shard_bounds(n, parts)
        want = [(int(a[0]), int(a[-1]) + 1) if len(a) else None
                for a in np.array_split(np.arange(n), parts)]
        assert [g if g[1] > g[0] else None for g in got] == want
        assert got[-1][1] == n


# -- seg_batch -------------------------------------------------------------

def seg_inputs(kind):
    rng = np.random.default_rng(len(kind))
    aa = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWYXJ*', np.uint8)
    if kind == 'low_complexity':
        toks = aa[rng.integers(0, len(aa), (32, 120))]
        # the entropy of every window is taken against the first window's
        # counts (the reference's quirk), so runs that open a sequence mask
        toks[:12, :30] = ord('A')
        toks[12:20, 40:80] = ord('A')
        toks[3, :30] = np.frombuffer(b'QP' * 15, np.uint8)
        toks[5, :39] = np.frombuffer(b'KKE' * 13, np.uint8)
        lens = rng.integers(20, 121, 32)
    elif kind == 'short':                       # lengths under the window
        toks = aa[rng.integers(0, 5, (32, 120))]
        toks[:8] = ord('G')
        lens = np.arange(32) % 14
    elif kind == 'lowercase':
        low = np.frombuffer(b'acdefghiklmnpqrstvwy', np.uint8)
        toks = np.where(rng.random((32, 120)) < 0.5,
                        aa[rng.integers(0, 20, (32, 120))],
                        low[rng.integers(0, 20, (32, 120))]).astype(np.uint8)
        toks[:, :40] = ord('s')
        lens = rng.integers(0, 121, 32)
    else:                                       # narrower than one window
        toks = aa[rng.integers(0, 3, (10, 8))]
        lens = np.arange(10) % 9
    return toks, lens.astype(np.int32)


@pytest.mark.parametrize('kind', ['low_complexity', 'short', 'lowercase',
                                  'narrow'])
def test_seg_batch_matches_jax(kind):
    from swiftortho_tpu.ops.seg import seg_batch as jax_seg
    toks, lens = seg_inputs(kind)
    want = np.asarray(jax_seg(toks, lens))
    got = seg_batch(torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    upper = np.where((toks >= 97) & (toks <= 122), toks - 32, toks)
    if kind != 'narrow':
        assert (want != upper).sum() > 10           # residues were masked


# -- sharded alignment -----------------------------------------------------

def pairs(B, L, seed):
    rng = np.random.default_rng(seed)
    t0 = AA[rng.integers(0, 20, (B, L))]
    t1 = t0.copy()
    sub = rng.random((B, L)) < 0.4
    t1[sub] = AA[rng.integers(0, 20, int(sub.sum()))]
    l0 = rng.integers(1, L + 1, B).astype(np.int32)
    l1 = rng.integers(1, L + 1, B).astype(np.int32)
    return t0, t1, l0, l1


@pytest.mark.parametrize('B', [16, 21])
def test_sw_align_sharded_matches_jax(meshes, B):
    """16 pairs against ``sharded_align_fn``; 21 (not a multiple of the
    mesh) against ``sw_align_sharded``, which pads; the port does not."""
    from swiftortho_tpu.parallel import mesh as jax_mesh
    jm, pm = meshes
    t0, t1, l0, l1 = pairs(B, 96, B)
    if B == 16:
        fn, _, _ = jax_mesh.sharded_align_fn(jm)
        with jm:
            want = fn(t0, t1, l0, l1)
    else:
        want = jax_mesh.sw_align_sharded(jm, t0, t1, l0, l1)
    got = port_mesh.sw_align_sharded(pm, t0, t1, l0, l1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_sw_align_auto_uses_active_mesh(meshes, monkeypatch):
    _, pm = meshes
    seen = []
    real = port_mesh.sw_align_sharded

    def spy(mesh, *a, **k):
        seen.append(mesh)
        return real(mesh, *a, **k)
    monkeypatch.setattr(port_mesh, 'sw_align_sharded', spy)
    args = [torch.from_numpy(x) for x in pairs(12, 64, 3)]
    alone = port_sw.sw_align_auto(*args, score_only=True)
    assert seen == []
    with port_mesh.use_search_mesh(pm):
        sharded = port_sw.sw_align_auto(*args, score_only=True)
    assert seen == [pm]
    for k in ('score', 'bi', 'bj'):
        assert torch.equal(alone[k], sharded[k]), k


# -- sharded search --------------------------------------------------------

@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    from swiftortho_tpu.corpus import make_corpus, write_corpus
    from swiftortho_tpu.io_fasta import SeqDB
    fsa = str(tmp_path_factory.mktemp('torch_parallel') / 'mini.fsa')
    write_corpus(fsa, make_corpus(n_taxa=3, n_families=6, seed=13,
                                  min_len=60, max_len=120))
    return SeqDB.from_path(fsa)


CFG = dict(expect=1e-5, nc=262144, chunk=13, query_batch=16)


@pytest.fixture(scope='module')
def jax_rows(corpus):
    from swiftortho_tpu.config import SearchConfig
    from swiftortho_tpu.search.blastp import blastp_stream
    rows = list(blastp_stream(corpus, corpus, SearchConfig(**CFG)))
    assert len(rows) > 25
    return rows


@pytest.mark.parametrize('route', ['gather', 'pack'])
def test_blastp_sharded_matches_jax(corpus, jax_rows, meshes, route,
                                    monkeypatch, capsys):
    """The port's search under the (4, 2) mesh writes the JAX package's
    rows; with SWIFTORTHO_DEVICE_PACK=force every pair is packed, part
    by part on the mesh devices."""
    from swiftortho_tpu_torch.config import SearchConfig
    _, pm = meshes
    if route == 'pack':
        monkeypatch.setenv('SWIFTORTHO_DEVICE_PACK', 'force')
    capsys.readouterr()
    rows = list(port_mesh.blastp_sharded(corpus, corpus, SearchConfig(**CFG),
                                         mesh=pm, device=CPU))
    waves = events(capsys.readouterr().err, 'search_wave')
    assert rows == jax_rows
    packed = sum(e['packed_pairs'] for e in waves)
    gathered = sum(e['gathered_pairs'] for e in waves)
    if route == 'pack':
        assert packed > 0 and gathered == 0
    else:
        assert packed == 0 and gathered > 0


def test_device_pack_one_table_per_device(corpus, meshes):
    """Under a mesh the resident table is built once per distinct
    device: the (4, 2) mesh over one CPU holds one table."""
    _, pm = meshes
    ctx = port_pack.DevicePackContext(corpus, CPU)
    with port_mesh.use_search_mesh(pm):
        assert ctx._devices() == [CPU] * 8
        assert ctx._table(CPU) is ctx._table('cpu')
    assert list(ctx._tab_dev) == [CPU]
    assert ctx._devices() == [CPU]


# -- the sharded step ------------------------------------------------------

def test_demo_multichip_matches_jax(meshes):
    from swiftortho_tpu.parallel import mesh as jax_mesh
    jm, pm = meshes
    want = jax_mesh.demo_multichip(n_queries=16, mesh=jm)
    got = port_mesh.demo_multichip(n_queries=16, mesh=pm)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    masked, bits, merged = got
    expect = np.full(len(merged), -1, np.int64)
    np.maximum.at(expect, np.arange(len(bits)) % len(merged),
                  bits.astype(np.int64))
    np.testing.assert_array_equal(merged.astype(np.int64), expect)


# -- sharded block-sparse MCL ----------------------------------------------

def clique_chain(n_cliques, csize, seed):
    rng = np.random.default_rng(seed)
    ei, ej, w = [], [], []
    for c in range(n_cliques):
        off = c * csize
        a, b = np.triu_indices(csize, 1)
        ei.append(off + a)
        ej.append(off + b)
        w.append(1.0 + 0.1 * rng.random(len(a)))
        if c:
            ei.append(np.array([off - 1]))
            ej.append(np.array([off]))
            w.append(np.array([0.05]))
    w = np.concatenate(w).astype(np.float32)
    ei, ej = np.concatenate(ei), np.concatenate(ej)
    m = n_cliques * csize
    selfw = np.zeros(m, np.float32)
    np.maximum.at(selfw, ei, w)
    np.maximum.at(selfw, ej, w)
    return m, ei.astype(np.int64), ej.astype(np.int64), w, selfw


def partition(m, ri, rj):
    ri, rj = np.asarray(ri), np.asarray(rj)
    lab = connected_components(m, ri, rj)
    present = np.zeros(m, bool)
    present[ri] = present[rj] = True
    groups = {}
    for i in np.flatnonzero(present):
        groups.setdefault(int(lab[i]), []).append(int(i))
    return sorted(groups.values())


def test_mcl_blocksparse_sharded_matches_single_and_jax(capsys):
    import jax
    from jax.sharding import Mesh

    from swiftortho_tpu.cluster.mcl_blocksparse import \
        mcl_blocksparse as jax_bs
    m, li, lj, w, selfw = clique_chain(40, 15, 0)
    single = partition(m, *port_bs.mcl_blocksparse(m, li, lj, w, selfw, 1.5,
                                                   mb=128))
    assert [len(c) for c in single] == [15] * 40
    capsys.readouterr()
    for n in (2, 4, 3):
        mesh = port_mesh.make_mesh(n_data=n, devices=[CPU] * n)
        got = port_bs.mcl_blocksparse(m, li, lj, w, selfw, 1.5, mb=128,
                                      mesh=mesh)
        assert partition(m, *got) == single, n
    used = [e['devices'] for e in
            events(capsys.readouterr().err, 'mcl_blocksparse')]
    assert used == [2, 4, 1]                  # power-of-two counts only
    jmesh = Mesh(np.asarray(jax.devices()), ('dev',))
    want = jax_bs(m, li, lj, w, selfw, 1.5, mb=128, mesh=jmesh)
    assert partition(m, *want) == single


def test_mcl_mesh_env_shards_over_local_devices(monkeypatch, capsys):
    """SWIFTORTHO_MCL_MESH=1 with two local devices: mcl_cluster's
    oversize component expands over both, with the partition of the run
    without it; with one local device it runs on that one."""
    from swiftortho_tpu_torch.cluster import mcl as port_mcl
    from swiftortho_tpu_torch.parallel import distributed as port_dist
    m, li, lj, w, _ = clique_chain(12, 10, 1)
    want = port_mcl.mcl_cluster(m, li, lj, w, max_dense=32, device=CPU)
    assert [len(c) for c in want] == [10] * 12
    monkeypatch.setenv('SWIFTORTHO_MCL_MESH', '1')
    for devs in ([CPU, CPU], [CPU]):
        monkeypatch.setattr(port_dist, 'local_devices',
                            lambda d, devs=devs: devs)
        capsys.readouterr()
        got = port_mcl.mcl_cluster(m, li, lj, w, max_dense=32, device=CPU)
        used = [e['devices'] for e in
                events(capsys.readouterr().err, 'mcl_blocksparse')]
        assert got == want and used == [len(devs)]


# -- the card --------------------------------------------------------------

def test_indexed_device(monkeypatch):
    assert port_device.indexed('cpu') == CPU
    assert port_device.indexed(torch.device('cuda', 2)) == \
        torch.device('cuda', 2)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 3)
    assert port_device.indexed('cuda') == torch.device('cuda', 3)
    assert port_sw.scoring_tables('cpu') is port_sw.scoring_tables(CPU)


@pytest.fixture(scope='module')
def cards():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
def test_cuda_launch_on_the_tensors_card(cards):
    """The kernel launches on the card its tensors live on, whichever
    card is current, and ``cuda`` and ``cuda:N`` share one table."""
    from swiftortho_tpu_torch.ops.banded_sw_cuda import sw_align_batch_cuda
    host = [torch.from_numpy(x) for x in pairs(64, 128, 5)]
    want = port_sw.sw_align_batch(*host)
    last = cards[-1]
    with torch.cuda.device(cards[0]):
        got = sw_align_batch_cuda(*[x.to(last) for x in host])  # (9, B)
    assert got.device == last
    for i, k in enumerate(port_sw.FIELDS):
        assert torch.equal(got[i].cpu(), want[k]), k
    with torch.cuda.device(last):
        assert port_sw.scoring_tables('cuda') is port_sw.scoring_tables(last)


@pytest.mark.cuda
def test_cuda_mesh_dispatch(cards):
    """sw_align_sharded over a mesh of the cards (each repeated twice)
    launches the kernel once per shard and equals the plain version."""
    from swiftortho_tpu_torch.ops import banded_sw_cuda
    host = [torch.from_numpy(x) for x in pairs(40, 96, 6)]
    want = port_sw.sw_align_batch(*host)
    mesh = port_mesh.make_mesh(n_data=len(cards) * 2,
                               devices=[d for d in cards for _ in (0, 1)])
    banded_sw_cuda.reset_counters()
    got = port_mesh.sw_align_sharded(mesh, *host)
    assert banded_sw_cuda.launches['full'] == mesh.size
    for k in want:
        assert torch.equal(got[k], want[k]), k
