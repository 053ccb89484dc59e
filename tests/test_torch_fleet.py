"""The port's multi-process fleet (``swiftortho_tpu_torch.parallel.
distributed``) against the JAX package, as tests/test_multihost.py holds
the JAX fleet.

Two processes join one gloo group through the ``SWIFTORTHO_COORD``
variables and run the port's ``find_hit`` CLI on the CPU: each rank
searches its half of the queries and rank 0 merges the parts.  The
merged table must equal the JAX package's ``blastp_stream``, byte for
byte.  The same ranks then run the sharded step over a mesh that spans
both processes, which must equal the single-process step.  Every child
gets a timeout and the group an init timeout, so a hang fails the test.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch.parallel import distributed as port_dist
from swiftortho_tpu_torch.parallel import mesh as port_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
CFG = dict(expect=1e-5, nc=262144, chunk=12, query_batch=4)
CLI = ['-e', '1e-5', '-M', '262144', '-c', '12']

WORKER = textwrap.dedent("""
    import functools, sys
    import numpy as np, torch
    from swiftortho_tpu_torch.cli import find_hit
    from swiftortho_tpu_torch.config import SearchConfig
    fsa, out, outdir = sys.argv[1:4]
    # four queries a wave, so that each rank runs several waves
    find_hit.SearchConfig = functools.partial(SearchConfig, query_batch=4)
    assert find_hit.main(['find_hit', '-p', 'blastp', '-i', fsa, '-d', fsa,
                          '-o', out] + sys.argv[4:]) == 0
    from swiftortho_tpu_torch.parallel import distributed as d
    from swiftortho_tpu_torch.parallel.mesh import demo_multichip
    assert d.process_count() == 2
    mesh = d.global_mesh(devices=[torch.device('cpu')] * 2)
    assert mesh.shape == (2, 2) and mesh.spans_processes()
    assert mesh.procs.tolist() == [[0, 0], [1, 1]]
    masked, bits, merged = demo_multichip(mesh=mesh)
    np.savez('%s/step_%d.npz' % (outdir, d.process_index()),
             masked=masked, bits=bits, merged=merged)
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def events(out: str, stage: str):
    return [rec for rec in (json.loads(line[len('[swiftortho] '):])
                            for line in out.splitlines()
                            if line.startswith('[swiftortho] {'))
            if rec.get('stage') == stage]


@pytest.fixture(scope='module')
def fleet(tmp_path_factory):
    """A 2-rank fleet through the find_hit CLI on an 18-sequence corpus:
    (corpus path, merged .sc path, each rank's output, run dir)."""
    from swiftortho_tpu.corpus import make_corpus, write_corpus
    where = tmp_path_factory.mktemp('torch_fleet')
    fsa = str(where / 'mini.fsa')
    # 18 queries, 4 a wave: rank 1 starts at query 9, so its wave
    # boundaries (9, 13, 17) differ from the single process's (8, 12, 16)
    write_corpus(fsa, make_corpus(n_taxa=2, n_families=9, seed=5,
                                  min_len=60, max_len=120))
    worker = where / 'worker.py'
    worker.write_text(WORKER)
    out = str(where / 'merged.sc')
    port = free_port()
    env = dict(os.environ, SWIFTORTHO_PLATFORM='cpu', PYTHONPATH=REPO,
               SWNATIVE_THREADS='1', SWIFTORTHO_PRODUCERS='1',
               SWIFTORTHO_COORD='127.0.0.1:%d' % port,
               SWIFTORTHO_NPROCS='2', SWIFTORTHO_DIST_TIMEOUT='120')
    procs = [subprocess.Popen(
        [sys.executable, str(worker), fsa, out, str(where)] + CLI,
        env=dict(env, SWIFTORTHO_PROC_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode(
                errors='replace'))
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], '\n'.join(outs)
    return fsa, out, outs, where


def test_fleet_rows_match_jax(fleet):
    from swiftortho_tpu.config import SearchConfig
    from swiftortho_tpu.io_fasta import SeqDB
    from swiftortho_tpu.search.blastp import blastp_stream
    fsa, out, _, _ = fleet
    db = SeqDB.from_path(fsa)
    want = ''.join(blastp_stream(db, db, SearchConfig(**CFG)))
    with open(out) as f:
        got = f.read()
    assert got == want and got


def test_fleet_ranks_split_queries_and_waves(fleet):
    _, _, outs, _ = fleet
    ranges = [events(o, 'fleet_rank_range') for o in outs]
    assert [[(r['rank'], r['nproc']) for r in rr] for rr in ranges] == \
        [[(0, 2)], [(1, 2)]]
    assert [(r[0]['q_lo'], r[0]['q_hi']) for r in ranges] == \
        [(0, 9), (9, 18)]
    # each rank ran only its own waves: ceil(9 / 4) each
    assert [len(events(o, 'search_wave')) for o in outs] == [3, 3]


def test_fleet_parts_removed_and_phases_logged(fleet):
    _, out, outs, where = fleet
    assert not list(where.glob('merged.sc.part*'))
    for rank, o in enumerate(outs):
        ph = events(o, 'fleet_rank_phases')
        assert len(ph) == 1 and ph[0]['rank'] == rank, o[-2000:]
        assert min(ph[0][k] for k in ('search_s', 'barrier_s', 'merge_s',
                                      'total_s')) >= 0


def test_cross_process_step_matches_single(fleet):
    """The sharded step over the (2, 2) mesh that spans both ranks: the
    ranks agree, and equal the single-process step over four shards and
    the JAX step over a (2, 2) mesh."""
    from swiftortho_tpu.parallel import mesh as jax_mesh
    where = fleet[3]
    got = [np.load(where / ('step_%d.npz' % r)) for r in (0, 1)]
    single = port_mesh.demo_multichip(mesh=port_mesh.make_mesh(
        n_data=2, n_db=2, devices=[CPU] * 4))
    want = jax_mesh.demo_multichip(mesh=jax_mesh.make_mesh(n_data=2, n_db=2))
    for i, k in enumerate(('masked', 'bits', 'merged')):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_array_equal(got[0][k], single[i], err_msg=k)
        np.testing.assert_array_equal(single[i], want[i], err_msg=k)


@pytest.mark.parametrize('q_start,q_end,nproc', [
    (0, 18, 2), (0, 17, 4), (5, 6, 3), (3, 3, 2), (10, 2, 2), (0, 41168, 2)])
def test_rank_query_range_matches_jax(q_start, q_end, nproc):
    from swiftortho_tpu.parallel.distributed import rank_query_range
    got = [port_dist.rank_query_range(q_start, q_end, nproc, p)
           for p in range(nproc)]
    assert got == [rank_query_range(q_start, q_end, nproc, p)
                   for p in range(nproc)]
    covered = [q for lo, hi in got for q in range(lo, hi)]
    assert covered == list(range(q_start, max(q_start, q_end)))


@pytest.mark.parametrize('nq,nd,q_start,q_end', [
    (10, 8, 0, -1), (10, 12, 0, -1), (10, 8, -3, 4), (10, 8, 12, 20)])
def test_resolve_query_range_matches_jax(nq, nd, q_start, q_end):
    from swiftortho_tpu.parallel.distributed import resolve_query_range
    qry, ref = range(nq), range(nd)
    assert port_dist.resolve_query_range(qry, ref, q_start, q_end) == \
        resolve_query_range(qry, ref, q_start, q_end)


def test_outside_a_fleet(monkeypatch):
    """Without the fleet variables nothing is joined, every helper is
    the one-process answer, and on the one CPU no mesh is made."""
    for k in ('SWIFTORTHO_COORD', 'SWIFTORTHO_NPROCS', 'SWIFTORTHO_PROC_ID'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    monkeypatch.setenv('SWIFTORTHO_MESH', '1')
    assert port_dist.init_distributed() is False
    assert (port_dist.process_count(), port_dist.process_index()) == (1, 0)
    assert port_dist.local_devices() == [CPU]
    port_dist.barrier('nothing to wait for')
    with port_dist.search_mesh_context():
        assert port_mesh.active_search_mesh() is None
    assert port_dist.global_mesh(devices=[CPU] * 2).shape == (1, 2)
    monkeypatch.setenv('SWIFTORTHO_NPROCS', '2')
    with pytest.raises(ValueError, match='SWIFTORTHO_COORD'):
        port_dist.init_distributed()


def test_card_share_and_collective_group(monkeypatch):
    """A rank takes a contiguous share of its host's cards, or shares
    one when the host has fewer cards than ranks; CUDA tensors of two
    ranks on one card cannot gather (NCCL), CPU tensors gather on gloo."""
    cards = [torch.device('cuda', i) for i in range(4)]
    monkeypatch.setattr(port_dist, '_platform_devices', lambda d: cards)
    for rank, want in ((0, cards[:2]), (1, cards[2:])):
        monkeypatch.setitem(port_dist._HOST, 'rank', rank)
        monkeypatch.setitem(port_dist._HOST, 'size', 2)
        assert port_dist.local_devices('cuda') == want
    monkeypatch.setattr(port_dist, '_platform_devices', lambda d: cards[:1])
    for rank in (0, 1):
        monkeypatch.setitem(port_dist._HOST, 'rank', rank)
        assert port_dist.local_devices('cuda') == cards[:1]
    monkeypatch.setattr(port_dist, '_SHARED_CARD', True)
    with pytest.raises(RuntimeError, match='NCCL'):
        port_dist.collective_group(cards[0])
    assert port_dist.collective_group(CPU) is port_dist._GLOO
