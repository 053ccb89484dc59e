"""The port's multi-db candidate fan-out
(``swiftortho_tpu_torch.search.candidates_multidb``) against the JAX
package: one chunk index per shard, each shard's candidates equal to the
JAX host engine's on the same chunk field for field, and the search under
``SWIFTORTHO_CANDIDATES=multidb`` writing the JAX package's host rows,
as tests/test_multidb.py holds the JAX fan-out on its 8-device CPU mesh.
The port's meshes repeat the CPU device.
"""

import json

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch.parallel import mesh as port_mesh
from swiftortho_tpu_torch.search import candidates_multidb as port_mdb

CPU = torch.device('cpu')
CFG = dict(expect=1e-5, nc=262144, chunk=12, query_batch=32)
FIELDS = ('qrow', 'subject', 'score', 'band_q', 'band_s')


def events(err, stage):
    return [rec for rec in (json.loads(line[len('[swiftortho] '):])
                            for line in err.splitlines()
                            if line.startswith('[swiftortho] {'))
            if rec.get('stage') == stage]


@pytest.fixture(scope='module')
def fsa(tmp_path_factory):
    from swiftortho_tpu.corpus import make_corpus, write_corpus
    path = str(tmp_path_factory.mktemp('torch_mdb') / 'c.fsa')
    write_corpus(path, make_corpus(n_taxa=4, n_families=12, seed=21,
                                   min_len=60, max_len=140))
    return path


@pytest.fixture(scope='module')
def host_rows(fsa):
    from swiftortho_tpu.config import SearchConfig
    from swiftortho_tpu.io_fasta import SeqDB
    from swiftortho_tpu.search.blastp import blastp_stream
    db = SeqDB.from_path(fsa)
    rows = list(blastp_stream(db, db, SearchConfig(**CFG)))
    assert len(rows) > 50
    return rows


def test_shard_devices_round_robin(monkeypatch):
    cards = [torch.device('cuda', i) for i in range(4)]
    # the 'db' axis of the active mesh (its first 'data' row)
    with port_mesh.use_search_mesh(port_mesh.make_mesh(
            n_data=1, n_db=4, devices=cards)):
        assert port_mdb.shard_devices(6) == cards + cards[:2]
    with port_mesh.use_search_mesh(port_mesh.make_mesh(
            n_data=2, n_db=2, devices=cards)):
        assert port_mdb.shard_devices(3) == [cards[0], cards[1], cards[0]]
    # a mesh over two ranks: this rank's entries of the row only
    spanning = port_mesh.Mesh(np.array([cards], dtype=object),
                              procs=[[0, 0, 1, 1]])
    with port_mesh.use_search_mesh(spanning):
        assert port_mdb.shard_devices(3) == [cards[0], cards[1], cards[0]]
    # no mesh: this process's devices of the platform
    assert port_mdb.shard_devices(3, platform=CPU) == [CPU] * 3
    assert port_mdb.shard_devices(2, devices=cards[2:]) == cards[2:]


def test_per_shard_candidates_match_jax_host_engine(fsa):
    """Each shard's candidates equal the JAX host engine's on the same
    chunk index, field for field."""
    from swiftortho_tpu.config import SearchConfig as JaxConfig
    from swiftortho_tpu.io_fasta import SeqDB as JaxDB
    from swiftortho_tpu.search.blastp import IndexSource as JaxIndexSource
    from swiftortho_tpu.search.candidates import generate_candidates
    from swiftortho_tpu_torch.config import SearchConfig
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.search.blastp import IndexSource
    db, cfg = SeqDB.from_path(fsa), SearchConfig(**CFG)
    jdb, jcfg = JaxDB.from_path(fsa), JaxConfig(**CFG)
    indexes = list(IndexSource.from_build(db, cfg))
    jax_indexes = list(JaxIndexSource.from_build(jdb, jcfg))
    assert len(indexes) == len(jax_indexes) >= 4
    toks, lens = db.padded_batch(np.arange(32, dtype=np.int64), 256)
    with port_mesh.use_search_mesh(port_mesh.make_mesh(
            n_data=2, n_db=4, devices=[CPU] * 8)):
        got = port_mdb.generate_candidates_multidb(
            toks, lens, db, indexes, cfg.resolved_alphabets(), cfg.seeds)
    assert len(got) == len(indexes)
    for jix, cand in zip(jax_indexes, got):
        want = generate_candidates(toks, lens, jdb, jix,
                                   jcfg.resolved_alphabets(), jcfg.seeds)
        assert len(want.subject) > 0
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(cand, f), getattr(want, f),
                                          err_msg=f)


@pytest.mark.parametrize('cap', ['default', 'fallback'])
def test_multidb_search_matches_jax_host_rows(fsa, host_rows, cap,
                                              monkeypatch, capsys):
    """The search under SWIFTORTHO_CANDIDATES=multidb on a (2, 4) mesh
    writes the JAX host rows.  With the default cap no shard falls back;
    with a cap of one posting every shard runs the host engine, logs
    ``device_candidates_fallback`` and the rows do not change."""
    from swiftortho_tpu_torch.config import SearchConfig
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.search.blastp import blastp_stream
    monkeypatch.setenv('SWIFTORTHO_CANDIDATES', 'multidb')
    if cap == 'fallback':
        monkeypatch.setenv('SWIFTORTHO_DEVICE_CAND_CAP', '1')
    db = SeqDB.from_path(fsa)
    capsys.readouterr()
    with port_mesh.use_search_mesh(port_mesh.make_mesh(
            n_data=2, n_db=4, devices=[CPU] * 8)):
        rows = list(blastp_stream(db, db, SearchConfig(**CFG), device=CPU))
    err = capsys.readouterr().err
    assert rows == host_rows
    phase = events(err, 'search_phaseA')
    assert [e['mode'] for e in phase] == ['multidb']
    falls = events(err, 'device_candidates_fallback')
    if cap == 'fallback':
        n_waves = -(-len(db) // CFG['query_batch'])
        assert len(falls) == phase[0]['shards_resident'] * n_waves
        assert {e['reason'] for e in falls} == {'cap'}
    else:
        assert falls == []
