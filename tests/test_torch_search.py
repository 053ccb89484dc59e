"""All-vs-all search on the port (swiftortho_tpu_torch.search.blastp and
its find_hit CLI) against the JAX package: the same m8 rows, byte for
byte, on the tests/test_ref_parity.py corpus.

CPU tests run the plain PyTorch SW; the ``cuda`` tests run the kernel and
hold it against the CPU run of the port.  The JAX package is imported
inside the tests that use it, so the card tests also collect where JAX
is not installed.
"""

import pytest
import torch

from swiftortho_tpu.config import SearchConfig
from swiftortho_tpu.corpus import make_corpus, write_corpus
from swiftortho_tpu.io_fasta import SeqDB
from swiftortho_tpu_torch.cli import find_hit as port_cli
from swiftortho_tpu_torch.ops import banded_sw_cuda
from swiftortho_tpu_torch.search import blastp as port

CPU = torch.device('cpu')
# -M keeps the persisted makedb index small; -e exercises flag parsing
CLI_FLAGS = ['-e', '1e-5', '-M', '262144']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    fsa = str(tmp_path_factory.mktemp('torch_search') / 'c.fsa')
    write_corpus(fsa, make_corpus(4, 40, seed=7, min_len=60, max_len=150))
    return fsa


@pytest.fixture(scope='module')
def db(corpus):
    return SeqDB.from_path(corpus)


@pytest.fixture(scope='module')
def jax_rows(db):
    from swiftortho_tpu.search.blastp import blastp_stream
    rows = list(blastp_stream(db, db, SearchConfig()))
    assert len(rows) > 100
    return rows


@pytest.fixture(scope='module')
def port_rows(db):
    return list(port.blastp_stream(db, db, SearchConfig(), device=CPU))


def test_stream_matches_jax(port_rows, jax_rows):
    assert port_rows == jax_rows


def test_stream_prepass_matches_jax(db, jax_rows, monkeypatch):
    """The score-only prepass (on by default only on CUDA) forced through
    the policy hook: the schedule changes, the rows do not."""
    seen = []

    def forced(device):
        seen.append(device)
        return True
    monkeypatch.setattr(port, 'use_prepass', forced)
    rows = list(port.blastp_stream(db, db, SearchConfig(), device=CPU))
    assert seen and rows == jax_rows


def test_prepass_policy():
    assert port.use_prepass(torch.device('cuda'))
    assert not port.use_prepass(CPU)


@pytest.fixture(scope='module')
def jax_cli_sc(corpus, tmp_path_factory):
    from swiftortho_tpu.cli import find_hit as jax_cli
    out = str(tmp_path_factory.mktemp('jax_cli') / 'j.sc')
    mp = pytest.MonkeyPatch()
    mp.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    mp.setenv('SWIFTORTHO_JAX_CACHE', '0')
    try:
        assert jax_cli.main(['find_hit', '-p', 'blastp', '-i', corpus,
                             '-d', corpus, '-o', out] + CLI_FLAGS) == 0
    finally:
        mp.undo()
    with open(out) as f:
        return f.read()


def test_cli_matches_jax_cli(corpus, jax_cli_sc, tmp_path, monkeypatch):
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    out = str(tmp_path / 'p.sc')
    assert port_cli.main(['find_hit', '-p', 'blastp', '-i', corpus,
                          '-d', corpus, '-o', out] + CLI_FLAGS) == 0
    with open(out) as f:
        assert f.read() == jax_cli_sc


def test_cli_makedb_then_search(corpus, jax_cli_sc, tmp_path, monkeypatch):
    import glob
    import shutil
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    local = str(tmp_path / 'db.fsa')
    shutil.copy(corpus, local)
    assert port_cli.main(['find_hit', '-p', 'makedb', '-i', local,
                          '-M', '262144']) == 0
    assert glob.glob(local + '.*.npz')
    out = str(tmp_path / 'd.sc')
    assert port_cli.main(['find_hit', '-p', 'blastp', '-i', corpus,
                          '-d', local, '-o', out, '-D', local]
                         + CLI_FLAGS) == 0
    with open(out) as f:
        assert f.read() == jax_cli_sc


def test_cli_usage_errors(capsys):
    assert port_cli.main(['find_hit', '-p', 'blastp']) == 1
    assert 'Usage' in capsys.readouterr().out


@pytest.mark.parametrize('env', [('SWIFTORTHO_CANDIDATES', 'multidb')])
def test_multidb_mesh_rows_match_jax(corpus, env, monkeypatch):
    """The multi-db route on a mesh of the CPU repeated four times, the
    reference cut into five chunks, the first 40 queries: the JAX
    package's host rows."""
    from swiftortho_tpu.search.blastp import blastp_stream
    from swiftortho_tpu_torch.config import SearchConfig as PortConfig
    from swiftortho_tpu_torch.io_fasta import SeqDB as PortDB
    from swiftortho_tpu_torch.parallel.mesh import make_mesh, use_search_mesh
    jdb = SeqDB.from_path(corpus)
    want = list(blastp_stream(jdb, jdb, SearchConfig(chunk=32), q_end=40))
    assert len(want) > 40
    monkeypatch.setenv(*env)
    pdb = PortDB.from_path(corpus)
    with use_search_mesh(make_mesh(n_data=2, n_db=2, devices=[CPU] * 4)):
        rows = list(port.blastp_stream(pdb, pdb, PortConfig(chunk=32),
                                       q_end=40, device=CPU))
    assert rows == want


@pytest.fixture(scope='module')
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_search_matches_cpu(cuda_device, db, port_rows):
    banded_sw_cuda.reset_counters()
    rows = list(port.blastp_stream(db, db, SearchConfig(),
                                   device=cuda_device))
    assert rows == port_rows
    assert banded_sw_cuda.launches['score_only'] > 0
    assert banded_sw_cuda.launches['full'] > 0
    # the prepass covers every aligned pair, the full pass a subset
    assert (banded_sw_cuda.pairs['score_only']
            > banded_sw_cuda.pairs['full'] > 0)
