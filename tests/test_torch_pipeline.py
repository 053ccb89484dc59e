"""The port's pipeline CLIs (find_orth, find_cluster, run_all, scripts)
and tools (make_corpus, run_scale) against the JAX package's, on the CPU
(SWIFTORTHO_PLATFORM=cpu) and the tests/test_cli.py corpus: output bytes
equal.

The JAX package is imported inside the tests that use it.
"""

import os
import shutil

import pytest

from swiftortho_tpu.corpus import make_corpus, write_corpus
from swiftortho_tpu_torch.cli import find_cluster as port_cluster
from swiftortho_tpu_torch.cli import find_hit as port_hit
from swiftortho_tpu_torch.cli import find_orth as port_orth
from swiftortho_tpu_torch.cli import run_all as port_run_all
from swiftortho_tpu_torch.cli import scripts as port_scripts

OUTPUTS = ('sc', 'opc', 'clsr', 'pan')


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    monkeypatch.setenv('SWIFTORTHO_JAX_CACHE', '0')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    fsa = str(tmp_path_factory.mktemp('pipe') / 'c.fsa')
    write_corpus(fsa, make_corpus(n_taxa=2, n_families=6, seed=2,
                                  min_len=60, max_len=120))
    return fsa


@pytest.fixture(scope='module')
def sc(corpus):
    out = corpus + '.sc'
    mp = pytest.MonkeyPatch()
    mp.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    try:
        assert port_hit.main(['find_hit', '-p', 'blastp', '-i', corpus,
                              '-d', corpus, '-o', out, '-e', '1e-5']) == 0
    finally:
        mp.undo()
    return out


def stdout_of(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize('flags', [[], ['-y', '50', '-n', 'bsr'],
                                   ['-L', 'y']])
def test_find_orth_matches_jax_cli(sc, flags, capsys):
    from swiftortho_tpu.cli import find_orth as jax_orth
    argv = ['find_orth', '-i', sc] + flags
    want = stdout_of(jax_orth.main, argv, capsys)
    assert want.count('\n') > 5
    assert stdout_of(port_orth.main, argv, capsys) == want


@pytest.mark.parametrize('algo', ['mcl', 'apc', 'sap'])
def test_find_cluster_matches_jax_cli(sc, algo, tmp_path, capsys):
    from swiftortho_tpu.cli import find_cluster as jax_cluster
    opc = str(tmp_path / 'c.opc')
    with open(opc, 'w') as f:
        f.write(stdout_of(port_orth.main, ['find_orth', '-i', sc], capsys))
    argv = ['find_cluster', '-i', opc, '-a', algo]
    want = stdout_of(jax_cluster.main, argv, capsys)
    assert want.count('\n') >= 3
    assert stdout_of(port_cluster.main, argv, capsys) == want


def run_pipeline(main, corpus, where, flags):
    os.makedirs(where)
    fsa = os.path.join(where, 'c.fsa')
    shutil.copy(corpus, fsa)
    assert main(['run_all', '-i', fsa, '-A', 'mcl', '-y', '0'] + flags) == 0
    res = fsa + '_results'
    out = {}
    for ext in OUTPUTS:
        with open(os.path.join(res, 'c.fsa.' + ext), 'rb') as f:
            out[ext] = f.read()
    return fsa, out


@pytest.mark.parametrize('flags', [[], ['-z', 'fast']])
def test_run_all_matches_jax(corpus, flags, tmp_path):
    from swiftortho_tpu.cli import run_all as jax_run_all
    _, want = run_pipeline(jax_run_all.main, corpus, str(tmp_path / 'j'),
                           flags)
    _, got = run_pipeline(port_run_all.main, corpus, str(tmp_path / 'p'),
                          flags)
    for ext in OUTPUTS:
        assert got[ext] == want[ext], ext
    assert want['clsr'].count(b'\n') >= 3


def test_run_all_resume_skips_fresh_stages(corpus, tmp_path, monkeypatch,
                                           capsys):
    fsa, first = run_pipeline(port_run_all.main, corpus,
                              str(tmp_path / 'p'), [])

    def boom(*a, **k):
        raise AssertionError('a fresh stage was recomputed')
    monkeypatch.setattr(port_run_all, 'blastp_to_file', boom)
    monkeypatch.setattr(port_run_all, 'find_orth_blocks', boom)
    monkeypatch.setattr(port_run_all, 'find_cluster_stream', boom)
    capsys.readouterr()
    assert port_run_all.main(['run_all', '-i', fsa, '-A', 'mcl', '-y', '0',
                              '-R', 'y']) == 0
    assert capsys.readouterr().err.count('"skipped": true') == 3
    for ext in OUTPUTS:
        with open('%s_results/c.fsa.%s' % (fsa, ext), 'rb') as f:
            assert f.read() == first[ext]


def run_all_fleet(fsa, flags, nproc=2):
    """run_all on ``nproc`` ranks joined through the SWIFTORTHO_COORD
    variables, on the CPU; each child has a timeout."""
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SWIFTORTHO_PLATFORM='cpu', PYTHONPATH=repo,
               SWNATIVE_THREADS='1', SWIFTORTHO_PRODUCERS='1',
               SWIFTORTHO_COORD='127.0.0.1:%d' % port,
               SWIFTORTHO_NPROCS=str(nproc), SWIFTORTHO_DIST_TIMEOUT='120')
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'swiftortho_tpu_torch.cli.run_all', '-i', fsa,
         '-A', 'mcl', '-y', '0'] + flags,
        env=dict(env, SWIFTORTHO_PROC_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nproc)]
    try:
        outs = [p.communicate(timeout=300)[0].decode(errors='replace')
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * nproc, '\n'.join(outs)
    return outs


def test_run_all_fleet_matches_one_process(corpus, tmp_path):
    """run_all as a 2-rank fleet, plain and -z fast: the .sc, .opc and
    .clsr equal the single-process port's.  The plain fleet searches a
    chunk index that rank 0 built once; only rank 0 runs the later
    stages."""
    import glob
    for name, flags in (('plain', []), ('fast', ['-z', 'fast'])):
        _, want = run_pipeline(port_run_all.main, corpus,
                               str(tmp_path / ('one_' + name)), flags)
        where = tmp_path / ('fleet_' + name)
        where.mkdir()
        fsa = str(where / 'c.fsa')
        shutil.copy(corpus, fsa)
        outs = run_all_fleet(fsa, flags)
        for ext in ('sc', 'opc', 'clsr'):
            with open('%s_results/c.fsa.%s' % (fsa, ext), 'rb') as f:
                assert f.read() == want[ext], (name, ext)
        assert want['clsr'].count(b'\n') >= 3
        assert '"fleet_rank_done"' in outs[1]
        assert '"fleet_rank_done"' not in outs[0]
        assert bool(glob.glob('%s_results/c.fsa.fleetdb.*.npz' % fsa)) == \
            (name == 'plain')


def test_scripts_dispatch_to_jax_commands(sc, capsys):
    from swiftortho_tpu.cli import scripts as jax_scripts
    want = stdout_of(jax_scripts.main, ['get_rbh', sc], capsys)
    assert want
    assert stdout_of(port_scripts.main, ['get_rbh', sc], capsys) == want
    assert port_scripts.main(['nonsense']) == 1
    assert 'names:' in capsys.readouterr().out


@pytest.mark.parametrize('main', [port_orth.main, port_cluster.main,
                                  port_run_all.main])
def test_usage_errors(main, capsys):
    assert main(['prog']) == 1
    assert 'Usage' in capsys.readouterr().out


def test_make_corpus_tool_matches_jax(tmp_path):
    """tools/make_corpus: the fasta and its .truth equal the JAX
    script's."""
    import subprocess
    import sys
    from swiftortho_tpu_torch.tools import make_corpus as port_tool
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want, got = str(tmp_path / 'j.fsa'), str(tmp_path / 'p.fsa')
    r = subprocess.run([sys.executable, os.path.join(repo, 'tools',
                                                     'make_corpus.py'),
                        want, '3', '20', '5'], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert port_tool.main(['make_corpus', got, '3', '20', '5']) == 0
    for ext in ('', '.truth'):
        with open(want + ext, 'rb') as a, open(got + ext, 'rb') as b:
            assert b.read() == a.read(), ext


def test_run_scale_matches_jax(tmp_path, capsys):
    """tools/run_scale on a tiny corpus (3 taxa, 30 families): the
    workdir's .sc, .opc and .clsr equal the JAX script's, -L y is
    byte-equal, and the JSON line adds up."""
    import json
    import subprocess
    import sys
    from swiftortho_tpu_torch.tools import run_scale as port_tool
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ['--taxa', '3', '--families', '30', '--max-len', '200']
    jdir, pdir = str(tmp_path / 'j'), str(tmp_path / 'p')
    r = subprocess.run([sys.executable, os.path.join(repo, 'tools',
                                                     'run_scale.py'),
                        '--workdir', jdir] + args, capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS='cpu',
                                SWIFTORTHO_JAX_CACHE='0'))
    assert r.returncode == 0, r.stderr[-2000:]
    capsys.readouterr()
    assert port_tool.main(['--workdir', pdir, '--orth-out-of-core']
                          + args) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    for ext in ('fsa', 'sc', 'opc', 'clsr'):
        with open(os.path.join(jdir, 'c.' + ext), 'rb') as a, \
                open(os.path.join(pdir, 'c.' + ext), 'rb') as b:
            assert b.read() == a.read(), ext
    assert res['orth_out_of_core_equal'] and res['device'] == 'cpu'
    assert res['chunks'] == 1 and res['sc_rows'] > 0
    assert 'purity: %d/%d groups single-family' % (
        res['pure_groups'], res['clsr_groups']) in r.stdout
    assert res['pure_groups'] == res['clsr_groups'] > 0
