"""The port's tools and its stage trace against the JAX package's
counterparts, on the same seeded inputs on the CPU.

- ``utils.stage`` with SWIFTORTHO_TRACE_DIR writes a torch.profiler
  Chrome trace under ``<dir>/<stage>/`` and logs the JAX ``stage``'s
  event; without the variable it makes no directory;
- ``tools.profile_phaseA``: the candidates of every (wave, chunk) equal
  the JAX tool's, line for line;
- ``tools.scaling_bench`` (a 1- and a 2-rank fleet of CPU processes): the
  merged ``.sc`` of each fleet equals the JAX find_hit CLI's;
- ``tools.bench_device_cand``: device and host candidates equal at two
  caps, and the host candidates equal the JAX ``generate_candidates``'s;
- ``tools/example_run.sh``: the JAX script's commands on the port's
  modules, with no CPU default;
- ``tools.index_cold``: every build of the first chunk logs the device
  index's stages, with the host ``build_index``'s postings.

No timing is asserted: the CPU runs the plain versions of the kernels.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch import utils as port_utils
from swiftortho_tpu_torch.tools import bench_device_cand as port_bdc
from swiftortho_tpu_torch.tools import profile_phaseA as port_phasea
from swiftortho_tpu_torch.tools import scaling_bench as port_scaling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ('qrow', 'subject', 'score', 'band_q', 'band_s')


def _events(text):
    return [json.loads(ln.split(' ', 1)[1]) for ln in text.splitlines()
            if ln.startswith('[swiftortho] {')]


def _stage_events(stage_fn):
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        with stage_fn('x', algorithm='mcl'):
            torch.ones(64).cumsum(0)
    return _events(buf.getvalue())


def _without_clock(events):
    return [{k: v for k, v in e.items() if k not in ('ts', 'seconds')}
            for e in events]


# -- utils.stage ---------------------------------------------------------

def test_stage_trace_writes_chrome_trace(tmp_path, monkeypatch):
    from swiftortho_tpu import utils as jax_utils
    monkeypatch.delenv('SWIFTORTHO_TRACE_DIR', raising=False)
    want = _without_clock(_stage_events(jax_utils.stage))
    monkeypatch.setenv('SWIFTORTHO_TRACE_DIR', str(tmp_path / 'trace'))
    got = _stage_events(port_utils.stage)
    assert _without_clock(got) == want == [{'stage': 'x',
                                            'algorithm': 'mcl'}]
    files = list((tmp_path / 'trace' / 'x').glob('*.pt.trace.json'))
    assert len(files) == 1
    names = {e.get('name') for e in
             json.loads(files[0].read_text())['traceEvents']}
    assert 'aten::cumsum' in names


def test_stage_without_trace_dir_makes_nothing(tmp_path, monkeypatch):
    from swiftortho_tpu import utils as jax_utils
    monkeypatch.delenv('SWIFTORTHO_TRACE_DIR', raising=False)
    monkeypatch.chdir(tmp_path)
    got = _stage_events(port_utils.stage)
    assert _without_clock(got) == _without_clock(
        _stage_events(jax_utils.stage))
    assert list(tmp_path.iterdir()) == []


def test_stage_trace_that_cannot_start_is_logged(tmp_path, monkeypatch):
    """A second trace inside a running one does not start (it would end
    the first one's session): one trace_unavailable event, both stages
    timed, the outer trace written."""
    monkeypatch.setenv('SWIFTORTHO_TRACE_DIR', str(tmp_path))
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        with port_utils.stage('outer'):
            with port_utils.stage('inner'):
                torch.ones(8).sum()
    ev = _events(buf.getvalue())
    assert [e['stage'] for e in ev] == ['trace_unavailable', 'inner',
                                        'outer']
    assert ev[0]['trace'] == 'inner' and 'already' in ev[0]['error']
    assert list((tmp_path / 'outer').glob('*.pt.trace.json'))
    assert not (tmp_path / 'inner').exists()


# -- profile_phaseA --------------------------------------------------------

PHASEA_ARGS = ['--taxa', '3', '--families', '30', '--waves', '1',
               '--nc', '65536']


def _chunk_lines(text):
    """The per-(wave, chunk) lines with their seconds blanked."""
    return [re.sub(r'\d+\.\d+s', 'Ts', ln) for ln in text.splitlines()
            if ln.lstrip().startswith(('[cached ctx]', '[plain]'))]


def test_profile_phaseA_matches_jax(tmp_path, capsys):
    r = subprocess.run([sys.executable, os.path.join(REPO, 'tools',
                                                     'profile_phaseA.py'),
                        '--workdir', str(tmp_path / 'j')] + PHASEA_ARGS,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert r.returncode == 0, r.stderr[-2000:]
    capsys.readouterr()
    assert port_phasea.main(['--workdir', str(tmp_path / 'p')]
                            + PHASEA_ARGS) == 0
    out = capsys.readouterr().out
    want = _chunk_lines(r.stdout)
    assert _chunk_lines(out) == want and len(want) == 2
    res = json.loads(out.splitlines()[-1])
    jax_cands = [int(x) for x in re.findall(r'\(cands (\d+)\)', r.stdout)]
    assert [w['cands'] for w in res['waves']] == [jax_cands] == [[626]]
    assert res['chunks'] == 1 and not res['index_cached']
    for f in ('c.fsa', 'idx_nc65536.0.npz'):
        with open(tmp_path / 'j' / f, 'rb') as a, \
                open(tmp_path / 'p' / f, 'rb') as b:
            assert b.read() == a.read(), f
    # the index cache is reused
    assert port_phasea.main(['--workdir', str(tmp_path / 'p')]
                            + PHASEA_ARGS) == 0
    again = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert again['index_cached'] and again['corpus_s'] is None
    assert [w['cands'] for w in again['waves']] == [[626]]


# -- scaling_bench ---------------------------------------------------------

SCALING_SEQS = 60


def test_scaling_bench_matches_jax_cli(tmp_path, monkeypatch):
    from swiftortho_tpu.cli import find_hit as jax_cli
    from swiftortho_tpu.corpus import make_corpus, write_corpus
    r = subprocess.run(
        [sys.executable, '-m', 'swiftortho_tpu_torch.tools.scaling_bench',
         '--seqs', str(SCALING_SEQS), '--procs', '1,2'],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, SWIFTORTHO_PLATFORM='cpu', PYTHONPATH=REPO,
                 TMPDIR=str(tmp_path)))
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res['metric'] == 'fleet_scaling' and res['device'] == 'cpu'
    rows = res['results']
    assert [x['procs'] for x in rows] == [1, 2]
    for x in rows:
        assert x['cards'] == 0 and x['ranks_per_card'] is None
        assert x['seconds'] > 0 and x['rows_per_s'] > 0
        assert x['efficiency'] > 0 and x['rows'] > 0
        assert [k['rank'] for k in x['ranks']] == list(range(x['procs']))
        assert all({'init_s', 'cpu_s', 'search_s', 'barrier_s',
                    'merge_s'} <= set(k) for k in x['ranks'])
    assert re.findall(r'^procs=(\d+)', r.stdout, re.M) == ['1', '2']

    # the corpus and the merged tables against the JAX package's
    want_fsa = str(tmp_path / 'jax.fsa')
    write_corpus(want_fsa, make_corpus(n_taxa=10,
                                       n_families=SCALING_SEQS // 10,
                                       seed=7, min_len=120, max_len=240))
    with open(want_fsa, 'rb') as a, open(res['fsa'], 'rb') as b:
        assert b.read() == a.read()
    want_sc = str(tmp_path / 'jax.sc')
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    monkeypatch.setenv('SWIFTORTHO_JAX_CACHE', '0')
    assert jax_cli.main(['find_hit', '-p', 'blastp', '-i', want_fsa, '-d',
                         want_fsa, '-o', want_sc, '-e', '1e-5', '-M',
                         '262144']) == 0
    with open(want_sc, 'rb') as f:
        want = f.read()
    assert want and res['sc_md5'] == hashlib.md5(want).hexdigest()
    workdir = os.path.dirname(res['fsa'])
    for n in (1, 2):
        with open(os.path.join(workdir, 'out_%d.sc' % n), 'rb') as f:
            assert f.read() == want, n
    assert not [f for f in os.listdir(workdir) if '.part' in f]


def test_scaling_bench_card_assignment(monkeypatch):
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '3,5')
    assert port_scaling.card_ids(cuda, 1) == ['3']
    assert port_scaling.card_ids(cuda, 2) == ['3', '5']
    assert port_scaling.card_ids(cuda, 4) == ['3'] * 4
    assert port_scaling.card_ids(cpu, 2) is None


# -- bench_device_cand -----------------------------------------------------

CAND_CORPUS = dict(n_taxa=3, n_families=20, seed=7, min_len=60, max_len=120)


def test_bench_device_cand_parity_and_jax_host(tmp_path, monkeypatch):
    from swiftortho_tpu.config import SearchConfig
    from swiftortho_tpu.corpus import make_corpus, write_corpus
    from swiftortho_tpu.io_fasta import SeqDB
    from swiftortho_tpu.ops.index import build_index
    from swiftortho_tpu.ops.seg import seg_batch_vec
    from swiftortho_tpu.search.candidates import generate_candidates

    from swiftortho_tpu_torch.search import candidates as port_cand
    host = []
    real = port_cand.generate_candidates

    def recording(*a, **k):
        host.append(real(*a, **k))
        return host[-1]
    monkeypatch.setattr(port_cand, 'generate_candidates', recording)
    monkeypatch.setenv('SWIFTORTHO_DEVICE_CAND_CAP', '123')
    out = io.StringIO()
    res = port_bdc.bench(**CAND_CORPUS, wave=32, caps=(256, 1 << 16),
                         device='cpu', out=out)
    assert os.environ['SWIFTORTHO_DEVICE_CAND_CAP'] == '123'
    assert res['device'] == 'cpu' and len(host) == 2
    assert [c['cap'] for c in res['caps']] == [256, 1 << 16]
    assert all(c['parity'] for c in res['caps'])
    assert min(res['caps'][0]['blocks']) > 1          # stage 2 in blocks
    assert res['caps'][1]['blocks'] == [1, 1]
    assert res['host_candidates'] == [len(h.qrow) for h in host]
    assert out.getvalue().count('parity=True') == 2

    # the JAX host engine on the JAX package's corpus and index
    fsa = str(tmp_path / 'c.fsa')
    write_corpus(fsa, make_corpus(**CAND_CORPUS))
    db = SeqDB.from_path(fsa)
    cfg = SearchConfig(expect=1e-5, nc=1 << 24)
    index = build_index(db, 0, len(db), ['aa9'], cfg.seeds, cfg.nc)
    assert len(index.locus) == res['postings']
    pad = 1
    while pad < int(db.lengths.max()):
        pad *= 2
    for wst, got in zip((0, 32), host):
        idx = np.arange(wst, min(wst + 32, len(db)), dtype=np.int64)
        toks, lens = db.padded_batch(idx, pad)
        want = generate_candidates(seg_batch_vec(toks, lens), lens, db,
                                   index, ['aa9'], cfg.seeds)
        assert len(want.qrow) > 0
        for f in FIELDS:
            assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_bench_device_cand_fails_on_fallback():
    """A cap below one query's postings makes the device engine fall back
    to the host: the run fails rather than timing the host twice."""
    with pytest.raises(RuntimeError, match='fell back'):
        port_bdc.bench(**CAND_CORPUS, wave=32, caps=(8,), device='cpu',
                       out=io.StringIO())


# -- example_run.sh --------------------------------------------------------

PORT_SCRIPT = os.path.join(REPO, 'swiftortho_tpu_torch', 'tools',
                           'example_run.sh')


def _commands(path):
    """The script's python commands, continuation lines joined."""
    with open(path) as f:
        text = f.read().replace('\\\n', ' ')
    return [' '.join(ln.split()) for ln in text.splitlines()
            if ln.strip().startswith('python')]


def test_example_run_script_mirrors_jax():
    r = subprocess.run(['bash', '-n', PORT_SCRIPT], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    with open(PORT_SCRIPT) as f:
        text = f.read()
    assert not re.search(r'swiftortho_tpu\.', text)
    code = [ln for ln in text.splitlines()
            if not ln.lstrip().startswith('#')]
    assert not [ln for ln in code if 'SWIFTORTHO_PLATFORM' in ln]
    want = [c.replace('python tools/make_corpus.py',
                      'python3 -m swiftortho_tpu_torch.tools.make_corpus')
            .replace('python -m swiftortho_tpu.', 'python3 -m '
                     'swiftortho_tpu_torch.')
            for c in _commands(os.path.join(REPO, 'tools',
                                            'example_run.sh'))]
    assert _commands(PORT_SCRIPT) == want and len(want) == 7


# -- index_cold ------------------------------------------------------------

def test_index_cold_builds_the_first_chunk(tmp_path, monkeypatch, capsys):
    from swiftortho_tpu.config import SearchConfig
    from swiftortho_tpu.io_fasta import SeqDB
    from swiftortho_tpu.ops.index import build_index
    from swiftortho_tpu_torch.ops import index_device
    from swiftortho_tpu_torch.tools import index_cold
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    log_event = index_device.log_event
    index_cold.main(['--taxa', '3', '--families', '20', '--max-len', '120',
                     '--builds', '2', '--profile',
                     '--workdir', str(tmp_path)])
    assert index_device.log_event is log_event
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res['device'] == 'cpu' and len(res['builds']) == 2
    for b in res['builds']:
        assert sorted(k for k in b if k.endswith('_s')) == \
            ['csr_s', 'decode_s', 'hash_sort_s', 'threshold_s']
    assert res['first_build_top_host_events']
    db = SeqDB.from_path(str(tmp_path / 'c.fsa'))
    cfg = SearchConfig()
    want = build_index(db, 0, min(cfg.effective_chunk(), len(db)),
                       cfg.resolved_alphabets(), cfg.seeds, cfg.nc,
                       cfg.step)
    assert res['postings'] == len(want.locus)
    assert res['T'] == int(db.offsets[len(db)])
