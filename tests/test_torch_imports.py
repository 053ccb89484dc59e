"""The port imports torch, never jax and nothing of the JAX package
(``swiftortho_tpu``), and never picks the CPU on its own:
``SWIFTORTHO_PLATFORM=cuda`` (the default) without a card raises."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import swiftortho_tpu_torch
from swiftortho_tpu_torch import device as port_device

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = pathlib.Path(swiftortho_tpu_torch.__file__).parent

# Runs with jax and the JAX package made unimportable: every port module
# imports (the device
# index, candidate and pair-packing modules, the multi-device ones and the
# tools among them), and the find_hit (default route, all three device routes, then the
# multi-db route), find_orth, find_cluster and run_all CLIs run on a
# 3-record fasta on the CPU.
_NO_JAX = r'''
import contextlib, importlib, io, os, pkgutil, sys
sys.modules['jax'] = None
sys.modules['swiftortho_tpu'] = None
import swiftortho_tpu_torch as pkg
# modules only: the built native library (native/libswnative.so) is skipped
mods = pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')
names = [m.name for m in mods if m.ispkg or os.path.exists(os.path.join(
    m.module_finder.path, m.name.rsplit('.', 1)[1] + '.py'))]
for name in names:
    importlib.import_module(name)
for name in ('ops.index_device', 'search.candidates_device', 'ops.device_pack',
             'parallel', 'parallel.mesh', 'parallel.distributed',
             'search.candidates_multidb', 'tools.make_corpus',
             'tools.run_scale'):
    assert pkg.__name__ + '.' + name in names, name
from swiftortho_tpu_torch.cli import find_cluster, find_hit, find_orth, run_all
fsa, sc = sys.argv[1], sys.argv[2]
routes = dict(SWIFTORTHO_INDEX='device', SWIFTORTHO_CANDIDATES='device',
              SWIFTORTHO_DEVICE_PACK='force')
os.environ.update(routes)
assert find_hit.main(['find_hit', '-p', 'blastp', '-i', fsa, '-d', fsa,
                      '-o', sc + '.dev']) == 0
for k in routes:
    del os.environ[k]
assert find_hit.main(['find_hit', '-p', 'blastp', '-i', fsa, '-d', fsa,
                      '-o', sc]) == 0
assert open(sc).read() == open(sc + '.dev').read()
os.environ['SWIFTORTHO_CANDIDATES'] = 'multidb'
assert find_hit.main(['find_hit', '-p', 'blastp', '-i', fsa, '-d', fsa,
                      '-o', sc + '.mdb']) == 0
del os.environ['SWIFTORTHO_CANDIDATES']
assert open(sc).read() == open(sc + '.mdb').read()
with open(sc + '.opc', 'w') as f, contextlib.redirect_stdout(f):
    assert find_orth.main(['find_orth', '-i', sc]) == 0
with open(sc + '.clsr', 'w') as f, contextlib.redirect_stdout(f):
    assert find_cluster.main(['find_cluster', '-i', sc + '.opc',
                              '-a', 'mcl']) == 0
with contextlib.redirect_stdout(io.StringIO()):
    assert run_all.main(['run_all', '-i', fsa, '-A', 'mcl']) == 0
assert not [m for m in sys.modules
            if m.split('.')[0] in ('jax', 'swiftortho_tpu')
            if sys.modules[m] is not None]
print(len(names))
'''


def test_port_runs_without_jax(tmp_path):
    fsa = tmp_path / 'three.fsa'
    seq = 'MKVLAWDERTYHACDEFGHIKLMNPQRSTVWYMKVLAWDERTYHACDEFGHIKLMNPQRST'
    fsa.write_text('>a|1 x\n%s\n>b|1 y\n%s\n>c|1 z\n%sAAA\n'
                   % (seq, seq[3:], seq))
    out = tmp_path / 'three.sc'
    env = dict(os.environ, SWIFTORTHO_PLATFORM='cpu', PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, '-c', _NO_JAX, str(fsa), str(out)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 20         # every module imported
    rows = out.read_text().splitlines()
    assert len(rows) == 9                          # 3 x 3 hits
    assert all(len(row.split('\t')) == 16 for row in rows)
    assert (tmp_path / 'three.sc.opc').read_text().count('\n') == 3
    assert (tmp_path / 'three.sc.clsr').read_text().split() == [
        'a|1', 'b|1', 'c|1']
    res = tmp_path / 'three.fsa_results'
    for ext in ('sc', 'opc', 'clsr', 'pan'):
        assert (res / ('three.fsa.' + ext)).stat().st_size > 0


def _imported_modules(path):
    """Every module an ``import`` statement in ``path`` names, at module
    level or inside a function; relative imports resolved."""
    rel = path.relative_to(REPO).with_suffix('')
    parts = list(rel.parts)
    if parts[-1] == '__init__':
        parts = parts[:-1]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = parts[:len(parts) - node.level + 1] \
                    if path.name == '__init__.py' else \
                    parts[:len(parts) - node.level]
                yield '.'.join(base + ([node.module] if node.module else []))
            else:
                yield node.module or ''


def test_no_jax_package_import_in_sources():
    """No file of the port and not chip_smoke.py imports swiftortho_tpu."""
    paths = sorted(PKG.rglob('*.py')) + [REPO / 'chip_smoke.py']
    assert len(paths) > 50
    seen = set()
    for path in paths:
        for m in _imported_modules(path):
            seen.add(m.split('.')[0])
            assert m.split('.')[0] != 'swiftortho_tpu', (path, m)
    assert {'swiftortho_tpu_torch', 'torch', 'numpy'} <= seen


def test_no_jax_import_in_sources():
    for path in PKG.rglob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or '']
            else:
                continue
            for m in mods:
                assert m.split('.')[0] != 'jax', (path, m)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cuda')
    with pytest.raises(RuntimeError, match='SWIFTORTHO_PLATFORM=cuda'):
        port_device.get_device()
    monkeypatch.delenv('SWIFTORTHO_PLATFORM')        # default is cuda too
    with pytest.raises(RuntimeError):
        port_device.get_device()


def test_platform_choice(monkeypatch):
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    assert port_device.get_device() == torch.device('cpu')
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'tpu')
    with pytest.raises(ValueError, match='tpu'):
        port_device.get_device()
