"""The port's own copies of the JAX package's host modules against the
originals.

- Behaviour: one case per copied module or native entry, each run through
  ``swiftortho_tpu`` and ``swiftortho_tpu_torch`` on the same seeded
  numpy input, results equal.
- Source: one case per copied file and per copied function.  A copied
  ``.py`` equals its original by ``ast.dump`` once the module docstrings
  are removed; a C++ source is byte-equal; a copied function equals its
  original by the ``ast.dump`` of its node.  ``EXCEPTIONS`` names the few
  definitions allowed to differ and what each difference is.
- Builds: the port's native library, and its CUDA kernel library (with a
  stand-in ``nvcc``), each built from two processes at once.
"""

import ast
import importlib
import io
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

JAX, PORT = 'swiftortho_tpu', 'swiftortho_tpu_torch'
REPO = pathlib.Path(__file__).resolve().parent.parent


def mod(pkg, name):
    return importlib.import_module('%s.%s' % (pkg, name))


def records(seed, n_taxa=3, n_genes=12, lo=40, hi=160):
    rng = np.random.default_rng(seed)
    aa = np.array(list('ACDEFGHIKLMNPQRSTVWY'))
    return [('tax%d|g%03d fam%d' % (t, g, g % 5),
             ''.join(aa[rng.integers(0, 20, int(rng.integers(lo, hi)))]))
            for t in range(n_taxa) for g in range(n_genes)]


def sc_text(seed, n_taxa=4, n_genes=15):
    """An m8 table grouped by query, self-hit first, bit score
    descending: 16 tab-separated columns as find_hit writes them.  Genes
    g of one family (g // 3) hit each other in every taxon, so the
    table holds orthologs, co-orthologs and in-paralogs."""
    rng = np.random.default_rng(seed)
    ids = ['tax%d|g%03d' % (t, g) for t in range(n_taxa)
           for g in range(n_genes)]
    glen = rng.integers(80, 300, len(ids))
    rows = []
    for qi, q in enumerate(ids):
        fam = [si for si in range(len(ids))
               if (si % n_genes) // 3 == (qi % n_genes) // 3 and si != qi]
        weak = list(rng.choice(len(ids), 2, replace=False))
        hits = [(qi, 900.0)] + [(si, float(400 - 5 * abs(si % n_genes
                                                        - qi % n_genes)
                                           + rng.integers(0, 40)))
                                for si in fam]
        hits += [(si, float(rng.uniform(30, 60))) for si in weak
                 if si != qi and si not in fam]
        hits.sort(key=lambda h: -h[1])
        qlen = int(glen[qi])
        for si, bit in hits:
            slen = int(glen[si])
            aln = int(rng.integers(min(qlen, slen) * 3 // 4,
                                   min(qlen, slen) + 1))
            qst = int(rng.integers(1, qlen - aln + 2))
            sst = int(rng.integers(1, slen - aln + 2))
            rows.append('%s\t%s\t%.2f\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%s\t%.1f'
                        '\t%d\t%d\t%d\t%s\n'
                        % (q, ids[si], rng.uniform(20, 100), aln,
                           rng.integers(0, aln // 3), rng.integers(0, 5),
                           qst, qst + aln - 1, sst, sst + aln - 1,
                           '%.2e' % rng.uniform(1e-80, 1e-6), bit, qlen,
                           slen, si, ids[si]))
    return ''.join(rows)


def case_sw_align_batch_native(pkg):
    rng = np.random.default_rng(1)
    B, L = 40, 96
    aa = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWYxX*', np.uint8)
    t0 = aa[rng.integers(0, len(aa), (B, L))]
    t1 = t0.copy()
    sub = rng.random((B, L)) < 0.3
    t1[sub] = aa[rng.integers(0, 20, int(sub.sum()))]
    l0 = rng.integers(0, L + 1, B).astype(np.int32)
    l1 = rng.integers(0, L + 1, B).astype(np.int32)
    return mod(pkg, 'native').sw_align_batch_native(t0, t1, l0, l1)


def case_gather_rows(pkg):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 255, 5000, dtype=np.uint8)
    n = 30
    counts = rng.integers(0, 64, n)
    starts = rng.integers(0, len(src) - 64, n)
    row_idx = rng.permutation(n)
    dst = np.full((n, 64), 7, np.uint8)
    mod(pkg, 'native').gather_rows(src, starts, counts, row_idx, dst)
    return dst


def case_seg_batch_native(pkg):
    rng = np.random.default_rng(3)
    B, L = 12, 200
    aa = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWYacde', np.uint8)
    toks = aa[rng.integers(0, len(aa), (B, L))]
    toks[:, 40:80] = ord('A')                       # low-complexity runs
    toks[3, 100:130] = np.frombuffer(b'QP' * 15, np.uint8)
    lens = rng.integers(20, L + 1, B)
    c = mod(pkg, 'constants')
    return mod(pkg, 'native').seg_batch_native(toks, lens, c.SEG_WINDOW,
                                               c.SEG_MIN_ENT)


def case_format_rows_native(pkg):
    rng = np.random.default_rng(4)
    nat = mod(pkg, 'native')
    n, nq, ns = 50, 7, 11
    fields = {'idy': rng.uniform(10, 100, n), 'e': rng.uniform(1e-90, 1, n)}
    for k in ('aln', 'mis', 'gap', 'qst1', 'qed', 'sst1', 'sed', 'bit',
              'qlen', 'slen', 'qidx'):
        fields[k] = rng.integers(0, 3000, n)
    qb, qo = nat.encode_blob(['tax%d|q%d' % (i % 3, i) for i in range(nq)])
    rb, ro = nat.encode_blob(['tax%d|s%d' % (i % 4, i) for i in range(ns)])
    db, do = nat.encode_blob(['desc %d x' % i for i in range(ns)])
    return nat.format_rows_native(fields, rng.integers(0, nq, n), qb, qo,
                                  rng.integers(0, ns, n), rb, ro, db, do)


def case_m8parse_block_native(pkg):
    return mod(pkg, 'native').m8parse_block_native(sc_text(5).encode())


def _index(pkg, seed=6):
    db = mod(pkg, 'io_fasta').SeqDB.from_records(records(seed))
    cfg = mod(pkg, 'config').SearchConfig()
    alphabets = cfg.resolved_alphabets()
    ix = mod(pkg, 'ops.index').build_index(db, 0, len(db), alphabets,
                                           cfg.seeds, 1 << 18, cfg.step)
    return db, cfg, alphabets, ix


def case_build_index(pkg):
    _, _, _, ix = _index(pkg)
    return (ix.start, ix.locus, ix.soas, ix.sid, ix.sst, ix.threshold,
            ix.mink, ix.nc)


def case_generate_candidates(pkg):
    db, cfg, alphabets, ix = _index(pkg)
    idx = np.arange(0, len(db), 2, dtype=np.int64)
    toks, lens = db.padded_batch(idx, 256)
    c = mod(pkg, 'constants')
    toks = mod(pkg, 'native').seg_batch_native(toks, lens, c.SEG_WINDOW,
                                               c.SEG_MIN_ENT)
    cand = mod(pkg, 'search.candidates').generate_candidates(
        toks, lens, db, ix, alphabets, cfg.seeds)
    assert len(cand.subject) > 0
    return [getattr(cand, f) for f in ('qrow', 'subject', 'score', 'band_q',
                                       'band_s')]


def case_find_orth_blocks(pkg, native='1'):
    os.environ['SWIFTORTHO_NATIVE_ORTH'] = native
    try:
        cfg = mod(pkg, 'config').OrthConfig()
        return ''.join(mod(pkg, 'orth.inference').find_orth_blocks(
            io.StringIO(sc_text(7)), cfg))
    finally:
        del os.environ['SWIFTORTHO_NATIVE_ORTH']


def case_pan_report(pkg):
    recs = records(8, n_taxa=5, n_genes=10)
    db = mod(pkg, 'io_fasta').SeqDB.from_records(recs)
    rng = np.random.default_rng(8)
    names = [r[0].split()[0] for r in recs]
    groups = {}
    for nm in names:
        if rng.random() < 0.85:
            groups.setdefault(int(nm[-1]) % 4 + 4 * (rng.random() < 0.3),
                              []).append(nm)
    clsr = ['\t'.join(g) + '\n' for _, g in sorted(groups.items())]
    out = io.StringIO()
    mod(pkg, 'analysis.pan_genome').pan_report(db, clsr, out)
    return out.getvalue()


def case_parse_args(pkg):
    pa = mod(pkg, 'cli._args').parse_args
    d = {'-i': '', '-e': '1e-3', '-v': '100', '-s': '1111111'}
    return [pa(argv, d) for argv in (
        ['x', '-i', 'a.fsa', '-e1e-5', '-v', '20'],
        ['x', '-s11011', '-i'],
        ['x', 'junk', '-q', '1', '-vv'],
        ['x'])]


def case_device_pack_routing(pkg):
    """The routing of the JAX DevicePackContext and of the port's: a
    quarter-size table, then the hot-set pick, then the table rows."""
    db = mod(pkg, 'io_fasta').SeqDB.from_records(
        records(9, n_genes=20, lo=30, hi=300))
    dp = mod(pkg, 'ops.device_pack')
    old = os.environ.get('SWIFTORTHO_PACK_CAP')
    os.environ['SWIFTORTHO_PACK_CAP'] = str(len(db) // 4 * 384)
    try:
        if pkg == PORT:
            import torch
            ctx = dp.DevicePackContext(db, torch.device('cpu'))
        else:
            ctx = dp.DevicePackContext(db)
    finally:
        if old is None:
            del os.environ['SWIFTORTHO_PACK_CAP']
        else:
            os.environ['SWIFTORTHO_PACK_CAP'] = old
    before = [ctx.n_db, ctx.stride, ctx.selected, ctx.ok, ctx.sel.copy(),
              ctx.row_of.copy(), ctx.fits.copy()]
    rng = np.random.default_rng(9)
    picked = ctx.maybe_select(rng.zipf(1.5, 300) % len(db))
    return before + [picked, ctx.sel, ctx.row_of, ctx.fits, ctx.selected,
                     np.asarray(ctx._table())]


CASES = {k[5:]: v for k, v in sorted(globals().items())
         if k.startswith('case_')}


def assert_same(a, b, where='result'):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], '%s[%r]' % (where, k))
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, '%s[%d]' % (where, i))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize('case', sorted(CASES) + ['find_orth_blocks_pure'])
def test_copy_matches_jax_package(case):
    if case == 'find_orth_blocks_pure':
        def fn(pkg):
            return case_find_orth_blocks(pkg, native='0')
    else:
        fn = CASES[case]
    want = fn(JAX)
    got = fn(PORT)
    assert_same(got, want)
    if case == 'find_orth_blocks':
        assert want.count('\n') > 20


def test_native_build_from_two_processes(tmp_path):
    """Two processes build the port's native library at once, from a
    fresh copy of its sources: both load a valid library (the build
    publishes with os.replace under a file lock) and compute the same
    alignments as the JAX package's library."""
    pkg = tmp_path / 'portcopy'
    shutil.copytree(REPO / PORT / 'native', pkg / 'native',
                    ignore=shutil.ignore_patterns('*.so', '*.so.*',
                                                  '__pycache__'))
    for f in ('__init__.py', 'constants.py', 'utils.py'):
        shutil.copy(REPO / PORT / f, pkg / f)
    child = r'''
import sys, numpy as np
from portcopy import native
native.load()
rng = np.random.default_rng(0)
aa = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
t = aa[rng.integers(0, 20, (8, 50))]
l = np.full(8, 50, np.int32)
r = native.sw_align_batch_native(t, t[::-1].copy(), l, l)
print(' '.join(str(int(v)) for k in sorted(r) for v in r[k]))
'''
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, '-c', child], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    rng = np.random.default_rng(0)
    t = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)[
        rng.integers(0, 20, (8, 50))]
    lens = np.full(8, 50, np.int32)
    ref = mod(JAX, 'native').sw_align_batch_native(t, t[::-1].copy(), lens,
                                                   lens)
    want = ' '.join(str(int(v)) for k in sorted(ref) for v in ref[k])
    assert [o.strip() for o, _ in outs] == [want, want]
    left = sorted(p.name for p in (pkg / 'native').iterdir())
    assert 'libswnative.so' in left and 'libswnative.so.hash' in left
    assert not [n for n in left if n.endswith(('.tmp', '.tmp.hash'))]


# -- source --------------------------------------------------------------

# Files copied whole: equal to the original up to the module docstring.
COPIED_FILES = [
    'constants.py', 'config.py', 'io_fasta.py', 'corpus.py', 'utils.py',
    'native/__init__.py', 'ops/__init__.py', 'ops/seeds.py', 'ops/index.py',
    'ops/stats.py', 'search/__init__.py', 'search/candidates.py',
    'cli/__init__.py', 'cli/_args.py', 'cli/scripts.py',
    'cluster/__init__.py', 'cluster/fsfdp.py', 'cluster/checkpoint.py',
    'orth/__init__.py', 'orth/fast.py', 'orth/inference.py',
    'orth/outofcore.py', 'parallel/__init__.py', 'analysis/__init__.py',
    'cluster/driver.py',
] + ['analysis/%s.py' % m for m in (
    'exttools', 'goterm', 'misc', 'msa', 'operon', 'orth2phy',
    'pan_genome', 'phylo', 'rbh')]

# Top-level names whose definitions (or imports) may differ, and why.
EXCEPTIONS = {
    'utils.py': ({'stage'},
                 'stage() opens a torch.profiler trace in place of the '
                 'JAX one'),
    'native/__init__.py': ({'fcntl', '_build', '_build_locked', 'load'},
                           'the g++ build runs under a file lock and is '
                           'published with os.replace'),
    'cli/_args.py': ({'apply_platform_env'},
                     'no JAX platform or compile-cache set-up; joins a '
                     'fleet under SWIFTORTHO_COORD'),
    'cluster/driver.py': ({'torch', 'find_cluster_stream',
                           'find_cluster_file'},
                          'a device argument handed to the engines'),
}

# Functions copied into modules that are otherwise the port's own.
COPIED_FUNCTIONS = [
    ('ops/banded_sw.py', 'postprocess_batch'),
    ('cluster/mcl_blocksparse.py', '_pair_lists'),
    ('cluster/apc.py', 'apc_cluster_faithful'),
    ('cluster/apc.py', '_apclust_ref_py'),
    ('cluster/components.py', 'cnc_labels'),
    ('cluster/components.py', 'union_find'),
    ('cluster/components.py', 'connected_components'),
    ('parallel/distributed.py', 'rank_query_range'),
    ('parallel/distributed.py', 'resolve_query_range'),
    ('ops/device_pack.py', 'DevicePackContext.maybe_select'),
]

# The routing of DevicePackContext: the statements of __init__ that set
# the routing attributes, and the table-row build of _table (the device
# each copy lives on is the port's own).
PACK_ROUTING = {'stride', 'n_db', '_lens_ok', 'sel', 'row_of', 'fits',
                'selected', 'ok', 'n_total'}


def _tree(pkg, rel):
    tree = ast.parse((REPO / pkg / rel).read_text())
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        tree.body = body[1:]
    return tree


def _defines(node):
    """The top-level names a statement defines or imports."""
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return {node.name}
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return {(a.asname or a.name).split('.')[0] for a in node.names}
    return set()


def _without(tree, names):
    return ast.dump(ast.Module(
        body=[n for n in tree.body if not _defines(n) & names],
        type_ignores=[]))


@pytest.mark.parametrize('rel', COPIED_FILES)
def test_copied_file_source_matches(rel):
    want, got = _tree(JAX, rel), _tree(PORT, rel)
    if rel not in EXCEPTIONS:
        assert ast.dump(got) == ast.dump(want), rel
        return
    names, why = EXCEPTIONS[rel]
    assert ast.dump(got) != ast.dump(want), (rel, 'exception not needed')
    assert _without(got, names) == _without(want, names), (rel, why)
    assert names <= set().union(*map(_defines, got.body)), rel


@pytest.mark.parametrize('name', sorted(
    p.name for p in (REPO / JAX / 'native').glob('*.cpp')))
def test_copied_cpp_source_matches(name):
    want = (REPO / JAX / 'native' / name).read_bytes()
    assert (REPO / PORT / 'native' / name).read_bytes() == want


def _node(pkg, rel, qualname):
    body = ast.parse((REPO / pkg / rel).read_text()).body
    node = None
    for part in qualname.split('.'):
        node = next(n for n in body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and n.name == part)
        body = node.body
    return node


@pytest.mark.parametrize('rel,name', COPIED_FUNCTIONS,
                         ids=[n for _, n in COPIED_FUNCTIONS])
def test_copied_function_source_matches(rel, name):
    assert (ast.dump(_node(PORT, rel, name))
            == ast.dump(_node(JAX, rel, name))), (rel, name)


def _pack_routing(pkg):
    init = _node(pkg, 'ops/device_pack.py', 'DevicePackContext.__init__')
    kept = []
    for st in init.body:
        tgts = st.targets if isinstance(st, ast.Assign) else \
            [getattr(st, 'target', None)]
        attrs = {t.attr for t in tgts if isinstance(t, ast.Attribute)}
        if not attrs or attrs & PACK_ROUTING:
            kept.append(ast.dump(st))
    table = _node(pkg, 'ops/device_pack.py', 'DevicePackContext._table')
    build = next(st for st in table.body if isinstance(st, ast.If))
    rows = [ast.dump(st) for st in build.body
            if '_put' not in ast.dump(st) and '_tab_dev' not in ast.dump(st)]
    return kept, rows


def test_device_pack_routing_source_matches():
    kept, rows = _pack_routing(PORT)
    assert (kept, rows) == _pack_routing(JAX)
    assert len(kept) >= 12 and len(rows) >= 4


# -- builds --------------------------------------------------------------

_FAKE_NVCC = r'''#!%(python)s
import os, subprocess, sys, time
args = sys.argv[1:]
out = args[args.index('-o') + 1]
stub = out + '.stub.cpp'
with open(stub, 'w') as f:
    f.write('extern "C" {\n'
            'int swt_banded_sw(void) { return 0; }\n'
            'int swt_xdrop_walk(void) { return 0; }\n'
            'int swt_accept_rounds(void) { return 0; }\n'
            'int swt_lanes_for(int a, int b) { return 4; }\n'
            'const char *swt_cuda_error_string(int e) { return "ok"; }\n'
            '}\n')
subprocess.run(['g++', '-shared', '-fPIC', '-o', out, stub], check=True)
os.remove(stub)
# ptxas reports while compiling (-c), not while linking
for k in range(%(lines)d if '-c' in args else 0):
    # a long report, written slowly: a reader racing the writer would
    # see it cut short
    sys.stderr.write("ptxas info    : Used %%d registers, spill %%d\n"
                     %% (k, k))
    sys.stderr.flush()
    time.sleep(0.002)
'''


def test_kernel_build_from_two_processes(tmp_path):
    """Two processes build the port's CUDA kernel library at first use,
    with a stand-in nvcc on CUDA_HOME that writes a loadable library and
    a long ptxas report for each source it compiles: both load the
    library and read the whole report, neither opens the published
    report for writing, and no temporary file is left."""
    lines = 300
    cuda = tmp_path / 'cuda' / 'bin'
    cuda.mkdir(parents=True)
    nvcc = cuda / 'nvcc'
    nvcc.write_text(_FAKE_NVCC % {'python': sys.executable, 'lines': lines})
    nvcc.chmod(0o755)
    pkg = tmp_path / 'portcopy'
    shutil.copytree(REPO / PORT / 'csrc', pkg / 'csrc')
    shutil.copy(REPO / PORT / '_build.py', pkg / '_build.py')
    (pkg / '__init__.py').write_text('')
    child = r'''
import builtins
from portcopy import _build
writes, _open = [], builtins.open
def spy(file, mode='r', *a, **k):
    if 'w' in mode or 'a' in mode:
        writes.append(str(file))
    return _open(file, mode, *a, **k)
builtins.open = spy
_build.load_kernels()
builtins.open = _open
info = _build.build_info()
print(info['built'], info['path'] + '.ptxas.txt' in writes,
      len(info['ptxas']))
'''
    env = dict(os.environ, PYTHONPATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / 'cuda'))
    procs = [subprocess.Popen([sys.executable, '-c', child], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    # each read the whole report, and none wrote the published report in
    # place (it is written to a file of its own and renamed)
    sources = len(list((pkg / 'csrc').glob('*.cu')))
    assert [o.split()[1:] for o, _ in outs] == [
        ['False', str(lines * sources)]] * 2
    left = sorted(p.name for p in (pkg / 'build').iterdir())
    assert [n for n in left if n.endswith('.so')]
    assert [n for n in left if n.endswith('.ptxas.txt')]
    assert not [n for n in left if '.tmp' in n], left
