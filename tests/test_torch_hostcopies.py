"""The port's own copies of the JAX package's host modules against the
originals: one case per copied module or native entry, each run through
``swiftortho_tpu`` and ``swiftortho_tpu_torch`` on the same seeded numpy
input, results equal.  One more test builds the port's native library
from two processes at once.
"""

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
