"""The long-pair path of the port's search (pairs with a side >= 4096,
aligned in 4096-wide diagonal tiles, ``search/blastp.py::
_align_long_tiles``) against the JAX package's, and the port's find_hit
CLI against the JAX CLI on a corpus with long proteins.

The three-record setup is the one of ``tests/test_edge_cases.py``
(9,000 / 5,100 / 4,200 residues): one batch of tiles, including empty
subject tiles past the subject's end.  Tolerance is 0: every field is an
integer or a float made from integers the same way.  The JAX package is
imported inside the tests that use it, so the card test also collects
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch.io_fasta import SeqDB
from swiftortho_tpu_torch.ops import banded_sw_cuda
from swiftortho_tpu_torch.search import blastp as port

CPU = torch.device('cpu')
AA = 'ACDEFGHIKLMNPQRSTVWY'
TILE_FIELDS = ('idy', 'aln', 'mis', 'gap', 'qst', 'qed', 'sst', 'sed', 'bit')


def three_records():
    rng = np.random.default_rng(42)

    def mk(n):
        return ''.join(AA[i] for i in rng.integers(0, 20, n))
    base = mk(9000)
    return [('t|a', base),                       # 3 tiles against itself
            ('t|b', base[:5000] + mk(100)),      # a shorter homolog
            ('t|c', mk(4200))]                   # the subject runs out


def tile_args(db):
    toks, lens = db.padded_batch(np.arange(3), 16384)
    zeros = np.zeros(3, dtype=np.int64)
    return (toks, lens, db, np.arange(3), zeros,
            np.arange(3, dtype=np.int64), zeros, zeros, (4096,))


def as_tuples(rows_of):
    return {p: [tuple(r[k] for k in TILE_FIELDS) for r in rows]
            for p, rows in rows_of.items()}


@pytest.fixture(scope='module')
def port_tiles():
    db = SeqDB.from_records(three_records())
    return as_tuples(port._align_long_tiles(*tile_args(db), CPU))


def test_tiles_match_jax(port_tiles):
    from swiftortho_tpu.io_fasta import SeqDB as JaxDB
    from swiftortho_tpu.search.blastp import _align_long_tiles
    jdb = JaxDB.from_records(three_records())
    want = as_tuples(_align_long_tiles(*tile_args(jdb)))
    assert port_tiles == want
    # 3 + 2 + 2 tiles; the third pair's second tile has an empty subject
    assert [len(want[p]) for p in range(3)] == [3, 3, 3]
    assert want[2][2][1] == 0


def test_tiles_match_oracle(port_tiles):
    """Each tile against the sequential oracle loop (the reference's
    kswat_st_long)."""
    from swiftortho_tpu.ops.banded_sw import kswat_oracle
    recs = three_records()
    sqi = recs[0][1]
    for p in range(3):
        sqj = recs[p][1]
        want = []
        for i in range(0, len(sqi), 4096):
            o = kswat_oracle(sqi[i:i + 4096], sqj[i:i + 4096])
            want.append((o.idy, o.aln, o.mis, o.gap, o.qst + i, o.qed + i,
                         o.sst + i, o.sed + i, o.bit))
        assert port_tiles[p] == want, p


@pytest.fixture(scope='module')
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_tiles_match_cpu(cuda_device, port_tiles):
    """The same tiles through the CUDA kernel: one full-statistics launch
    at width 4096."""
    db = SeqDB.from_records(three_records())
    banded_sw_cuda.reset_counters()
    got = as_tuples(port._align_long_tiles(*tile_args(db), cuda_device))
    assert got == port_tiles
    assert banded_sw_cuda.launches['full'] == 1
    assert list(banded_sw_cuda.shapes['full']) == ['4096x4096']


@pytest.fixture(scope='module')
def long_corpus(tmp_path_factory):
    """Two taxa of three families, lengths 3,000-6,000: proteins past
    4,096 residues, and their homologs."""
    from swiftortho_tpu_torch.corpus import make_corpus, write_corpus
    fsa = str(tmp_path_factory.mktemp('long') / 'c.fsa')
    corpus = make_corpus(n_taxa=2, n_families=3, seed=5, min_len=3000,
                         max_len=6000)
    assert max(len(s) for _, s in corpus.records) > 4096
    write_corpus(fsa, corpus)
    return fsa


def test_cli_matches_jax_cli(long_corpus, tmp_path, monkeypatch, capfd):
    import json

    from swiftortho_tpu.cli import find_hit as jax_cli
    from swiftortho_tpu_torch.cli import find_hit as port_cli
    monkeypatch.setenv('SWIFTORTHO_PLATFORM', 'cpu')
    monkeypatch.setenv('SWIFTORTHO_JAX_CACHE', '0')
    argv = ['find_hit', '-p', 'blastp', '-i', long_corpus, '-d',
            long_corpus, '-o']
    want, got = str(tmp_path / 'j.sc'), str(tmp_path / 'p.sc')
    assert jax_cli.main(argv + [want]) == 0
    capfd.readouterr()
    assert port_cli.main(argv + [got]) == 0
    waves = [json.loads(ln.split(' ', 1)[1])
             for ln in capfd.readouterr().err.splitlines()
             if ln.startswith('[swiftortho] {"ts"')]
    waves = [w for w in waves if w['stage'] == 'search_wave']
    assert sum(w['long_pairs'] for w in waves) > 0
    assert sum(w['long_tiles'] for w in waves) > sum(w['long_pairs']
                                                      for w in waves)
    with open(want) as a, open(got) as b:
        rows = a.read()
        assert b.read() == rows
    # rows with a coordinate past the first 4096-residue tile
    assert any(max(int(f) for f in ln.split('\t')[6:10]) > 4096
               for ln in rows.splitlines())
