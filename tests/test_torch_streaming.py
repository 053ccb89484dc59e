"""The port's streamed, out-of-core search (``search/blastp.py``: the
prefetching ``IndexSource``, strict streaming, the block-scheduled
phase A with its index cache, the ``CandidateSpill``, ``makedb`` /
``from_disk`` and the reference's ``.idx/.soas/.bin`` layout) against the
JAX package's ``blastp_stream`` on the ``tests/test_streaming.py`` corpus
and config (``chunk=24``: five reference chunks).

Every mode must write the JAX package's rows for the same config, with
the residency bound it promises.  The port runs on the CPU (the plain
PyTorch SW).  The JAX package is imported inside the fixtures and tests
that use it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from swiftortho_tpu_torch.config import SearchConfig
from swiftortho_tpu_torch.corpus import make_corpus, write_corpus
from swiftortho_tpu_torch.io_fasta import SeqDB
from swiftortho_tpu_torch.search.blastp import (CandidateSpill, IndexSource,
                                                blastp_stream, make_db)

CPU = torch.device('cpu')
CFG = dict(expect=1e-5, nc=262144, chunk=24, query_batch=64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def fsa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('torch_stream') / 'c.fsa')
    write_corpus(path, make_corpus(n_taxa=3, n_families=40, seed=11,
                                   min_len=60, max_len=150))
    return path


@pytest.fixture(scope='module')
def corpus(fsa):
    return SeqDB.from_path(fsa)


def jax_stream(fsa, cfg=None, **kw):
    from swiftortho_tpu.config import SearchConfig as JaxConfig
    from swiftortho_tpu.io_fasta import SeqDB as JaxDB
    from swiftortho_tpu.search.blastp import blastp_stream as jax_blastp
    db = JaxDB.from_path(fsa)
    return list(jax_blastp(db, db, JaxConfig(**(cfg or CFG)), **kw))


@pytest.fixture(scope='module')
def want(fsa):
    rows = jax_stream(fsa)
    assert len(rows) > 100
    return rows


def search(corpus, cfg=None, **kw):
    return list(blastp_stream(corpus, corpus, SearchConfig(**(cfg or CFG)),
                              device=CPU, **kw))


def n_chunks(corpus):
    return -(-len(corpus) // SearchConfig(**CFG).effective_chunk())


class TestStreamedIndex:
    def test_resident(self, corpus, want):
        assert n_chunks(corpus) >= 4, 'needs a multi-chunk setup'
        indexes = make_db(corpus, SearchConfig(**CFG))
        assert len(indexes) == n_chunks(corpus)
        assert search(corpus, indexes=indexes) == want

    def test_prefetch(self, corpus, want):
        src = IndexSource.from_build(corpus, SearchConfig(**CFG))
        assert search(corpus, indexes=src) == want
        assert len(src) == n_chunks(corpus)
        assert src.max_resident <= 2, src.max_resident

    def test_strict_streaming(self, corpus, want, monkeypatch):
        monkeypatch.setenv('SWIFTORTHO_PREFETCH_INDEX', '0')
        src = IndexSource.from_build(corpus, SearchConfig(**CFG))
        assert search(corpus, indexes=src) == want
        assert src.max_resident == 1, src.max_resident

    def test_spill(self, corpus, want, tmp_path, monkeypatch):
        """-T: candidates and masked wave tokens on disk, strict
        streaming, nothing left behind."""
        monkeypatch.setenv('SWIFTORTHO_PREFETCH_INDEX', '0')
        sd = str(tmp_path / 'spill')
        src = IndexSource.from_build(corpus, SearchConfig(**CFG))
        assert search(corpus, indexes=src, spill_dir=sd) == want
        assert src.max_resident == 1
        assert os.listdir(sd) == [], 'spill files must be cleaned up'

    @pytest.mark.parametrize('writer', ['port', 'jax'])
    def test_disk_index(self, corpus, fsa, want, writer, tmp_path):
        """makedb then from_disk; the port also reads the JAX package's
        makedb files."""
        prefix = str(tmp_path / 'db')
        if writer == 'port':
            make_db(corpus, SearchConfig(**CFG), out_prefix=prefix)
        else:
            from swiftortho_tpu.config import SearchConfig as JaxConfig
            from swiftortho_tpu.io_fasta import SeqDB as JaxDB
            from swiftortho_tpu.search.blastp import make_db as jax_make_db
            jax_make_db(JaxDB.from_path(fsa), JaxConfig(**CFG),
                        out_prefix=prefix)
        src = IndexSource.from_disk(prefix)
        assert len(src) == n_chunks(corpus)
        assert search(corpus, indexes=src) == want
        assert src.max_resident <= 2

    @pytest.mark.parametrize('writer', ['port', 'jax'])
    def test_ref_layout_disk_index(self, corpus, fsa, want, writer,
                                   tmp_path):
        """-D on the reference's chunked .idx/.soas/.bin layout, written
        by the port's save_index_ref or by the JAX package's."""
        prefix = str(tmp_path / 'refdb')
        if writer == 'port':
            from swiftortho_tpu_torch.ops.index import save_index_ref
            cfg = SearchConfig(**CFG)
            indexes = IndexSource.from_build(corpus, cfg)
        else:
            from swiftortho_tpu.config import SearchConfig as JaxConfig
            from swiftortho_tpu.io_fasta import SeqDB as JaxDB
            from swiftortho_tpu.ops.index import save_index_ref
            from swiftortho_tpu.search.blastp import \
                IndexSource as JaxSource
            cfg = JaxConfig(**CFG)
            indexes = JaxSource.from_build(JaxDB.from_path(fsa), cfg)
        for ci, ix in enumerate(indexes):
            save_index_ref('%s.%d' % (prefix, ci), ix, space=cfg.seeds,
                           nr=cfg.alphabet)
        src = IndexSource.from_disk(prefix)
        assert len(src) == n_chunks(corpus)
        assert search(corpus, indexes=src) == want
        assert src.max_resident <= 2


class TestOverlap:
    def test_overlap_off(self, corpus, want, monkeypatch):
        monkeypatch.setenv('SWIFTORTHO_OVERLAP', '0')
        assert search(corpus) == want

    def test_wave_pipeline(self, corpus, want, monkeypatch):
        monkeypatch.setenv('SWIFTORTHO_WAVE_PIPELINE', '3')
        assert search(corpus) == want

    def test_phase_a_error_propagates(self, corpus):
        class Boom(RuntimeError):
            pass

        def bad(ci):
            raise Boom('index build failed')

        with pytest.raises(Boom):
            search(corpus, indexes=IndexSource(3, bad))


class TestCandidateSpill:
    def test_disk_roundtrip(self, tmp_path):
        from swiftortho_tpu_torch.search.candidates import Candidates
        sp = CandidateSpill(str(tmp_path / 's'))
        c = Candidates(qrow=np.array([1, 2]), subject=np.array([3, 4]),
                       score=np.array([9, 8]), band_q=np.array([0, 1]),
                       band_s=np.array([2, 3]))
        sp.append(0, c)
        sp.append(0, c)
        out = sp.take(0)
        assert len(out) == 2
        np.testing.assert_array_equal(out[1].subject, c.subject)
        assert sp.take(0) == []
        assert sp.take(5) == []
        assert os.listdir(str(tmp_path / 's')) == []


class TestBlockScheduledPhaseA:
    @pytest.mark.parametrize('mode', ['prefetch', 'strict', 'spill'])
    def test_blocks(self, corpus, want, mode, tmp_path, monkeypatch,
                    capfd):
        """Waves in blocks of one (every chunk swept per block, indexes
        disk-cached after block 0): the JAX rows, the residency bound,
        no cache or spill file left."""
        monkeypatch.setenv('SWIFTORTHO_WAVE_BLOCK', '1')
        if mode != 'prefetch':
            monkeypatch.setenv('SWIFTORTHO_PREFETCH_INDEX', '0')
        sd = str(tmp_path / 'spill') if mode == 'spill' else None
        src = IndexSource.from_build(corpus, SearchConfig(**CFG))
        capfd.readouterr()
        assert search(corpus, indexes=src, spill_dir=sd) == want
        if mode == 'prefetch':
            assert src.max_resident <= 2    # swept + prefetched
        else:
            assert src.max_resident == 1
        pa = [json.loads(ln.split(' ', 1)[1])
              for ln in capfd.readouterr().err.splitlines()
              if '"search_phaseA"' in ln]
        assert pa[0]['blocks'] == pa[0]['waves'] > 1
        assert pa[0]['max_resident_indexes'] == src.max_resident
        if sd is not None:
            assert os.listdir(sd) == [], 'cache/spill files must be cleaned'


class TestDeviceRoutesStreamed:
    def test_device_routes_strict_blocks(self, corpus, want, monkeypatch):
        """The device index, the device candidate engine and device pair
        packing on the CPU, across five chunks, strict streaming in
        blocks of one wave."""
        for k, v in (('SWIFTORTHO_INDEX', 'device'),
                     ('SWIFTORTHO_CANDIDATES', 'device'),
                     ('SWIFTORTHO_DEVICE_PACK', 'force'),
                     ('SWIFTORTHO_PREFETCH_INDEX', '0'),
                     ('SWIFTORTHO_WAVE_BLOCK', '1')):
            monkeypatch.setenv(k, v)
        src = IndexSource.from_build(corpus, SearchConfig(**CFG), device=CPU)
        assert search(corpus, indexes=src) == want
        assert src.max_resident == 1


class TestStageLadderInvariance:
    @pytest.mark.parametrize('stages', ['4', '2,8', '1'])
    def test_rung_sizes(self, corpus, want, stages, monkeypatch):
        monkeypatch.setenv('SWIFTORTHO_ALIGN_STAGES', stages)
        assert search(corpus) == want

    def test_escalation_counts_logged(self, tmp_path, monkeypatch, capfd):
        """Deep families force rung escalations; the port logs them and
        writes the JAX rows."""
        path = str(tmp_path / 'deep.fsa')
        write_corpus(path, make_corpus(n_taxa=24, n_families=4, seed=3,
                                       min_len=60, max_len=120))
        cfg = dict(expect=1e-5, nc=262144, chunk=24, query_batch=64, v=6,
                   max_miss=0.6)
        monkeypatch.setenv('SWIFTORTHO_ALIGN_STAGES', '1')
        want = jax_stream(path, cfg)
        capfd.readouterr()
        assert search(SeqDB.from_path(path), cfg) == want
        waves = [json.loads(ln.split(' ', 1)[1])
                 for ln in capfd.readouterr().err.splitlines()
                 if ln.startswith('[swiftortho] {')]
        waves = [w for w in waves if w.get('stage') == 'search_wave']
        assert waves
        assert sum(w['esc_queries'] for w in waves) > 0


RSS_SCRIPT = r'''
import resource, sys
import torch
from swiftortho_tpu_torch.config import SearchConfig
from swiftortho_tpu_torch.io_fasta import SeqDB
from swiftortho_tpu_torch.search.blastp import (IndexSource, blastp_stream,
                                                make_db)

mode, fsa, spill = sys.argv[1], sys.argv[2], sys.argv[3]
cpu = torch.device('cpu')
db = SeqDB.from_path(fsa)
cfg = SearchConfig(expect=1e-5, nc=262144, chunk=640, query_batch=16)

# warm-up: a tiny search, so allocator pools are in the high-water mark
# before the measurement
warm = SeqDB(tokens=db.tokens[:db.offsets[40]].copy(),
             offsets=db.offsets[:41].copy(), headers=db.headers[:40])
list(blastp_stream(warm, warm, cfg, device=cpu))
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

total_bytes = 0
if mode == 'resident':
    ixs = make_db(db, cfg)
    total_bytes = sum(ix.locus.nbytes + ix.sid.nbytes + ix.sst.nbytes
                      + ix.start.nbytes for ix in ixs)
else:
    ixs = IndexSource.from_build(db, cfg)
rows = sum(1 for _ in blastp_stream(db, db, cfg, indexes=ixs, q_start=0,
                                    q_end=16, device=cpu,
                                    spill_dir=(spill if mode == 'stream'
                                               else None)))
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print('RESULT %d %d %d %d' % (rows, base, peak, total_bytes))
'''


class TestBoundedRss:
    def test_streamed_rss_below_index(self, tmp_path):
        """Two subprocesses over a reference whose index is much larger
        than one chunk: the streamed, spilled search's RSS growth over a
        warmed-up baseline stays below half the total index bytes, with
        the resident search's rows."""
        path = str(tmp_path / 'big.fsa')
        write_corpus(path, make_corpus(n_taxa=2, n_families=3400, seed=3,
                                       min_len=220, max_len=260))
        env = dict(os.environ, SWIFTORTHO_PLATFORM='cpu', PYTHONPATH=REPO)

        def run(mode):
            r = subprocess.run(
                [sys.executable, '-c', RSS_SCRIPT, mode, path,
                 str(tmp_path / 'spill')],
                capture_output=True, text=True, timeout=600, env=env)
            assert r.returncode == 0, r.stderr[-2000:]
            line = [ln for ln in r.stdout.splitlines()
                    if ln.startswith('RESULT')][0]
            rows, base, peak, total = map(int, line.split()[1:])
            return rows, (peak - base) * 1024, total

        rows_r, _, total_bytes = run('resident')
        rows_s, delta_s, _ = run('stream')
        assert rows_r == rows_s and rows_r > 0
        assert total_bytes > 40 << 20, (
            'setup too small to be meaningful: %d' % total_bytes)
        assert delta_s < total_bytes / 2, (delta_s, total_bytes)
