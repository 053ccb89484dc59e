"""Synthetic multi-proteome corpus generator.

The reference's test corpus (example/ref.fsa, 5 RefSeq bacterial proteomes,
README.md:220-227) is a missing blob, so end-to-end validation needs a
reproducible substitute.  This generator evolves a set of ancestral protein
families into N taxa with substitutions/indels plus lineage-specific
duplications (in-paralogs) and losses — giving a corpus with *known*
ortholog-group ground truth for pipeline tests and benchmarks.

Headers follow the reference convention ``taxon|gene`` (README.md:40-48).

Copied from ``swiftortho_tpu/corpus.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

AA = 'ACDEFGHIKLMNPQRSTVWY'
# rough amino-acid background frequencies (uniform-ish, tilted to common aa)
_AA_P = np.array([8.3, 1.4, 5.4, 6.8, 3.9, 7.1, 2.3, 6.0, 5.8, 9.7,
                  2.4, 4.1, 4.7, 3.9, 5.5, 6.6, 5.4, 6.9, 1.1, 2.9])
_AA_P = _AA_P / _AA_P.sum()


@dataclass
class CorpusTruth:
    """records: list of (header, seq); family_of: header-id -> family index."""
    records: List[Tuple[str, str]]
    family_of: dict


def _rand_protein(rng, n):
    return ''.join(np.random.default_rng(rng.integers(1 << 31)).choice(
        list(AA), size=n, p=_AA_P))


def _evolve(rng, seq: str, sub_rate: float, indel_rate: float) -> str:
    out = []
    for c in seq:
        r = rng.random()
        if r < indel_rate / 2:
            continue
        if r < indel_rate:
            out.append(c)
            out.append(AA[rng.integers(0, 20)])
            continue
        if r < indel_rate + sub_rate:
            out.append(AA[rng.integers(0, 20)])
        else:
            out.append(c)
    return ''.join(out) if out else seq[:1]


def make_corpus(n_taxa: int = 4, n_families: int = 60,
                seed: int = 42, min_len: int = 80, max_len: int = 400,
                sub_rate: float = 0.12, indel_rate: float = 0.02,
                dup_prob: float = 0.08, loss_prob: float = 0.05
                ) -> CorpusTruth:
    rng = np.random.default_rng(seed)
    ancestors = [_rand_protein(rng, int(rng.integers(min_len, max_len)))
                 for _ in range(n_families)]
    records = []
    family_of = {}
    for t in range(n_taxa):
        tax = 'tax%d' % t
        g = 0
        for f, anc in enumerate(ancestors):
            if rng.random() < loss_prob and t > 0:
                continue
            n_copies = 1 + (rng.random() < dup_prob)
            for _ in range(n_copies):
                seq = _evolve(rng, anc, sub_rate, indel_rate)
                gid = '%s|g%04d' % (tax, g)
                records.append(('%s fam%03d' % (gid, f), seq))
                family_of[gid] = f
                g += 1
    return CorpusTruth(records, family_of)


def write_corpus(path: str, corpus: CorpusTruth):
    from .io_fasta import write_fasta
    write_fasta(path, corpus.records)
