"""Species phylogeny from typed ortholog rows.

Behavioral contract: reference scripts/orth2phy.py: rows 'O\\tq\\ts\\t...'
(our pipeline's 'OT' rows are accepted too); families anchor on the
reference taxon (default: most genes): family(g_ref) = [g_ref] + partners;
only families of the maximum size (covering all represented taxa) are
kept; each family is aligned (external famsa/mafft/muscle when on PATH
— the reference's aligners — else the built-in center-star) and
per-taxon rows concatenated.  Unlike rbh2phy there is no gap padding
for absent taxa — full-size families make it unnecessary.

Copied from ``swiftortho_tpu/analysis/orth2phy.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

from ..io_fasta import SeqDB
from .exttools import align_family


def orth_families(orth_lines: Iterable[str], db: SeqDB,
                  ref_taxon: str = '', sep: str = '|') -> List[List[str]]:
    taxon_ct = Counter(db.taxa(sep))
    if not ref_taxon:
        ref_taxon = max(taxon_ct.items(), key=lambda x: x[1])[0]
    ortholog: Dict[str, List[str]] = {}
    for line in orth_lines:
        f = line.rstrip('\n').split('\t')
        if len(f) < 4 or f[0] not in ('O', 'OT'):
            continue
        g0, g1 = f[1], f[2]
        t0, t1 = g0.split(sep)[0], g1.split(sep)[0]
        if t0 == ref_taxon:
            ortholog.setdefault(g0, [g0]).append(g1)
        elif t1 == ref_taxon:
            ortholog.setdefault(g1, [g1]).append(g0)
    if not ortholog:
        return []
    size = max(len(v) for v in ortholog.values())
    return [v for v in ortholog.values() if len(v) == size]


def orth2phy(orth_lines: Iterable[str], db: SeqDB, ref_taxon: str = '',
             sep: str = '|') -> List[Tuple[str, str]]:
    fams = orth_families(orth_lines, db, ref_taxon, sep)
    id2i = {gid: i for i, gid in enumerate(db.ids)}
    tree: Dict[str, List[str]] = {}
    for fam in fams:
        fam = [g for g in fam if g in id2i]
        if len(fam) < 2:
            continue
        aln = align_family(fam, [db.seq_str(id2i[g]) for g in fam])
        for g, row in zip(fam, aln):
            tree.setdefault(g.split(sep)[0], []).append(row)
    return [(tax, ''.join(rows)) for tax, rows in tree.items()]
