"""Reciprocal-best-hit extraction and RBH-based species phylogeny.

Behavioral contract:
- get_rbh (scripts/get_rbh.py): per query, best inter-taxon hit per subject
  taxon (first wins on score ties); pairs seen from both directions are
  printed once ('qid\\tsid' with qid < sid).
- rbh2phy (scripts/rbh2phy.py): reference taxon = most genes (or -r);
  per query the best hit per (ref-taxon -> other-taxon) marks a candidate;
  the reverse direction confirms it; genes RBH-confirmed in >= 90% of taxa
  form families; families are aligned and concatenated per taxon with
  all-gap padding for absent taxa.  The reference shells out to
  famsa/mafft/muscle (rbh2phy.py:203-214); this framework uses those
  same tools when they are on PATH (analysis/exttools.py reproduces the
  probe order and argv) and its own center-star MSA otherwise.

Copied from ``swiftortho_tpu/analysis/rbh.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, Iterator, List, Tuple

from ..io_fasta import SeqDB
from .exttools import align_family


def _m8_groups(lines: Iterable[str]) -> Iterator[List[List[str]]]:
    """Rows grouped by consecutive qid, sorted by bit desc within group
    (reference m8parse, rbh2phy.py:78-95)."""
    flag = None
    out: List[List[str]] = []
    for line in lines:
        f = line.rstrip('\n').split('\t')
        if len(f) < 12:
            continue
        if flag != f[0]:
            if out:
                out.sort(key=lambda x: -float(x[11]))
                yield out
            flag = f[0]
            out = [f]
        else:
            out.append(f)
    if out:
        out.sort(key=lambda x: -float(x[11]))
        yield out


def get_rbh_pairs(lines: Iterable[str], sep: str = '|') -> Iterator[str]:
    """scripts/get_rbh.py behavior (groups in file order, best per taxon
    by strict >)."""
    seen = set()
    flag = None
    group: List[Tuple[str, str, float]] = []

    def flush(group):
        best: Dict[str, Tuple[str, str, float]] = {}
        for qid, sid, sco in group:
            qtx, stx = qid.split(sep)[0], sid.split(sep)[0]
            if qtx == stx:
                continue
            if stx not in best or best[stx][2] < sco:
                best[stx] = (qid, sid, sco)
        return best.values()

    for line in lines:
        f = line.rstrip('\n').split('\t')
        if len(f) < 12:
            continue
        qid, sid, sco = f[0], f[1], float(f[11])
        if qid != flag:
            if group:
                for q, s, _ in flush(group):
                    a, b = (q, s) if q < s else (s, q)
                    key = a + '\t' + b
                    if key in seen:
                        yield key + '\n'
                        seen.remove(key)
                    else:
                        seen.add(key)
            flag = qid
            group = [(qid, sid, sco)]
        else:
            group.append((qid, sid, sco))
    if group:
        for q, s, _ in flush(group):
            a, b = (q, s) if q < s else (s, q)
            key = a + '\t' + b
            if key in seen:
                yield key + '\n'


def rbh_families(sc_lines: Iterable[str], db: SeqDB, ref_taxon: str = '',
                 sep: str = '|', min_rate: float = 0.9) -> List[List[str]]:
    """RBH gene families anchored on the reference taxon."""
    taxon_ct = Counter(db.taxa(sep))
    ranked = sorted(taxon_ct.items(), key=lambda x: -x[1])
    taxon_n = len(ranked)
    if not ref_taxon:
        ref_taxon = ranked[0][0]
    tidx = {t: i for i, (t, _) in enumerate(ranked)}

    sc_lines = list(sc_lines)
    ortholog: Dict[str, List] = {}
    for group in _m8_groups(sc_lines):
        Os = {}
        for f in group:
            qid, sid = f[0], f[1]
            qtx, stx = qid.split(sep)[0], sid.split(sep)[0]
            if qtx == ref_taxon and stx != ref_taxon:
                Os.setdefault((qtx, stx), (qid, sid))
        for qid, sid in Os.values():
            stx = sid.split(sep)[0]
            if qid not in ortholog:
                ortholog[qid] = [-1] * (taxon_n * 2)
                ortholog[qid][0] = qid
                ortholog[qid][1] = 1
            ortholog[qid][tidx[stx] * 2] = sid

    for group in _m8_groups(sc_lines):
        Os = {}
        for f in group:
            qid, sid = f[0], f[1]
            qtx, stx = qid.split(sep)[0], sid.split(sep)[0]
            if qtx != ref_taxon and stx == ref_taxon:
                Os.setdefault((qtx, stx), (sid, qid))
        for rq, rs in Os.values():
            if rq not in ortholog:
                continue
            stx = rs.split(sep)[0]
            if ortholog[rq][tidx[stx] * 2] == rs:
                ortholog[rq][tidx[stx] * 2 + 1] = 1

    fams = []
    for vec in ortholog.values():
        fam = [a for a, b in zip(vec[::2], vec[1::2]) if b == 1]
        if len(fam) / taxon_n >= min_rate:
            fams.append(fam)
    return fams


def rbh2phy(sc_lines: Iterable[str], db: SeqDB, ref_taxon: str = '',
            sep: str = '|') -> List[Tuple[str, str]]:
    """Concatenated per-taxon alignment records [(taxon, aligned seq)]."""
    fams = rbh_families(sc_lines, db, ref_taxon, sep)
    id2i = {gid: i for i, gid in enumerate(db.ids)}
    taxon_set = set(db.taxa(sep))
    tree: Dict[str, List[str]] = {}
    for fam in fams:
        seqs = [db.seq_str(id2i[g]) for g in fam]
        aln = align_family(fam, seqs)
        width = len(aln[0]) if aln else 0
        visit = set()
        for g, row in zip(fam, aln):
            tax = g.split(sep)[0]
            tree.setdefault(tax, []).append(row)
            visit.add(tax)
        for tax in taxon_set - visit:
            tree.setdefault(tax, []).append('-' * width)
    return [(tax, ''.join(rows)) for tax, rows in tree.items()]
