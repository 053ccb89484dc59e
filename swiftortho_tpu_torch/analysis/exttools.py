"""External-tool probe-and-fallback dispatch (MSA / trim / tree).

The reference pipeline shells out to external tools when present:

- family MSA: famsa -> mafft -> muscle, probed in that order with
  ``type <tool>`` (scripts/rbh2phy.py:203-214); argv reproduced here
  verbatim (``famsa -t 4 IN OUT``, ``mafft --quiet --auto IN > OUT``,
  ``muscle -in IN -out OUT -fasta -quiet``).
- alignment trim: ``trimal -in A -out B -automated1`` when ``which
  trimal`` succeeds, else a plain copy (scripts/run_all.py:213-219).
- species tree: ``fasttree -quiet -wag -gamma -pseudo -spr 4 -mlacc 2
  -slownni -no2nd -boot 1000 ALN > NWK`` (scripts/run_all.py:220-221;
  the reference invokes it unconditionally and silently produces no
  tree when absent — here absence falls back to the built-in NJ).

On hosts where the tools exist this module reproduces those exact
invocations so the pipeline's trees match the reference pipeline's;
where they are absent (this environment) the framework's built-ins
(center-star MSA, gap-fraction trim, neighbor joining) take over —
they remain the only testable path here.  ``SWIFTORTHO_NO_EXTERNAL=1``
forces the built-ins regardless of PATH (reproducibility switch).

Deviation from the reference, named: the reference *requires* one of
famsa/mafft/muscle and exits otherwise (rbh2phy.py:215-217); this
framework never hard-fails — the built-in aligner is the fallback.

Copied from ``swiftortho_tpu/analysis/exttools.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence, Tuple


def externals_enabled() -> bool:
    return os.environ.get('SWIFTORTHO_NO_EXTERNAL', '') not in (
        '1', 'y', 'yes', 'true')


def find_tool(*names: str) -> Optional[str]:
    """First tool on PATH among ``names`` (None if disabled/absent)."""
    if not externals_enabled():
        return None
    for name in names:
        path = shutil.which(name)
        if path:
            return path
    return None


def msa_tool() -> Optional[Tuple[str, str]]:
    """(kind, path) of the preferred external aligner — reference probe
    order famsa -> mafft -> muscle (rbh2phy.py:203-214)."""
    if not externals_enabled():
        return None
    for kind in ('famsa', 'mafft', 'muscle'):
        path = shutil.which(kind)
        if path:
            return kind, path
    return None


def _read_fasta_rows(path: str) -> List[Tuple[str, str]]:
    from ..io_fasta import iter_fasta
    with open(path) as fh:
        return [(head.split()[0], seq) for head, seq in iter_fasta(fh)]


def msa_align_external(ids: Sequence[str], seqs: Sequence[str],
                       tool: Tuple[str, str]) -> Optional[List[str]]:
    """Align one family with the external tool; rows returned in input
    order (external aligners may reorder records).  None on any tool
    failure so the caller can fall back."""
    kind, path = tool
    with tempfile.TemporaryDirectory(prefix='swmsa_') as td:
        fin = os.path.join(td, 'f.fsa')
        fout = os.path.join(td, 'f.fsa.aln')
        with open(fin, 'w') as out:
            for gid, seq in zip(ids, seqs):
                out.write('>%s\n%s\n' % (gid, seq))
        try:
            if kind == 'famsa':
                r = subprocess.run([path, '-t', '4', fin, fout],
                                   stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)
            elif kind == 'mafft':
                with open(fout, 'w') as oh:
                    r = subprocess.run([path, '--quiet', '--auto', fin],
                                       stdout=oh,
                                       stderr=subprocess.DEVNULL)
            else:   # muscle
                r = subprocess.run([path, '-in', fin, '-out', fout,
                                    '-fasta', '-quiet'],
                                   stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)
        except OSError:
            return None
        if r.returncode != 0 or not os.path.exists(fout):
            return None
        rows = dict(_read_fasta_rows(fout))
        if set(rows) != set(ids):
            return None
        aligned = [rows[gid] for gid in ids]
        if len({len(s) for s in aligned}) != 1:
            return None
        return aligned


def align_family(ids: Sequence[str], seqs: Sequence[str]) -> List[str]:
    """Family MSA: external famsa/mafft/muscle when present (reference
    invocation), built-in center-star otherwise."""
    tool = msa_tool()
    if tool is not None:
        rows = msa_align_external(ids, seqs, tool)
        if rows is not None:
            return rows
    from .msa import center_star_msa
    return center_star_msa(list(seqs))


def trim_alignment_file(aln_path: str, trim_path: str) -> bool:
    """``trimal -in A -out B -automated1`` (run_all.py:213-216) when
    trimal is on PATH; returns False (nothing written) otherwise."""
    path = find_tool('trimal')
    if path is None:
        return False
    try:
        r = subprocess.run([path, '-in', aln_path, '-out', trim_path,
                            '-automated1'],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    except OSError:
        return False
    return r.returncode == 0 and os.path.exists(trim_path)


def tree_from_file(aln_path: str) -> Optional[str]:
    """fasttree on the concatenated alignment with the reference's
    exact flag set (run_all.py:220-221); None when absent/failed."""
    path = find_tool('fasttree', 'FastTree')
    if path is None:
        return None
    try:
        r = subprocess.run(
            [path, '-quiet', '-wag', '-gamma', '-pseudo', '-spr', '4',
             '-mlacc', '2', '-slownni', '-no2nd', '-boot', '1000',
             aln_path],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    except OSError:
        return None
    if r.returncode != 0 or not r.stdout.strip():
        return None
    return r.stdout.decode().strip()
