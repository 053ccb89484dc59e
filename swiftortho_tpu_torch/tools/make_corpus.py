"""Generate a synthetic multi-proteome corpus with known ortholog truth.

Usage: python -m swiftortho_tpu_torch.tools.make_corpus out.fsa [n_taxa]
       [n_families] [seed]

Writes the fasta plus ``out.fsa.truth`` (gene, tab, family) for
validation.  Counterpart of the JAX package's ``tools/make_corpus.py``,
on the port's copy of ``corpus.make_corpus``: the same arguments give the
same bytes.
"""

from __future__ import annotations

import sys

from ..corpus import make_corpus, write_corpus


def main(argv=None):
    argv = sys.argv if argv is None else argv
    out = argv[1] if len(argv) > 1 else 'corpus.fsa'
    n_taxa = int(argv[2]) if len(argv) > 2 else 5
    n_fam = int(argv[3]) if len(argv) > 3 else 500
    seed = int(argv[4]) if len(argv) > 4 else 42
    corpus = make_corpus(n_taxa=n_taxa, n_families=n_fam, seed=seed)
    write_corpus(out, corpus)
    with open(out + '.truth', 'w') as fh:
        for gid, fam in sorted(corpus.family_of.items()):
            fh.write('%s\t%d\n' % (gid, fam))
    print('wrote %s: %d records, %d taxa, %d families'
          % (out, len(corpus.records), n_taxa, n_fam))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
