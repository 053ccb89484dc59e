"""Command-line tools of the port: ``make_corpus`` (a synthetic
multi-proteome corpus with its family truth) and ``run_scale`` (the
search -> orthology -> MCL pipeline at scale, with stage seconds).

Counterparts of the JAX package's ``tools/make_corpus.py`` and
``tools/run_scale.py``; run them as ``python -m
swiftortho_tpu_torch.tools.<name>``.
"""
