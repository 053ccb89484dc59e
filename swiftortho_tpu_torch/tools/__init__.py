"""Command-line tools of the port: ``make_corpus`` (a synthetic
multi-proteome corpus with its family truth), ``run_scale`` (the
search -> orthology -> MCL pipeline at scale, with stage seconds),
``scaling_bench`` (fleet scaling at 1/2/4 ranks), ``profile_phaseA``
(host candidate generation per wave and chunk), ``bench_device_cand``
(the device candidate engine against the host one) and
``example_run.sh`` (the reference example run on the port's CLIs).

Counterparts of the JAX package's scripts of the same names in
``tools/``; run them as ``python -m swiftortho_tpu_torch.tools.<name>``
(``bash swiftortho_tpu_torch/tools/example_run.sh``).
"""
