"""SwiftOrtho search on PyTorch and CUDA (NVIDIA Hopper).

The port of ``swiftortho_tpu``'s pipeline, from the all-vs-all search
(``find_hit``) to clustering (``find_cluster``, ``run_all``): the
same m8 hit table, byte for byte, with the banded Smith-Waterman run by a
hand-written CUDA kernel (``csrc/banded_sw.cu``).  Host code with no
device work (fasta I/O, seed index, candidate engine, the C++ host
kernels in ``native/``, scoring constants, orthology inference and the
analysis scripts) is the port's own copy of the JAX package's; this
package imports ``torch``, never ``jax`` and nothing of
``swiftortho_tpu``.

Pick the device with ``SWIFTORTHO_PLATFORM=cuda|cpu`` (default ``cuda``,
see ``device.get_device``).
"""
