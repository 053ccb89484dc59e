"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Every source in ``csrc/`` is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds).  The library lives in ``build/`` under a name
keyed by a sha256 of the sources and the commands, so a changed source
or flag always rebuilds and a stale binary is never loaded.  The
compiles carry ``-Xptxas -v``; their report (registers, shared memory,
spills per kernel) is kept beside the library and returned by
``build_info``.  Only sources in the repository are used.  Processes that
build at first use together (fleet ranks on one host) each compile to a
temporary file of their own pid; the report, then the library, are
published with ``os.replace``, so no process reads a half-written file.

Counterpart of ``swiftortho_tpu/native/__init__.py:36-68`` (the g++
build of the host kernels).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_lib = None
_info: dict = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location.  Raises if none exists."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    cands += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')


def _sources() -> list:
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(CSRC, '*.cu')))


def _ptxas_lines(text: str) -> list:
    """The per-kernel lines of a ``-Xptxas -v`` report."""
    keep = ('Compiling entry', 'Used ', 'spill', 'stack frame')
    return [ln.strip() for ln in text.splitlines()
            if any(k in ln for k in keep)]


def load_kernels() -> ctypes.CDLL:
    """The kernels' library, built on first use; raises on any failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        nvcc = nvcc_path()
        compile_cmd = [nvcc, *NVCC_FLAGS, '-c']
        link_cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-shared']
        h = hashlib.sha256(' '.join(compile_cmd + link_cmd).encode())
        for s in srcs:
            with open(os.path.join(CSRC, s), 'rb') as f:
                h.update(s.encode() + b'\0' + f.read())
        so = os.path.join(BUILD_DIR, 'libswt_kernels.%s.so'
                          % h.hexdigest()[:16])
        report = so + '.ptxas.txt'
        seconds = 0.0
        built = not os.path.exists(so)
        if built:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '%s.%d.tmp' % (so, os.getpid())
            objs = ['%s.%s.o' % (tmp, s) for s in srcs]
            t0 = time.time()
            procs = [subprocess.Popen(compile_cmd + [s, '-o', o], cwd=CSRC,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for s, o in zip(srcs, objs)]
            steps = []
            for p in procs:
                out = p.communicate()[0]
                steps.append((p.args, p.returncode, out))
            if all(rc == 0 for _, rc, _ in steps):
                r = subprocess.run(link_cmd + objs + ['-o', tmp], cwd=CSRC,
                                   capture_output=True, text=True)
                steps.append((r.args, r.returncode, r.stdout + r.stderr))
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
            seconds = time.time() - t0
            for args, rc, text in steps:
                if rc != 0:
                    raise RuntimeError('nvcc failed (exit %d): %s\n%s'
                                       % (rc, ' '.join(args), text[-6000:]))
            with open(tmp + '.ptxas.txt', 'w') as f:
                f.write(''.join(text for _, _, text in steps))
            os.replace(tmp + '.ptxas.txt', report)
            os.replace(tmp, so)
        with open(report) as f:
            ptxas = _ptxas_lines(f.read())
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.swt_banded_sw.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp,
                                      ci, ci, ci, vp, vp]
        lib.swt_banded_sw.restype = ci
        lib.swt_xdrop_walk.argtypes = [vp] * 12 + [ci] * 5 + [vp] * 4
        lib.swt_xdrop_walk.restype = ci
        lib.swt_accept_rounds.argtypes = [vp] * 4 + [ctypes.c_longlong] \
            + [vp] * 4
        lib.swt_accept_rounds.restype = ci
        lib.swt_lanes_for.argtypes = [ci, ci]
        lib.swt_lanes_for.restype = ci
        lib.swt_cuda_error_string.argtypes = [ci]
        lib.swt_cuda_error_string.restype = ctypes.c_char_p
        _info.update(path=so, built=built, seconds=round(seconds, 3),
                     command='%s <source> && %s <objects>'
                     % (' '.join(compile_cmd), ' '.join(link_cmd)),
                     ptxas=ptxas)
        _lib = lib
        return _lib


def build_info() -> dict:
    """Library path, whether this process built it, nvcc seconds, the
    command and the ptxas report lines (empty before ``load_kernels``)."""
    return dict(_info)
