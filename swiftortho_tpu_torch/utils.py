"""Observability: structured per-stage timing logs.

The reference's only observability is wall-clock prints in run_all
(scripts/run_all.py:99-223) and progress counters in the index build
(lib/fsearch.py:640-641).  Here every stage emits one structured JSON
line on stderr (machine-parseable, greppable).

Copied from ``swiftortho_tpu/utils.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.  Left out: the JAX
profiler trace that the reference's ``stage`` opens under
SWIFTORTHO_TRACE_DIR.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


_warned: set = set()


def warn_fallback(kind: str, detail: str, exact: bool = True):
    """Loud, once-per-process warning that a native/fast path degraded to a
    fallback.  ``exact=False`` marks fallbacks that can change output (e.g.
    the capped numpy chain scorer) — those must never be silent."""
    if kind in _warned:
        return
    _warned.add(kind)
    log_event('fallback', kind=kind, detail=detail, exact=exact,
              capped=not exact)
    sys.stderr.write('[swiftortho] WARNING: %s fallback in use — %s%s\n'
                     % (kind, detail,
                        '' if exact else ' (results may differ: capped '
                        'extensions can perturb candidate ranking)'))
    sys.stderr.flush()


def log_event(stage: str, **fields):
    rec = {'ts': round(time.time(), 3), 'stage': stage}
    rec.update(fields)
    sys.stderr.write('[swiftortho] %s\n' % json.dumps(rec))
    sys.stderr.flush()


@contextlib.contextmanager
def stage(name: str, **fields):
    """Time a pipeline stage."""
    t0 = time.time()
    try:
        yield
    finally:
        log_event(name, seconds=round(time.time() - t0, 3), **fields)


def fresh(path: str, *inputs: str) -> bool:
    """True if `path` exists and is newer than all inputs (stage-resume
    support: the reference restarts stages by rerunning from input files,
    SURVEY.md section 5)."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    mt = os.path.getmtime(path)
    # strict <: an input written in the same mtime tick counts as newer
    # (coarse-granularity filesystems would otherwise keep stale output);
    # a missing input means the pipeline state is inconsistent -> rerun.
    return all(os.path.exists(i) and os.path.getmtime(i) < mt
               for i in inputs)
