"""Observability: structured per-stage timing logs and profiler hooks.

The reference's only observability is wall-clock prints in run_all
(scripts/run_all.py:99-223) and progress counters in the index build
(lib/fsearch.py:640-641).  Here every stage emits one structured JSON
line on stderr (machine-parseable, greppable), and a ``torch.profiler``
trace can be captured around any stage via SWIFTORTHO_TRACE_DIR.

Copied from ``swiftortho_tpu/utils.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.  ``stage`` opens a
``torch.profiler`` trace where the original opens a JAX one.
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
    """Time a pipeline stage; with SWIFTORTHO_TRACE_DIR=/path set, wrap it
    in a ``torch.profiler`` trace (CPU activity, and CUDA activity when a
    card is present) written as a Chrome trace under ``/path/<name>/``.
    A profiler that cannot start or stop does not fail the stage: it is
    logged as one ``trace_unavailable`` event."""
    trace_dir = os.environ.get('SWIFTORTHO_TRACE_DIR')
    tracer = cuda = None
    if trace_dir:
        try:
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)
            if torch.autograd._profiler_enabled():
                # a second session would end the first one's (and crash
                # its exit), where the JAX profiler refuses to nest
                raise RuntimeError('a profiler is already running')
            cuda = torch.cuda.is_available()
            tracer = profile(
                activities=[ProfilerActivity.CPU]
                + ([ProfilerActivity.CUDA] if cuda else []),
                on_trace_ready=tensorboard_trace_handler(
                    os.path.join(trace_dir, name)))
            tracer.__enter__()
        except Exception as e:
            tracer = None
            log_event('trace_unavailable', trace=name,
                      error='%s: %s' % (type(e).__name__, e))
    t0 = time.time()
    try:
        yield
    finally:
        if tracer is not None:
            try:
                if cuda:
                    torch.cuda.synchronize()   # the stage's kernels end
                tracer.__exit__(None, None, None)
            except Exception as e:
                log_event('trace_unavailable', trace=name,
                          error='%s: %s' % (type(e).__name__, e))
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
