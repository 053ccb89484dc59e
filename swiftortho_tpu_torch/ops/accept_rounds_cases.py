"""Edge inputs of the accept rounds (``search/candidates_device.py::
accept_rounds`` and its kernel, ``ops/accept_rounds_cuda.py``), by name,
made from a seed with numpy: the one generator that the CPU tests and
``chip_smoke.py`` on the card both hold the kernel to.

``make_case(name, seed, scale)`` returns (new_seg bool, valid bool, qst
int32, E int32) arrays; ``scale`` multiplies each case's number of
segments or points.
"""

from __future__ import annotations

import numpy as np

CASES = ('engine', 'unsorted', 'e_equals_qst', 'all_invalid',
         'one_point_segments', 'one_long_segment', 'no_points')


def _segments(sizes):
    new_seg = np.zeros(int(sizes.sum()), bool)
    new_seg[np.concatenate([[0], np.cumsum(sizes)[:-1]])] = True
    return new_seg


def _sorted_runs(rng, sizes, high):
    return np.concatenate([np.sort(rng.integers(0, high, s)) for s in sizes])


def _case(name, rng, scale):
    if name == 'engine':            # qst ascending in a group, E >= qst
        sizes = rng.integers(1, 12, 300 * scale)
        qst = _sorted_runs(rng, sizes, 400)
        E = qst + np.where(rng.random(len(qst)) < 0.3, 0,
                           rng.integers(0, 60, len(qst)))
        return _segments(sizes), rng.random(len(qst)) < 0.85, qst, E
    if name == 'unsorted':          # flags anywhere but at 0, E < qst
        C = 2000 * scale
        new_seg = rng.random(C) < 0.15
        new_seg[0] = False
        qst = rng.integers(0, 300, C)
        E = qst + rng.integers(-40, 40, C)
        return new_seg, rng.random(C) < 0.8, qst, E
    if name == 'e_equals_qst':
        sizes = rng.integers(1, 9, 200 * scale)
        qst = _sorted_runs(rng, sizes, 50)
        return _segments(sizes), np.ones(len(qst), bool), qst, qst
    if name == 'all_invalid':
        sizes = rng.integers(1, 6, 100 * scale)
        qst = rng.integers(0, 100, int(sizes.sum()))
        return _segments(sizes), np.zeros(len(qst), bool), qst, qst + 3
    if name == 'one_point_segments':
        C = 500 * scale
        qst = rng.integers(0, 200, C)
        return (np.ones(C, bool), rng.random(C) < 0.7, qst,
                qst + rng.integers(0, 30, C))
    if name == 'one_long_segment':
        C = 3000 * scale
        qst = np.sort(rng.integers(0, 4000, C))
        E = qst + rng.integers(0, 25, C)
        new_seg = np.zeros(C, bool)
        new_seg[0] = True
        return new_seg, rng.random(C) < 0.9, qst, E
    if name == 'no_points':
        z = np.zeros(0, np.int64)
        return np.zeros(0, bool), np.zeros(0, bool), z, z
    raise KeyError(name)


def make_case(name: str, seed: int = 0, scale: int = 1):
    """(new_seg, valid, qst, E) for the case ``name`` (one of ``CASES``)."""
    new_seg, valid, qst, E = _case(name, np.random.default_rng(seed), scale)
    return new_seg, valid, qst.astype(np.int32), E.astype(np.int32)
