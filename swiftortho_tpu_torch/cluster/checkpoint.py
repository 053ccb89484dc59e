"""Clustering checkpoint store: resumable MCL runs (SURVEY.md §5).

The reference's only checkpoint is the search-stage index dump; its
clustering restarts from scratch on every failure (bin/find_cluster.py
holds everything in process memory).  Here long MCL runs persist two
kinds of state under a checkpoint directory:

- **finished batches** — the cluster lists produced by each dense size
  bucket batch and each oversize (block-sparse) component, keyed by a
  content signature of the graph + parameters, so a rerun skips every
  batch that already completed;
- **iteration state** — the block-sparse engine's (keys, tiles, snapshot)
  at every convergence-check iteration, stored as sparse COO, so a run
  killed mid-component resumes at the last check instead of iteration 0.

All writes are atomic (tmp file + os.replace); a kill can at worst lose
the state since the previous checkpoint, never corrupt one.  Signatures
make stale state self-invalidating: different input graph or parameters
hash to different keys, so a directory can be reused across runs.

Copied from ``swiftortho_tpu/cluster/checkpoint.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np


def graph_signature(n: int, ei: np.ndarray, ej: np.ndarray, w: np.ndarray,
                    labels: Optional[np.ndarray], **params) -> str:
    h = hashlib.sha1()
    h.update(str(n).encode())
    for a in (ei, ej, w):
        h.update(np.ascontiguousarray(a).tobytes())
    if labels is not None:
        h.update(np.ascontiguousarray(labels).tobytes())
    for k in sorted(params):
        h.update(('%s=%r' % (k, params[k])).encode())
    return h.hexdigest()[:16]


def _atomic_savez(path: str, **arrays) -> None:
    tmp = path + '.tmp.npz'                  # ends in .npz: savez keeps it
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


class ClusterCheckpoint:
    """One store = one directory; keys are namespaced by the signature."""

    def __init__(self, directory: str, signature: str):
        self.dir = directory
        self.sig = signature
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, '%s_%s.npz' % (self.sig, key))

    # -- finished-batch results (ragged cluster lists) --

    def load_batch(self, key: str) -> Optional[List[List[int]]]:
        path = self._path('batch_' + key)
        if not os.path.isfile(path):
            return None
        try:
            with np.load(path) as z:
                flat, off = z['flat'], z['off']
        except Exception:
            return None                      # truncated/corrupt: recompute
        return [flat[off[i]:off[i + 1]].tolist()
                for i in range(len(off) - 1)]

    def save_batch(self, key: str, clusters: List[List[int]]) -> None:
        off = np.zeros(len(clusters) + 1, np.int64)
        for i, c in enumerate(clusters):
            off[i + 1] = off[i] + len(c)
        flat = (np.concatenate([np.asarray(c, np.int64) for c in clusters])
                if clusters else np.zeros(0, np.int64))
        _atomic_savez(self._path('batch_' + key), flat=flat, off=off)

    # -- block-sparse iteration state (sparse COO of the padded tiles) --

    def load_state(self, key: str) -> Optional[dict]:
        path = self._path('state_' + key)
        if not os.path.isfile(path):
            return None
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception:
            return None

    def save_state(self, key: str, **arrays) -> None:
        _atomic_savez(self._path('state_' + key), **arrays)

    def clear_state(self, key: str) -> None:
        try:
            os.remove(self._path('state_' + key))
        except OSError:
            pass
