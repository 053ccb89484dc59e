"""Typed configuration shared across pipeline stages.

One dataclass per stage (the reference hand-rolls an args dict per CLI:
bin/find_hit.py:227-242, bin/find_orth.py:44-59, bin/find_cluster.py:95-110,
scripts/run_all.py:64-76).  Defaults mirror bin/find_hit.py.

Copied from ``swiftortho_tpu/config.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .constants import AA9, AA20


@dataclass
class SearchConfig:
    """All-vs-all search (reference find_hit.py defaults, :212-228)."""
    expect: float = 1e-3          # -e
    v: int = 500                  # -v max hits per query
    max_miss: float = 1e-3        # -m early-stop miss ratio
    seeds: str = '11111111'       # -s spaced seed pattern(s)
    alphabet: str = 'aa9'         # -r reduced alphabet spec ('/' separated)
    step: int = 1                 # -j seed stride
    filter_query: bool = True     # -F T
    threshold: int = -1           # -t bucket-count threshold override
    nc: int = 120_000_000         # -M hash bucket count
    chunk: int = 50_000           # -c reference sequences per index chunk
    sep: str = '|'                # taxon|gene header separator

    # TPU batching knobs (no reference analog).  Wave size 4096 + wave
    # pipeline 4 measured fastest on the 40k corpus (BASELINE.md round-2
    # table: 45.7s vs 69.7s at 2048/2) — bigger waves amortize dispatch
    # latency and keep the device busy across the deeper pipeline.
    query_batch: int = 4096       # queries processed per wave
    align_buckets: tuple = (128, 256, 512, 1024, 2048, 4096)

    def resolved_alphabets(self) -> List[str]:
        out = []
        for a in self.alphabet.split('/'):
            a = a.strip()
            if a == 'aa9':
                out.append(AA9)
            elif a == 'aa20':
                out.append(AA20)
            else:
                out.append(a)
        return out

    def effective_chunk(self) -> int:
        # find_hit.py:273-274 divides chunk size by the alphabet count
        return max(1, self.chunk // (self.alphabet.count('/') + 1))


@dataclass
class OrthConfig:
    """Orthology inference (reference find_orth.py defaults, :44-45)."""
    coverage: float = 0.5         # -c min query coverage
    identity: float = 0.0         # -y min identity
    norm: str = 'no'              # -n no|bsr|bal score normalization
    sep: str = '|'


@dataclass
class ClusterConfig:
    """Graph clustering (reference find_cluster.py defaults, :95-110)."""
    algorithm: str = 'apc'        # -a (reference default, find_cluster.py:96)
    inflation: float = 1.5        # -I
    damping: float = 0.5          # -d (apc)
    prune: float = 1e-5           # MCL weak-edge prune
    component_batch: int = 10**7  # -b max edges per MCL sub-problem
    max_dense: int = 4096         # dense-MCL component size cap (ours)
    ckpt_dir: str | None = None   # resumable-MCL checkpoint dir (ours)
    # default (r5): replicate the reference APC's order-dependent
    # streaming-max quirks bit-for-bit (cluster/apc.apc_cluster_faithful)
    # — partition-identical to the runnable reference, and measured only
    # 1.49x slower than the textbook mode at ~100k-graph scale
    # (BASELINE.md r5; quirks are the spec).  faithful=False or
    # SWIFTORTHO_APC_FAITHFUL=0 selects the textbook exact row max
    # (the documented fast mode; SWIFTORTHO_APC_FAITHFUL=1 forces
    # faithful regardless of this field).
    faithful: bool = True


@dataclass
class PipelineConfig:
    search: SearchConfig = field(default_factory=SearchConfig)
    orth: OrthConfig = field(default_factory=OrthConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
