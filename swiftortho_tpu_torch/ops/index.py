"""Spaced-seed inverted index (counting-sort CSR).

Behavioral contract: reference ``Fasta.build_msav`` (lib/fsearch.py:2208-2280):
- bucket count array over NC buckets; threshold = int(mu + 2*sd) of the
  nonzero bucket counts, with the reference's off-by-one divisor (its
  get_mu_sd divides by count+1, fsearch.py:746-761);
- exclusive scan -> CSR offsets; postings are global residue offsets
  (chunk-local soas prefix sums + in-sequence position);
- NC comes from the CLI -M parameter (find_hit.py default 120000000); the
  reference's internal bins formula is dead code due to the scale
  overwrite at fsearch.py:2216.

Host (numpy) implementation; the posting arrays then feed the vectorized
candidate stage.  A chunk covers sequences [start, end) of the reference
set (default 50000 per chunk, find_hit.py -c).

Copied from ``swiftortho_tpu/ops/index.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import sqrt
from typing import List

import numpy as np

from ..constants import reduced_alphabet_table
from ..io_fasta import SeqDB
from .seeds import hash_seeds_flat, min_pattern_len


def ref_mu_sd(counts: np.ndarray) -> tuple[float, float]:
    """mu/sd over strictly-positive entries with the reference's
    divide-by-(n+1) quirk (fsearch.py:746-761)."""
    pos = counts[counts > 0].astype(np.float64)
    n = len(pos) + 1
    mu = float(pos.sum()) / n
    sd = sqrt(float(((pos - mu) ** 2).sum()) / n)
    return mu, sd


@dataclass
class SeedIndex:
    nc: int
    start: np.ndarray          # (nc+1,) int64 CSR offsets
    locus: np.ndarray          # (n_postings,) int64 global residue offsets
    soas: np.ndarray           # (chunk_len+1,) int64 prefix sums of seq lens
    seq_offset: int            # global id of first sequence in chunk
    threshold: int             # mu + 2 sd bucket-count gate
    mink: int                  # shortest pattern length
    sid: np.ndarray = None     # (n_postings,) int32 decoded global seq ids
    sst: np.ndarray = None     # (n_postings,) int32 decoded in-seq positions

    def __post_init__(self):
        if self.sid is None:
            try:        # threaded native bisect (identical; GIL-free)
                from ..native import decode_locus_native
                idx, self.sst = decode_locus_native(self.soas, self.locus)
                self.sid = (idx + np.int32(self.seq_offset)).astype(np.int32)
            except Exception:
                self.sid, self.sst = self.decode_locus(self.locus)
                self.sid = self.sid.astype(np.int32)
                self.sst = self.sst.astype(np.int32)

    def posting_range(self, buckets: np.ndarray):
        return self.start[buckets], self.start[buckets + 1]

    def bucket_counts(self, buckets: np.ndarray) -> np.ndarray:
        return self.start[buckets + 1] - self.start[buckets]

    def decode_locus(self, loc: np.ndarray):
        """global residue offset -> (global sequence id, in-seq position).

        Reproduces the reference's bisect exactly (fsearch.py:134-153 via
        get_loc_mem :2511-2514): it returns the largest index with
        soas[idx] < loc, so a *position-0* seed of sequence j (loc ==
        soas[j]) is attributed to sequence j-1 at position len(j-1) — a
        reference off-by-one that shifts one seed per sequence onto the
        previous subject; faithful because it changes candidate sets.
        Postings are pre-decoded once at build/load time (sid/sst)."""
        idx = np.maximum(np.searchsorted(self.soas, loc, side='left') - 1, 0)
        return idx + self.seq_offset, loc - self.soas[idx]


def save_index(path: str, ix: 'SeedIndex'):
    """Persist a chunk index (the reference's .idx/.soas/.bin checkpoint
    with its params footer, lib/fsearch.py:2298-2349, as one npz)."""
    np.savez_compressed(
        path, start=ix.start, locus=ix.locus, soas=ix.soas,
        params=np.array([ix.nc, ix.seq_offset, ix.threshold, ix.mink],
                        dtype=np.int64))


def load_index(path: str) -> 'SeedIndex':
    z = np.load(path)
    nc, seq_offset, threshold, mink = (int(x) for x in z['params'])
    return SeedIndex(nc=nc, start=z['start'], locus=z['locus'],
                     soas=z['soas'], seq_offset=seq_offset,
                     threshold=threshold, mink=mink)


def save_index_ref(prefix: str, ix: 'SeedIndex', space: str, nr: str):
    """Write a chunk index in the REFERENCE's on-disk DB layout
    (lib/fsearch.py Fasta.write, :2298-2349): three little-endian int32
    files — ``<prefix>.idx`` (locus), ``<prefix>.soas`` (per-seq prefix
    sums), ``<prefix>.bin`` (NC CSR start offsets) — with the ``;``-joined
    params footer ``offset;offend;mw;threshold;NC;space;nr`` appended to
    .bin followed by one trailing byte = chr(len(footer)) (:2336-2348).

    offend carries the reference's end+1 quirk (build_msav stores the
    pre-clamp ``end + 1``, :2226); mw = max '1'-count over the seed
    patterns (:2221).  Values must fit int32 (pack('i')); a chunk whose
    token count exceeds 2^31-1 cannot use this layout (the reference has
    the same bound)."""
    for arr, nm in ((ix.locus, '.idx'), (ix.soas, '.soas'),
                    (ix.start, '.bin')):
        if len(arr) and int(np.max(arr)) > 2 ** 31 - 1:
            raise OverflowError('%s values exceed int32 (reference '
                                'layout bound)' % nm)
    ix.locus.astype('<i4').tofile(prefix + '.idx')
    ix.soas.astype('<i4').tofile(prefix + '.soas')
    mw = max(p.count('1') for p in space.split(','))
    offend = ix.seq_offset + (len(ix.soas) - 1) + 1
    footer = '%d;%d;%d;%d;%d;%s;%s' % (
        ix.seq_offset, offend, mw, ix.threshold, ix.nc, space, nr)
    if len(footer) > 255:
        raise ValueError('params footer exceeds the 1-byte length field')
    with open(prefix + '.bin', 'wb') as f:
        ix.start[:ix.nc].astype('<i4').tofile(f)
        f.write(footer.encode() + bytes([len(footer)]))


def load_index_ref(prefix: str) -> tuple['SeedIndex', dict]:
    """Load a reference-layout chunk DB (written by the reference's
    ``-p makedb`` / Fasta.write or by save_index_ref) into a SeedIndex.

    Returns (index, params) where params carries the footer fields we do
    not store (space, nr, mw, offend) so callers can validate them
    against the active SearchConfig.  The CSR end of the last bucket is
    len(locus) (the reference reads bucket i as [start[i], start[i+1]),
    final end implicit), so our (nc+1,) start gains that sentinel."""
    locus = np.fromfile(prefix + '.idx', '<i4').astype(np.int64)
    soas = np.fromfile(prefix + '.soas', '<i4').astype(np.int64)
    with open(prefix + '.bin', 'rb') as f:
        raw = f.read()
    m = raw[-1]
    footer = raw[len(raw) - 1 - m:len(raw) - 1].decode()
    offset, offend, mw, thr, nc, space, nr = footer.split(';')
    nc = int(nc)
    start = np.frombuffer(raw, '<i4', count=nc).astype(np.int64)
    start = np.concatenate([start, [len(locus)]])
    ix = SeedIndex(nc=nc, start=start, locus=locus, soas=soas,
                   seq_offset=int(offset), threshold=int(thr),
                   mink=min(len(p) for p in space.split(',')))
    return ix, {'space': space, 'nr': nr, 'mw': int(mw),
                'offend': int(offend)}


def build_index(db: SeqDB, start: int, end: int, alphabets: List[str],
                ssps: str, nc: int, step: int = 1,
                threshold_override: int = -1) -> SeedIndex:
    """Build the CSR seed index for reference sequences [start, end)."""
    end = min(end, len(db))
    lens = db.lengths[start:end].astype(np.int64)
    soas = np.zeros(end - start + 1, dtype=np.int64)
    np.cumsum(lens, out=soas[1:])
    chunk_tokens = db.tokens[db.offsets[start]:db.offsets[end]]
    seq_of = np.repeat(np.arange(end - start, dtype=np.int64), lens)

    bs, ps = [], []
    for alpha in alphabets:
        tbl = reduced_alphabet_table(alpha)
        b, p = hash_seeds_flat(chunk_tokens, seq_of, tbl, ssps, nc, step)
        bs.append(b)
        ps.append(p)
    b = np.concatenate(bs) if bs else np.zeros(0, np.int64)
    p = np.concatenate(ps) if ps else np.zeros(0, np.int64)

    # the native counting sort walks all nc buckets three times, so it
    # only pays off when the posting stream is dense relative to the
    # bucket table (big corpora); sparse cases (tiny corpus, default
    # -M 120M) stay on numpy, whose O(nc) part is a single bincount
    dense = len(b) * 16 >= nc
    done = False
    if dense:
        try:
            # threaded native counting sort (groupby.cpp
            # index_csr_scatter): identical to bincount + cumsum +
            # stable argsort-take below
            from ..native import index_csr_scatter_native
            csr, locus = index_csr_scatter_native(b, p, nc)
            counts = np.diff(csr)
            done = True
        except Exception:
            pass            # no compiler: single-core numpy
    if not done:
        counts = np.bincount(b, minlength=nc)
        csr = np.zeros(nc + 1, dtype=np.int64)
        np.cumsum(counts, out=csr[1:])
        order = np.argsort(b, kind='stable')
        locus = p[order]    # p is already the chunk-global residue offset

    mu, sd = ref_mu_sd(counts)
    threshold = int(mu + 2 * sd)
    if threshold_override >= 1:
        threshold = threshold_override

    return SeedIndex(nc=nc, start=csr, locus=locus, soas=soas,
                     seq_offset=start, threshold=threshold,
                     mink=min_pattern_len(ssps))
