"""Fasta ingest into flat token arrays (the TPU-friendly layout).

The whole proteome set is held as one contiguous uint8 token array plus
int64 offsets — the same "prefix-sums of sequence lengths" idea as the
reference's ``soas`` array (lib/fsearch.py:2238-2243) — so that device code
only ever sees dense arrays, never Python strings.

Header conventions follow the reference (README.md:40-48): a record id is
the first whitespace token of the header; the taxon is the id prefix before
``sep`` (default ``|``).

Copied from ``swiftortho_tpu/io_fasta.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def iter_fasta(fh: io.TextIOBase) -> Iterator[Tuple[str, str]]:
    """Yield (header, sequence) pairs; header excludes the leading '>'.

    Records with empty sequences are kept (the reference's index-based
    Fasta numbers every '>' header, fsearch.py:2180-2199, and sequence
    indices in the m8 output and -l/-u ranges must match it)."""
    head = None
    chunks: List[str] = []
    for line in fh:
        if line.startswith('>'):
            if head is not None:
                yield head, ''.join(chunks)
            head = line[1:].rstrip('\n')
            chunks = []
        else:
            chunks.append(line.strip())
    if head is not None:
        yield head, ''.join(chunks)


def write_fasta(path: str, records: Sequence[Tuple[str, str]], width: int = 0):
    with open(path, 'w') as fh:
        for head, seq in records:
            fh.write('>%s\n' % head)
            if width > 0:
                for i in range(0, len(seq), width):
                    fh.write(seq[i:i + width] + '\n')
            else:
                fh.write(seq + '\n')


@dataclass
class SeqDB:
    """A set of sequences as flat arrays.

    tokens  : uint8[total]   raw bytes of all sequences, concatenated
    offsets : int64[n+1]     sequence i occupies tokens[offsets[i]:offsets[i+1]]
    headers : full fasta headers (no '>')
    ids     : first whitespace token of each header
    """

    tokens: np.ndarray
    offsets: np.ndarray
    headers: List[str]
    ids: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.ids:
            self.ids = [h.split(' ')[0] for h in self.headers]

    def __len__(self) -> int:
        return len(self.headers)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def seq_bytes(self, i: int) -> np.ndarray:
        return self.tokens[self.offsets[i]:self.offsets[i + 1]]

    def seq_str(self, i: int) -> str:
        return self.seq_bytes(i).tobytes().decode('latin-1')

    def taxa(self, sep: str = '|') -> List[str]:
        return [sid.split(sep)[0] for sid in self.ids]

    @classmethod
    def from_records(cls, records: Sequence[Tuple[str, str]]) -> 'SeqDB':
        headers = []
        parts = []
        offsets = [0]
        total = 0
        for head, seq in records:
            headers.append(head)
            b = np.frombuffer(seq.encode('latin-1'), dtype=np.uint8)
            parts.append(b)
            total += len(b)
            offsets.append(total)
        tokens = (np.concatenate(parts) if parts
                  else np.zeros(0, dtype=np.uint8))
        return cls(tokens=tokens, offsets=np.asarray(offsets, dtype=np.int64),
                   headers=headers)

    @classmethod
    def from_path(cls, path: str) -> 'SeqDB':
        with open(path, 'r') as fh:
            return cls.from_records(list(iter_fasta(fh)))

    def padded_batch(self, idx: np.ndarray, pad_to: int,
                     starts: np.ndarray | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """Gather sequences idx (optionally suffixes from `starts`) into a
        dense (len(idx), pad_to) uint8 batch plus int32 lengths.  Sequences
        longer than pad_to are truncated (callers bucket by length)."""
        idx = np.asarray(idx, dtype=np.int64)
        n = len(idx)
        out = np.zeros((n, pad_to), dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        offs = self.offsets
        if starts is None:
            starts = np.zeros(n, dtype=np.int64)
        for r, (i, st) in enumerate(zip(idx, starts)):
            a, b = offs[i] + st, offs[i + 1]
            if a >= b:
                continue
            m = min(b - a, pad_to)
            out[r, :m] = self.tokens[a:a + m]
            lens[r] = m
        return out, lens
