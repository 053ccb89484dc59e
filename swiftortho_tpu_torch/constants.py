"""Scoring tables, alphabets and statistical constants.

Behavioral contract (reference lib/fsearch.py:330-346, 1066-1086):
- BLOSUM62 over the 23 letters A..V plus B, Z, X (no '*'), case-folded,
  with every unlisted byte pair scoring -4.
- Karlin-Altschul: gapped lambda=0.267, lnK=-3.1941832122778293;
  ungapped 0.309 / 1.9589953886039688;  bit = int((lam*S - lnK)/ln2);
  E = D * m * n * 2**-bit with D = number of reference sequences.
- Reduced amino-acid alphabets map each residue to min(ord) of its group
  (reference lib/fsearch.py:406-422).

Copied from ``swiftortho_tpu/constants.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# BLOSUM62 (standard NCBI table, 23 symbols; '*' intentionally absent so it
# falls through to the -4 default, matching reference lib/fsearch.py:334).
# ---------------------------------------------------------------------------

BLOSUM62_ALPHA = "ARNDCQEGHILKMFPSTWYVBZX"

_BLOSUM62_ROWS = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1
"""

DEFAULT_MISMATCH = -4


def _build_blosum62_bytes() -> np.ndarray:
    """256x256 int8 score table over raw bytes, case-folded, default -4."""
    rows = [list(map(int, line.split()))
            for line in _BLOSUM62_ROWS.strip().splitlines()]
    mat = np.full((256, 256), DEFAULT_MISMATCH, dtype=np.int8)
    for i, a in enumerate(BLOSUM62_ALPHA):
        for j, b in enumerate(BLOSUM62_ALPHA):
            s = rows[i][j]
            for ai in (ord(a), ord(a.lower())):
                for bj in (ord(b), ord(b.lower())):
                    mat[ai, bj] = s
                    mat[bj, ai] = s
    return mat


#: 256x256 int8 raw-byte substitution table (reference b62, fsearch.py:346).
B62_BYTES: np.ndarray = _build_blosum62_bytes()

# ---------------------------------------------------------------------------
# Compact 32-symbol code space for on-device scoring.
# Code 0..22 = BLOSUM62_ALPHA order; 23 = any other byte (-4 row); codes are
# case-folded.  Raw bytes are still carried separately for identity tests.
# ---------------------------------------------------------------------------

N_CODES = 32
BAD_CODE = 23


def _build_code_tables():
    byte2code = np.full(256, BAD_CODE, dtype=np.int32)
    for i, a in enumerate(BLOSUM62_ALPHA):
        byte2code[ord(a)] = i
        byte2code[ord(a.lower())] = i
    code_mat = np.full((N_CODES, N_CODES), DEFAULT_MISMATCH, dtype=np.int32)
    rows = [list(map(int, line.split()))
            for line in _BLOSUM62_ROWS.strip().splitlines()]
    for i in range(len(BLOSUM62_ALPHA)):
        for j in range(len(BLOSUM62_ALPHA)):
            code_mat[i, j] = rows[i][j]
    return byte2code, code_mat


#: 256 -> [0,32) code table and 32x32 int32 code-space substitution matrix.
BYTE2CODE, B62_CODES = _build_code_tables()

# ---------------------------------------------------------------------------
# Reduced amino-acid alphabets (reference bin/find_hit.py:219-220).
# ---------------------------------------------------------------------------

AA9 = "AST,CFILMVY,DN,EQ,G,H,KR,P,W"
AA20 = "A,S,T,C,F,I,L,M,V,Y,D,N,E,Q,G,H,K,R,P,W"
AA_NR_DEFAULT = "KREDQN,C,G,H,ILV,M,F,Y,W,P,STA"  # fsearch.py:385 module default


def reduced_alphabet_table(groups: str = AA_NR_DEFAULT) -> np.ndarray:
    """Byte->int map sending every residue of a group to min(ord) of the group.

    Identity for bytes outside any group (reference generate_nr_tbl,
    lib/fsearch.py:406-422: table starts as range(512); only 0..255 used).
    """
    tbl = np.arange(256, dtype=np.int64)
    for grp in groups.upper().split(","):
        if not grp:
            continue
        lo = min(ord(c) for c in grp)
        for c in grp:
            tbl[ord(c)] = lo
            tbl[ord(c.lower())] = lo
    return tbl


# ---------------------------------------------------------------------------
# Karlin-Altschul statistics (reference lib/fsearch.py:1066-1086).
# ---------------------------------------------------------------------------

LN2 = 0.69314718055994529
KA_GAPPED_LAMBDA = 0.267
KA_GAPPED_LNK = -3.1941832122778293
KA_UNGAPPED_LAMBDA = 0.309
KA_UNGAPPED_LNK = -1.9589953886039688

GAP_OPEN = -11
GAP_EXTEND = -1
KBOUND = 16            # banded-SW half band width (fsearch.py:1357)
MIN_CHAIN_SCORE = 25   # candidate gate self.min (fsearch.py:2224)
XDROP = 30             # ungapped extension drop (fsearch.py:2454)
LONG_SEQ_TILE = 4096   # kswat_st_long tile size (fsearch.py:1480)
SEG_WINDOW = 12
SEG_MIN_ENT = 2.2
