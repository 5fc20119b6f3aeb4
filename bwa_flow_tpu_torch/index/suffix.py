"""Suffix-array construction (NumPy prefix-doubling).

Builds the suffix array of a 2-bit nucleotide sequence plus an implicit
sentinel smaller than every base (matching the suffix order used by the
reference index builder, bwa/is.c + bwa/bwt_gen.c). Prefix doubling with
``np.lexsort`` is O(n log^2 n) but NumPy-vectorized, which is plenty for
test/bench genomes; production-scale builders can load stock ``bwa index``
artifacts instead (see index/io.py).
"""

from __future__ import annotations

import numpy as np


def suffix_array(seq: np.ndarray) -> np.ndarray:
    """Suffix array of ``seq + [sentinel]``.

    Args:
      seq: uint8/int array of symbols in [0, 3].

    Returns:
      int64 array of length ``len(seq) + 1``; element 0 is always
      ``len(seq)`` (the sentinel suffix).
    """
    n = int(len(seq)) + 1
    # rank 0 reserved for the sentinel; bases get 1..4
    rank = np.zeros(n, dtype=np.int64)
    rank[: n - 1] = seq.astype(np.int64) + 1
    k = 1
    sa = None
    while True:
        # key = (rank[i], rank[i+k]) with rank past the end == 0 (sentinel
        # region sorts first, which is correct: shorter suffix < extension)
        second = np.zeros(n, dtype=np.int64)
        if k < n:
            second[: n - k] = rank[k:]
        sa = np.lexsort((second, rank))
        # recompute ranks
        key_r = rank[sa]
        key_s = second[sa]
        new_rank = np.empty(n, dtype=np.int64)
        head = np.ones(n, dtype=bool)
        head[1:] = (key_r[1:] != key_r[:-1]) | (key_s[1:] != key_s[:-1])
        new_rank[sa] = np.cumsum(head) - 1
        rank = new_rank
        if rank[sa[-1]] == n - 1:  # all ranks distinct
            break
        k <<= 1
    return sa.astype(np.int64)


def bwt_from_sa(seq: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """$-removed BWT string and the primary index.

    Row k of the conceptual sorted-rotation matrix holds the suffix starting
    at sa[k]; its BWT symbol is seq[sa[k]-1], except the row with sa[k]==0
    whose symbol is the sentinel. bwa stores the BWT with that row removed
    and remembers its index as ``primary`` (bwa/bwt.h:47).
    """
    n = len(seq)
    primary = int(np.nonzero(sa == 0)[0][0])
    # chunked gather: materializing (sa - 1) whole costs another
    # 8 bytes/symbol (human fwd+rc: +50 GB — the build OOM-killed there)
    bwt = np.empty(n, np.uint8)
    CHUNK = 1 << 28
    out = 0
    for lo, hi in ((0, primary), (primary + 1, len(sa))):
        for c0 in range(lo, hi, CHUNK):
            c1 = min(c0 + CHUNK, hi)
            bwt[out:out + (c1 - c0)] = seq[sa[c0:c1] - 1]
            out += c1 - c0
    assert out == n
    return bwt, primary
