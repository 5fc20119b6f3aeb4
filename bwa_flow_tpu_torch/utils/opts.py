"""Alignment options — the single source of truth for scoring parameters.

Mirrors the semantics of the reference's ``mem_opt_t``
(bwa/bwamem.h:26-59, defaults bwa/bwamem.c:48-84)
so output is bit-compatible with ``bwa mem``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# flag bits (reference: bwa/bwamem.h:14-24)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000
MEM_F_XB = 0x2000

MEM_MAPQ_COEF = 30.0
MEM_MAPQ_MAX = 60


def fill_scmat(a: int, b: int) -> np.ndarray:
    """5x5 scoring matrix: +a on diagonal, -b off-diagonal, -1 vs N.

    Reference: bwa/bwa.c:109-118 (bwa_fill_scmat).
    """
    mat = np.full((5, 5), -1, dtype=np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = a if i == j else -b
    # row/col 4 (N) stay -1
    return mat


def _round_f32(v: float) -> float:
    """Round a ratio through IEEE float32 — the reference's option
    struct stores these as C floats (bwamem.h:48-51), and boundary
    comparisons depend on the f32 value."""
    import struct as _struct
    return _struct.unpack("f", _struct.pack("f", v))[0]


@dataclasses.dataclass
class MemOpt:
    a: int = 1                  # match score
    b: int = 4                  # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100                # band width
    zdrop: int = 100
    max_mem_intv: int = 20
    T: int = 30                 # output score threshold
    flag: int = 0
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    chunk_size: int = 10000000
    # The reference stores these ratios in C FLOAT fields (bwamem.h:48-51)
    # and every comparison promotes the float to double — so 0.80 is
    # really 0.80f = 0.800000011920929. Defaults here are pre-rounded
    # through float32; -c/-D style setters must round too (see
    # _round_f32). Measured consequence of using the double literal:
    # score-at-exactly-80% XA hits flip (e.g. 116 >= 145*0.80 is True in
    # double, False after float32 rounding — 8 diverging reads per
    # 200k-read soak).
    mask_level: float = 0.50              # exact in f32
    drop_ratio: float = 0.50              # exact in f32
    XA_drop_ratio: float = 0.800000011920928955078125
    mask_level_redun: float = 0.949999988079071044921875
    mapQ_coef_len: float = 50.0
    # NB: the reference stores this in an *int* field, truncating
    # log(50)=3.912 to 3 (bwamem.c:81); keep the truncation for bit-exact
    # MAPQ.
    mapQ_coef_fac: int = int(math.log(50.0))
    max_ins: int = 10000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    mat: np.ndarray = dataclasses.field(default_factory=lambda: fill_scmat(1, 4))

    def refresh_mat(self) -> None:
        self.mat = fill_scmat(self.a, self.b)

    @property
    def split_len(self) -> int:
        # (int)(opt->min_seed_len * opt->split_factor + .499), bwamem.c:124
        return int(self.min_seed_len * self.split_factor + 0.499)
