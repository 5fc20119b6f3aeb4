"""POSIX rand48 replication.

``bwa index`` fills ambiguous (N) reference bases with lrand48()&3 after
srand48(11) (reference: bwa/bntseq.c:261,290-291). To produce byte-identical
.pac files we replicate the 48-bit LCG exactly.
"""

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Rand48:
    def __init__(self, seed: int = 11):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self._x = (self._x * _A + _C) & _MASK
        return self._x >> 17  # non-negative long in [0, 2^31)
