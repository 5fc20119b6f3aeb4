"""Streaming duplicate marking — samblaster-equivalent semantics.

Reimplements the reference's samblaster port (markDupsDiscordants
src/samblaster.cpp:425-568, signature machinery
src/samblaster.h:270-360, stage wiring in the reference's markdup
stage, lines 50-192): signature-based duplicate detection over
primary-alignment pairs, with strand-normalized clipped-adjusted
positions binned into 2^27-wide genome bins. FLAG 1024 is set on every
alignment line of every read in a duplicate block.

Where the reference guards one global hash table with a mutex (its
markdup stage, lines 132-134), this keeps a per-instance signature set;
multi-host operation merges signature sets via allgather
(parallel/distributed.py) instead of sharing memory.

The stage is NativeMarkDupStage, on the _markdup host library
(csrc/host/_markdup.cpp); its golden specification is the JAX package's
regex stage (bwa_flow_tpu/dedup/markdup.py), which the tests hold it
to.
"""

from __future__ import annotations

import numpy as np

from .. import _build
from ..io.sam import Read


class NativeMarkDupState:
    """The signature store of the JAX package's regex stage, over the
    _markdup host library: per-bin open-addressing uint64 sets (~11
    B/signature against ~200 B for a Python tuple set). Its signature
    items are (s1, s2, sig) triples of uint64 (csrc/host/_markdup.cpp
    items), each below 2^63: s1 and s2 keep 32 bits, and sig packs two
    27-bit bin positions, the first in its top 32 bits."""

    def __init__(self, anns, ignore_unmated: bool = False):
        self._lib = _build.host_module("_markdup")
        names = [a.name.encode() for a in anns]
        name_off = np.zeros(len(names) + 1, np.int64)
        for i, nm in enumerate(names):
            name_off[i + 1] = name_off[i] + len(nm)
        lens = np.array([a.len for a in anns], np.int64)
        self._st = self._lib.create(b"".join(names), name_off, lens,
                                    bool(ignore_unmated))
        self.ignore_unmated = ignore_unmated

    @property
    def dup_count(self) -> int:
        return self._lib.counts(self._st)[0]

    @property
    def unmated_count(self) -> int:
        return self._lib.counts(self._st)[1]

    def signature_items(self):
        raw = np.frombuffer(self._lib.items(self._st), np.uint64)
        return [tuple(int(x) for x in raw[i:i + 3])
                for i in range(0, len(raw), 3)]

    def merge(self, items) -> None:
        flat = np.asarray([x for t in items for x in t], np.uint64)
        self._lib.merge(self._st, flat.tobytes())


class NativeMarkDupStage:
    """The JAX package's regex stage on the native engine (grouping by
    QNAME, the reference's markdup stage, lines 86-192): one C++ pass
    parses primary lines, probes/updates the signature store, and
    rewrites FLAG 1024 — no regex, no Python per line."""

    def __init__(self, fm, ignore_unmated: bool = False):
        self.state = NativeMarkDupState(fm.bns.anns, ignore_unmated)

    def process(self, reads: list[Read]) -> None:
        n = len(reads)
        if not n:
            return
        # the library works on bytes: offsets count UTF-8 bytes, also
        # where a read's SAM is not ASCII
        sams = [r.sam.encode() for r in reads]
        sam_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in sams], out=sam_off[1:])
        blocks = [0]
        i = 0
        while i < n:
            j = i + 1
            while j < n and reads[j].name == reads[i].name:
                j += 1
            blocks.append(j)
            i = j
        block_off = np.asarray(blocks, np.int64)
        lib = self.state._lib
        new_cat, new_off_b = lib.process(self.state._st, b"".join(sams),
                                         sam_off, block_off)
        if lib.counts(self.state._st)[2]:
            raise ValueError(
                "markdup: ungrouped input (block without first/second "
                "of pair)")
        new_off = np.frombuffer(new_off_b, np.int64)
        for i, r in enumerate(reads):
            r.sam = new_cat[new_off[i]:new_off[i + 1]].decode()


def make_markdup_stage(fm, ignore_unmated: bool = False):
    """The streaming duplicate-marking stage."""
    return NativeMarkDupStage(fm, ignore_unmated)
