"""Streaming duplicate marking — samblaster-equivalent semantics.

Reimplements the reference's samblaster port (markDupsDiscordants
src/samblaster.cpp:425-568, signature machinery
src/samblaster.h:270-360, stage wiring src/MarkDupStage.cpp:50-192):
signature-based duplicate detection over primary-alignment pairs, with
strand-normalized clipped-adjusted positions binned into 2^27-wide genome
bins. FLAG 1024 is set on every alignment line of every read in a
duplicate block.

Where the reference guards one global hash table with a mutex
(MarkDupStage.cpp:132-134), this keeps a per-instance signature set that
batches can update NumPy-vectorized; multi-host operation merges signature
sets via allgather (parallel/distributed.py) instead of sharing memory.

Two stages compute the same marks: NativeMarkDupStage (the _markdup host
library, csrc/host/_markdup.cpp), which make_markdup_stage returns, and
the regex MarkDupStage here, its golden specification, taken with
native=False.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .. import _build
from ..io.sam import Read

BIN_SHIFT = 27
BIN_MASK = (1 << BIN_SHIFT) - 1
MAX_SEQUENCE_LENGTH = 250  # samblaster.h:49

# flag bits
_PAIRED = 0x1
_CONCORDANT = 0x2
_UNMAPPED = 0x4
_NEXT_UNMAPPED = 0x8
_REVERSE = 0x10
_FIRST = 0x40
_SECOND = 0x80
_SECONDARY = 0x100
_DUP = 0x400
_SUPPLEMENTARY = 0x800

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")


@dataclasses.dataclass
class _Line:
    """splitLine_t equivalent: the parsed fields markdup needs."""

    flag: int
    rname: str
    rapos: int
    cigar: bytes
    pos: int = 0
    seq_num: int = 0
    bin_num: int = 0
    bin_pos: int = 0

    def is_rev(self) -> bool:
        return bool(self.flag & _REVERSE)


def _calc_offsets(line: _Line) -> None:
    """calcOffsets (samblaster.cpp:560-605): clip-adjusted unclipped
    position, strand-normalized."""
    ra_len = 0
    sclip = eclip = 0
    first = True
    for m in _CIGAR_RE.finditer(line.cigar):
        ln = int(m.group(1))
        op = m.group(2)
        if op in (b"M", b"=", b"X"):
            ra_len += ln
            first = False
        elif op in (b"S", b"H"):
            if first:
                sclip += ln
            else:
                eclip += ln
        elif op in (b"D", b"N"):
            ra_len += ln
    if not line.flag & _REVERSE:
        pos = line.rapos - sclip
    else:
        pos = line.rapos + ra_len + eclip - 1
    line.pos = pos + MAX_SEQUENCE_LENGTH  # padPos


class MarkDupState:
    """Per-run signature store (sigs array analog)."""

    def __init__(self, anns, ignore_unmated: bool = False):
        # falcon's table: "*" -> 0, then contig i -> i (MarkDupStage.cpp:54-71)
        self.seqs = {"*": 0}
        self.seq_offs = {0: 0}
        total = 0
        for i, ann in enumerate(anns):
            self.seqs[ann.name] = i
            self.seq_offs[i] = total
            total += ann.len + 1
        self.sigs: set[tuple[int, int, int]] = set()
        self.ignore_unmated = ignore_unmated
        self.dup_count = 0
        self.unmated_count = 0

    def signature_items(self):
        """Serialized signatures for cross-host merging."""
        return sorted(self.sigs)

    def merge(self, items) -> None:
        self.sigs.update(tuple(t) for t in items)


def _needs_swap(first: _Line, second: _Line) -> bool:
    """needSwap (samblaster.h:358-370)."""
    if first.pos != second.pos:
        return first.pos > second.pos
    if first.seq_num != second.seq_num:
        return first.seq_num > second.seq_num
    if first.is_rev() == second.is_rev():
        return False
    return first.is_rev() and not second.is_rev()


def mark_dups_block(state: MarkDupState, lines: list[_Line]) -> bool:
    """markDupsDiscordants (samblaster.cpp:425-568) over one QNAME block of
    primary lines. Returns True if the block is a duplicate."""
    first = second = None
    for line in lines:
        if line.flag & (_SECONDARY | _SUPPLEMENTARY):
            continue
        if not line.flag & _PAIRED:
            second = line
        elif line.flag & _FIRST:
            first = line
        elif line.flag & _SECOND:
            second = line
    orphan = dummy_first = False
    if first is None and second is None:
        if state.ignore_unmated:
            state.unmated_count += 1
            return False
        raise ValueError("markdup: block without first/second of pair "
                         "(input not grouped by read id?)")
    if first is None or second is None:
        if second is None:
            first, second = second, first
        if (second.flag & _PAIRED) and (
                second.flag & _UNMAPPED
                or not second.flag & _NEXT_UNMAPPED):
            if state.ignore_unmated:
                state.unmated_count += 1
                return False
            raise ValueError("markdup: unmatched paired read "
                             "(input not grouped by read id?)")
        if second.flag & _UNMAPPED:
            return False
        first = _Line(flag=0x85 if second.flag & _FIRST else 0x45,
                      rname="*", rapos=0, cigar=b"*")
        orphan = dummy_first = True
    else:
        if (first.flag & _UNMAPPED) and (second.flag & _UNMAPPED):
            return False
        orphan = bool((first.flag | second.flag) & _UNMAPPED)
        if not first.flag & _UNMAPPED and second.flag & _UNMAPPED:
            first, second = second, first

    _calc_offsets(second)
    second.seq_num = state.seqs.get(second.rname, 0)
    seq_off = state.seq_offs.get(second.seq_num, 0)
    second.bin_num = (seq_off + second.pos) >> BIN_SHIFT
    second.bin_pos = (seq_off + second.pos) & BIN_MASK
    if orphan:
        first.pos = first.seq_num = first.bin_num = first.bin_pos = 0
    else:
        _calc_offsets(first)
        first.seq_num = state.seqs.get(first.rname, 0)
        seq_off = state.seq_offs.get(first.seq_num, 0)
        first.bin_num = (seq_off + first.pos) >> BIN_SHIFT
        first.bin_pos = (seq_off + first.pos) & BIN_MASK

    if not orphan and _needs_swap(first, second):
        first, second = second, first

    sig = ((first.bin_pos & 0xFFFFFFFF) << 32) | (second.bin_pos & 0xFFFFFFFF)
    s1 = first.bin_num * 2 + (1 if first.is_rev() else 0)
    s2 = second.bin_num * 2 + (1 if second.is_rev() else 0)
    key = (s1, s2, sig)
    if key in state.sigs:
        state.dup_count += 1
        return True
    state.sigs.add(key)
    return False


def _primary_line(sam: str) -> _Line | None:
    for text in sam.splitlines():
        f = text.split("\t")
        if len(f) < 11:
            continue
        flag = int(f[1])
        if flag & (_SECONDARY | _SUPPLEMENTARY):
            continue
        return _Line(flag=flag, rname=f[2], rapos=int(f[3]),
                     cigar=f[5].encode())
    return None


def _set_dup(sam: str) -> str:
    out = []
    for text in sam.splitlines():
        f = text.split("\t")
        if len(f) >= 11:
            f[1] = str(int(f[1]) | _DUP)
        out.append("\t".join(f))
    return "\n".join(out) + ("\n" if sam.endswith("\n") else "")


class MarkDupStage:
    """Batch stage: group aligned reads by QNAME (adjacent), run the block
    dedup, and rewrite FLAG 1024 into the SAM of duplicate blocks
    (MarkDupStage.cpp:86-192)."""

    def __init__(self, fm, ignore_unmated: bool = False):
        self.state = MarkDupState(fm.bns.anns, ignore_unmated)

    def process(self, reads: list[Read]) -> None:
        i = 0
        n = len(reads)
        while i < n:
            j = i + 1
            while j < n and reads[j].name == reads[i].name:
                j += 1
            block = reads[i:j]
            lines = [ln for ln in (_primary_line(r.sam) for r in block)
                     if ln is not None]
            if lines and mark_dups_block(self.state, lines):
                for r in block:
                    r.sam = _set_dup(r.sam)
            i = j


# ----------------------------------------------------------------- native

class NativeMarkDupState:
    """MarkDupState-compatible facade over the _markdup host library:
    per-bin open-addressing uint64 sets (~11 B/signature against ~200 B
    for a Python tuple set). Its signature items are (s1, s2, sig)
    triples of uint64 (csrc/host/_markdup.cpp items), each below 2^63:
    s1 and s2 keep 32 bits, and sig packs two 27-bit bin positions, the
    first in its top 32 bits."""

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
    """MarkDupStage on the native engine: one C++ pass parses primary
    lines, probes/updates the signature store, and rewrites FLAG 1024 —
    no regex, no Python per line."""

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


def make_markdup_stage(fm, ignore_unmated: bool = False,
                       native: bool = True):
    """The streaming duplicate-marking stage: the native one, or with
    native=False the regex MarkDupStage."""
    if native:
        return NativeMarkDupStage(fm, ignore_unmated)
    return MarkDupStage(fm, ignore_unmated)
