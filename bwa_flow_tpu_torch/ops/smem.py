"""Golden (NumPy) SMEM seeding.

Exact reimplementation of the reference seeding front-end:
  - bwt_smem1a      (bwa/bwt.c:289-351)
  - bwt_seed_strategy1 (bwa/bwt.c:358-379)
  - mem_collect_intv (bwa/bwamem.c:120-168: SMEM pass, re-seeding pass,
    LAST-like third pass, sort by info)

An interval is (k, l, s, info) with info = start<<32 | end, matching
bwtintv_t (bwa/bwt.h:60-63).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..index.fmindex import FMIndex
from ..utils.ksort import ks_introsort
from ..utils.opts import MemOpt
from . import fm as fmops


@dataclasses.dataclass
class Intv:
    x0: int
    x1: int
    s: int
    info: int  # start<<32 | end

    @property
    def start(self) -> int:
        return self.info >> 32

    @property
    def end(self) -> int:
        return self.info & 0xFFFFFFFF


class IntvBatch:
    """Array-native interval batch — the production interface between the
    device seeding machine and the native chain/wave stages.

    Per-read Intv OBJECTS cost ~125 ms of Python per 8k-read batch to
    build and get immediately re-packed into flat arrays by the native
    consumers (chain_batch/create_driver); this type carries those flat
    arrays directly. iv_off int64[n+1] bounds read r's intervals at
    [iv_off[r], iv_off[r+1]); columns x0/x1/sv int64[NI], st/en int32[NI]
    mirror bwtintv_t (bwa/bwt.h:60-63). Indexing materializes Intv lists
    for the Python fallback paths."""

    __slots__ = ("iv_off", "x0", "x1", "sv", "st", "en")

    def __init__(self, iv_off, x0, x1, sv, st, en):
        self.iv_off, self.x0, self.x1 = iv_off, x0, x1
        self.sv, self.st, self.en = sv, st, en

    def __len__(self) -> int:
        return len(self.iv_off) - 1

    def __getitem__(self, r: int) -> list[Intv]:
        lo, hi = int(self.iv_off[r]), int(self.iv_off[r + 1])
        info = (self.st[lo:hi].astype(np.int64) << 32) \
            | self.en[lo:hi].astype(np.int64)
        return [Intv(int(k), int(l), int(s), int(i)) for k, l, s, i in
                zip(self.x0[lo:hi], self.x1[lo:hi], self.sv[lo:hi], info)]

    def lists(self) -> list[list[Intv]]:
        return [self[r] for r in range(len(self))]

    def slice_reads(self, lo: int, hi: int) -> "IntvBatch":
        """Sub-batch view for reads [lo, hi) (multi-device sharding)."""
        a, b = int(self.iv_off[lo]), int(self.iv_off[hi])
        return IntvBatch(self.iv_off[lo:hi + 1] - a, self.x0[a:b],
                         self.x1[a:b], self.sv[a:b], self.st[a:b],
                         self.en[a:b])

    @classmethod
    def concat(cls, parts: list["IntvBatch"]) -> "IntvBatch":
        """The batches' reads one after another (the inverse of
        slice_reads over consecutive ranges)."""
        if len(parts) == 1:
            return parts[0]
        offs = [parts[0].iv_off]
        for p in parts[1:]:
            offs.append(p.iv_off[1:] + offs[-1][-1])
        return cls(np.concatenate(offs),
                   *(np.concatenate([getattr(p, f) for p in parts])
                     for f in ("x0", "x1", "sv", "st", "en")))

    @classmethod
    def from_lists(cls, all_intvs: list[list[Intv]]) -> "IntvBatch":
        n = len(all_intvs)
        iv_off = np.zeros(n + 1, np.int64)
        for r, iv in enumerate(all_intvs):
            iv_off[r + 1] = iv_off[r] + len(iv)
        NI = int(iv_off[-1])
        x0 = np.empty(NI, np.int64)
        x1 = np.empty(NI, np.int64)
        sv = np.empty(NI, np.int64)
        st = np.empty(NI, np.int32)
        en = np.empty(NI, np.int32)
        i = 0
        for iv in all_intvs:
            for p in iv:
                x0[i] = p.x0
                x1[i] = p.x1
                sv[i] = p.s
                st[i] = p.info >> 32
                en[i] = p.info & 0xFFFFFFFF
                i += 1
        return cls(iv_off, x0, x1, sv, st, en)


def smem1a(fm: FMIndex, q: np.ndarray, x: int, min_intv: int,
           max_intv: int = 0) -> tuple[int, list[Intv]]:
    """SMEMs covering position x. Returns (end-of-longest-match, mems)."""
    length = len(q)
    mems: list[Intv] = []
    if q[x] > 3:
        return x + 1, mems
    if min_intv < 1:
        min_intv = 1
    ik = fmops.set_intv(fm, int(q[x]))
    ik_info = x + 1
    curr: list[tuple[np.ndarray, int]] = []

    i = x + 1
    while i < length:  # forward search
        if ik[2] < max_intv:  # an interval small enough
            curr.append((ik.copy(), ik_info))
            break
        elif q[i] < 4:
            c = 3 - int(q[i])
            ok = fmops.bwt_extend(fm, ik, is_back=False)
            if ok[c, 2] != ik[2]:  # change of the interval size
                curr.append((ik.copy(), ik_info))
                if ok[c, 2] < min_intv:
                    break
            ik = ok[c].copy()
            ik_info = i + 1
        else:  # ambiguous base: always terminate
            curr.append((ik.copy(), ik_info))
            break
        i += 1
    if i == length:
        curr.append((ik.copy(), ik_info))
    curr.reverse()  # longer matches (smaller intervals) first
    ret = curr[0][1]
    prev = curr
    # stale forward-loop ik is consulted by the max_intv gate below,
    # reproducing the reference's use of the captured variable (bwt.c:330)
    stale_s = int(ik[2])

    i = x - 1
    while i >= -1:  # backward search for MEMs
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        curr = []
        for (p, p_info) in prev:
            ok = None
            if c >= 0 and stale_s >= max_intv:
                ok = fmops.bwt_extend(fm, p, is_back=True)
            if c < 0 or stale_s < max_intv or ok[c, 2] < min_intv:
                if len(curr) == 0:  # no longer match survives
                    if len(mems) == 0 or i + 1 < (mems[-1].info >> 32):
                        mems.append(Intv(int(p[0]), int(p[1]), int(p[2]),
                                         ((i + 1) << 32) | p_info))
            elif len(curr) == 0 or ok[c, 2] != curr[-1][0][2]:
                curr.append((ok[c].copy(), p_info))
        if len(curr) == 0:
            break
        prev = curr
        i -= 1
    mems.reverse()  # sorted by start coordinate
    return ret, mems


def seed_strategy1(fm: FMIndex, q: np.ndarray, x: int, min_len: int,
                   max_intv: int) -> tuple[int, Intv | None]:
    """LAST-like forward-only seeding (bwa/bwt.c:358-379)."""
    length = len(q)
    if q[x] > 3:
        return x + 1, None
    ik = fmops.set_intv(fm, int(q[x]))
    for i in range(x + 1, length):
        if q[i] < 4:
            c = 3 - int(q[i])
            ok = fmops.bwt_extend(fm, ik, is_back=False)
            if ok[c, 2] < max_intv and i - x >= min_len:
                m = Intv(int(ok[c, 0]), int(ok[c, 1]), int(ok[c, 2]),
                         (x << 32) | (i + 1))
                return i + 1, m
            ik = ok[c].copy()
        else:
            return i + 1, None
    return length, None


def collect_intv(opt: MemOpt, fm: FMIndex, q: np.ndarray) -> list[Intv]:
    """All seeding intervals for one read, sorted by info
    (bwa/bwamem.c:120-168)."""
    length = len(q)
    mems: list[Intv] = []
    start_width = 1
    split_len = opt.split_len
    # first pass: all SMEMs
    x = 0
    while x < length:
        if q[x] < 4:
            x, m1 = smem1a(fm, q, x, start_width, 0)
            for p in m1:
                if (p.info & 0xFFFFFFFF) - (p.info >> 32) >= opt.min_seed_len:
                    mems.append(p)
        else:
            x += 1
    # second pass: re-seed long, low-occurrence SMEMs from their middle
    old_n = len(mems)
    for k in range(old_n):
        p = mems[k]
        start, end = p.info >> 32, p.info & 0xFFFFFFFF
        if end - start < split_len or p.s > opt.split_width:
            continue
        _, m1 = smem1a(fm, q, (start + end) >> 1, p.s + 1, 0)
        for pp in m1:
            if (pp.info & 0xFFFFFFFF) - (pp.info >> 32) >= opt.min_seed_len:
                mems.append(pp)
    # third pass: LAST-like
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = seed_strategy1(fm, q, x, opt.min_seed_len,
                                      opt.max_mem_intv)
                if m is not None and m.s > 0:
                    mems.append(m)
            else:
                x += 1
    # intv_lt / ks_introsort (bwamem.c:90,167): re-seeded intervals can
    # duplicate a pass-1 info, so the introsort tie permutation matters
    ks_introsort(mems, lambda x, y: x.info < y.info)
    return mems
