"""Seed chaining and chain filtering (golden host implementation).

Reimplements mem_chain / test_and_merge / mem_chain_weight / mem_chain_flt /
mem_flt_chained_seeds (bwa/bwamem.c:170-624) over the interval output of
ops/smem.py. The reference keeps chains in a B-tree keyed by position
(bwamem.c:190-193); here a bisect-maintained sorted list plays that role.

mem_chain_flt's weight sort replicates the reference's ks_introsort
permutation exactly (utils/ksort.py): which of several identical-weight
repeat chains survives filtering — and hence the XS sub score — depends
on how introsort reorders ties.
"""

from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

from ..index.fmindex import FMIndex
from ..utils.ksort import ks_introsort
from ..utils.opts import MemOpt
from . import fm as fmops
from . import ksw
from .smem import Intv

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


@dataclasses.dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclasses.dataclass
class Chain:
    pos: int
    rid: int
    is_alt: int
    seeds: list  # list[Seed]
    w: int = 0
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0

    @property
    def n(self) -> int:
        return len(self.seeds)


def test_and_merge(opt: MemOpt, l_pac: int, c: Chain, p: Seed, seed_rid: int) -> bool:
    """bwamem.c:199-220; True if the seed merged into (or is contained in)
    the chain."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (p.qbeg >= c.seeds[0].qbeg and p.qbeg + p.len <= qend
            and p.rbeg >= c.seeds[0].rbeg and p.rbeg + p.len <= rend):
        return True  # contained seed
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac:
        return False  # different strand
    x = p.qbeg - last.qbeg  # always non-negative
    y = p.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last.len < opt.max_chain_gap
            and y - last.len < opt.max_chain_gap):
        c.seeds.append(p)
        return True
    return False


def chain_weight(c: Chain) -> int:
    """bwamem.c:222-241: min of query/ref coverage by seeds."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp = w
    w = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return w if w < (1 << 30) else (1 << 30) - 1


class _KBTree:
    """Exact replica of klib kbtree's insert/interval/traverse behavior
    for chain keys (bwa/kbtree.h, degree t=5 for mem_chain_t at
    KB_DEFAULT_SIZE — /tmp-verified sizeof math). bwa's output DEPENDS on
    kbtree implementation accidents: with duplicate chain positions (one
    per tandem-repeat copy), which duplicate `kb_intervalp` returns — and
    therefore which chain a seed merges into — is determined by the
    B-tree node layout, i.e. the split history. A sorted-list bisect
    picks a different duplicate and produces different chains on
    tandem-repeat reads (measured: 43 diverging reads per 200k-read
    soak, all in tandem arrays). Keys are (pos, chain) pairs compared by
    pos only."""

    __slots__ = ("t", "root")

    class _Node:
        __slots__ = ("keys", "kids")

        def __init__(self, leaf: bool):
            self.keys: list = []
            self.kids: list | None = None if leaf else []

    def __init__(self, t: int = 5):
        self.t = t
        self.root = self._Node(leaf=True)

    @staticmethod
    def _get_aux(node, pos):
        """__kb_getp_aux: lower_bound, then (index, r) with r<0 stepping
        left — exact match lands on the FIRST equal key with r=0."""
        n = len(node.keys)
        if n == 0:
            return -1, 1
        begin, end = 0, n
        while begin < end:
            mid = (begin + end) >> 1
            if node.keys[mid][0] < pos:
                begin = mid + 1
            else:
                end = mid
        if begin == n:
            return n - 1, 1
        kp = node.keys[begin][0]
        r = (pos > kp) - (pos < kp)
        if r < 0:
            begin -= 1
        return begin, r

    def interval(self, pos):
        """kb_intervalp: (lower, upper) chain objects; exact match
        returns that in-node element for both."""
        lower = upper = None
        x = self.root
        while x is not None:
            i, r = self._get_aux(x, pos)
            if i >= 0 and r == 0:
                c = x.keys[i][1]
                return c, c
            if i >= 0:
                lower = x.keys[i][1]
            if i < len(x.keys) - 1:
                upper = x.keys[i + 1][1]
            if x.kids is None:
                break
            x = x.kids[i + 1]
        return lower, upper

    def _split(self, x, i, y):
        t = self.t
        z = self._Node(leaf=y.kids is None)
        z.keys = y.keys[t:]
        if y.kids is not None:
            z.kids = y.kids[t:]
            del y.kids[t:]
        mid = y.keys[t - 1]
        del y.keys[t - 1:]
        x.kids.insert(i + 1, z)
        x.keys.insert(i, mid)

    def put(self, pos, chain):
        t = self.t
        r = self.root
        if len(r.keys) == 2 * t - 1:
            s = self._Node(leaf=False)
            s.kids = [r]
            self._split(s, 0, r)
            self.root = s
            r = s
        x = r
        while True:
            if x.kids is None:
                i, _ = self._get_aux(x, pos)
                x.keys.insert(i + 1, (pos, chain))
                return
            i, _ = self._get_aux(x, pos)
            i += 1
            if len(x.kids[i].keys) == 2 * t - 1:
                self._split(x, i, x.kids[i])
                if pos > x.keys[i][0]:
                    i += 1
            x = x.kids[i]

    def traverse(self) -> list:
        """__kb_traverse in-order emission."""
        out: list = []

        def rec(x):
            if x.kids is None:
                out.extend(k[1] for k in x.keys)
                return
            for j, key in enumerate(x.keys):
                rec(x.kids[j])
                out.append(key[1])
            rec(x.kids[len(x.keys)])

        rec(self.root)
        return out


def mem_chain(opt: MemOpt, fm: FMIndex, length: int, intvs: list[Intv],
              sa_lookup=None) -> list[Chain]:
    """Seeds -> chains (bwamem.c:260-324). ``intvs`` is collect_intv output.

    ``sa_lookup(x0, k)`` resolves the SA value of interval row x0+k; defaults
    to the golden LF-walk. The device path passes precomputed values."""
    bns = fm.bns
    l_pac = bns.l_pac
    if length < opt.min_seed_len:
        return []
    if sa_lookup is None:
        sa_lookup = lambda x0, k: fmops.bwt_sa(fm, x0 + k)
    # frac_rep from over-occurring intervals
    b = e = l_rep = 0
    for p in intvs:
        if p.s <= opt.max_occ:
            continue
        sb, se = p.start, p.end
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b

    tree = _KBTree()
    n_put = 0
    for p in intvs:
        slen = p.end - p.start
        step = p.s // opt.max_occ if p.s > opt.max_occ else 1
        k = 0
        count = 0
        while k < p.s and count < opt.max_occ:
            rbeg = sa_lookup(p.x0, k)
            s = Seed(rbeg=rbeg, qbeg=p.start, len=slen, score=slen)
            rid = bns.intv2rid(rbeg, rbeg + slen)
            k += step
            count += 1
            if rid < 0:
                continue  # bridges contigs or the fw-rev boundary
            to_add = False
            if n_put:
                lower, _upper = tree.interval(rbeg)
                if lower is None or not test_and_merge(opt, l_pac, lower,
                                                       s, rid):
                    to_add = True
            else:
                to_add = True
            if to_add:
                c = Chain(pos=rbeg, rid=rid,
                          is_alt=int(bool(bns.anns[rid].is_alt)), seeds=[s])
                tree.put(rbeg, c)
                n_put += 1
    chains = tree.traverse()
    for c in chains:
        c.frac_rep = l_rep / length
    return chains


def mem_chain_flt(opt: MemOpt, chains: list[Chain]) -> list[Chain]:
    """bwamem.c:336-394."""
    if not chains:
        return []
    a = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            a.append(c)
    if not a:
        return []
    ks_introsort(a, lambda x, y: x.w > y.w)  # flt_lt (bwamem.c:333)

    def chn_beg(ch):
        return ch.seeds[0].qbeg

    def chn_end(ch):
        return ch.seeds[-1].qbeg + ch.seeds[-1].len

    kept_idx = [0]
    a[0].kept = 3
    for i in range(1, len(a)):
        large_ovlp = False
        broke = False
        for j in kept_idx:
            b_max = max(chn_beg(a[j]), chn_beg(a[i]))
            e_min = min(chn_end(a[j]), chn_end(a[i]))
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = chn_end(a[i]) - chn_beg(a[i])
                lj = chn_end(a[j]) - chn_beg(a[j])
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (a[i].w < a[j].w * opt.drop_ratio
                            and a[j].w - a[i].w >= opt.min_seed_len << 1):
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap the number of kept=1/2 chains to extend (bwamem.c:382-387): from
    # the chain that hits the cap onward, drop everything below kept=3
    k = 0
    cut = len(a)
    for i, c in enumerate(a):
        if c.kept == 0 or c.kept == 3:
            continue
        k += 1
        if k >= opt.max_chain_extend:
            cut = i
            break
    for i in range(cut, len(a)):
        if a[i].kept < 3:
            a[i].kept = 0
    return [c for c in a if c.kept != 0]


def mem_seed_sw(opt: MemOpt, fm: FMIndex, l_query: int, query: np.ndarray,
                s: Seed) -> int:
    """bwamem.c:580-605."""
    bns = fm.bns
    l_pac = bns.l_pac
    if s.len >= MEM_SHORT_LEN:
        return -1
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rseq, rid, rb, re = bns.fetch_seq(rb, mid, re)
    r = ksw.ksw_align2(qe - qb, query[qb:qe].copy(), re - rb, rseq, opt.mat,
                       opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                       ksw.KSW_XSTART)
    return r.score


def mem_flt_chained_seeds(opt: MemOpt, fm: FMIndex, l_query: int,
                          query: np.ndarray, chains: list[Chain]) -> None:
    """bwamem.c:607-624 (no-op for short reads)."""
    min_l = (MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight
             else MEM_MINSC_COEF * math.log(l_query))
    if min_l > MEM_SEEDSW_COEF * l_query:
        return
    min_hsp_score = int(opt.a * min_l + 0.499)
    for c in chains:
        kept = []
        for s in c.seeds:
            s.score = mem_seed_sw(opt, fm, l_query, query, s)
            if s.score < 0 or s.score >= min_hsp_score:
                s.score = s.len * opt.a if s.score < 0 else s.score
                kept.append(s)
        c.seeds = kept
