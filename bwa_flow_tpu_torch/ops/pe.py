"""Paired-end pairing: insert-size stats, mate rescue, pair scoring, PE SAM.

Reimplements bwa/bwamem_pair.c: mem_infer_dir (:26-33), cal_sub (:35-47),
mem_pestat (:49-112), mem_matesw (:114-183), mem_pair (:185-246),
mem_sam_pe (:253-396).

Host code, copied from bwa_flow_tpu/ops/pe.py onto the port's modules;
mate rescue runs the host ksw_align2 (ops/ksw.py), with no device kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..index.fmindex import FMIndex
from ..io.sam import Read, mem_aln2sam, mem_gen_alt, mem_reg2sam
from ..ops import ksw
from ..ops.align import mem_reg2aln
from ..ops.region import (AlnReg, hash_64, mem_approx_mapq_se,
                          mem_mark_primary_se, mem_reorder_primary5,
                          mem_sort_dedup_patch)
from ..utils.opts import (MEM_F_ALL, MEM_F_NO_RESCUE, MEM_F_NOPAIRING,
                          MEM_F_PRIMARY5, MemOpt)

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


@dataclasses.dataclass
class PeStat:
    low: int = 0
    high: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0


def mem_infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """Returns (dir, dist); dir in FF/FR/RF/RR encoding (pair.c:26-33)."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def _cal_sub(opt: MemOpt, r: list[AlnReg]) -> int:
    for j in range(1, len(r)):
        b_max = max(r[j].qb, r[0].qb)
        e_min = min(r[j].qe, r[0].qe)
        if e_min > b_max:
            min_l = min(r[j].qe - r[j].qb, r[0].qe - r[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return r[j].score
    return opt.min_seed_len * opt.a


def mem_pestat(opt: MemOpt, l_pac: int, regs: list[list[AlnReg]]
               ) -> list[PeStat]:
    """Infer the insert-size distribution per orientation from one batch
    (pair.c:49-112). regs is interleaved per-read region lists."""
    pes = [PeStat() for _ in range(4)]
    isize: list[list[int]] = [[], [], [], []]
    n = len(regs)
    for i in range(n >> 1):
        r0, r1 = regs[i << 1 | 0], regs[i << 1 | 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = mem_infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    for d in range(4):
        r = pes[d]
        q = sorted(isize[d])
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            continue
        p25 = q[int(0.25 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        vals = [v for v in q if r.low <= v <= r.high]
        r.avg = sum(vals) / len(vals)
        r.std = math.sqrt(sum((v - r.avg) ** 2 for v in q
                              if r.low <= v <= r.high) / len(vals))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        r.low = max(r.low, 1)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
    return pes


def mem_matesw(opt: MemOpt, fm: FMIndex, pes: list[PeStat], a: AlnReg,
               l_ms: int, ms: np.ndarray, ma: list[AlnReg]) -> tuple[int, list[AlnReg]]:
    """Mate rescue SW (pair.c:114-183). Returns (n, updated ma list)."""
    bns = fm.bns
    l_pac = bns.l_pac
    skip = [p.failed != 0 for p in pes]
    for p in ma:
        r, dist = mem_infer_dir(l_pac, a.rb, p.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = True
    if all(skip):
        return 0, ma
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
        else:
            seq = ms
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        rid = -1
        ref = None
        if rb < re:
            ref, rid, rb, re = bns.fetch_seq(rb, (rb + re) >> 1, re)
        if a.rid == rid and re - rb >= opt.min_seed_len:
            xtra = (ksw.KSW_XSUBO | ksw.KSW_XSTART
                    | (ksw.KSW_XBYTE if l_ms * opt.a < 250 else 0)
                    | (opt.min_seed_len * opt.a))
            aln = ksw.ksw_align2(l_ms, seq.copy(), re - rb, ref, opt.mat,
                                 opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                                 xtra)
            if aln.score >= opt.min_seed_len and aln.qb >= 0:
                b = AlnReg()
                b.rid = a.rid
                b.is_alt = a.is_alt
                b.qb = l_ms - (aln.qe + 1) if is_rev else aln.qb
                b.qe = l_ms - aln.qb if is_rev else aln.qe + 1
                b.rb = ((l_pac << 1) - (rb + aln.te + 1)) if is_rev else rb + aln.tb
                b.re = ((l_pac << 1) - (rb + aln.tb)) if is_rev else rb + aln.te + 1
                b.score = aln.score
                b.csub = aln.score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insert keeping ma sorted by score desc (pair.c:168-174)
                ins = len(ma)
                for i in range(len(ma)):
                    if ma[i].score < b.score:
                        ins = i
                        break
                ma.insert(ins, b)
            n += 1
        if n:
            ma = mem_sort_dedup_patch(opt, None, None, ma, None)
    return n, ma


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def mem_pair(opt: MemOpt, fm: FMIndex, pes: list[PeStat],
             a: list[list[AlnReg]], rid_: int, n_pri: list[int]
             ) -> tuple[int, int, int, list[int]]:
    """Pair scoring (pair.c:185-246). Returns (score, sub, n_sub, z)."""
    bns = fm.bns
    l_pac = bns.l_pac
    v = []  # (x, y) pairs
    for r in range(2):
        for i in range(n_pri[r]):
            e = a[r][i]
            key_x = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            key_x = (e.rid << 32) | (key_x - bns.anns[e.rid].offset)
            key_y = (e.score << 32) | (i << 2) | (int(e.rb >= l_pac) << 1) | r
            v.append((key_x, key_y))
    v.sort()
    u = []
    y = [-1, -1, -1, -1]
    for i in range(len(v)):
        for r in range(2):
            dr = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[dr].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dr].high:
                    break
                if dist < pes[dr].low:
                    continue
                if pes[dr].std != 0.0:
                    ns = (dist - pes[dr].avg) / pes[dr].std
                    erfc2 = max(2.0 * math.erfc(abs(ns) / math.sqrt(2.0)),
                                5e-324)
                    q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                            + 0.721 * math.log(erfc2) * opt.a + 0.499)
                    q = max(q, 0)
                else:
                    # C semantics for a degenerate (std==0) insert
                    # distribution: ns is +-inf/nan, log(2*erfc(|ns|))
                    # -> -inf/nan, and the int cast clamps to q = 0
                    q = 0
                pair_y = (k << 32) | i
                pair_x = (q << 32) | (hash_64((pair_y ^ (rid_ << 8))
                                              & ((1 << 64) - 1)) & 0xFFFFFFFF)
                u.append((pair_x, pair_y))
        y[v[i][1] & 3] = i
    z = [-1, -1]
    if u:
        tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
        u.sort()
        i = u[-1][1] >> 32
        k = u[-1][1] & 0xFFFFFFFF
        # y<<32>>34 in uint64 = (y & 0xffffffff) >> 2 = the region index i
        z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
        z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
        ret = u[-1][0] >> 32
        sub = (u[-2][0] >> 32) if len(u) > 1 else 0
        n_sub = sum(1 for j in range(len(u) - 2, -1, -1)
                    if sub - (u[j][0] >> 32) <= tmp)
        return ret, sub, n_sub, z
    return 0, 0, 0, z


def mem_sam_pe(opt: MemOpt, fm: FMIndex, pes: list[PeStat], rid_: int,
               s: list[Read], a: list[list[AlnReg]], rg_id: str = "") -> int:
    """PE finalization: rescue, pairing, SAM for both ends (pair.c:253-396)."""
    n = 0
    extra_flag = 1
    if not (opt.flag & MEM_F_NO_RESCUE):
        b: list[list[AlnReg]] = [[], []]
        for i in range(2):
            for reg in a[i]:
                if a[i] and reg.score >= a[i][0].score - opt.pen_unpaired:
                    b[i].append(reg)
        for i in range(2):
            for j in range(min(len(b[i]), opt.max_matesw)):
                cnt, a[1 - i] = mem_matesw(opt, fm, pes, b[i][j],
                                           s[1 - i].l_seq, s[1 - i].seq,
                                           a[1 - i])
                n += cnt
    n_pri = [mem_mark_primary_se(opt, a[0], (rid_ << 1 | 0) & ((1 << 64) - 1)),
             mem_mark_primary_se(opt, a[1], (rid_ << 1 | 1) & ((1 << 64) - 1))]
    if opt.flag & MEM_F_PRIMARY5:
        mem_reorder_primary5(opt.T, a[0])
        mem_reorder_primary5(opt.T, a[1])
    if not (opt.flag & MEM_F_NOPAIRING):
        o, subo, n_sub, z = (mem_pair(opt, fm, pes, a, rid_, n_pri)
                             if n_pri[0] and n_pri[1] else (0, 0, 0, [-1, -1]))
        if n_pri[0] and n_pri[1] and o > 0:
            # multiple good hits on either end?
            is_multi = [False, False]
            for i in range(2):
                for j in range(1, n_pri[i]):
                    if a[i][j].secondary < 0 and a[i][j].score >= opt.T:
                        is_multi[i] = True
                        break
            if not is_multi[0] and not is_multi[1]:
                return _sam_pe_paired(opt, fm, pes, rid_, s, a, n_pri, o,
                                      subo, n_sub, z, n, rg_id)
    return _sam_pe_unpaired(opt, fm, pes, s, a, n_pri, extra_flag, n, rg_id)


def _sam_pe_paired(opt, fm, pes, rid_, s, a, n_pri, o, subo, n_sub, z, n,
                   rg_id):
    extra_flag = 1
    score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
    subo = max(subo, score_un)
    q_pe = raw_mapq(o - subo, opt.a)
    if n_sub > 0:
        q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
    q_pe = min(max(q_pe, 0), 60)
    q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep + a[1][0].frac_rep))
               + 0.499)
    q_se = [0, 0]
    if o > score_un:  # paired alignment preferred
        c = [a[0][z[0]], a[1][z[1]]]
        for i in range(2):
            if c[i].secondary >= 0:
                c[i].sub = a[i][c[i].secondary].score
                c[i].secondary = -2
            q_se[i] = mem_approx_mapq_se(opt, c[i])
        q_se[0] = q_se[0] if q_se[0] > q_pe else min(q_pe, q_se[0] + 40)
        q_se[1] = q_se[1] if q_se[1] > q_pe else min(q_pe, q_se[1] + 40)
        extra_flag |= 2
        q_se[0] = min(q_se[0], raw_mapq(c[0].score - c[0].csub, opt.a))
        q_se[1] = min(q_se[1], raw_mapq(c[1].score - c[1].csub, opt.a))
    else:  # unpaired preferred
        z = [0, 0]
        q_se[0] = mem_approx_mapq_se(opt, a[0][0])
        q_se[1] = mem_approx_mapq_se(opt, a[1][0])
    for i in range(2):
        k = a[i][z[i]].secondary_all
        if 0 <= k < n_pri[i]:  # switch secondary and primary
            assert a[i][k].secondary_all < 0
            for j in range(len(a[i])):
                if a[i][j].secondary_all == k or j == k:
                    a[i][j].secondary_all = z[i]
            a[i][z[i]].secondary_all = -1
    XA = [None, None]
    if not (opt.flag & MEM_F_ALL):
        for i in range(2):
            XA[i] = mem_gen_alt(opt, fm, a[i], s[i].l_seq, s[i].seq)
    h = [None, None]
    aa = [[], []]
    for i in range(2):
        h[i] = mem_reg2aln(opt, fm, s[i].l_seq, s[i].seq, a[i][z[i]])
        h[i].mapq = q_se[i]
        h[i].flag |= (0x40 << i) | extra_flag
        h[i].XA = XA[i][z[i]] if XA[i] else None
        aa[i].append(h[i])
        if n_pri[i] < len(a[i]):  # ALT hits
            p = a[i][n_pri[i]]
            if p.score < opt.T or p.secondary >= 0 or not p.is_alt:
                continue
            g = mem_reg2aln(opt, fm, s[i].l_seq, s[i].seq, p)
            g.flag |= 0x800 | (0x40 << i) | extra_flag
            g.XA = XA[i][n_pri[i]] if XA[i] else None
            aa[i].append(g)
    s[0].sam = "".join(
        mem_aln2sam(opt, fm, s[0], len(aa[0]), aa[0], i, h[1], rg_id)
        for i in range(len(aa[0])))
    s[1].sam = "".join(
        mem_aln2sam(opt, fm, s[1], len(aa[1]), aa[1], i, h[0], rg_id)
        for i in range(len(aa[1])))
    assert s[0].name == s[1].name, "paired reads have different names"
    return n


def _sam_pe_unpaired(opt, fm, pes, s, a, n_pri, extra_flag, n, rg_id):
    h = [None, None]
    for i in range(2):
        which = -1
        if a[i]:
            if a[i][0].score >= opt.T:
                which = 0
            elif n_pri[i] < len(a[i]) and a[i][n_pri[i]].score >= opt.T:
                which = n_pri[i]
        if which >= 0:
            h[i] = mem_reg2aln(opt, fm, s[i].l_seq, s[i].seq, a[i][which])
        else:
            h[i] = mem_reg2aln(opt, fm, s[i].l_seq, s[i].seq, None)
    if (not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid
            and h[0].rid >= 0 and a[0] and a[1]):
        d, dist = mem_infer_dir(fm.bns.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    s[0].sam = ""
    s[1].sam = ""
    mem_reg2sam(opt, fm, s[0], a[0], 0x41 | extra_flag, h[1], rg_id)
    mem_reg2sam(opt, fm, s[1], a[1], 0x81 | extra_flag, h[0], rg_id)
    assert s[0].name == s[1].name, "paired reads have different names"
    return n
