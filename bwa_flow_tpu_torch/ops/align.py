"""Final alignment construction: banded global CIGAR, NM/MD, mem_reg2aln.

Reimplements bwa_gen_cigar2 (bwa/bwa.c:121-207), infer_bw
(bwa/bwamem.c:801-808) and mem_reg2aln (bwa/bwamem.c:1104-1174).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..index.fmindex import FMIndex
from ..utils.opts import MemOpt
from . import ksw
from .region import AlnReg, mem_approx_mapq_se

CIGAR_OPS = "MIDSH"


@dataclasses.dataclass
class Aln:
    """mem_aln_t equivalent (bwa/bwamem.h:90-100)."""

    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    is_alt: int = 0
    mapq: int = 0
    NM: int = -1
    cigar: list = dataclasses.field(default_factory=list)  # [(op, len)]
    MD: str = ""
    XA: str | None = None
    score: int = -1
    sub: int = -1
    alt_sc: int = 0


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """bwamem.c:801-808."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar2(opt_mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
               e_ins: int, w_: int, fm: FMIndex, l_query: int,
               query: np.ndarray, rb: int, re: int, want_cigar: bool = True
               ) -> tuple[int, list, int, str]:
    """bwa_gen_cigar2: returns (score, cigar [(op,len)], NM, MD).

    query is the nt4-coded sub-query [qb:qe]; rb/re in fw-rev coordinates."""
    bns = fm.bns
    l_pac = bns.l_pac
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return 0, [], -1, ""
    rseq = bns.get_seq(rb, re)
    rlen = len(rseq)
    if re - rb != rlen:
        return 0, [], -1, ""
    if rb >= l_pac:  # reverse both to left-align indels in fwd coordinates
        query = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == re - rb and w_ == 0:  # no-gap shortcut (bwa.c:141-149)
        cigar = [(0, l_query)] if want_cigar else []
        score = int(sum(int(opt_mat[rseq[i], query[i]]) for i in range(l_query)))
    else:
        max_ins = int((((l_query + 1) >> 1) * int(opt_mat[0, 0]) - o_ins) / e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * int(opt_mat[0, 0]) - o_del) / e_del + 1.0)
        max_gap = max(max_ins, max_del, 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        min_w = abs(rlen - l_query) + 3
        w = max(w, min_w)
        score, cigar = ksw.ksw_global2(l_query, query, rlen, rseq, opt_mat,
                                       o_del, e_del, o_ins, e_ins, w,
                                       want_cigar=want_cigar)
    NM = -1
    md = ""
    if want_cigar:  # compute NM and MD (bwa.c:169-199)
        n_mm = n_gap = 0
        int2base = "ACGTN" if rb < l_pac else "TGCAN"
        x = y = u = 0
        parts = []
        for k, (op, ln) in enumerate(cigar):
            if op == 0:  # match
                for i in range(ln):
                    if query[x + i] != rseq[y + i]:
                        parts.append(str(u))
                        parts.append(int2base[rseq[y + i]])
                        n_mm += 1
                        u = 0
                    else:
                        u += 1
                x += ln
                y += ln
            elif op == 2:  # deletion
                if 0 < k < len(cigar) - 1:  # not at cigar edges
                    parts.append(str(u))
                    parts.append("^")
                    parts.extend(int2base[rseq[y + i]] for i in range(ln))
                    u = 0
                    n_gap += ln
                y += ln
            elif op == 1:  # insertion
                x += ln
                n_gap += ln
        parts.append(str(u))
        md = "".join(parts)
        NM = n_mm + n_gap
    return score, cigar, NM, md


def mem_reg2aln(opt: MemOpt, fm: FMIndex, l_query: int, query: np.ndarray,
                ar: AlnReg | None) -> Aln:
    """bwamem.c:1104-1174."""
    bns = fm.bns
    a = Aln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        # reference memsets mem_aln_t to zero (bwamem.c:1106-1112), so
        # unmapped records carry score=0/sub=0 and emit AS:i:0 XS:i:0
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        a.score = 0
        a.sub = 0
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = mem_approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins)
    w2 = max(w2, tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    i = 0
    NM = -1
    cigar: list = []
    md = ""
    score = 0
    while True:
        w2 = min(w2, opt.w << 2)
        score, cigar, NM, md = gen_cigar2(opt.mat, opt.o_del, opt.e_del,
                                          opt.o_ins, opt.e_ins, w2, fm,
                                          qe - qb, query[qb:qe].copy(), rb, re)
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if i >= 3 or score >= ar.truesc - opt.a:
            break
    a.NM = NM
    a.MD = md
    pos, is_rev = bns.depos(rb if rb < bns.l_pac else re - 1)
    a.is_rev = int(is_rev)
    if cigar:  # squeeze out leading/trailing deletions
        if cigar[0][0] == 2:
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # add clipping
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    a.cigar = cigar
    a.rid = bns.pos2rid(pos)
    assert a.rid == ar.rid
    a.pos = pos - bns.anns[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a
