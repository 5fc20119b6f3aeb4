"""SAM record emission with bwa-mem-exact formatting.

Reimplements mem_aln2sam (bwa/bwamem.c:824-961), mem_reg2sam (:1018-1064)
and mem_gen_alt (bwa/bwamem_extra.c:90-144).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..index.fmindex import FMIndex
from ..ops.align import Aln, mem_reg2aln
from ..ops.region import AlnReg
from ..utils.opts import (MEM_F_ALL, MEM_F_NO_MULTI, MEM_F_REF_HDR,
                          MEM_F_SOFTCLIP, MEM_F_XB, MemOpt)

_FWD = "ACGTN"
_REV = "TGCAN"
CIGAR_CHARS = "MIDSH"
CIGAR_CHARS_N = "MIDSHN"


@dataclasses.dataclass
class Read:
    """bseq1_t equivalent: one sequenced read."""

    name: str
    seq: np.ndarray                 # uint8 nt4 codes (0-4)
    qual: str | None = None
    comment: str | None = None
    id: int = 0
    sam: str = ""

    @property
    def l_seq(self) -> int:
        return len(self.seq)


def _get_rlen(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (0, 2))


def _cigar_str(opt: MemOpt, p: Aln, which: int) -> str:
    """add_cigar (bwamem.c:824-835)."""
    if not p.cigar:
        return "*"
    out = []
    for op, ln in p.cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{CIGAR_CHARS[c]}")
    return "".join(out)


def mem_aln2sam(opt: MemOpt, fm: FMIndex, s: Read, n: int, alns: list[Aln],
                which: int, m_: Aln | None, rg_id: str = "") -> str:
    """One SAM line for alns[which] (bwamem.c:837-961)."""
    bns = fm.bns
    p = dataclasses.replace(alns[which])
    m = dataclasses.replace(m_) if m_ is not None else None
    p.flag |= 0x1 if m else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m and m.rid < 0) else 0
    if p.rid < 0 and m and m.rid >= 0:  # copy mate to alignment
        p.rid, p.pos, p.is_rev, p.cigar = m.rid, m.pos, m.is_rev, []
    if m and m.rid < 0 and p.rid >= 0:  # copy alignment to mate
        m.rid, m.pos, m.is_rev, m.cigar = p.rid, p.pos, p.is_rev, []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m and m.is_rev) else 0

    out = [s.name, str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0))]
    if p.rid >= 0:
        out.append(bns.anns[p.rid].name)
        out.append(str(p.pos + 1))
        out.append(str(p.mapq))
        out.append(_cigar_str(opt, p, which))
    else:
        out.extend(["*", "0", "0", "*"])
    if m and m.rid >= 0:
        out.append("=" if p.rid == m.rid else bns.anns[m.rid].name)
        out.append(str(m.pos + 1))
        if p.rid == m.rid:
            p0 = p.pos + (_get_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (_get_rlen(m.cigar) - 1 if m.is_rev else 0)
            if not m.cigar or not p.cigar:
                out.append("0")
            else:
                sign = 1 if p0 > p1 else (-1 if p0 < p1 else 0)
                out.append(str(-(p0 - p1 + sign)))
        else:
            out.append("0")
    else:
        out.extend(["*", "0", "0"])

    # SEQ and QUAL
    if p.flag & 0x100:
        out.extend(["*", "*"])
    else:
        qb, qe = 0, s.l_seq
        clip = (p.cigar and which and not (opt.flag & MEM_F_SOFTCLIP)
                and not p.is_alt)
        if not p.is_rev:
            if clip:
                if p.cigar[0][0] in (3, 4):
                    qb += p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qe -= p.cigar[-1][1]
            out.append("".join(_FWD[c] for c in s.seq[qb:qe]))
            out.append(s.qual[qb:qe] if s.qual else "*")
        else:
            if clip:
                if p.cigar[0][0] in (3, 4):
                    qe -= p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qb += p.cigar[-1][1]
            out.append("".join(_REV[c] for c in s.seq[qe - 1:None if qb == 0 else qb - 1:-1]))
            out.append(s.qual[qe - 1:None if qb == 0 else qb - 1:-1] if s.qual else "*")

    line = "\t".join(out)
    # optional tags
    if p.cigar:
        line += f"\tNM:i:{p.NM}\tMD:Z:{p.MD}"
    if m and m.cigar:
        line += "\tMC:Z:" + _cigar_str(opt, m, which)
    if p.score >= 0:
        line += f"\tAS:i:{p.score}"
    if p.sub >= 0:
        line += f"\tXS:i:{p.sub}"
    if rg_id:
        line += f"\tRG:Z:{rg_id}"
    if not (p.flag & 0x100):
        others = [i for i in range(n) if i != which and not (alns[i].flag & 0x100)]
        if others:
            sa = []
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                cig = "".join(f"{ln}{CIGAR_CHARS[op]}" for op, ln in r.cigar)
                sa.append(f"{bns.anns[r.rid].name},{r.pos + 1},"
                          f"{'+-'[r.is_rev]},{cig},{r.mapq},{r.NM};")
            line += "\tSA:Z:" + "".join(sa)
        if p.alt_sc > 0:
            line += f"\tpa:f:{p.score / p.alt_sc:.3f}"
    if p.XA:
        line += ("\tXB:Z:" if opt.flag & MEM_F_XB else "\tXA:Z:") + p.XA
    if s.comment:
        line += "\t" + s.comment
    if (opt.flag & MEM_F_REF_HDR) and p.rid >= 0 and bns.anns[p.rid].anno:
        line += "\tXR:Z:" + bns.anns[p.rid].anno.replace("\t", " ")
    return line + "\n"


def get_pri_idx(xa_drop_ratio: float, a: list[AlnReg], i: int) -> int:
    k = a[i].secondary_all
    if k >= 0 and a[i].score >= a[k].score * xa_drop_ratio:
        return k
    return -1


def mem_gen_alt(opt: MemOpt, fm: FMIndex, a: list[AlnReg], l_query: int,
                query: np.ndarray) -> list[str | None]:
    """XA strings per primary hit (bwamem_extra.c:98-144)."""
    n = len(a)
    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = get_pri_idx(opt.XA_drop_ratio, a, i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if a[i].is_alt:
                has_alt[r] = True
    XA: list[str | None] = [None] * n
    if tot == 0:
        return XA
    aln = [""] * n
    for i in range(n):
        r = get_pri_idx(opt.XA_drop_ratio, a, i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or (not has_alt[r] and cnt[r] > opt.max_XA_hits):
            continue
        t = mem_reg2aln(opt, fm, l_query, query, a[i])
        cig = "".join(f"{ln}{CIGAR_CHARS_N[op]}" for op, ln in t.cigar)
        entry = (f"{fm.bns.anns[t.rid].name},{'+-'[t.is_rev]}{t.pos + 1},"
                 f"{cig},{t.NM}")
        if opt.flag & MEM_F_XB:
            entry += f",{t.score}"
        aln[r] += entry + ";"
    for k in range(n):
        XA[k] = aln[k] if aln[k] else None
    return XA


def mem_reg2sam(opt: MemOpt, fm: FMIndex, s: Read, a: list[AlnReg],
                extra_flag: int, m: Aln | None, rg_id: str = "") -> None:
    """bwamem.c:1018-1064; appends SAM line(s) to s.sam."""
    XA = None
    if not (opt.flag & MEM_F_ALL):
        XA = mem_gen_alt(opt, fm, a, s.l_seq, s.seq)
    aa: list[Aln] = []
    keep_idx: list[int] = []
    l = 0
    for k, p in enumerate(a):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (0 <= p.secondary < (1 << 31) - 1
                and p.score < a[p.secondary].score * opt.drop_ratio):
            continue
        q = mem_reg2aln(opt, fm, s.l_seq, s.seq, p)
        assert q.rid >= 0
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1  # don't output sub-optimal score
        if l and p.secondary < 0:  # supplementary
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if (not (opt.flag & 0x1000) and l and not p.is_alt
                and q.mapq > aa[0].mapq):
            q.mapq = aa[0].mapq
        l += 1
        aa.append(q)
        keep_idx.append(k)
    if not aa:
        t = mem_reg2aln(opt, fm, s.l_seq, s.seq, None)
        t.flag |= extra_flag
        s.sam += mem_aln2sam(opt, fm, s, 1, [t], 0, m, rg_id)
    else:
        for k in range(len(aa)):
            s.sam += mem_aln2sam(opt, fm, s, len(aa), aa, k, m, rg_id)
