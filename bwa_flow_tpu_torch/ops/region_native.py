"""Native tail-stage wrapper: batched dedup/primary/MAPQ/CIGAR/SAM in C++.

Port of bwa_flow_tpu/ops/region_native.py onto the port's own copy of the
extension (csrc/host/_region.cpp, a byte-exact C++ port of ops/region.py
+ ops/align.py + io/sam.py's SE path, and the PE tail: dedup, pestat,
mate rescue, pairing, SAM), built and loaded by _build.host_module. Its
batch calls release the GIL, so the tail thread overlaps the device
driver. se_tail_ok/pe_tail_ok send the XR (-V) annotation tag and
qual-less reads to the Python tail.
"""

from __future__ import annotations

import weakref

import numpy as np

from .. import _build
from ..index.fmindex import FMIndex
from ..utils.opts import MEM_F_REF_HDR, MemOpt
from .region import AlnReg

_REG_NF = 12


def ext():
    """The _region extension module (built at first use)."""
    return _build.host_module("_region")


# id(index) -> (weak reference to it, its arrays); an entry goes when its
# index is freed, so an index that later gets the same id never meets it
_BNS: dict = {}


def bns_arrays(fm: FMIndex) -> dict:
    """The contig and reference arrays the native stages take, made once
    an index and shared by the three wrappers: ann_off, ann_alt,
    name_cat, name_off and pac; wave_native adds its RefBlock capsule
    ("ref")."""
    key = id(fm)
    c = _BNS.get(key)
    if c is None or c[0]() is not fm:
        anns = fm.bns.anns
        names = [a.name.encode() for a in anns]
        name_off = np.zeros(len(names) + 1, np.int64)
        for i, nm in enumerate(names):
            name_off[i + 1] = name_off[i] + len(nm)
        c = (weakref.ref(fm), dict(
            ann_off=np.array([a.offset for a in anns], np.int64),
            ann_alt=np.array([1 if a.is_alt else 0 for a in anns],
                             np.uint8),
            name_cat=b"".join(names), name_off=name_off,
            pac=np.ascontiguousarray(fm.bns.pac, np.uint8)))
        _BNS[key] = c
        weakref.finalize(fm, _BNS.pop, key, None)
    return c[1]


def _opt_arrays(opt: MemOpt):
    opti = np.array([opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins,
                     opt.e_ins, opt.w, opt.T, opt.flag, opt.min_seed_len,
                     opt.max_chain_gap, opt.max_XA_hits,
                     opt.max_XA_hits_alt, opt.mapQ_coef_fac], np.int64)
    optf = np.array([opt.mask_level, opt.mask_level_redun, opt.drop_ratio,
                     opt.XA_drop_ratio, opt.mapQ_coef_len], np.float64)
    mat = np.ascontiguousarray(opt.mat[:5, :5], np.int8)
    return opti, optf, mat


def pack_regs(reg_lists) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """AlnReg lists -> (rows int64[NR,12], frac f64[NR], off int64[n+1])."""
    n = len(reg_lists)
    off = np.zeros(n + 1, np.int64)
    total = sum(len(r) for r in reg_lists)
    rows = np.zeros((total, _REG_NF), np.int64)
    frac = np.zeros(total, np.float64)
    w = 0
    for r, regs in enumerate(reg_lists):
        for p in regs:
            rows[w] = (p.rb, p.re, p.qb, p.qe, p.rid, p.score, p.truesc,
                       p.w, p.seedcov, p.seedlen0, p.csub, p.is_alt)
            frac[w] = p.frac_rep
            w += 1
        off[r + 1] = w
    return rows, frac, off


def unpack_regs(rows_b, frac_b, off_b) -> list:
    """bytes or ndarray packed regions -> AlnReg lists."""
    rows = np.frombuffer(rows_b, np.int64).reshape(-1, _REG_NF) \
        if isinstance(rows_b, bytes) else rows_b.reshape(-1, _REG_NF)
    frac = np.frombuffer(frac_b, np.float64) \
        if isinstance(frac_b, bytes) else frac_b
    off = np.frombuffer(off_b, np.int64) \
        if isinstance(off_b, bytes) else off_b
    out = []
    for r in range(len(off) - 1):
        regs = []
        for i in range(off[r], off[r + 1]):
            f = rows[i]
            regs.append(AlnReg(
                rb=int(f[0]), re=int(f[1]), qb=int(f[2]), qe=int(f[3]),
                rid=int(f[4]), score=int(f[5]), truesc=int(f[6]),
                w=int(f[7]), seedcov=int(f[8]), seedlen0=int(f[9]),
                csub=int(f[10]), is_alt=int(f[11]),
                frac_rep=float(frac[i]), n_comp=1))
        out.append(regs)
    return out


def se_tail_ok(opt: MemOpt, reads) -> bool:
    """Native SE tail handles the default emission path; the rare XR
    (-V) annotation tag and qual-less (FASTA) reads take Python."""
    if opt.flag & MEM_F_REF_HDR:
        return False
    return all(r.qual is not None for r in reads)


pe_tail_ok = se_tail_ok


def _read_arrays(reads):
    """(seq_cat, seq_off, qual_cat, name_cat, name_off, com_cat, com_off,
    ids) of a batch of reads."""
    n = len(reads)
    seq_off = np.zeros(n + 1, np.int64)
    for i, r in enumerate(reads):
        seq_off[i + 1] = seq_off[i] + len(r.seq)
    seq_cat = np.concatenate([np.ascontiguousarray(r.seq, np.uint8)
                              for r in reads]) if n else \
        np.zeros(0, np.uint8)
    qual_cat = "".join(r.qual for r in reads).encode()
    names = [r.name.encode() for r in reads]
    name_off = np.zeros(n + 1, np.int64)
    for i, nm in enumerate(names):
        name_off[i + 1] = name_off[i] + len(nm)
    name_cat = b"".join(names)
    comments = [(r.comment or "").encode() for r in reads]
    com_off = np.zeros(n + 1, np.int64)
    for i, cm in enumerate(comments):
        com_off[i + 1] = com_off[i] + len(cm)
    com_cat = b"".join(comments)
    ids = np.array([r.id for r in reads], np.int64)
    return (seq_cat, seq_off, qual_cat, name_cat, name_off, com_cat,
            com_off, ids)


def _regs_arrays(reg_lists, packed):
    if packed is not None:
        rows, frac, off = packed
        return np.ascontiguousarray(rows.reshape(-1, _REG_NF)), frac, off
    rows, frac, off = pack_regs(reg_lists)
    return np.ascontiguousarray(rows), frac, off


_TAIL_PHASES = ("dedup", "rescue", "pair", "sam")


def _count(counters: dict | None, names, values) -> None:
    """Add a native tail's counters to `counters`: the phases' seconds
    (the C++ gives nanoseconds) under their names, then the counts."""
    if counters is None:
        return
    for k, v in zip(names, values):
        v = float(v) * 1e-9 if k in _TAIL_PHASES else int(v)
        counters[k] = counters.get(k, 0) + v


def se_tail_batch(opt: MemOpt, fm: FMIndex, reads, reg_lists,
                  rg_id: str = "", packed=None,
                  counters: dict | None = None) -> list[str]:
    """SAM text per read: dedup + alt flags + primary + (-5 reorder) +
    reg2sam, all native. `packed=(rows, frac, off)` skips AlnReg
    marshaling entirely (native wave driver output feeds straight in).
    `counters`, if given, gains the seconds the C++ spent in "dedup" and
    in "sam" (primary marking and the records)."""
    rows, frac, off = _regs_arrays(reg_lists, packed)
    b = bns_arrays(fm)
    opti, optf, mat = _opt_arrays(opt)
    sams, ctr = ext().se_tail_batch(
        *_read_arrays(reads), rows, frac, off, b["pac"], fm.bns.l_pac,
        b["ann_off"], b["ann_alt"], b["name_cat"], b["name_off"],
        rg_id.encode(), opti, optf, mat)
    _count(counters, ("dedup", "sam"), np.frombuffer(ctr, np.int64))
    return [s.decode() for s in sams]


def dedup_batch(opt: MemOpt, fm: FMIndex, seqs, reg_lists) -> list:
    """Native dedup/patch (+ALT flagging) for PE phase 1; returns AlnReg
    lists."""
    n = len(seqs)
    seq_off = np.zeros(n + 1, np.int64)
    for i, s in enumerate(seqs):
        seq_off[i + 1] = seq_off[i] + len(s)
    seq_cat = np.concatenate([np.ascontiguousarray(s, np.uint8)
                              for s in seqs]) if n else np.zeros(0, np.uint8)
    rows, frac, off = pack_regs(reg_lists)
    b = bns_arrays(fm)
    opti, optf, mat = _opt_arrays(opt)
    rows_b, frac_b, off_b = ext().dedup_batch(
        seq_cat, seq_off, np.ascontiguousarray(rows), frac, off, b["pac"],
        fm.bns.l_pac, b["ann_off"], b["ann_alt"], opti, optf, mat)
    return unpack_regs(rows_b, frac_b, off_b)


def _pes_array(pes) -> np.ndarray:
    out = np.zeros(20, np.float64)
    for d in range(4):
        p = pes[d]
        out[d * 5:d * 5 + 5] = (p.low, p.high, p.failed, p.avg, p.std)
    return out


def pe_tail_batch(opt: MemOpt, fm: FMIndex, reads, reg_lists,
                  rg_id: str = "", packed=None, pes0=None,
                  counters: dict | None = None):
    """PE tail fully native: dedup + per-batch pestat + mate rescue +
    pairing + SAM for interleaved pairs; GIL released throughout.
    Returns (sams list[str], pes list[PeStat] actually used).
    `counters`, if given, gains the seconds the C++ spent in "dedup"
    (with the insert-size estimate), "rescue", "pair" and "sam", the
    rescue's ksw_align2 calls ("matesw"), those of them that ran the
    striped pass ("matesw_vec") and the pairs ("pairs")."""
    from .pe import PeStat
    rows, frac, off = _regs_arrays(reg_lists, packed)
    b = bns_arrays(fm)
    opti, optf, mat = _opt_arrays(opt)
    pe_ints = np.array([opt.pen_unpaired, opt.max_matesw, opt.max_ins],
                       np.int64)
    pes_in = _pes_array(pes0) if pes0 is not None else None
    sams, pes_b, ctr = ext().pe_tail_batch(
        *_read_arrays(reads), rows, frac, off, b["pac"], fm.bns.l_pac,
        b["ann_off"], b["ann_alt"], b["name_cat"], b["name_off"],
        rg_id.encode(), opti, optf, mat, pe_ints, pes_in)
    _count(counters, _TAIL_PHASES + ("matesw", "matesw_vec", "pairs"),
           np.frombuffer(ctr, np.int64))
    pv = np.frombuffer(pes_b, np.float64)
    pes_used = [PeStat(low=int(pv[d * 5]), high=int(pv[d * 5 + 1]),
                       failed=int(pv[d * 5 + 2]), avg=float(pv[d * 5 + 3]),
                       std=float(pv[d * 5 + 4])) for d in range(4)]
    return [s.decode() for s in sams], pes_used
