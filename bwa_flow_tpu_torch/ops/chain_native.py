"""Native chain-stage wrapper: batched seed chaining + filtering in C++.

Port of bwa_flow_tpu/ops/chain_native.py onto the port's own copy of the
extension (csrc/host/_chain.cpp, a C++ port of ops/chain.py including the
klib-introsort tie permutation), built and loaded by _build.host_module.
Reads the long-read seed-SW filter applies to (mem_flt_chained_seeds
would not be a no-op) come back as None and run through the Python
path.
"""

from __future__ import annotations

import numpy as np

from .. import _build
from ..index.fmindex import FMIndex
from ..utils.opts import MemOpt
from . import region_native
from .chain import Chain, Seed
from .probe_layout import sa_probe_layout


def ext():
    """The _chain extension module (built at first use)."""
    return _build.host_module("_chain")


def owners_for(opt: MemOpt, all_intvs) -> list:
    """Rebuild the owners triplets (lazy path for Python fallbacks)."""
    return sa_probe_layout(opt, all_intvs, build_owners=True)[2]


def intv_arrays(all_intvs) -> tuple[np.ndarray, ...]:
    """(iv_off, x0, sv, st, en) flat arrays for a batch of intervals —
    pass-through for IntvBatch, packing loop for Intv lists."""
    from .smem import IntvBatch
    if isinstance(all_intvs, IntvBatch):
        b = all_intvs
        return b.iv_off, b.x0, b.sv, b.st, b.en
    n = len(all_intvs)
    NI = sum(len(iv) for iv in all_intvs)
    iv_off = np.zeros(n + 1, np.int64)
    x0 = np.empty(NI, np.int64)
    sv = np.empty(NI, np.int64)
    st = np.empty(NI, np.int32)
    en = np.empty(NI, np.int32)
    i = 0
    for r, intvs in enumerate(all_intvs):
        for p in intvs:
            x0[i] = p.x0
            sv[i] = p.s
            info = p.info
            st[i] = info >> 32
            en[i] = info & 0xFFFFFFFF
            i += 1
        iv_off[r + 1] = i
    return iv_off, x0, sv, st, en


def ann_arrays(fm: FMIndex):
    """(contig offsets int64, is_alt uint8) of an index, made once."""
    b = region_native.bns_arrays(fm)
    return b["ann_off"], b["ann_alt"]


def chain_args(opt: MemOpt, fm: FMIndex, seqs, all_intvs,
               sa_vals: np.ndarray, sa_off: np.ndarray) -> tuple:
    """The arguments of the extension's chain_batch and
    chain_batch_packed."""
    n = len(seqs)
    l_query = np.fromiter((len(s) for s in seqs), np.int32, n)
    iv_off, x0, sv, st, en = intv_arrays(all_intvs)
    ann_off, ann_alt = ann_arrays(fm)
    return (l_query, iv_off, x0, sv, st, en,
            np.ascontiguousarray(sa_off, np.int64),
            np.ascontiguousarray(sa_vals, np.int64),
            ann_off, ann_alt, fm.bns.l_pac,
            opt.min_seed_len, opt.max_occ, opt.max_chain_gap, opt.w,
            opt.min_chain_weight, opt.max_chain_extend,
            float(opt.drop_ratio), float(opt.mask_level))


def chain_batch(opt: MemOpt, fm: FMIndex, seqs, all_intvs,
                sa_vals: np.ndarray, sa_off: np.ndarray) -> list:
    """Chains for a batch of reads; entries are lists of Chain, or None
    for reads that need the Python fallback. sa_vals/sa_off follow
    sa_probe_layout's enumeration."""
    anns = fm.bns.anns
    res = ext().chain_batch(*chain_args(opt, fm, seqs, all_intvs, sa_vals,
                                        sa_off))
    out = []
    for item in res:
        if item is None:
            out.append(None)
            continue
        frac_rep, clist = item
        chains = []
        for rid, seeds in clist:
            chains.append(Chain(
                pos=0, rid=rid, is_alt=int(bool(anns[rid].is_alt)),
                seeds=[Seed(rbeg=s0, qbeg=s1, len=s2, score=s3)
                       for (s0, s1, s2, s3) in seeds],
                frac_rep=frac_rep))
        out.append(chains)
    return out

