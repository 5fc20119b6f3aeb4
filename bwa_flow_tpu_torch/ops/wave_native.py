"""Native wave-driver wrapper: the extension stage with zero Python in
the per-task loop.

Port of bwa_flow_tpu/ops/wave_native.py onto the port's own copy of the
extension (csrc/host/_wave.cpp), built and loaded by _build.host_module.
Chains come straight from _chain.chain_batch_packed as flat arrays; the
_wave driver holds every read's extension state machine (seed ordering,
skip heuristics, band-retry stages, inline scalar fallback for
oversized/non-resident tasks) and the Python side only moves descriptor
waves to the device and results back. Harvester threads (steal) and
drain run pending reads on the exact scalar kernel (ksw_impl.h) with the
GIL released. Long reads the seed-SW filter applies to are spliced in
from the golden Python path.
"""

from __future__ import annotations

import numpy as np

from .. import _build
from ..index.fmindex import FMIndex
from ..utils.opts import MemOpt
from . import chain_native, region_native


def ext():
    """The _wave extension module (built at first use)."""
    return _build.host_module("_wave")


def _ref(fm: FMIndex):
    """The index's pac and contig offsets copied ONCE into a C++
    RefBlock capsule that every per-batch driver borrows (kept with the
    index's other native arrays, region_native.bns_arrays)."""
    b = region_native.bns_arrays(fm)
    if "ref" not in b:
        b["ref"] = ext().make_ref(b["pac"], b["ann_off"])
    return b["ref"]


def create_driver(opt: MemOpt, fm: FMIndex, seqs, all_intvs, sa_flat,
                  dev_flags: np.ndarray, qmax: int, tmax: int, cap: int):
    """Returns (driver_capsule, needs_py list). needs_py reads have no
    chains in the driver and must be spliced in by the caller."""
    vals, off, _ = sa_flat
    n = len(seqs)
    ref = _ref(fm)
    needs_py_b, chain_off, chain_rid, chain_frac, seed_off, seeds = \
        chain_native.ext().chain_batch_packed(*chain_native.chain_args(
            opt, fm, seqs, all_intvs, vals, off))
    seq_off = np.zeros(n + 1, np.int64)
    for r, sq in enumerate(seqs):
        seq_off[r + 1] = seq_off[r] + len(sq)
    seq_cat = np.concatenate(
        [np.ascontiguousarray(sq, np.uint8) for sq in seqs]) if n else \
        np.zeros(0, np.uint8)
    opti = np.array([opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                     opt.w, opt.zdrop, opt.pen_clip5, opt.pen_clip3],
                    np.int64)
    mat = np.ascontiguousarray(opt.mat[:5, :5], np.int8)
    wd = ext().create(seq_cat, seq_off, np.ascontiguousarray(dev_flags),
                      chain_off, chain_rid, chain_frac, seed_off, seeds,
                      ref, fm.bns.l_pac, None, opti, mat, qmax, tmax, cap)
    needs = [r for r in range(n) if needs_py_b[r]]
    return wd, needs


def pack(wd, stream, reserve=0, qsmall=0):
    """Pack the next wave: (slots int32[count], desc int64[11, cap],
    n_small) or None. qsmall > 0 partitions slots [0:n_small) as the
    small-shape class (both query sides <= qsmall) for the caller's small
    kernel shape; slots are cost-sorted within each class."""
    r = ext().pack(wd, stream, reserve, qsmall)
    if r is None:
        return None
    slots_b, desc_b, n_small = r
    return (np.frombuffer(slots_b, np.int32),
            np.frombuffer(desc_b, np.int64).reshape(11, -1), n_small)


def host_tasks(wd) -> int:
    return ext().host_tasks(wd)


def n_pending(wd) -> int:
    return ext().n_pending(wd)


def host_breakdown(wd) -> tuple[int, int, int]:
    """(oversize_q, oversize_t, sched): why tasks ran on the scalar
    kernel — a query side over qmax, a clamped target span over tmax (or
    a read not resident on the device), or drain/steal scheduling."""
    return ext().host_breakdown(wd)


def steal(wd, max_reads: int) -> int:
    """Claim up to max_reads pending reads and run them to completion on
    the exact scalar kernel (GIL released) — harvester-thread entry for
    CPU+device work sharing (the reference's accx_priority,
    kflow/include/kflow/MapStage.h:78-116)."""
    return ext().steal(wd, max_reads)


def apply_results(wd, stream, out) -> None:
    """Feed a wave's rows (int32[12, count]) back into the driver."""
    ext().apply(wd, stream, np.ascontiguousarray(out, np.int32))


def drain(wd) -> int:
    """Finish every pending (not in-flight) read on the exact scalar
    kernel; returns tasks run."""
    return ext().drain(wd)


def finish(wd):
    rows_b, frac_b, off_b = ext().finish(wd)
    rows = np.frombuffer(rows_b, np.int64).reshape(-1, 12)
    frac = np.frombuffer(frac_b, np.float64)
    off = np.frombuffer(off_b, np.int64)
    return rows, frac, off


def splice(rows, frac, off, py_regs: dict):
    """Replace the (empty) entries of needs_py reads with Python regs."""
    if not py_regs:
        return rows, frac, off
    lists = region_native.unpack_regs(rows, frac, off)
    for r, regs in py_regs.items():
        lists[r] = regs
    return region_native.pack_regs(lists)
