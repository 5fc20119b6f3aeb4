"""Launchers of the hand-written CUDA kernels of the seed program's loops.

Each kernel replaces one XLA loop of bwa_flow_tpu/ops/smem_jax.py and
computes what the plain PyTorch version of the same name in
ops/smem_torch.py computes:

  - ``seed_p1p3`` (csrc/seed_p1p3.cu): pass 1's forward scan fused with
    pass 3, the while_loop at smem_jax.py:400 (_p1p3_machine);
  - ``seed_fwd`` (csrc/seed_fwd.cu): pass 2's forward scans in task
    mode, the while_loop at smem_jax.py:350 (_fwd_scan_machine);
  - ``seed_bwd`` (csrc/seed_bwd.cu): the backward walks over the break
    pool, the while_loop at smem_jax.py:505 (_bwd_walk_machine);
  - ``seed_cohort`` (csrc/seed_cohort.cu): cohort emission, the
    fori_loop at smem_jax.py:539 (_cohort_emit).

The machines run each lane to its end on the card, with the FM
primitives of csrc/seed_fm.cuh, so a machine is one launch and its
caller reads nothing from the card: ``seed_p1p3`` and ``seed_fwd`` with
four threads a lane (csrc/seed_quad.cuh; blocks from ``p1p3_geometry``
and ``fwd_geometry``; ``seed_p1p3`` stages the lane's symbol-table row
in shared memory for L <= P1P3_MAX_L and reads it from global memory
above), ``seed_bwd`` with one thread a queue entry, and ``seed_cohort``
with one thread a row over chunks staged in shared memory. What bounds
the machines is the latency of a lane's serial chain of dependent FM
row gathers, not bytes: the index of a bacterial genome sits in the 50
MB L2 (PERF.md). The dispatching wrappers (CPU tensors: the plain
version; CUDA tensors: these launchers) are in smem_torch.py.

Each launcher checks its tensors, launches on the tensor's card and its
current stream inside the card's device guard, raises when
cudaGetLastError reports a failed launch, and adds one to its count in
``n_launches`` (chip_smoke.py resets and reads them). Shard threads
launch too (parallel/mesh.py), so the counts and the first load change
under _LOCK.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build

KERNELS = ("seed_p1p3", "seed_fwd", "seed_bwd", "seed_cohort")
n_launches = dict.fromkeys(KERNELS, 0)

_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
# the C launchers' arguments (csrc/<name>.cu)
_ARGTYPES = {
    "seed_p1p3": [_I] * 9 + [_LL, _PP, _P, _P, _LL, _LL, _P],
    "seed_fwd": [_I] * 6 + [_PP, _P, _P, _LL, _LL, _P],
    "seed_bwd": [_I] * 4 + [_PP, _P, _P, _LL, _LL, _P],
    "seed_cohort": [_I, _I, _P, _P, _I, _P, _P, _P],
}
_FNS: dict = {}
_LOCK = threading.Lock()
# seed_p1p3 stages a lane's symbol-table row in shared memory as int16 up
# to this L: the packed pivot (p << 6) | (q[p] << 3) | q[p + 1], p <= L,
# fits for L <= 511; above it the kernel's unstaged variant reads the row
# from global memory
P1P3_MAX_L = 511
_SMS: dict = {}


def _fn(name: str):
    """(launcher, error string) of csrc/<name>.cu, built and loaded at
    first use."""
    with _LOCK:
        if name not in _FNS:
            lib = _build.load(name)
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            lib.seed_error_string.argtypes = [ctypes.c_int]
            lib.seed_error_string.restype = ctypes.c_char_p
            _FNS[name] = (fn, lib.seed_error_string)
        return _FNS[name]


def _check(name: str, x, dtype, numel: int, dev) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != dev:
        raise ValueError(f"{name}: on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.numel() != numel:
        raise ValueError(f"{name}: {x.numel()} elements, expected {numel}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return x


def _device(who: str, t: torch.Tensor) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{who}: tensors must be on a CUDA device (the "
                         "CPU runs the plain version in smem_torch)")
    return t.device


def _fm_args(dfm, dev, dt):
    """(fm_blocks, L2, seq_len, primary, wide) of the index view."""
    _check("fm_blocks", dfm.fm_blocks, torch.int32, dfm.fm_blocks.numel(),
           dev)
    if dfm.fm_blocks.dim() != 2 or dfm.fm_blocks.shape[1] != 8:
        raise ValueError("fm_blocks: expected int32[n_blocks, 8]")
    _check("L2", dfm.L2, dt, 5, dev)
    if dt not in (torch.int32, torch.int64):
        raise TypeError(f"coordinates of dtype {dt}: expected int32 or "
                        "int64")
    return (dfm.fm_blocks.data_ptr(), dfm.L2.data_ptr(), int(dfm.seq_len),
            int(dfm.primary), int(dt == torch.int64))


def _launch(name: str, dev, *args) -> None:
    """Call the launcher with the tensors' card current (the runtime
    launches on the current device) on its current stream; raise on a
    failed launch; count it."""
    fn, err = _fn(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()} "
                           f"({rc})")
    with _LOCK:
        n_launches[name] += 1


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def fwd_geometry(lanes: int, sms: int) -> tuple[int, int]:
    """(threads a block, blocks) of a launch over `lanes` lanes, four
    threads a lane (seed_fwd, seed_p1p3): the widest block of 32, 16 or 8
    lanes that still gives each of the card's `sms` SMs a block, else 8
    lanes a block. seed_fwd deals the lanes to the blocks in turn (lane =
    local lane x blocks + block), so the task pool's live prefix spreads
    over every block."""
    for per in (32, 16):
        if -(-lanes // per) >= sms:
            return 4 * per, -(-lanes // per)
    return 32, -(-lanes // 8)


def p1p3_geometry(lanes: int, sms: int, L: int) -> tuple[int, int, bool]:
    """(threads a block, blocks, stage) of a seed_p1p3 launch over `lanes`
    lanes of reads padded to L: blocks as fwd_geometry; stage (the int16
    shared-memory stage of the symbol table) for L <= P1P3_MAX_L, else
    the unstaged variant."""
    return (*fwd_geometry(lanes, sms), L <= P1P3_MAX_L)


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def p1p3(dfm, L: int, NB: int, ITERS: int, NP3: int, min_seed_len: int,
         max_mem_intv: int, sym, read_id, qlen1, qlen3, s1: dict,
         s3: dict) -> None:
    """Run pass 1 (state s1, _fresh's keys) and pass 3 (state s3: mode, x,
    i, ik, mems, n_mem, ovf) to their ends on the card, updating both in
    place; ovf ends as the plain version's ovf | (mode != 3). sym is
    _sym_tab's int32[2 * B * L] table; L > P1P3_MAX_L takes the unstaged
    variant (p1p3_geometry)."""
    dev = _device("seed_p1p3", sym)
    if L <= 0:
        raise ValueError(f"seed_p1p3: L = {L}; expected reads padded to "
                         "L >= 1")
    B = s1["mode"].shape[0]
    dt = s1["ik"].dtype
    fm = _fm_args(dfm, dev, dt)
    i32, u8 = torch.int32, torch.bool
    ts = [_check("sym", sym, i32, 2 * B * L, dev),
          _check("read_id", read_id, i32, B, dev),
          _check("qlen1", qlen1, i32, B, dev),
          _check("qlen3", qlen3, i32, B, dev)]
    for k in ("mode", "x", "i", "ik_info", "g", "nb"):
        ts.append(_check(f"s1.{k}", s1[k], i32, B, dev))
    ts += [_check("s1.ik", s1["ik"], dt, 3 * B, dev),
           _check("s1.brk_kls", s1["brk_kls"], dt, B * 3 * NB + 1, dev),
           _check("s1.brk_meta", s1["brk_meta"], i32, B * 3 * NB + 1, dev),
           _check("s1.ovf", s1["ovf"], u8, B, dev)]
    for k in ("mode", "x", "i"):
        ts.append(_check(f"s3.{k}", s3[k], i32, B, dev))
    ts += [_check("s3.ik", s3["ik"], dt, 3 * B, dev),
           _check("s3.mems", s3["mems"], dt, B * 4 * NP3 + 1, dev),
           _check("s3.n_mem", s3["n_mem"], i32, B, dev),
           _check("s3.ovf", s3["ovf"], u8, B, dev)]
    _fn("seed_p1p3")      # the kernel first (built at first use), then
    threads, _, stage = p1p3_geometry(2 * B, _sm_count(dev), L)  # the SMs
    _launch("seed_p1p3", dev, fm[4], threads, int(stage), B, L, NB, NP3,
            ITERS, int(min_seed_len), int(max_mem_intv), _ptrs(ts), *fm[:4])


def fwd_scan(dfm, L: int, NB: int, ITERS: int, q_flat, read_id, qlen, mi,
             s: dict) -> None:
    """Run pass 2's task-mode forward scans (state s, _fresh's keys) to
    their ends on the card, in place; ovf ends as ovf | (mode != 3)."""
    dev = _device("seed_fwd", q_flat)
    NL = s["mode"].shape[0]
    dt = s["ik"].dtype
    fm = _fm_args(dfm, dev, dt)
    i32 = torch.int32
    ts = [_check("q_flat", q_flat, i32, q_flat.numel(), dev),
          _check("read_id", read_id, i32, NL, dev),
          _check("qlen", qlen, i32, NL, dev),
          _check("mi", mi, dt, NL, dev)]
    for k in ("mode", "x", "i", "ik_info", "g", "nb"):
        ts.append(_check(f"s.{k}", s[k], i32, NL, dev))
    ts += [_check("s.ik", s["ik"], dt, 3 * NL, dev),
           _check("s.brk_kls", s["brk_kls"], dt, NL * 3 * NB + 1, dev),
           _check("s.brk_meta", s["brk_meta"], i32, NL * 3 * NB + 1, dev),
           _check("s.ovf", s["ovf"], torch.bool, NL, dev)]
    _fn("seed_fwd")
    threads, _ = fwd_geometry(NL, _sm_count(dev))
    _launch("seed_fwd", dev, fm[4], threads, NL, L, NB, ITERS, _ptrs(ts),
            *fm[:4])


def bwd_walk(dfm, L: int, ITB: int, q_flat, read_id, bst0, i_b0, mi,
             total) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward walks of the first `total` (int32 0-d tensor on the
    card) queue entries; returns (r int32[M], bst [M, 3])."""
    dev = _device("seed_bwd", q_flat)
    M = i_b0.shape[0]
    dt = bst0.dtype
    fm = _fm_args(dfm, dev, dt)
    i32 = torch.int32
    r = torch.empty(M, dtype=i32, device=dev)
    bst = torch.empty((M, 3), dtype=dt, device=dev)
    ts = [_check("q_flat", q_flat, i32, q_flat.numel(), dev),
          _check("read_id", read_id, i32, M, dev),
          _check("bst0", bst0, dt, 3 * M, dev),
          _check("i_b0", i_b0, i32, M, dev),
          _check("mi", mi, dt, M, dev),
          _check("total", total, i32, 1, dev), r, bst]
    _launch("seed_bwd", dev, fm[4], M, L, ITB, _ptrs(ts), *fm[:4])
    return r, bst


def cohort_emit(r, brk_g, valid) -> torch.Tensor:
    """m_prev int32[NL, NB] of every break slot. brk_g may be a row view
    (unit stride along the slots) of the break metadata."""
    dev = _device("seed_cohort", r)
    NL, NB = r.shape
    if brk_g.shape != r.shape or brk_g.stride(1) != 1:
        raise ValueError("brk_g: expected int32[NL, NB] rows of unit "
                         "stride")
    if brk_g.device != dev or brk_g.dtype != torch.int32:
        raise TypeError(f"brk_g: {brk_g.dtype} on {brk_g.device}, "
                        f"expected torch.int32 on {dev}")
    _check("r", r, torch.int32, NL * NB, dev)
    _check("valid", valid, torch.bool, NL * NB, dev)
    m_out = torch.empty((NL, NB), dtype=torch.int32, device=dev)
    _launch("seed_cohort", dev, NL, NB, r.data_ptr(), brk_g.data_ptr(),
            brk_g.stride(0), valid.data_ptr(), m_out.data_ptr())
    return m_out
