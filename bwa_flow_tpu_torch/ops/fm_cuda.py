"""Launcher of the hand-written CUDA kernel of the LF walk of SA lookup.

``sa_walk`` (csrc/sa_walk.cu, its per-block logic in csrc/sa_walk.cuh,
the LF step FM::lf in csrc/seed_fm.cuh) replaces the XLA loops of
bwa_flow_tpu/ops/fm_jax.py: _lf_walk_fixed (:338, a fori_loop), sa_batch's
while_loops (:438, :457) and the compaction between them (compact_pool,
:409). One launch computes a whole sa_batch call, every phase and pool,
outputs included: what the plain PyTorch version
ops/fm_torch.py::_sa_walk_plain computes. The caller's rows are read and
never written, and nothing is read back to the host. The dispatching
wrapper (CPU tensors: the plain version; CUDA tensors: this launcher) is
fm_torch.sa_batch.

The launcher checks its tensors, allocates the outputs and the call's
scratch (the blocks' ticket and status words, zeroed on the caller's
stream: shard threads launch on several streams of one card at once, so
no scratch is shared between calls), launches on the tensors' card and
its current stream inside the card's device guard, raises when
cudaGetLastError reports a failed launch, and adds one to its count in
``n_launches`` (chip_smoke.py resets and reads it). Shard threads launch
too (parallel/mesh.py), so the count and the first load change under
_LOCK.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from .. import _build
from .smem_cuda import _check, _fm_args

KERNELS = ("sa_walk",)
n_launches = dict.fromkeys(KERNELS, 0)

_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# sa_walk_launch's arguments (csrc/sa_walk.cu)
_ARGTYPES = [_I, _I, _I, _I, _I, _I, _I, _LL, _I, _P, _P, _P, _P, _LL, _P,
             _P, _LL, _LL, _P, _P]
_FNS: dict = {}
_LOCK = threading.Lock()


def _fn():
    """(launcher, slots a block, error string) of csrc/sa_walk.cu, built
    and loaded at first use."""
    with _LOCK:
        if "sa_walk" not in _FNS:
            lib = _build.load("sa_walk")
            fn = lib.sa_walk_launch
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            lib.sa_walk_slots.argtypes = []
            lib.sa_walk_slots.restype = ctypes.c_int
            lib.sa_walk_error_string.argtypes = [ctypes.c_int]
            lib.sa_walk_error_string.restype = ctypes.c_char_p
            _FNS["sa_walk"] = (fn, lib.sa_walk_slots(),
                               lib.sa_walk_error_string)
        return _FNS["sa_walk"]


def _device(t) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError("sa_walk: tensors must be on a CUDA device (the "
                         "CPU runs the plain version in fm_torch)")
    return t.device


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """The card's device guard (the runtime launches on the current
    device); yields the handle of its current stream, where the kernel
    launches."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def phases(B: int, max_iters: int, intv: int) -> tuple:
    """The step budgets of a call's phases: (2 intv, 4 intv, max_iters)
    for a phased call (intv > 0 and B >= 64, pools of B/4 and B/16
    lanes), else (max_iters,) (fm_jax.sa_batch's two shapes)."""
    if intv > 0 and B >= 64:
        return (2 * intv, 4 * intv, max_iters)
    return (max_iters,)


def sa_walk(dfm, k: torch.Tensor, max_iters: int, intv: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sa_batch call on the card, in one launch: (sa int64[B],
    overflow bool[B]) of the rows k (int32 on a narrow view of the index,
    int64 on the wide one: dfm.L2's dtype), walked against the sampled SA
    dfm.sa."""
    dev = _device(k)
    B = k.numel()
    dt = k.dtype
    fm = _fm_args(dfm, dev, dt)
    _check("k", k, dt, B, dev)
    if dfm.sa.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sa: dtype {dfm.sa.dtype}, expected int32 or int64")
    _check("sa", dfm.sa, dfm.sa.dtype, dfm.sa.numel(), dev)
    intv_s = int(dfm.sa_intv)
    budgets = phases(B, max_iters, intv)
    if intv_s < 1 or intv_s & (intv_s - 1) or not dfm.sa.numel():
        raise ValueError(f"sa_walk: sa_intv {intv_s} (a power of two) and "
                         f"{dfm.sa.numel()} samples")
    if min(budgets) < 0 or sum(budgets) >= 2**31 or B >= 2**31:
        raise ValueError(f"sa_walk: budgets {budgets}, {B} rows")
    fn, slots, err = _fn()
    sa = torch.empty(B, dtype=torch.int64, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return sa, ovf              # no slot: nothing launches
    with _on_device(dev) as stream:
        # the ticket, then a status word a block for each pool's ranks
        scratch = torch.zeros(1 + (len(budgets) - 1) * -(-B // slots),
                              dtype=torch.int64, device=dev)
        b3 = (*budgets, 0, 0)[:3]
        rc = fn(fm[4], int(dfm.sa.dtype == torch.int64), B, len(budgets),
                *b3, intv_s - 1, intv_s.bit_length() - 1, k.data_ptr(),
                sa.data_ptr(), ovf.data_ptr(), dfm.sa.data_ptr(),
                dfm.sa.numel(), *fm[:4], scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sa_walk launch failed: {err(rc).decode()} "
                           f"({rc})")
    with _LOCK:
        n_launches["sa_walk"] += 1
    return sa, ovf
