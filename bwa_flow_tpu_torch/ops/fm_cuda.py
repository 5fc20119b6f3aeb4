"""Launcher of the hand-written CUDA kernel of the LF walk.

``sa_walk`` (csrc/sa_walk.cu, its lane loop in csrc/sa_walk.cuh, the LF
step FM::lf in csrc/seed_fm.cuh) replaces the XLA loops of
bwa_flow_tpu/ops/fm_jax.py: _lf_walk_fixed (:338, a fori_loop) and
sa_batch's while_loops (:438, :457). It computes what the plain PyTorch
version ops/fm_torch.py::_lf_walk_plain computes, one thread a lane,
each lane run to its death or to the step budget, so a walk is one
launch and its caller reads nothing from the card. A pool's live count
(the compaction's, on the card) is read by the kernel itself; slots at
or past it are not walked. The dispatching wrapper (CPU tensors: the
plain version; CUDA tensors: this launcher) is fm_torch._lf_walk.

The launcher checks its tensors, launches on the tensors' card and its
current stream inside the card's device guard, raises when
cudaGetLastError reports a failed launch, and adds one to its count in
``n_launches`` (chip_smoke.py resets and reads it). Shard threads
launch too (parallel/mesh.py), so the count and the first load change
under _LOCK.
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
_ARGTYPES = [_I, _I, _I, _LL, _P, _P, _P, _P, _P, _LL, _LL, _P]
_FNS: dict = {}
_LOCK = threading.Lock()


def _fn():
    """(launcher, error string) of csrc/sa_walk.cu, built and loaded at
    first use."""
    with _LOCK:
        if "sa_walk" not in _FNS:
            lib = _build.load("sa_walk")
            fn = lib.sa_walk_launch
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            lib.sa_walk_error_string.argtypes = [ctypes.c_int]
            lib.sa_walk_error_string.restype = ctypes.c_char_p
            _FNS["sa_walk"] = (fn, lib.sa_walk_error_string)
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


def lf_walk(dfm, mask: int, kk: torch.Tensor, steps: torch.Tensor, T: int,
            live: torch.Tensor | None = None) -> None:
    """Walk the lanes of kk (rows) and steps (their step counts) in place
    on the card: each lane below `live` (one int32 on the card: the
    count of leading slots that hold lanes; None: every lane) takes LF
    steps while (row & mask) != 0, at most T. kk and steps are int32 on
    a narrow view of the index, int64 on the wide one (dfm.L2's dtype)."""
    dev = _device(kk)
    n = kk.numel()
    dt = kk.dtype
    fm = _fm_args(dfm, dev, dt)
    _check("kk", kk, dt, n, dev)
    _check("steps", steps, dt, n, dev)
    if live is not None:
        _check("live", live, torch.int32, 1, dev)
    if mask < 0 or not 0 <= T < 2**31 or n >= 2**31:
        raise ValueError(f"sa_walk: mask {mask}, T {T}, {n} lanes")
    fn, err = _fn()
    if n == 0 or T == 0:
        return                      # no step to take: nothing launches
    with _on_device(dev) as stream:
        rc = fn(fm[4], n, T, mask, kk.data_ptr(), steps.data_ptr(),
                None if live is None else live.data_ptr(), *fm[:4], stream)
    if rc != 0:
        raise RuntimeError(f"sa_walk launch failed: {err(rc).decode()} "
                           f"({rc})")
    with _LOCK:
        n_launches["sa_walk"] += 1
