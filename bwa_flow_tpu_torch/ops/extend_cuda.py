"""Wrapper of the hand-written CUDA ksw_extend2 kernel (csrc/ksw_extend.cu).

Replaces the Pallas TPU kernel bwa_flow_tpu/ops/extend_pallas.py
(_extend_pallas with the _make_kernel body), with the signature and
outputs of the plain version ops/extend_torch.py::extend_core.

What bounds it on the H100: int32 operations over the banded DP cells
(about 20 per cell, plus two scratch loads and stores). The design is
the simple exact one: one thread per task runs bwa's scalar row loop,
its H/E rows in a task-minor scratch buffer so a warp's accesses are
coalesced, and each thread stops when its own task breaks or reaches
tlen. That leaves the card latency-bound with B/32 warps; a warp per
task with a prefix-max F scan is the later fast version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .extend_torch import _as_int

# launches of the kernel (a plain count; chip_smoke.py resets and reads it)
n_launches = 0

_FN = None


def _fn():
    global _FN
    if _FN is None:
        lib = _build.load("ksw_extend")
        fn = lib.ksw_extend2_launch
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.ksw_error_string.argtypes = [ctypes.c_int]
        lib.ksw_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.ksw_error_string)
    return _FN


def _check(name: str, x: torch.Tensor, shape: tuple, dev) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != dev:
        raise ValueError(f"{name}: on {x.device}, expected {dev}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {x.dtype}, expected torch.int32")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def extend_core_cuda(qmax: int, tmax: int, q, qlen, t, tlen, h0, mat,
                     o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop
                     ) -> tuple[torch.Tensor, ...]:
    """Batched ksw_extend2 on the card. q int32[B, qmax], t int32[B,
    tmax], qlen/tlen/h0 int32[B], mat int32[5, 5], all contiguous on one
    CUDA device; `w` an int or int32[B]; other scalars ints or 0-d
    tensors. Returns 6 int32[B] tensors (score, qle, tle, gtle, gscore,
    max_off). Launches on the current stream and does not synchronise."""
    global n_launches
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("extend_core_cuda: tensors must be on a CUDA "
                         "device (the CPU runs extend_torch.extend_core)")
    dev = q.device
    B = q.shape[0]
    _check("q", q, (B, qmax), dev)
    _check("t", t, (B, tmax), dev)
    for name, v in (("qlen", qlen), ("tlen", tlen), ("h0", h0)):
        _check(name, v, (B,), dev)
    _check("mat", mat, (5, 5), dev)
    if isinstance(w, torch.Tensor) and w.dim() > 0:
        _check("w", w, (B,), dev)
    else:
        w = torch.full((B,), _as_int(w), dtype=torch.int32, device=dev)
    eh = torch.empty((2, qmax + 1, B), dtype=torch.int32, device=dev)
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    fn, err = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(B, qmax, tmax, q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), h0.data_ptr(), w.data_ptr(), mat.data_ptr(),
            _as_int(o_del), _as_int(e_del), _as_int(o_ins), _as_int(e_ins),
            _as_int(end_bonus), _as_int(zdrop), eh.data_ptr(),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ksw_extend2 launch failed: "
                           f"{err(rc).decode()} ({rc})")
    n_launches += 1
    return tuple(out[k] for k in range(6))
