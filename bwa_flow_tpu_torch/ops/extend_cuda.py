"""Wrappers of the hand-written CUDA ksw_extend2 kernels.

extend_core_cuda (csrc/ksw_extend.cu) replaces the Pallas TPU kernel
bwa_flow_tpu/ops/extend_pallas.py::_extend_pallas with the _make_kernel
body; extend_core_cuda16 (csrc/ksw_extend16.cu) replaces the same call
with the int16 body _make_kernel16, which the wave path selects through
fits_i16. Both take the signature and give the outputs of the plain
version ops/extend_torch.py::extend_core (extend_core16 for the int16
kernel).

What bounds them on the H100: operations over the banded DP cells (10
per cell from the recurrence; the int16 rows allow two cells per packed
32-bit operation). Both run one warp per task (csrc/ksw_warp.cuh), 4
tasks a block: the warp computes a target row for all query columns at
once, one column a lane (int32) or two a lane in one 32-bit word
(int16), with F from a shuffle prefix-max scan; the task's DP rows stay
in its lanes' registers, its query profile in shared memory. Both take
qmax < 256. What holds them back is the latency of a row's dependency
chain (PERF.md).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .. import _build
from .extend_torch import _as_int

# launches of each kernel (plain counts; chip_smoke.py resets and reads
# them). Shard threads may launch (parallel/mesh.py), so the counts and
# the first load change under _LOCK.
n_launches = 0
n_launches16 = 0

_FNS: dict = {}
_LOCK = threading.Lock()


def fits_i16(qmax: int, h0max: int, max_mat: int, end_bonus: int) -> bool:
    """True when the int16 kernel is selected and exact for this scoring:
    only with BWA_TPU_EXTEND16 set (read at call time; off by default),
    and only when every DP row value stays inside int16: cells are at
    most h0max (the largest starting score a task can carry, L_reads*a
    in the wave path) plus (qmax+2)*max_mat of match gain plus the end
    bonus, and the F-scan ramp stays above the int16 floor. The same
    gate and bound as bwa_flow_tpu/ops/extend_pallas.py::fits_i16."""
    if not os.environ.get("BWA_TPU_EXTEND16"):
        return False
    return i16_exact(qmax, h0max, max_mat, end_bonus)


def i16_exact(qmax: int, h0max: int, max_mat: int, end_bonus: int) -> bool:
    """The bound of fits_i16 without its gate: the int16 kernel and its
    plain version are exact on inputs that satisfy it."""
    return h0max + (qmax + 2) * max(max_mat, 1) + max(end_bonus, 0) \
        < (1 << 13) - 256


def _fn(name: str, entry: str):
    """ctypes function `entry` of csrc/<name>.cu: 3 ints, 7 pointers, 6
    ints, then the out pointer and the stream."""
    with _LOCK:
        if name not in _FNS:
            lib = _build.load(name)
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
            fn.restype = ctypes.c_int
            lib.ksw_error_string.argtypes = [ctypes.c_int]
            lib.ksw_error_string.restype = ctypes.c_char_p
            _FNS[name] = (fn, lib.ksw_error_string)
        return _FNS[name]


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


def _checked(who: str, qmax: int, tmax: int, q, qlen, t, tlen, h0, mat, w):
    """Validate the kernels' inputs; returns (device, B, w as int32[B])."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError(f"{who}: tensors must be on a CUDA device (the "
                         "CPU runs the plain version in extend_torch)")
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
    return dev, B, w


def _launch(fn, err, dev, B, qmax, tmax, q, qlen, t, tlen, h0, w, mat,
            o_del, e_del, o_ins, e_ins, end_bonus, zdrop, out) -> None:
    """Call the C launcher with the tensors' card current: the runtime
    launches on the current device, so a call from a thread whose
    current card is another would launch there with this card's
    stream."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(B, qmax, tmax, q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
                tlen.data_ptr(), h0.data_ptr(), w.data_ptr(),
                mat.data_ptr(), _as_int(o_del), _as_int(e_del),
                _as_int(o_ins), _as_int(e_ins), _as_int(end_bonus),
                _as_int(zdrop), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ksw_extend2 launch failed: "
                           f"{err(rc).decode()} ({rc})")


def extend_core_cuda(qmax: int, tmax: int, q, qlen, t, tlen, h0, mat,
                     o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop
                     ) -> tuple[torch.Tensor, ...]:
    """Batched ksw_extend2 on the card. q int32[B, qmax], t int32[B,
    tmax], qlen/tlen/h0 int32[B], mat int32[5, 5], all contiguous on one
    CUDA device; `w` an int or int32[B]; other scalars ints or 0-d
    tensors. Returns 6 int32[B] tensors (score, qle, tle, gtle, gscore,
    max_off). Launches on the current stream and does not synchronise.
    The launch fails, and this raises, when qmax >= 256 or when the
    shared memory of a block (4 tasks' query profiles and target symbols)
    exceeds the 227 KB a block may have."""
    global n_launches
    dev, B, w = _checked("extend_core_cuda", qmax, tmax, q, qlen, t, tlen,
                         h0, mat, w)
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    fn, err = _fn("ksw_extend", "ksw_extend2_launch")
    _launch(fn, err, dev, B, qmax, tmax, q, qlen, t, tlen, h0, w, mat,
            o_del, e_del, o_ins, e_ins, end_bonus, zdrop, out)
    with _LOCK:
        n_launches += 1
    return tuple(out[k] for k in range(6))


def extend_core_cuda16(qmax: int, tmax: int, q, qlen, t, tlen, h0, mat,
                       o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop
                       ) -> tuple[torch.Tensor, ...]:
    """Batched ksw_extend2 on the card with int16 DP rows, two columns
    a 32-bit word; the signature, checks, outputs and launch limits of
    extend_core_cuda.

    Precondition: i16_exact(qmax, max(h0), mat.max(), end_bonus), the
    bound of fits_i16; outside it the rows overflow and the results are
    wrong. The kernel does not check it."""
    global n_launches16
    dev, B, w = _checked("extend_core_cuda16", qmax, tmax, q, qlen, t,
                         tlen, h0, mat, w)
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    fn, err = _fn("ksw_extend16", "ksw_extend2_i16_launch")
    _launch(fn, err, dev, B, qmax, tmax, q, qlen, t, tlen, h0, w, mat,
            o_del, e_del, o_ins, e_ins, end_bonus, zdrop, out)
    with _LOCK:
        n_launches16 += 1
    return tuple(out[k] for k in range(6))
