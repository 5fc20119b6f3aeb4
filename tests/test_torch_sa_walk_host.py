"""The LF walk of bwa_flow_tpu_torch/csrc/sa_walk.cuh and the LF step
FM::lf of csrc/seed_fm.cuh on the CPU: both headers compiled with the
host's c++ under tests/test_torch_seed_fm_host.py's stand-in for the
little of CUDA they use, and called through ctypes.

FM::lf is held, on every row of a small index (0, primary and seq_len
among them), to the port's plain LF step (fm_torch._inv_psi_batch) and
the JAX package's (fm_jax._inv_psi_batch). The kernel's per-slot code
(sawalk::walk_slot, run here for every slot of a launch) is held to the
port's plain walk (fm_torch._lf_walk_plain) and the JAX package's
(fm_jax._lf_walk_fixed), narrow (int32) and wide (int64), at several
step budgets, on random pools and on front-packed pools whose live
count is below their capacity: there the padding slots must come back
as they went in. Every value is an integer: equal or not. The harness's
sa_walk_launch has the kernel launcher's C signature, so
tests/test_torch_sa_walk.py puts it behind ops/fm_cuda.py in place of
the card."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwa_flow_tpu.ops import fm_jax
from bwa_flow_tpu_torch import _build
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.ops import fm_cuda, fm_torch
from tests.test_torch_seed_fm_host import SHIM
from tests.test_torch_smem import _contigs

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

HARNESS = r"""
#include "cuda_host_shim.h"
#include "sa_walk.cuh"

using seedfm::FM;

template <typename T>
static void lf(const void* blocks, const T* l2, long long seq_len,
               long long primary, int n, const T* k, T* out) {
  const FM<T> fm(blocks, l2, seq_len, primary);
  for (int e = 0; e < n; ++e) out[e] = fm.lf(k[e]);
}

// the kernel's grid, one slot after another
template <typename T>
static void walk(int n, int steps, long long mask, void* kk, void* st,
                 const void* live, const void* blocks, const void* l2,
                 long long seq_len, long long primary) {
  for (int i = 0; i < n; ++i)
    sawalk::walk_slot<T>(i, n, steps, (T)mask, (T*)kk, (T*)st,
                         (const int32_t*)live, blocks, (const T*)l2,
                         seq_len, primary);
}

extern "C" {
void lf32(const void* bl, const int32_t* l2, long long sl, long long pr,
          int n, const int32_t* k, int32_t* out) {
  lf<int32_t>(bl, l2, sl, pr, n, k, out);
}
void lf64(const void* bl, const int64_t* l2, long long sl, long long pr,
          int n, const int64_t* k, int64_t* out) {
  lf<int64_t>(bl, l2, sl, pr, n, k, out);
}
// csrc/sa_walk.cu's launcher signature; the stream is not used
int sa_walk_launch(int wide, int n, int steps, long long mask, void* kk,
                   void* st, const void* live, const void* fm_blocks,
                   const void* L2, long long seq_len, long long primary,
                   void* stream) {
  (void)stream;
  if (wide)
    walk<int64_t>(n, steps, mask, kk, st, live, fm_blocks, L2, seq_len,
                  primary);
  else
    walk<int32_t>(n, steps, mask, kk, st, live, fm_blocks, L2, seq_len,
                  primary);
  return 0;
}
const char* sa_walk_error_string(int code) {
  (void)code;
  return "host harness";
}
}
"""


def build_harness(d):
    """Compile the harness around csrc/sa_walk.cuh into directory d and
    load it; skips without a host c++."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host c++ to compile csrc/sa_walk.cuh with")
    (d / "cuda_host_shim.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    out = d / "libsa_walk_host.so"
    r = subprocess.run([cxx, *_build.HOST_FLAGS, f"-I{d}", f"-I{_build.CSRC}",
                        "-o", str(out), str(d / "harness.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    lib = ctypes.CDLL(str(out))
    lib.sa_walk_launch.argtypes = fm_cuda._ARGTYPES
    lib.sa_walk_launch.restype = ctypes.c_int
    lib.sa_walk_error_string.argtypes = [ctypes.c_int]
    lib.sa_walk_error_string.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("sa_walk_host"))


@pytest.fixture(scope="module")
def idx():
    fm = build_index(_contigs(np.random.default_rng(0x5A7)))
    dt = fm_torch.DeviceFM.from_host(fm, "cpu", dense_sa_max=0)
    dj = fm_jax.DeviceFM.from_host(fm, dense_sa_max=0)
    return dict(fm=fm, seq_len=int(fm.seq_len), primary=int(fm.primary),
                intv=int(fm.sa_intv),
                torch={"int64": dt, "int32": dt.narrow()},
                jax={"int64": dj, "int32": fm_jax._narrow_view(dj)})


def _np_dtype(width):
    return np.int32 if width == "int32" else np.int64


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def harness_walk(lib, idx, width, kk, steps, T, live=None):
    """The kernel's code over every slot of (kk, steps) on copies; live:
    the count of leading slots that hold lanes (None: all)."""
    npt = _np_dtype(width)
    fm = idx["fm"]
    kk, steps = kk.astype(npt).copy(), steps.astype(npt).copy()
    blocks = np.ascontiguousarray(fm.fm_blocks, dtype=np.int32)
    l2 = np.ascontiguousarray(np.asarray(fm.L2), dtype=npt)
    cnt = None if live is None else np.array([live], np.int32)
    rc = lib.sa_walk_launch(int(width == "int64"), len(kk), T,
                            idx["intv"] - 1, _ptr(kk).value,
                            _ptr(steps).value,
                            None if cnt is None else _ptr(cnt).value,
                            _ptr(blocks).value, _ptr(l2).value,
                            idx["seq_len"], idx["primary"], None)
    assert rc == 0
    return kk, steps


@pytest.mark.parametrize("width", ["int32", "int64"])
def test_lf_step_equals_plain_and_jax_on_every_row(lib, idx, width):
    seq_len, primary = idx["seq_len"], idx["primary"]
    npt = _np_dtype(width)
    k = np.arange(seq_len + 1, dtype=npt)
    assert k[0] == 0 and k[primary] == primary and k[-1] == seq_len
    fm = idx["fm"]
    blocks = np.ascontiguousarray(fm.fm_blocks, dtype=np.int32)
    l2 = np.ascontiguousarray(np.asarray(fm.L2), dtype=npt)
    out = np.zeros_like(k)
    fn = lib.lf32 if width == "int32" else lib.lf64
    fn.restype = None
    fn(_ptr(blocks), _ptr(l2), ctypes.c_longlong(seq_len),
       ctypes.c_longlong(primary), ctypes.c_int(len(k)), _ptr(k), _ptr(out))
    want = fm_torch._inv_psi_batch(idx["torch"][width], torch.as_tensor(k))
    np.testing.assert_array_equal(out, want.numpy())
    assert out[primary] == 0
    want_j = fm_jax._inv_psi_batch(idx["jax"][width], jnp.asarray(k))
    np.testing.assert_array_equal(out, np.asarray(want_j))


def _pool(idx, case, rng):
    """(kk, steps, live) of a pool: "random", every slot a lane at a
    random row; "front_packed", CAP slots whose first `live` hold lanes
    (lane 0 live, some lanes dead), the rest padding: copies of lane 0
    and random rows, which must come back untouched."""
    seq_len, mask = idx["seq_len"], idx["intv"] - 1
    if case == "random":
        kk = rng.integers(0, seq_len + 1, 700)
        return kk, rng.integers(0, 50, 700), None
    CAP, live = 256, 90
    kk = rng.integers(0, seq_len + 1, CAP)
    while not kk[0] & mask:
        kk[0] = rng.integers(1, seq_len + 1)
    kk[live:live + 40] = kk[0]
    kk[5:live:9] = (kk[5:live:9] // (mask + 1)) * (mask + 1)   # dead
    return kk, rng.integers(0, 50, CAP), live


@pytest.mark.parametrize("case", ["random", "front_packed"])
@pytest.mark.parametrize("T", ["1", "2intv", "4intv", "256"])
@pytest.mark.parametrize("width", ["int32", "int64"])
def test_lane_loop_equals_plain_and_jax(lib, idx, width, T, case):
    T = {"1": 1, "2intv": 2 * idx["intv"], "4intv": 4 * idx["intv"],
         "256": 256}[T]
    npt = _np_dtype(width)
    rng = np.random.default_rng(T * 7 + len(case))
    kk0, st0, live = _pool(idx, case, rng)
    kk0, st0 = kk0.astype(npt), st0.astype(npt)
    mask = idx["intv"] - 1
    got_k, got_s = harness_walk(lib, idx, width, kk0, st0, T, live)
    # the port's plain walk, with the live count as the kernel reads it
    cnt = None if live is None else torch.tensor([live], dtype=torch.int32)
    want_k, want_s = fm_torch._lf_walk_plain(
        idx["torch"][width], mask, torch.as_tensor(kk0),
        torch.as_tensor(st0), T, live=cnt)
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())
    # the JAX package's on the lanes (the pool's live prefix)
    n = len(kk0) if live is None else live
    jk, js = fm_jax._lf_walk_fixed(
        idx["jax"][width], jnp.asarray(mask, dtype=npt),
        jnp.asarray(kk0[:n]), jnp.asarray(st0[:n]), T)
    np.testing.assert_array_equal(got_k[:n], np.asarray(jk))
    np.testing.assert_array_equal(got_s[:n], np.asarray(js))
    # padding slots come back as they went in; some lanes walked
    np.testing.assert_array_equal(got_k[n:], kk0[n:])
    np.testing.assert_array_equal(got_s[n:], st0[n:])
    assert (got_s[:n] > st0[:n]).sum() > n // 3
    if case == "front_packed":
        assert got_s[0] > st0[0] and (kk0[n:] == kk0[0]).sum() >= 40
