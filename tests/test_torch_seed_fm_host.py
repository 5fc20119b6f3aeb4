"""The one-symbol FM probe of bwa_flow_tpu_torch/csrc/seed_fm.cuh on the
CPU: the header compiled with the host's c++ under a stand-in for the
little of CUDA it uses (__device__, __forceinline__, __ldg, __popc,
__funnelshift_rc, int4), as _build.host_module builds the host
libraries, and called through ctypes.

The probe is what the seed_p1p3 and seed_bwd kernels run a step: the row
of one symbol c of bwt_extend, from the count of c and of the symbols
above c at the two probe coordinates. Each case holds it, in one thread
(FM::extend1, FM::part<4>) and as a quad's four threads (FM::part<1> for
words 0..3, summed as the quad's two shuffles sum them, then
FM::finish), against the port's plain versions (fm_torch.occ4_batch,
smem_torch.bwt_extend_dir_batch + _take_row) and the JAX package's
(fm_jax.occ4_batch, smem_jax.bwt_extend_dir_batch), on an index the
port builds from a numpy-seeded genome, int32 and int64 coordinates,
both directions and all four symbols. Every value is an integer: equal
or not. FM::set_intv is held to set_intv_batch the same way. This is
the only CPU check that reaches the kernels' arithmetic; the kernels
themselves run only on the card (chip_smoke.py phase 12)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwa_flow_tpu.ops import fm_jax, smem_jax
from bwa_flow_tpu_torch import _build
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.ops import fm_torch, smem_torch
from tests.test_torch_smem import _contigs

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

N = 512   # probes a case

# the CUDA the header uses, for the host compiler
SHIM = r"""
#pragma once
#include <cstdint>
#define __device__
#define __forceinline__ inline
struct int4 { int x, y, z, w; };
template <class X> inline X __ldg(const X* p) { return *p; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
// (hi:lo) >> min(sh, 32), the low 32 bits
inline unsigned __funnelshift_rc(unsigned lo, unsigned hi, unsigned sh) {
  sh = sh > 32 ? 32 : sh;
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> sh);
}
"""

HARNESS = r"""
#include "cuda_host_shim.h"
#include "seed_fm.cuh"

using seedfm::FM;
using seedfm::Part;

// out [n, 3]: the row (k, l, s); cnt [n, 4]: occ(a, c), the sum of
// occ(a, j > c), occ(b, c), the sum of occ(b, j > c) for a = probe - 1,
// b = probe - 1 + s
template <typename T>
static void probe(const void* blocks, const T* l2, long long seq_len,
                  long long primary, int n, const T* ik,
                  const uint8_t* back, const int32_t* sym, int quad, T* out,
                  T* cnt) {
  const FM<T> fm(blocks, l2, seq_len, primary);
  for (int e = 0; e < n; ++e) {
    const T k = ik[3 * e], l = ik[3 * e + 1], s = ik[3 * e + 2];
    const bool b = back[e] != 0;
    const int c = sym[e];
    Part<T> p;
    if (quad) {
      p = fm.template part<1>(b ? k : l, s, c, 0);
      for (int j = 1; j < 4; ++j)
        p.n += fm.template part<1>(b ? k : l, s, c, j).n;
      fm.finish(p, k, l, s, b, c, out[3 * e], out[3 * e + 1],
                out[3 * e + 2]);
    } else {
      p = fm.template part<4>(b ? k : l, s, c, 0);
      fm.extend1(k, l, s, b, c, out[3 * e], out[3 * e + 1], out[3 * e + 2]);
    }
    cnt[4 * e] = p.eq_a + (T)(p.n & 0xFFu);
    cnt[4 * e + 1] = p.above_a + (T)((p.n >> 8) & 0xFFu);
    cnt[4 * e + 2] = p.eq_b + (T)((p.n >> 16) & 0xFFu);
    cnt[4 * e + 3] = p.above_b + (T)(p.n >> 24);
  }
}

template <typename T>
static void intv(const T* l2, int n, const int32_t* sym, T* out) {
  const FM<T> fm(nullptr, l2, 0, 0);
  for (int e = 0; e < n; ++e)
    fm.set_intv(sym[e], out[3 * e], out[3 * e + 1], out[3 * e + 2]);
}

extern "C" {
void probe32(const void* bl, const int32_t* l2, long long sl, long long pr,
             int n, const int32_t* ik, const uint8_t* back,
             const int32_t* sym, int quad, int32_t* out, int32_t* cnt) {
  probe<int32_t>(bl, l2, sl, pr, n, ik, back, sym, quad, out, cnt);
}
void probe64(const void* bl, const int64_t* l2, long long sl, long long pr,
             int n, const int64_t* ik, const uint8_t* back,
             const int32_t* sym, int quad, int64_t* out, int64_t* cnt) {
  probe<int64_t>(bl, l2, sl, pr, n, ik, back, sym, quad, out, cnt);
}
void intv32(const int32_t* l2, int n, const int32_t* sym, int32_t* out) {
  intv<int32_t>(l2, n, sym, out);
}
void intv64(const int64_t* l2, int n, const int32_t* sym, int64_t* out) {
  intv<int64_t>(l2, n, sym, out);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The harness around csrc/seed_fm.cuh, built with the host's c++."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host c++ to compile csrc/seed_fm.cuh with")
    d = tmp_path_factory.mktemp("seed_fm_host")
    (d / "cuda_host_shim.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    out = d / "libseed_fm_host.so"
    r = subprocess.run([cxx, *_build.HOST_FLAGS, f"-I{d}", f"-I{_build.CSRC}",
                        "-o", str(out), str(d / "harness.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def idx():
    fm = build_index(_contigs(np.random.default_rng(0x5EED)))
    dt = fm_torch.DeviceFM.from_host(fm, "cpu")
    dj = fm_jax.DeviceFM.from_host(fm)
    return dict(fm=fm, seq_len=int(fm.seq_len), primary=int(fm.primary),
                torch={"int64": dt, "int32": dt.narrow()},
                jax={"int64": dj, "int32": fm_jax._narrow_view(dj)})


def _rows(kk: np.ndarray, seq_len: int, primary: int) -> np.ndarray:
    """The block row occ4 reads for coordinate kk (its primary shift and
    clamp)."""
    k = np.clip(kk - (kk >= primary), 0, seq_len - 1)
    return k // 64


def _cases(case: str, seq_len: int, primary: int, rng) -> np.ndarray:
    """(probe, s) pairs [n, 2] with both coordinates in [-1, seq_len]."""
    probe = rng.integers(0, seq_len + 2, 8 * N)
    s = rng.integers(0, seq_len + 1, 8 * N) % (seq_len + 2 - probe)
    if case == "k_minus_1":
        probe[:] = 0
    elif case == "k_seq_len":
        s = seq_len + 1 - probe          # b = seq_len
        probe[::2] = seq_len + 1         # a = b = seq_len
        s[::2] = 0
    elif case == "straddle_primary":
        probe = primary - rng.integers(0, 70, 8 * N)
        s = primary - probe + 1 + rng.integers(0, 140, 8 * N)
        # coordinates one either side of primary, and on it
        m = N // 4
        probe[:m] = primary + (np.arange(m) % 3)
        s[:m] = 1 + (np.arange(m) % 5)
        s = np.minimum(s, seq_len + 1 - probe)
    elif case in ("same_block", "other_block"):
        s = rng.integers(0, 48 if case == "same_block" else 400, 8 * N)
        probe = rng.integers(1, seq_len - 400, 8 * N)
        ra = _rows(probe - 1, seq_len, primary)
        rb = _rows(probe - 1 + s, seq_len, primary)
        keep = (ra == rb) if case == "same_block" else (ra != rb)
        probe, s = probe[keep], s[keep]
    pairs = np.stack([probe, s], axis=1)[:N]
    assert len(pairs) == N
    a, b = pairs[:, 0] - 1, pairs[:, 0] - 1 + pairs[:, 1]
    assert ((a >= -1) & (b <= seq_len) & (a <= b)).all()
    if case == "k_minus_1":
        assert (a == -1).all()
    if case == "k_seq_len":
        assert (b == seq_len).all()
    if case == "straddle_primary":
        assert ((pairs[:, 0] <= primary) & (b >= primary)).mean() > 0.5
    return pairs


def _run(lib, idx, case: str, width: str, quad: bool):
    seq_len, primary = idx["seq_len"], idx["primary"]
    rng = np.random.default_rng(0x5EED + len(case))
    pairs = _cases(case, seq_len, primary, rng)
    other = rng.integers(0, seq_len + 1, N)
    back = (np.arange(N) // 4) % 2 == 1       # both directions ...
    sym = (np.arange(N) % 4).astype(np.int32)  # ... and all four symbols
    ik = np.empty((N, 3), np.int64)
    ik[:, 0] = np.where(back, pairs[:, 0], other)   # the probed coordinate
    ik[:, 1] = np.where(back, other, pairs[:, 0])
    ik[:, 2] = pairs[:, 1]
    npt = np.int32 if width == "int32" else np.int64
    ik = np.ascontiguousarray(ik.astype(npt))
    fm = idx["fm"]
    blocks = np.ascontiguousarray(fm.fm_blocks, dtype=np.int32)
    l2 = np.ascontiguousarray(np.asarray(fm.L2), dtype=npt)
    back8 = back.astype(np.uint8)
    out = np.zeros((N, 3), npt)
    cnt = np.zeros((N, 4), npt)
    fn = lib.probe32 if width == "int32" else lib.probe64
    ptr = (lambda a: a.ctypes.data_as(ctypes.c_void_p))
    fn.restype = None
    fn(ptr(blocks), ptr(l2), ctypes.c_longlong(seq_len),
       ctypes.c_longlong(primary), ctypes.c_int(N), ptr(ik), ptr(back8),
       ptr(sym), ctypes.c_int(int(quad)), ptr(out), ptr(cnt))
    return ik, back, sym, out, cnt


def _expected_counts(occ: np.ndarray, sym: np.ndarray) -> np.ndarray:
    """occ [n, 4] -> (occ[c], sum of occ[j > c]) [n, 2]."""
    rows = np.arange(len(sym))
    above = np.where(np.arange(4)[None, :] > sym[:, None], occ, 0).sum(1)
    return np.stack([occ[rows, sym], above], axis=1)


@pytest.mark.parametrize("form", ["thread", "quad"])
@pytest.mark.parametrize("width", ["int32", "int64"])
@pytest.mark.parametrize("case", ["random", "k_minus_1", "k_seq_len",
                                  "straddle_primary", "same_block",
                                  "other_block"])
def test_one_symbol_probe_equals_plain_and_jax(lib, idx, case, width, form):
    ik, back, sym, out, cnt = _run(lib, idx, case, width, form == "quad")
    probe = np.where(back, ik[:, 0], ik[:, 1]).astype(np.int64)
    coords = np.concatenate([probe - 1, probe - 1 + ik[:, 2]]).astype(
        ik.dtype)
    # the port's plain versions
    dt = idx["torch"][width]
    occ = fm_torch.occ4_batch(dt, torch.as_tensor(coords)).numpy()
    want_cnt = np.concatenate([_expected_counts(occ[:N], sym),
                               _expected_counts(occ[N:], sym)], axis=1)
    np.testing.assert_array_equal(cnt, want_cnt)
    ok = smem_torch.bwt_extend_dir_batch(dt, torch.as_tensor(ik),
                                         torch.as_tensor(back))
    want = smem_torch._take_row(ok, torch.as_tensor(sym)).numpy()
    np.testing.assert_array_equal(out, want)
    assert out.dtype == want.dtype
    # the JAX package's
    dj = idx["jax"][width]
    occ_j = np.asarray(fm_jax.occ4_batch(dj, jnp.asarray(coords)))
    np.testing.assert_array_equal(occ_j, occ)
    ok_j = np.asarray(smem_jax.bwt_extend_dir_batch(dj, jnp.asarray(ik),
                                                    jnp.asarray(back)))
    np.testing.assert_array_equal(out, ok_j[np.arange(N), sym])


@pytest.mark.parametrize("width", ["int32", "int64"])
def test_set_intv_equals_plain_and_jax(lib, idx, width):
    npt = np.int32 if width == "int32" else np.int64
    sym = np.array([0, 1, 2, 3, -1, 4, 7, 9], np.int32)
    l2 = np.ascontiguousarray(np.asarray(idx["fm"].L2), dtype=npt)
    out = np.zeros((len(sym), 3), npt)
    fn = lib.intv32 if width == "int32" else lib.intv64
    fn.restype = None
    fn(l2.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(len(sym)),
       sym.ctypes.data_as(ctypes.c_void_p),
       out.ctypes.data_as(ctypes.c_void_p))
    want = fm_torch.set_intv_batch(idx["torch"][width],
                                   torch.as_tensor(sym)).numpy()
    np.testing.assert_array_equal(out, want)
    # the JAX package's on the symbols a pivot can have (it does not clamp
    # the others; the port's plain version and the kernels do)
    want_j = fm_jax.set_intv_batch(idx["jax"][width], jnp.asarray(sym[:4]))
    np.testing.assert_array_equal(out[:4], np.asarray(want_j))
