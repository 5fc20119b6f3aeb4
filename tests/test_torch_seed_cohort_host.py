"""The chunked scan of the seed_cohort kernel
(bwa_flow_tpu_torch/csrc/seed_cohort.cuh) on the CPU: the header compiled
with the host's c++ under a stand-in for __device__ and __forceinline__,
as tests/test_torch_seed_fm_host.py compiles seed_fm.cuh, and called
through ctypes.

The kernel stages a block's rows a chunk of C slots at a time, from the
last chunk to the first, and each row's thread scans its chunk with
scan_chunk, carrying (g_c, m_c) from chunk to chunk. The harness walks
the chunks in that order, with chunk_span's bounds, copies each chunk's
r, group and valid flag into int32 buffers (as the kernel's shared
memory holds them) and scans it, so it runs the kernel's per-row logic
exactly. Each case holds it to the port's plain _cohort_emit and to the
JAX package's, on random groups that are not monotone along the row,
invalid slots anywhere, group rows of a stride above NB (a row view of
the break metadata), NB not a multiple of C, and NB = 1. Every value is
an integer: equal or not. The kernel itself runs only on the card
(chip_smoke.py phase 12)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwa_flow_tpu.ops import smem_jax
from bwa_flow_tpu_torch import _build
from bwa_flow_tpu_torch.ops import smem_torch

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

SHIM = r"""
#pragma once
#define __device__
#define __forceinline__ inline
"""

HARNESS = r"""
#include <vector>

#include "cuda_host_shim.h"
#include "seed_cohort.cuh"

using namespace seedcohort;

// m_out [NL, NB] of r [NL, NB], g rows of g_stride elements, valid
// uint8 [NL, NB], chunks of C slots: each row's chunks from the last to
// the first, staged and scanned as seed_cohort.cu's kernel does
extern "C" void cohort(int NL, int NB, int C, const int32_t* r,
                       const int32_t* g, int g_stride, const uint8_t* valid,
                       int32_t* m_out) {
  std::vector<int32_t> sr(C), sg(C), sv(C), sm(C);
  const int chunks = (NB + C - 1) / C;
  for (int row = 0; row < NL; ++row) {
    Carry c;
    for (int ci = chunks - 1; ci >= 0; --ci) {
      int base, n;
      chunk_span(ci, NB, C, base, n);
      for (int j = 0; j < n; ++j) {
        sr[j] = r[(long long)row * NB + base + j];
        sg[j] = g[(long long)row * g_stride + base + j];
        sv[j] = valid[(long long)row * NB + base + j];
      }
      scan_chunk(sr.data(), sg.data(), sv.data(), sm.data(), n, c);
      for (int j = 0; j < n; ++j) m_out[(long long)row * NB + base + j] = sm[j];
    }
  }
}
"""

CHUNK = 32   # seed_cohort.cu's kChunk


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The harness around csrc/seed_cohort.cuh, built with the host's
    c++."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host c++ to compile csrc/seed_cohort.cuh with")
    d = tmp_path_factory.mktemp("seed_cohort_host")
    (d / "cuda_host_shim.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    out = d / "libseed_cohort_host.so"
    r = subprocess.run([cxx, *_build.HOST_FLAGS, f"-I{d}", f"-I{_build.CSRC}",
                        "-o", str(out), str(d / "harness.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    fn = ctypes.CDLL(str(out)).cohort
    fn.restype = None
    return fn


def _run(fn, r, meta, valid, C):
    """The harness on r [NL, NB], the group row meta[:, 2, :] of the
    break metadata [NL, 3, NB] (stride 3 NB) and valid [NL, NB]."""
    NL, NB = r.shape
    m = np.zeros((NL, NB), np.int32)
    ptr = (lambda a: a.ctypes.data_as(ctypes.c_void_p))
    valid8 = np.ascontiguousarray(valid, dtype=np.uint8)
    g_flat = meta.reshape(-1)[2 * NB:]      # row 0's group row onward
    fn(ctypes.c_int(NL), ctypes.c_int(NB), ctypes.c_int(C), ptr(r),
       ptr(g_flat), ctypes.c_int(3 * NB), ptr(valid8), ptr(m))
    return m


@pytest.mark.parametrize("C", [CHUNK, 7])
@pytest.mark.parametrize("NL,NB", [(40, 128), (17, 64), (9, 45), (5, 33),
                                   (3, 200), (12, 1), (1, 31)])
def test_chunked_scan_equals_plain_and_jax(lib, NL, NB, C):
    rng = np.random.default_rng(NL * 1000 + NB * 10 + C)
    r = rng.integers(-1, 60, (NL, NB)).astype(np.int32)
    # groups in no order along the row, repeated runs among them, and
    # negative ids (the scan's start value -1 included)
    meta = rng.integers(-2, 5, (NL, 3, NB)).astype(np.int32)
    runs = rng.random((NL, NB)) < 0.5
    meta[:, 2, 1:] = np.where(runs[:, 1:], meta[:, 2, :-1], meta[:, 2, 1:])
    valid = rng.random((NL, NB)) < 0.7
    valid[0] = True
    if NL > 1:
        valid[1] = False
    got = _run(lib, r, meta, valid, C)
    g_view = torch.as_tensor(meta)[:, 2, :]
    assert g_view.stride(0) == 3 * NB
    want = smem_torch._cohort_emit(torch.as_tensor(r), g_view,
                                   torch.as_tensor(valid), NB).numpy()
    np.testing.assert_array_equal(got, want)
    want_j = smem_jax._cohort_emit(jnp.asarray(r), jnp.asarray(meta[:, 2, :]),
                                   jnp.asarray(valid), NB)
    np.testing.assert_array_equal(got, np.asarray(want_j))
    # the cases reach what the carry must get right
    g = meta[:, 2, :]
    assert (np.diff(g, axis=1) < 0).any() or NB < 3
    if NB > 1:
        assert (want < smem_torch.BIG32).any()
