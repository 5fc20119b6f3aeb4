"""The LF walk of bwa_flow_tpu_torch/csrc/sa_walk.cuh and the LF step
FM::lf of csrc/seed_fm.cuh on the CPU: both headers compiled with the
host's c++ under a stand-in for the little of CUDA they use, and called
through ctypes.

FM::lf is held, on every row of a small index (0, primary and seq_len
among them), to the port's plain LF step (fm_torch._inv_psi_batch) and
the JAX package's (fm_jax._inv_psi_batch). The kernel's per-block code
(sawalk::walk_block) runs as the card runs it, one block's threads as
host threads (a barrier for __syncthreads, a warp's 32 threads meeting
at each ballot and reduction), the logical blocks one after another in
ticket order, each through all its phases and look-backs; its blocks
are small (32 or 64 slots), so a call of 40-5000 slots spans up to 157
blocks and each pool fills across block boundaries. Every call is held
to the port's plain version (fm_torch._sa_walk_plain) and the JAX
package's (fm_jax.sa_batch), sa and overflow, narrow (int32) and wide
(int64), phased and unphased; the look-back alone is held to the sum of
the earlier blocks' counts on status words a concurrent run can leave.
Every value is an integer: equal or not. The harness's sa_walk_launch
and sa_walk_slots have the kernel launcher's C signatures, so
tests/test_torch_sa_walk.py puts it behind ops/fm_cuda.py
in place of the card."""

import ctypes
import dataclasses
import shutil
import subprocess
import threading

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

# what sa_walk.cuh needs beyond SHIM: a block's threads as host threads
THREADS_SHIM = r"""
#pragma once
#include <barrier>
#include <thread>
#include <vector>
#define __host__
#define __global__
struct HostWarp {
  std::barrier<> bar{32};
  unsigned v[32];
};
inline thread_local int t_lane = 0;
inline thread_local HostWarp* t_warp = nullptr;
inline thread_local std::barrier<>* t_block = nullptr;
inline void __syncthreads() { t_block->arrive_and_wait(); }
// a warp's 32 threads meet, each with its value, and read all 32:
// op 0 a ballot, 1 a sum, 2 a minimum
inline unsigned warp_meet(unsigned x, int op) {
  t_warp->v[t_lane] = x;
  t_warp->bar.arrive_and_wait();
  unsigned r = op == 2 ? ~0u : 0u;
  for (int i = 0; i < 32; ++i) {
    const unsigned y = t_warp->v[i];
    r = op == 0 ? r | (y != 0 ? 1u << i : 0u)
                : (op == 1 ? r + y : (y < r ? y : r));
  }
  t_warp->bar.arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int p) { return warp_meet(p, 0); }
inline bool __any_sync(unsigned, int p) { return warp_meet(p, 0) != 0; }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline unsigned __reduce_add_sync(unsigned, unsigned x) {
  return warp_meet(x, 1);
}
inline unsigned __reduce_min_sync(unsigned, unsigned x) {
  return warp_meet(x, 2);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
"""

HARNESS = r"""
#include "cuda_host_shim.h"
#include "cuda_host_threads.h"
#include "sa_walk.cuh"

using seedfm::FM;

template <typename T>
static void lf(const void* blocks, const T* l2, long long seq_len,
               long long primary, int n, const T* k, T* out) {
  const FM<T> fm(blocks, l2, seq_len, primary);
  for (int e = 0; e < n; ++e) out[e] = fm.lf(k[e]);
}

constexpr int kThreads = HARNESS_THREADS;   // threads, and slots, a block

// the kernel's grid: the logical blocks one after another (each takes its
// ticket, so block b is the b-th to start), a block's threads as threads
template <typename T, typename S>
static int run(const sawalk::Params<T, S>& p) {
  alignas(16) static unsigned char smem[sawalk::shared_bytes<T, kThreads>()];
  std::barrier<> block(kThreads);
  HostWarp warps[kThreads / 32];
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t)
    threads.emplace_back([&, t] {
      t_lane = t & 31;
      t_warp = &warps[t >> 5];
      t_block = &block;
      for (int b = 0; b < p.nblocks; ++b) {
        sawalk::walk_block<T, S, kThreads>(p, smem, t);
        block.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
  return 0;
}

// exclusive_prefix alone: warp 0 of a block of 32 threads looks back from
// block b over the status words (one scan's) the caller made
static int lookback(unsigned long long* status, int b, int count) {
  std::barrier<> block(32);
  HostWarp warp;
  int out = -1;
  std::vector<std::thread> threads;
  for (int t = 0; t < 32; ++t)
    threads.emplace_back([&, t] {
      t_lane = t;
      t_warp = &warp;
      t_block = &block;
      sawalk::exclusive_prefix<32>(status, b, count, t, &out);
    });
  for (auto& th : threads) th.join();
  return out;
}

extern "C" {
int harness_lookback(unsigned long long* status, int b, int count) {
  return lookback(status, b, count);
}
void lf32(const void* bl, const int32_t* l2, long long sl, long long pr,
          int n, const int32_t* k, int32_t* out) {
  lf<int32_t>(bl, l2, sl, pr, n, k, out);
}
void lf64(const void* bl, const int64_t* l2, long long sl, long long pr,
          int n, const int64_t* k, int64_t* out) {
  lf<int64_t>(bl, l2, sl, pr, n, k, out);
}
// csrc/sa_walk.cu's signatures; the stream is not used
int sa_walk_slots() { return kThreads; }
int sa_walk_launch(int wide, int sa_wide, int n, int phases, int budget0,
                   int budget1, int budget2, long long mask, int intv_shift,
                   const void* k, void* sa, void* ovf, const void* samples,
                   long long n_samples, const void* fm_blocks, const void* L2,
                   long long seq_len, long long primary, void* scratch,
                   void* stream) {
  (void)stream;
#define AS(T, S)                                                          \
  run<T, S>(sawalk::make_params<T, S, kThreads>(                          \
      n, phases, budget0, budget1, budget2, mask, intv_shift, k, sa, ovf, \
      samples, n_samples, fm_blocks, L2, seq_len, primary, scratch))
  if (wide) return sa_wide ? AS(int64_t, int64_t) : AS(int64_t, int32_t);
  return sa_wide ? AS(int32_t, int64_t) : AS(int32_t, int32_t);
#undef AS
}
const char* sa_walk_error_string(int code) {
  (void)code;
  return "host harness";
}
}
"""


def build_harness(d, threads: int = 32):
    """Compile the harness around csrc/sa_walk.cuh, with blocks of
    `threads` threads and slots, into directory d and load it; skips
    without a host c++."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host c++ to compile csrc/sa_walk.cuh with")
    (d / "cuda_host_shim.h").write_text(SHIM)
    (d / "cuda_host_threads.h").write_text(THREADS_SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    out = d / "libsa_walk_host.so"
    r = subprocess.run([cxx, *_build.HOST_FLAGS, "-std=c++20", "-pthread",
                        f"-DHARNESS_THREADS={threads}", f"-I{d}",
                        f"-I{_build.CSRC}", "-o", str(out),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    lib = ctypes.CDLL(str(out))
    lib.sa_walk_launch.argtypes = fm_cuda._ARGTYPES
    lib.sa_walk_launch.restype = ctypes.c_int
    lib.sa_walk_slots.argtypes = []
    lib.sa_walk_slots.restype = ctypes.c_int
    lib.sa_walk_error_string.argtypes = [ctypes.c_int]
    lib.sa_walk_error_string.restype = ctypes.c_char_p
    lib.harness_lookback.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.harness_lookback.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The harness with blocks of 32 threads (one warp) and of 64 (two:
    block_rank's sum over warps), built at first use."""
    built = {}

    def get(threads):
        if threads not in built:
            built[threads] = build_harness(
                tmp_path_factory.mktemp(f"sa_walk_host{threads}"), threads)
        return built[threads]
    return get


@pytest.fixture(scope="module")
def lib(libs):
    return libs(32)


@pytest.fixture(scope="module")
def idx():
    # 2 x 8000 bp: some rows walk past 6 intervals
    fm = build_index(_contigs(np.random.default_rng(0x5A7), length=8000))
    dt = fm_torch.DeviceFM.from_host(fm, "cpu", dense_sa_max=0)
    dj = fm_jax.DeviceFM.from_host(fm, dense_sa_max=0)
    # each row's LF steps to a sampled row (the plain walk, unbounded)
    mask = int(fm.sa_intv) - 1
    rows = torch.arange(int(fm.seq_len) + 1, dtype=torch.int64)
    _, length = fm_torch._lf_walk_plain(dt, mask, rows,
                                        torch.zeros_like(rows), 1 << 14)
    return dict(fm=fm, seq_len=int(fm.seq_len), primary=int(fm.primary),
                intv=int(fm.sa_intv), length=length.numpy(),
                torch={"int64": dt, "int32": dt.narrow()},
                jax={"int64": dj, "int32": fm_jax._narrow_view(dj)})


def _np_dtype(width):
    return np.int32 if width == "int32" else np.int64


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def harness_call(lib, idx, dfm, k, max_iters, intv):
    """One sa_batch call on the kernel's code, as fm_cuda.sa_walk makes
    it: (sa, overflow) of the rows k on the index view dfm."""
    width = "int64" if dfm.L2.dtype == torch.int64 else "int32"
    npt = _np_dtype(width)
    fm = idx["fm"]
    k = np.ascontiguousarray(k, dtype=npt)
    B = len(k)
    budgets = fm_cuda.phases(B, max_iters, intv)
    blocks = np.ascontiguousarray(fm.fm_blocks, dtype=np.int32)
    l2 = np.ascontiguousarray(np.asarray(fm.L2), dtype=npt)
    samples = dfm.sa.numpy()
    sa = np.full(B, -7, np.int64)
    ovf = np.full(B, 7, np.uint8)
    slots = lib.sa_walk_slots()
    scratch = np.zeros(1 + (len(budgets) - 1) * -(-B // slots), np.int64)
    b3 = (*budgets, 0, 0)[:3]
    rc = lib.sa_walk_launch(
        int(width == "int64"), int(samples.dtype == np.int64), B,
        len(budgets), *b3, idx["intv"] - 1, idx["intv"].bit_length() - 1,
        _ptr(k).value, _ptr(sa).value, _ptr(ovf).value, _ptr(samples).value,
        len(samples), _ptr(blocks).value, _ptr(l2).value, idx["seq_len"],
        idx["primary"], _ptr(scratch).value, None)
    assert rc == 0
    return sa, ovf


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


def _call(idx, case: str, rng):
    """(rows, max_iters, intv) of a case: "random" (1000 rows, phased);
    "pools_across_blocks" (256 rows, phased: 80 walk past 2 intervals,
    more than the B/4 pool of 64, and 24 of them past 6, more than the
    B/16 pool of 16, spread over the whole call, so both pools fill in a
    middle block and drop lanes in that block and every later one);
    "lane0_live" (64 rows: lane 0 past 6 intervals, two more past 2, so
    lane 0 walks in two pools that are not full); "unphased" (500 rows,
    intv 0, a budget of 40); "small" (40 rows: under 64, unphased though
    intv is given); "many_blocks" (5000 rows, phased, 1500 past 2
    intervals and 400 of them past 6, so both pools fill: over 256 blocks
    of 16 slots, more than one look-back window)."""
    length, intv = idx["length"], idx["intv"]
    n = len(length)
    long6 = np.nonzero(length > 6 * intv)[0]
    long2 = np.nonzero((length > 2 * intv) & (length <= 6 * intv))[0]
    short = np.nonzero(length <= 2 * intv)[0]
    if case == "random":
        return rng.integers(0, n, 1000), 256, intv
    if case in ("pools_across_blocks", "many_blocks"):
        k = rng.choice(short, 256)
        at = rng.permutation(256)[:80]
        k[at[:24]] = rng.choice(long6, 24)
        k[at[24:]] = rng.choice(long2, 56)
        return k, 256, intv
    if case == "lane0_live":
        k = np.concatenate([rng.choice(long6, 1), rng.choice(long2, 2),
                            rng.choice(short, 61)])
        return k, 256, intv
    if case == "many_blocks":
        k = rng.choice(short, 5000)
        at = rng.permutation(5000)[:1500]
        k[at[:400]] = rng.choice(long6, 400)
        k[at[400:]] = rng.choice(long2, 1100)
        return k, 256, intv
    if case == "unphased":
        return rng.integers(0, n, 500), 40, 0
    return rng.integers(0, n, 40), 256, intv


@pytest.mark.parametrize("case", ["random", "pools_across_blocks",
                                  "lane0_live", "unphased", "small",
                                  "many_blocks"])
@pytest.mark.parametrize("threads", [32, 64])
@pytest.mark.parametrize("width", ["int32", "int64", "int64_sa64"])
def test_block_walk_equals_plain_and_jax(libs, idx, width, threads, case):
    """int64_sa64: the wide view with an int64 sampled SA (a genome of
    2^31 rows or more has one)."""
    lib = libs(threads)
    k, max_iters, intv = _call(idx, case, np.random.default_rng(
        threads + len(case)))
    dfm = idx["torch"][width[:5]]
    if width.endswith("sa64"):
        dfm = dataclasses.replace(dfm, sa=dfm.sa.long())
    width = width[:5]
    k = k.astype(_np_dtype(width))
    got = harness_call(lib, idx, dfm, k, max_iters, intv)
    want = fm_torch._sa_walk_plain(dfm, torch.as_tensor(k), max_iters, intv)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    wj = fm_jax.sa_batch(idx["jax"][width], jnp.asarray(k), max_iters, intv)
    np.testing.assert_array_equal(got[0], np.asarray(wj[0]))
    np.testing.assert_array_equal(got[1], np.asarray(wj[1]))
    length, ovf = idx["length"][k], got[1].astype(bool)
    if case in ("pools_across_blocks", "many_blocks"):
        # the last 16 of the 80 lanes past 2 intervals drop from the B/4
        # pool of 64; of the lanes still live after it (the 24 past 6 and
        # the dropped), the first 16 walk the B/16 pool, the rest overflow
        assert 0 < ovf.sum() < len(k) * 0.3
        assert not ovf[length <= 2 * intv].any()
        assert -(-len(k) // threads) > 1
    if case == "lane0_live":
        assert not ovf.any() and length[0] > 6 * intv
    if case == "unphased":
        np.testing.assert_array_equal(ovf, length > max_iters)


@pytest.mark.parametrize("b", [1, 31, 32, 33, 256, 257, 600])
@pytest.mark.parametrize("layout", ["counts", "prefixes", "gaps"])
def test_lookback_sums_every_earlier_block(lib, b, layout):
    """sawalk::exclusive_prefix over status words as a concurrent run can
    leave them: "counts", every earlier block has published only its own
    count (block 0 its prefix), so the look-back sums every window back
    to block 0; "prefixes", every 100th block has also published its
    inclusive prefix, where the look-back must stop; "gaps", as
    "prefixes" with the blocks more than one prefix back not yet
    published, which it must not wait for. It returns the live lanes of
    blocks 0..b-1 and publishes block b's inclusive prefix."""
    rng = np.random.default_rng(b)
    count = rng.integers(0, 50, 700)
    incl = np.cumsum(count)
    status = (1 << 32) + count.astype(np.uint64)
    status[0] = (2 << 32) + int(count[0])
    if layout != "counts":
        status[100::100] = (2 << 32) + incl[100::100].astype(np.uint64)
    if layout == "gaps" and b > 100:
        near = (b - 1) // 100 * 100          # the nearest prefix before b
        status[1:near] = 0
    status[b:] = 0                         # b and on: not yet published
    status = np.ascontiguousarray(status, dtype=np.uint64)
    got = []
    # a look-back that waits for a block it does not need never returns
    th = threading.Thread(target=lambda: got.append(lib.harness_lookback(
        status.ctypes.data, b, int(count[b]))), daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "the look-back waits for a block it does " \
        "not need"
    assert got == [incl[b - 1]]
    assert status[b] == (2 << 32) + int(incl[b])
