// One lane of the LF walk (sa_walk.cu): the function of the plain PyTorch
// version bwa_flow_tpu_torch/ops/fm_torch.py::_lf_walk_plain for one
// lane. A lane is live while its row is not a sampled one ((k & mask) !=
// 0); each step of a live lane maps its row one LF step back (FM::lf of
// seed_fm.cuh) and counts the step. A dead lane holds its values, so a
// loop that leaves at the lane's death or at `steps_max` steps gives what
// steps_max steps over every lane give, and what a loop "until every lane
// is dead or steps_max" gives (JAX fm_jax.py: _lf_walk_fixed's fori_loop,
// sa_batch's while_loops).
//
// The header needs nothing of CUDA beyond __device__, __forceinline__ and
// __ldg (and seed_fm.cuh's stand-ins), so tests/test_torch_sa_walk_host.py
// compiles it with the host's c++ under a stand-in for those.

#pragma once

#include <cstdint>

#include "seed_fm.cuh"

namespace sawalk {

// Walks one lane in place: row k, its step count s.
template <typename T>
__device__ __forceinline__ void walk_lane(const seedfm::FM<T>& fm, T mask,
                                          int steps_max, T& k, T& s) {
  for (int t = 0; t < steps_max && (k & mask) != 0; ++t) {
    k = fm.lf(k);
    ++s;
  }
}

// What the thread of slot i does (sa_walk.cu's kernel; the host harness
// runs it for every slot): a slot at or past n, or at or past the live
// count (one int32 in device memory; null: all n slots hold lanes), is
// padding and returns at once; a lane dead on entry returns after one
// read of its row; a live lane walks and stores its row and step count.
template <typename T>
__device__ __forceinline__ void walk_slot(int i, int n, int steps_max,
                                          T mask, T* kk, T* st,
                                          const int32_t* live,
                                          const void* blocks, const T* L2,
                                          long long seq_len,
                                          long long primary) {
  if (i >= n || (live != nullptr && i >= __ldg(live))) return;
  T k = kk[i];
  if ((k & mask) == 0) return;
  const seedfm::FM<T> fm(blocks, L2, seq_len, primary);
  T s = st[i];
  walk_lane(fm, mask, steps_max, k, s);
  kk[i] = k;
  st[i] = s;
}

}  // namespace sawalk
