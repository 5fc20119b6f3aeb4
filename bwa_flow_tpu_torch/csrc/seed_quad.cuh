// A quad of threads running one scan lane of the seed machines
// (seed_p1p3.cu, seed_fwd.cu): the four threads hold the same state and
// take the same branches; thread j counts word j of a probe's FM rows
// (seed_fm.cuh's FM::part<1>), two quad shuffles sum the counts, and
// thread j stores row j of a record.

#pragma once

#include <cuda_runtime.h>

#include "seed_fm.cuh"

namespace seedquad {

using seedfm::FM;

// The four threads of one lane: their mask in the warp and each one's
// word j of a probe row.
struct Quad {
  unsigned mask;
  int j;

  // the quad of thread `tid` of its block
  __device__ __forceinline__ explicit Quad(unsigned tid)
      : mask(0xFu << (tid & 28u)), j((int)(tid & 3u)) {}

  __device__ __forceinline__ unsigned sum(unsigned v) const {
    v += __shfl_xor_sync(mask, v, 1, 4);
    v += __shfl_xor_sync(mask, v, 2, 4);
    return v;
  }
};

template <typename X>
__device__ __forceinline__ X pick3(int j, X a0, X a1, X a2) {
  return j == 0 ? a0 : (j == 1 ? a1 : a2);
}

// The forward one-symbol probe of (k, l, s) and symbol c, by the quad.
template <typename T>
__device__ __forceinline__ void probe(const FM<T>& fm, const Quad& q, T k,
                                      T l, T s, int c, T& ok, T& ol,
                                      T& os) {
  seedfm::Part<T> p = fm.template part<1>(l, s, c, q.j);
  p.n = q.sum(p.n);
  fm.finish(p, k, l, s, false, c, ok, ol, os);
}

}  // namespace seedquad
