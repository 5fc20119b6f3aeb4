// The per-row scan of cohort emission (seed_cohort.cu), one chunk of a
// row's break slots at a time: the function of the plain PyTorch version
// bwa_flow_tpu_torch/ops/smem_torch.py::_cohort_emit for one row, cut
// into chunks that the kernel stages in shared memory. A row's chunks are
// scanned from the last to the first, and the carry (g_c, m_c) passes
// from one chunk to the next, so the chunks together are the one scan.
//
// The header needs nothing of CUDA beyond __device__ and __forceinline__,
// so tests/test_torch_seed_cohort_host.py compiles it with the host's c++
// under a stand-in for those.

#pragma once

#include <cstdint>

namespace seedcohort {

constexpr int kBig = 1 << 30;   // BIG32 of smem_torch

// The slots [base, base + n) of chunk `ci` of a row of NB slots cut into
// chunks of C; chunk 0 holds the first C slots, and the last chunk may be
// short.
__device__ __forceinline__ void chunk_span(int ci, int NB, int C, int& base,
                                           int& n) {
  base = ci * C;
  n = NB - base < C ? NB - base : C;
}

// The carry of a row's scan, before its last slot: no group yet.
struct Carry {
  int g_c = -1;
  int m_c = kBig;
};

// Scans one chunk of a row from its last slot to its first, carrying
// (g_c, m_c): slot j's r[j], g[j] and valid flag v[j] (0 or not), its
// output m[j], for the chunk's n slots. A valid slot of the carried group
// gets the carried minimum, every other slot kBig; a valid slot restarts
// the carry on another group, or lowers its minimum; an invalid slot
// leaves it as it is.
__device__ __forceinline__ void scan_chunk(const int32_t* r,
                                           const int32_t* g,
                                           const int32_t* v, int32_t* m,
                                           int n, Carry& c) {
  for (int j = n - 1; j >= 0; --j) {
    const int gj = g[j];
    const bool vj = v[j] != 0;
    const int rj = r[j];
    const bool same = vj && gj == c.g_c;
    m[j] = same ? c.m_c : kBig;
    if (vj) {
      c.m_c = same ? (c.m_c < rj ? c.m_c : rj) : rj;
      c.g_c = gj;
    }
  }
}

}  // namespace seedcohort
