// Cohort emission of the seed program: for every break slot, the minimum
// death step r over the later slots of its group (its m_prev), on NVIDIA
// Hopper (sm_90a).
//
// Replaces the XLA fori_loop of bwa_flow_tpu/ops/smem_jax.py:539
// (_cohort_emit, :518-541). Same contract as the plain PyTorch version
// bwa_flow_tpu_torch/ops/smem_torch.py::_cohort_emit: a row's NB slots
// are scanned from the last to the first, carrying the current group g_c
// and the running minimum m_c of r within it; a valid slot of the same
// group gets m_c, every other slot BIG32. Exact for any input: groups
// need not be sorted, and an invalid slot neither resets nor feeds the
// carry.
//
// What bounds it on the H100: bytes. It reads r, the group and the valid
// flag of every slot and writes m_prev once: 13 bytes a slot, 6.8 MB for
// 4096 rows of 128 slots, about 2 us at 3.35 TB/s. Design: a block takes
// 32 rows, so 4096 rows fill 128 blocks; each row's scan stays one
// thread's sequential loop (seed_cohort.cuh's scan_chunk), and the memory
// access is built around it:
//   - the rows are cut into chunks of 32 slots, taken from the last to the
//     first; a chunk's r, group and valid flag for the block's 32 rows are
//     loaded with coalesced reads (a warp reads 32 consecutive slots of
//     one row) into registers, while the previous chunk is being scanned,
//     and then staged in shared memory, each row padded by one word so
//     that the 32 scanning threads read 32 different banks;
//   - thread t scans row t's chunk out of shared memory, carrying (g_c,
//     m_c) in registers from chunk to chunk, and writes m_prev back into
//     shared memory, from which the warps store it with coalesced writes.
// The group rows may be a strided view (g_stride elements apart: the
// break metadata's group row has stride 3 NB), and NB need not be a
// multiple of the chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "seed_cohort.cuh"

namespace {

using seedcohort::Carry;
using seedcohort::chunk_span;
using seedcohort::scan_chunk;

constexpr int kRows = 32;                 // rows a block, one thread each
constexpr int kChunk = 32;                // slots a chunk
constexpr int kPad = kChunk + 1;          // a staged row, padded
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kRows / kWarps;      // rows a warp loads and stores

__global__ void __launch_bounds__(kThreads)
    cohort_kernel(int NL, int NB, const int32_t* __restrict__ r,
                  const int32_t* __restrict__ g, int g_stride,
                  const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ m_out) {
  __shared__ int32_t sr[kRows * kPad], sg[kRows * kPad], sv[kRows * kPad],
      sm[kRows * kPad];
  const int row0 = blockIdx.x * kRows;
  const int rows = NL - row0 < kRows ? NL - row0 : kRows;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int chunks = (NB + kChunk - 1) / kChunk;
  // chunk ci of the kPer rows warp + kWarps * u, slot `lane`, into
  // registers
  int vr[kPer] = {}, vg[kPer] = {}, vv[kPer] = {};
  auto load = [&](int ci) {
    int base, n;
    chunk_span(ci, NB, kChunk, base, n);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int rr = warp + kWarps * u;
      if (rr < rows && lane < n) {
        const long long o = (long long)(row0 + rr) * NB + base + lane;
        vr[u] = __ldg(r + o);
        vv[u] = __ldg(valid + o);
        vg[u] = __ldg(g + (long long)(row0 + rr) * g_stride + base + lane);
      }
    }
  };
  Carry c;
  if (chunks > 0) load(chunks - 1);
  for (int ci = chunks - 1; ci >= 0; --ci) {
    int base, n;
    chunk_span(ci, NB, kChunk, base, n);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int rr = warp + kWarps * u;
      if (rr < rows && lane < n) {
        sr[rr * kPad + lane] = vr[u];
        sg[rr * kPad + lane] = vg[u];
        sv[rr * kPad + lane] = vv[u];
      }
    }
    __syncthreads();
    if (ci > 0) load(ci - 1);   // in flight during the scan
    if (t < rows)
      scan_chunk(sr + t * kPad, sg + t * kPad, sv + t * kPad, sm + t * kPad,
                 n, c);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int rr = warp + kWarps * u;
      if (rr < rows && lane < n)
        m_out[(long long)(row0 + rr) * NB + base + lane] =
            sm[rr * kPad + lane];
    }
  }
}

}  // namespace

// r int32[NL, NB], g int32 rows of g_stride elements (NB used), valid
// bool[NL, NB], m_out int32[NL, NB]. Returns cudaGetLastError().
extern "C" int seed_cohort_launch(int NL, int NB, const void* r,
                                  const void* g, int g_stride,
                                  const void* valid, void* m_out,
                                  void* stream) {
  if (NL > 0 && NB > 0)
    cohort_kernel<<<(NL + kRows - 1) / kRows, kThreads, 0,
                    (cudaStream_t)stream>>>(
        NL, NB, (const int32_t*)r, (const int32_t*)g, g_stride,
        (const uint8_t*)valid, (int32_t*)m_out);
  return (int)cudaGetLastError();
}

extern "C" const char* seed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
