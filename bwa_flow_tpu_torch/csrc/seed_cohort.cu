// Cohort emission of the seed program: for every break slot, the minimum
// death step r over the later slots of its group (its m_prev), one thread
// a row, on NVIDIA Hopper (sm_90a).
//
// Replaces the XLA fori_loop of bwa_flow_tpu/ops/smem_jax.py:539
// (_cohort_emit, :518-541). Same contract as the plain PyTorch version
// bwa_flow_tpu_torch/ops/smem_torch.py::_cohort_emit: a row's NB slots
// are scanned from the last to the first, carrying the current group g_c
// and the running minimum m_c of r within it; a valid slot of the same
// group gets m_c, every other slot BIG32. The plain version runs NB steps
// of about 8 torch ops over all rows; here each row's scan is one
// thread's loop.
//
// What bounds it on the H100: bytes. It reads r, the group and the valid
// flag of every slot and writes m_prev once: 13 bytes a slot, 6.8 MB for
// 4096 rows of 128 slots, about 2 us at 3.35 TB/s. Its time is the
// latency of one thread's NB dependent steps over strided rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;   // BIG32 of smem_torch

__global__ void __launch_bounds__(128)
    cohort_kernel(int NL, int NB, const int32_t* __restrict__ r,
                  const int32_t* __restrict__ g, int g_stride,
                  const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ m_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= NL) return;
  const long long o = (long long)row * NB;
  const int32_t* gr = g + (long long)row * g_stride;
  int g_c = -1, m_c = kBig;
  for (int j = NB - 1; j >= 0; --j) {
    const int gj = gr[j];
    const bool vj = valid[o + j] != 0;
    const int rj = r[o + j];
    const bool same = vj && gj == g_c;
    m_out[o + j] = same ? m_c : kBig;
    if (vj) {
      m_c = same ? (m_c < rj ? m_c : rj) : rj;
      g_c = gj;
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
  const int threads = 128;
  if (NL > 0)
    cohort_kernel<<<(NL + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(
        NL, NB, (const int32_t*)r, (const int32_t*)g, g_stride,
        (const uint8_t*)valid, (int32_t*)m_out);
  return (int)cudaGetLastError();
}

extern "C" const char* seed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
