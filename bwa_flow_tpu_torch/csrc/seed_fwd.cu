// The seed program's pass 2 forward scans (re-seeding long low-occurrence
// SMEMs from their middle), one thread a task lane, on NVIDIA Hopper
// (sm_90a).
//
// Replaces the XLA while_loop of bwa_flow_tpu/ops/smem_jax.py:350
// (_fwd_scan_machine, :318-353, in task mode). Same contract as the plain
// PyTorch version bwa_flow_tpu_torch/ops/smem_torch.py::_fwd_scan_machine:
// each lane arrives in mode 1 (a task: pivot x, start interval, min_intv)
// or 3 (an empty lane), extends forward one read symbol a step, records a
// break interval (ik, then (ik_info, x, g)) into its [3, NB] stores
// whenever the interval changes or the scan ends, and stops (mode 3) when
// its interval dies below min_intv, the read ends, or its stores are full
// (overflow). This is _fwd_post written out for one lane.
//
// As in seed_p1p3.cu, a lane in mode 3 is a fixed point and reads nothing
// of another lane, so running each lane alone to mode 3 or ITERS steps
// gives the plain version's state bit for bit; the state arrays are
// updated in place (the wrapper passes copies).
//
// What bounds it on the H100: the latency of a lane's chain of dependent
// gathers (a read symbol and two 32-byte FM rows a step, the index in
// L2), not bytes. Design: the state in registers, one thread a lane, 128
// a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "seed_fm.cuh"

namespace {

using seedfm::clampi;
using seedfm::FM;

template <typename T>
struct FwdArgs {
  int NL, L, NB, iters;
  const int32_t* q;        // [reads * L] read symbols (pad 4)
  const int32_t* read_id;  // [NL]
  const int32_t* qlen;     // [NL]
  const T* mi;             // [NL] min_intv of each task
  int32_t *mode, *x, *i, *info, *g, *nb;
  T* ik;                   // [NL, 3]
  T* brk_kls;              // [NL, 3, NB]
  int32_t* brk_meta;       // [NL, 3, NB]
  uint8_t* ovf;
};

template <typename T>
__global__ void __launch_bounds__(128)
    fwd_kernel(FwdArgs<T> a, const void* blocks, const T* L2,
               long long seq_len, long long primary) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.NL) return;
  const FM<T> fm(blocks, L2, seq_len, primary);
  const int L = a.L, NB = a.NB;
  int mode = a.mode[b], x = a.x[b], i = a.i[b];
  int ik_info = a.info[b], g = a.g[b], nb = a.nb[b];
  bool ovf = a.ovf[b] != 0;
  T ik[3] = {a.ik[3 * b], a.ik[3 * b + 1], a.ik[3 * b + 2]};
  const int row = a.read_id[b] * L;
  const int qlen = a.qlen[b];
  const T mi = a.mi[b];
  T* kls = a.brk_kls + (long long)b * 3 * NB;
  int32_t* meta = a.brk_meta + (long long)b * 3 * NB;
  // task mode: a lane is in mode 1 or 3; one in any other mode never
  // changes (the plain version's step leaves it as it is)
  for (int it = 0; it < a.iters && mode == 1; ++it) {
    const int q_i = __ldg(a.q + row + clampi(i, 0, L - 1));
    T okc[3];
    fm.extend(ik, false, clampi(3 - q_i, 0, 3), okc);
    const bool end_now = i >= qlen || q_i > 3;
    const bool changed = okc[2] != ik[2];
    const bool die = changed && okc[2] < mi;
    const bool push = end_now || changed;
    const bool to_next = end_now || die;
    bool nb_ovf = false;
    if (push) {
      if (nb >= NB) {
        nb_ovf = true;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) kls[c * NB + nb] = ik[c];
        meta[nb] = ik_info;
        meta[NB + nb] = x;
        meta[2 * NB + nb] = g;
        ++nb;
      }
    }
    if (!to_next) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ik[c] = okc[c];
      ik_info = i + 1;
      i = i + 1;
    } else {
      mode = 3;
    }
    if (nb_ovf) {
      mode = 3;
      ovf = true;
    }
  }
  a.mode[b] = mode;
  a.x[b] = x;
  a.i[b] = i;
  a.info[b] = ik_info;
  a.g[b] = g;
  a.nb[b] = nb;
  a.ovf[b] = (ovf || mode != 3) ? 1 : 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.ik[3 * b + c] = ik[c];
}

template <typename T>
int launch(int NL, int L, int NB, int iters, void* const* p,
           const void* blocks, const void* L2, long long seq_len,
           long long primary, cudaStream_t stream) {
  FwdArgs<T> a;
  a.NL = NL; a.L = L; a.NB = NB; a.iters = iters;
  a.q = (const int32_t*)p[0];
  a.read_id = (const int32_t*)p[1];
  a.qlen = (const int32_t*)p[2];
  a.mi = (const T*)p[3];
  a.mode = (int32_t*)p[4]; a.x = (int32_t*)p[5]; a.i = (int32_t*)p[6];
  a.info = (int32_t*)p[7]; a.g = (int32_t*)p[8]; a.nb = (int32_t*)p[9];
  a.ik = (T*)p[10]; a.brk_kls = (T*)p[11]; a.brk_meta = (int32_t*)p[12];
  a.ovf = (uint8_t*)p[13];
  const int threads = 128;
  if (NL > 0)
    fwd_kernel<T><<<(NL + threads - 1) / threads, threads, 0, stream>>>(
        a, blocks, (const T*)L2, seq_len, primary);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, read_id, qlen, mi, mode, x, i, ik_info, g, nb, ik, brk_kls,
// brk_meta, ovf. wide: coordinates int64 (else int32). Returns
// cudaGetLastError().
extern "C" int seed_fwd_launch(int wide, int NL, int L, int NB, int iters,
                               void* const* ptrs, const void* fm_blocks,
                               const void* L2, long long seq_len,
                               long long primary, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return launch<int64_t>(NL, L, NB, iters, ptrs, fm_blocks, L2, seq_len,
                           primary, s);
  return launch<int32_t>(NL, L, NB, iters, ptrs, fm_blocks, L2, seq_len,
                         primary, s);
}

extern "C" const char* seed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
