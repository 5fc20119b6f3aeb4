// The seed program's backward walks over the compacted break pool, one
// thread a queue entry, on NVIDIA Hopper (sm_90a).
//
// Replaces the XLA while_loop of bwa_flow_tpu/ops/smem_jax.py:505
// (_bwd_walk_machine, :407-516). Same contract as the plain PyTorch
// version bwa_flow_tpu_torch/ops/smem_torch.py::_bwd_walk_machine: each
// of the first `total` queue entries (the live prefix of the pool) walks
// its recorded break interval backward over its read, one symbol a step,
// until the symbol is ambiguous, the read's start is passed, or the
// interval drops below the entry's min_intv; it reports the step it died
// at (r) and the interval before that step (bst, the state at maximal
// backward reach). Entries past `total` keep the dead-on-entry convention
// r = i_b0, bst = bst0.
//
// The plain version runs a worklist of A lanes that refill from the
// queue, but an entry's result depends only on that entry, so one thread
// an entry gives the same r and bst. A walk takes at most L + 1 steps
// (i_b falls from at most L - 1 to -1), under the plain version's safety
// budget ITB = M (L + 2) / A + L + 8, which therefore never binds there;
// here a walk is cut at ITB steps too, and the state it reached is
// written, as the plain version's safety write does.
//
// What bounds it on the H100: the latency of a walk's chain of dependent
// FM row gathers (the index in L2); the pools hold 10^5 entries and
// more, so the card is full. The design takes everything else off the
// chain: the one-symbol probe of seed_fm.cuh (the counts of one symbol
// and of those above it, one row gather when both coordinates share a
// block, no array indexed by a runtime value, so no stack), and the next
// step's read symbol loaded beside this step's rows, so a step waits on
// one gather, not on a symbol and then the rows. The pool is sorted
// longest walk first, so neighbouring threads walk similar lengths and a
// warp's threads finish close together.

#include <cstdint>
#include <cuda_runtime.h>

#include "seed_fm.cuh"

namespace {

using seedfm::clampi;
using seedfm::FM;

template <typename T>
__global__ void __launch_bounds__(128)
    bwd_kernel(int M, int L, int itb, const int32_t* __restrict__ q,
               const int32_t* __restrict__ read_id,
               const T* __restrict__ bst0, const int32_t* __restrict__ i_b0,
               const T* __restrict__ mi, const int32_t* __restrict__ total,
               int32_t* __restrict__ r, T* __restrict__ bst,
               const void* blocks, const T* L2, long long seq_len,
               long long primary) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  T k = bst0[3 * e], l = bst0[3 * e + 1], s = bst0[3 * e + 2];
  int ib = i_b0[e];
  if (e < *total) {
    const FM<T> fm(blocks, L2, seq_len, primary);
    const int32_t* qr = q + (long long)read_id[e] * L;
    const T m = mi[e];
    int qb = __ldg(qr + clampi(ib, 0, L - 1));
    for (int step = 0; step < itb; ++step) {
      if (ib < 0 || qb >= 4) break;
      // the next step's symbol, in flight beside this step's rows
      const int qn = __ldg(qr + clampi(ib - 1, 0, L - 1));
      T ok, ol, os;
      fm.extend1(k, l, s, true, clampi(qb, 0, 3), ok, ol, os);
      if (os < m) break;
      k = ok;
      l = ol;
      s = os;
      --ib;
      qb = qn;
    }
  }
  r[e] = ib;
  bst[3 * e] = k;
  bst[3 * e + 1] = l;
  bst[3 * e + 2] = s;
}

template <typename T>
int launch(int M, int L, int itb, void* const* p, const void* blocks,
           const void* L2, long long seq_len, long long primary,
           cudaStream_t stream) {
  const int threads = 128;
  if (M > 0)
    bwd_kernel<T><<<(M + threads - 1) / threads, threads, 0, stream>>>(
        M, L, itb, (const int32_t*)p[0], (const int32_t*)p[1],
        (const T*)p[2], (const int32_t*)p[3], (const T*)p[4],
        (const int32_t*)p[5], (int32_t*)p[6], (T*)p[7], blocks,
        (const T*)L2, seq_len, primary);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, read_id, bst0 [M, 3], i_b0, mi, total (one int32), r [M] out,
// bst [M, 3] out. wide: coordinates int64 (else int32). Returns
// cudaGetLastError().
extern "C" int seed_bwd_launch(int wide, int M, int L, int itb,
                               void* const* ptrs, const void* fm_blocks,
                               const void* L2, long long seq_len,
                               long long primary, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return launch<int64_t>(M, L, itb, ptrs, fm_blocks, L2, seq_len,
                           primary, s);
  return launch<int32_t>(M, L, itb, ptrs, fm_blocks, L2, seq_len, primary,
                         s);
}

extern "C" const char* seed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
