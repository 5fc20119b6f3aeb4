// The LF walk of SA lookup, one thread a lane, on NVIDIA Hopper (sm_90a).
//
// Replaces the XLA loops of bwa_flow_tpu/ops/fm_jax.py: _lf_walk_fixed
// (:338-380, a fori_loop in 64k-lane chunks) and sa_batch's while_loops
// (:438, :457). Same contract as the plain PyTorch version
// bwa_flow_tpu_torch/ops/fm_torch.py::_lf_walk_plain: each lane below the
// live count walks its row k back by LF steps while (k & mask) != 0, at
// most `steps` steps, counting them in s; a lane that is dead, and every
// slot at or past the live count (a pool's padding), is left as it is.
// The live count is read from device memory (an int32 that the caller's
// compaction wrote on the card; none: all n lanes), so no caller reads
// the card to launch the walk.
//
// What bounds it on the H100: a lane's chain of dependent 32-byte FM row
// gathers, one a step; on a genome whose index is larger than the 50 MB
// L2 each comes from HBM. The design keeps the chain to one gather a
// step (FM::lf: one row gives the symbol and its count, c is picked by
// selects, no stack), runs each lane to its end in one thread, and sends
// the pool's padding slots and the lanes dead on entry away after one
// read, so only the lanes that walk hold a warp.

#include <cstdint>
#include <cuda_runtime.h>

#include "sa_walk.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    sa_walk_kernel(int n, int steps, T mask, T* __restrict__ kk,
                   T* __restrict__ st, const int32_t* __restrict__ live,
                   const void* blocks, const T* L2, long long seq_len,
                   long long primary) {
  sawalk::walk_slot<T>(blockIdx.x * blockDim.x + threadIdx.x, n, steps,
                       mask, kk, st, live, blocks, L2, seq_len, primary);
}

template <typename T>
int launch(int n, int steps, long long mask, void* kk, void* st,
           const void* live, const void* blocks, const void* L2,
           long long seq_len, long long primary, cudaStream_t stream) {
  const int threads = 256;
  if (n > 0 && steps > 0)
    sa_walk_kernel<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
        n, steps, (T)mask, (T*)kk, (T*)st, (const int32_t*)live, blocks,
        (const T*)L2, seq_len, primary);
  return (int)cudaGetLastError();
}

}  // namespace

// kk, st: the lanes' rows and step counts [n], updated in place; live:
// one int32 on the card, the count of leading slots that hold lanes (null:
// all n). wide: coordinates int64 (else int32). Returns
// cudaGetLastError().
extern "C" int sa_walk_launch(int wide, int n, int steps, long long mask,
                              void* kk, void* st, const void* live,
                              const void* fm_blocks, const void* L2,
                              long long seq_len, long long primary,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return launch<int64_t>(n, steps, mask, kk, st, live, fm_blocks, L2,
                           seq_len, primary, s);
  return launch<int32_t>(n, steps, mask, kk, st, live, fm_blocks, L2,
                         seq_len, primary, s);
}

extern "C" const char* sa_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
