// The LF walk of SA lookup on NVIDIA Hopper (sm_90a): one launch a
// sa_batch call, every phase inside it.
//
// Replaces the XLA loops of bwa_flow_tpu/ops/fm_jax.py: _lf_walk_fixed
// (:338-380, a fori_loop in 64k-lane chunks), sa_batch's while_loops
// (:438, :457) and the compaction between them (compact_pool, :409). It
// computes what the plain PyTorch version
// bwa_flow_tpu_torch/ops/fm_torch.py::_sa_walk_plain computes (the
// contract at the top of sa_walk.cuh), outputs included: each slot's SA
// value as int64 and its overflow flag. The caller's rows are read and
// never written; nothing is read back by the host.
//
// What bounds it on the H100: a lane's chain of dependent 32-byte
// fm_blocks row gathers, one an LF step; on a genome whose index is
// larger than the 50 MB L2 each comes from HBM (about 330 ns). A call's
// time is therefore its longest lane's total steps times that latency,
// plus what keeps lanes from starting. The design keeps only that chain:
// one launch for the three phases (no launch between them, no torch
// compaction or copies on the host's stream); each block reads its slots
// once and walks a queue of its live lanes in shared memory, so the
// 70-80% of slots dead on entry hold no thread, a thread whose lane dies
// takes the next one, and a lane stays in its block from its first step
// to its last; a block owns as many slots as it has threads (256), so the
// live lanes, which the seed program's fused walk packs at the front of
// its slots, spread over many blocks and SMs (blocks of 1024 slots left
// each front block about 3 lanes a thread, and were slower: PERF.md §6),
// and the lanes dead on entry are written after the next barrier, off
// the block's path. Blocks waiting on a look-back read their window
// coalesced and sleep between reads, so they do not crowd the L2 lines
// the other blocks publish to.
//
// Why the ranks are exact: a pool takes the first cap live lanes in lane
// order. Each block owns a contiguous range of slots and keeps its queue
// in lane order, so a lane's rank is the live lanes of the earlier blocks
// plus its queue position. The earlier blocks' count comes from a
// decoupled look-back (sa_walk.cuh: exclusive_prefix) on status words in
// per-call scratch; blocks number themselves from an atomic ticket, so
// every block they wait on is resident and never waits on them. A block
// whose count plus the earlier blocks' fits the pool walks its whole
// queue; the others walk the first cap - (the earlier blocks' count).

#include <cstdint>
#include <cuda_runtime.h>

#include "sa_walk.cuh"

namespace {

constexpr int kThreads = 256;   // threads, and slots, a block

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    sa_walk_kernel(const __grid_constant__ sawalk::Params<T, S> p) {
  __shared__ __align__(16) unsigned char
      smem[sawalk::shared_bytes<T, kThreads>()];
  sawalk::walk_block<T, S, kThreads>(p, smem, (int)threadIdx.x);
}

template <typename T, typename S>
int launch(const sawalk::Params<T, S>& p, cudaStream_t stream) {
  if (p.n <= 0) return (int)cudaSuccess;
  sa_walk_kernel<T, S><<<p.nblocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The slots a block owns: a call of n slots takes ceil(n / this) blocks,
// and its scratch 1 + (phases - 1) * that many int64 words.
extern "C" int sa_walk_slots() { return kThreads; }

// One sa_batch call of n slots (rows k) on `stream`: sa (int64 [n]) and
// ovf (bool [n]) written. phases 3 (budgets 2 intv, 4 intv, max_iters;
// pools of n/4 and n/16) or 1 (budget0 = max_iters); mask = sa_intv - 1,
// intv_shift = log2(sa_intv). wide: coordinates int64 (else int32);
// sa_wide: the sampled SA int64 (else int32). scratch: zero. Returns
// cudaGetLastError().
extern "C" int sa_walk_launch(int wide, int sa_wide, int n, int phases,
                              int budget0, int budget1, int budget2,
                              long long mask, int intv_shift, const void* k,
                              void* sa, void* ovf, const void* samples,
                              long long n_samples, const void* fm_blocks,
                              const void* L2, long long seq_len,
                              long long primary, void* scratch,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SA_WALK_AS(T, S)                                                   \
  launch<T, S>(sawalk::make_params<T, S, kThreads>(                        \
                   n, phases, budget0, budget1, budget2, mask, intv_shift, \
                   k, sa, ovf, samples, n_samples, fm_blocks, L2, seq_len, \
                   primary, scratch),                                      \
               s)
  if (wide)
    return sa_wide ? SA_WALK_AS(int64_t, int64_t)
                   : SA_WALK_AS(int64_t, int32_t);
  return sa_wide ? SA_WALK_AS(int32_t, int64_t)
                 : SA_WALK_AS(int32_t, int32_t);
#undef SA_WALK_AS
}

extern "C" const char* sa_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
