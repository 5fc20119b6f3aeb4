// The per-block logic of the LF walk of SA lookup (sa_walk.cu): one
// logical block's share of one sa_batch call, every phase of it.
//
// The contract (the plain PyTorch version, ops/fm_torch.py::
// _sa_walk_plain, and the JAX package's fm_jax.sa_batch). Lane i of the
// n slots is live while its row is not a sampled one ((k & mask) != 0);
// each step of a live lane maps its row one LF step back (FM::lf of
// seed_fm.cuh) and counts the step. With three phases (intv > 0 and
// n >= 64): every lane walks at most budget0 = 2 intv steps; a lane still
// live then walks budget1 = 4 intv more if fewer than cap0 = n/4 live
// lanes come before it in lane order; a lane still live after that
// (walked or not) walks budget2 = max_iters more if fewer than cap1 =
// n/16 still-live lanes come before it. With one phase, every lane walks
// at most budget0 = max_iters steps. A lane still live at the end
// overflows. Its value is steps + samples[clamp(k >> intv_shift)], in the
// promoted type of the steps (T) and the samples (S), as int64.
//
// A block of NT threads owns NT slots in lane order, [ticket * NT, + NT),
// one a thread. It reads them once, coalesced, and queues the live lanes
// (their slot numbers, in lane order) in shared memory beside their rows
// and step counts; a lane dead on entry is finished by its thread after
// the next barrier, off the block's path. Threads take queued lanes one at
// a time from a shared counter and walk each to its death or to the
// phase's budget, so a thread whose lane dies takes the next one and no
// thread waits on a dead slot. After each phase but the last the block
// re-queues its live lanes, still in lane order (the dead are finished
// after the next barrier), and learns how many live lanes the earlier
// blocks hold (a decoupled look-back over per-block status words); the
// first cap - that many of its queue walk the next phase. Blocks take
// their logical numbers from an atomic ticket, so a block waits only on
// blocks that started before it, which are resident and never wait on
// it: the look-back cannot deadlock, on one wave or several. A block as
// small as its threads keeps a call's live lanes, which its callers pack
// at the front (the seed program's fused walk), spread over many SMs.
//
// The header needs nothing of CUDA beyond __device__, __forceinline__,
// __ldg, __syncthreads, __ballot_sync, __any_sync, __reduce_add_sync,
// __reduce_min_sync, __nanosleep, __popc, atomicAdd (and seed_fm.cuh's
// stand-ins), so
// tests/test_torch_sa_walk_host.py compiles it with the host's c++ under
// a stand-in for those that runs a block's threads as host threads.

#pragma once

#include <cstddef>
#include <cstdint>

#include "seed_fm.cuh"

namespace sawalk {

// a status word: a flag in the high half, a count of live lanes in the
// low half (at most n < 2^31); 0 means not published yet
constexpr unsigned long long kCount = 1ull << 32;    // the block's own
constexpr unsigned long long kPrefix = 2ull << 32;   // through this block

// One sa_batch call. scratch: [0] the ticket (its low 32 bits), then
// phases - 1 arrays of nblocks status words, all zero at launch.
template <typename T, typename S>
struct Params {
  const T* k;                  // [n] the rows, read only
  long long* sa;               // [n] out
  uint8_t* ovf;                // [n] out: still live at the end
  const S* samples;            // the sampled SA
  long long n_samples;
  const void* blocks;          // fm_blocks
  const T* L2;
  long long seq_len, primary;
  unsigned long long* scratch;
  T mask;                      // sa_intv - 1
  int intv_shift;              // log2(sa_intv)
  int n, nblocks, phases;
  int budget0, budget1, budget2, cap0, cap1;
};

// The Params of a call of n slots in blocks of NT (sa_walk.cu's launcher
// and the host harness build them here): phases 3 (budgets 2 intv,
// 4 intv, max_iters; pools of n/4 and n/16 lanes) or 1 (budget0 =
// max_iters).
template <typename T, typename S, int NT>
__host__ __device__ inline Params<T, S> make_params(
    int n, int phases, int budget0, int budget1, int budget2,
    long long mask, int intv_shift, const void* k, void* sa, void* ovf,
    const void* samples, long long n_samples, const void* blocks,
    const void* L2, long long seq_len, long long primary, void* scratch) {
  Params<T, S> p;
  p.k = (const T*)k;
  p.sa = (long long*)sa;
  p.ovf = (uint8_t*)ovf;
  p.samples = (const S*)samples;
  p.n_samples = n_samples;
  p.blocks = blocks;
  p.L2 = (const T*)L2;
  p.seq_len = seq_len;
  p.primary = primary;
  p.scratch = (unsigned long long*)scratch;
  p.mask = (T)mask;
  p.intv_shift = intv_shift;
  p.n = n;
  p.nblocks = (n + NT - 1) / NT;
  p.phases = phases;
  p.budget0 = budget0;
  p.budget1 = budget1;
  p.budget2 = budget2;
  p.cap0 = n / 4;
  p.cap1 = n / 16;
  return p;
}

// A block's shared memory: the control words, then its slots' rows and
// step counts, and the queue.
template <int NT>
struct Control {
  int ticket, next, excl;
  int warp_total[NT / 32];
};

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

template <typename T, int NT>
__host__ __device__ constexpr size_t shared_bytes() {
  return align16(sizeof(Control<NT>)) + align16(NT * (sizeof(T) + 4)) +
         align16(NT * sizeof(uint16_t));
}

// A status word, published and observed at device scope. Each word is
// written once, whole, with its flag, and no other data is read through
// it, so relaxed stores and loads suffice (a release store would wait
// for the block's earlier result stores), and a lane's loads of a window
// stay independent (in flight together).
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
#if defined(__CUDA_ARCH__)
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
#endif
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* p) {
#if defined(__CUDA_ARCH__)
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

// The flags set before this thread's (in thread order) and, in total, the
// block's: one ballot a warp, the warps' totals through shared memory.
// Every thread of the block calls it.
template <int NT>
__device__ __forceinline__ int block_rank(bool f, int tid, int* warp_total,
                                          int& total) {
  const unsigned b = __ballot_sync(0xFFFFFFFFu, f);
  const int lane = tid & 31, w = tid >> 5;
  if (lane == 0) warp_total[w] = __popc(b);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int j = 0; j < NT / 32; ++j) {
    const int c = warp_total[j];
    before += j < w ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + __popc(b & ((1u << lane) - 1u));
}

// Status words a lane of the look-back reads at once: a window of 32 x
// kWindow earlier blocks costs one round trip to the L2.
constexpr int kWindow = 8;

// Block b's count of live lanes published in `status` (one scan's
// words), and the live lanes of all earlier blocks returned to every
// thread. Warp 0 looks back a window of 32 x kWindow blocks at a time,
// each lane reading kWindow words at once: the nearest block that has
// published its inclusive prefix ends the sum (block 0 publishes one at
// once, and so does every block once it knows its own), and the window
// is read again, after a short sleep, until every block nearer than that
// has published its count, so the waiting warps read a window coalesced
// and seldom. Exact: each word is written once with its flag, so a count
// is never read half-made.
template <int NT>
__device__ __forceinline__ int exclusive_prefix(unsigned long long* status,
                                                int b, int count, int tid,
                                                int* out) {
  if (tid < 32) {
    const int lane = tid;
    if (lane == 0)
      publish(status + b, (b == 0 ? kPrefix : kCount) | (unsigned)count);
    unsigned excl = 0;
    for (int j = b - 1; j >= 0; j -= 32 * kWindow) {
      unsigned long long v[kWindow];
      unsigned near;   // the distance (lane + 32 u) of the nearest prefix
      for (;;) {
#pragma unroll
        for (int u = 0; u < kWindow; ++u) {
          const int p = j - lane - 32 * u;
          v[u] = p >= 0 ? observe(status + p) : kPrefix;   // before block 0
        }
        near = 32 * kWindow;
#pragma unroll
        for (int u = kWindow - 1; u >= 0; --u)
          if ((v[u] >> 32) == 2) near = lane + 32 * u;
        near = __reduce_min_sync(0xFFFFFFFFu, near);
        bool missing = false;
#pragma unroll
        for (int u = 0; u < kWindow; ++u)
          missing |= (unsigned)(lane + 32 * u) < near && (v[u] >> 32) == 0;
        if (!__any_sync(0xFFFFFFFFu, missing)) break;
        __nanosleep(128);
      }
      unsigned add = 0;
#pragma unroll
      for (int u = 0; u < kWindow; ++u)
        add += (unsigned)(lane + 32 * u) <= near ? (unsigned)v[u] : 0u;
      excl += __reduce_add_sync(0xFFFFFFFFu, add);
      if (near < 32 * kWindow) break;
    }
    if (lane == 0) {
      if (b > 0) publish(status + b, kPrefix | (excl + (unsigned)count));
      *out = (int)excl;
    }
  }
  __syncthreads();
  return *out;
}

// A block with no live lane left publishes a count of 0 in the scans
// from `from` on (block 0 as its prefix), and needs no look-back.
__device__ __forceinline__ void retire(unsigned long long* status,
                                       int nblocks, int phases, int b,
                                       int from, int tid) {
  if (tid == 0)
    for (int sc = from; sc < phases - 1; ++sc)
      publish(status + (size_t)sc * nblocks + b, b == 0 ? kPrefix : kCount);
}

// A lane's result: its value and overflow flag, in slot `slot`.
template <typename T, typename S>
__device__ __forceinline__ void finish(const Params<T, S>& p, long long slot,
                                       T k, int s, bool live) {
  T j = k >> p.intv_shift;   // floor division by sa_intv, as the plain's //
  const long long jj =
      j < 0 ? 0 : ((long long)j > p.n_samples - 1 ? p.n_samples - 1
                                                   : (long long)j);
  const S v = __ldg(p.samples + jj);
  long long out;
  if constexpr (sizeof(T) == 4 && sizeof(S) == 4)
    out = (int32_t)((uint32_t)s + (uint32_t)v);   // int32 + int32 wraps
  else
    out = (long long)s + (long long)v;
  p.sa[slot] = out;
  p.ovf[slot] = live ? 1 : 0;
}

// Walk queue entries [0, m) to their deaths or `budget` steps each: each
// thread takes an entry from the shared counter `next`, and another when
// its lane is done, in one loop, so a warp's lanes refill on their own.
template <typename T>
__device__ __forceinline__ void walk_queue(const seedfm::FM<T>& fm, T mask,
                                           int budget, int m, int* next,
                                           const uint16_t* q, T* row,
                                           int* st) {
  int e = atomicAdd(next, 1);
  if (e >= m) return;
  int i = q[e];
  T k = row[i];
  int s = st[i], end = s + budget;
  for (;;) {
    if (s < end && (k & mask) != 0) {
      k = fm.lf(k);
      ++s;
      continue;
    }
    row[i] = k;
    st[i] = s;
    e = atomicAdd(next, 1);
    if (e >= m) return;
    i = q[e];
    k = row[i];
    s = st[i];
    end = s + budget;
  }
}

// What every thread (tid of NT) of one block does: the block's slots
// through every phase of the call. smem: shared_bytes<T, NT>() bytes.
template <typename T, typename S, int NT>
__device__ __forceinline__ void walk_block(const Params<T, S>& p,
                                           unsigned char* smem, int tid) {
  Control<NT>* c = (Control<NT>*)smem;
  T* row = (T*)(smem + align16(sizeof(Control<NT>)));
  int* st = (int*)(row + NT);
  uint16_t* q = (uint16_t*)(smem + align16(sizeof(Control<NT>)) +
                            align16(NT * (sizeof(T) + 4)));
  if (tid == 0) c->ticket = (int)atomicAdd((unsigned*)p.scratch, 1u);
  __syncthreads();
  const int b = c->ticket;
  const long long base = (long long)b * NT;
  const int cnt = (long long)p.n - base < NT ? (int)(p.n - base) : NT;
  unsigned long long* status = p.scratch + 1;

  // the slots, one a thread, read once; the live queue in lane order
  T k = 0;
  bool live = false;
  if (tid < cnt) {
    k = p.k[base + tid];
    live = (k & p.mask) != 0;
  }
  int nq;
  int pos = block_rank<NT>(live, tid, c->warp_total, nq);
  if (live) {
    row[tid] = k;
    st[tid] = 0;
    q[pos] = (uint16_t)tid;
  }
  // a dead lane this thread finishes after the next barrier: slot, row,
  // steps (-1: none)
  int di = tid < cnt && !live ? tid : -1, ds = 0;
  T dk = k;
  if (nq == 0) {   // no live lane: every scan counts none of this block
    if (di >= 0) finish(p, base + di, dk, ds, false);
    retire(status, p.nblocks, p.phases, b, 0, tid);
    return;
  }
  int m = nq;   // the first phase walks every queued lane
  for (int ph = 0;; ++ph) {
    if (tid == 0) c->next = 0;
    __syncthreads();
    if (di >= 0) finish(p, base + di, dk, ds, false);
    const int budget =
        ph == 0 ? p.budget0 : (ph == 1 ? p.budget1 : p.budget2);
    {
      // built for each walk: held across the whole block, the int64
      // view's FM pushed a register to the stack
      const seedfm::FM<T> fm(p.blocks, p.L2, p.seq_len, p.primary);
      walk_queue(fm, p.mask, budget, m, &c->next, q, row, st);
    }
    __syncthreads();
    if (ph == p.phases - 1) break;
    // re-queue the live in lane order, one entry a thread (in place: each
    // entry is read before the barriers of block_rank, written after)
    int i = 0;
    di = -1;
    live = false;
    if (tid < nq) {
      i = q[tid];
      dk = row[i];
      live = (dk & p.mask) != 0;
      if (!live) {
        di = i;
        ds = st[i];
      }
    }
    pos = block_rank<NT>(live, tid, c->warp_total, nq);
    if (live) q[pos] = (uint16_t)i;
    if (nq == 0) {   // scans ph and on count no lane of this block
      if (di >= 0) finish(p, base + di, dk, ds, false);
      retire(status, p.nblocks, p.phases, b, ph, tid);
      return;
    }
    const int excl = exclusive_prefix<NT>(
        status + (size_t)ph * p.nblocks, b, nq, tid, &c->excl);
    const int cap = ph == 0 ? p.cap0 : p.cap1;
    m = cap - excl <= 0 ? 0 : (cap - excl < nq ? cap - excl : nq);
  }
  // the rest: the last pool's lanes, dead or out of budget, and the lanes
  // it had no room for
  if (tid < nq) {
    const int i = q[tid];
    const T kk = row[i];
    finish(p, base + i, kk, st[i], (kk & p.mask) != 0);
  }
}

}  // namespace sawalk
