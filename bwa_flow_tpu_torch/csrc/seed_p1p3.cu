// The seed program's pass 1 forward scan fused with pass 3 (LAST-like
// seeding), four threads a lane, on NVIDIA Hopper (sm_90a).
//
// Replaces the XLA while_loop of bwa_flow_tpu/ops/smem_jax.py:400
// (_p1p3_machine, :355-404). Same contract as the plain PyTorch version
// bwa_flow_tpu_torch/ops/smem_torch.py::_p1p3_machine: lanes [0, B) are
// pass 1's forward scans (one a read: pivot acquisition from the packed
// symbol table, forward bwt_extend, break intervals recorded into the
// lane's [3, NB] stores), lanes [B, 2B) pass 3's scans (pivot, forward
// walk, a mem emitted into the lane's [4, NP3] slots when the interval
// drops below max_mem_intv after min_seed_len). The step functions are
// _fwd_pre2/_fwd_post and _p3_pre2/_p3_post written out for one lane.
//
// Why a lane can run to its end on its own: a lane reads only its own
// state, its read's row of the symbol table and the index, and a lane in
// mode 3 is a fixed point of the step. The plain version runs every lane
// until all are in mode 3 or ITERS steps have passed; a lane that stops
// at mode 3, or after ITERS steps of its own, ends in the same state, and
// a lane left short of mode 3 sets its overflow bit as there. Every store
// lands in the lane's own slots, so the outputs are equal bit for bit.
// The state arrays are updated in place (the wrapper passes copies).
//
// What bounds it on the H100: a lane's steps are a serial chain of
// dependent FM row gathers, so it is bound by latency, not by bytes or
// operations; the index (a 4.6 Mbp genome: ~4.6 MB of rows) sits in the
// 50 MB L2, so a gather costs an L2 hit. The design keeps many lanes in
// flight on every SM and puts nothing else on the chain:
//   - a quad of threads runs one lane: the four hold the same state and
//     take the same branches, and thread j counts word j of the probe's
//     rows (seed_fm.cuh's one-symbol probe), two quad shuffles summing
//     the counts; 2B lanes are 8B threads, and the wrapper picks blocks
//     of 32, 16 or 8 lanes so that every SM gets a block
//     (smem_cuda.p1p3_geometry);
//   - the lane's row of the symbol table, both halves (symbols and packed
//     pivots), is staged in shared memory at lane start, so a step's only
//     global gather is the FM row. The stage is int16: the pivot value
//     (p << 6) | ... fits for L <= 511 (smem_cuda.P1P3_MAX_L). Above that
//     the kernel's other variant (kStage = false) stages nothing and reads
//     the table from global memory through the read-only cache, which
//     needs no shared memory and so works at any L;
//   - nothing is indexed by a runtime value, so nothing goes to the stack.
// A warp holds 8 lanes, so it waits on its longest of 8, not of 32.

#include <cstdint>
#include <cuda_runtime.h>

#include "seed_fm.cuh"
#include "seed_quad.cuh"

namespace {

using seedfm::clampi;
using seedfm::FM;
using seedfm::pick4;
using seedquad::pick3;
using seedquad::probe;
using seedquad::Quad;

template <typename T>
struct P1P3Args {
  int B, L, NB, NP3, iters, min_seed_len;
  long long max_mem_intv;
  const int32_t* sym;      // [2 * B * L]: symbols, then the pivot table
  const int32_t* read_id;  // pass 1 [B]
  const int32_t* qlen1;    // pass 1 [B]
  const int32_t* qlen3;    // pass 3 [B]
  // pass 1 state
  int32_t *mode1, *x1, *i1, *info1, *g1, *nb1;
  T* ik1;                  // [B, 3]
  T* brk_kls;              // [B, 3, NB]
  int32_t* brk_meta;       // [B, 3, NB]: (ik_info, x, g)
  uint8_t* ovf1;
  // pass 3 state
  int32_t *mode3, *x3, *i3;
  T* ik3;                  // [B, 3]
  T* mems;                 // [B, 4, NP3]: (k, l, s, info)
  int32_t* n_mem;
  uint8_t* ovf3;
};

template <typename T>
__device__ __forceinline__ T pack_info(int start, int end) {
  if (sizeof(T) == 4) return (T)((start << 16) | end);
  return (T)(((long long)start << 32) | (long long)end);
}

// A value of the lane's symbol-table row: staged in shared memory (int16),
// or read from global memory through the read-only cache (int32)
__device__ __forceinline__ int sym_at(const int16_t* row, int p) {
  return row[p];
}
__device__ __forceinline__ int sym_at(const int32_t* row, int p) {
  return __ldg(row + p);
}

// sq, sp: the lane's symbols and pivot table (L each), staged (S =
// int16_t) or in global memory (S = int32_t)
template <typename T, typename S>
__device__ __forceinline__ void pass1_lane(const P1P3Args<T>& a,
                                           const FM<T>& fm, const Quad& q,
                                           const S* sq, const S* sp,
                                           int b) {
  const int L = a.L, NB = a.NB;
  int mode = a.mode1[b], x = a.x1[b], i = a.i1[b];
  int ik_info = a.info1[b], g = a.g1[b], nb = a.nb1[b];
  bool ovf = a.ovf1[b] != 0;
  T k = a.ik1[3 * b], l = a.ik1[3 * b + 1], s = a.ik1[3 * b + 2];
  const int qlen = a.qlen1[b];
  T* kls = a.brk_kls + (long long)b * 3 * NB;
  int32_t* meta = a.brk_meta + (long long)b * 3 * NB;
  for (int it = 0; it < a.iters && mode != 3; ++it) {
    const bool m0 = mode == 0;
    const int val = m0 ? sym_at(sp, clampi(x, 0, L - 1))
                       : sym_at(sq, clampi(i, 0, L - 1));
    // _fwd_pre2: pivot acquisition
    const int cand = x < L ? (val >> 6) : L;
    const bool found = cand < L;
    if (m0) {
      mode = found ? 1 : 3;
      if (found) {
        x = cand;
        fm.set_intv((val >> 3) & 7, k, l, s);
        ik_info = x + 1;
        i = x + 1;
        ++g;
      }
    }
    if (mode != 1) continue;
    const int q_i = val & 7;
    // _fwd_post after the shared probe
    T ok, ol, os;
    probe(fm, q, k, l, s, clampi(3 - q_i, 0, 3), ok, ol, os);
    const bool end_now = i >= qlen || q_i > 3;
    const bool changed = os != s;
    const bool die = changed && os < (T)1;
    const bool push = end_now || changed;
    const bool to_next = end_now || die;
    bool nb_ovf = false;
    if (push) {
      if (nb >= NB) {
        nb_ovf = true;
      } else {
        if (q.j < 3) {   // thread j stores row j
          kls[q.j * NB + nb] = pick3(q.j, k, l, s);
          meta[q.j * NB + nb] = pick3(q.j, ik_info, x, g);
        }
        ++nb;
      }
    }
    if (!to_next) {
      k = ok;
      l = ol;
      s = os;
      ik_info = i + 1;
      i = i + 1;
    } else {
      // next pivot = end of the longest match (= the last push's end)
      x = ik_info;
      mode = 0;
    }
    if (nb_ovf) {
      mode = 3;
      ovf = true;
    }
  }
  if (q.j == 0) {
    a.mode1[b] = mode;
    a.x1[b] = x;
    a.i1[b] = i;
    a.info1[b] = ik_info;
    a.g1[b] = g;
    a.nb1[b] = nb;
    a.ovf1[b] = (ovf || mode != 3) ? 1 : 0;
  }
  if (q.j < 3) a.ik1[3 * b + q.j] = pick3(q.j, k, l, s);
}

template <typename T, typename S>
__device__ __forceinline__ void pass3_lane(const P1P3Args<T>& a,
                                           const FM<T>& fm, const Quad& q,
                                           const S* sq, const S* sp,
                                           int b) {
  const int L = a.L, NP3 = a.NP3;
  int mode = a.mode3[b], x = a.x3[b], i = a.i3[b], n = a.n_mem[b];
  bool ovf = a.ovf3[b] != 0;
  T k = a.ik3[3 * b], l = a.ik3[3 * b + 1], s = a.ik3[3 * b + 2];
  const int qlen = a.qlen3[b];
  T* slots = a.mems + (long long)b * 4 * NP3;
  for (int it = 0; it < a.iters && mode != 3; ++it) {
    const bool m0 = mode == 0;
    const int val = m0 ? sym_at(sp, clampi(x, 0, L - 1))
                       : sym_at(sq, clampi(i, 0, L - 1));
    // _p3_pre2
    const int cand = x < L ? (val >> 6) : L;
    const bool found = cand < L;
    if (m0) {
      mode = found ? 1 : 3;
      if (found) {
        x = cand;
        fm.set_intv((val >> 3) & 7, k, l, s);
        i = x + 1;
      }
    }
    if (mode != 1) continue;
    const int q_i = val & 7;
    // _p3_post
    T ok, ol, os;
    probe(fm, q, k, l, s, clampi(3 - q_i, 0, 3), ok, ol, os);
    const bool ended = i >= qlen;
    const bool amb = !ended && q_i > 3;
    const bool live = !ended && !amb;
    const bool hit = live && (long long)os < a.max_mem_intv &&
                     (i - x) >= a.min_seed_len;
    if (hit && os > 0) {
      if (n >= NP3) {
        ovf = true;
      } else {
        // thread j stores row j
        slots[q.j * NP3 + n] = pick4(q.j, ok, ol, os, pack_info<T>(x, i + 1));
        ++n;
      }
    }
    const int i_old = i;
    if (live && !hit) {
      k = ok;
      l = ol;
      s = os;
      i = i + 1;
    }
    if (ended) x = qlen;
    else if (amb || hit) x = i_old + 1;
    if (ended || amb || hit) mode = 0;
  }
  if (q.j == 0) {
    a.mode3[b] = mode;
    a.x3[b] = x;
    a.i3[b] = i;
    a.n_mem[b] = n;
    a.ovf3[b] = (ovf || mode != 3) ? 1 : 0;
  }
  if (q.j < 3) a.ik3[3 * b + q.j] = pick3(q.j, k, l, s);
}

// Four threads a lane. kStage: the lane's symbol-table row is staged in
// dynamic shared memory, 2 * L + 2 int16 a lane (L <= 511); else the
// lane reads it from global memory (any L).
template <typename T, bool kStage>
__global__ void __launch_bounds__(128)
    p1p3_kernel(P1P3Args<T> a, const void* blocks, const T* L2,
                long long seq_len, long long primary) {
  extern __shared__ int16_t stage[];
  const int lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 2);
  if (lane >= 2 * a.B) return;   // a quad shares its lane, so all 4 leave
  const Quad q(threadIdx.x);
  const int L = a.L;
  const bool first = lane < a.B;
  const int b = first ? lane : lane - a.B;
  // the lane's read row of both halves of the symbol table
  const long long row = (long long)(first ? a.read_id[b] : b) * L;
  const int32_t* src_q = a.sym + row;
  const int32_t* src_p = a.sym + (long long)a.B * L + row;
  const FM<T> fm(blocks, L2, seq_len, primary);
  if constexpr (kStage) {
    // a lane's 2L int16 and one word more, so the 8 lanes of a warp read
    // different banks
    int16_t* sq = stage + (threadIdx.x >> 2) * (2 * L + 2);
    int16_t* sp = sq + L;
#pragma unroll 8
    for (int p = q.j; p < L; p += 4) {
      sq[p] = (int16_t)__ldg(src_q + p);
      sp[p] = (int16_t)__ldg(src_p + p);
    }
    __syncwarp(q.mask);
    if (first) pass1_lane(a, fm, q, (const int16_t*)sq, (const int16_t*)sp,
                          b);
    else pass3_lane(a, fm, q, (const int16_t*)sq, (const int16_t*)sp, b);
  } else {
    if (first) pass1_lane(a, fm, q, src_q, src_p, b);
    else pass3_lane(a, fm, q, src_q, src_p, b);
  }
}

template <typename T>
int launch(P1P3Args<T> a, int threads, bool stage, const void* blocks,
           const void* L2, long long seq_len, long long primary,
           cudaStream_t stream) {
  // the int16 stage holds L <= 511 only
  if (threads <= 0 || threads > 128 || threads % 32 != 0 || a.L <= 0 ||
      (stage && a.L > 511))
    return (int)cudaErrorInvalidValue;
  const long long n = 8LL * a.B;   // 2B lanes, four threads each
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((n + threads - 1) / threads);
  if (!stage) {
    p1p3_kernel<T, false><<<grid, threads, 0, stream>>>(
        a, blocks, (const T*)L2, seq_len, primary);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)(threads / 4) * (2 * a.L + 2) * sizeof(int16_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        p1p3_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  p1p3_kernel<T, true><<<grid, threads, smem, stream>>>(
      a, blocks, (const T*)L2, seq_len, primary);
  return (int)cudaGetLastError();
}

template <typename T>
P1P3Args<T> args(int B, int L, int NB, int NP3, int iters, int min_seed_len,
                 long long max_mem_intv, void* const* p) {
  P1P3Args<T> a;
  a.B = B; a.L = L; a.NB = NB; a.NP3 = NP3; a.iters = iters;
  a.min_seed_len = min_seed_len; a.max_mem_intv = max_mem_intv;
  a.sym = (const int32_t*)p[0];
  a.read_id = (const int32_t*)p[1];
  a.qlen1 = (const int32_t*)p[2];
  a.qlen3 = (const int32_t*)p[3];
  a.mode1 = (int32_t*)p[4]; a.x1 = (int32_t*)p[5]; a.i1 = (int32_t*)p[6];
  a.info1 = (int32_t*)p[7]; a.g1 = (int32_t*)p[8]; a.nb1 = (int32_t*)p[9];
  a.ik1 = (T*)p[10]; a.brk_kls = (T*)p[11];
  a.brk_meta = (int32_t*)p[12]; a.ovf1 = (uint8_t*)p[13];
  a.mode3 = (int32_t*)p[14]; a.x3 = (int32_t*)p[15]; a.i3 = (int32_t*)p[16];
  a.ik3 = (T*)p[17]; a.mems = (T*)p[18]; a.n_mem = (int32_t*)p[19];
  a.ovf3 = (uint8_t*)p[20];
  return a;
}

}  // namespace

// ptrs: the 21 device pointers of P1P3Args in its order (sym ... ovf3).
// wide: coordinates int64 (else int32). threads: a block's threads, a
// multiple of 32 up to 128 (four a lane). stage: stage the symbol table
// in shared memory (L <= 511), else read it from global memory. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a block size, an L < 1
// or a staged L above 511.
extern "C" int seed_p1p3_launch(int wide, int threads, int stage, int B,
                                int L, int NB,
                                int NP3, int iters, int min_seed_len,
                                long long max_mem_intv, void* const* ptrs,
                                const void* fm_blocks, const void* L2,
                                long long seq_len, long long primary,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return launch(args<int64_t>(B, L, NB, NP3, iters, min_seed_len,
                                max_mem_intv, ptrs),
                  threads, stage != 0, fm_blocks, L2, seq_len, primary, s);
  return launch(args<int32_t>(B, L, NB, NP3, iters, min_seed_len,
                              max_mem_intv, ptrs),
                threads, stage != 0, fm_blocks, L2, seq_len, primary, s);
}

extern "C" const char* seed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
