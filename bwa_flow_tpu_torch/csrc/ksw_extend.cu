// Batched exact ksw_extend2 (bwa/ksw.c:380-479) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bwa_flow_tpu/ops/extend_pallas.py:550
// (_extend_pallas with the _make_kernel body). Same contract as the
// plain version bwa_flow_tpu_torch/ops/extend_torch.py::extend_core:
// per task, a banded affine-gap extension of a query from a starting
// score h0, returning (score, qle, tle, gtle, gscore, max_off).
//
// What bounds it on the H100: int32 operations over the banded DP cells,
// 10 a cell from the recurrence (an add and a max fuse into one DPX
// instruction). What keeps it from that bound is latency: every target
// row depends on the one before, and within a row bwa's scalar loop
// carries F from column to column, a chain of about 10 dependent
// operations a cell.
//
// Design: one warp per task, 4 warps (tasks) a block, ceil(B / 4) blocks,
// so a wave of 80 tasks runs on 20 SMs. The warp computes a target row
// for all query columns at once, 32 columns (one a lane) per chunk, as
// the plain version and the Pallas body do: F opens from M and not from
// H, so it is a pure max-plus scan, F(j) = max(0, max over beg <= k < j
// of max(M(k) - oe_ins, 0) + k e_ins) - (j-1) e_ins, taken as an
// exclusive prefix max of that ramp over the chunk's lanes (5
// __shfl_up_sync steps) and a running carry from chunk to chunk. The
// chunks' scans do not depend on each other, and their count NCH (qlen /
// 32 + 1) is a template argument, so they unroll into NCH interleaved
// streams: a row costs about one chunk's dependency chain, not one cell's
// chain per column. The row max and its last column come from one
// __reduce_max_sync of (H << 8 | column) (two reductions when a score
// could reach 2^23), the band shrink and H(i, end-1) from three more.
// The DP rows bwa keeps in eh[] stay in registers: each lane holds H[j]
// and E[j] of its own columns, and the write-back's one-column shift is a
// __shfl_up_sync. Only the query profile and the target symbols sit in
// the warp's shared memory; there is no global scratch. The task loop
// and its bookkeeping are in ksw_warp.cuh, shared with the int16 kernel
// ksw_extend16.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "ksw_warp.cuh"

namespace {

constexpr int kMaxChunks = 8;   // qmax < 256
constexpr int kNeg = -(1 << 30);

// Columns a row holds: qmax + 1 rounded up to whole chunks.
__host__ __device__ inline int row_len(int qmax) {
  return 32 * (qmax / 32 + 1);
}

// The query profile qp[6][P] of a task in shared memory (row 5 is zeros:
// the score of a target symbol outside 0..4), int32.
__host__ __device__ inline int row_bytes(int qmax) {
  return 6 * row_len(qmax) * (int)sizeof(int32_t);
}

template <int NCH>
struct RowsI32 {
  static constexpr int kCols = 32;
  const int32_t* qp;
  int P, lane, e_ins, oe_ins, e_del, oe_del;
  // (H << 8 | column) fits int32: one reduction gives m and mj
  bool packed;
  // the DP rows ksw.c keeps in eh[]: H[j] and E[j] of column j = 32c +
  // lane, in this lane's registers
  int H[NCH], E[NCH];

  __device__ __forceinline__ RowsI32(void* smem, const ksw::Params& p,
                                     int lane_, long long hbound)
      : qp((const int32_t*)smem), P(row_len(p.qmax)), lane(lane_),
        e_ins(p.e_ins), oe_ins(p.o_ins + p.e_ins), e_del(p.e_del),
        oe_del(p.o_del + p.e_del), packed(hbound < (1 << 23) - 1) {}

  // The query profile, and the first row (ksw.c:390-396): H[0] = h0, then
  // decay by e_ins from h0 - oe_ins while positive, 0 past qlen; E = 0.
  __device__ __forceinline__ void init(const int32_t* q, int qlen, int h0,
                                       const int* mat) {
    int32_t* prof = (int32_t*)qp;
    for (int j = lane; j < P; j += 32) {
      const int qs = j < qlen ? min(max(q[j], 0), 4) : 0;
      for (int c = 0; c < 5; ++c) prof[c * P + j] = mat[c * 5 + qs];
      prof[5 * P + j] = 0;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int j = c * 32 + lane;
      H[c] = j == 0 ? h0
                    : (j <= qlen ? max(h0 - oe_ins - (j - 1) * e_ins, 0) : 0);
      E[c] = 0;
    }
    __syncwarp();
  }

  // Target row i, target symbol tb, over the band [beg, end): the cells,
  // the row's reductions, then the write-back (H[beg] = h1_init, H[j+1] =
  // H(i, j), E[j] = E(i+1, j) over the band, E[end] = 0). Each step runs
  // over all chunks before the next, so the chunks' independent chains
  // interleave.
  __device__ __forceinline__ void row(int tb, int beg, int end, int h1_init,
                                      ksw::RowOut& r) {
    int S[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) S[c] = qp[tb * P + c * 32 + lane];
    const unsigned band = end - beg;
    bool in[NCH];
    int M[NCH], a[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int j = c * 32 + lane;
      in[c] = (unsigned)(j - beg) < band;
      M[c] = (in[c] && H[c]) ? H[c] + S[c] : 0;   // H[j] is H(i-1, j-1)
      // the F ramp: max(M - oe_ins, 0) + j e_ins, kNeg outside the band
      a[c] = in[c] ? __viaddmax_s32(M[c], -oe_ins, 0) + j * e_ins : kNeg;
    }
    // inclusive prefix max over each chunk's lanes (a lane below d gets
    // its own value back from the shuffle)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) y[c] = __shfl_up_sync(ksw::kFull, a[c], d);
#pragma unroll
      for (int c = 0; c < NCH; ++c) a[c] = max(a[c], y[c]);
    }
    int x[NCH], top[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      x[c] = __shfl_up_sync(ksw::kFull, a[c], 1);
      top[c] = __shfl_sync(ksw::kFull, a[c], 31);
    }
    int carry = kNeg, hmax = -1, key = -1;
    int first = ksw::kBig, last = -1, h1 = -1;
    int Hc[NCH], Eo[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int j = c * 32 + lane;
      // exclusive prefix max over the band's k < j
      const int run = lane ? max(carry, x[c]) : carry;
      carry = max(carry, top[c]);
      // F = max(run - (j-1) e_ins, 0): 0 at beg, where run is kNeg
      const int f = __viaddmax_s32(run, (1 - j) * e_ins, 0);
      Hc[c] = in[c] ? __vimax3_s32(M[c], E[c], f) : -1;
      Eo[c] = __viaddmax_s32_relu(M[c], -oe_del, E[c] - e_del);
      hmax = max(hmax, Hc[c]);
      key = max(key, Hc[c] * 256 + j);     // negative outside the band
      if (j == end - 1) h1 = Hc[c];
      // the band shrink's candidates in the written-back rows: E[j] =
      // E(i+1, j) and H[j+1] = H(i, j)
      const bool ez = in[c] && Eo[c] != 0, hz = in[c] && Hc[c] != 0;
      first = min(first, ez ? j : (hz ? j + 1 : ksw::kBig));
      last = max(last, hz ? j + 1 : (ez ? j : -1));
    }
    // the left neighbour's H(i, j-1), for the shifted write-back
    int up[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      up[c] = __shfl_up_sync(ksw::kFull, Hc[c], 1);
      top[c] = __shfl_sync(ksw::kFull, Hc[c], 31);
    }
    r.first = __reduce_min_sync(ksw::kFull, first);
    r.last = __reduce_max_sync(ksw::kFull, last);
    if (packed) {
      const int km = __reduce_max_sync(ksw::kFull, key);
      r.m = km >> 8;
      r.mj = km & 0xff;
    } else {
      r.m = __reduce_max_sync(ksw::kFull, hmax);
      int jl = -1;                         // last column attaining m
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        if (Hc[c] == r.m) jl = c * 32 + lane;
      r.mj = __reduce_max_sync(ksw::kFull, jl);
    }
    r.h1 = __reduce_max_sync(ksw::kFull, h1);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int j = c * 32 + lane;
      if ((unsigned)(j - beg) <= band) {   // [beg, end]
        H[c] = j == beg ? h1_init : (lane ? up[c] : (c ? top[c - 1] : 0));
        E[c] = j < end ? Eo[c] : 0;
      }
    }
  }
};

__global__ void __launch_bounds__(ksw::kWarps * 32)
ksw_extend2_kernel(ksw::Params p, const int32_t* __restrict__ mat_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int mat[25];
  if (threadIdx.x < 25) mat[threadIdx.x] = mat_in[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * ksw::kWarps + warp;
  if (b >= p.B) return;
  const int rb = row_bytes(p.qmax);
  unsigned char* ws = smem + (size_t)warp * ksw::warp_bytes(rb, p.tmax);
  ksw::run_warp<RowsI32, kMaxChunks>(p, mat, ws, ws + rb, b, lane);
}

}  // namespace

extern "C" int ksw_extend2_launch(
    int B, int qmax, int tmax, const void* query, const void* target,
    const void* qlen, const void* tlen, const void* h0, const void* w,
    const void* mat, int o_del, int e_del, int o_ins, int e_ins,
    int end_bonus, int zdrop, void* out, void* stream) {
  if (B <= 0) return 0;
  if (qmax < 0 || qmax / 32 + 1 > kMaxChunks || tmax < 0)
    return (int)cudaErrorInvalidValue;
  // the query profiles and target symbols of kWarps tasks; above 48 KB a
  // kernel must opt in, and no block may have more than the H100's 227 KB
  const int smem = ksw::kWarps * ksw::warp_bytes(row_bytes(qmax), tmax);
  if (smem + 25 * (int)sizeof(int) > ksw::kSmemBlockMax)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ksw_extend2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const ksw::Params p{B, qmax, tmax, (const int32_t*)query,
                      (const int32_t*)target, (const int32_t*)qlen,
                      (const int32_t*)tlen, (const int32_t*)h0,
                      (const int32_t*)w, o_del, e_del, o_ins, e_ins,
                      end_bonus, zdrop, (int32_t*)out};
  const int blocks = (B + ksw::kWarps - 1) / ksw::kWarps;
  ksw_extend2_kernel<<<blocks, ksw::kWarps * 32, smem,
                       (cudaStream_t)stream>>>(p, (const int32_t*)mat);
  return (int)cudaGetLastError();
}

extern "C" const char* ksw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
