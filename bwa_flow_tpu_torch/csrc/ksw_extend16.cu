// Batched exact ksw_extend2 (bwa/ksw.c:380-479) with int16 DP rows, two
// query columns in each 32-bit word, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bwa_flow_tpu/ops/extend_pallas.py:550
// (_extend_pallas with the _make_kernel16 body, use16=True), which keeps
// its DP rows int16 under the fits_i16 bound. Same contract as the plain
// version bwa_flow_tpu_torch/ops/extend_torch.py::extend_core16 and as
// the int32 kernel ksw_extend.cu: per task, a banded affine-gap extension
// of a query from a starting score h0, returning (score, qle, tle, gtle,
// gscore, max_off).
//
// What bounds it on the H100: operations over the banded DP cells, 10 a
// cell from the recurrence, and since the rows are int16, two cells per
// 32-bit operation with the packed DPX instructions (__viaddmax_s16x2,
// __vimax3_s16x2, ...). What keeps it from that bound is latency, as in
// the int32 kernel: the row-to-row dependency and, in bwa's scalar loop,
// the column-to-column chain of F.
//
// Design: the warp-per-task skeleton of ksw_extend.cu (ksw_warp.cuh: one
// warp per task, 4 a block; a row computed for all columns at once, F
// as an exclusive prefix max of the ramp max(M - oe_ins, 0) + j e_ins).
// Each lane holds two adjacent columns (2w, 2w+1) in one 32-bit word, so
// a chunk covers 64 columns and a 151-column row takes 3 chunks, not 5.
// The elementwise work runs on the 16x2 DPX instructions: adds as
// __viaddmax_s16x2 with the int16 floor, the band and column masks from
// __viaddmin_s16x2 and __vimin_s16x2_relu, the hd != 0 test from
// __vimin3_u16x2. The scan runs first within the word (the high column's
// exclusive max is the low column's ramp), then across lanes on the
// word's maximum (5 __shfl_up_sync steps), then from chunk to chunk
// through a running carry. The band shrink's candidates and H(i, end-1)
// are kept per half as packed minima and maxima and reduced once a row.
// The rows stay in registers, two columns a word; the write-back's
// one-column shift crosses word boundaries: the lane takes its left
// neighbour's word (__shfl_up_sync, lane 0 from the previous chunk's lane
// 31) and joins the two halves with __byte_perm. The packed query profile
// and the target symbols sit in the warp's shared memory.
//
// Exact while every H and E value, the ramp and the -8192 sentinel (the
// int16 body's NEG16) fit int16, which fits_i16 / i16_exact guarantee for
// the values: at most h0max + (qmax+2)*max_mat + end_bonus < 2^13 - 256.
// The caller checks that bound; the kernel does not.

#include <cstdint>
#include <cuda_runtime.h>

#include "ksw_warp.cuh"

namespace {

constexpr int kMaxChunks = 4;     // qmax < 256
constexpr int kNeg16 = -(1 << 13);

// Words a row holds: qmax + 1 columns rounded up to whole 64-column chunks.
__host__ __device__ inline int row_words(int qmax) {
  return 32 * (qmax / 64 + 1);
}

// The packed query profile qp[6][W] of a task in shared memory (row 5 is
// zeros: the score of a target symbol outside 0..4), one 32-bit word per
// two columns.
__host__ __device__ inline int row_bytes(int qmax) {
  return 6 * row_words(qmax) * (int)sizeof(uint32_t);
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return ((uint32_t)lo & 0xffffu) | ((uint32_t)hi << 16);
}

__device__ __forceinline__ int lo16(uint32_t x) {
  return (int)(int16_t)(x & 0xffffu);
}

__device__ __forceinline__ int hi16(uint32_t x) {
  return (int)(int16_t)(x >> 16);
}

// Per half: a + b, on the DPX adder (max with the int16 floor is a no-op).
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return __viaddmax_s16x2(a, b, 0x80008000u);
}

// Per half: 0xffff where x (>= 0) is nonzero, else 0.
__device__ __forceinline__ uint32_t nonzero2(uint32_t x) {
  return __vimin3_u16x2(x, 0x00010001u, 0x00010001u) * 0xffffu;
}

// Per half: 0xffff where lo <= column < hi, else 0, from the packed
// columns col, their negations ncol, (1 - lo) and hi: min(col - lo + 1,
// hi - col) is at least 1 exactly inside.
__device__ __forceinline__ uint32_t in2(uint32_t col, uint32_t ncol,
                                        uint32_t lo1, uint32_t hi) {
  const uint32_t t = __viaddmin_s16x2(col, lo1, add2(ncol, hi));
  return __vimin_s16x2_relu(t, 0x00010001u) * 0xffffu;
}

template <int NCH>
struct RowsI16x2 {
  static constexpr int kCols = 64;
  const uint32_t* qp;
  int W, lane, e_ins, oe_ins;
  uint32_t noe_ins2, noe_del2, ne_del2;  // (-oe_ins, -oe_ins), ...
  // the DP rows ksw.c keeps in eh[]: H and E of columns (2w, 2w+1), w =
  // 32c + lane, packed in this lane's registers
  uint32_t H[NCH], E[NCH];

  // hbound is not needed: i16_exact bounds every value under 2^13.
  __device__ __forceinline__ RowsI16x2(void* smem, const ksw::Params& p,
                                       int lane_, long long)
      : qp((const uint32_t*)smem), W(row_words(p.qmax)), lane(lane_),
        e_ins(p.e_ins), oe_ins(p.o_ins + p.e_ins) {
    noe_ins2 = pack2(-oe_ins, -oe_ins);
    noe_del2 = pack2(-(p.o_del + p.e_del), -(p.o_del + p.e_del));
    ne_del2 = pack2(-p.e_del, -p.e_del);
  }

  // The packed query profile, and the first row (ksw.c:390-396): H[0] =
  // h0, then decay by e_ins from h0 - oe_ins while positive, 0 past qlen;
  // E = 0.
  __device__ __forceinline__ void init(const int32_t* q, int qlen, int h0,
                                       const int* mat) {
    uint32_t* prof = (uint32_t*)qp;
    for (int k = lane; k < W; k += 32) {
      const int qs0 = 2 * k < qlen ? min(max(q[2 * k], 0), 4) : 0;
      const int qs1 = 2 * k + 1 < qlen ? min(max(q[2 * k + 1], 0), 4) : 0;
      for (int c = 0; c < 5; ++c)
        prof[c * W + k] = pack2(mat[c * 5 + qs0], mat[c * 5 + qs1]);
      prof[5 * W + k] = 0;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      int v[2];
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * (c * 32 + lane) + h;
        v[h] = j == 0 ? h0
                      : (j <= qlen ? max(h0 - oe_ins - (j - 1) * e_ins, 0)
                                   : 0);
      }
      H[c] = pack2(v[0], v[1]);
      E[c] = 0;
    }
    __syncwarp();
  }

  // Target row i over the band [beg, end), as RowsI32::row, two columns a
  // lane.
  __device__ __forceinline__ void row(int tb, int beg, int end, int h1_init,
                                      ksw::RowOut& r) {
    uint32_t S[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) S[c] = qp[tb * W + c * 32 + lane];
    const uint32_t neg2 = pack2(kNeg16, kNeg16), ones = 0x00010001u;
    const uint32_t beg1 = pack2(1 - beg, 1 - beg), end2 = pack2(end, end);
    uint32_t col[NCH], ncol[NCH], bm[NCH], M[NCH];
    int lo[NCH], x[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int w2 = 2 * (c * 32 + lane);
      col[c] = pack2(w2, w2 + 1);
      ncol[c] = pack2(-w2, -w2 - 1);
      bm[c] = in2(col[c], ncol[c], beg1, end2);           // [beg, end)
      // H(i-1, j-1) + score where H(i-1, j-1) != 0, in the band
      M[c] = add2(H[c], S[c]) & nonzero2(H[c]) & bm[c];
      // the F ramp max(M - oe_ins, 0) + j e_ins, kNeg16 outside the band
      uint32_t a = add2(__viaddmax_s16x2(M[c], noe_ins2, 0u),
                        pack2(w2 * e_ins, (w2 + 1) * e_ins));
      a = (a & bm[c]) | (neg2 & ~bm[c]);
      lo[c] = lo16(a);
      x[c] = max(lo[c], hi16(a));          // the word's maximum
    }
    // inclusive prefix max of the words' maxima over each chunk's lanes (a
    // lane below d gets its own value back from the shuffle)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) y[c] = __shfl_up_sync(ksw::kFull, x[c], d);
#pragma unroll
      for (int c = 0; c < NCH; ++c) x[c] = max(x[c], y[c]);
    }
    int xe[NCH], top[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      xe[c] = __shfl_up_sync(ksw::kFull, x[c], 1);
      top[c] = __shfl_sync(ksw::kFull, x[c], 31);
    }
    // per half: the first and last candidate columns of the band shrink,
    // and H(i, end-1)
    const uint32_t e1 = pack2(2 - end, 2 - end);
    uint32_t first2 = 0x7fff7fffu, last2 = 0xffffffffu, h12 = 0xffffffffu;
    int carry = kNeg16, key = -1;
    uint32_t Hc[NCH], Eo[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int w2 = 2 * (c * 32 + lane);
      const int run = lane ? max(carry, xe[c]) : carry;
      carry = max(carry, top[c]);
      // exclusive prefix max of both columns (the high column also sees
      // the low one's ramp); F = max(that - (j-1) e_ins, 0), 0 at beg
      const uint32_t ex = pack2(run, max(run, lo[c]));
      const uint32_t f = __viaddmax_s16x2(
          ex, pack2((1 - w2) * e_ins, -w2 * e_ins), 0u);
      const uint32_t h = __vimax3_s16x2(M[c], E[c], f) & bm[c];
      Eo[c] = __viaddmax_s16x2_relu(M[c], noe_del2, add2(E[c], ne_del2));
      Hc[c] = h | ~bm[c];                  // -1 outside the band
      // (H << 8 | column): the row max and its last column in one reduce
      key = max(key, max(lo16(Hc[c]) * 256 + w2,
                         hi16(Hc[c]) * 256 + w2 + 1));
      const uint32_t at1 = in2(col[c], ncol[c], e1, end2);  // end - 1
      h12 = __vimax3_s16x2(h12, h | ~at1, h | ~at1);
      // the band shrink's candidates in the written-back rows: E[j] =
      // E(i+1, j) and H[j+1] = H(i, j), j in the band
      const uint32_t ez = nonzero2(Eo[c] & bm[c]), hz = nonzero2(h);
      const uint32_t col1 = add2(col[c], ones);
      first2 = __vimin3_s16x2(first2, (col[c] & ez) | (0x7fff7fffu & ~ez),
                              (col1 & hz) | (0x7fff7fffu & ~hz));
      last2 = __vimax3_s16x2(last2, col[c] | ~ez, col1 | ~hz);
    }
    // the left neighbour's word, for the write-back shifted by a column
    uint32_t up[NCH], tops[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      up[c] = __shfl_up_sync(ksw::kFull, Hc[c], 1);
      tops[c] = __shfl_sync(ksw::kFull, Hc[c], 31);
    }
    const int f1 = min(lo16(first2), hi16(first2));
    r.first = __reduce_min_sync(ksw::kFull, f1 == 0x7fff ? ksw::kBig : f1);
    r.last = __reduce_max_sync(ksw::kFull, max(lo16(last2), hi16(last2)));
    const int km = __reduce_max_sync(ksw::kFull, key);
    r.m = km >> 8;
    r.mj = km & 0xff;
    r.h1 = __reduce_max_sync(ksw::kFull, max(lo16(h12), hi16(h12)));
    const uint32_t h1i = pack2(h1_init, h1_init);
    const uint32_t end1 = pack2(end + 1, end + 1);
    const uint32_t bg1 = pack2(beg + 1, beg + 1);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const uint32_t left = lane ? up[c] : (c ? tops[c - 1] : 0u);
      // (H(i, 2w-1), H(i, 2w)): the row shifted right by one column
      const uint32_t shifted = __byte_perm(left, Hc[c], 0x5432);
      const uint32_t wm = in2(col[c], ncol[c], beg1, end1);  // [beg, end]
      const uint32_t bg = in2(col[c], ncol[c], beg1, bg1);   // beg
      H[c] = (((shifted & ~bg) | (h1i & bg)) & wm) | (H[c] & ~wm);
      E[c] = (Eo[c] & bm[c]) | (E[c] & ~wm);         // E[end] = 0
    }
  }
};

__global__ void __launch_bounds__(ksw::kWarps * 32)
ksw_extend2_i16_kernel(ksw::Params p, const int32_t* __restrict__ mat_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int mat[25];
  if (threadIdx.x < 25) mat[threadIdx.x] = mat_in[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * ksw::kWarps + warp;
  if (b >= p.B) return;
  const int rb = row_bytes(p.qmax);
  unsigned char* ws = smem + (size_t)warp * ksw::warp_bytes(rb, p.tmax);
  ksw::run_warp<RowsI16x2, kMaxChunks>(p, mat, ws, ws + rb, b, lane);
}

}  // namespace

extern "C" int ksw_extend2_i16_launch(
    int B, int qmax, int tmax, const void* query, const void* target,
    const void* qlen, const void* tlen, const void* h0, const void* w,
    const void* mat, int o_del, int e_del, int o_ins, int e_ins,
    int end_bonus, int zdrop, void* out, void* stream) {
  if (B <= 0) return 0;
  if (qmax < 0 || qmax / 64 + 1 > kMaxChunks || tmax < 0)
    return (int)cudaErrorInvalidValue;
  // the query profiles and target symbols of kWarps tasks; above 48 KB a
  // kernel must opt in, and no block may have more than the H100's 227 KB
  const int smem = ksw::kWarps * ksw::warp_bytes(row_bytes(qmax), tmax);
  if (smem + 25 * (int)sizeof(int) > ksw::kSmemBlockMax)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ksw_extend2_i16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const ksw::Params p{B, qmax, tmax, (const int32_t*)query,
                      (const int32_t*)target, (const int32_t*)qlen,
                      (const int32_t*)tlen, (const int32_t*)h0,
                      (const int32_t*)w, o_del, e_del, o_ins, e_ins,
                      end_bonus, zdrop, (int32_t*)out};
  const int blocks = (B + ksw::kWarps - 1) / ksw::kWarps;
  ksw_extend2_i16_kernel<<<blocks, ksw::kWarps * 32, smem,
                           (cudaStream_t)stream>>>(p, (const int32_t*)mat);
  return (int)cudaGetLastError();
}

extern "C" const char* ksw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
