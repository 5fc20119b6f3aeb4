// Batched exact ksw_extend2 (bwa/ksw.c:380-479) with int16 DP rows in
// shared memory, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bwa_flow_tpu/ops/extend_pallas.py
// (_extend_pallas with the _make_kernel16 body, use16=True), which keeps
// its DP rows int16 in VMEM under the fits_i16 bound. Same contract as
// the plain version bwa_flow_tpu_torch/ops/extend_torch.py::extend_core16
// and as the int32 kernel csrc/ksw_extend.cu: per task, a banded
// affine-gap extension of a query from a starting score h0, returning
// (score, qle, tle, gtle, gscore, max_off).
//
// Design: one thread per task runs the same exact scalar row loop as the
// int32 kernel, with the same lane preparation (h0 = max(h0, 1), the band
// cap in double, degenerate lanes return (h0, 0, 0, 0, -1, 0)). The H and
// E rows are int16 in shared memory, laid out [2][qmax+1][32] for a block
// of 32 threads (one task per thread, the task index fastest, so a warp's
// 32 halves of one row position fill 16 consecutive banks and never
// conflict). At qmax = 160 that is 20,608 bytes a block: Hopper's
// counterpart of the TPU kernel's VMEM-resident rows, where the int32
// kernel's rows go through a global scratch buffer. Every cell computes
// in int32 registers and narrows on store. That is exact while every H
// and E value fits int16, which fits_i16 guarantees: values are at most
// h0max + (qmax+2)*max_mat + end_bonus < 2^13 - 256. The caller checks
// that bound; the kernel does not.
//
// What bounds it on the H100: operations over the banded DP cells, 10 per
// cell from the recurrence, and since the rows are int16, two cells per
// 32-bit operation with the packed DPX instructions (__viaddmax_s16x2,
// __vimax3_s16x2). Its rows never touch device memory, so each cell
// costs a shared-memory load and store instead of an L2/HBM round trip.
// One thread per task still gives only B/32 warps (128 at B = 4096, about
// one per SM, and one or two on the main path's waves of ~80 tasks), so
// the kernel is latency-bound; two tasks per 32-bit word and more warps
// per SM are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kSmemBlockMax = 232448;    // shared memory a block may have

__global__ void ksw_extend2_i16_kernel(
    int B, int qmax, int tmax,
    const int32_t* __restrict__ query,   // [B, qmax], symbols 0..4
    const int32_t* __restrict__ target,  // [B, tmax], symbols 0..4
    const int32_t* __restrict__ qlen_in,
    const int32_t* __restrict__ tlen_in,
    const int32_t* __restrict__ h0_in,
    const int32_t* __restrict__ w_in,    // per-lane band width
    const int32_t* __restrict__ mat_in,  // [5, 5]
    int o_del, int e_del, int o_ins, int e_ins, int end_bonus, int zdrop,
    int32_t* __restrict__ out) {         // [6, B]
  extern __shared__ int16_t rows[];      // [2][qmax+1][kThreads]
  __shared__ int mat[25];
  if (threadIdx.x < 25) mat[threadIdx.x] = mat_in[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const int qlen = min(max(qlen_in[b], 0), qmax);
  const int tlen = min(max(tlen_in[b], 0), tmax);
  const int h0 = max(h0_in[b], 1);
  if (qlen == 0 || tlen == 0) {
    out[0 * B + b] = h0;
    out[1 * B + b] = 0;
    out[2 * B + b] = 0;
    out[3 * B + b] = 0;
    out[4 * B + b] = -1;
    out[5 * B + b] = 0;
    return;
  }
  const int oe_del = o_del + e_del;
  const int oe_ins = o_ins + e_ins;
  const int32_t* q = query + (size_t)b * qmax;
  const int32_t* t = target + (size_t)b * tmax;
  int16_t* H = rows + threadIdx.x;                        // H[j * kThreads]
  int16_t* E = rows + (qmax + 1) * kThreads + threadIdx.x;

  // band cap (double math, truncated), max over the whole 5x5 matrix
  int w = w_in[b];
  {
    int max_sc = mat[0];
    for (int k = 1; k < 25; ++k) max_sc = max(max_sc, mat[k]);
    int max_ins = (int)(((double)qlen * max_sc + end_bonus - o_ins) /
                            e_ins + 1.0);
    if (max_ins < 1) max_ins = 1;
    if (w > max_ins) w = max_ins;
    int max_del = (int)(((double)qlen * max_sc + end_bonus - o_del) /
                            e_del + 1.0);
    if (max_del < 1) max_del = 1;
    if (w > max_del) w = max_del;
  }

  // first row (ksw.c:390-396): H[0] = h0, then decay by e_ins while > 0
  {
    int v = h0;
    H[0] = (int16_t)v;
    E[0] = 0;
    v = h0 > oe_ins ? h0 - oe_ins : 0;
    for (int j = 1; j <= qlen; ++j) {
      H[j * kThreads] = (int16_t)v;
      E[j * kThreads] = 0;
      v = v > e_ins ? v - e_ins : 0;
    }
  }

  int maxv = h0, gscore = -1, max_off = 0;
  int max_i = -1, max_j = -1, max_ie = -1;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    const int tb = t[i];
    const int* row = (tb >= 0 && tb < 5) ? mat + tb * 5 : nullptr;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1 = 0;
    if (beg == 0) {
      h1 = h0 - (o_del + e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    }
    // no beg >= end shortcut: the collapsed-band row runs its empty
    // inner loop, then the eh[end]/gscore bookkeeping and the m == 0
    // break (ksw.c:424-456)
    int f = 0, m = 0, mj = end - 1;
    for (int j = beg; j < end; ++j) {
      const int o = j * kThreads;
      const int hd = H[o];                 // H(i-1, j-1)
      const int ein = E[o];                // E(i, j)
      H[o] = (int16_t)h1;                  // H(i, j-1)
      int qs = q[j];
      qs = qs < 0 ? 0 : (qs > 4 ? 4 : qs);
      const int sc = row ? row[qs] : 0;
      const int M = hd ? hd + sc : 0;
      int h = M >= ein ? M : ein;
      h = h >= f ? h : f;
      h1 = h;
      if (h >= m) { m = h; mj = j; }      // last argmax
      int tt = M - oe_del;
      if (tt < 0) tt = 0;
      const int e2 = ein - e_del;
      E[o] = (int16_t)(e2 > tt ? e2 : tt);
      tt = M - oe_ins;
      if (tt < 0) tt = 0;
      f -= e_ins;
      if (tt > f) f = tt;
    }
    H[end * kThreads] = (int16_t)h1;
    E[end * kThreads] = 0;
    // the post-loop j is end, or beg when the band collapsed
    if ((beg < end ? end : beg) == qlen) {
      if (h1 >= gscore) max_ie = i;
      if (h1 > gscore) gscore = h1;
    }
    if (m == 0) break;
    if (m > maxv) {
      maxv = m;
      max_i = i;
      max_j = mj;
      const int off = mj > i ? mj - i : i - mj;
      if (off > max_off) max_off = off;
    } else if (zdrop > 0) {
      const int di = i - max_i, dj = mj - max_j;
      if (di > dj) {
        if (maxv - m - (di - dj) * e_del > zdrop) break;
      } else {
        if (maxv - m - (dj - di) * e_ins > zdrop) break;
      }
    }
    // band shrink over the written-back rows (ksw.c:460-466)
    int j = beg;
    while (j < end && H[j * kThreads] == 0 && E[j * kThreads] == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && H[j * kThreads] == 0 && E[j * kThreads] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  out[0 * B + b] = maxv;
  out[1 * B + b] = max_j + 1;
  out[2 * B + b] = max_i + 1;
  out[3 * B + b] = max_ie + 1;
  out[4 * B + b] = gscore;
  out[5 * B + b] = max_off;
}

}  // namespace

extern "C" int ksw_extend2_i16_launch(
    int B, int qmax, int tmax, const void* query, const void* target,
    const void* qlen, const void* tlen, const void* h0, const void* w,
    const void* mat, int o_del, int e_del, int o_ins, int e_ins,
    int end_bonus, int zdrop, void* out, void* stream) {
  if (B <= 0) return 0;
  // the int16 H and E rows of one block, beside the static 5x5 matrix;
  // above 48 KB a kernel must opt in, and no block may have more than
  // the H100's 227 KB
  const int smem = 2 * (qmax + 1) * kThreads * (int)sizeof(int16_t);
  if (smem + 25 * (int)sizeof(int) > kSmemBlockMax)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ksw_extend2_i16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  ksw_extend2_i16_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      B, qmax, tmax, (const int32_t*)query, (const int32_t*)target,
      (const int32_t*)qlen, (const int32_t*)tlen, (const int32_t*)h0,
      (const int32_t*)w, (const int32_t*)mat, o_del, e_del, o_ins, e_ins,
      end_bonus, zdrop, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* ksw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
