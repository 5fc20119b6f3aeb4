// FM-index primitives of the seed machines (seed_p1p3.cu, seed_fwd.cu,
// seed_bwd.cu) for one thread on the card: the all-symbol occ of one row
// coordinate, the one-direction bwt_extend that keeps only the row of the
// symbol the caller adds, and the single-base start interval.
//
// Each is the per-lane form of the plain PyTorch version in
// bwa_flow_tpu_torch/ops/fm_torch.py (occ4_batch, set_intv_batch) and
// ops/smem_torch.py (bwt_extend_dir_batch, _take_row), with the same
// clamps and corner cases, so every value is equal: occ at k = -1 is 0,
// at k = seq_len the column totals of L2; a probe at or past `primary`
// reads the row one lower; the backward-derived coordinate gains one when
// the interval straddles `primary`.
//
// The index is the port's block layout (index/fmindex.py): one 32-byte
// int32 row per 64 BWT symbols, 4 counts then 4 words of 16 two-bit
// symbols, the first symbol in a word's top bits. A row is read as two
// 16-byte loads through the read-only cache. T is the coordinate type:
// int32_t on the narrow view of a sub-2^31 genome, int64_t on the wide
// one.

#pragma once

#include <cstdint>

namespace seedfm {

constexpr int kBlock = 64;   // BWT symbols a block row covers

template <typename T>
struct FM {
  const int4* rows;   // fm_blocks int32[n_blocks, 8]: two int4 a row
  T L2[5];
  T seq_len, primary;

  __device__ __forceinline__ FM(const void* blocks, const T* l2,
                                long long seq_len_, long long primary_)
      : rows((const int4*)blocks), seq_len((T)seq_len_),
        primary((T)primary_) {
#pragma unroll
    for (int c = 0; c < 5; ++c) L2[c] = l2[c];
  }

  // occ(k, c) for c = 0..3 (bwa/bwt.c:169-186; fm_torch.occ4_batch).
  __device__ __forceinline__ void occ4(T k, T out[4]) const {
    if (k == (T)-1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = 0;
      return;
    }
    if (k == seq_len) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = L2[c + 1] - L2[c];
      return;
    }
    T kk = k - (k >= primary ? (T)1 : (T)0);
    if (kk < 0) kk = 0;
    if (kk > seq_len - 1) kk = seq_len - 1;
    const long long blk = (long long)kk / kBlock;
    const int within = (int)((long long)kk % kBlock) + 1;
    const int4 cnt = __ldg(rows + 2 * blk);
    const int4 wd = __ldg(rows + 2 * blk + 1);
    const unsigned w[4] = {(unsigned)wd.x, (unsigned)wd.y, (unsigned)wd.z,
                           (unsigned)wd.w};
    const int base[4] = {cnt.x, cnt.y, cnt.z, cnt.w};
    unsigned keep[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = within - 16 * j;
      n = n < 0 ? 0 : (n > 16 ? 16 : n);
      // the first n symbols of a word are its top 2n bits
      keep[j] = n == 0 ? 0u : ~((1u << (2 * (16 - n))) - 1u);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned pat = (unsigned)c * 0x55555555u;
      int n = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned x = ~(w[j] ^ pat);
        n += __popc(x & (x >> 1) & 0x55555555u & keep[j]);
      }
      out[c] = (T)base[c] + (T)n;
    }
  }

  // Row c of bwt_extend(ik, is_back) (bwa/bwt.c:262-275): the interval
  // after adding base c, as (k, l, s) (bwt_extend_dir_batch + _take_row).
  __device__ __forceinline__ void extend(const T ik[3], bool is_back, int c,
                                         T ok[3]) const {
    const T probe = is_back ? ik[0] : ik[1];
    const T s = ik[2];
    T tk[4], tl[4];
    occ4(probe - 1, tk);
    occ4(probe - 1 + s, tl);
    const T crosses =
        (probe <= primary && probe + s - 1 >= primary) ? (T)1 : (T)0;
    // derived[c] = b3 + sum of ok_s over the symbols above c
    T d = (is_back ? ik[1] : ik[0]) + crosses;
#pragma unroll
    for (int j = 3; j > 0; --j)
      if (j > c) d += tl[j] - tk[j];
    const T p = L2[c] + 1 + tk[c];
    ok[0] = is_back ? p : d;
    ok[1] = is_back ? d : p;
    ok[2] = tl[c] - tk[c];
  }

  // The start interval of base c (bwa/bwt.h:80; set_intv_batch).
  __device__ __forceinline__ void set_intv(int c, T ik[3]) const {
    c = c < 0 ? 0 : (c > 3 ? 3 : c);
    ik[0] = L2[c] + 1;
    ik[1] = L2[3 - c] + 1;
    ik[2] = L2[c + 1] - L2[c];
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace seedfm
