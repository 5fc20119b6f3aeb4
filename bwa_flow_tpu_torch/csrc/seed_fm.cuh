// FM-index primitives of the seed machines (seed_p1p3.cu, seed_fwd.cu,
// seed_bwd.cu) and the LF walk (sa_walk.cu) for one thread on the card:
// the one-symbol probe (the row of one symbol of bwt_extend), whole in
// one thread (seed_bwd.cu) or split over a quad of threads
// (seed_quad.cuh: seed_p1p3.cu, seed_fwd.cu), the single-base start
// interval, and one LF step.
//
// Each is the per-lane form of the plain PyTorch version in
// bwa_flow_tpu_torch/ops/fm_torch.py (occ4_batch, set_intv_batch,
// _inv_psi_batch) and ops/smem_torch.py (bwt_extend_dir_batch,
// _take_row), with the same
// clamps and corner cases, so every value is equal: occ at k = -1 is 0,
// at k = seq_len the column totals of L2; a probe at or past `primary`
// reads the row one lower; the backward-derived coordinate gains one when
// the interval straddles `primary`.
//
// The one-symbol probe computes only what the row of symbol c needs: for
// each of the two probe coordinates the count of c and the count of the
// symbols above c, in one pass over the row's 4 words (the derived
// coordinate is b3 + the sum over j > c of tl[j] - tk[j], which is the
// difference of the two above-c counts). It gathers a row once when both
// coordinates lie in the same 64-symbol block, and it indexes no array
// by a runtime value (pick4), so ptxas keeps nothing of it on the stack.
// It is split in two so that a quad of threads can share it: part()
// counts a thread's words (all 4, or word j of a quad) into one packed
// word, which a quad sums with two shuffles before finish().
//
// The index is the port's block layout (index/fmindex.py): one 32-byte
// int32 row per 64 BWT symbols, 4 counts then 4 words of 16 two-bit
// symbols, the first symbol in a word's top bits. A row is read through
// the read-only cache. T is the coordinate type: int32_t on the narrow
// view of a sub-2^31 genome, int64_t on the wide one.
//
// The header needs nothing of CUDA beyond __device__, __forceinline__,
// __ldg, __popc, __funnelshift_rc and int4, so
// tests/test_torch_seed_fm_host.py and tests/test_torch_sa_walk_host.py
// compile it with the host's c++ under a stand-in for those.

#pragma once

#include <cstdint>

namespace seedfm {

constexpr int kBlock = 64;   // BWT symbols a block row covers

// a_c for c in [0, 3], by selects: an array indexed by a runtime value
// would go to the stack
template <typename X>
__device__ __forceinline__ X pick4(int c, X a0, X a1, X a2, X a3) {
  return c == 0 ? a0 : (c == 1 ? a1 : (c == 2 ? a2 : a3));
}

// The counts of symbol c among the first n symbols (n clamped to [0, 16])
// of a word: (symbols equal to c) | (symbols above c) << 8.
__device__ __forceinline__ unsigned count_word(unsigned w, int c, int n) {
  constexpr unsigned kPair = 0x55555555u;   // the low bit of each symbol
  // the first n symbols of a word are its top 2n bits: the funnel shift
  // clamps its count at 32, so n >= 16 keeps them all
  const unsigned keep =
      ~__funnelshift_rc(0xFFFFFFFFu, 0u, (unsigned)(2 * (n < 0 ? 0 : n)));
  const unsigned x = ~(w ^ ((unsigned)c * kPair));
  const unsigned eq = x & (x >> 1) & kPair & keep;
  const unsigned hi = (w >> 1) & kPair, lo = w & kPair;
  const unsigned above =
      (c == 0 ? (hi | lo) : (c == 1 ? hi : (c == 2 ? (hi & lo) : 0u))) &
      keep;
  return (unsigned)__popc(eq) | (unsigned)__popc(above) << 8;
}

// count_word over a row's 4 words, the first `within` symbols of the row
__device__ __forceinline__ unsigned count_row(int4 w, int c, int within) {
  return count_word((unsigned)w.x, c, within) +
         count_word((unsigned)w.y, c, within - 16) +
         count_word((unsigned)w.z, c, within - 32) +
         count_word((unsigned)w.w, c, within - 48);
}

// A one-symbol probe between its two halves (FM::part, FM::finish): per
// coordinate (a = probe - 1, b = probe - 1 + s) the row counts of c and
// of the symbols above c, and in n the word counts, 8 bits each (at most
// 64): eq_a | above_a << 8 | eq_b << 16 | above_b << 24.
template <typename T>
struct Part {
  T eq_a, above_a, eq_b, above_b;
  unsigned n;
};

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

  // The start interval of base c (bwa/bwt.h:80; set_intv_batch).
  __device__ __forceinline__ void set_intv(int c, T& k, T& l, T& s) const {
    c = c < 0 ? 0 : (c > 3 ? 3 : c);
    const T l2c = pick4(c, L2[0], L2[1], L2[2], L2[3]);
    k = l2c + 1;
    l = pick4(3 - c, L2[0], L2[1], L2[2], L2[3]) + 1;
    s = pick4(c, L2[1], L2[2], L2[3], L2[4]) - l2c;
  }

  // The row block and the count of symbols `within` it (0 for k = -1 and
  // k = seq_len, whose values come from no row) of coordinate k, with
  // occ4_batch's shift past `primary` and clamp.
  __device__ __forceinline__ void locate(T k, T& blk, int& within) const {
    T kk = k - (k >= primary ? (T)1 : (T)0);
    kk = kk < 0 ? (T)0 : (kk > seq_len - 1 ? seq_len - 1 : kk);
    blk = kk >> 6;                       // kk >= 0: a shift divides
    within = (k == (T)-1 || k == seq_len) ? 0 : (int)(kk & 63) + 1;
  }

  // occ(k, c) and the sum of occ(k, j) over j > c, less the counts of the
  // row's words: the row's counts, or the whole value at k = -1 and
  // k = seq_len (whose `within` is 0, so their words count nothing). By
  // selects, not branches, so that no branch stands between a probe's
  // loads.
  __device__ __forceinline__ void bases(T k, int c, int4 cnt, T& eq,
                                        T& above) const {
    const T l2c = pick4(c, L2[0], L2[1], L2[2], L2[3]);
    const T l2c1 = pick4(c, L2[1], L2[2], L2[3], L2[4]);
    const T row_eq = (T)pick4(c, cnt.x, cnt.y, cnt.z, cnt.w);
    const T row_above = (c < 1 ? (T)cnt.y : (T)0) +
                        (c < 2 ? (T)cnt.z : (T)0) +
                        (c < 3 ? (T)cnt.w : (T)0);
    const bool neg = k == (T)-1, end = k == seq_len;
    eq = neg ? (T)0 : (end ? l2c1 - l2c : row_eq);
    above = neg ? (T)0 : (end ? L2[4] - l2c1 : row_above);
  }

  // The first half of the one-symbol probe of (probe, s) and symbol c:
  // NW = 4 counts all 4 words of both rows; NW = 1 counts word j of both,
  // so the four threads of a quad (j = 0..3) together count the rows.
  // Every load of the probe goes out before any of them is used, so a
  // step waits on one gather; the second row is loaded only when it is
  // another block.
  template <int NW>
  __device__ __forceinline__ Part<T> part(T probe, T s, int c,
                                          int j) const {
    const T ka = probe - 1, kb = probe - 1 + s;
    T blka, blkb;
    int wa, wb;
    locate(ka, blka, wa);
    locate(kb, blkb, wb);
    const int4* ra = rows + 2 * blka;
    const int4* rb = rows + 2 * blkb;
    const bool one = blka == blkb;
    const int4 ca = __ldg(ra);
    const int4 cb = one ? ca : __ldg(rb);
    Part<T> p;
    if constexpr (NW == 4) {
      const int4 da = __ldg(ra + 1);
      const int4 db = one ? da : __ldg(rb + 1);
      p.n = count_row(da, c, wa) | count_row(db, c, wb) << 16;
    } else {
      const unsigned w_a = __ldg((const unsigned*)(ra + 1) + j);
      const unsigned w_b =
          one ? w_a : __ldg((const unsigned*)(rb + 1) + j);
      p.n = count_word(w_a, c, wa - 16 * j) |
            count_word(w_b, c, wb - 16 * j) << 16;
    }
    bases(ka, c, ca, p.eq_a, p.above_a);
    bases(kb, c, cb, p.eq_b, p.above_b);
    return p;
  }

  // The second half: the row of symbol c of bwt_extend(ik, is_back) as
  // (k, l, s) from a part whose n holds the counts of all 4 words.
  __device__ __forceinline__ void finish(const Part<T>& p, T k, T l, T s,
                                         bool is_back, int c, T& ok,
                                         T& ol, T& os) const {
    const T tk = p.eq_a + (T)(p.n & 0xFFu);
    const T ak = p.above_a + (T)((p.n >> 8) & 0xFFu);
    const T tl = p.eq_b + (T)((p.n >> 16) & 0xFFu);
    const T al = p.above_b + (T)(p.n >> 24);
    const T probe = is_back ? k : l;
    const T crosses =
        (probe <= primary && probe + s - 1 >= primary) ? (T)1 : (T)0;
    const T d = (is_back ? l : k) + crosses + (al - ak);
    const T p0 = pick4(c, L2[0], L2[1], L2[2], L2[3]) + 1 + tk;
    ok = is_back ? p0 : d;
    ol = is_back ? d : p0;
    os = tl - tk;
  }

  // The one-symbol probe in one thread: the row of symbol c (clamped by
  // the caller) of bwt_extend((k, l, s), is_back).
  __device__ __forceinline__ void extend1(T k, T l, T s, bool is_back,
                                          int c, T& ok, T& ol,
                                          T& os) const {
    const Part<T> p = part<4>(is_back ? k : l, s, c, 0);
    finish(p, k, l, s, is_back, c, ok, ol, os);
  }

  // One LF step (bwa/bwt.c:53-59; fm_torch._inv_psi_batch) of row k in
  // [0, seq_len]: L2[c] + occ(k, c) for the BWT symbol c at k, and 0 at
  // k = primary. For k != primary the symbol's position k - (k > primary)
  // is the occ row kk = k - (k >= primary), so ONE row gives both c and
  // occ: the row's count of c plus the c among its first kk % 64 + 1
  // symbols (k = seq_len counts the last row whole). Both halves of the
  // row are loaded before either is used, and c picks its word, count
  // and L2 entry by selects, so no branch and no stack slot stands
  // between the loads and the result. Only the count of c is used of
  // count_row (its low byte: at most 64), so the count of the symbols
  // above c is dead code.
  __device__ __forceinline__ T lf(T k) const {
    T kk = k - (k >= primary ? (T)1 : (T)0);
    kk = kk < 0 ? (T)0 : (kk > seq_len - 1 ? seq_len - 1 : kk);
    const int4* r = rows + 2 * (kk >> 6);   // kk >= 0: a shift divides
    const int4 cnt = __ldg(r);
    const int4 w = __ldg(r + 1);
    const int off = (int)(kk & 63);
    const unsigned word = pick4(off >> 4, (unsigned)w.x, (unsigned)w.y,
                                (unsigned)w.z, (unsigned)w.w);
    const int c = (int)((word >> (2 * (15 - (off & 15)))) & 3u);
    const T v = pick4(c, L2[0], L2[1], L2[2], L2[3]) +
                (T)pick4(c, cnt.x, cnt.y, cnt.z, cnt.w) +
                (T)(count_row(w, c, off + 1) & 0xFFu);
    return k == primary ? (T)0 : v;
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace seedfm
