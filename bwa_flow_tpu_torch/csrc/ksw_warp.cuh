// The warp-per-task skeleton of the two ksw_extend2 kernels
// (ksw_extend.cu: int32 rows; ksw_extend16.cu: int16 rows, two columns a
// lane). One warp runs one task: the per-task set-up, the loop over
// target rows and its bookkeeping (gscore, maxima, z-drop, band shrink)
// live here once; a row policy `Rows<NCH>` computes one target row for
// all query columns at once, NCH chunks of Rows<1>::kCols columns, and
// keeps the task's DP rows in its lanes' registers (each lane the columns
// it computes) and the task's query profile in the warp's shared memory.
//
// Every value below that is not a column is warp-uniform: each lane holds
// the same beg, end, maxv, ... and takes the same branches, so the warp
// never diverges outside the row policy's masked lanes.
//
// The contract is bwa's ksw_extend2 (bwa/ksw.c:380-479) as the plain
// version bwa_flow_tpu_torch/ops/extend_torch.py::extend_core states it.

#pragma once

#include <cstdint>

namespace ksw {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // tasks a block: one per SM sub-partition
constexpr int kBig = 1 << 30;
constexpr int kSmemBlockMax = 232448;   // shared memory a block may have

struct Params {
  int B, qmax, tmax;
  const int32_t* query;   // [B, qmax], symbols 0..4
  const int32_t* target;  // [B, tmax], symbols 0..4
  const int32_t* qlen;
  const int32_t* tlen;
  const int32_t* h0;
  const int32_t* w;       // per-lane band width
  int o_del, e_del, o_ins, e_ins, end_bonus, zdrop;
  int32_t* out;           // [6, B]
};

// What a row policy reports for target row i: the row maximum m, its last
// column mj, h1 = H(i, end-1), and over the written-back rows the first
// nonzero column in [beg, end] (kBig if none) and the last (-1 if none).
struct RowOut {
  int m, mj, h1, first, last;
};

struct Task {
  const Params* p;
  const int* mat;     // [5, 5] in shared memory
  void* rows;         // the warp's query profile
  uint8_t* tsym;      // the warp's target symbols, [tmax]
  int b, lane, qlen, tlen, h0;
};

__device__ __forceinline__ void write_out(const Params& p, int b, int score,
                                          int qle, int tle, int gtle,
                                          int gscore, int max_off) {
  p.out[0 * p.B + b] = score;
  p.out[1 * p.B + b] = qle;
  p.out[2 * p.B + b] = tle;
  p.out[3 * p.B + b] = gtle;
  p.out[4 * p.B + b] = gscore;
  p.out[5 * p.B + b] = max_off;
}

template <class Rows>
__device__ void extend_task(const Task& t) {
  const Params& p = *t.p;
  const int qlen = t.qlen, tlen = t.tlen, h0 = t.h0;

  // band cap (double math, truncated), max over the whole 5x5 matrix
  int w = p.w[t.b];
  int max_sc = t.mat[0];
  for (int k = 1; k < 25; ++k) max_sc = max(max_sc, t.mat[k]);
  {
    int max_ins = (int)(((double)qlen * max_sc + p.end_bonus - p.o_ins) /
                            p.e_ins + 1.0);
    if (max_ins < 1) max_ins = 1;
    if (w > max_ins) w = max_ins;
    int max_del = (int)(((double)qlen * max_sc + p.end_bonus - p.o_del) /
                            p.e_del + 1.0);
    if (max_del < 1) max_del = 1;
    if (w > max_del) w = max_del;
  }

  // target symbols, 5 for anything outside 0..4 (scores 0 there)
  const int32_t* tg = p.target + (size_t)t.b * p.tmax;
  for (int i = t.lane; i < tlen; i += 32) {
    const int s = tg[i];
    t.tsym[i] = (uint8_t)((s >= 0 && s < 5) ? s : 5);
  }
  // no DP value exceeds h0 + qlen * max_sc: a column adds at most one
  // match score to the path that ends in it
  Rows rows(t.rows, p, t.lane,
            (long long)h0 + (long long)qlen * max(max_sc, 0));
  rows.init(p.query + (size_t)t.b * p.qmax, qlen, h0, t.mat);  // syncs

  const int o_del = p.o_del, e_del = p.e_del, e_ins = p.e_ins;
  const int zdrop = p.zdrop;
  int maxv = h0, gscore = -1, max_off = 0;
  int max_i = -1, max_j = -1, max_ie = -1;
  int beg = 0, end = qlen;
  int tb = t.tsym[0];
  for (int i = 0; i < tlen; ++i) {
    const int tb_next = t.tsym[min(i + 1, tlen - 1)];   // a row ahead
    beg = max(beg, i - w);
    end = min(min(end, i + w + 1), qlen);
    const int h1_init = beg == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    if (beg >= end) {
      // collapsed band: ksw.c runs an empty inner loop, does the
      // eh[end]/gscore bookkeeping with h1_init (its j is beg) and breaks
      // on m == 0 (ksw.c:424-456)
      if (beg == qlen) {
        if (h1_init >= gscore) max_ie = i;
        gscore = max(gscore, h1_init);
      }
      break;
    }
    RowOut r;
    rows.row(tb, beg, end, h1_init, r);
    tb = tb_next;
    // the band shrink (ksw.c:460-466) first, since the next row waits on
    // it: the first nonzero column in [beg, end), then the last in [that,
    // end]; with none in [beg, end) the second range is [end, end], and
    // with none at all end = beg - 1 + 2. H[beg] = h1_init counts too.
    const int first = h1_init != 0 ? beg : r.first;
    const int last = h1_init != 0 ? max(r.last, beg) : r.last;
    const int beg_s = min(first, end);
    const int end_s = min((last < 0 ? beg_s - 1 : last) + 2, qlen);
    if (end == qlen) {
      if (r.h1 >= gscore) max_ie = i;
      gscore = max(gscore, r.h1);
    }
    // stop on m == 0, or on the z-drop when the row did not improve
    const bool improved = r.m > maxv;
    const int di = i - max_i, dj = r.mj - max_j;
    const int drop =
        maxv - r.m - (di > dj ? (di - dj) * e_del : (dj - di) * e_ins);
    if (r.m == 0 || (!improved && zdrop > 0 && drop > zdrop)) break;
    if (improved) {
      maxv = r.m;
      max_i = i;
      max_j = r.mj;
      max_off = max(max_off, abs(r.mj - i));
    }
    beg = beg_s;
    end = end_s;
  }
  if (t.lane == 0)
    write_out(p, t.b, maxv, max_j + 1, max_i + 1, max_ie + 1, gscore,
              max_off);
}

// Run Rows<nch> for nch in [1, N]: the chunk count is a template argument
// so that a row's chunks unroll into independent instruction streams.
template <template <int> class Rows, int N>
__device__ void dispatch(int nch, const Task& t) {
  if (nch == N) {
    extend_task<Rows<N>>(t);
    return;
  }
  if constexpr (N > 1) dispatch<Rows, N - 1>(nch, t);
}

// One task on one warp. A task with qlen == 0 or tlen == 0 gives (h0, 0,
// 0, 0, -1, 0). Otherwise it takes qlen / kCols + 1 chunks, so that every
// column in [0, qlen] (end and the write-back's H[end] included) lies in
// a chunk; the launcher guarantees qmax / kCols + 1 <= kMaxChunks.
template <template <int> class Rows, int kMaxChunks>
__device__ void run_warp(const Params& p, const int* mat, void* rows,
                         uint8_t* tsym, int b, int lane) {
  const int qlen = min(max(p.qlen[b], 0), p.qmax);
  const int tlen = min(max(p.tlen[b], 0), p.tmax);
  const int h0 = max(p.h0[b], 1);
  if (qlen == 0 || tlen == 0) {
    if (lane == 0) write_out(p, b, h0, 0, 0, 0, -1, 0);
    return;
  }
  const Task t{&p, mat, rows, tsym, b, lane, qlen, tlen, h0};
  dispatch<Rows, kMaxChunks>(qlen / Rows<1>::kCols + 1, t);
}

// Dynamic shared memory of a block: kWarps x (query profile + target
// symbols), the target rounded up to 16 bytes so that every warp's profile
// stays aligned.
__host__ __device__ inline int warp_bytes(int row_bytes, int tmax) {
  return row_bytes + ((tmax + 15) & ~15);
}

}  // namespace ksw
