// bwa_flow_tpu native kernel implementations (shared header).
//
// Exact ksw_extend2 / ksw_global2 semantics, C++ ports of this repo's
// own golden NumPy specifications (bwa_flow_tpu/ops/ksw.py) — see
// native/_native.cpp for provenance and tests/test_native.py for the
// integer-exactness harness. Header-only so both the _native bindings
// and the _region tail stage share one implementation.

#ifndef BWA_FLOW_TPU_KSW_IMPL_H
#define BWA_FLOW_TPU_KSW_IMPL_H

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace bwaflow {

constexpr int64_t MINUS_INF = -0x40000000;

struct Ext2Result {
  int64_t score, qle, tle, gtle, gscore, max_off;
};

// Exact ksw_extend2 semantics (golden: bwa_flow_tpu/ops/ksw.py:51-144).
Ext2Result ksw_extend2(int qlen, const uint8_t* query, int tlen,
                       const uint8_t* target, const int8_t* mat, int m,
                       int o_del, int e_del, int o_ins, int e_ins, int w,
                       int end_bonus, int zdrop, int h0) {
  const int oe_del = o_del + e_del;
  const int oe_ins = o_ins + e_ins;
  std::vector<int64_t> ehH(qlen + 2, 0), ehE(qlen + 2, 0);
  std::vector<int64_t> qp((size_t)m * qlen);
  int max_sc = 0;
  for (int i = 0; i < m * m; ++i)
    if (mat[i] > max_sc) max_sc = mat[i];
  for (int c = 0; c < m; ++c)
    for (int j = 0; j < qlen; ++j)
      qp[(size_t)c * qlen + j] = mat[c * m + query[j]];

  ehH[0] = h0;
  ehH[1] = h0 > oe_ins ? h0 - oe_ins : 0;
  for (int j = 2; j <= qlen && ehH[j - 1] > e_ins; ++j)
    ehH[j] = ehH[j - 1] - e_ins;

  {  // band cap (double math, truncated)
    int max_ins = (int)(((double)qlen * max_sc + end_bonus - o_ins) /
                            e_ins + 1.0);
    if (max_ins < 1) max_ins = 1;
    if (w > max_ins) w = max_ins;
    int max_del = (int)(((double)qlen * max_sc + end_bonus - o_del) /
                            e_del + 1.0);
    if (max_del < 1) max_del = 1;
    if (w > max_del) w = max_del;
  }

  int64_t maxv = h0, gscore = -1, max_off = 0;
  int max_i = -1, max_j = -1, max_ie = -1;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    const int64_t* q = &qp[(size_t)target[i] * qlen];
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int64_t h1 = 0;
    if (beg == 0) {
      h1 = h0 - (o_del + (int64_t)e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    }
    // no beg>=end shortcut: the reference runs the collapsed-band row —
    // empty inner loop, then eh[end]/gscore bookkeeping and m==0 break
    // (ksw.c:424-456)
    int64_t f = 0, mrow = 0;
    int mj = end - 1;
    for (int j = beg; j < end; ++j) {
      const int64_t hd = ehH[j];        // H(i-1, j-1)
      const int64_t ein = ehE[j];       // E(i, j)
      ehH[j] = h1;                      // H(i, j-1)
      const int64_t M = hd ? hd + q[j] : 0;
      int64_t h = M >= ein ? M : ein;
      h = h >= f ? h : f;
      h1 = h;
      if (h >= mrow) { mrow = h; mj = j; }   // last argmax
      int64_t t = M - oe_del;
      if (t < 0) t = 0;
      int64_t e2 = ein - e_del;
      ehE[j] = e2 > t ? e2 : t;
      t = M - oe_ins;
      if (t < 0) t = 0;
      f = f - e_ins;
      if (t > f) f = t;
    }
    ehH[end] = h1;
    ehE[end] = 0;
    // reference tests the post-loop j (== end, or beg when the band is
    // collapsed and the loop never ran)
    if ((beg < end ? end : beg) == qlen) {
      if (h1 >= gscore) max_ie = i;
      if (h1 > gscore) gscore = h1;
    }
    if (mrow == 0) break;
    if (mrow > maxv) {
      maxv = mrow;
      max_i = i;
      max_j = mj;
      int64_t off = mj > i ? mj - i : i - mj;
      if (off > max_off) max_off = off;
    } else if (zdrop > 0) {
      const int64_t di = i - max_i, dj = mj - max_j;
      if (di > dj) {
        if (maxv - mrow - (di - dj) * e_del > zdrop) break;
      } else {
        if (maxv - mrow - (dj - di) * e_ins > zdrop) break;
      }
    }
    // band shrink over the written-back arrays
    int j = beg;
    while (j < end && ehH[j] == 0 && ehE[j] == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && ehH[j] == 0 && ehE[j] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  return {maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off};
}

// Exact ksw_global2 semantics (golden: bwa_flow_tpu/ops/ksw.py:147-221).
int64_t ksw_global2(int qlen, const uint8_t* query, int tlen,
                    const uint8_t* target, const int8_t* mat, int m,
                    int o_del, int e_del, int o_ins, int e_ins, int w,
                    bool want_cigar,
                    std::vector<std::pair<int, int>>* cigar) {
  const int oe_del = o_del + e_del;
  const int oe_ins = o_ins + e_ins;
  const int n_col = qlen < 2 * w + 1 ? qlen : 2 * w + 1;
  std::vector<int64_t> ehH(qlen + 2, MINUS_INF), ehE(qlen + 2, MINUS_INF);
  std::vector<int64_t> qp((size_t)m * qlen);
  for (int c = 0; c < m; ++c)
    for (int j = 0; j < qlen; ++j)
      qp[(size_t)c * qlen + j] = mat[c * m + query[j]];
  std::vector<uint8_t> z;
  if (want_cigar) z.assign((size_t)tlen * n_col, 0);
  ehH[0] = 0;
  for (int j = 1; j <= qlen && j <= w; ++j)
    ehH[j] = -(o_ins + (int64_t)e_ins * j);
  for (int i = 0; i < tlen; ++i) {
    const int64_t* q = &qp[(size_t)target[i] * qlen];
    const int beg = i - w > 0 ? i - w : 0;
    const int end = i + w + 1 < qlen ? i + w + 1 : qlen;
    int64_t h1 = beg == 0 ? -(o_del + (int64_t)e_del * (i + 1))
                          : MINUS_INF;
    int64_t f = MINUS_INF;
    uint8_t* zi = want_cigar ? &z[(size_t)i * n_col] : nullptr;
    for (int j = beg; j < end; ++j) {
      const int64_t hd = ehH[j];
      const int64_t ein = ehE[j];
      ehH[j] = h1;
      const int64_t M = hd + q[j];
      uint8_t d = M >= ein ? 0 : 1;
      int64_t h = M >= ein ? M : ein;
      d = h >= f ? d : 2;
      h = h >= f ? h : f;
      h1 = h;
      const int64_t t_del = M - oe_del;
      const int64_t e_dec = ein - e_del;
      d |= e_dec > t_del ? 1 << 2 : 0;
      ehE[j] = e_dec > t_del ? e_dec : t_del;
      const int64_t t_ins = M - oe_ins;
      const int64_t f_dec = f - e_ins;
      d |= f_dec > t_ins ? 2 << 4 : 0;
      f = f_dec > t_ins ? f_dec : t_ins;
      if (want_cigar) zi[j - beg] = d;
    }
    ehH[end] = h1;
    ehE[end] = MINUS_INF;
  }
  const int64_t score = ehH[qlen];
  if (want_cigar) {
    std::vector<std::pair<int, int>> rev;
    auto push = [&rev](int op, int len) {
      if (!rev.empty() && rev.back().first == op)
        rev.back().second += len;
      else
        rev.emplace_back(op, len);
    };
    int i = tlen - 1;
    int k = (i + w + 1 < qlen ? i + w + 1 : qlen) - 1;
    int which = 0;
    while (i >= 0 && k >= 0) {
      const int beg = i - w > 0 ? i - w : 0;
      which = (z[(size_t)i * n_col + (k - beg)] >> (which << 1)) & 3;
      if (which == 0) {
        push(0, 1);
        --i;
        --k;
      } else if (which == 1) {
        push(2, 1);
        --i;
      } else {
        push(1, 1);
        --k;
      }
    }
    if (i >= 0) push(2, i + 1);
    if (k >= 0) push(1, k + 1);
    cigar->assign(rev.rbegin(), rev.rend());
  }
  return score;
}



// ------------------------------------------------------------------
// Local alignment (ksw_align2) — exact port of the golden NumPy
// emulation of ksw_u8/ksw_i16 (bwa_flow_tpu/ops/ksw.py:282-360,
// bwa/ksw.c:111-378 semantics), used by PE mate rescue.
// ------------------------------------------------------------------

constexpr int KSW_XBYTE = 0x10000;
constexpr int KSW_XSTOP = 0x20000;
constexpr int KSW_XSUBO = 0x40000;
constexpr int KSW_XSTART = 0x80000;

struct KswResult {
  int64_t score = 0, te = -1, qe = -1, score2 = -1, te2 = -1, tb = -1,
          qb = -1;
};

inline KswResult ksw_local(int qlen, const uint8_t* query, int tlen,
                           const uint8_t* target, const int8_t* mat, int m,
                           int o_del, int e_del, int o_ins, int e_ins,
                           int xtra, bool byte_mode) {
  int64_t minsc = (xtra & KSW_XSUBO) ? (xtra & 0xFFFF) : 0x10000;
  int64_t endsc = (xtra & KSW_XSTOP) ? (xtra & 0xFFFF) : 0x10000;
  int64_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  int64_t shift = 0;
  if (byte_mode) {
    int8_t mn = 127;
    for (int i = 0; i < m * m; ++i) mn = std::min(mn, mat[i]);
    shift = -(int64_t)mn;
  }
  std::vector<int64_t> H(qlen, 0), E(qlen, 0), Hmax(qlen, 0), Hrow(qlen);
  int64_t gmax = 0, te = -1;
  struct Run { int64_t imax; int64_t i; };
  std::vector<Run> b;
  KswResult r;
  for (int i = 0; i < tlen; ++i) {
    const int8_t* q = mat + (int64_t)target[i] * m;
    int64_t f = 0, imax = 0;
    for (int j = 0; j < qlen; ++j) {
      int64_t hd = j ? H[j - 1] : 0;
      int64_t M = std::max(hd + q[query[j]], (int64_t)0);
      int64_t h = std::max(std::max(M, E[j]), f);
      Hrow[j] = h;
      E[j] = std::max(std::max(h - oe_del, (int64_t)0),
                      std::max(E[j] - e_del, (int64_t)0));
      f = std::max(f - e_ins, std::max(h - oe_ins, (int64_t)0));
      imax = std::max(imax, h);
    }
    H.swap(Hrow);
    if (imax >= minsc) {
      if (b.empty() || b.back().i + 1 != i) b.push_back({imax, i});
      else if (b.back().imax < imax) b.back() = {imax, i};
    }
    if (imax > gmax) {
      gmax = imax;
      te = i;
      Hmax = H;
      if ((byte_mode && gmax + shift >= 255) || gmax >= endsc) break;
    }
  }
  r.score = (byte_mode && gmax + shift >= 255) ? 255 : gmax;
  r.te = te;
  if (r.score != 255 || !byte_mode) {
    if (te >= 0) {
      int64_t mx = 0;
      for (int j = 0; j < qlen; ++j) mx = std::max(mx, Hmax[j]);
      for (int j = 0; j < qlen; ++j)
        if (Hmax[j] == mx) { r.qe = j; break; }
    }
    if (!b.empty()) {
      int8_t max_sc = -128;
      for (int i = 0; i < m * m; ++i) max_sc = std::max(max_sc, mat[i]);
      int64_t rad = (r.score + max_sc - 1) / max_sc;
      int64_t low = te - rad, high = te + rad;
      for (const Run& run : b)
        if ((run.i < low || run.i > high) && run.imax > r.score2) {
          r.score2 = run.imax;
          r.te2 = run.i;
        }
    }
  }
  return r;
}

inline KswResult ksw_align2(int qlen, const uint8_t* query, int tlen,
                            const uint8_t* target, const int8_t* mat,
                            int m, int o_del, int e_del, int o_ins,
                            int e_ins, int xtra) {
  bool byte_mode = (xtra & KSW_XBYTE) != 0;
  KswResult r = ksw_local(qlen, query, tlen, target, mat, m, o_del, e_del,
                          o_ins, e_ins, xtra, byte_mode);
  if ((xtra & KSW_XSTART) == 0 ||
      ((xtra & KSW_XSUBO) && r.score < (xtra & 0xFFFF)))
    return r;
  std::vector<uint8_t> qr(query, query + r.qe + 1);
  std::vector<uint8_t> tr(target, target + r.te + 1);
  std::reverse(qr.begin(), qr.end());
  std::reverse(tr.begin(), tr.end());
  KswResult rr = ksw_local((int)qr.size(), qr.data(), (int)tr.size(),
                           tr.data(), mat, m, o_del, e_del, o_ins, e_ins,
                           (int)(KSW_XSTOP | r.score), byte_mode);
  if (r.score == rr.score) {
    r.tb = r.te - rr.te;
    r.qb = r.qe - rr.qe;
  }
  return r;
}

}  // namespace bwaflow

#endif  // BWA_FLOW_TPU_KSW_IMPL_H
