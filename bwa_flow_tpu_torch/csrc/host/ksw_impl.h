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
#include <iterator>
#include <utility>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

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
// bwa/ksw.c:111-378 semantics), used by PE mate rescue. Two passes give
// the same cells: ksw_local_striped (Farrar's striped int16 pass, as
// bwa/ksw.c's ksw_i16) wherever ksw_striped_ok holds, else
// ksw_local_scalar, one int64 cell at a time.
// ------------------------------------------------------------------

constexpr int KSW_XBYTE = 0x10000;
constexpr int KSW_XSTOP = 0x20000;
constexpr int KSW_XSUBO = 0x40000;
constexpr int KSW_XSTART = 0x80000;

struct KswResult {
  int64_t score = 0, te = -1, qe = -1, score2 = -1, te2 = -1, tb = -1,
          qb = -1;
};

// A run of consecutive rows whose maxima reach minsc: its best row.
struct KswRun {
  int64_t imax, i;
};

inline void ksw_add_run(std::vector<KswRun>& b, int64_t imax, int64_t i) {
  if (b.empty() || b.back().i + 1 != i) b.push_back({imax, i});
  else if (b.back().imax < imax) b.back() = {imax, i};
}

// score2/te2: the best run outside te +- rad.
inline void ksw_second(KswResult* r, const std::vector<KswRun>& b,
                       const int8_t* mat, int m) {
  if (b.empty()) return;
  int8_t max_sc = -128;
  for (int i = 0; i < m * m; ++i) max_sc = std::max(max_sc, mat[i]);
  int64_t rad = (r->score + max_sc - 1) / max_sc;
  int64_t low = r->te - rad, high = r->te + rad;
  for (const KswRun& run : b)
    if ((run.i < low || run.i > high) && run.imax > r->score2) {
      r->score2 = run.imax;
      r->te2 = run.i;
    }
}

inline int64_t ksw_shift(const int8_t* mat, int m, bool byte_mode) {
  if (!byte_mode) return 0;
  int8_t mn = 127;
  for (int i = 0; i < m * m; ++i) mn = std::min(mn, mat[i]);
  return -(int64_t)mn;
}

inline KswResult ksw_local_scalar(int qlen, const uint8_t* query, int tlen,
                                  const uint8_t* target, const int8_t* mat,
                                  int m, int o_del, int e_del, int o_ins,
                                  int e_ins, int xtra, bool byte_mode) {
  int64_t minsc = (xtra & KSW_XSUBO) ? (xtra & 0xFFFF) : 0x10000;
  int64_t endsc = (xtra & KSW_XSTOP) ? (xtra & 0xFFFF) : 0x10000;
  int64_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  int64_t shift = ksw_shift(mat, m, byte_mode);
  std::vector<int64_t> H(qlen, 0), E(qlen, 0), Hmax(qlen, 0), Hrow(qlen);
  int64_t gmax = 0, te = -1;
  std::vector<KswRun> b;
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
    if (imax >= minsc) ksw_add_run(b, imax, i);
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
    ksw_second(&r, b, mat, m);
  }
  return r;
}

// The striped pass keeps H, E and F in int16 lanes. No cell exceeds
// qlen * max(mat), so a query within this limit never saturates a lane;
// its gap arithmetic (unsigned saturating subtraction, and the lazy-F
// stop) holds for penalties of 0 or more.
constexpr int64_t KSW_I16_LIMIT = 32767 - 255;

inline bool ksw_striped_ok(int qlen, const int8_t* mat, int m, int o_del,
                           int e_del, int o_ins, int e_ins, int xtra) {
#if defined(__SSE2__)
  int8_t max_sc = 0;
  for (int i = 0; i < m * m; ++i) max_sc = std::max(max_sc, mat[i]);
  for (int pen : {o_del, e_del, o_ins, e_ins})
    if (pen < 0 || pen > 16383) return false;
  return qlen > 0 && (int64_t)qlen * max_sc +
                             ksw_shift(mat, m, (xtra & KSW_XBYTE) != 0) <
                         KSW_I16_LIMIT;
#else
  (void)qlen, (void)mat, (void)m, (void)o_del, (void)e_del, (void)o_ins,
      (void)e_ins, (void)xtra;
  return false;
#endif
}

#if defined(__SSE2__)
// One 128-bit register's 8 int16 lanes, as stored in a std::vector
// (which would drop __m128i's vector attributes).
struct alignas(16) KswLanes {
  int16_t l[8];
};

// The striped pass's rows, query profile and runs; one set a thread,
// reused by each call.
struct KswStriped {
  std::vector<KswLanes> qp, mask, h0, h1, e, hmax;
  std::vector<KswRun> runs;
};

// Farrar's striped pass (bwa/ksw.c's ksw_i16): query position
// l * slen + s is lane l of segment s, so a row is slen vectors of 8
// lanes. Within a row F runs down each lane; the lazy-F loop carries it
// across lanes (bwa/ksw.c:177-188). E is not lifted where F lifts H: a
// gap in the target after one in the query scores as the two in the
// other order, which the next row's F computes anyway, so every H
// equals ksw_local_scalar's. Positions past qlen score 0 and feed only
// later padding; the row maximum masks them out.
inline KswResult ksw_local_striped(int qlen, const uint8_t* query, int tlen,
                                   const uint8_t* target, const int8_t* mat,
                                   int m, int o_del, int e_del, int o_ins,
                                   int e_ins, int xtra, bool byte_mode) {
  constexpr int P = 8;
  thread_local KswStriped w;
  const int64_t minsc = (xtra & KSW_XSUBO) ? (xtra & 0xFFFF) : 0x10000;
  const int64_t endsc = (xtra & KSW_XSTOP) ? (xtra & 0xFFFF) : 0x10000;
  const int64_t shift = ksw_shift(mat, m, byte_mode);
  const int slen = (qlen + P - 1) / P;
  const __m128i zero = _mm_setzero_si128();
  const __m128i oe_del = _mm_set1_epi16((int16_t)(o_del + e_del));
  const __m128i v_e_del = _mm_set1_epi16((int16_t)e_del);
  const __m128i oe_ins = _mm_set1_epi16((int16_t)(o_ins + e_ins));
  const __m128i v_e_ins = _mm_set1_epi16((int16_t)e_ins);
  w.qp.resize((size_t)m * slen);
  w.mask.resize(slen);
  for (int s = 0; s < slen; ++s)
    for (int l = 0; l < P; ++l) {
      const int j = l * slen + s;
      w.mask[s].l[l] = j < qlen ? -1 : 0;
      for (int c = 0; c < m; ++c)
        w.qp[(size_t)c * slen + s].l[l] = j < qlen ? mat[c * m + query[j]]
                                                   : 0;
    }
  w.h0.assign(slen, KswLanes{});
  w.h1.assign(slen, KswLanes{});
  w.e.assign(slen, KswLanes{});
  w.hmax.resize(slen);
  w.runs.clear();
  __m128i* H0 = (__m128i*)w.h0.data();
  __m128i* H1 = (__m128i*)w.h1.data();
  __m128i* E = (__m128i*)w.e.data();
  const __m128i* mask = (const __m128i*)w.mask.data();
  const __m128i* qp = (const __m128i*)w.qp.data();
  int64_t gmax = 0, te = -1;
  for (int i = 0; i < tlen; ++i) {
    const __m128i* S = qp + (size_t)target[i] * slen;
    __m128i f = zero, vmax = zero;
    __m128i h = _mm_slli_si128(H0[slen - 1], 2);  // H(i-1, j-1), segment 0
    for (int s = 0; s < slen; ++s) {
      h = _mm_adds_epi16(h, S[s]);
      const __m128i e = E[s];
      h = _mm_max_epi16(h, e);
      h = _mm_max_epi16(h, f);
      vmax = _mm_max_epi16(vmax, _mm_and_si128(h, mask[s]));
      H1[s] = h;
      E[s] = _mm_max_epi16(_mm_subs_epu16(e, v_e_del),
                           _mm_subs_epu16(h, oe_del));
      f = _mm_max_epi16(_mm_subs_epu16(f, v_e_ins),
                        _mm_subs_epu16(h, oe_ins));
      h = H0[s];
    }
    // F into each lane from the one below. A carried F stops mattering
    // where, decayed, it no longer beats the gap opened from the H it
    // met (that H's own F was carried already).
    bool live = true;
    for (int k = 0; k < P && live; ++k) {
      f = _mm_slli_si128(f, 2);
      for (int s = 0; s < slen; ++s) {
        const __m128i h = H1[s];
        H1[s] = _mm_max_epi16(h, f);
        f = _mm_subs_epu16(f, v_e_ins);
        if (!_mm_movemask_epi8(
                _mm_cmpgt_epi16(f, _mm_subs_epu16(h, oe_ins)))) {
          live = false;
          break;
        }
      }
    }
    // F never beats the H it came from, so the first pass saw the row max
    vmax = _mm_max_epi16(vmax, _mm_srli_si128(vmax, 8));
    vmax = _mm_max_epi16(vmax, _mm_srli_si128(vmax, 4));
    vmax = _mm_max_epi16(vmax, _mm_srli_si128(vmax, 2));
    const int64_t imax = (int16_t)_mm_extract_epi16(vmax, 0);
    if (imax >= minsc) ksw_add_run(w.runs, imax, i);
    if (imax > gmax) {
      gmax = imax;
      te = i;
      std::copy(H1, H1 + slen, (__m128i*)w.hmax.data());
      if ((byte_mode && gmax + shift >= 255) || gmax >= endsc) break;
    }
    std::swap(H0, H1);
  }
  KswResult r;
  r.score = (byte_mode && gmax + shift >= 255) ? 255 : gmax;
  r.te = te;
  if (r.score != 255 || !byte_mode) {
    if (te >= 0) {  // the first position, in query order, of the row max
      auto hm = [&](int j) { return (int64_t)w.hmax[j % slen].l[j / slen]; };
      int64_t mx = 0;
      for (int j = 0; j < qlen; ++j) mx = std::max(mx, hm(j));
      for (int j = 0; j < qlen; ++j)
        if (hm(j) == mx) { r.qe = j; break; }
    }
    ksw_second(&r, w.runs, mat, m);
  }
  return r;
}
#endif

// `striped`, if given, learns whether the call ran striped;
// `scalar_only` holds it to the scalar pass (the tests' reference).
inline KswResult ksw_align2(int qlen, const uint8_t* query, int tlen,
                            const uint8_t* target, const int8_t* mat,
                            int m, int o_del, int e_del, int o_ins,
                            int e_ins, int xtra, bool* striped = nullptr,
                            bool scalar_only = false) {
  bool byte_mode = (xtra & KSW_XBYTE) != 0;
  // the start's pass is no longer than this one, so it fits too
  const bool vec = !scalar_only && ksw_striped_ok(qlen, mat, m, o_del,
                                                  e_del, o_ins, e_ins, xtra);
  if (striped) *striped = vec;
  auto local = [&](int ql, const uint8_t* q, int tl, const uint8_t* t,
                   int x) {
#if defined(__SSE2__)
    if (vec && ql > 0)
      return ksw_local_striped(ql, q, tl, t, mat, m, o_del, e_del, o_ins,
                               e_ins, x, byte_mode);
#endif
    return ksw_local_scalar(ql, q, tl, t, mat, m, o_del, e_del, o_ins,
                            e_ins, x, byte_mode);
  };
  KswResult r = local(qlen, query, tlen, target, xtra);
  if ((xtra & KSW_XSTART) == 0 ||
      ((xtra & KSW_XSUBO) && r.score < (xtra & 0xFFFF)))
    return r;
  thread_local std::vector<uint8_t> qr, tr;
  qr.assign(std::make_reverse_iterator(query + r.qe + 1),
            std::make_reverse_iterator(query));
  tr.assign(std::make_reverse_iterator(target + r.te + 1),
            std::make_reverse_iterator(target));
  KswResult rr = local((int)qr.size(), qr.data(), (int)tr.size(), tr.data(),
                       (int)(KSW_XSTOP | r.score));
  if (r.score == rr.score) {
    r.tb = r.te - rr.te;
    r.qb = r.qe - rr.qe;
  }
  return r;
}

}  // namespace bwaflow

#endif  // BWA_FLOW_TPU_KSW_IMPL_H
