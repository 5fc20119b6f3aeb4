// bwa_flow_tpu native SE tail stage (CPython extension).
//
// Post-extension host work for a BATCH of reads: region dedup/patch,
// primary marking, MAPQ, CIGAR/NM/MD generation and SAM text emission —
// the RegionsToSam role the reference runs in C
// (src/Pipeline.cpp:546-648 over bwa/bwamem.c). C++ port of this repo's
// own golden Python specification (ops/region.py, ops/align.py,
// io/sam.py) — byte-exact against it, enforced by
// tests/test_native_region.py and the real-bwa oracle suite. The heavy
// loop runs with the GIL released so the tail thread truly overlaps the
// device driver.
//
// Build: bwa_flow_tpu_torch/_build.py (c++ at first use; no external deps)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "introsort.h"
#include "ksw_impl.h"

namespace {

using bwaflow::ks_introsort;

constexpr double PATCH_MAX_R_BW = 0.05;
constexpr double PATCH_MIN_SC_RATIO = 0.90;
constexpr double MEM_MAPQ_COEF = 30.0;
constexpr int32_t INT32_MAXV = 0x7fffffff;

// MEM_F_* flags (golden: utils/opts.py)
constexpr int F_ALL = 0x8;
constexpr int F_NO_MULTI = 0x10;
constexpr int F_PRIMARY5 = 0x800;
constexpr int F_KEEP_SUPP_MAPQ = 0x1000;
constexpr int F_SOFTCLIP = 0x200;
constexpr int F_XB = 0x2000;

struct Opt {
  int32_t a, b, o_del, e_del, o_ins, e_ins, w, T, flag, min_seed_len,
      max_chain_gap, max_XA_hits, max_XA_hits_alt, mapQ_coef_fac;
  double mask_level, mask_level_redun, drop_ratio, XA_drop_ratio,
      mapQ_coef_len;
  int8_t mat[25];
};

struct Bns {
  const uint8_t* pac;
  int64_t l_pac;
  const int64_t* offsets;
  int64_t n_ctg;
  const char* name_cat;
  const int64_t* name_off;

  int32_t pos2rid(int64_t pos_f) const {
    const int64_t* e = offsets + n_ctg;
    return (int32_t)(std::upper_bound(offsets, e, pos_f) - offsets) - 1;
  }
  std::string name(int32_t rid) const {
    return std::string(name_cat + name_off[rid],
                       name_cat + name_off[rid + 1]);
  }
  // golden fmindex.fetch_seq: clip [beg,end) to the contig containing mid
  void fetch_clip(int64_t* beg, int64_t mid, int64_t* end,
                  int32_t* rid) const {
    int64_t pos_f = mid >= l_pac ? (l_pac << 1) - 1 - mid : mid;
    bool is_rev = mid >= l_pac;
    *rid = pos2rid(pos_f);
    int64_t far_beg = offsets[*rid];
    int64_t far_end = (*rid + 1 < n_ctg) ? offsets[*rid + 1] : l_pac;
    if (is_rev) {
      int64_t b = (l_pac << 1) - far_end;
      int64_t e = (l_pac << 1) - far_beg;
      far_beg = b;
      far_end = e;
    }
    *beg = std::max(*beg, far_beg);
    *end = std::min(*end, far_end);
  }
  // golden fmindex.get_seq: bases [beg, end) of the fw-rev coordinate
  // space; empty when bridging the strand boundary
  void get_seq(int64_t beg, int64_t end, std::vector<uint8_t>* out) const {
    out->clear();
    if (end < beg) std::swap(beg, end);
    end = std::min(end, l_pac << 1);
    beg = std::max(beg, (int64_t)0);
    if (beg < l_pac && end > l_pac) return;  // bridges
    bool rev = beg >= l_pac;
    int64_t bf = rev ? (l_pac << 1) - end : beg;
    int64_t ef = rev ? (l_pac << 1) - beg : end;
    out->reserve(ef - bf);
    for (int64_t p = bf; p < ef; ++p)
      out->push_back((pac[p >> 2] >> ((~p & 3) << 1)) & 3);
    if (rev) {
      std::reverse(out->begin(), out->end());
      for (uint8_t& c : *out) c = 3 - c;
    }
  }
};

// mem_alnreg_t equivalent (golden: ops/region.py AlnReg)
struct Reg {
  int64_t rb, re;
  int32_t qb, qe, rid, score, truesc, sub, alt_sc, csub, sub_n, w, seedcov,
      secondary, secondary_all, seedlen0, n_comp, is_alt;
  double frac_rep;
  uint64_t hash;
};

// golden region.py hash_64 (bwa/utils.h:98-108)
uint64_t hash_64(uint64_t key) {
  key = key + ~(key << 32);
  key ^= key >> 22;
  key = key + ~(key << 13);
  key ^= key >> 8;
  key = key + (key << 3);
  key ^= key >> 15;
  key = key + ~(key << 27);
  key ^= key >> 31;
  return key;
}

// golden align.py:40-45
int64_t infer_bw(int64_t l1, int64_t l2, int64_t score, int64_t a,
                 int64_t q, int64_t r) {
  if (l1 == l2 && l1 * a - score < ((q + r - a) << 1)) return 0;
  int64_t w = (int64_t)((double)(std::min(l1, l2) * a - score - q) / r + 2.0);
  return std::max(w, (int64_t)std::llabs(l1 - l2));
}

struct CigarOp { int op, len; };

// golden align.py gen_cigar2 (bwa_gen_cigar2 semantics)
int64_t gen_cigar2(const Opt& opt, const Bns& bns, int64_t w_,
                   int32_t l_query, const uint8_t* query_in, int64_t rb,
                   int64_t re, bool want_cigar,
                   std::vector<CigarOp>* cigar, int32_t* NM,
                   std::string* md) {
  cigar->clear();
  *NM = -1;
  md->clear();
  if (l_query <= 0 || rb >= re || (rb < bns.l_pac && re > bns.l_pac))
    return 0;
  std::vector<uint8_t> rseq;
  bns.get_seq(rb, re, &rseq);
  int64_t rlen = (int64_t)rseq.size();
  if (re - rb != rlen) return 0;
  std::vector<uint8_t> query(query_in, query_in + l_query);
  if (rb >= bns.l_pac) {
    std::reverse(query.begin(), query.end());
    std::reverse(rseq.begin(), rseq.end());
  }
  int64_t score;
  if (l_query == re - rb && w_ == 0) {  // no-gap shortcut
    if (want_cigar) cigar->push_back({0, l_query});
    score = 0;
    for (int32_t i = 0; i < l_query; ++i)
      score += opt.mat[rseq[i] * 5 + query[i]];
  } else {
    int64_t max_ins = (int64_t)((double)(((l_query + 1) >> 1) * opt.mat[0]
                                         - opt.o_ins) / opt.e_ins + 1.0);
    int64_t max_del = (int64_t)((double)(((l_query + 1) >> 1) * opt.mat[0]
                                         - opt.o_del) / opt.e_del + 1.0);
    int64_t max_gap = std::max(std::max(max_ins, max_del), (int64_t)1);
    int64_t w = (max_gap + std::llabs(rlen - l_query) + 1) >> 1;
    w = std::min(w, w_);
    int64_t min_w = std::llabs(rlen - l_query) + 3;
    w = std::max(w, min_w);
    std::vector<std::pair<int, int>> cg;
    score = bwaflow::ksw_global2(l_query, query.data(), (int)rlen,
                                 rseq.data(), opt.mat, 5, opt.o_del,
                                 opt.e_del, opt.o_ins, opt.e_ins, (int)w,
                                 want_cigar, &cg);
    for (auto& pr : cg) cigar->push_back({pr.first, pr.second});
  }
  if (want_cigar) {  // NM + MD
    static const char* FWD = "ACGTN";
    static const char* REV = "TGCAN";
    const char* int2base = rb < bns.l_pac ? FWD : REV;
    int64_t n_mm = 0, n_gap = 0, x = 0, y = 0, u = 0;
    char buf[32];
    for (size_t k = 0; k < cigar->size(); ++k) {
      int op = (*cigar)[k].op, ln = (*cigar)[k].len;
      if (op == 0) {
        for (int i = 0; i < ln; ++i) {
          if (query[x + i] != rseq[y + i]) {
            snprintf(buf, sizeof buf, "%lld", (long long)u);
            *md += buf;
            *md += int2base[rseq[y + i]];
            ++n_mm;
            u = 0;
          } else {
            ++u;
          }
        }
        x += ln; y += ln;
      } else if (op == 2) {
        if (k > 0 && k + 1 < cigar->size()) {
          snprintf(buf, sizeof buf, "%lld", (long long)u);
          *md += buf;
          *md += '^';
          for (int i = 0; i < ln; ++i) *md += int2base[rseq[y + i]];
          u = 0;
          n_gap += ln;
        }
        y += ln;
      } else if (op == 1) {
        x += ln;
        n_gap += ln;
      }
    }
    snprintf(buf, sizeof buf, "%lld", (long long)u);
    *md += buf;
    *NM = (int32_t)(n_mm + n_gap);
  }
  return score;
}

// golden region.py mem_approx_mapq_se
int32_t approx_mapq_se(const Opt& opt, const Reg& a) {
  int64_t sub = a.sub ? a.sub : (int64_t)opt.min_seed_len * opt.a;
  sub = std::max((int64_t)a.csub, sub);
  if (sub >= a.score) return 0;
  int64_t l = std::max((int64_t)(a.qe - a.qb), a.re - a.rb);
  double identity =
      1.0 - (double)(l * opt.a - a.score) / (opt.a + opt.b) / l;
  int64_t mapq;
  if (a.score == 0) {
    mapq = 0;
  } else if (opt.mapQ_coef_len > 0) {
    double tmp = l < opt.mapQ_coef_len
                     ? 1.0
                     : (double)opt.mapQ_coef_fac / std::log((double)l);
    tmp *= identity * identity;
    mapq = (int64_t)(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499);
  } else {
    mapq = (int64_t)(MEM_MAPQ_COEF * (1.0 - (double)sub / a.score) *
                         std::log((double)a.seedcov) + 0.499);
    if (identity < 0.95)
      mapq = (int64_t)(mapq * identity * identity + 0.499);
  }
  if (a.sub_n > 0)
    mapq -= (int64_t)(4.343 * std::log((double)a.sub_n + 1) + 0.499);
  mapq = std::min(mapq, (int64_t)60);
  mapq = std::max(mapq, (int64_t)0);
  return (int32_t)(mapq * (1.0 - a.frac_rep) + 0.499);
}

// golden region.py mem_patch_reg
int64_t patch_reg(const Opt& opt, const Bns& bns, const uint8_t* query,
                  const Reg& a, const Reg& b, int64_t* w_out) {
  if (a.rb < bns.l_pac && bns.l_pac <= b.rb) return 0;
  if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return 0;
  int64_t w = std::llabs((a.re - b.rb) - (int64_t)(a.qe - b.qb));
  double r = std::fabs((double)(a.re - b.rb) / (b.re - a.rb) -
                       (double)(a.qe - b.qb) / (b.qe - a.qb));
  if (a.re < b.rb || a.qe < b.qb) {
    if (w > (int64_t)opt.w << 1 || r >= PATCH_MAX_R_BW) return 0;
  } else if (w > (int64_t)opt.w << 2 || r >= PATCH_MAX_R_BW * 2) {
    return 0;
  }
  w += a.w + b.w;
  w = std::min(w, (int64_t)opt.w << 2);
  std::vector<CigarOp> cg;
  int32_t NM;
  std::string md;
  int64_t score = gen_cigar2(opt, bns, w, b.qe - a.qb, query + a.qb, a.rb,
                             b.re, false, &cg, &NM, &md);
  int64_t q_s = (int64_t)((double)(b.qe - a.qb) /
                              ((b.qe - b.qb) + (a.qe - a.qb)) *
                              (b.score + a.score) + 0.499);
  int64_t r_s = (int64_t)((double)(b.re - a.rb) /
                              ((b.re - b.rb) + (a.re - a.rb)) *
                              (b.score + a.score) + 0.499);
  if ((double)score / std::max(q_s, r_s) < PATCH_MIN_SC_RATIO) return 0;
  *w_out = w;
  return score;
}

// golden region.py mem_sort_dedup_patch
void dedup_patch(const Opt& opt, const Bns& bns, const uint8_t* query,
                 std::vector<Reg>& regs, bool do_patch = true) {
  int64_t n = (int64_t)regs.size();
  if (n <= 1) return;
  std::vector<Reg>& a = regs;
  ks_introsort(a, [](const Reg& x, const Reg& y) { return x.re < y.re; });
  for (Reg& p : a) p.n_comp = 1;
  for (int64_t i = 1; i < n; ++i) {
    Reg& p = a[i];
    if (p.rid != a[i - 1].rid || p.rb >= a[i - 1].re + opt.max_chain_gap)
      continue;
    for (int64_t j = i - 1;
         j >= 0 && p.rid == a[j].rid && p.rb < a[j].re + opt.max_chain_gap;
         --j) {
      Reg& q = a[j];
      if (q.qe == q.qb) continue;  // excluded
      int64_t o_r = q.re - p.rb;
      int64_t o_q = q.qb < p.qb ? (int64_t)(q.qe - p.qb)
                                : (int64_t)(p.qe - q.qb);
      int64_t m_r = std::min(q.re - q.rb, p.re - p.rb);
      int64_t m_q = std::min((int64_t)(q.qe - q.qb), (int64_t)(p.qe - p.qb));
      if (o_r > opt.mask_level_redun * m_r &&
          o_q > opt.mask_level_redun * m_q) {
        if (p.score < q.score) {
          p.qe = p.qb;
          break;
        } else {
          q.qe = q.qb;
        }
      } else if (do_patch && q.rb < p.rb) {
        int64_t w = 0;
        int64_t score = patch_reg(opt, bns, query, q, p, &w);
        if (score > 0) {  // merge q into p
          p.n_comp += q.n_comp + 1;
          p.seedcov = std::max(p.seedcov, q.seedcov);
          p.sub = std::max(p.sub, q.sub);
          p.csub = std::max(p.csub, q.csub);
          p.qb = q.qb;
          p.rb = q.rb;
          p.truesc = p.score = (int32_t)score;
          p.w = (int32_t)w;
          q.qb = q.qe;
        }
      }
    }
  }
  std::vector<Reg> kept;
  kept.reserve(a.size());
  for (Reg& p : a)
    if (p.qe > p.qb) kept.push_back(p);
  a.swap(kept);
  ks_introsort(a, [](const Reg& x, const Reg& y) {
    return x.score > y.score ||
           (x.score == y.score &&
            (x.rb < y.rb || (x.rb == y.rb && x.qb < y.qb)));
  });
  for (size_t i = 1; i < a.size(); ++i)
    if (a[i].score == a[i - 1].score && a[i].rb == a[i - 1].rb &&
        a[i].qb == a[i - 1].qb)
      a[i].qe = a[i].qb;
  kept.clear();
  for (size_t i = 0; i < a.size(); ++i)
    if (i == 0 || a[i].qe > a[i].qb) kept.push_back(a[i]);
  a.swap(kept);
}

// golden region.py _mark_primary_core
void mark_primary_core(const Opt& opt, std::vector<Reg>& a, int64_t n) {
  int64_t tmp = std::max((int64_t)opt.a + opt.b,
                         std::max((int64_t)opt.o_del + opt.e_del,
                                  (int64_t)opt.o_ins + opt.e_ins));
  std::vector<int64_t> z{0};
  for (int64_t i = 1; i < n; ++i) {
    int64_t found = -1;
    for (int64_t k : z) {
      int64_t b_max = std::max(a[k].qb, a[i].qb);
      int64_t e_min = std::min(a[k].qe, a[i].qe);
      if (e_min > b_max) {
        int64_t min_l = std::min((int64_t)(a[i].qe - a[i].qb),
                                 (int64_t)(a[k].qe - a[k].qb));
        if (e_min - b_max >= min_l * opt.mask_level) {
          if (a[k].sub == 0) a[k].sub = a[i].score;
          if (a[k].score - a[i].score <= tmp &&
              (a[k].is_alt || !a[i].is_alt))
            ++a[k].sub_n;
          found = k;
          break;
        }
      }
    }
    if (found < 0) z.push_back(i);
    else a[i].secondary = (int32_t)found;
  }
}

// golden region.py mem_mark_primary_se
int64_t mark_primary_se(const Opt& opt, std::vector<Reg>& a, int64_t rid_) {
  int64_t n = (int64_t)a.size();
  if (n == 0) return 0;
  int64_t n_pri = 0;
  for (int64_t i = 0; i < n; ++i) {
    Reg& p = a[i];
    p.sub = p.alt_sc = 0;
    p.secondary = p.secondary_all = -1;
    p.hash = hash_64((uint64_t)(rid_ + i));
    if (!p.is_alt) ++n_pri;
  }
  ks_introsort(a, [](const Reg& x, const Reg& y) {  // alnreg_hlt
    return x.score > y.score ||
           (x.score == y.score &&
            (x.is_alt < y.is_alt ||
             (x.is_alt == y.is_alt && x.hash < y.hash)));
  });
  mark_primary_core(opt, a, n);
  for (int64_t i = 0; i < n; ++i) {
    Reg& p = a[i];
    p.secondary_all = (int32_t)i;
    if (!p.is_alt && p.secondary >= 0 && a[p.secondary].is_alt)
      p.alt_sc = a[p.secondary].score;
  }
  if (0 <= n_pri && n_pri < n) {
    if (n_pri > 0) {
      ks_introsort(a, [](const Reg& x, const Reg& y) {  // alnreg_hlt2
        return x.is_alt < y.is_alt ||
               (x.is_alt == y.is_alt &&
                (x.score > y.score ||
                 (x.score == y.score && x.hash < y.hash)));
      });
    }
    std::vector<int64_t> z(n);
    for (int64_t i = 0; i < n; ++i) z[a[i].secondary_all] = i;
    for (int64_t i = 0; i < n; ++i) {
      Reg& p = a[i];
      if (p.secondary >= 0) {
        p.secondary_all = (int32_t)z[p.secondary];
        if (p.is_alt) p.secondary = INT32_MAXV;
      } else {
        p.secondary_all = -1;
      }
    }
    if (n_pri > 0) {
      for (int64_t i = 0; i < n_pri; ++i) {
        a[i].sub = 0;
        a[i].secondary = -1;
      }
      mark_primary_core(opt, a, n_pri);
    }
  } else {
    for (Reg& p : a) p.secondary_all = p.secondary;
  }
  return n_pri;
}

// golden region.py mem_reorder_primary5
void reorder_primary5(int32_t T, std::vector<Reg>& a) {
  int64_t n_pri = 0;
  for (const Reg& p : a)
    if (p.secondary < 0 && !p.is_alt && p.score >= T) ++n_pri;
  if (n_pri <= 1) return;
  int64_t left_st = INT32_MAXV, left_k = -1;
  for (int64_t k = 0; k < (int64_t)a.size(); ++k) {
    const Reg& p = a[k];
    if (p.secondary >= 0 || p.is_alt || p.score < T) continue;
    if (p.qb < left_st) { left_st = p.qb; left_k = k; }
  }
  if (left_k == 0) return;
  std::swap(a[0], a[left_k]);
  for (int64_t k = 1; k < (int64_t)a.size(); ++k) {
    Reg& p = a[k];
    if (p.secondary == 0) p.secondary = (int32_t)left_k;
    else if (p.secondary == left_k) p.secondary = 0;
    if (p.secondary_all == 0) p.secondary_all = (int32_t)left_k;
    else if (p.secondary_all == left_k) p.secondary_all = 0;
  }
}

// mem_aln_t equivalent (golden: ops/align.py Aln)
struct AlnT {
  int64_t pos = -1;
  int32_t rid = -1, flag = 0, is_rev = 0, is_alt = 0, mapq = 0, NM = -1;
  std::vector<CigarOp> cigar;
  std::string MD;
  std::string XA;   // empty = none
  int32_t score = -1, sub = -1, alt_sc = 0;
};

// golden align.py mem_reg2aln
AlnT reg2aln(const Opt& opt, const Bns& bns, int32_t l_query,
             const uint8_t* query, const Reg* ar) {
  AlnT a;
  if (ar == nullptr || ar->rb < 0 || ar->re < 0) {
    a.rid = -1;
    a.pos = -1;
    a.flag |= 0x4;
    a.score = 0;
    a.sub = 0;
    return a;
  }
  int32_t qb = ar->qb, qe = ar->qe;
  int64_t rb = ar->rb, re = ar->re;
  a.mapq = ar->secondary < 0 ? approx_mapq_se(opt, *ar) : 0;
  if (ar->secondary >= 0) a.flag |= 0x100;
  int64_t tmp = infer_bw(qe - qb, re - rb, ar->truesc, opt.a, opt.o_del,
                         opt.e_del);
  int64_t w2 = infer_bw(qe - qb, re - rb, ar->truesc, opt.a, opt.o_ins,
                        opt.e_ins);
  w2 = std::max(w2, tmp);
  if (w2 > opt.w) w2 = std::min(w2, (int64_t)ar->w);
  int64_t last_sc = -(1ll << 30);
  int i = 0;
  int32_t NM = -1;
  std::vector<CigarOp> cigar;
  std::string md;
  int64_t score = 0;
  while (true) {
    w2 = std::min(w2, (int64_t)opt.w << 2);
    score = gen_cigar2(opt, bns, w2, qe - qb, query + qb, rb, re, true,
                       &cigar, &NM, &md);
    if (score == last_sc || w2 == (int64_t)opt.w << 2) break;
    last_sc = score;
    w2 <<= 1;
    ++i;
    if (i >= 3 || score >= ar->truesc - opt.a) break;
  }
  a.NM = NM;
  a.MD = md;
  int64_t p0 = rb < bns.l_pac ? rb : re - 1;
  bool is_rev = p0 >= bns.l_pac;
  int64_t pos = is_rev ? (bns.l_pac << 1) - 1 - p0 : p0;
  a.is_rev = is_rev ? 1 : 0;
  if (!cigar.empty()) {  // squeeze out leading/trailing deletions
    if (cigar[0].op == 2) {
      pos += cigar[0].len;
      cigar.erase(cigar.begin());
    } else if (cigar.back().op == 2) {
      cigar.pop_back();
    }
  }
  if (qb != 0 || qe != l_query) {  // clipping
    int32_t clip5 = is_rev ? l_query - qe : qb;
    int32_t clip3 = is_rev ? qb : l_query - qe;
    if (clip5) cigar.insert(cigar.begin(), {3, clip5});
    if (clip3) cigar.push_back({3, clip3});
  }
  a.cigar = std::move(cigar);
  a.rid = bns.pos2rid(pos);
  a.pos = pos - bns.offsets[a.rid];
  a.score = ar->score;
  a.sub = std::max(ar->sub, ar->csub);
  a.is_alt = ar->is_alt;
  a.alt_sc = ar->alt_sc;
  return a;
}

static const char CIGAR_CHARS[] = "MIDSH";
static const char CIGAR_CHARS_N[] = "MIDSHN";

// golden sam.py _cigar_str (add_cigar)
void cigar_str(const Opt& opt, const AlnT& p, int which, std::string* out) {
  if (p.cigar.empty()) { *out += '*'; return; }
  char buf[24];
  for (const CigarOp& co : p.cigar) {
    int c = co.op;
    if (!(opt.flag & F_SOFTCLIP) && !p.is_alt && (c == 3 || c == 4))
      c = which ? 4 : 3;
    snprintf(buf, sizeof buf, "%d%c", co.len, CIGAR_CHARS[c]);
    *out += buf;
  }
}

int64_t get_rlen(const std::vector<CigarOp>& cig) {
  int64_t n = 0;
  for (const CigarOp& co : cig)
    if (co.op == 0 || co.op == 2) n += co.len;
  return n;
}

// golden sam.py get_pri_idx
int64_t get_pri_idx(double xa_drop, const std::vector<Reg>& a, int64_t i) {
  int64_t k = a[i].secondary_all;
  if (k >= 0 && a[i].score >= a[k].score * xa_drop) return k;
  return -1;
}

// golden sam.py mem_gen_alt (XA strings per primary hit)
void gen_alt(const Opt& opt, const Bns& bns, const std::vector<Reg>& a,
             int32_t l_query, const uint8_t* query,
             std::vector<std::string>* XA) {
  int64_t n = (int64_t)a.size();
  XA->assign(n, std::string());
  std::vector<int32_t> cnt(n, 0);
  std::vector<uint8_t> has_alt(n, 0);
  int64_t tot = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = get_pri_idx(opt.XA_drop_ratio, a, i);
    if (r >= 0) {
      ++cnt[r];
      ++tot;
      if (a[i].is_alt) has_alt[r] = 1;
    }
  }
  if (tot == 0) return;
  char buf[64];
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = get_pri_idx(opt.XA_drop_ratio, a, i);
    if (r < 0) continue;
    if (cnt[r] > opt.max_XA_hits_alt ||
        (!has_alt[r] && cnt[r] > opt.max_XA_hits))
      continue;
    AlnT t = reg2aln(opt, bns, l_query, query, &a[i]);
    std::string& out = (*XA)[r];
    out += bns.name(t.rid);
    snprintf(buf, sizeof buf, ",%c%lld,", "+-"[t.is_rev],
             (long long)(t.pos + 1));
    out += buf;
    for (const CigarOp& co : t.cigar) {
      snprintf(buf, sizeof buf, "%d%c", co.len, CIGAR_CHARS_N[co.op]);
      out += buf;
    }
    snprintf(buf, sizeof buf, ",%d", t.NM);
    out += buf;
    if (opt.flag & F_XB) {
      snprintf(buf, sizeof buf, ",%d", t.score);
      out += buf;
    }
    out += ';';
  }
}

// golden sam.py mem_aln2sam
void aln2sam(const Opt& opt, const Bns& bns, const std::string& name,
             int32_t l_seq, const uint8_t* seq, const char* qual,
             const std::string& comment, int64_t n_alns,
             const std::vector<AlnT>& alns, int64_t which,
             const std::string& rg_id, std::string* out,
             const AlnT* m_in = nullptr) {
  AlnT p = alns[which];  // copy (flag mutations are local)
  AlnT m_store;
  AlnT* m = nullptr;
  if (m_in) {
    m_store = *m_in;
    m = &m_store;
  }
  p.flag |= m ? 0x1 : 0;
  p.flag |= (p.rid < 0) ? 0x4 : 0;
  p.flag |= (m && m->rid < 0) ? 0x8 : 0;
  if (p.rid < 0 && m && m->rid >= 0) {  // copy mate to alignment
    p.rid = m->rid;
    p.pos = m->pos;
    p.is_rev = m->is_rev;
    p.cigar.clear();
  }
  if (m && m->rid < 0 && p.rid >= 0) {  // copy alignment to mate
    m->rid = p.rid;
    m->pos = p.pos;
    m->is_rev = p.is_rev;
    m->cigar.clear();
  }
  p.flag |= p.is_rev ? 0x10 : 0;
  p.flag |= (m && m->is_rev) ? 0x20 : 0;
  char buf[64];
  *out += name;
  snprintf(buf, sizeof buf, "\t%d\t",
           (p.flag & 0xFFFF) | ((p.flag & 0x10000) ? 0x100 : 0));
  *out += buf;
  if (p.rid >= 0) {
    *out += bns.name(p.rid);
    snprintf(buf, sizeof buf, "\t%lld\t%d\t", (long long)(p.pos + 1),
             p.mapq);
    *out += buf;
    cigar_str(opt, p, (int)which, out);
  } else {
    *out += "*\t0\t0\t*";
  }
  *out += '\t';
  if (m && m->rid >= 0) {
    if (p.rid == m->rid) *out += '=';
    else *out += bns.name(m->rid);
    snprintf(buf, sizeof buf, "\t%lld\t", (long long)(m->pos + 1));
    *out += buf;
    if (p.rid == m->rid) {
      if (m->cigar.empty() || p.cigar.empty()) {
        *out += '0';
      } else {
        int64_t p0 = p.pos + (p.is_rev ? get_rlen(p.cigar) - 1 : 0);
        int64_t p1 = m->pos + (m->is_rev ? get_rlen(m->cigar) - 1 : 0);
        int64_t sign = p0 > p1 ? 1 : (p0 < p1 ? -1 : 0);
        snprintf(buf, sizeof buf, "%lld", (long long)(-(p0 - p1 + sign)));
        *out += buf;
      }
    } else {
      *out += '0';
    }
  } else {
    *out += "*\t0\t0";
  }
  *out += '\t';
  // SEQ + QUAL
  static const char* FWD = "ACGTN";
  static const char* REV = "TGCAN";
  if (p.flag & 0x100) {
    *out += "*\t*";
  } else {
    int32_t qb = 0, qe = l_seq;
    bool clip = !p.cigar.empty() && which && !(opt.flag & F_SOFTCLIP) &&
                !p.is_alt;
    if (!p.is_rev) {
      if (clip) {
        if (p.cigar[0].op == 3 || p.cigar[0].op == 4) qb += p.cigar[0].len;
        if (p.cigar.back().op == 3 || p.cigar.back().op == 4)
          qe -= p.cigar.back().len;
      }
      for (int32_t i = qb; i < qe; ++i) *out += FWD[seq[i]];
      *out += '\t';
      if (qual) out->append(qual + qb, qual + qe);
      else *out += '*';
    } else {
      if (clip) {
        if (p.cigar[0].op == 3 || p.cigar[0].op == 4) qe -= p.cigar[0].len;
        if (p.cigar.back().op == 3 || p.cigar.back().op == 4)
          qb += p.cigar.back().len;
      }
      for (int32_t i = qe - 1; i >= qb; --i) *out += REV[seq[i]];
      *out += '\t';
      if (qual) {
        for (int32_t i = qe - 1; i >= qb; --i) *out += qual[i];
      } else {
        *out += '*';
      }
    }
  }
  // optional tags
  if (!p.cigar.empty()) {
    snprintf(buf, sizeof buf, "\tNM:i:%d\tMD:Z:", p.NM);
    *out += buf;
    *out += p.MD;
  }
  if (m && !m->cigar.empty()) {
    *out += "\tMC:Z:";
    cigar_str(opt, *m, (int)which, out);
  }
  if (p.score >= 0) {
    snprintf(buf, sizeof buf, "\tAS:i:%d", p.score);
    *out += buf;
  }
  if (p.sub >= 0) {
    snprintf(buf, sizeof buf, "\tXS:i:%d", p.sub);
    *out += buf;
  }
  if (!rg_id.empty()) {
    *out += "\tRG:Z:";
    *out += rg_id;
  }
  if (!(p.flag & 0x100)) {
    bool others = false;
    for (int64_t i = 0; i < n_alns; ++i)
      if (i != which && !(alns[i].flag & 0x100)) { others = true; break; }
    if (others) {
      *out += "\tSA:Z:";
      for (int64_t i = 0; i < n_alns; ++i) {
        const AlnT& r = alns[i];
        if (i == which || (r.flag & 0x100)) continue;
        *out += bns.name(r.rid);
        snprintf(buf, sizeof buf, ",%lld,%c,", (long long)(r.pos + 1),
                 "+-"[r.is_rev]);
        *out += buf;
        for (const CigarOp& co : r.cigar) {
          snprintf(buf, sizeof buf, "%d%c", co.len, CIGAR_CHARS[co.op]);
          *out += buf;
        }
        snprintf(buf, sizeof buf, ",%d,%d;", r.mapq, r.NM);
        *out += buf;
      }
    }
    if (p.alt_sc > 0) {
      snprintf(buf, sizeof buf, "\tpa:f:%.3f",
               (double)p.score / p.alt_sc);
      *out += buf;
    }
  }
  if (!p.XA.empty()) {
    *out += (opt.flag & F_XB) ? "\tXB:Z:" : "\tXA:Z:";
    *out += p.XA;
  }
  if (!comment.empty()) {
    *out += '\t';
    *out += comment;
  }
  *out += '\n';
}

// golden sam.py mem_reg2sam
void reg2sam(const Opt& opt, const Bns& bns, const std::string& name,
             int32_t l_seq, const uint8_t* seq, const char* qual,
             const std::string& comment, std::vector<Reg>& a,
             const std::string& rg_id, std::string* sam,
             int32_t extra_flag, const AlnT* m) {
  std::vector<std::string> XA;
  bool want_xa = !(opt.flag & F_ALL);
  if (want_xa) gen_alt(opt, bns, a, l_seq, seq, &XA);
  std::vector<AlnT> aa;
  int64_t l = 0;
  for (int64_t k = 0; k < (int64_t)a.size(); ++k) {
    Reg& p = a[k];
    if (p.score < opt.T) continue;
    if (p.secondary >= 0 && (p.is_alt || !(opt.flag & F_ALL))) continue;
    if (p.secondary >= 0 && p.secondary < INT32_MAXV &&
        p.score < a[p.secondary].score * opt.drop_ratio)
      continue;
    AlnT q = reg2aln(opt, bns, l_seq, seq, &p);
    if (want_xa) q.XA = XA[k];
    q.flag |= extra_flag;
    if (p.secondary >= 0) q.sub = -1;
    if (l && p.secondary < 0)
      q.flag |= (opt.flag & F_NO_MULTI) ? 0x10000 : 0x800;
    if (!(opt.flag & F_KEEP_SUPP_MAPQ) && l && !p.is_alt &&
        q.mapq > aa[0].mapq)
      q.mapq = aa[0].mapq;
    ++l;
    aa.push_back(std::move(q));
  }
  if (aa.empty()) {
    AlnT t = reg2aln(opt, bns, l_seq, seq, nullptr);
    t.flag |= extra_flag;
    std::vector<AlnT> one{std::move(t)};
    aln2sam(opt, bns, name, l_seq, seq, qual, comment, 1, one, 0, rg_id,
            sam, m);
  } else {
    for (int64_t k = 0; k < (int64_t)aa.size(); ++k)
      aln2sam(opt, bns, name, l_seq, seq, qual, comment,
              (int64_t)aa.size(), aa, k, rg_id, sam, m);
  }
}

// the SE tail entry keeps its old shape
void reg2sam_se(const Opt& opt, const Bns& bns, const std::string& name,
                int32_t l_seq, const uint8_t* seq, const char* qual,
                const std::string& comment, std::vector<Reg>& a,
                const std::string& rg_id, std::string* sam) {
  reg2sam(opt, bns, name, l_seq, seq, qual, comment, a, rg_id, sam, 0,
          nullptr);
}


// ------------------------------------------------------------------
// Paired-end tail (golden: ops/pe.py over bwa/bwamem_pair.c)
// ------------------------------------------------------------------

constexpr double PE_MIN_RATIO = 0.8;
constexpr int PE_MIN_DIR_CNT = 10;
constexpr double PE_MIN_DIR_RATIO = 0.05;
constexpr double PE_OUTLIER_BOUND = 2.0;
constexpr double PE_MAPPING_BOUND = 3.0;
constexpr double PE_MAX_STDDEV = 4.0;
constexpr int F_NO_RESCUE = 0x20;
constexpr int F_NOPAIRING = 0x4;

struct PeOpt {           // the PE-specific option fields
  int32_t pen_clip5, pen_clip3, zdrop, pen_unpaired, max_matesw;
  int64_t max_ins;
};

struct PeStatC {
  int64_t low = 0, high = 0;
  int32_t failed = 0;
  double avg = 0.0, stdv = 0.0;
};

// golden pe.py mem_infer_dir
inline void infer_dir(int64_t l_pac, int64_t b1, int64_t b2, int* d,
                      int64_t* dist) {
  bool r1 = b1 >= l_pac, r2 = b2 >= l_pac;
  int64_t p2 = (r1 == r2) ? b2 : (l_pac << 1) - 1 - b2;
  *dist = p2 > b1 ? p2 - b1 : b1 - p2;
  *d = ((r1 == r2) ? 0 : 1) ^ (p2 > b1 ? 0 : 3);
}

// golden pe.py _cal_sub
int64_t cal_sub(const Opt& o, const std::vector<Reg>& r) {
  for (size_t j = 1; j < r.size(); ++j) {
    int64_t b_max = std::max(r[j].qb, r[0].qb);
    int64_t e_min = std::min(r[j].qe, r[0].qe);
    if (e_min > b_max) {
      int64_t min_l = std::min((int64_t)(r[j].qe - r[j].qb),
                               (int64_t)(r[0].qe - r[0].qb));
      if (e_min - b_max >= min_l * o.mask_level) return r[j].score;
    }
  }
  return (int64_t)o.min_seed_len * o.a;
}

// golden pe.py mem_pestat
void pestat(const Opt& o, const PeOpt& po, int64_t l_pac,
            const std::vector<std::vector<Reg>>& regs, PeStatC pes[4]) {
  std::vector<int64_t> isize[4];
  int64_t n = (int64_t)regs.size();
  for (int64_t i = 0; i < n / 2; ++i) {
    const std::vector<Reg>& r0 = regs[2 * i];
    const std::vector<Reg>& r1 = regs[2 * i + 1];
    if (r0.empty() || r1.empty()) continue;
    if (cal_sub(o, r0) > PE_MIN_RATIO * r0[0].score) continue;
    if (cal_sub(o, r1) > PE_MIN_RATIO * r1[0].score) continue;
    if (r0[0].rid != r1[0].rid) continue;
    int d;
    int64_t dist;
    infer_dir(l_pac, r0[0].rb, r1[0].rb, &d, &dist);
    if (dist && dist <= po.max_ins) isize[d].push_back(dist);
  }
  size_t mx = 0;
  for (int d = 0; d < 4; ++d) mx = std::max(mx, isize[d].size());
  for (int d = 0; d < 4; ++d) {
    PeStatC& r = pes[d];
    std::vector<int64_t>& q = isize[d];
    std::sort(q.begin(), q.end());
    if ((int64_t)q.size() < PE_MIN_DIR_CNT) {
      r.failed = 1;
      continue;
    }
    int64_t p25 = q[(size_t)(0.25 * q.size() + 0.499)];
    int64_t p75 = q[(size_t)(0.75 * q.size() + 0.499)];
    r.low = std::max(
        (int64_t)(p25 - PE_OUTLIER_BOUND * (p75 - p25) + 0.499),
        (int64_t)1);
    r.high = (int64_t)(p75 + PE_OUTLIER_BOUND * (p75 - p25) + 0.499);
    double sum = 0;
    int64_t cnt = 0;
    for (int64_t v : q)
      if (r.low <= v && v <= r.high) { sum += (double)v; ++cnt; }
    r.avg = sum / cnt;
    double var = 0;
    for (int64_t v : q)
      if (r.low <= v && v <= r.high)
        var += ((double)v - r.avg) * ((double)v - r.avg);
    r.stdv = std::sqrt(var / cnt);
    r.low = (int64_t)(p25 - PE_MAPPING_BOUND * (p75 - p25) + 0.499);
    r.high = (int64_t)(p75 + PE_MAPPING_BOUND * (p75 - p25) + 0.499);
    if ((double)r.low > r.avg - PE_MAX_STDDEV * r.stdv)
      r.low = (int64_t)(r.avg - PE_MAX_STDDEV * r.stdv + 0.499);
    if ((double)r.high < r.avg + PE_MAX_STDDEV * r.stdv)
      r.high = (int64_t)(r.avg + PE_MAX_STDDEV * r.stdv + 0.499);
    r.low = std::max(r.low, (int64_t)1);
  }
  for (int d = 0; d < 4; ++d)
    if (pes[d].failed == 0 && (double)isize[d].size() < mx * PE_MIN_DIR_RATIO)
      pes[d].failed = 1;
}

// golden pe.py mem_matesw (pair.c:114-183)
// Returns its ksw_align2 calls; `n_vec` gains those that ran striped.
int matesw(const Opt& o, const PeOpt& po, const Bns& bns,
           const PeStatC pes[4], const Reg& a, int32_t l_ms,
           const uint8_t* ms, std::vector<Reg>& ma, int64_t* n_vec) {
  int64_t l_pac = bns.l_pac;
  bool skip[4];
  for (int r = 0; r < 4; ++r) skip[r] = pes[r].failed != 0;
  for (const Reg& p : ma) {
    int r;
    int64_t dist;
    infer_dir(l_pac, a.rb, p.rb, &r, &dist);
    if (pes[r].low <= dist && dist <= pes[r].high) skip[r] = true;
  }
  if (skip[0] && skip[1] && skip[2] && skip[3]) return 0;
  int n = 0;
  for (int r = 0; r < 4; ++r) {
    if (skip[r]) continue;
    bool is_rev = ((r >> 1) != (r & 1));
    bool is_larger = !(r >> 1);
    std::vector<uint8_t> seq(ms, ms + l_ms);
    if (is_rev) {
      std::reverse(seq.begin(), seq.end());
      for (uint8_t& c : seq) c = c < 4 ? 3 - c : 4;
    }
    int64_t rb, re;
    if (!is_rev) {
      rb = is_larger ? a.rb + pes[r].low : a.rb - pes[r].high;
      re = (is_larger ? a.rb + pes[r].high : a.rb - pes[r].low) + l_ms;
    } else {
      rb = (is_larger ? a.rb + pes[r].low : a.rb - pes[r].high) - l_ms;
      re = is_larger ? a.rb + pes[r].high : a.rb - pes[r].low;
    }
    rb = std::max(rb, (int64_t)0);
    re = std::min(re, l_pac << 1);
    int32_t rid = -1;
    std::vector<uint8_t> ref;
    if (rb < re) {
      int64_t mid = (rb + re) >> 1;
      bns.fetch_clip(&rb, mid, &re, &rid);
      bns.get_seq(rb, re, &ref);
    }
    if (a.rid == rid && re - rb >= o.min_seed_len) {
      int xtra = bwaflow::KSW_XSUBO | bwaflow::KSW_XSTART |
                 ((int64_t)l_ms * o.a < 250 ? bwaflow::KSW_XBYTE : 0) |
                 (o.min_seed_len * o.a);
      bool vec = false;
      bwaflow::KswResult aln = bwaflow::ksw_align2(
          l_ms, seq.data(), (int)(re - rb), ref.data(), o.mat, 5, o.o_del,
          o.e_del, o.o_ins, o.e_ins, xtra, &vec);
      *n_vec += vec;
      if (aln.score >= o.min_seed_len && aln.qb >= 0) {
        Reg b{};
        b.rid = a.rid;
        b.is_alt = a.is_alt;
        b.qb = (int32_t)(is_rev ? l_ms - (aln.qe + 1) : aln.qb);
        b.qe = (int32_t)(is_rev ? l_ms - aln.qb : aln.qe + 1);
        b.rb = is_rev ? (l_pac << 1) - (rb + aln.te + 1) : rb + aln.tb;
        b.re = is_rev ? (l_pac << 1) - (rb + aln.tb) : rb + aln.te + 1;
        b.score = (int32_t)aln.score;
        b.csub = (int32_t)aln.score2;
        b.secondary = -1;
        b.seedcov =
            (int32_t)(std::min(b.re - b.rb, (int64_t)(b.qe - b.qb)) >> 1);
        b.truesc = 0;
        size_t ins = ma.size();
        for (size_t i = 0; i < ma.size(); ++i)
          if (ma[i].score < b.score) { ins = i; break; }
        ma.insert(ma.begin() + ins, b);
      }
      ++n;
    }
    if (n) dedup_patch(o, bns, nullptr, ma, /*do_patch=*/false);
  }
  return n;
}

inline int64_t raw_mapq(int64_t diff, int64_t a) {
  return (int64_t)(6.02 * (double)diff / (double)a + 0.499);
}

// golden pe.py mem_pair (pair.c:185-246)
void mem_pair(const Opt& o, const Bns& bns, const PeStatC pes[4],
              std::vector<Reg>* a, uint64_t rid_, const int64_t n_pri[2],
              int64_t* o_out, int64_t* sub_out, int64_t* nsub_out,
              int64_t z[2]) {
  z[0] = z[1] = -1;
  *o_out = *sub_out = *nsub_out = 0;
  int64_t l_pac = bns.l_pac;
  std::vector<std::pair<uint64_t, uint64_t>> v;
  for (int r = 0; r < 2; ++r) {
    for (int64_t i = 0; i < n_pri[r]; ++i) {
      const Reg& e = a[r][i];
      uint64_t kx = (uint64_t)(e.rb < l_pac ? e.rb
                                            : (l_pac << 1) - 1 - e.rb);
      kx = ((uint64_t)e.rid << 32) | (kx - (uint64_t)bns.offsets[e.rid]);
      uint64_t ky = ((uint64_t)e.score << 32) | ((uint64_t)i << 2) |
                    ((e.rb >= l_pac ? 1ull : 0ull) << 1) | (uint64_t)r;
      v.push_back({kx, ky});
    }
  }
  std::sort(v.begin(), v.end());
  std::vector<std::pair<uint64_t, uint64_t>> u;
  int64_t y[4] = {-1, -1, -1, -1};
  for (int64_t i = 0; i < (int64_t)v.size(); ++i) {
    for (int r = 0; r < 2; ++r) {
      int dr = (r << 1) | ((v[i].second >> 1) & 1);
      if (pes[dr].failed) continue;
      int which = (r << 1) | ((v[i].second & 1) ^ 1);
      if (y[which] < 0) continue;
      for (int64_t k = y[which]; k >= 0; --k) {
        if ((int)(v[k].second & 3) != which) continue;
        int64_t dist = (int64_t)(v[i].first - v[k].first);
        if (dist > pes[dr].high) break;
        if (dist < pes[dr].low) continue;
        int64_t q;
        if (pes[dr].stdv != 0.0) {
          double ns = ((double)dist - pes[dr].avg) / pes[dr].stdv;
          double erfc2 = std::max(
              2.0 * std::erfc(std::fabs(ns) / std::sqrt(2.0)), 5e-324);
          q = (int64_t)((double)(v[i].second >> 32) +
                        (double)(v[k].second >> 32) +
                        0.721 * std::log(erfc2) * o.a + 0.499);
          q = std::max(q, (int64_t)0);
        } else {
          q = 0;
        }
        uint64_t pair_y = ((uint64_t)k << 32) | (uint64_t)i;
        uint64_t pair_x =
            ((uint64_t)q << 32) |
            (hash_64(pair_y ^ (rid_ << 8)) & 0xFFFFFFFFull);
        u.push_back({pair_x, pair_y});
      }
    }
    y[v[i].second & 3] = i;
  }
  if (!u.empty()) {
    int64_t tmp = std::max((int64_t)o.a + o.b,
                           std::max((int64_t)o.o_del + o.e_del,
                                    (int64_t)o.o_ins + o.e_ins));
    std::sort(u.begin(), u.end());
    int64_t i = (int64_t)(u.back().second >> 32);
    int64_t k = (int64_t)(u.back().second & 0xFFFFFFFFull);
    z[v[i].second & 1] = (int64_t)((v[i].second & 0xFFFFFFFFull) >> 2);
    z[v[k].second & 1] = (int64_t)((v[k].second & 0xFFFFFFFFull) >> 2);
    *o_out = (int64_t)(u.back().first >> 32);
    *sub_out = u.size() > 1 ? (int64_t)(u[u.size() - 2].first >> 32) : 0;
    int64_t n_sub = 0;
    for (int64_t j = (int64_t)u.size() - 2; j >= 0; --j)
      if (*sub_out - (int64_t)(u[j].first >> 32) <= tmp) ++n_sub;
    *nsub_out = n_sub;
  }
}


// ------------------------------------------------------------------
// mem_sam_pe (golden: pe.py:246-374 over pair.c:253-396)
// ------------------------------------------------------------------

// A tail batch's phase times on the steady clock: each lap() charges the
// time since the previous one to a phase. The PE tail laps three times a
// pair, the SE tail twice a read; nothing inside a phase reads the clock.
enum TailPhase { T_DEDUP = 0, T_RESCUE, T_PAIR, T_SAM, T_NPHASE };

struct TailClock {
  using Clock = std::chrono::steady_clock;
  Clock::time_point last = Clock::now();
  int64_t ns[T_NPHASE] = {0, 0, 0, 0};
  void lap(TailPhase p) {
    Clock::time_point t = Clock::now();
    ns[p] += std::chrono::duration_cast<std::chrono::nanoseconds>(
                 t - last).count();
    last = t;
  }
};

struct PeRead {
  std::string name;
  int32_t l_seq;
  const uint8_t* seq;
  const char* qual;
  std::string comment;
  std::string sam;
};

// Returns the ksw_align2 calls of its mate rescue; `n_vec` gains those
// that ran striped. Laps `clk` after the rescue and after the
// paired/unpaired decision; the caller laps the SAM.
int sam_pe(const Opt& o, const PeOpt& po, const Bns& bns,
           const PeStatC pes[4], uint64_t rid_, PeRead s[2],
           std::vector<Reg> a[2], const std::string& rg_id,
           TailClock* clk, int64_t* n_vec) {
  int n = 0;
  int32_t extra_flag = 1;
  if (!(o.flag & F_NO_RESCUE)) {
    std::vector<Reg> b[2];
    for (int i = 0; i < 2; ++i)
      for (const Reg& reg : a[i])
        if (!a[i].empty() && reg.score >= a[i][0].score - po.pen_unpaired)
          b[i].push_back(reg);
    for (int i = 0; i < 2; ++i)
      for (int64_t j = 0;
           j < std::min((int64_t)b[i].size(), (int64_t)po.max_matesw); ++j)
        n += matesw(o, po, bns, pes, b[i][j], s[1 - i].l_seq,
                    s[1 - i].seq, a[1 - i], n_vec);
  }
  clk->lap(T_RESCUE);
  int64_t n_pri[2];
  n_pri[0] = mark_primary_se(o, a[0], (int64_t)((rid_ << 1) | 0));
  n_pri[1] = mark_primary_se(o, a[1], (int64_t)((rid_ << 1) | 1));
  if (o.flag & F_PRIMARY5) {
    reorder_primary5(o.T, a[0]);
    reorder_primary5(o.T, a[1]);
  }
  if (!(o.flag & F_NOPAIRING)) {
    int64_t oo = 0, subo = 0, n_sub = 0;
    int64_t z[2] = {-1, -1};
    if (n_pri[0] && n_pri[1])
      mem_pair(o, bns, pes, a, rid_, n_pri, &oo, &subo, &n_sub, z);
    if (n_pri[0] && n_pri[1] && oo > 0) {
      bool is_multi[2] = {false, false};
      for (int i = 0; i < 2; ++i)
        for (int64_t j = 1; j < n_pri[i]; ++j)
          if (a[i][j].secondary < 0 && a[i][j].score >= o.T) {
            is_multi[i] = true;
            break;
          }
      if (!is_multi[0] && !is_multi[1]) {
        clk->lap(T_PAIR);
        // ------- paired emission (golden pe.py:_sam_pe_paired) -------
        int64_t score_un = a[0][0].score + a[1][0].score - po.pen_unpaired;
        subo = std::max(subo, score_un);
        int64_t q_pe = raw_mapq(oo - subo, o.a);
        if (n_sub > 0)
          q_pe -= (int64_t)(4.343 * std::log((double)n_sub + 1) + 0.499);
        q_pe = std::min(std::max(q_pe, (int64_t)0), (int64_t)60);
        q_pe = (int64_t)(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep +
                                              a[1][0].frac_rep)) + 0.499);
        int64_t q_se[2] = {0, 0};
        if (oo > score_un) {  // paired alignment preferred
          Reg* c[2] = {&a[0][z[0]], &a[1][z[1]]};
          for (int i = 0; i < 2; ++i) {
            if (c[i]->secondary >= 0) {
              c[i]->sub = a[i][c[i]->secondary].score;
              c[i]->secondary = -2;
            }
            q_se[i] = approx_mapq_se(o, *c[i]);
          }
          q_se[0] = q_se[0] > q_pe ? q_se[0]
                                   : std::min(q_pe, q_se[0] + 40);
          q_se[1] = q_se[1] > q_pe ? q_se[1]
                                   : std::min(q_pe, q_se[1] + 40);
          extra_flag |= 2;
          q_se[0] = std::min(q_se[0],
                             raw_mapq(c[0]->score - c[0]->csub, o.a));
          q_se[1] = std::min(q_se[1],
                             raw_mapq(c[1]->score - c[1]->csub, o.a));
        } else {  // unpaired preferred
          z[0] = z[1] = 0;
          q_se[0] = approx_mapq_se(o, a[0][0]);
          q_se[1] = approx_mapq_se(o, a[1][0]);
        }
        for (int i = 0; i < 2; ++i) {
          int64_t k = a[i][z[i]].secondary_all;
          if (0 <= k && k < n_pri[i]) {  // switch secondary and primary
            for (int64_t j = 0; j < (int64_t)a[i].size(); ++j)
              if (a[i][j].secondary_all == k || j == k)
                a[i][j].secondary_all = (int32_t)z[i];
            a[i][z[i]].secondary_all = -1;
          }
        }
        std::vector<std::string> XA[2];
        bool want_xa = !(o.flag & F_ALL);
        if (want_xa)
          for (int i = 0; i < 2; ++i)
            gen_alt(o, bns, a[i], s[i].l_seq, s[i].seq, &XA[i]);
        AlnT h[2];
        std::vector<AlnT> aa[2];
        for (int i = 0; i < 2; ++i) {
          h[i] = reg2aln(o, bns, s[i].l_seq, s[i].seq, &a[i][z[i]]);
          h[i].mapq = (int32_t)q_se[i];
          h[i].flag |= (0x40 << i) | extra_flag;
          if (want_xa) h[i].XA = XA[i][z[i]];
          aa[i].push_back(h[i]);
          if (n_pri[i] < (int64_t)a[i].size()) {  // ALT hits
            const Reg& p = a[i][n_pri[i]];
            if (p.score < o.T || p.secondary >= 0 || !p.is_alt) continue;
            AlnT g = reg2aln(o, bns, s[i].l_seq, s[i].seq, &p);
            g.flag |= 0x800 | (0x40 << i) | extra_flag;
            if (want_xa) g.XA = XA[i][n_pri[i]];
            aa[i].push_back(std::move(g));
          }
        }
        for (int64_t k = 0; k < (int64_t)aa[0].size(); ++k)
          aln2sam(o, bns, s[0].name, s[0].l_seq, s[0].seq, s[0].qual,
                  s[0].comment, (int64_t)aa[0].size(), aa[0], k, rg_id,
                  &s[0].sam, &h[1]);
        for (int64_t k = 0; k < (int64_t)aa[1].size(); ++k)
          aln2sam(o, bns, s[1].name, s[1].l_seq, s[1].seq, s[1].qual,
                  s[1].comment, (int64_t)aa[1].size(), aa[1], k, rg_id,
                  &s[1].sam, &h[0]);
        return n;
      }
    }
  }
  // ------- unpaired emission (golden pe.py:_sam_pe_unpaired) -------
  clk->lap(T_PAIR);
  AlnT h[2];
  for (int i = 0; i < 2; ++i) {
    int64_t which = -1;
    if (!a[i].empty()) {
      if (a[i][0].score >= o.T) which = 0;
      else if (n_pri[i] < (int64_t)a[i].size() &&
               a[i][n_pri[i]].score >= o.T)
        which = n_pri[i];
    }
    if (which >= 0)
      h[i] = reg2aln(o, bns, s[i].l_seq, s[i].seq, &a[i][which]);
    else
      h[i] = reg2aln(o, bns, s[i].l_seq, s[i].seq, nullptr);
  }
  if (!(o.flag & F_NOPAIRING) && h[0].rid == h[1].rid && h[0].rid >= 0 &&
      !a[0].empty() && !a[1].empty()) {
    int d;
    int64_t dist;
    infer_dir(bns.l_pac, a[0][0].rb, a[1][0].rb, &d, &dist);
    if (!pes[d].failed && pes[d].low <= dist && dist <= pes[d].high)
      extra_flag |= 2;
  }
  reg2sam(o, bns, s[0].name, s[0].l_seq, s[0].seq, s[0].qual,
          s[0].comment, a[0], rg_id, &s[0].sam, 0x41 | extra_flag, &h[1]);
  reg2sam(o, bns, s[1].name, s[1].l_seq, s[1].seq, s[1].qual,
          s[1].comment, a[1], rg_id, &s[1].sam, 0x81 | extra_flag, &h[0]);
  return n;
}

// ------------------------------------------------------------------
// binding
// ------------------------------------------------------------------

bool get_buf(PyObject* obj, Py_buffer* view, const char* name) {
  if (PyObject_GetBuffer(obj, view, PyBUF_SIMPLE) != 0) {
    PyErr_Format(PyExc_TypeError, "%s: expected a contiguous buffer", name);
    return false;
  }
  return true;
}

constexpr int REG_NF = 12;  // rb re qb qe rid score truesc w seedcov
                            // seedlen0 csub is_alt

void load_regs(const int64_t* rows, const double* fr, int64_t lo,
               int64_t hi, std::vector<Reg>* out) {
  out->clear();
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t* f = rows + i * REG_NF;
    Reg r{};
    r.rb = f[0]; r.re = f[1];
    r.qb = (int32_t)f[2]; r.qe = (int32_t)f[3];
    r.rid = (int32_t)f[4]; r.score = (int32_t)f[5];
    r.truesc = (int32_t)f[6]; r.w = (int32_t)f[7];
    r.seedcov = (int32_t)f[8]; r.seedlen0 = (int32_t)f[9];
    r.csub = (int32_t)f[10]; r.is_alt = (int32_t)f[11];
    r.sub = 0; r.alt_sc = 0; r.sub_n = 0;
    r.secondary = -1; r.secondary_all = -1; r.n_comp = 0;
    r.frac_rep = fr[i];
    out->push_back(r);
  }
}

// se_tail_batch(seq_cat u8, seq_off i64[n+1], qual_cat bytes|None,
//               name_cat bytes, name_off i64[n+1],
//               comment_cat bytes, comment_off i64[n+1],
//               ids i64[n],
//               reg_rows i64[NR, 12], reg_frac f64[NR], reg_off i64[n+1],
//               pac u8, l_pac, ann_off i64[nc], ann_alt u8[nc],
//               ann_name_cat bytes, ann_name_off i64[nc+1],
//               rg_id bytes, opt_ints i64[14], opt_floats f64[5],
//               mat i8[25])
//  -> (list[bytes] SAM text per read,
//      counters i64[2] bytes: ns in dedup, ns in SAM)
PyObject* py_se_tail_batch(PyObject*, PyObject* args) {
  PyObject *seq_o, *seqoff_o, *qual_o, *name_o, *nameoff_o, *com_o,
      *comoff_o, *ids_o, *regs_o, *frac_o, *regoff_o, *pac_o, *annoff_o,
      *annalt_o, *annname_o, *annnameoff_o, *optint_o, *optflt_o, *mat_o;
  const char* rg_id_c;
  Py_ssize_t rg_len;
  long long l_pac;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOLOOOOy#OOO", &seq_o, &seqoff_o,
                        &qual_o, &name_o, &nameoff_o, &com_o, &comoff_o,
                        &ids_o, &regs_o, &frac_o, &regoff_o, &pac_o,
                        &l_pac, &annoff_o, &annalt_o, &annname_o,
                        &annnameoff_o, &rg_id_c, &rg_len, &optint_o,
                        &optflt_o, &mat_o))
    return nullptr;
  PyObject* objs[] = {seq_o,  seqoff_o,  name_o,     nameoff_o,
                      com_o,  comoff_o,  ids_o,      regs_o,
                      frac_o, regoff_o,  pac_o,      annoff_o,
                      annalt_o, annname_o, annnameoff_o, optint_o,
                      optflt_o, mat_o};
  const int NB = 18;
  Py_buffer bufs[NB];
  for (int i = 0; i < NB; ++i) {
    if (!get_buf(objs[i], &bufs[i], "arg")) {
      for (int j = 0; j < i; ++j) PyBuffer_Release(&bufs[j]);
      return nullptr;
    }
  }
  Py_buffer qualb;
  bool has_qual = qual_o != Py_None;
  if (has_qual && !get_buf(qual_o, &qualb, "qual")) {
    for (int j = 0; j < NB; ++j) PyBuffer_Release(&bufs[j]);
    return nullptr;
  }

  const uint8_t* seq_cat = (const uint8_t*)bufs[0].buf;
  const int64_t* seq_off = (const int64_t*)bufs[1].buf;
  const char* name_cat = (const char*)bufs[2].buf;
  const int64_t* name_off = (const int64_t*)bufs[3].buf;
  const char* com_cat = (const char*)bufs[4].buf;
  const int64_t* com_off = (const int64_t*)bufs[5].buf;
  const int64_t* ids = (const int64_t*)bufs[6].buf;
  const int64_t* reg_rows = (const int64_t*)bufs[7].buf;
  const double* reg_frac = (const double*)bufs[8].buf;
  const int64_t* reg_off = (const int64_t*)bufs[9].buf;
  const char* qual_cat = has_qual ? (const char*)qualb.buf : nullptr;
  const int64_t* opti = (const int64_t*)bufs[15].buf;
  const double* optf = (const double*)bufs[16].buf;

  Opt opt;
  opt.a = (int32_t)opti[0]; opt.b = (int32_t)opti[1];
  opt.o_del = (int32_t)opti[2]; opt.e_del = (int32_t)opti[3];
  opt.o_ins = (int32_t)opti[4]; opt.e_ins = (int32_t)opti[5];
  opt.w = (int32_t)opti[6]; opt.T = (int32_t)opti[7];
  opt.flag = (int32_t)opti[8]; opt.min_seed_len = (int32_t)opti[9];
  opt.max_chain_gap = (int32_t)opti[10];
  opt.max_XA_hits = (int32_t)opti[11];
  opt.max_XA_hits_alt = (int32_t)opti[12];
  opt.mapQ_coef_fac = (int32_t)opti[13];
  opt.mask_level = optf[0];
  opt.mask_level_redun = optf[1];
  opt.drop_ratio = optf[2];
  opt.XA_drop_ratio = optf[3];
  opt.mapQ_coef_len = optf[4];
  std::memcpy(opt.mat, bufs[17].buf, 25);

  Bns bns{(const uint8_t*)bufs[10].buf, (int64_t)l_pac,
          (const int64_t*)bufs[11].buf,
          (int64_t)(bufs[11].len / sizeof(int64_t)),
          (const char*)bufs[13].buf, (const int64_t*)bufs[14].buf};
  const uint8_t* ann_alt = (const uint8_t*)bufs[12].buf;
  std::string rg_id(rg_id_c, rg_id_c + rg_len);
  int64_t n = (int64_t)(bufs[6].len / sizeof(int64_t));

  std::vector<std::string> sams((size_t)n);
  int64_t counters[2];
  Py_BEGIN_ALLOW_THREADS
  TailClock clk;
  std::vector<Reg> regs;
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* seq = seq_cat + seq_off[r];
    int32_t l_seq = (int32_t)(seq_off[r + 1] - seq_off[r]);
    load_regs(reg_rows, reg_frac, reg_off[r], reg_off[r + 1], &regs);
    dedup_patch(opt, bns, seq, regs);
    for (Reg& p : regs)
      if (p.rid >= 0 && ann_alt[p.rid]) p.is_alt = 1;
    clk.lap(T_DEDUP);
    mark_primary_se(opt, regs, ids[r]);
    if (opt.flag & F_PRIMARY5) reorder_primary5(opt.T, regs);
    std::string name(name_cat + name_off[r], name_cat + name_off[r + 1]);
    std::string comment(com_cat + com_off[r], com_cat + com_off[r + 1]);
    reg2sam_se(opt, bns, name, l_seq, seq,
               has_qual ? qual_cat + seq_off[r] : nullptr, comment, regs,
               rg_id, &sams[r]);
    clk.lap(T_SAM);
  }
  counters[0] = clk.ns[T_DEDUP];
  counters[1] = clk.ns[T_SAM];
  Py_END_ALLOW_THREADS

  PyObject* out = PyList_New((Py_ssize_t)n);
  for (int64_t r = 0; r < n; ++r)
    PyList_SET_ITEM(out, (Py_ssize_t)r,
                    PyBytes_FromStringAndSize(sams[r].data(),
                                              (Py_ssize_t)sams[r].size()));
  for (int j = 0; j < NB; ++j) PyBuffer_Release(&bufs[j]);
  if (has_qual) PyBuffer_Release(&qualb);
  return Py_BuildValue(
      "(NN)", out,
      PyBytes_FromStringAndSize((const char*)counters, sizeof counters));
}

// dedup_batch: dedup/patch only (phase 1 of the PE tail; pestat must see
// dedup'd regions). Returns per-read [NR2, 13] int64 rows
// (REG_NF + n_comp... actually the 12 input fields with post-dedup
// values) + frac stays per-row.
PyObject* py_dedup_batch(PyObject*, PyObject* args) {
  PyObject *seq_o, *seqoff_o, *regs_o, *frac_o, *regoff_o, *pac_o,
      *annoff_o, *annalt_o, *optint_o, *optflt_o, *mat_o;
  long long l_pac;
  if (!PyArg_ParseTuple(args, "OOOOOOLOOOOO", &seq_o, &seqoff_o, &regs_o,
                        &frac_o, &regoff_o, &pac_o, &l_pac, &annoff_o,
                        &annalt_o, &optint_o, &optflt_o, &mat_o))
    return nullptr;
  PyObject* objs[] = {seq_o, seqoff_o, regs_o, frac_o, regoff_o,
                      pac_o, annoff_o, annalt_o, optint_o, optflt_o,
                      mat_o};
  const int NB = 11;
  Py_buffer bufs[NB];
  for (int i = 0; i < NB; ++i) {
    if (!get_buf(objs[i], &bufs[i], "arg")) {
      for (int j = 0; j < i; ++j) PyBuffer_Release(&bufs[j]);
      return nullptr;
    }
  }
  const uint8_t* seq_cat = (const uint8_t*)bufs[0].buf;
  const int64_t* seq_off = (const int64_t*)bufs[1].buf;
  const int64_t* reg_rows = (const int64_t*)bufs[2].buf;
  const double* reg_frac = (const double*)bufs[3].buf;
  const int64_t* reg_off = (const int64_t*)bufs[4].buf;
  const int64_t* opti = (const int64_t*)bufs[8].buf;
  const double* optf = (const double*)bufs[9].buf;
  Opt opt{};
  opt.a = (int32_t)opti[0]; opt.b = (int32_t)opti[1];
  opt.o_del = (int32_t)opti[2]; opt.e_del = (int32_t)opti[3];
  opt.o_ins = (int32_t)opti[4]; opt.e_ins = (int32_t)opti[5];
  opt.w = (int32_t)opti[6]; opt.T = (int32_t)opti[7];
  opt.flag = (int32_t)opti[8]; opt.min_seed_len = (int32_t)opti[9];
  opt.max_chain_gap = (int32_t)opti[10];
  opt.max_XA_hits = (int32_t)opti[11];
  opt.max_XA_hits_alt = (int32_t)opti[12];
  opt.mapQ_coef_fac = (int32_t)opti[13];
  opt.mask_level = optf[0];
  opt.mask_level_redun = optf[1];
  opt.drop_ratio = optf[2];
  opt.XA_drop_ratio = optf[3];
  opt.mapQ_coef_len = optf[4];
  std::memcpy(opt.mat, bufs[10].buf, 25);
  Bns bns{(const uint8_t*)bufs[5].buf, (int64_t)l_pac,
          (const int64_t*)bufs[6].buf,
          (int64_t)(bufs[6].len / sizeof(int64_t)), nullptr, nullptr};
  const uint8_t* ann_alt = (const uint8_t*)bufs[7].buf;
  int64_t n = (int64_t)(bufs[1].len / sizeof(int64_t)) - 1;

  std::vector<std::vector<Reg>> all((size_t)n);
  Py_BEGIN_ALLOW_THREADS
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* seq = seq_cat + seq_off[r];
    load_regs(reg_rows, reg_frac, reg_off[r], reg_off[r + 1], &all[r]);
    dedup_patch(opt, bns, seq, all[r]);
    for (Reg& p : all[r])
      if (p.rid >= 0 && ann_alt[p.rid]) p.is_alt = 1;
  }
  Py_END_ALLOW_THREADS

  // pack results: rows [NR2, 14] (the 12 fields + n_comp + sub/csub kept
  // via fields), frac f64[NR2], off i64[n+1]
  int64_t total = 0;
  for (auto& v : all) total += (int64_t)v.size();
  PyObject* rows_b = PyBytes_FromStringAndSize(
      nullptr, (Py_ssize_t)(total * REG_NF * 8));
  PyObject* frac_b = PyBytes_FromStringAndSize(nullptr,
                                               (Py_ssize_t)(total * 8));
  PyObject* off_b = PyBytes_FromStringAndSize(nullptr,
                                              (Py_ssize_t)((n + 1) * 8));
  int64_t* orows = (int64_t*)PyBytes_AS_STRING(rows_b);
  double* ofrac = (double*)PyBytes_AS_STRING(frac_b);
  int64_t* ooff = (int64_t*)PyBytes_AS_STRING(off_b);
  int64_t w = 0;
  ooff[0] = 0;
  for (int64_t r = 0; r < n; ++r) {
    for (const Reg& p : all[r]) {
      int64_t* f = orows + w * REG_NF;
      f[0] = p.rb; f[1] = p.re; f[2] = p.qb; f[3] = p.qe; f[4] = p.rid;
      f[5] = p.score; f[6] = p.truesc; f[7] = p.w; f[8] = p.seedcov;
      f[9] = p.seedlen0; f[10] = p.csub; f[11] = p.is_alt;
      ofrac[w] = p.frac_rep;
      ++w;
    }
    ooff[r + 1] = w;
  }
  for (int j = 0; j < NB; ++j) PyBuffer_Release(&bufs[j]);
  return Py_BuildValue("(NNN)", rows_b, frac_b, off_b);
}


// pe_tail_batch(seq_cat, seq_off, qual_cat|None, name_cat, name_off,
//               comment_cat, comment_off, ids i64[n],
//               reg_rows i64[NR,12], reg_frac f64[NR], reg_off i64[n+1],
//               pac, l_pac, ann_off, ann_alt, ann_name_cat, ann_name_off,
//               rg_id y#, opt_ints i64[14], opt_floats f64[5], mat i8[25],
//               pe_ints i64[3] (pen_unpaired, max_matesw, max_ins),
//               pes f64[20]|None (low, high, failed, avg, std x4))
//  -> (list[bytes] SAM per read, pes_out f64[20] bytes,
//      counters i64[7] bytes: ns in dedup (phase 1 and the insert-size
//      estimate), in mate rescue, in pairing, in SAM (the records and the
//      per-pair loads); ksw_align2 calls of the rescue, those of them
//      that ran striped; pairs)
PyObject* py_pe_tail_batch(PyObject*, PyObject* args) {
  PyObject *seq_o, *seqoff_o, *qual_o, *name_o, *nameoff_o, *com_o,
      *comoff_o, *ids_o, *regs_o, *frac_o, *regoff_o, *pac_o, *annoff_o,
      *annalt_o, *annname_o, *annnameoff_o, *optint_o, *optflt_o, *mat_o,
      *peint_o, *pes_o;
  const char* rg_id_c;
  Py_ssize_t rg_len;
  long long l_pac;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOLOOOOy#OOOOO", &seq_o,
                        &seqoff_o, &qual_o, &name_o, &nameoff_o, &com_o,
                        &comoff_o, &ids_o, &regs_o, &frac_o, &regoff_o,
                        &pac_o, &l_pac, &annoff_o, &annalt_o, &annname_o,
                        &annnameoff_o, &rg_id_c, &rg_len, &optint_o,
                        &optflt_o, &mat_o, &peint_o, &pes_o))
    return nullptr;
  PyObject* objs[] = {seq_o,  seqoff_o,  name_o,     nameoff_o,
                      com_o,  comoff_o,  ids_o,      regs_o,
                      frac_o, regoff_o,  pac_o,      annoff_o,
                      annalt_o, annname_o, annnameoff_o, optint_o,
                      optflt_o, mat_o, peint_o};
  const int NB = 19;
  Py_buffer bufs[NB];
  for (int i = 0; i < NB; ++i) {
    if (!get_buf(objs[i], &bufs[i], "arg")) {
      for (int j = 0; j < i; ++j) PyBuffer_Release(&bufs[j]);
      return nullptr;
    }
  }
  Py_buffer qualb, pesb;
  bool has_qual = qual_o != Py_None;
  if (has_qual && !get_buf(qual_o, &qualb, "qual")) {
    for (int j = 0; j < NB; ++j) PyBuffer_Release(&bufs[j]);
    return nullptr;
  }
  bool has_pes0 = pes_o != Py_None;
  if (has_pes0 && !get_buf(pes_o, &pesb, "pes")) {
    for (int j = 0; j < NB; ++j) PyBuffer_Release(&bufs[j]);
    if (has_qual) PyBuffer_Release(&qualb);
    return nullptr;
  }

  const uint8_t* seq_cat = (const uint8_t*)bufs[0].buf;
  const int64_t* seq_off = (const int64_t*)bufs[1].buf;
  const char* name_cat = (const char*)bufs[2].buf;
  const int64_t* name_off = (const int64_t*)bufs[3].buf;
  const char* com_cat = (const char*)bufs[4].buf;
  const int64_t* com_off = (const int64_t*)bufs[5].buf;
  const int64_t* ids = (const int64_t*)bufs[6].buf;
  const int64_t* reg_rows = (const int64_t*)bufs[7].buf;
  const double* reg_frac = (const double*)bufs[8].buf;
  const int64_t* reg_off = (const int64_t*)bufs[9].buf;
  const char* qual_cat = has_qual ? (const char*)qualb.buf : nullptr;
  const int64_t* opti = (const int64_t*)bufs[15].buf;
  const double* optf = (const double*)bufs[16].buf;
  const int64_t* pei = (const int64_t*)bufs[18].buf;

  Opt opt;
  opt.a = (int32_t)opti[0]; opt.b = (int32_t)opti[1];
  opt.o_del = (int32_t)opti[2]; opt.e_del = (int32_t)opti[3];
  opt.o_ins = (int32_t)opti[4]; opt.e_ins = (int32_t)opti[5];
  opt.w = (int32_t)opti[6]; opt.T = (int32_t)opti[7];
  opt.flag = (int32_t)opti[8]; opt.min_seed_len = (int32_t)opti[9];
  opt.max_chain_gap = (int32_t)opti[10];
  opt.max_XA_hits = (int32_t)opti[11];
  opt.max_XA_hits_alt = (int32_t)opti[12];
  opt.mapQ_coef_fac = (int32_t)opti[13];
  opt.mask_level = optf[0];
  opt.mask_level_redun = optf[1];
  opt.drop_ratio = optf[2];
  opt.XA_drop_ratio = optf[3];
  opt.mapQ_coef_len = optf[4];
  std::memcpy(opt.mat, bufs[17].buf, 25);
  PeOpt po;
  po.pen_unpaired = (int32_t)pei[0];
  po.max_matesw = (int32_t)pei[1];
  po.max_ins = pei[2];
  po.pen_clip5 = po.pen_clip3 = po.zdrop = 0;  // unused in the PE tail

  Bns bns{(const uint8_t*)bufs[10].buf, (int64_t)l_pac,
          (const int64_t*)bufs[11].buf,
          (int64_t)(bufs[11].len / sizeof(int64_t)),
          (const char*)bufs[13].buf, (const int64_t*)bufs[14].buf};
  const uint8_t* ann_alt = (const uint8_t*)bufs[12].buf;
  std::string rg_id(rg_id_c, rg_id_c + rg_len);
  int64_t n = (int64_t)(bufs[6].len / sizeof(int64_t));

  std::vector<std::string> sams((size_t)n);
  double pes_out[20];
  int64_t counters[7];
  Py_BEGIN_ALLOW_THREADS
  TailClock clk;
  int64_t n_matesw = 0, n_vec = 0;
  // phase 1: dedup + ALT flags for every read
  std::vector<std::vector<Reg>> all((size_t)n);
  for (int64_t r = 0; r < n; ++r) {
    load_regs(reg_rows, reg_frac, reg_off[r], reg_off[r + 1], &all[r]);
    dedup_patch(opt, bns, seq_cat + seq_off[r], all[r]);
    for (Reg& p : all[r])
      if (p.rid >= 0 && ann_alt[p.rid]) p.is_alt = 1;
  }
  // phase 2: per-batch insert-size stats (pair.c:49-112) unless -I
  PeStatC pes[4];
  if (has_pes0) {
    const double* pv = (const double*)pesb.buf;
    for (int d = 0; d < 4; ++d) {
      pes[d].low = (int64_t)pv[d * 5 + 0];
      pes[d].high = (int64_t)pv[d * 5 + 1];
      pes[d].failed = (int32_t)pv[d * 5 + 2];
      pes[d].avg = pv[d * 5 + 3];
      pes[d].stdv = pv[d * 5 + 4];
    }
  } else {
    pestat(opt, po, bns.l_pac, all, pes);
  }
  for (int d = 0; d < 4; ++d) {
    pes_out[d * 5 + 0] = (double)pes[d].low;
    pes_out[d * 5 + 1] = (double)pes[d].high;
    pes_out[d * 5 + 2] = (double)pes[d].failed;
    pes_out[d * 5 + 3] = pes[d].avg;
    pes_out[d * 5 + 4] = pes[d].stdv;
  }
  clk.lap(T_DEDUP);
  // phase 3: per-pair rescue + pairing + SAM
  for (int64_t i = 0; i < n / 2; ++i) {
    PeRead rd[2];
    std::vector<Reg> a2[2];
    for (int j = 0; j < 2; ++j) {
      int64_t r = 2 * i + j;
      rd[j].name.assign(name_cat + name_off[r], name_cat + name_off[r + 1]);
      rd[j].l_seq = (int32_t)(seq_off[r + 1] - seq_off[r]);
      rd[j].seq = seq_cat + seq_off[r];
      rd[j].qual = has_qual ? qual_cat + seq_off[r] : nullptr;
      rd[j].comment.assign(com_cat + com_off[r], com_cat + com_off[r + 1]);
      a2[j] = std::move(all[r]);
    }
    uint64_t pair_id = (uint64_t)(ids[2 * i] >> 1);
    clk.lap(T_SAM);  // the previous pair's records and this pair's loads
    n_matesw +=
        sam_pe(opt, po, bns, pes, pair_id, rd, a2, rg_id, &clk, &n_vec);
    sams[2 * i] = std::move(rd[0].sam);
    sams[2 * i + 1] = std::move(rd[1].sam);
  }
  clk.lap(T_SAM);
  for (int p = 0; p < T_NPHASE; ++p) counters[p] = clk.ns[p];
  counters[4] = n_matesw;
  counters[5] = n_vec;
  counters[6] = n / 2;
  Py_END_ALLOW_THREADS

  PyObject* out = PyList_New((Py_ssize_t)n);
  for (int64_t r = 0; r < n; ++r)
    PyList_SET_ITEM(out, (Py_ssize_t)r,
                    PyBytes_FromStringAndSize(sams[r].data(),
                                              (Py_ssize_t)sams[r].size()));
  for (int j = 0; j < NB; ++j) PyBuffer_Release(&bufs[j]);
  if (has_qual) PyBuffer_Release(&qualb);
  if (has_pes0) PyBuffer_Release(&pesb);
  return Py_BuildValue(
      "(NNN)", out,
      PyBytes_FromStringAndSize((const char*)pes_out, sizeof pes_out),
      PyBytes_FromStringAndSize((const char*)counters, sizeof counters));
}

PyMethodDef methods[] = {
    {"pe_tail_batch", py_pe_tail_batch, METH_VARARGS,
     "batched PE tail: dedup + pestat + rescue + pairing + SAM text"},
    {"se_tail_batch", py_se_tail_batch, METH_VARARGS,
     "batched SE tail: dedup + primary + mapq + cigar + SAM text"},
    {"dedup_batch", py_dedup_batch, METH_VARARGS,
     "batched region dedup/patch (PE phase 1)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_region",
                                "bwa_flow_tpu native tail stage", -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit__region(void) { return PyModule_Create(&moduledef); }
