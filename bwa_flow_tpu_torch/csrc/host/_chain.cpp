// bwa_flow_tpu native host chain stage (CPython extension).
//
// Seed chaining + chain filtering for a BATCH of reads — the hot host
// stage between device seeding and device extension. The reference runs
// this in C (mem_chain / mem_chain_flt, bwa/bwamem.c:260-394 via
// SeqsToChains, src/Pipeline.cpp:333-406); this is a C++ port of this
// repo's own golden Python specification (bwa_flow_tpu/ops/chain.py and
// utils/ksort.py) — integer-exact against it, enforced by
// tests/test_native_chain.py. Host CPUs on TPU hosts are the scarce
// resource (the device outruns Python by orders of magnitude), so this
// stage processes packed arrays with zero Python in the loop.
//
// Build: bwa_flow_tpu_torch/_build.py (c++ at first use; no external deps)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "introsort.h"

namespace {

using bwaflow::ks_introsort;

// ------------------------------------------------------------------
// chain structures (golden: ops/chain.py)
// ------------------------------------------------------------------

struct SeedC {
  int64_t rbeg;
  int32_t qbeg, len, score;
};

struct ChainC {
  int64_t pos;
  int32_t rid;
  uint8_t is_alt;
  int64_t w;
  int32_t kept;
  int32_t first;
  std::vector<SeedC> seeds;
};

struct Opt {
  int32_t min_seed_len, max_occ, max_chain_gap, w, min_chain_weight,
      max_chain_extend;
  double drop_ratio, mask_level;
};

struct Bns {
  const int64_t* offsets;  // contig start offsets (forward strand)
  int64_t n_ctg;
  const uint8_t* is_alt;
  int64_t l_pac;

  int32_t pos2rid(int64_t pos_f) const {
    // upper_bound(offsets, pos_f) - 1 (golden fmindex.pos2rid)
    const int64_t* e = offsets + n_ctg;
    return (int32_t)(std::upper_bound(offsets, e, pos_f) - offsets) - 1;
  }

  int32_t intv2rid(int64_t rb, int64_t re) const {
    // golden fmindex.intv2rid (bridging strands/contigs -> negative)
    if (rb < l_pac && l_pac < re) return -2;
    int64_t pos_b = rb >= l_pac ? (l_pac << 1) - 1 - rb : rb;
    int32_t rid_b = pos2rid(pos_b);
    int32_t rid_e = rid_b;
    if (rb < re) {
      int64_t x = re - 1;
      int64_t pos_e = x >= l_pac ? (l_pac << 1) - 1 - x : x;
      rid_e = pos2rid(pos_e);
    }
    return rid_b == rid_e ? rid_b : -1;
  }
};

// golden chain.py:58-78
bool test_and_merge(const Opt& opt, int64_t l_pac, ChainC& c, const SeedC& p,
                    int32_t seed_rid) {
  const SeedC& last = c.seeds.back();
  int64_t qend = last.qbeg + last.len;
  int64_t rend = last.rbeg + last.len;
  if (seed_rid != c.rid) return false;
  if (p.qbeg >= c.seeds[0].qbeg && p.qbeg + p.len <= qend &&
      p.rbeg >= c.seeds[0].rbeg && p.rbeg + p.len <= rend)
    return true;  // contained
  if ((last.rbeg < l_pac || c.seeds[0].rbeg < l_pac) && p.rbeg >= l_pac)
    return false;  // different strand
  int64_t x = p.qbeg - last.qbeg;  // non-negative
  int64_t y = p.rbeg - last.rbeg;
  if (y >= 0 && x - y <= opt.w && y - x <= opt.w &&
      x - last.len < opt.max_chain_gap && y - last.len < opt.max_chain_gap) {
    c.seeds.push_back(p);
    return true;
  }
  return false;
}

// golden chain.py:81-101
int64_t chain_weight(const ChainC& c) {
  int64_t w = 0, end = 0;
  for (const SeedC& s : c.seeds) {
    if (s.qbeg >= end) w += s.len;
    else if (s.qbeg + s.len > end) w += s.qbeg + s.len - end;
    end = std::max(end, (int64_t)s.qbeg + s.len);
  }
  int64_t tmp = w;
  w = 0; end = 0;
  for (const SeedC& s : c.seeds) {
    if (s.rbeg >= end) w += s.len;
    else if (s.rbeg + s.len > end) w += s.rbeg + s.len - end;
    end = std::max(end, s.rbeg + s.len);
  }
  w = std::min(w, tmp);
  return w < (1ll << 30) ? w : (1ll << 30) - 1;
}

// Exact replica of klib kbtree insert/interval/traverse for chain keys
// (bwa/kbtree.h; degree t=5 for mem_chain_t at KB_DEFAULT_SIZE). bwa's
// chains depend on kbtree implementation accidents: with duplicate
// chain positions (tandem repeats), WHICH duplicate kb_intervalp
// returns — and so which chain a seed merges into — follows from the
// B-tree node/split history; a sorted-array bisect picks a different
// duplicate and yields different chains (measured 43 diverging reads
// per 200k-read soak before this replica). Keys are (pos, chain index).
struct KBTree {
  static constexpr int T = 5;
  struct Node {
    std::vector<std::pair<int64_t, int32_t>> keys;
    std::vector<Node*> kids;  // empty => leaf
  };
  Node* root;
  KBTree() : root(new Node()) {}
  ~KBTree() { free_rec(root); }
  static void free_rec(Node* x) {
    for (Node* c : x->kids) free_rec(c);
    delete x;
  }
  // __kb_getp_aux: lower_bound then step left on r<0; exact match lands
  // on the FIRST equal key in the node with r=0
  static int get_aux(const Node* x, int64_t pos, int* r) {
    int n = (int)x->keys.size();
    if (n == 0) { *r = 1; return -1; }
    int begin = 0, end = n;
    while (begin < end) {
      int mid = (begin + end) >> 1;
      if (x->keys[mid].first < pos) begin = mid + 1;
      else end = mid;
    }
    if (begin == n) { *r = 1; return n - 1; }
    int64_t kp = x->keys[begin].first;
    *r = (pos > kp) - (pos < kp);
    if (*r < 0) --begin;
    return begin;
  }
  int32_t interval_lower(int64_t pos) const {  // chain idx or -1
    int32_t lower = -1;
    const Node* x = root;
    while (x) {
      int r;
      int i = get_aux(x, pos, &r);
      if (i >= 0 && r == 0) return x->keys[i].second;
      if (i >= 0) lower = x->keys[i].second;
      if (x->kids.empty()) break;
      x = x->kids[i + 1];
    }
    return lower;
  }
  void split(Node* x, int i, Node* y) {
    Node* z = new Node();
    z->keys.assign(y->keys.begin() + T, y->keys.end());
    if (!y->kids.empty()) {
      z->kids.assign(y->kids.begin() + T, y->kids.end());
      y->kids.resize(T);
    }
    auto mid = y->keys[T - 1];
    y->keys.resize(T - 1);
    x->kids.insert(x->kids.begin() + i + 1, z);
    x->keys.insert(x->keys.begin() + i, mid);
  }
  void put(int64_t pos, int32_t idx) {
    Node* r = root;
    if ((int)r->keys.size() == 2 * T - 1) {
      Node* s = new Node();
      s->kids.push_back(r);
      split(s, 0, r);
      root = s;
      r = s;
    }
    Node* x = r;
    while (true) {
      int rr;
      if (x->kids.empty()) {
        int i = get_aux(x, pos, &rr);
        x->keys.insert(x->keys.begin() + i + 1, {pos, idx});
        return;
      }
      int i = get_aux(x, pos, &rr) + 1;
      if ((int)x->kids[i]->keys.size() == 2 * T - 1) {
        split(x, i, x->kids[i]);
        if (pos > x->keys[i].first) ++i;
      }
      x = x->kids[i];
    }
  }
  static void trav_rec(const Node* x, std::vector<int32_t>* out) {
    if (x->kids.empty()) {
      for (auto& k : x->keys) out->push_back(k.second);
      return;
    }
    for (size_t j = 0; j < x->keys.size(); ++j) {
      trav_rec(x->kids[j], out);
      out->push_back(x->keys[j].second);
    }
    trav_rec(x->kids[x->keys.size()], out);
  }
  void traverse(std::vector<int32_t>* out) const { trav_rec(root, out); }
};

// golden chain.py:104-159 for ONE read; sa points at the pre-resolved
// occurrence values in enumeration order (interval -> k by step).
void mem_chain_one(const Opt& opt, const Bns& bns, int32_t l_query,
                   int64_t n_iv, const int64_t* iv_x0, const int64_t* iv_s,
                   const int32_t* iv_start, const int32_t* iv_end,
                   const int64_t* sa, double* frac_rep,
                   std::vector<ChainC>& chains) {
  chains.clear();
  if (l_query < opt.min_seed_len) { *frac_rep = 0.0; return; }
  // frac_rep from over-occurring intervals
  int64_t b = 0, e = 0, l_rep = 0;
  for (int64_t ii = 0; ii < n_iv; ++ii) {
    if (iv_s[ii] <= opt.max_occ) continue;
    int64_t sb = iv_start[ii], se = iv_end[ii];
    if (sb > e) { l_rep += e - b; b = sb; e = se; }
    else e = std::max(e, se);
  }
  l_rep += e - b;
  *frac_rep = (double)l_rep / l_query;

  KBTree tree;
  int64_t sai = 0;
  for (int64_t ii = 0; ii < n_iv; ++ii) {
    int32_t slen = iv_end[ii] - iv_start[ii];
    int64_t step = iv_s[ii] > opt.max_occ ? iv_s[ii] / opt.max_occ : 1;
    int64_t k = 0, count = 0;
    while (k < iv_s[ii] && count < opt.max_occ) {
      int64_t rbeg = sa[sai++];
      SeedC s{rbeg, iv_start[ii], slen, slen};
      int32_t rid = bns.intv2rid(rbeg, rbeg + slen);
      k += step;
      ++count;
      if (rid < 0) continue;
      bool to_add = false;
      if (!chains.empty()) {
        int32_t lower = tree.interval_lower(rbeg);
        if (lower < 0 ||
            !test_and_merge(opt, bns.l_pac, chains[lower], s, rid))
          to_add = true;
      } else {
        to_add = true;
      }
      if (to_add) {
        ChainC c;
        c.pos = rbeg;
        c.rid = rid;
        c.is_alt = bns.is_alt[rid] ? 1 : 0;
        c.w = 0; c.kept = 0; c.first = -1;
        c.seeds.push_back(s);
        chains.push_back(std::move(c));
        tree.put(rbeg, (int32_t)(chains.size() - 1));
      }
    }
  }
  // emit in kbtree in-order traversal order (__kb_traverse), which the
  // downstream filter's tie-sensitive introsort depends on
  std::vector<int32_t> order;
  order.reserve(chains.size());
  tree.traverse(&order);
  std::vector<ChainC> sorted_chains;
  sorted_chains.reserve(chains.size());
  for (int32_t idx : order) sorted_chains.push_back(std::move(chains[idx]));
  chains.swap(sorted_chains);
}

// golden chain.py:162-223 (in place; output = kept chains in sort order)
void mem_chain_flt(const Opt& opt, std::vector<ChainC>& chains) {
  if (chains.empty()) return;
  std::vector<ChainC> a;
  a.reserve(chains.size());
  for (ChainC& c : chains) {
    c.first = -1;
    c.kept = 0;
    c.w = chain_weight(c);
    if (c.w >= opt.min_chain_weight) a.push_back(std::move(c));
  }
  chains.clear();
  if (a.empty()) return;
  ks_introsort(a, [](const ChainC& x, const ChainC& y) {
    return x.w > y.w;  // flt_lt
  });
  auto chn_beg = [](const ChainC& c) { return (int64_t)c.seeds[0].qbeg; };
  auto chn_end = [](const ChainC& c) {
    return (int64_t)c.seeds.back().qbeg + c.seeds.back().len;
  };
  std::vector<int64_t> kept_idx{0};
  a[0].kept = 3;
  for (int64_t i = 1; i < (int64_t)a.size(); ++i) {
    bool large_ovlp = false, broke = false;
    for (int64_t j : kept_idx) {
      int64_t b_max = std::max(chn_beg(a[j]), chn_beg(a[i]));
      int64_t e_min = std::min(chn_end(a[j]), chn_end(a[i]));
      if (e_min > b_max && (!a[j].is_alt || a[i].is_alt)) {
        int64_t li = chn_end(a[i]) - chn_beg(a[i]);
        int64_t lj = chn_end(a[j]) - chn_beg(a[j]);
        int64_t min_l = std::min(li, lj);
        if (e_min - b_max >= min_l * opt.mask_level &&
            min_l < opt.max_chain_gap) {
          large_ovlp = true;
          if (a[j].first < 0) a[j].first = (int32_t)i;
          if (a[i].w < a[j].w * opt.drop_ratio &&
              a[j].w - a[i].w >= (int64_t)opt.min_seed_len << 1) {
            broke = true;
            break;
          }
        }
      }
    }
    if (!broke) {
      kept_idx.push_back(i);
      a[i].kept = large_ovlp ? 2 : 3;
    }
  }
  for (int64_t j : kept_idx)
    if (a[j].first >= 0) a[a[j].first].kept = 1;
  // cap kept=1/2 chains (golden chain.py:209-222)
  int64_t kcnt = 0, cut = (int64_t)a.size();
  for (int64_t i = 0; i < (int64_t)a.size(); ++i) {
    if (a[i].kept == 0 || a[i].kept == 3) continue;
    if (++kcnt >= opt.max_chain_extend) { cut = i; break; }
  }
  for (int64_t i = cut; i < (int64_t)a.size(); ++i)
    if (a[i].kept < 3) a[i].kept = 0;
  for (ChainC& c : a)
    if (c.kept != 0) chains.push_back(std::move(c));
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

// chain_batch(l_query int32[n], iv_off int64[n+1], iv_x0 int64[NI],
//             iv_s int64[NI], iv_start int32[NI], iv_end int32[NI],
//             sa_off int64[n+1], sa_vals int64[NO],
//             ann_off int64[nc], ann_alt uint8[nc], l_pac,
//             min_seed_len, max_occ, max_chain_gap, w,
//             min_chain_weight, max_chain_extend,
//             drop_ratio, mask_level)
//  -> list over reads: None (needs Python fallback: long-read seed-SW
//     filter applies) or (frac_rep,
//     [(rid, [(rbeg, qbeg, len, score), ...]), ...])
PyObject* py_chain_batch(PyObject*, PyObject* args) {
  PyObject *lq_o, *ivo_o, *x0_o, *s_o, *st_o, *en_o, *sao_o, *sav_o,
      *ao_o, *aa_o;
  long long l_pac;
  Opt opt;
  if (!PyArg_ParseTuple(
          args, "OOOOOOOOOOLiiiiiidd", &lq_o, &ivo_o, &x0_o, &s_o, &st_o,
          &en_o, &sao_o, &sav_o, &ao_o, &aa_o, &l_pac, &opt.min_seed_len,
          &opt.max_occ, &opt.max_chain_gap, &opt.w, &opt.min_chain_weight,
          &opt.max_chain_extend, &opt.drop_ratio, &opt.mask_level))
    return nullptr;
  Py_buffer bufs[10];
  PyObject* objs[10] = {lq_o, ivo_o, x0_o, s_o, st_o,
                        en_o, sao_o, sav_o, ao_o, aa_o};
  const char* names[10] = {"l_query", "iv_off", "iv_x0", "iv_s",
                           "iv_start", "iv_end", "sa_off", "sa_vals",
                           "ann_off", "ann_alt"};
  for (int i = 0; i < 10; ++i) {
    if (!get_buf(objs[i], &bufs[i], names[i])) {
      for (int j = 0; j < i; ++j) PyBuffer_Release(&bufs[j]);
      return nullptr;
    }
  }
  const int32_t* l_query = (const int32_t*)bufs[0].buf;
  const int64_t* iv_off = (const int64_t*)bufs[1].buf;
  const int64_t* iv_x0 = (const int64_t*)bufs[2].buf;
  const int64_t* iv_s = (const int64_t*)bufs[3].buf;
  const int32_t* iv_start = (const int32_t*)bufs[4].buf;
  const int32_t* iv_end = (const int32_t*)bufs[5].buf;
  const int64_t* sa_off = (const int64_t*)bufs[6].buf;
  const int64_t* sa_vals = (const int64_t*)bufs[7].buf;
  Bns bns{(const int64_t*)bufs[8].buf,
          (int64_t)(bufs[8].len / sizeof(int64_t)),
          (const uint8_t*)bufs[9].buf, (int64_t)l_pac};
  int64_t n = (int64_t)(bufs[0].len / sizeof(int32_t));
  (void)iv_x0;

  PyObject* out = PyList_New((Py_ssize_t)n);
  std::vector<ChainC> chains;
  for (int64_t r = 0; r < n; ++r) {
    int32_t lq = l_query[r];
    // long-read seed filter applies? -> Python fallback (rare)
    double min_l = opt.min_chain_weight
                       ? 1.1 * opt.min_chain_weight
                       : 5.5 * std::log((double)lq);
    if (lq >= opt.min_seed_len && !(min_l > 0.05 * lq)) {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(out, (Py_ssize_t)r, Py_None);
      continue;
    }
    double frac_rep = 0.0;
    mem_chain_one(opt, bns, lq, iv_off[r + 1] - iv_off[r],
                  iv_x0 + iv_off[r], iv_s + iv_off[r], iv_start + iv_off[r],
                  iv_end + iv_off[r], sa_vals + sa_off[r], &frac_rep,
                  chains);
    mem_chain_flt(opt, chains);
    PyObject* clist = PyList_New((Py_ssize_t)chains.size());
    for (Py_ssize_t ci = 0; ci < (Py_ssize_t)chains.size(); ++ci) {
      const ChainC& c = chains[ci];
      PyObject* seeds = PyList_New((Py_ssize_t)c.seeds.size());
      for (Py_ssize_t si = 0; si < (Py_ssize_t)c.seeds.size(); ++si) {
        const SeedC& s = c.seeds[si];
        PyList_SET_ITEM(seeds, si,
                        Py_BuildValue("(Liii)", (long long)s.rbeg,
                                      (int)s.qbeg, (int)s.len,
                                      (int)s.score));
      }
      PyList_SET_ITEM(clist, ci,
                      Py_BuildValue("(iN)", (int)c.rid, seeds));
    }
    PyList_SET_ITEM(out, (Py_ssize_t)r,
                    Py_BuildValue("(dN)", frac_rep, clist));
  }
  for (int i = 0; i < 10; ++i) PyBuffer_Release(&bufs[i]);
  return out;
}

// chain_batch_packed(... same args ...) -> (needs_py bytes[n],
//   chain_off i64[n+1], chain_rid i32[NC], chain_frac f64[NC],
//   seed_off i64[NC+1], seeds i64[NS*4])
// Flat-array output feeding the native wave driver with zero Python
// object churn; reads needing the Python fallback have zero chains here
// and needs_py[r] = 1.
PyObject* py_chain_batch_packed(PyObject*, PyObject* args) {
  PyObject *lq_o, *ivo_o, *x0_o, *s_o, *st_o, *en_o, *sao_o, *sav_o,
      *ao_o, *aa_o;
  long long l_pac;
  Opt opt;
  if (!PyArg_ParseTuple(
          args, "OOOOOOOOOOLiiiiiidd", &lq_o, &ivo_o, &x0_o, &s_o, &st_o,
          &en_o, &sao_o, &sav_o, &ao_o, &aa_o, &l_pac, &opt.min_seed_len,
          &opt.max_occ, &opt.max_chain_gap, &opt.w, &opt.min_chain_weight,
          &opt.max_chain_extend, &opt.drop_ratio, &opt.mask_level))
    return nullptr;
  Py_buffer bufs[10];
  PyObject* objs[10] = {lq_o, ivo_o, x0_o, s_o, st_o,
                        en_o, sao_o, sav_o, ao_o, aa_o};
  for (int i = 0; i < 10; ++i) {
    if (!get_buf(objs[i], &bufs[i], "arg")) {
      for (int j = 0; j < i; ++j) PyBuffer_Release(&bufs[j]);
      return nullptr;
    }
  }
  const int32_t* l_query = (const int32_t*)bufs[0].buf;
  const int64_t* iv_off = (const int64_t*)bufs[1].buf;
  const int64_t* iv_x0 = (const int64_t*)bufs[2].buf;
  const int64_t* iv_s = (const int64_t*)bufs[3].buf;
  const int32_t* iv_start = (const int32_t*)bufs[4].buf;
  const int32_t* iv_end = (const int32_t*)bufs[5].buf;
  const int64_t* sa_off = (const int64_t*)bufs[6].buf;
  const int64_t* sa_vals = (const int64_t*)bufs[7].buf;
  Bns bns{(const int64_t*)bufs[8].buf,
          (int64_t)(bufs[8].len / sizeof(int64_t)),
          (const uint8_t*)bufs[9].buf, (int64_t)l_pac};
  int64_t n = (int64_t)(bufs[0].len / sizeof(int32_t));
  (void)iv_x0;

  std::vector<uint8_t> needs_py((size_t)n, 0);
  std::vector<int64_t> chain_off{0};
  std::vector<int32_t> chain_rid;
  std::vector<double> chain_frac;
  std::vector<int64_t> seed_off{0};
  std::vector<int64_t> seeds_flat;
  {
    std::vector<ChainC> chains;
    for (int64_t r = 0; r < n; ++r) {
      int32_t lq = l_query[r];
      double min_l = opt.min_chain_weight
                         ? 1.1 * opt.min_chain_weight
                         : 5.5 * std::log((double)lq);
      if (lq >= opt.min_seed_len && !(min_l > 0.05 * lq)) {
        needs_py[r] = 1;
        chain_off.push_back((int64_t)chain_rid.size());
        continue;
      }
      double frac_rep = 0.0;
      mem_chain_one(opt, bns, lq, iv_off[r + 1] - iv_off[r],
                    iv_x0 + iv_off[r], iv_s + iv_off[r],
                    iv_start + iv_off[r], iv_end + iv_off[r],
                    sa_vals + sa_off[r], &frac_rep, chains);
      mem_chain_flt(opt, chains);
      for (const ChainC& c : chains) {
        chain_rid.push_back(c.rid);
        chain_frac.push_back(frac_rep);
        for (const SeedC& sd : c.seeds) {
          seeds_flat.push_back(sd.rbeg);
          seeds_flat.push_back(sd.qbeg);
          seeds_flat.push_back(sd.len);
          seeds_flat.push_back(sd.score);
        }
        seed_off.push_back((int64_t)(seeds_flat.size() / 4));
      }
      chain_off.push_back((int64_t)chain_rid.size());
    }
  }
  for (int i = 0; i < 10; ++i) PyBuffer_Release(&bufs[i]);
  auto mk_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize((const char*)p, (Py_ssize_t)nbytes);
  };
  return Py_BuildValue(
      "(NNNNNN)",
      mk_bytes(needs_py.data(), needs_py.size()),
      mk_bytes(chain_off.data(), chain_off.size() * 8),
      mk_bytes(chain_rid.data(), chain_rid.size() * 4),
      mk_bytes(chain_frac.data(), chain_frac.size() * 8),
      mk_bytes(seed_off.data(), seed_off.size() * 8),
      mk_bytes(seeds_flat.data(), seeds_flat.size() * 8));
}

PyMethodDef methods[] = {
    {"chain_batch", py_chain_batch, METH_VARARGS,
     "batched seed chaining + chain filtering (exact golden semantics)"},
    {"chain_batch_packed", py_chain_batch_packed, METH_VARARGS,
     "chain_batch with flat-array output (feeds the native wave driver)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_chain",
                                "bwa_flow_tpu native chain stage", -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit__chain(void) { return PyModule_Create(&moduledef); }
