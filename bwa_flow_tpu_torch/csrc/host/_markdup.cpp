// bwa_flow_tpu native duplicate marking (CPython extension).
//
// samblaster-equivalent streaming markdup — C++ port of the golden
// Python specification (the JAX package's bwa_flow_tpu/dedup/markdup.py,
// itself a reimplementation of the reference's samblaster port,
// src/samblaster.cpp:425-568). Two scalability fixes over the Python
// stage:
//   - signatures live in per-(bin-pair) open-addressing uint64 sets
//     (~11 B/signature at 0.7 load) instead of a Python tuple set
//     (~200 B/pair — hundreds of GB at WGS scale);
//   - primary-line fields parse straight from the SAM text in C with
//     no regex, and FLAG 1024 rewriting happens in the same pass.
//
// Every C++ exception is caught before it leaves the module: process's
// released-GIL region through run_nogil (nogil.h), the rest with the GIL
// held; std::bad_alloc raises MemoryError, anything else RuntimeError.
//
// Build: bwa_flow_tpu_torch/_build.py (c++ at first use; no external
// deps)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "nogil.h"

namespace {

using bwaflow::NoGilError;
using bwaflow::run_nogil;

constexpr int BIN_SHIFT = 27;
constexpr int64_t BIN_MASK = (1ll << BIN_SHIFT) - 1;
constexpr int MAX_SEQUENCE_LENGTH = 250;  // samblaster.h:49

constexpr int F_PAIRED = 0x1;
constexpr int F_UNMAPPED = 0x4;
constexpr int F_NEXT_UNMAPPED = 0x8;
constexpr int F_REVERSE = 0x10;
constexpr int F_FIRST = 0x40;
constexpr int F_SECOND = 0x80;
constexpr int F_SECONDARY = 0x100;
constexpr int F_DUP = 0x400;
constexpr int F_SUPPLEMENTARY = 0x800;

// open-addressing uint64 set (linear probing, 0 = empty sentinel;
// the value 0 itself is tracked separately)
struct U64Set {
  std::vector<uint64_t> slots;
  size_t n = 0;
  bool has_zero = false;

  U64Set() : slots(16, 0) {}

  void grow() {
    std::vector<uint64_t> old;
    old.swap(slots);
    slots.assign(old.size() * 2, 0);
    size_t saved_n = n;
    n = 0;
    for (uint64_t v : old)
      if (v) insert_nogrow(v);
    n = saved_n;
  }

  void insert_nogrow(uint64_t v) {
    size_t mask = slots.size() - 1;
    size_t i = (size_t)(v * 0x9E3779B97F4A7C15ull) & mask;
    while (slots[i]) {
      if (slots[i] == v) return;
      i = (i + 1) & mask;
    }
    slots[i] = v;
  }

  // returns true if v was already present
  bool check_insert(uint64_t v) {
    if (v == 0) {
      if (has_zero) return true;
      has_zero = true;
      return false;
    }
    size_t mask = slots.size() - 1;
    size_t i = (size_t)(v * 0x9E3779B97F4A7C15ull) & mask;
    while (slots[i]) {
      if (slots[i] == v) return true;
      i = (i + 1) & mask;
    }
    slots[i] = v;
    if (++n * 10 >= slots.size() * 7) grow();
    return false;
  }

  bool contains(uint64_t v) const {
    if (v == 0) return has_zero;
    size_t mask = slots.size() - 1;
    size_t i = (size_t)(v * 0x9E3779B97F4A7C15ull) & mask;
    while (slots[i]) {
      if (slots[i] == v) return true;
      i = (i + 1) & mask;
    }
    return false;
  }
};

struct State {
  std::unordered_map<std::string, int32_t> seqs;   // name -> index
  std::vector<int64_t> seq_offs;                   // index -> offset
  // signature store keyed by (s1, s2) strand-bin pair
  std::unordered_map<uint64_t, U64Set> bins;
  bool ignore_unmated = false;
  int64_t dup_count = 0;
  int64_t unmated_count = 0;
  int64_t strict_errors = 0;  // ungrouped input in strict mode
};

struct Line {
  int32_t flag = 0;
  int32_t seq_num = 0;
  int64_t rapos = 0;
  int64_t pos = 0;
  int64_t bin_num = 0;
  int64_t bin_pos = 0;
  const char* cigar = nullptr;
  size_t cigar_len = 0;
  bool valid = false;

  bool is_rev() const { return (flag & F_REVERSE) != 0; }
};

// calcOffsets (bwa_flow_tpu/dedup/markdup.py:60-84)
void calc_offsets(Line& l) {
  int64_t ra_len = 0, sclip = 0, eclip = 0;
  bool first = true;
  const char* p = l.cigar;
  const char* e = l.cigar + l.cigar_len;
  while (p < e) {
    int64_t ln = 0;
    while (p < e && *p >= '0' && *p <= '9') ln = ln * 10 + (*p++ - '0');
    if (p >= e) break;
    char op = *p++;
    if (op == 'M' || op == '=' || op == 'X') {
      ra_len += ln;
      first = false;
    } else if (op == 'S' || op == 'H') {
      if (first) sclip += ln;
      else eclip += ln;
    } else if (op == 'D' || op == 'N') {
      ra_len += ln;
    }
  }
  int64_t pos;
  if (!(l.flag & F_REVERSE)) pos = l.rapos - sclip;
  else pos = l.rapos + ra_len + eclip - 1;
  l.pos = pos + MAX_SEQUENCE_LENGTH;
}

bool needs_swap(const Line& a, const Line& b) {
  if (a.pos != b.pos) return a.pos > b.pos;
  if (a.seq_num != b.seq_num) return a.seq_num > b.seq_num;
  if (a.is_rev() == b.is_rev()) return false;
  return a.is_rev() && !b.is_rev();
}

// markDupsDiscordants over one QNAME block (bwa_flow_tpu/dedup/markdup.py:122-190)
bool mark_block(State& S, std::vector<Line>& lines) {
  Line *first = nullptr, *second = nullptr;
  for (Line& l : lines) {
    if (l.flag & (F_SECONDARY | F_SUPPLEMENTARY)) continue;
    if (!(l.flag & F_PAIRED)) second = &l;
    else if (l.flag & F_FIRST) first = &l;
    else if (l.flag & F_SECOND) second = &l;
  }
  bool orphan = false;
  Line dummy;
  if (!first && !second) {
    if (S.ignore_unmated) {
      ++S.unmated_count;
      return false;
    }
    ++S.strict_errors;  // the wrapper raises (golden: ValueError)
    return false;
  }
  if (!first || !second) {
    if (!second) std::swap(first, second);
    if ((second->flag & F_PAIRED) &&
        ((second->flag & F_UNMAPPED) ||
         !(second->flag & F_NEXT_UNMAPPED))) {
      if (S.ignore_unmated) {
        ++S.unmated_count;
        return false;
      }
      ++S.strict_errors;
      return false;
    }
    if (second->flag & F_UNMAPPED) return false;
    dummy.flag = (second->flag & F_FIRST) ? 0x85 : 0x45;
    dummy.seq_num = 0;
    first = &dummy;
    orphan = true;
  } else {
    if ((first->flag & F_UNMAPPED) && (second->flag & F_UNMAPPED))
      return false;
    orphan = ((first->flag | second->flag) & F_UNMAPPED) != 0;
    if (!(first->flag & F_UNMAPPED) && (second->flag & F_UNMAPPED))
      std::swap(first, second);
  }

  calc_offsets(*second);
  int64_t seq_off = S.seq_offs[second->seq_num];
  second->bin_num = (seq_off + second->pos) >> BIN_SHIFT;
  second->bin_pos = (seq_off + second->pos) & BIN_MASK;
  if (orphan) {
    first->pos = first->bin_num = first->bin_pos = 0;
    first->seq_num = 0;
  } else {
    calc_offsets(*first);
    seq_off = S.seq_offs[first->seq_num];
    first->bin_num = (seq_off + first->pos) >> BIN_SHIFT;
    first->bin_pos = (seq_off + first->pos) & BIN_MASK;
  }
  if (!orphan && needs_swap(*first, *second)) std::swap(first, second);

  uint64_t sig = ((uint64_t)(first->bin_pos & 0xFFFFFFFF) << 32) |
                 (uint64_t)(second->bin_pos & 0xFFFFFFFF);
  uint64_t s1 = (uint64_t)(first->bin_num * 2 + (first->is_rev() ? 1 : 0));
  uint64_t s2 = (uint64_t)(second->bin_num * 2 +
                           (second->is_rev() ? 1 : 0));
  uint64_t key = (s1 << 32) | s2;
  if (S.bins[key].check_insert(sig)) {
    ++S.dup_count;
    return true;
  }
  return false;
}

// ------------------------------------------------------------------
// SAM text processing
// ------------------------------------------------------------------

// parse the primary line of one read's SAM text into Line (flag, rname
// resolved to seq_num, rapos, cigar span)
Line primary_line(const State& S, const char* sam, size_t len) {
  Line out;
  const char* p = sam;
  const char* end = sam + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    // fields: QNAME FLAG RNAME POS MAPQ CIGAR ...
    const char* f[7];
    int nf = 0;
    f[nf++] = p;
    for (const char* q = p; q < nl && nf < 7; ++q)
      if (*q == '\t') f[nf++] = q + 1;
    if (nf >= 7) {
      int32_t flag = (int32_t)strtol(f[1], nullptr, 10);
      if (!(flag & (F_SECONDARY | F_SUPPLEMENTARY))) {
        out.flag = flag;
        std::string rname(f[2], (const char*)memchr(f[2], '\t',
                                                    nl - f[2]) - f[2]);
        auto it = S.seqs.find(rname);
        out.seq_num = it == S.seqs.end() ? 0 : it->second;
        out.rapos = strtoll(f[3], nullptr, 10);
        const char* ce = (const char*)memchr(f[5], '\t', nl - f[5]);
        out.cigar = f[5];
        out.cigar_len = (ce ? ce : nl) - f[5];
        out.valid = true;
        return out;
      }
    }
    p = nl + 1;
  }
  return out;
}

// rewrite FLAG |= 1024 on every line of a read's SAM text
void set_dup(const char* sam, size_t len, std::string* out) {
  const char* p = sam;
  const char* end = sam + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    const char* t1 = (const char*)memchr(p, '\t', nl - p);
    if (t1) {
      const char* t2 = (const char*)memchr(t1 + 1, '\t', nl - t1 - 1);
      if (t2) {
        long flag = strtol(t1 + 1, nullptr, 10) | F_DUP;
        out->append(p, t1 + 1 - p);
        *out += std::to_string(flag);
        out->append(t2, nl - t2);
      } else {
        out->append(p, nl - p);
      }
    } else {
      out->append(p, nl - p);
    }
    if (nl < end) *out += '\n';
    p = nl + 1;
  }
}

// ------------------------------------------------------------------
// bindings
// ------------------------------------------------------------------

void state_destroy(PyObject* cap) {
  delete (State*)PyCapsule_GetPointer(cap, "bwa_markdup_state");
}

bool get_buf(PyObject* obj, Py_buffer* view, const char* name) {
  if (PyObject_GetBuffer(obj, view, PyBUF_SIMPLE) != 0) {
    PyErr_Format(PyExc_TypeError, "%s: expected a contiguous buffer", name);
    return false;
  }
  return true;
}

// create(name_cat bytes, name_off i64[nc+1], lens i64[nc], ignore_unmated)
PyObject* py_create(PyObject*, PyObject* args) {
  PyObject *names_o, *noff_o, *lens_o;
  int ignore_unmated;
  if (!PyArg_ParseTuple(args, "OOOp", &names_o, &noff_o, &lens_o,
                        &ignore_unmated))
    return nullptr;
  Py_buffer nb, ob, lb;
  if (!get_buf(names_o, &nb, "names")) return nullptr;
  if (!get_buf(noff_o, &ob, "name_off")) { PyBuffer_Release(&nb);
    return nullptr; }
  if (!get_buf(lens_o, &lb, "lens")) {
    PyBuffer_Release(&nb); PyBuffer_Release(&ob); return nullptr; }
  const char* cat = (const char*)nb.buf;
  const int64_t* off = (const int64_t*)ob.buf;
  const int64_t* lens = (const int64_t*)lb.buf;
  int64_t nc = (int64_t)(lb.len / 8);
  bool ok = ob.len / 8 == nc + 1 && off[0] == 0;
  for (int64_t i = 0; ok && i < nc; ++i)
    ok = off[i] <= off[i + 1] && off[i + 1] <= (int64_t)nb.len;
  State* S = nullptr;
  NoGilError err;
  if (ok) {
    run_nogil(&err, [&]() {
      S = new State();
      S->ignore_unmated = ignore_unmated != 0;
      // falcon's table: "*" -> 0 then contig i -> i (the reference's
      // markdup stage, lines 54-71)
      S->seqs["*"] = 0;
      S->seq_offs.resize(nc + 1);
      S->seq_offs[0] = 0;
      int64_t total = 0;
      for (int64_t i = 0; i < nc; ++i) {
        S->seqs[std::string(cat + off[i], cat + off[i + 1])] = (int32_t)i;
        S->seq_offs[i] = total;
        total += lens[i] + 1;
      }
    });
  }
  PyBuffer_Release(&nb);
  PyBuffer_Release(&ob);
  PyBuffer_Release(&lb);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError,
                    "create: name_off must be nc + 1 offsets into names");
    return nullptr;
  }
  if (err) {
    delete S;
    return err.raise(PyExc_RuntimeError);
  }
  PyObject* cap = PyCapsule_New(S, "bwa_markdup_state", state_destroy);
  if (!cap) delete S;
  return cap;
}

// process(state, sam_cat bytes, sam_off i64[n+1], block_off i64[nb+1])
//  -> (new_sam_cat bytes, new_sam_off bytes i64[n+1])
// blocks are [block_off[k], block_off[k+1]) read index ranges sharing a
// QNAME; duplicates get FLAG|1024 rewritten into the returned text.
PyObject* py_process(PyObject*, PyObject* args) {
  PyObject *st_o, *sam_o, *soff_o, *boff_o;
  if (!PyArg_ParseTuple(args, "OOOO", &st_o, &sam_o, &soff_o, &boff_o))
    return nullptr;
  State* S = (State*)PyCapsule_GetPointer(st_o, "bwa_markdup_state");
  if (!S) return nullptr;
  Py_buffer sb, ob, bb;
  if (!get_buf(sam_o, &sb, "sam")) return nullptr;
  if (!get_buf(soff_o, &ob, "sam_off")) { PyBuffer_Release(&sb);
    return nullptr; }
  if (!get_buf(boff_o, &bb, "block_off")) {
    PyBuffer_Release(&sb); PyBuffer_Release(&ob); return nullptr; }
  const char* sam = (const char*)sb.buf;
  const int64_t* soff = (const int64_t*)ob.buf;
  const int64_t* boff = (const int64_t*)bb.buf;
  int64_t n = (int64_t)(ob.len / 8) - 1;
  int64_t nb = (int64_t)(bb.len / 8) - 1;
  // reads [soff[r], soff[r+1]) tile the text; blocks tile the reads
  bool ok = n >= 0 && nb >= 0 && soff[0] == 0 && soff[n] <= (int64_t)sb.len
      && boff[0] == 0 && boff[nb] == n;
  for (int64_t r = 0; ok && r < n; ++r) ok = soff[r] <= soff[r + 1];
  for (int64_t b = 0; ok && b < nb; ++b) ok = boff[b] <= boff[b + 1];
  if (!ok) {
    PyBuffer_Release(&sb);
    PyBuffer_Release(&ob);
    PyBuffer_Release(&bb);
    PyErr_SetString(PyExc_ValueError,
                    "process: sam_off or block_off out of order or range");
    return nullptr;
  }

  std::string out_cat;
  std::vector<int64_t> out_off;
  NoGilError err;
  Py_BEGIN_ALLOW_THREADS
  run_nogil(&err, [&]() {
    out_cat.reserve((size_t)sb.len + 1024);
    out_off.assign((size_t)n + 1, 0);
    std::vector<Line> lines;
    int64_t w = 0;
    for (int64_t b = 0; b < nb; ++b) {
      lines.clear();
      for (int64_t r = boff[b]; r < boff[b + 1]; ++r) {
        Line l = primary_line(*S, sam + soff[r], soff[r + 1] - soff[r]);
        if (l.valid) lines.push_back(l);
      }
      bool dup = !lines.empty() && mark_block(*S, lines);
      for (int64_t r = boff[b]; r < boff[b + 1]; ++r) {
        if (dup)
          set_dup(sam + soff[r], soff[r + 1] - soff[r], &out_cat);
        else
          out_cat.append(sam + soff[r], soff[r + 1] - soff[r]);
        out_off[++w] = (int64_t)out_cat.size();
      }
    }
  });
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&sb);
  PyBuffer_Release(&ob);
  PyBuffer_Release(&bb);
  if (err) return err.raise(PyExc_RuntimeError);
  return Py_BuildValue(
      "(NN)",
      PyBytes_FromStringAndSize(out_cat.data(),
                                (Py_ssize_t)out_cat.size()),
      PyBytes_FromStringAndSize((const char*)out_off.data(),
                                (Py_ssize_t)(out_off.size() * 8)));
}

// items(state) -> bytes of (s1 u64, s2 u64, sig u64) triples, sorted
PyObject* py_items(PyObject*, PyObject* args) {
  PyObject* st_o;
  if (!PyArg_ParseTuple(args, "O", &st_o)) return nullptr;
  State* S = (State*)PyCapsule_GetPointer(st_o, "bwa_markdup_state");
  if (!S) return nullptr;
  std::vector<uint64_t> sorted;
  NoGilError err;
  run_nogil(&err, [&]() {
    std::vector<uint64_t> flat;
    for (const auto& kv : S->bins) {
      uint64_t s1 = kv.first >> 32, s2 = kv.first & 0xFFFFFFFFull;
      if (kv.second.has_zero) {
        flat.push_back(s1); flat.push_back(s2); flat.push_back(0);
      }
      for (uint64_t v : kv.second.slots)
        if (v) { flat.push_back(s1); flat.push_back(s2); flat.push_back(v); }
    }
    // sort triples for deterministic cross-host merge
    std::vector<size_t> idx(flat.size() / 3);
    for (size_t i = 0; i < idx.size(); ++i) idx[i] = i;
    std::sort(idx.begin(), idx.end(), [&](size_t a, size_t b) {
      for (int k = 0; k < 3; ++k) {
        if (flat[a * 3 + k] != flat[b * 3 + k])
          return flat[a * 3 + k] < flat[b * 3 + k];
      }
      return false;
    });
    sorted.resize(flat.size());
    for (size_t i = 0; i < idx.size(); ++i)
      for (int k = 0; k < 3; ++k) sorted[i * 3 + k] = flat[idx[i] * 3 + k];
  });
  if (err) return err.raise(PyExc_RuntimeError);
  return PyBytes_FromStringAndSize((const char*)sorted.data(),
                                   (Py_ssize_t)(sorted.size() * 8));
}

// merge(state, items_bytes)
PyObject* py_merge(PyObject*, PyObject* args) {
  PyObject *st_o, *it_o;
  if (!PyArg_ParseTuple(args, "OO", &st_o, &it_o)) return nullptr;
  State* S = (State*)PyCapsule_GetPointer(st_o, "bwa_markdup_state");
  if (!S) return nullptr;
  Py_buffer ib;
  if (!get_buf(it_o, &ib, "items")) return nullptr;
  const uint64_t* v = (const uint64_t*)ib.buf;
  int64_t n = (int64_t)(ib.len / 24);
  NoGilError err;
  run_nogil(&err, [&]() {
    for (int64_t i = 0; i < n; ++i) {
      uint64_t key = (v[i * 3] << 32) | v[i * 3 + 1];
      S->bins[key].check_insert(v[i * 3 + 2]);
    }
  });
  PyBuffer_Release(&ib);
  if (err) return err.raise(PyExc_RuntimeError);
  Py_RETURN_NONE;
}

PyObject* py_counts(PyObject*, PyObject* args) {
  PyObject* st_o;
  if (!PyArg_ParseTuple(args, "O", &st_o)) return nullptr;
  State* S = (State*)PyCapsule_GetPointer(st_o, "bwa_markdup_state");
  if (!S) return nullptr;
  return Py_BuildValue("(LLL)", (long long)S->dup_count,
                       (long long)S->unmated_count,
                       (long long)S->strict_errors);
}

PyMethodDef methods[] = {
    {"create", py_create, METH_VARARGS, "create markdup state"},
    {"process", py_process, METH_VARARGS,
     "mark duplicates over QNAME blocks of SAM text"},
    {"items", py_items, METH_VARARGS, "serialize signatures"},
    {"merge", py_merge, METH_VARARGS, "merge serialized signatures"},
    {"counts", py_counts, METH_VARARGS,
     "(dup_count, unmated_count, strict_errors)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_markdup",
                                "bwa_flow_tpu native duplicate marking",
                                -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__markdup(void) { return PyModule_Create(&moduledef); }
