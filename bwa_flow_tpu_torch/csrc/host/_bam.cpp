// bwa_flow_tpu native BAM encoding + BGZF (CPython extension).
//
// The reference emits BAM through htslib (sam_parse1 + multithreaded
// bgzf, the reference's src/bwa_wrapper.cpp:452-591 and
// src/Pipeline.cpp:828-892). This module is the encoder of the
// from-scratch writer (io/bam.py): the JAX package's Python encoder
// (bwa_flow_tpu/io/bam.py) is the golden specification; these routines
// produce byte-identical records in batch with no per-record Python.
//
//   sam_to_bam(sam, names)               -> concatenated raw records
//   sam_to_bam_bucketed(...)             -> per-genome-bucket raw records
//                                           (BucketSortStage analog,
//                                           src/BucketSortStage.cpp:43-164)
//   scan_records(data)                   -> int64[n,5] (off, len, utid,
//                                           pos+1, rev) for the bam1_lt
//                                           sort key (src/Pipeline.cpp:31-42)
//   gather(data, offs, lens)             -> records concatenated in order
//   bgzf(data, level, nthreads)          -> BGZF stream (0xFF00 blocks),
//                                           blocks deflated in parallel
//
// A malformed SAM line raises ValueError, as the Python encoder does
// (also where that one writes a record: a qual of another length than
// the seq); the encoders run without the GIL and catch every C++
// exception inside that region (run_nogil, nogil.h), raising it once
// the GIL is held again. A failed BGZF block raises.
//
// Build: bwa_flow_tpu_torch/_build.py (c++ -pthread -lz at first use)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "nogil.h"

namespace {

using bwaflow::NoGilError;
using bwaflow::run_nogil;

// ---------------------------------------------------------------- encode

// _SEQ_CODE: "=ACMGRSVTWYHKDBN" positions, uppercased input, default 15.
int8_t SEQ_CODE[256];
// _CIGAR_OP: "MIDNSHP=X"
int8_t CIGAR_OP[256];

void init_tables() {
  const char* seq = "=ACMGRSVTWYHKDBN";
  const char* cig = "MIDNSHP=X";
  for (int i = 0; i < 256; i++) SEQ_CODE[i] = 15;
  for (int i = 0; i < 16; i++) {
    SEQ_CODE[(unsigned char)seq[i]] = i;
    SEQ_CODE[(unsigned char)tolower(seq[i])] = i;
  }
  for (int i = 0; i < 256; i++) CIGAR_OP[i] = -1;
  for (int i = 0; i < 9; i++) CIGAR_OP[(unsigned char)cig[i]] = i;
}

// SAM spec section 5.3 (bwa_flow_tpu/io/bam.py reg2bin)
int reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (int)(beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (int)(beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (int)(beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (int)(beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (int)(beg >> 26);
  return 0;
}

struct Field {
  const char* p;
  size_t n;
  std::string str() const { return std::string(p, n); }
  bool is(const char* s) const { return n == strlen(s) && !memcmp(p, s, n); }
};

// A decimal integer field (optional sign, 1-18 digits); anything else
// throws, as Python's int() raises.
int64_t to_int(const Field& f) {
  int64_t v = 0;
  bool neg = false;
  size_t i = 0;
  if (f.n && (f.p[0] == '-' || f.p[0] == '+')) {
    neg = f.p[0] == '-';
    i = 1;
  }
  if (i == f.n || f.n - i > 18)
    throw std::runtime_error("bad integer field: " + f.str());
  for (; i < f.n; i++) {
    if (f.p[i] < '0' || f.p[i] > '9')
      throw std::runtime_error("bad integer field: " + f.str());
    v = v * 10 + (f.p[i] - '0');
  }
  return neg ? -v : v;
}

void put_u8(std::string& out, uint8_t v) { out.push_back((char)v); }
void put_u16(std::string& out, uint16_t v) {
  out.append((const char*)&v, 2);
}
void put_i32(std::string& out, int32_t v) { out.append((const char*)&v, 4); }
void put_u32(std::string& out, uint32_t v) {
  out.append((const char*)&v, 4);
}
void put_f32(std::string& out, float v) { out.append((const char*)&v, 4); }

// Optional-tag encoding matching bwa_flow_tpu/io/bam.py _encode_tags byte for byte.
void encode_tag(std::string& out, const Field& tag) {
  if (tag.n < 5 || tag.p[2] != ':' || tag.p[4] != ':')
    throw std::runtime_error("bad tag: " + tag.str());
  out.append(tag.p, 2);
  char typ = tag.p[3];
  Field val{tag.p + 5, tag.n - 5};
  switch (typ) {
    case 'i': {
      int64_t v = to_int(val);
      if (v < -(1ll << 31) || v >= (1ll << 31))
        throw std::runtime_error("tag int out of range: " + tag.str());
      out.push_back('i');
      put_i32(out, (int32_t)v);
      break;
    }
    case 'A':
      out.push_back('A');
      out.push_back(val.n ? val.p[0] : '\0');
      break;
    case 'f':
      out.push_back('f');
      put_f32(out, strtof(val.str().c_str(), nullptr));
      break;
    case 'Z':
    case 'H':
      out.push_back(typ);
      out.append(val.p, val.n);
      out.push_back('\0');
      break;
    case 'B': {
      // subtype, then comma-separated numbers
      if (!val.n) throw std::runtime_error("empty B tag");
      char code = val.p[0];
      std::vector<Field> nums;
      size_t i = 1;
      while (i < val.n) {
        if (val.p[i] != ',') throw std::runtime_error("bad B tag");
        size_t j = ++i;
        while (j < val.n && val.p[j] != ',') j++;
        nums.push_back({val.p + i, j - i});
        i = j;
      }
      out.push_back('B');
      out.push_back(code);
      put_i32(out, (int32_t)nums.size());
      for (const Field& x : nums) {
        switch (code) {
          case 'c': out.push_back((char)(int8_t)to_int(x)); break;
          case 'C': out.push_back((char)(uint8_t)to_int(x)); break;
          case 's': { int16_t v = (int16_t)to_int(x); out.append((const char*)&v, 2); break; }
          case 'S': { uint16_t v = (uint16_t)to_int(x); out.append((const char*)&v, 2); break; }
          case 'i': put_i32(out, (int32_t)to_int(x)); break;
          case 'I': put_u32(out, (uint32_t)to_int(x)); break;
          case 'f': put_f32(out, strtof(x.str().c_str(), nullptr)); break;
          default: throw std::runtime_error("bad B subtype");
        }
      }
      break;
    }
    default:
      throw std::runtime_error(std::string("unsupported tag type ") + typ);
  }
}

struct RecMeta {
  size_t off, len;
  int32_t tid, pos;  // BAM (0-based) coordinates
  uint16_t flag;
};

// Encode one SAM line (no trailing newline) appended to out; returns meta.
RecMeta encode_line(std::string& out, const char* line, size_t len,
                    const std::unordered_map<std::string, int>& tid_map) {
  std::vector<Field> f;
  f.reserve(16);
  size_t start = 0;
  for (size_t i = 0; i <= len; i++) {
    if (i == len || line[i] == '\t') {
      f.push_back({line + start, i - start});
      start = i + 1;
    }
  }
  if (f.size() < 11) throw std::runtime_error("short SAM line");
  int64_t flag = to_int(f[1]);
  int64_t pos = to_int(f[3]);
  int64_t mapq = to_int(f[4]);
  int64_t pnext = to_int(f[7]);
  int64_t tlen = to_int(f[8]);
  auto lookup = [&](const Field& name) -> int {
    if (name.n == 1 && name.p[0] == '*') return -1;
    auto it = tid_map.find(name.str());
    return it == tid_map.end() ? -1 : it->second;
  };
  // the fields Python's struct.pack holds to their BAM widths
  if (f[0].n > 254) throw std::runtime_error("qname longer than 254");
  if (flag < 0 || flag > 0xFFFF) throw std::runtime_error("flag out of range");
  if (mapq < 0 || mapq > 0xFF) throw std::runtime_error("mapq out of range");
  if (pos < -(1ll << 31) + 1 || pos > (1ll << 31) ||
      pnext < -(1ll << 31) + 1 || pnext > (1ll << 31) ||
      tlen < -(1ll << 31) || tlen >= (1ll << 31))
    throw std::runtime_error("pos, pnext or tlen out of range");
  int tid = lookup(f[2]);
  int mtid = f[6].is("=") ? tid : lookup(f[6]);
  // cigar
  std::vector<uint32_t> cig;
  int64_t rlen = 0;
  if (!f[5].is("*")) {
    uint32_t n = 0;
    for (size_t i = 0; i < f[5].n; i++) {
      char c = f[5].p[i];
      if (c >= '0' && c <= '9') {
        n = n * 10 + (c - '0');
      } else {
        int op = CIGAR_OP[(unsigned char)c];
        if (op < 0) throw std::runtime_error("bad cigar op");
        if (n >= (1u << 28)) throw std::runtime_error("cigar length");
        cig.push_back((n << 4) | (uint32_t)op);
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rlen += n;
        n = 0;
      }
    }
  }
  if (cig.size() > 0xFFFF) throw std::runtime_error("too many cigar ops");
  if (rlen == 0) rlen = 1;
  int l_seq = f[9].is("*") ? 0 : (int)f[9].n;
  if (l_seq && !f[10].is("*") && f[10].n != (size_t)l_seq)
    throw std::runtime_error("qual and seq lengths differ");
  int bin = pos > 0 ? reg2bin(pos - 1, pos - 1 + rlen) : 4680;

  size_t rec_off = out.size();
  put_i32(out, 0);  // block_size placeholder
  put_i32(out, tid);
  put_i32(out, (int32_t)(pos - 1));
  put_u8(out, (uint8_t)(f[0].n + 1));
  put_u8(out, (uint8_t)mapq);
  put_u16(out, (uint16_t)bin);
  put_u16(out, (uint16_t)cig.size());
  put_u16(out, (uint16_t)flag);
  put_i32(out, l_seq);
  put_i32(out, mtid);
  put_i32(out, (int32_t)(pnext - 1));
  put_i32(out, (int32_t)tlen);
  out.append(f[0].p, f[0].n);
  out.push_back('\0');
  for (uint32_t c : cig) put_u32(out, c);
  if (l_seq) {
    size_t nib = out.size();
    out.resize(out.size() + (l_seq + 1) / 2, '\0');
    char* q = &out[nib];
    for (int i = 0; i < l_seq; i++) {
      int code = SEQ_CODE[(unsigned char)f[9].p[i]];
      if (i % 2 == 0)
        q[i / 2] = (char)(code << 4);
      else
        q[i / 2] |= (char)code;
    }
    if (f[10].is("*")) {
      out.append((size_t)l_seq, (char)0xff);
    } else {
      size_t qo = out.size();
      out.resize(out.size() + l_seq);
      char* qq = &out[qo];
      for (int i = 0; i < l_seq; i++) {
        int v = (unsigned char)f[10].p[i] - 33;
        qq[i] = (char)(v < 0 ? 0 : (v > 93 ? 93 : v));
      }
    }
  }
  std::string tags;
  for (size_t i = 11; i < f.size(); i++) encode_tag(tags, f[i]);
  out += tags;
  int32_t bs = (int32_t)(out.size() - rec_off - 4);
  memcpy(&out[rec_off], &bs, 4);
  return {rec_off, out.size() - rec_off, tid, (int32_t)(pos - 1),
          (uint16_t)flag};
}

std::unordered_map<std::string, int> parse_names(const char* buf,
                                                 Py_ssize_t n) {
  // '\0'-joined reference names in tid order
  std::unordered_map<std::string, int> m;
  int tid = 0;
  Py_ssize_t start = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    if (buf[i] == '\0') {
      m.emplace(std::string(buf + start, i - start), tid++);
      start = i + 1;
    }
  }
  return m;
}

// Iterate SAM text lines, skipping blank and '@' header lines.
template <typename Fn>
void for_each_line(const char* s, Py_ssize_t n, Fn&& fn) {
  Py_ssize_t start = 0;
  for (Py_ssize_t i = 0; i <= n; i++) {
    if (i == n || s[i] == '\n') {
      if (i > start && s[start] != '@') fn(s + start, (size_t)(i - start));
      start = i + 1;
    }
  }
}

PyObject* py_sam_to_bam(PyObject*, PyObject* args) {
  const char* sam;
  Py_ssize_t sam_n;
  const char* names;
  Py_ssize_t names_n;
  if (!PyArg_ParseTuple(args, "s#y#", &sam, &sam_n, &names, &names_n))
    return nullptr;
  std::string out;
  NoGilError err;
  Py_BEGIN_ALLOW_THREADS
  run_nogil(&err, [&]() {
    auto tid_map = parse_names(names, names_n);
    for_each_line(sam, sam_n, [&](const char* p, size_t n) {
      encode_line(out, p, n, tid_map);
    });
  });
  Py_END_ALLOW_THREADS
  if (err) return err.raise(PyExc_ValueError);
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

// sam_to_bam_bucketed(sam, names, acc_int64_bytes, bucket_size, nbuckets,
//                     drop_dups, filter_unmap) -> list[nbuckets+1] of bytes
PyObject* py_sam_to_bam_bucketed(PyObject*, PyObject* args) {
  const char* sam;
  Py_ssize_t sam_n;
  const char* names;
  Py_ssize_t names_n;
  const char* accb;
  Py_ssize_t acc_n;
  long long bucket_size;
  int nbuckets, drop_dups, filter_unmap;
  if (!PyArg_ParseTuple(args, "s#y#y#Lipp", &sam, &sam_n, &names, &names_n,
                        &accb, &acc_n, &bucket_size, &nbuckets, &drop_dups,
                        &filter_unmap))
    return nullptr;
  const int64_t* acc = (const int64_t*)accb;
  if (nbuckets < 1 || bucket_size < 1) {
    PyErr_SetString(PyExc_ValueError,
                    "sam_to_bam_bucketed: nbuckets and bucket_size >= 1");
    return nullptr;
  }
  std::vector<std::string> buckets;
  NoGilError err;
  Py_BEGIN_ALLOW_THREADS
  run_nogil(&err, [&]() {
    buckets.resize((size_t)nbuckets + 1);
    auto tid_map = parse_names(names, names_n);
    // acc holds a start for every name's tid
    if ((size_t)acc_n < tid_map.size() * 8)
      throw std::runtime_error("acc shorter than the names");
    std::string rec;
    for_each_line(sam, sam_n, [&](const char* p, size_t n) {
      rec.clear();
      RecMeta m = encode_line(rec, p, n, tid_map);
      if (drop_dups && (m.flag & 0x400)) return;
      if (filter_unmap && (m.flag & 0x4)) return;
      int b;
      if (m.tid < 0) {
        b = nbuckets;
      } else {
        long long g = acc[m.tid] + m.pos;
        if (g < 0) {
          b = nbuckets;  // matches Python floor-div -1 -> files[-1]
        } else {
          long long bid = g / bucket_size;
          b = (int)(bid < nbuckets - 1 ? bid : nbuckets - 1);
        }
      }
      buckets[(size_t)b] += rec;
    });
  });
  Py_END_ALLOW_THREADS
  if (err) return err.raise(PyExc_ValueError);
  PyObject* lst = PyList_New((Py_ssize_t)buckets.size());
  if (!lst) return nullptr;
  for (size_t i = 0; i < buckets.size(); i++) {
    PyObject* b = PyBytes_FromStringAndSize(buckets[i].data(),
                                            (Py_ssize_t)buckets[i].size());
    if (!b) {
      Py_DECREF(lst);
      return nullptr;
    }
    PyList_SET_ITEM(lst, (Py_ssize_t)i, b);
  }
  return lst;
}

// ---------------------------------------------------------------- scan

// scan_records(data) -> bytes of int64[n,5]: off, len, utid, pos+1, rev
PyObject* py_scan_records(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const char* data = (const char*)buf.buf;
  Py_ssize_t n = buf.len;
  std::vector<int64_t> rows;
  bool bad = false;
  NoGilError err;
  Py_BEGIN_ALLOW_THREADS
  run_nogil(&err, [&]() {
    Py_ssize_t off = 0;
    while (off + 4 <= n) {
      int32_t bs;
      memcpy(&bs, data + off, 4);
      if (bs < 32 || off + 4 + bs > n) {
        bad = true;
        break;
      }
      int32_t tid, pos;
      uint16_t flag;
      memcpy(&tid, data + off + 4, 4);
      memcpy(&pos, data + off + 8, 4);
      memcpy(&flag, data + off + 18, 2);
      rows.push_back(off);
      rows.push_back(4 + bs);
      rows.push_back((int64_t)(uint32_t)tid);
      rows.push_back((int64_t)pos + 1);
      rows.push_back((flag >> 4) & 1);
      off += 4 + bs;
    }
    if (off != n) bad = true;
  });
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  if (err) return err.raise(PyExc_RuntimeError);
  if (bad) {
    PyErr_SetString(PyExc_ValueError, "corrupt BAM record stream");
    return nullptr;
  }
  return PyBytes_FromStringAndSize((const char*)rows.data(),
                                   (Py_ssize_t)(rows.size() * 8));
}

// gather(data, offs_int64_bytes, lens_int64_bytes) -> bytes
PyObject* py_gather(PyObject*, PyObject* args) {
  Py_buffer buf, offs_b, lens_b;
  if (!PyArg_ParseTuple(args, "y*y*y*", &buf, &offs_b, &lens_b))
    return nullptr;
  const char* data = (const char*)buf.buf;
  const int64_t* offs = (const int64_t*)offs_b.buf;
  const int64_t* lens = (const int64_t*)lens_b.buf;
  Py_ssize_t cnt = offs_b.len / 8;
  // every record [offs[i], offs[i] + lens[i]) inside data, one length
  // an offset
  bool ok = offs_b.len == lens_b.len;
  int64_t total = 0;
  for (Py_ssize_t i = 0; ok && i < cnt; i++) {
    ok = offs[i] >= 0 && lens[i] >= 0 && lens[i] <= buf.len - offs[i];
    total += lens[i];
  }
  if (!ok) {
    PyBuffer_Release(&buf);
    PyBuffer_Release(&offs_b);
    PyBuffer_Release(&lens_b);
    PyErr_SetString(PyExc_ValueError,
                    "gather: offs and lens differ in length, or a record "
                    "lies outside data");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
  if (!out) {
    PyBuffer_Release(&buf);
    PyBuffer_Release(&offs_b);
    PyBuffer_Release(&lens_b);
    return nullptr;
  }
  char* dst = PyBytes_AS_STRING(out);
  Py_BEGIN_ALLOW_THREADS
  int64_t w = 0;
  for (Py_ssize_t i = 0; i < cnt; i++) {
    memcpy(dst + w, data + offs[i], (size_t)lens[i]);
    w += lens[i];
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  PyBuffer_Release(&offs_b);
  PyBuffer_Release(&lens_b);
  return out;
}

// ---------------------------------------------------------------- bgzf

// One BGZF member (io/bam.py bgzf_block): gzip header with BC extra
// field + raw deflate + crc32 + isize.
std::string bgzf_block(const char* p, size_t n, int level) {
  std::string cdata;
  cdata.resize(compressBound((uLong)n) + 64);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
      Z_OK)
    throw std::runtime_error("deflateInit2 failed");
  zs.next_in = (Bytef*)p;
  zs.avail_in = (uInt)n;
  zs.next_out = (Bytef*)&cdata[0];
  zs.avail_out = (uInt)cdata.size();
  if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
    deflateEnd(&zs);
    throw std::runtime_error("deflate failed");
  }
  size_t clen = zs.total_out;
  deflateEnd(&zs);
  size_t bsize = clen + 25 + 1;
  if (bsize > 0x10000) throw std::runtime_error("BGZF block too large");
  std::string out;
  out.reserve(bsize);
  const uint8_t head[12] = {31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 6, 0};
  out.append((const char*)head, 12);
  uint8_t extra[6] = {66, 67, 2, 0, 0, 0};
  uint16_t bs16 = (uint16_t)(bsize - 1);
  memcpy(extra + 4, &bs16, 2);
  out.append((const char*)extra, 6);
  out.append(cdata.data(), clen);
  uint32_t crc = (uint32_t)crc32(0, (const Bytef*)p, (uInt)n);
  uint32_t isz = (uint32_t)n;
  out.append((const char*)&crc, 4);
  out.append((const char*)&isz, 4);
  return out;
}

// bgzf(data, level=6, nthreads=1) -> bytes (no EOF marker appended)
PyObject* py_bgzf(PyObject*, PyObject* args) {
  Py_buffer buf;
  int level = 6, nthreads = 1;
  if (!PyArg_ParseTuple(args, "y*|ii", &buf, &level, &nthreads))
    return nullptr;
  const char* data = (const char*)buf.buf;
  size_t n = (size_t)buf.len;
  constexpr size_t BLK = 0xFF00;
  size_t nblk = (n + BLK - 1) / BLK;
  std::vector<std::string> blocks;
  std::atomic<bool> failed{false};  // a block's deflate failed
  NoGilError err;
  Py_BEGIN_ALLOW_THREADS
  run_nogil(&err, [&]() {
    blocks.resize(nblk);
    int nt = nthreads < 1 ? 1 : nthreads;
    if ((size_t)nt > nblk) nt = (int)(nblk ? nblk : 1);
    bwaflow::run_threads(nt, [&](int t) {
      for (size_t i = (size_t)t; i < nblk; i += (size_t)nt) {
        size_t off = i * BLK;
        size_t len = off + BLK <= n ? BLK : n - off;
        try {
          blocks[i] = bgzf_block(data + off, len, level);
        } catch (...) {
          failed.store(true, std::memory_order_relaxed);
        }
      }
    });
  });
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  if (err) return err.raise(PyExc_RuntimeError);
  if (failed.load()) {
    PyErr_SetString(PyExc_ValueError, "bgzf compression failed");
    return nullptr;
  }
  size_t total = 0;
  for (const auto& b : blocks) total += b.size();
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
  if (!out) return nullptr;
  char* dst = PyBytes_AS_STRING(out);
  size_t w = 0;
  for (const auto& b : blocks) {
    memcpy(dst + w, b.data(), b.size());
    w += b.size();
  }
  return out;
}

// zlib_version() -> the version of the zlib this library links
PyObject* py_zlib_version(PyObject*, PyObject*) {
  return PyUnicode_FromString(zlibVersion());
}

PyMethodDef methods[] = {
    {"zlib_version", py_zlib_version, METH_NOARGS,
     "zlib_version() -> version of the linked zlib"},
    {"sam_to_bam", py_sam_to_bam, METH_VARARGS,
     "sam_to_bam(sam_text, names_nul_joined) -> raw BAM records"},
    {"sam_to_bam_bucketed", py_sam_to_bam_bucketed, METH_VARARGS,
     "encode + route SAM lines into genome-position buckets"},
    {"scan_records", py_scan_records, METH_VARARGS,
     "scan raw records -> int64[n,5] (off, len, utid, pos1, rev) bytes"},
    {"gather", py_gather, METH_VARARGS,
     "gather(data, offs, lens) -> concatenated records"},
    {"bgzf", py_bgzf, METH_VARARGS,
     "bgzf(data, level=6, nthreads=1) -> BGZF stream (no EOF block)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_bam",
                                "native BAM/BGZF encoding",
                                -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit__bam(void) {
  init_tables();
  return PyModule_Create(&moduledef);
}
