// bwa_flow_tpu_torch native FASTQ/FASTA reader (CPython extension).
//
// The reference reads its input in a stage of its own (kflow's
// KseqsRead; bwa's kt_pipeline step 0 over kseq.h), so the threads that
// align never parse. This module is that stage for io/fastq.py's
// read_batches: a std::thread parses batch N+1 while the consumer holds
// batch N, never taking the GIL, and the consumer's next() waits for it
// with the GIL released and builds the batch's Read objects.
//
//   Reader(path1, path2, chunk_bp, interleaved, start_id, read_cls,
//          seq_view)              opens the inputs ("-": standard input);
//                                 read_cls is io/sam.py's Read, seq_view
//                                 makes a uint8 array of a bytearray
//   Reader.next()              -> (reads, reader_seconds, ready), or None
//                                 after the last batch; the thread starts
//                                 at the first call
//   Reader.close()             -> stops and joins the thread, which
//                                 closes its own descriptors
//   live_threads()             -> reader threads running in the process
//
// Parse (kseq semantics, as the JAX package's io/fastq.py reads them):
// gzip by its magic, members concatenated; FASTA or FASTQ by the first
// byte; "\r\n" stripped; a FASTQ sequence runs over lines until one that
// starts with '+', and its quality accumulates until it covers the
// sequence; name and comment split at the first run of whitespace, as
// bytes.split(None, 1); bases to nt4 (ACGTacgt -> 0-3, all else 4); an
// empty quality or comment is None; a name's /1 or /2 suffix dropped.
// Batches are cut as io/fastq.py's: at chunk_bp bases (paired files
// interleaved, `interleaved` to an even count), ids contiguous from
// start_id.
//
// The thread waits in poll() on its input and on a wake pipe, so it is
// never blocked in read() when close() joins it: close() sets the stop
// flag and writes the pipe, and the thread leaves at its next check (a
// refill of its buffer at most). Every C++ exception is caught on the
// thread and raised to the consumer, with the GIL held, at the next()
// that would have returned that batch.
//
// Build: bwa_flow_tpu_torch/_build.py (c++ -pthread -lz at first use)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <fcntl.h>
#include <poll.h>
#include <pthread.h>
#include <signal.h>
#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <new>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

// What the thread throws; the consumer picks Python's exception type.
struct FormatError : std::runtime_error {  // ValueError
  using std::runtime_error::runtime_error;
};
struct SysError : std::runtime_error {  // OSError from errno, the path
  int err;
  SysError(int e, const std::string& path) : std::runtime_error(path), err(e) {}
};
struct GzipError : std::runtime_error {  // OSError with zlib's message
  using std::runtime_error::runtime_error;
};
struct TruncatedGzip : std::runtime_error {  // EOFError, as Python's gzip
  using std::runtime_error::runtime_error;
};
struct Stopped {};  // close() was called

enum Kind { kNone, kMemory, kValue, kErrno, kOSError, kEOF, kOther };

struct Failure {
  int kind = kNone;
  int err = 0;
  std::string msg;
};

unsigned char NT4[256];

void init_nt4() {
  std::memset(NT4, 4, sizeof NT4);
  const char* s = "ACGT";
  for (int i = 0; i < 4; ++i) {
    NT4[(unsigned char)s[i]] = (unsigned char)i;
    NT4[(unsigned char)(s[i] + 32)] = (unsigned char)i;
  }
}

// bytes.split's whitespace
inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

inline void strip_eol(const char* p, size_t& n) {
  while (n && (p[n - 1] == '\r' || p[n - 1] == '\n')) --n;
}

std::atomic<int> g_live{0};
PyObject* g_empty_tuple;
PyObject* g_empty_str;
PyObject* g_fields[6];  // io/sam.py's Read, in its order

constexpr size_t kBuf = size_t(1) << 20;

// One input: a descriptor read after poll(), gunzipped when it starts
// with the gzip magic, cut into lines.
class Source {
 public:
  Source(int fd, std::string path, const std::atomic<bool>* stop, int wake)
      : fd_(fd), path_(std::move(path)), stop_(stop), wake_(wake) {}
  ~Source() {
    if (zinit_) inflateEnd(&zs_);
    if (fd_ >= 0) ::close(fd_);
  }
  Source(const Source&) = delete;
  Source& operator=(const Source&) = delete;

  // Reads the first bytes and decides gzip.
  void start() {
    buf_.resize(kBuf);
    while (end_ < 2) {
      size_t got = read_raw(buf_.data() + end_, kBuf - end_);
      if (!got) break;
      end_ += got;
    }
    if (end_ >= 2 && buf_[0] == 0x1f && buf_[1] == 0x8b) {
      gz_ = true;
      raw_.resize(kBuf);
      std::memcpy(raw_.data(), buf_.data(), end_);
      std::memset(&zs_, 0, sizeof zs_);
      if (inflateInit2(&zs_, 16 + MAX_WBITS) != Z_OK) throw std::bad_alloc();
      zinit_ = true;
      zs_.next_in = raw_.data();
      zs_.avail_in = (uInt)end_;
      beg_ = end_ = 0;
    }
  }

  // The next line without its '\n' in [p, p + n), valid until the next
  // call; false at the end of the input (then always).
  bool getline(const char*& p, size_t& n) {
    line_.clear();
    for (;;) {
      if (beg_ < end_) {
        const char* s = (const char*)buf_.data() + beg_;
        size_t avail = end_ - beg_;
        const char* nl = (const char*)std::memchr(s, '\n', avail);
        if (nl) {
          size_t len = (size_t)(nl - s);
          beg_ += len + 1;
          if (line_.empty()) {
            p = s;
            n = len;
          } else {
            line_.append(s, len);
            p = line_.data();
            n = line_.size();
          }
          return true;
        }
        line_.append(s, avail);
        beg_ = end_;
      }
      if (!fill()) {
        if (line_.empty()) return false;
        p = line_.data();
        n = line_.size();
        return true;
      }
    }
  }

 private:
  size_t read_raw(unsigned char* dst, size_t cap) {
    for (;;) {
      if (stop_->load(std::memory_order_relaxed)) throw Stopped{};
      struct pollfd fds[2] = {{fd_, POLLIN, 0}, {wake_, POLLIN, 0}};
      int r = ::poll(fds, 2, -1);
      if (r < 0) {
        if (errno == EINTR) continue;
        throw SysError(errno, path_);
      }
      if (fds[1].revents) throw Stopped{};
      ssize_t got = ::read(fd_, dst, cap);
      if (got >= 0) return (size_t)got;
      if (errno == EINTR || errno == EAGAIN) continue;
      throw SysError(errno, path_);
    }
  }

  bool fill() {
    beg_ = end_ = 0;
    if (!gz_) {
      if (eof_) return false;
      end_ = read_raw(buf_.data(), kBuf);
      if (!end_) eof_ = true;
      return end_ > 0;
    }
    while (end_ == 0) {
      if (zs_.avail_in == 0) {
        if (eof_) {
          if (member_)
            throw TruncatedGzip(
                "Compressed file ended before the end-of-stream marker "
                "was reached");
          return false;
        }
        size_t got = read_raw(raw_.data(), raw_.size());
        if (!got) {
          eof_ = true;
          continue;
        }
        zs_.next_in = raw_.data();
        zs_.avail_in = (uInt)got;
      }
      if (!member_) {  // between members: zero padding, as Python's gzip
        while (zs_.avail_in && *zs_.next_in == 0) {
          ++zs_.next_in;
          --zs_.avail_in;
        }
        if (!zs_.avail_in) continue;
        if (inflateReset(&zs_) != Z_OK) throw GzipError(path_ + ": bad state");
        member_ = true;
      }
      zs_.next_out = buf_.data();
      zs_.avail_out = (uInt)kBuf;
      int rc = inflate(&zs_, Z_NO_FLUSH);
      end_ = kBuf - zs_.avail_out;
      if (rc == Z_STREAM_END) {
        member_ = false;
      } else if (rc == Z_MEM_ERROR) {
        throw std::bad_alloc();
      } else if (rc != Z_OK && !(rc == Z_BUF_ERROR && zs_.avail_in == 0)) {
        throw GzipError(path_ + ": " +
                        (zs_.msg ? zs_.msg : "invalid gzip data"));
      }
    }
    return true;
  }

  int fd_;
  std::string path_;
  const std::atomic<bool>* stop_;
  int wake_;
  std::vector<unsigned char> buf_, raw_;
  size_t beg_ = 0, end_ = 0;
  bool eof_ = false, gz_ = false, zinit_ = false, member_ = false;
  z_stream zs_;
  std::string line_;
};

// One batch, packed: record i's bases are seq[seq_off[i], seq_off[i+1]),
// and so on; an empty quality or comment is None.
struct Batch {
  int64_t n = 0, start_id = 0;
  double parse_s = 0;
  std::vector<unsigned char> seq;
  std::string names, quals, comments;
  std::vector<int64_t> seq_off{0}, name_off{0}, qual_off{0}, com_off{0};
};

// One FASTA or FASTQ file, record by record.
class SeqFile {
 public:
  SeqFile(int fd, std::string path, const std::atomic<bool>* stop, int wake)
      : src_(fd, std::move(path), stop, wake) {}

  // Appends the next record to `b` (its length to *len); false at the end.
  bool next(Batch& b, int64_t* len) {
    const char* p;
    size_t n;
    if (fmt_ == 0) {
      src_.start();
      if (!src_.getline(p, n)) {
        fmt_ = -1;
        return false;
      }
      unsigned char first = n ? (unsigned char)p[0] : '\n';
      if (first != '>' && first != '@') {
        char msg[64];
        std::snprintf(msg, sizeof msg,
                      "not FASTA/FASTQ input: leading byte 0x%02x", first);
        throw FormatError(msg);
      }
      fmt_ = first;
      set_head(p, n);
    } else if (fmt_ == '@' && !has_head_) {
      // a FASTQ header is read when its record is asked for, so a record
      // is complete without the next one's first line
      if (!src_.getline(p, n)) return false;
      set_head(p, n);
    }
    if (!has_head_) return false;
    return fmt_ == '>' ? next_fasta(b, len) : next_fastq(b, len);
  }

 private:
  // the header line, stripped, without its first byte
  void set_head(const char* p, size_t n) {
    strip_eol(p, n);
    head_.assign(n ? p + 1 : p, n ? n - 1 : 0);
    has_head_ = true;
  }

  // name (its /1 or /2 dropped) and comment from head_ into the batch;
  // name_ keeps the name as read, for the error messages
  void put_head(Batch& b) {
    const char* h = head_.data();
    size_t n = head_.size(), i = 0;
    while (i < n && is_space(h[i])) ++i;
    size_t ns = i;
    while (i < n && !is_space(h[i])) ++i;
    size_t ne = i;
    while (i < n && is_space(h[i])) ++i;
    if (ne == ns) throw FormatError("FASTA/FASTQ record with an empty name");
    name_.assign(h + ns, ne - ns);
    size_t keep = ne - ns;
    char last = h[ne - 1];
    if (keep > 2 && h[ne - 2] == '/' && (last == '1' || last == '2'))
      keep -= 2;
    b.names.append(h + ns, keep);
    b.comments.append(h + i, n - i);
  }

  void put_seq(Batch& b, const char* p, size_t n) {
    size_t at = b.seq.size();
    b.seq.resize(at + n);
    unsigned char* d = b.seq.data() + at;
    for (size_t k = 0; k < n; ++k) d[k] = NT4[(unsigned char)p[k]];
  }

  void close_record(Batch& b, int64_t s0, int64_t* len) {
    b.seq_off.push_back((int64_t)b.seq.size());
    b.name_off.push_back((int64_t)b.names.size());
    b.qual_off.push_back((int64_t)b.quals.size());
    b.com_off.push_back((int64_t)b.comments.size());
    *len = (int64_t)b.seq.size() - s0;
  }

  bool next_fasta(Batch& b, int64_t* len) {
    put_head(b);
    int64_t s0 = (int64_t)b.seq.size();
    const char* p;
    size_t n;
    for (;;) {
      if (!src_.getline(p, n)) {
        has_head_ = false;
        break;
      }
      strip_eol(p, n);
      if (n && p[0] == '>') {
        set_head(p, n);
        break;
      }
      put_seq(b, p, n);
    }
    close_record(b, s0, len);
    return true;
  }

  bool next_fastq(Batch& b, int64_t* len) {
    put_head(b);
    int64_t s0 = (int64_t)b.seq.size();
    const char* p;
    size_t n;
    while (src_.getline(p, n) && !(n && p[0] == '+')) {
      strip_eol(p, n);
      put_seq(b, p, n);
    }
    size_t slen = b.seq.size() - (size_t)s0, qlen = 0;
    while (qlen < slen) {
      if (!src_.getline(p, n))
        throw FormatError("truncated FASTQ record '" + name_ +
                          "': quality shorter than sequence");
      strip_eol(p, n);
      b.quals.append(p, n);
      qlen += n;
    }
    if (qlen != slen)
      throw FormatError("malformed FASTQ record '" + name_ +
                        "': quality length " + std::to_string(qlen) +
                        " != sequence length " + std::to_string(slen));
    has_head_ = false;
    close_record(b, s0, len);
    return true;
  }

  Source src_;
  int fmt_ = 0;  // 0 before the first byte, '>' or '@', -1 empty input
  bool has_head_ = false;
  std::string head_, name_;
};

// What the reader thread and the consumer share.
struct State {
  std::unique_ptr<SeqFile> f1, f2;
  int64_t chunk_bp = 0, next_id = 0;
  bool interleaved = false;
  int wake[2] = {-1, -1};
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv;
  std::unique_ptr<Batch> slot;  // the batch parsed ahead (depth 1)
  bool done = false;            // the thread has left
  Failure fail;                 // why, if it failed
  std::thread th;
  bool started = false;

  ~State() {
    for (int fd : wake)
      if (fd >= 0) ::close(fd);
  }

  void parse(Batch& b) {
    b.start_id = next_id;
    int64_t bp = 0, l1, l2;
    if (f2) {
      for (;;) {
        if (!f1->next(b, &l1)) {
          Batch extra;
          if (f2->next(extra, &l2))
            throw FormatError("paired FASTQs differ in length");
          break;
        }
        if (!f2->next(b, &l2))
          throw FormatError("paired FASTQs differ in length");
        b.n += 2;
        bp += l1 + l2;
        if (bp >= chunk_bp) break;
      }
    } else {
      while (f1->next(b, &l1)) {
        ++b.n;
        bp += l1;
        if (bp >= chunk_bp && (!interleaved || b.n % 2 == 0)) break;
      }
    }
    next_id += b.n;
  }

  void record(int kind, int err, const char* msg) noexcept {
    fail.kind = kind;
    fail.err = err;
    try {
      fail.msg = msg;
    } catch (...) {
      fail.kind = kMemory;
    }
  }

  void run() noexcept {
    sigset_t all;  // signals go to the interpreter's threads
    sigfillset(&all);
    pthread_sigmask(SIG_BLOCK, &all, nullptr);
    try {
      for (;;) {
        {
          std::unique_lock<std::mutex> lk(mu);
          cv.wait(lk, [&] { return !slot || stop.load(); });
          if (stop.load()) break;
        }
        auto t0 = std::chrono::steady_clock::now();
        auto b = std::make_unique<Batch>();
        parse(*b);
        b->parse_s = std::chrono::duration<double>(
                         std::chrono::steady_clock::now() - t0)
                         .count();
        if (b->n == 0) break;
        {
          std::lock_guard<std::mutex> lk(mu);
          slot = std::move(b);
        }
        cv.notify_all();
      }
    } catch (const Stopped&) {
    } catch (const std::bad_alloc&) {
      record(kMemory, 0, "");
    } catch (const FormatError& e) {
      record(kValue, 0, e.what());
    } catch (const SysError& e) {
      record(kErrno, e.err, e.what());
    } catch (const GzipError& e) {
      record(kOSError, 0, e.what());
    } catch (const TruncatedGzip& e) {
      record(kEOF, 0, e.what());
    } catch (const std::exception& e) {
      record(kOther, 0, e.what());
    } catch (...) {
      record(kOther, 0, "unknown C++ exception");
    }
    f1.reset();  // the thread closes its own descriptors
    f2.reset();
    try {
      std::lock_guard<std::mutex> lk(mu);
      done = true;
    } catch (...) {
      done = true;
    }
    cv.notify_all();
    g_live.fetch_sub(1);
  }
};

struct ReaderObject {
  PyObject_HEAD
  State* st;
  PyObject* read_cls;
  PyObject* seq_view;
};

// Stops the thread and joins it (it is never blocked in read(): it
// polls the wake pipe beside its input), then frees what it held.
void reader_close(ReaderObject* self) {
  State* st = self->st;
  if (!st) return;
  self->st = nullptr;
  Py_BEGIN_ALLOW_THREADS
  st->stop.store(true);
  try {
    std::lock_guard<std::mutex> lk(st->mu);
  } catch (...) {
  }
  st->cv.notify_all();
  if (st->wake[1] >= 0) {
    char c = 1;
    ssize_t w = ::write(st->wake[1], &c, 1);
    (void)w;
  }
  if (st->started) st->th.join();
  delete st;
  Py_END_ALLOW_THREADS
}

PyObject* raise_failure(const Failure& f) {
  switch (f.kind) {
    case kMemory:
      return PyErr_NoMemory();
    case kValue:
      PyErr_SetString(PyExc_ValueError, f.msg.c_str());
      return nullptr;
    case kErrno:
      errno = f.err;
      return PyErr_SetFromErrnoWithFilename(PyExc_OSError, f.msg.c_str());
    case kOSError:
      PyErr_SetString(PyExc_OSError, f.msg.c_str());
      return nullptr;
    case kEOF:
      PyErr_SetString(PyExc_EOFError, f.msg.c_str());
      return nullptr;
    default:
      PyErr_SetString(PyExc_RuntimeError, f.msg.c_str());
      return nullptr;
  }
}

PyObject* decode_or_none(const std::string& s, int64_t a, int64_t b) {
  if (a == b) Py_RETURN_NONE;
  return PyUnicode_DecodeUTF8(s.data() + a, (Py_ssize_t)(b - a), "strict");
}

// The batch's Read objects, made as read_cls's dataclass __init__ makes
// them (its six fields set in order, `sam` to "") without running it; seq
// a view of one uint8 array over the batch's bases.
PyObject* build(ReaderObject* self, const Batch& b) {
  PyObject* buf = PyByteArray_FromStringAndSize((const char*)b.seq.data(),
                                                (Py_ssize_t)b.seq.size());
  if (!buf) return nullptr;
  PyObject* arr = PyObject_CallOneArg(self->seq_view, buf);
  Py_DECREF(buf);
  if (!arr) return nullptr;
  PyObject* list = PyList_New((Py_ssize_t)b.n);
  if (!list) {
    Py_DECREF(arr);
    return nullptr;
  }
  PyTypeObject* tp = (PyTypeObject*)self->read_cls;
  for (int64_t i = 0; i < b.n; ++i) {
    PyObject* vals[6] = {nullptr, nullptr, nullptr, nullptr, nullptr,
                         Py_NewRef(g_empty_str)};
    vals[0] = PyUnicode_DecodeUTF8(
        b.names.data() + b.name_off[i],
        (Py_ssize_t)(b.name_off[i + 1] - b.name_off[i]), "strict");
    PyObject* lo = PyLong_FromLongLong(b.seq_off[i]);
    PyObject* hi = PyLong_FromLongLong(b.seq_off[i + 1]);
    PyObject* sl = (lo && hi) ? PySlice_New(lo, hi, nullptr) : nullptr;
    Py_XDECREF(lo);
    Py_XDECREF(hi);
    if (sl) {
      vals[1] = PyObject_GetItem(arr, sl);
      Py_DECREF(sl);
    }
    vals[2] = decode_or_none(b.quals, b.qual_off[i], b.qual_off[i + 1]);
    vals[3] = decode_or_none(b.comments, b.com_off[i], b.com_off[i + 1]);
    vals[4] = PyLong_FromLongLong(b.start_id + i);
    PyObject* r = nullptr;
    if (vals[0] && vals[1] && vals[2] && vals[3] && vals[4])
      r = tp->tp_new(tp, g_empty_tuple, nullptr);
    for (int k = 0; r && k < 6; ++k)
      if (PyObject_SetAttr(r, g_fields[k], vals[k]) < 0) Py_CLEAR(r);
    for (PyObject* v : vals) Py_XDECREF(v);
    if (!r) {
      Py_DECREF(list);
      Py_DECREF(arr);
      return nullptr;
    }
    PyList_SET_ITEM(list, (Py_ssize_t)i, r);
  }
  Py_DECREF(arr);
  return list;
}

PyObject* reader_next(ReaderObject* self, PyObject*) {
  State* st = self->st;
  if (!st) Py_RETURN_NONE;
  if (!st->started) {
    try {
      g_live.fetch_add(1);
      st->th = std::thread(&State::run, st);
      st->started = true;
    } catch (const std::exception& e) {
      g_live.fetch_sub(1);
      PyErr_Format(PyExc_RuntimeError, "cannot start the reader thread: %s",
                   e.what());
      return nullptr;
    }
  }
  std::unique_ptr<Batch> b;
  bool got = false, broken = false;
  // A batch parsed ahead is taken with the GIL held (the thread holds the
  // lock for a pointer's move at most): releasing the GIL only to take it
  // back would queue this thread behind the others for a switch interval.
  try {
    std::lock_guard<std::mutex> lk(st->mu);
    b = std::move(st->slot);
    got = b || st->done;
  } catch (...) {
    broken = true;
  }
  bool ready = b != nullptr;
  while (!got && !broken) {
    // wait in slices, so a signal reaches the interpreter between them
    Py_BEGIN_ALLOW_THREADS
    try {
      std::unique_lock<std::mutex> lk(st->mu);
      got = st->cv.wait_for(lk, std::chrono::milliseconds(100),
                            [&] { return st->slot || st->done; });
      if (got) b = std::move(st->slot);
    } catch (...) {
      broken = true;
    }
    Py_END_ALLOW_THREADS
    if (!got && !broken && PyErr_CheckSignals() < 0) return nullptr;
  }
  if (broken) {
    PyErr_SetString(PyExc_RuntimeError, "the reader's lock failed");
    return nullptr;
  }
  if (b) st->cv.notify_all();
  if (!b) {
    if (st->fail.kind == kNone) Py_RETURN_NONE;
    Failure f = st->fail;
    st->fail.kind = kNone;
    return raise_failure(f);
  }
  PyObject* reads = build(self, *b);
  if (!reads) return nullptr;
  return Py_BuildValue("(NdN)", reads, b->parse_s, PyBool_FromLong(ready));
}

PyObject* reader_close_py(ReaderObject* self, PyObject*) {
  reader_close(self);
  Py_RETURN_NONE;
}

int open_input(const char* path) {
  if (std::strcmp(path, "-") == 0) return fcntl(0, F_DUPFD_CLOEXEC, 0);
  int fd;
  do {
    fd = ::open(path, O_RDONLY | O_CLOEXEC);
  } while (fd < 0 && errno == EINTR);
  return fd;
}

int reader_init(ReaderObject* self, PyObject* args, PyObject*) {
  PyObject *p1 = nullptr, *p2 = nullptr, *cls, *view;
  long long chunk_bp, start_id;
  int interleaved;
  if (!PyArg_ParseTuple(args, "O&OLpLOO", PyUnicode_FSConverter, &p1, &p2,
                        &chunk_bp, &interleaved, &start_id, &cls, &view))
    return -1;
  PyObject* p2b = nullptr;
  if (p2 != Py_None && !PyUnicode_FSConverter(p2, &p2b)) {
    Py_DECREF(p1);
    return -1;
  }
  reader_close(self);
  Py_INCREF(cls);
  Py_XSETREF(self->read_cls, cls);
  Py_INCREF(view);
  Py_XSETREF(self->seq_view, view);
  const char* path1 = PyBytes_AS_STRING(p1);
  const char* path2 = p2b ? PyBytes_AS_STRING(p2b) : nullptr;
  int fd1 = -1, fd2 = -1, err = 0;
  const char* bad = nullptr;
  Py_BEGIN_ALLOW_THREADS  // a FIFO's open waits for its writer
  fd1 = open_input(path1);
  if (fd1 < 0) {
    err = errno;
    bad = path1;
  } else if (path2) {
    fd2 = open_input(path2);
    if (fd2 < 0) {
      err = errno;
      bad = path2;
    }
  }
  Py_END_ALLOW_THREADS
  int rc = -1;
  State* st = nullptr;
  if (bad) {
    errno = err;
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, bad);
  } else {
    try {
      st = new State();
      if (::pipe2(st->wake, O_CLOEXEC | O_NONBLOCK) != 0) {
        err = errno;
        delete st;
        st = nullptr;
        errno = err;
        PyErr_SetFromErrno(PyExc_OSError);
      } else {
        st->f1 = std::make_unique<SeqFile>(fd1, path1, &st->stop,
                                           st->wake[0]);
        fd1 = -1;
        if (path2) {
          st->f2 = std::make_unique<SeqFile>(fd2, path2, &st->stop,
                                             st->wake[0]);
          fd2 = -1;
        }
        st->chunk_bp = chunk_bp;
        st->interleaved = interleaved != 0;
        st->next_id = start_id;
        self->st = st;
        rc = 0;
      }
    } catch (const std::bad_alloc&) {
      delete st;
      PyErr_NoMemory();
    }
  }
  if (fd1 >= 0) ::close(fd1);
  if (fd2 >= 0) ::close(fd2);
  Py_DECREF(p1);
  Py_XDECREF(p2b);
  return rc;
}

PyObject* reader_new(PyTypeObject* type, PyObject*, PyObject*) {
  ReaderObject* self = (ReaderObject*)type->tp_alloc(type, 0);
  if (self) {
    self->st = nullptr;
    self->read_cls = nullptr;
    self->seq_view = nullptr;
  }
  return (PyObject*)self;
}

void reader_dealloc(ReaderObject* self) {
  reader_close(self);
  Py_XDECREF(self->read_cls);
  Py_XDECREF(self->seq_view);
  Py_TYPE(self)->tp_free((PyObject*)self);
}

PyMethodDef reader_methods[] = {
    {"next", (PyCFunction)reader_next, METH_NOARGS,
     "next() -> (reads, reader_seconds, ready), or None after the last "
     "batch"},
    {"close", (PyCFunction)reader_close_py, METH_NOARGS,
     "close() -> stop and join the reader thread"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject ReaderType = {PyVarObject_HEAD_INIT(nullptr, 0)};

PyObject* py_live_threads(PyObject*, PyObject*) {
  return PyLong_FromLong(g_live.load());
}

PyMethodDef methods[] = {
    {"live_threads", py_live_threads, METH_NOARGS,
     "live_threads() -> reader threads running in the process"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_fastq",
                                "native FASTQ/FASTA reader", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__fastq(void) {
  init_nt4();
  g_empty_tuple = PyTuple_New(0);
  g_empty_str = PyUnicode_FromString("");
  if (!g_empty_tuple || !g_empty_str) return nullptr;
  const char* f[6] = {"name", "seq", "qual", "comment", "id", "sam"};
  for (int k = 0; k < 6; ++k)
    if (!(g_fields[k] = PyUnicode_InternFromString(f[k]))) return nullptr;
  ReaderType.tp_name = "bwa_flow_tpu_torch._fastq.Reader";
  ReaderType.tp_basicsize = sizeof(ReaderObject);
  ReaderType.tp_flags = Py_TPFLAGS_DEFAULT;
  ReaderType.tp_doc = "A FASTQ/FASTA reader parsing one batch ahead";
  ReaderType.tp_new = reader_new;
  ReaderType.tp_init = (initproc)reader_init;
  ReaderType.tp_dealloc = (destructor)reader_dealloc;
  ReaderType.tp_methods = reader_methods;
  if (PyType_Ready(&ReaderType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  Py_INCREF(&ReaderType);
  if (PyModule_AddObject(m, "Reader", (PyObject*)&ReaderType) < 0) {
    Py_DECREF(&ReaderType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
