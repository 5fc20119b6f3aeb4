// C++ exceptions and released-GIL regions, for the host libraries.
//
// A C++ exception must not leave a Py_BEGIN_ALLOW_THREADS region: it
// would skip Py_END_ALLOW_THREADS, and a handler outside the region
// would set the Python error without the GIL, which aborts the
// interpreter. run_nogil runs a region's body and records what it threw
// (std::bad_alloc, or another exception's message); once the region has
// ended, the caller raises it with the GIL held. run_threads starts
// worker threads so that a failed start joins the ones already running
// before it throws (a joinable std::thread's destructor terminates the
// process).

#pragma once

#include <Python.h>

#include <cstdio>
#include <exception>
#include <new>
#include <thread>
#include <vector>

namespace bwaflow {

struct NoGilError {
  int kind = 0;  // 0: nothing thrown, 1: std::bad_alloc, 2: another
  char msg[512] = {0};

  explicit operator bool() const { return kind != 0; }

  void set(const char* what) noexcept {
    kind = 2;
    std::snprintf(msg, sizeof msg, "%s", what);
  }

  // With the GIL held: MemoryError for std::bad_alloc, else `type` with
  // the exception's message. Returns nullptr, for `return err.raise();`.
  PyObject* raise(PyObject* type) const {
    if (kind == 1) return PyErr_NoMemory();
    PyErr_SetString(type, msg);
    return nullptr;
  }
};

template <class F>
void run_nogil(NoGilError* err, F&& body) noexcept {
  try {
    body();
  } catch (const std::bad_alloc&) {
    err->kind = 1;
  } catch (const std::exception& e) {
    err->set(e.what());
  } catch (...) {
    err->set("unknown C++ exception");
  }
}

// Run fn(t) for t in [0, n) on n threads and join them all. fn must not
// throw; a thread that cannot start makes this join the started ones and
// rethrow.
template <class F>
void run_threads(int n, F&& fn) {
  std::vector<std::thread> th;
  th.reserve((size_t)(n > 0 ? n : 1));
  try {
    for (int t = 0; t < n; ++t) th.emplace_back([&fn, t]() { fn(t); });
  } catch (...) {
    for (auto& x : th) x.join();
    throw;
  }
  for (auto& x : th) x.join();
}

}  // namespace bwaflow
