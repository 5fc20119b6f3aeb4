// ks_introsort port (shared header) — see bwa_flow_tpu/utils/ksort.py:
// a faithful replication of klib's element movements, which decide the
// order of equal keys and hence bit-level output (chain filter ties,
// dedup end-position ties). Differentially tested via the Python port.

#ifndef BWA_FLOW_TPU_INTROSORT_H
#define BWA_FLOW_TPU_INTROSORT_H

#include <cstdint>
#include <utility>
#include <vector>

namespace bwaflow {

template <typename T, typename LT>
void insertsort(T* a, int64_t s, int64_t t, LT lt) {
  for (int64_t i = s + 1; i < t; ++i)
    for (int64_t j = i; j > s && lt(a[j], a[j - 1]); --j)
      std::swap(a[j], a[j - 1]);
}

template <typename T, typename LT>
void combsort(T* a, int64_t s, int64_t n, LT lt) {
  const double shrink = 1.2473309501039786540366528676643;
  int64_t gap = n;
  bool do_swap;
  do {
    if (gap > 2) {
      gap = (int64_t)(gap / shrink);
      if (gap == 9 || gap == 10) gap = 11;
    }
    do_swap = false;
    for (int64_t i = s; i < s + n - gap; ++i) {
      if (lt(a[i + gap], a[i])) {
        std::swap(a[i], a[i + gap]);
        do_swap = true;
      }
    }
  } while (do_swap || gap > 2);
  if (gap != 1) insertsort(a, s, s + n, lt);
}

template <typename T, typename LT>
void ks_introsort(std::vector<T>& v, LT lt) {
  int64_t n = (int64_t)v.size();
  T* a = v.data();
  if (n < 1) return;
  if (n == 2) {
    if (lt(a[1], a[0])) std::swap(a[0], a[1]);
    return;
  }
  int d = 2;
  while ((1ll << d) < n) ++d;
  struct Frame { int64_t s, t; int d; };
  std::vector<Frame> stack;
  int64_t s = 0, t = n - 1;
  d <<= 1;
  while (true) {
    if (s < t) {
      if (--d == 0) {
        combsort(a, s, t - s + 1, lt);
        t = s;
        continue;
      }
      int64_t i = s, j = t, k = i + ((j - i) >> 1) + 1;
      if (lt(a[k], a[i])) {
        if (lt(a[k], a[j])) k = j;
      } else {
        k = lt(a[j], a[i]) ? i : j;
      }
      T rp = a[k];
      if (k != t) std::swap(a[k], a[t]);
      while (true) {
        do ++i; while (lt(a[i], rp));
        do --j; while (i <= j && lt(rp, a[j]));
        if (j <= i) break;
        std::swap(a[i], a[j]);
      }
      std::swap(a[i], a[t]);
      if (i - s > t - i) {
        if (i - s > 16) stack.push_back({s, i - 1, d});
        s = (t - i > 16) ? i + 1 : t;
      } else {
        if (t - i > 16) stack.push_back({i + 1, t, d});
        t = (i - s > 16) ? i - 1 : s;
      }
    } else {
      if (stack.empty()) {
        insertsort(a, 0, n, lt);
        return;
      }
      Frame f = stack.back();
      stack.pop_back();
      s = f.s; t = f.t; d = f.d;
    }
  }
}


}  // namespace bwaflow

#endif  // BWA_FLOW_TPU_INTROSORT_H
