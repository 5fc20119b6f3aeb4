// The seed program's pass 2 forward scans (re-seeding long low-occurrence
// SMEMs from their middle), four threads a task lane, on NVIDIA Hopper
// (sm_90a).
//
// Replaces the XLA while_loop of bwa_flow_tpu/ops/smem_jax.py:350
// (_fwd_scan_machine, :318-353, in task mode). Same contract as the plain
// PyTorch version bwa_flow_tpu_torch/ops/smem_torch.py::_fwd_scan_machine:
// each lane arrives in mode 1 (a task: pivot x, start interval, min_intv)
// or 3 (an empty lane), extends forward one read symbol a step, records a
// break interval (ik, then (ik_info, x, g)) into its [3, NB] stores
// whenever the interval changes or the scan ends, and stops (mode 3) when
// its interval dies below min_intv, the read ends, or its stores are full
// (overflow). This is _fwd_post written out for one lane.
//
// As in seed_p1p3.cu, a lane in mode 3 is a fixed point and reads nothing
// of another lane, so running each lane alone to mode 3 or ITERS steps
// gives the plain version's state bit for bit; the state arrays are
// updated in place (the wrapper passes copies).
//
// What bounds it on the H100: the latency of a lane's chain of dependent
// FM row gathers (the index in L2), not bytes. The lanes are the task
// pool of smem_torch._compact: a dense prefix of live tasks, then empty
// mode-3 lanes, and the live count is not known on the host (reading it
// would wait for the card). The design, after seed_p1p3.cu's:
//   - a quad of threads runs one lane (seed_quad.cuh): thread j counts
//     word j of the one-symbol probe's rows, two shuffles sum the counts,
//     and thread j stores row j of a break record;
//   - lanes are dealt to blocks in turn, lane = local lane x gridDim.x +
//     blockIdx.x (smem_cuda.fwd_geometry picks blocks of 32, 16 or 8
//     lanes so that every SM gets a block), so the first k lanes, the
//     live prefix, land on min(k, blocks) distinct blocks and so on every
//     SM, without the count;
//   - the read's next symbol is loaded beside this step's rows, so a step
//     waits on one gather;
//   - nothing is indexed by a runtime value, so nothing goes to the stack.

#include <cstdint>
#include <cuda_runtime.h>

#include "seed_fm.cuh"
#include "seed_quad.cuh"

namespace {

using seedfm::clampi;
using seedfm::FM;
using seedquad::pick3;
using seedquad::probe;
using seedquad::Quad;

template <typename T>
struct FwdArgs {
  int NL, L, NB, iters;
  const int32_t* q;        // [reads * L] read symbols (pad 4)
  const int32_t* read_id;  // [NL]
  const int32_t* qlen;     // [NL]
  const T* mi;             // [NL] min_intv of each task
  int32_t *mode, *x, *i, *info, *g, *nb;
  T* ik;                   // [NL, 3]
  T* brk_kls;              // [NL, 3, NB]
  int32_t* brk_meta;       // [NL, 3, NB]
  uint8_t* ovf;
};

template <typename T>
__global__ void __launch_bounds__(128)
    fwd_kernel(FwdArgs<T> a, const void* blocks, const T* L2,
               long long seq_len, long long primary) {
  // lanes dealt to the blocks in turn (smem_cuda.fwd_geometry)
  const int b = (int)(threadIdx.x >> 2) * (int)gridDim.x + (int)blockIdx.x;
  if (b >= a.NL) return;   // a quad shares its lane, so all 4 leave
  const Quad q(threadIdx.x);
  int mode = a.mode[b];
  const int NB = a.NB;
  int x = a.x[b], i = a.i[b], ik_info = a.info[b], g = a.g[b];
  int nb = a.nb[b];
  bool ovf = a.ovf[b] != 0;
  T k = a.ik[3 * b], l = a.ik[3 * b + 1], s = a.ik[3 * b + 2];
  if (mode == 1) {
    const FM<T> fm(blocks, L2, seq_len, primary);
    const int L = a.L;
    const int32_t* qr = a.q + (long long)a.read_id[b] * L;
    const int qlen = a.qlen[b];
    const T mi = a.mi[b];
    T* kls = a.brk_kls + (long long)b * 3 * NB;
    int32_t* meta = a.brk_meta + (long long)b * 3 * NB;
    int q_i = __ldg(qr + clampi(i, 0, L - 1));
    // task mode: a lane is in mode 1 or 3; one in any other mode never
    // changes (the plain version's step leaves it as it is)
    for (int it = 0; it < a.iters; ++it) {
      // the next step's symbol, in flight beside this step's rows
      const int qn = __ldg(qr + clampi(i + 1, 0, L - 1));
      T ok, ol, os;
      probe(fm, q, k, l, s, clampi(3 - q_i, 0, 3), ok, ol, os);
      const bool end_now = i >= qlen || q_i > 3;
      const bool changed = os != s;
      const bool die = changed && os < mi;
      const bool push = end_now || changed;
      const bool to_next = end_now || die;
      bool nb_ovf = false;
      if (push) {
        if (nb >= NB) {
          nb_ovf = true;
        } else {
          if (q.j < 3) {   // thread j stores row j
            kls[q.j * NB + nb] = pick3(q.j, k, l, s);
            meta[q.j * NB + nb] = pick3(q.j, ik_info, x, g);
          }
          ++nb;
        }
      }
      if (!to_next) {
        k = ok;
        l = ol;
        s = os;
        ik_info = i + 1;
        i = i + 1;
        q_i = qn;
      } else {
        mode = 3;
      }
      if (nb_ovf) {
        mode = 3;
        ovf = true;
      }
      if (mode != 1) break;
    }
  }
  if (q.j == 0) {
    a.mode[b] = mode;
    a.i[b] = i;
    a.info[b] = ik_info;
    a.nb[b] = nb;
    a.ovf[b] = (ovf || mode != 3) ? 1 : 0;
  }
  if (q.j < 3) a.ik[3 * b + q.j] = pick3(q.j, k, l, s);
}

template <typename T>
int launch(int NL, int L, int NB, int iters, int threads, void* const* p,
           const void* blocks, const void* L2, long long seq_len,
           long long primary, cudaStream_t stream) {
  if (threads <= 0 || threads > 128 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  FwdArgs<T> a;
  a.NL = NL; a.L = L; a.NB = NB; a.iters = iters;
  a.q = (const int32_t*)p[0];
  a.read_id = (const int32_t*)p[1];
  a.qlen = (const int32_t*)p[2];
  a.mi = (const T*)p[3];
  a.mode = (int32_t*)p[4]; a.x = (int32_t*)p[5]; a.i = (int32_t*)p[6];
  a.info = (int32_t*)p[7]; a.g = (int32_t*)p[8]; a.nb = (int32_t*)p[9];
  a.ik = (T*)p[10]; a.brk_kls = (T*)p[11]; a.brk_meta = (int32_t*)p[12];
  a.ovf = (uint8_t*)p[13];
  const long long n = 4LL * NL;   // four threads a lane
  if (n > 0)
    fwd_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    stream>>>(a, blocks, (const T*)L2, seq_len, primary);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, read_id, qlen, mi, mode, x, i, ik_info, g, nb, ik, brk_kls,
// brk_meta, ovf. wide: coordinates int64 (else int32). threads: a block's
// threads, a multiple of 32 up to 128 (four a lane). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a block size it does
// not take.
extern "C" int seed_fwd_launch(int wide, int threads, int NL, int L, int NB,
                               int iters, void* const* ptrs,
                               const void* fm_blocks, const void* L2,
                               long long seq_len, long long primary,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return launch<int64_t>(NL, L, NB, iters, threads, ptrs, fm_blocks, L2,
                           seq_len, primary, s);
  return launch<int32_t>(NL, L, NB, iters, threads, ptrs, fm_blocks, L2,
                         seq_len, primary, s);
}

extern "C" const char* seed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
