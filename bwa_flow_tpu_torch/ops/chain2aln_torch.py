"""Device coupled seed-extension tasks.

Port of bwa_flow_tpu/ops/chain2aln_jax.py. One task is one seed of one
chain: left extension (reversed query prefix vs reversed reference
window), then the right extension seeded with the left score
(mem_chain2aln, bwa/bwamem.c:716-779). Every extension runs a banded
ksw_extend2 — a CUDA kernel on the card, its plain PyTorch version on
the CPU.

Two forms, as in the JAX package:

  - the descriptor waves of the pipeline (seed_extend_desc_batch,
    DescTaskBuffer): the query and reference windows are assembled on
    the device from the resident read batch and the packed reference;
    each side runs ONE try, the int32 or the int16 core as fits_i16
    selects, and the host applies bwa's local/to-end decision, the
    band-doubling retries and the coordinates (pipeline/batch.py);
  - the coupled two-try batch over materialized windows
    (seed_extend_batch, SeedExtendTaskBuffer; parallel/mesh.py and
    entry.py call it): both sides with bwa's band doubling on the
    device, four int32 extension calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import extend_cuda, extend_torch
from .fm_torch import to_host

I32 = torch.int32
I64 = torch.int64


def _extend_impl(q: torch.Tensor, use16: bool = False):
    """The extension core for tensors on q's device: a CUDA kernel on a
    CUDA device, its plain PyTorch version on the CPU; the int16 one of
    each when use16. Nothing else decides this."""
    if q.device.type == "cuda":
        return (extend_cuda.extend_core_cuda16 if use16
                else extend_cuda.extend_core_cuda)
    if q.device.type == "cpu":
        return (extend_torch.extend_core16 if use16
                else extend_torch.extend_core)
    raise ValueError(f"unsupported device {q.device}")


def _two_tries(qmax, tmax, q, ql, t, tl, h0, mat, o_del, e_del, o_ins,
               e_ins, w0: int, end_bonus, zdrop, prev0):
    """bwa band doubling: try w, retry 2w where the score moved from its
    entry value (`prev0`: -1 for the left extension, the incoming score
    for the right) and max_off >= w/2 + w/4 (bwamem.c:737-744). Both
    tries run on every lane, as in the JAX package. Returns the selected
    6-tuple and the band used, int32[B]."""
    ext = _extend_impl(q)
    r0 = ext(qmax, tmax, q, ql, t, tl, h0, mat, o_del, e_del, o_ins, e_ins,
             w0, end_bonus, zdrop)
    need = (r0[0] != prev0) & (r0[5] >= ((w0 >> 1) + (w0 >> 2)))
    r1 = ext(qmax, tmax, q, ql, t, tl, h0, mat, o_del, e_del, o_ins, e_ins,
             w0 * 2, end_bonus, zdrop)
    out = tuple(torch.where(need, b, a) for a, b in zip(r0, r1))
    aw = torch.where(need, w0 * 2, w0).to(I32)
    return out, aw


def seed_extend_batch(qmax: int, tmax: int, ql_q, ql_n, tl_t, tl_n,
                      qr_q, qr_n, tr_t, tr_n, h0, mat, o_del, e_del, o_ins,
                      e_ins, w, pen_clip5, pen_clip3, zdrop
                      ) -> tuple[torch.Tensor, ...]:
    """Batched coupled seed extension from materialized windows (the
    counterpart of chain2aln_jax.seed_extend_batch and its _coupled).

    ql_*/tl_*: reversed left query/target (int32 [B, qmax]/[B, tmax] and
    int32[B] lengths; length 0 = no left extension); qr_*/tr_*: the
    right query/target; h0: seed_len * a; mat int32[5, 5]; all
    contiguous on one device. The scalars are ints or 0-d tensors.
    Returns 12 int32[B] tensors
      (lscore, lqle, ltle, lgtle, lgscore, aw0,
       rscore, rqle, rtle, rgtle, rgscore, aw1)
    where lanes without a left extension report lscore = h0, aw0 = w,
    and lanes without a right one rscore = lscore, aw1 = w. Each side
    runs the int32 core at w and at 2w: four launches of the int32
    kernel on a card."""
    w = extend_torch._as_int(w)
    lres, aw0 = _two_tries(qmax, tmax, ql_q, ql_n, tl_t, tl_n, h0, mat,
                           o_del, e_del, o_ins, e_ins, w, pen_clip5, zdrop,
                           torch.full_like(h0, -1))
    has_left = ql_n > 0
    # score entering the right extension: the left score, or the seed's
    lscore = torch.where(has_left, lres[0], h0).contiguous()
    aw0 = torch.where(has_left, aw0, w)
    rres, aw1 = _two_tries(qmax, tmax, qr_q, qr_n, tr_t, tr_n, lscore, mat,
                           o_del, e_del, o_ins, e_ins, w, pen_clip3, zdrop,
                           lscore)
    has_right = qr_n > 0
    rscore = torch.where(has_right, rres[0], lscore)
    aw1 = torch.where(has_right, aw1, w)
    return (lscore, lres[1], lres[2], lres[3], lres[4], aw0,
            rscore, rres[1], rres[2], rres[3], rres[4], aw1)


class SeedExtendTaskBuffer:
    """Fixed-shape host packing buffer for coupled seed-extension tasks
    (the SWTask analog, the reference's src/fpga/SWTask.cpp); run() sends
    the whole buffer through seed_extend_batch."""

    def __init__(self, cap: int, qmax: int, tmax: int):
        self.cap, self.qmax, self.tmax = cap, qmax, tmax
        self.ql_q = np.zeros((cap, qmax), np.int32)
        self.ql_n = np.zeros(cap, np.int32)
        self.tl_t = np.zeros((cap, tmax), np.int32)
        self.tl_n = np.zeros(cap, np.int32)
        self.qr_q = np.zeros((cap, qmax), np.int32)
        self.qr_n = np.zeros(cap, np.int32)
        self.tr_t = np.zeros((cap, tmax), np.int32)
        self.tr_n = np.zeros(cap, np.int32)
        self.h0 = np.ones(cap, np.int32)
        self.n = 0

    def reset(self):
        """Empty the buffer: lengths 0, h0 1 (the sequences stay, masked
        by the lengths)."""
        self.n = 0
        self.ql_n[:] = 0
        self.tl_n[:] = 0
        self.qr_n[:] = 0
        self.tr_n[:] = 0
        self.h0[:] = 1

    def add(self, q_left: np.ndarray, t_left: np.ndarray,
            q_right: np.ndarray, t_right: np.ndarray, h0: int) -> int:
        """Sequences already direction-ordered (left ones reversed).
        Returns the task slot, or -1 when a piece exceeds the buffer's
        shape or the buffer is full (the caller runs the task on the
        host)."""
        if (len(q_left) > self.qmax or len(q_right) > self.qmax
                or len(t_left) > self.tmax or len(t_right) > self.tmax
                or self.n >= self.cap):
            return -1
        i = self.n
        self.ql_q[i, :len(q_left)] = q_left
        self.ql_n[i] = len(q_left)
        self.tl_t[i, :len(t_left)] = t_left
        self.tl_n[i] = len(t_left)
        self.qr_q[i, :len(q_right)] = q_right
        self.qr_n[i] = len(q_right)
        self.tr_t[i, :len(t_right)] = t_right
        self.tr_n[i] = len(t_right)
        self.h0[i] = h0
        self.n += 1
        return i

    def run(self, opt, device=None, fetch=to_host
            ) -> tuple[np.ndarray, ...]:
        """Run every slot (all `cap`, as the JAX buffer does) on `device`
        (cuda unless the caller asks for the CPU); returns the 12 outputs
        of seed_extend_batch as int32[cap] host arrays, read with
        `fetch`."""
        dev = resolve_device(device)

        def put(a):
            return torch.as_tensor(a, device=dev)
        out = seed_extend_batch(
            self.qmax, self.tmax, put(self.ql_q), put(self.ql_n),
            put(self.tl_t), put(self.tl_n), put(self.qr_q), put(self.qr_n),
            put(self.tr_t), put(self.tr_n), put(self.h0),
            put(np.ascontiguousarray(opt.mat[:5, :5], dtype=np.int32)),
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
            opt.pen_clip5, opt.pen_clip3, opt.zdrop)
        return tuple(fetch(o) for o in out)


def _pac_window_batch(dfm, start: torch.Tensor, step_down: bool, N: int
                      ) -> torch.Tensor:
    """Decode N contiguous reference symbols per lane from the packed
    2-bit pac by word gathers. start int64[T] is the first
    forward-reverse coordinate; step_down walks start-1-j (left
    windows), else start+j. An extension window never crosses the
    forward/reverse boundary (bwa/bwamem.c:660-664), so one flip and
    complement covers the reverse strand. Out-of-range lanes read
    clipped words; callers mask by length."""
    T = start.shape[0]
    dev = start.device
    W = N // 16 + 2
    two_l = dfm.l_pac * 2
    pos0 = (start - 1 if step_down else start).clamp(0, two_l - 1)
    is_rev = pos0 >= dfm.l_pac
    fstart = torch.where(is_rev, two_l - 1 - pos0, pos0)
    # f-coordinate direction of the window walk
    down = is_rev ^ step_down
    lo = torch.where(down, fstart - (N - 1), fstart)
    base = (lo >> 4).to(I64)
    n_words = dfm.pac_words.shape[0]
    widx = (base[:, None] + torch.arange(W, dtype=I64, device=dev)[None, :]
            ).clamp(0, n_words - 1)
    words = dfm.pac_words[widx.reshape(-1)].reshape(T, W).to(I64) \
        & 0xFFFFFFFF
    # unpack 16 symbols/word: symbol s lives at bits 8*(s>>2)+6-2*(s&3)
    sh = torch.as_tensor(
        [8 * (s >> 2) + 6 - 2 * (s & 3) for s in range(16)], dtype=I64,
        device=dev)
    syms = ((words[:, :, None] >> sh[None, None, :]) & 3).to(I32).reshape(
        T, W * 16)
    # ascending-f window starts at lo & 15
    off = (lo & 15).to(I64)
    win = syms.gather(1, off[:, None] + torch.arange(N, dtype=I64,
                                                     device=dev)[None, :])
    # down-walking lanes read fpos descending; complement reverse strand
    win = torch.where(down[:, None], win.flip(1), win)
    return torch.where(is_rev[:, None], 3 - win, win)


def seed_extend_desc_batch(qmax: int, tmax: int, L_reads: int, dfm,
                           reads: torch.Tensor, desc: torch.Tensor,
                           mat: torch.Tensor, o_del, e_del, o_ins, e_ins,
                           pen_clip5, pen_clip3, zdrop, use16: bool = False
                           ) -> torch.Tensor:
    """Coupled seed extension from task DESCRIPTORS.

    reads: [B_reads, L_reads] (0..4, the seeding batch); desc: int64 or,
    narrowed (narrow_desc), int32 [11, T] (read_idx, qbeg, slen,
    l_query, rbeg, rmax0, rmax1, h0, wl, wr, skip_left). Each side runs
    ONE banded extension at its per-lane width; bwa's rare band-doubling
    retry is re-enqueued by the host driver. skip_left lanes are right-only retries whose h0 carries the
    saved left score. use16 runs both sides on the int16 core (the
    caller checks fits_i16). Returns int32[12, T]: (lscore, lqle, ltle,
    lgtle, lgscore, lmax_off, rscore, rqle, rtle, rgtle, rgscore,
    rmax_off)."""
    dev = desc.device
    T = desc.shape[1]
    read_idx = desc[0].to(I64)
    qbeg = desc[1].to(I32)
    slen = desc[2].to(I32)
    l_query = desc[3].to(I32)
    rbeg = desc[4].to(I64)
    rmax0 = desc[5].to(I64)
    rmax1 = desc[6].to(I64)
    h0 = desc[7].to(I32)
    wl = desc[8].to(I32).contiguous()
    wr = desc[9].to(I32).contiguous()
    skip_left = desc[10] != 0
    jq = torch.arange(qmax, dtype=I32, device=dev)[None, :]
    jt = torch.arange(tmax, dtype=I32, device=dev)[None, :]
    reads_flat = reads.reshape(-1)

    def read_gather(pos):
        idx = read_idx[:, None] * L_reads + pos.clamp(0, L_reads - 1)
        return reads_flat[idx.reshape(-1)].reshape(T, -1).to(I32)

    # left: query[qbeg-1-j], target pac[rbeg-1-j]; target spans clamp to
    # qlen_side + w + 1: the banded DP never reaches target rows beyond
    # qlen + w, so the clamp is exact
    ql_n = torch.where(skip_left, 0, qbeg)
    ql_q = read_gather(qbeg[:, None] - 1 - jq)
    ql_q = torch.where(jq < ql_n[:, None], ql_q, 0)
    tl_n = torch.where(skip_left, 0,
                       torch.minimum((rbeg - rmax0).to(I32),
                                     torch.clamp_max(qbeg + wl + 1, tmax)))
    tl_t = _pac_window_batch(dfm, rbeg, True, tmax)
    tl_t = torch.where(jt < tl_n[:, None], tl_t, 0)
    # right: query[qe+j], target pac[rbeg+slen+j]
    qe = qbeg + slen
    qr_n = torch.clamp_min(l_query - qe, 0)
    qr_q = read_gather(qe[:, None] + jq)
    qr_q = torch.where(jq < qr_n[:, None], qr_q, 0)
    re_abs = rbeg + slen.to(I64)
    tr_n = torch.minimum((rmax1 - re_abs).clamp(0, tmax).to(I32),
                         qr_n + wr + 1)
    tr_t = _pac_window_batch(dfm, re_abs, False, tmax)
    tr_t = torch.where(jt < tr_n[:, None], tr_t, 0)

    ext = _extend_impl(ql_q, use16)
    lres = ext(qmax, tmax, ql_q.contiguous(), ql_n.contiguous(),
               tl_t.contiguous(), tl_n.contiguous(), h0.contiguous(), mat,
               o_del, e_del, o_ins, e_ins, wl, pen_clip5, zdrop)
    has_left = ql_n > 0
    lscore = torch.where(has_left, lres[0], h0)
    rres = ext(qmax, tmax, qr_q.contiguous(), qr_n.contiguous(),
               tr_t.contiguous(), tr_n.contiguous(), lscore.contiguous(),
               mat, o_del, e_del, o_ins, e_ins, wr, pen_clip3, zdrop)
    has_right = qr_n > 0
    rscore = torch.where(has_right, rres[0], lscore)
    out = (lscore, lres[1], lres[2], lres[3], lres[4], lres[5],
           rscore, rres[1], rres[2], rres[3], rres[4], rres[5])
    return torch.stack([o.to(I32) for o in out])


def narrow_desc(desc: np.ndarray) -> np.ndarray:
    """Halve a descriptor block's upload bytes when every value (in
    particular the genome coordinates in rows 4-6) fits int32 — true for
    any genome under 1 Gbp (seq_len = 2*l_pac < 2^31).
    seed_extend_desc_batch widens the coordinate rows back to int64."""
    if desc.dtype == np.int64 and int(desc.max(initial=0)) < 2**31 \
            and int(desc.min(initial=0)) > -(2**31):
        return desc.astype(np.int32)
    return desc


class DescTaskBuffer:
    """Descriptor-only task buffer: ~100 bytes per task go to the device;
    the windows assemble there (seed_extend_desc_batch)."""

    def __init__(self, cap: int, qmax: int, tmax: int):
        self.cap, self.qmax, self.tmax = cap, qmax, tmax
        self.desc = np.zeros((11, cap), np.int64)
        self.reset()

    def reset(self):
        self.n = 0
        self.desc[:] = 0
        self.desc[7] = 1   # h0 must stay positive for padding lanes
        self.desc[8] = 1   # band widths positive for padding lanes
        self.desc[9] = 1

    def add(self, task, read_idx: int, wl: int, wr: int,
            skip_left: bool = False, h0: int | None = None) -> int:
        """Returns the slot, or -1 when the task exceeds the device
        shapes or its read is not device-resident (host fallback).
        wl/wr are the per-side band widths of this try; skip_left + h0
        enqueue a right-only retry seeded with the saved left score."""
        d = task
        # spans clamped to qlen_side + w + 1 (exact; see above)
        qr_side = d.l_query - (d.qbeg + d.slen)
        if (read_idx < 0 or self.n >= self.cap
                or d.qbeg > self.qmax
                or qr_side > self.qmax
                or min(d.rbeg - d.rmax0, d.qbeg + wl + 1) > self.tmax
                or min(d.rmax1 - (d.rbeg + d.slen),
                       qr_side + wr + 1) > self.tmax):
            return -1
        i = self.n
        self.desc[:, i] = (read_idx, d.qbeg, d.slen, d.l_query, d.rbeg,
                           d.rmax0, d.rmax1,
                           d.h0 if h0 is None else h0, wl, wr,
                           1 if skip_left else 0)
        self.n += 1
        return i

    def _params(self, opt, device, put=None):
        """Scoring constants: the matrix uploaded once per device, through
        `put(array, device)` when given (a caller's watched upload). A
        CUDA device without an index means the current card, the one
        the matrix lands on, so the next call finds it cached."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        cache = getattr(self, "_params_cache", None)
        if cache is None or cache[0].device != device:
            mat = np.ascontiguousarray(opt.mat[:5, :5], np.int32)
            cache = (put(mat, device) if put is not None
                     else torch.as_tensor(mat, device=device),
                     int(opt.o_del), int(opt.e_del), int(opt.o_ins),
                     int(opt.e_ins), int(opt.pen_clip5),
                     int(opt.pen_clip3), int(opt.zdrop))
            self._params_cache = cache
        return cache

    def run(self, opt, dfm, reads_dev, L_reads: int, fetch=to_host
            ) -> np.ndarray:
        """Run the wave; returns int32[12, n] on the host, read with
        `fetch`."""
        return fetch(self.run_async(opt, dfm, reads_dev, L_reads))

    def run_async(self, opt, dfm, reads_dev, L_reads: int) -> torch.Tensor:
        """Enqueue the wave over the filled slots; returns the device
        result tensor int32[12, n] (its host copy waits for the
        device). The int16 core runs when fits_i16 selects it for the
        largest starting score a task can carry, L_reads * a."""
        dev = reads_dev.device
        desc = torch.as_tensor(self.desc[:, :max(self.n, 1)], device=dev)
        use16 = extend_cuda.fits_i16(self.qmax, L_reads * int(opt.a),
                                     int(opt.mat.max()),
                                     max(opt.pen_clip5, opt.pen_clip3, 0))
        return seed_extend_desc_batch(self.qmax, self.tmax, L_reads, dfm,
                                      reads_dev, desc,
                                      *self._params(opt, dev), use16=use16)
