"""Device SMEM seeding in PyTorch — a batched FM-index state machine.

Port of bwa_flow_tpu/ops/smem_jax.py (mem_collect_intv,
bwa/bwamem.c:120-168): the same three passes, machines, budgets and
overflow bits, as plain torch ops on the device.

For break intervals processed longest-forward-first, backward death
steps r_j are non-increasing (containment), and bwa emits exactly the
first interval of each distinct-r cohort, with its own (k, l, s) state at
maximal backward reach. So every forward break walks back independently
and the emission rule runs afterwards as array ops; the output is
exactly bwa's bwt_smem1a semantics.

Passes: (1) all SMEMs from scanning pivots — a forward scan recording
break intervals, fused with (3) LAST-like forward seeding
(bwa/bwt.c:358-379) into one loop; then a batch-parallel backward
worklist walk and cohort emission; (2) re-seeding of long low-occ SMEMs
from their middle with min_intv = s+1, one lane per task. Results are
sorted by `info` on the device, and the seeds' SA values are resolved in
the same call (dense-SA gather, or the phased LF walk). Budgets are
fixed; a read that exhausts one sets an OVF_* bit and is redone by
big-budget device calls (two levels, the second doubling the first's
budgets), then by the host golden.

The three machines and cohort emission (the XLA loops of smem_jax) are
hand-written CUDA kernels on the card (ops/smem_cuda.py, csrc/seed_*.cu),
each machine lane run to its end by one thread or a quad, and the fused
SA walk of an index without a dense SA is the sa_walk kernel
(fm_torch.sa_batch, ops/fm_cuda.py), so on the card the seed program
reads nothing from the device until its caller fetches the result. Each
kernel's plain version stays here (_p1p3_machine, _fwd_scan_machine,
_bwd_walk_machine, _cohort_emit), and the dispatching wrappers
(p1p3_machine, fwd_scan_machine, bwd_walk_machine, cohort_emit; their
device test is fm_torch._on_card) take it only for
tensors on the CPU. A plain machine is a Python loop over torch steps
whose stop condition is read from the device every CHECK_EVERY steps (a
step on finished lanes changes nothing, so the extra steps are no-ops).
Every such read, and every copy of a result to the host, goes through
the `fetch` argument (fm_torch.to_host by default; the batch aligner
passes its watchdog). Scatters with a drop sentinel write into buffers
with one spare trailing slot that absorbs every dropped index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..index.io import wide
from ..utils.opts import MemOpt
from ..utils.trace import GLOBAL as tracer
from . import smem as smem_golden
from . import smem_cuda
from .fm_torch import (DeviceFM, _on_card, occ4_batch, sa_batch,
                       set_intv_batch, to_host)

I32 = torch.int32
I64 = torch.int64
BIG32 = 1 << 30
# machine steps between host reads of the loop condition
CHECK_EVERY = 8


def _ar(n: int, dev, dt=I32) -> torch.Tensor:
    return torch.arange(n, dtype=dt, device=dev)


def _scatter_set_(buf: torch.Tensor, idx: torch.Tensor, vals) -> None:
    """buf[idx] = vals in place; buf's last slot is the drop sentinel and
    every idx >= len(buf) - 1 lands there."""
    buf.index_put_((idx.clamp_max(buf.shape[0] - 1).long(),),
                   vals.to(buf.dtype) if isinstance(vals, torch.Tensor)
                   else torch.as_tensor(vals, dtype=buf.dtype,
                                        device=buf.device))


def _set_drop(n: int, idx, vals, dt, dev) -> torch.Tensor:
    """zeros(n).at[idx].set(vals, mode="drop")."""
    buf = torch.zeros(n + 1, dtype=dt, device=dev)
    _scatter_set_(buf, idx, vals)
    return buf[:n]


def _max_drop(n: int, idx, vals, dev) -> torch.Tensor:
    """zeros(n, int32).at[idx].max(vals, mode="drop")."""
    buf = torch.zeros(n + 1, dtype=I32, device=dev)
    buf.scatter_reduce_(0, idx.clamp_max(n).long(), vals.to(I32), "amax",
                        include_self=True)
    return buf[:n]


def _run(step, s, running, iters: int, fetch):
    """while it < iters and running(s): s = step(s), with the condition
    (a 0-d bool tensor) read by `fetch` every CHECK_EVERY steps."""
    it = 0
    while it < iters and fetch(running(s)):
        for _ in range(min(CHECK_EVERY, iters - it)):
            s = step(s)
        it += min(CHECK_EVERY, iters - it)
    return s


def bwt_extend_dir_batch(dfm: DeviceFM, ik: torch.Tensor,
                         is_back: torch.Tensor) -> torch.Tensor:
    """bwt_extend with a per-lane direction flag (bwa/bwt.c:262-275).
    ik: [B, 3]; is_back: bool[B]. Returns ok [B, 4, 3]; the two occ
    probes are shared between directions."""
    B = ik.shape[0]
    probe = torch.where(is_back, ik[:, 0], ik[:, 1])
    s = ik[:, 2]
    occ2 = occ4_batch(dfm, torch.cat([probe - 1, probe - 1 + s]))
    tk, tl = occ2[:B], occ2[B:]
    ok_probe = dfm.L2[:4] + 1 + tk                        # [B, 4]
    ok_s = tl - tk
    crosses = ((probe <= dfm.primary) & (probe + s - 1 >= dfm.primary)
               ).to(ik.dtype)
    b3 = torch.where(is_back, ik[:, 1], ik[:, 0]) + crosses
    b2 = b3 + ok_s[:, 3]
    b1 = b2 + ok_s[:, 2]
    b0 = b1 + ok_s[:, 1]
    derived = torch.stack([b0, b1, b2, b3], dim=-1)
    isb = is_back[:, None]
    ok_k = torch.where(isb, ok_probe, derived)
    ok_l = torch.where(isb, derived, ok_probe)
    return torch.stack([ok_k, ok_l, ok_s], dim=-1)


def _pack_info(start, end, dt):
    """mem info sort key. Wide: start<<32|end (bwa's uint64_t info,
    bwa/bwt.c:311). Narrow (int32 coords, reads < 32768 bp):
    start<<16|end — the same lexicographic order."""
    if dt == I32:
        return ((start.to(I32) << 16) | end.to(I32)).to(I32)
    return (start.to(I64) << 32) | end.to(I64)


INFO_SHIFT = {np.dtype(np.int32): 16, np.dtype(np.int64): 32}


def _take_row(arr, idx):
    """arr[b, idx[b], :] for [B, 4, 3] arrays (idx in [0, 4))."""
    return arr.gather(1, idx.long()[:, None, None].expand(-1, 1,
                                                          arr.shape[2]))[:, 0]


def _scatter_slot_(buf, shape, idx, val, do) -> None:
    """buf viewed as [NL, K, N] (+1 sentinel slot): buf[b, :, idx[b]] =
    val[b, :] where do[b], in place."""
    NL, K, N = shape
    dev = buf.device
    base = torch.where(do, _ar(NL, dev) * (K * N) + idx, NL * K * N)
    flat_idx = (base[:, None] + _ar(K, dev)[None, :] * N).reshape(-1)
    _scatter_set_(buf, flat_idx, val.reshape(-1))


def _view3(buf, shape):
    return buf[:-1].view(shape)


def _p3_pre2(dfm: DeviceFM, L: int, val, s):
    """Pass-3 pivot acquisition from one prefetched sym-table value."""
    mode = s["mode"]
    m0 = mode == 0
    cand = torch.where(s["x"] < L, val >> 6, L)
    found = cand < L
    start = m0 & found
    x = torch.where(start, cand, s["x"])
    mode = torch.where(m0, torch.where(found, 1, 3).to(I32), mode)
    init_ik = set_intv_batch(dfm, ((val >> 3) & 7).clamp(0, 3))
    return dict(s, mode=mode, x=x,
                ik=torch.where(start[:, None], init_ik, s["ik"]),
                i=torch.where(start, x + 1, s["i"])), val & 7


def _p3_post(NP3: int, qlen, min_seed_len, max_mem_intv, s, ok, q_i):
    """Pass-3 step after the shared occ probe."""
    mode, x, i, ik = s["mode"], s["x"], s["i"], s["ik"]
    B = mode.shape[0]
    m1 = mode == 1
    ended = m1 & (i >= qlen)          # loop exhausted: jump to len
    amb = m1 & ~ended & (q_i > 3)     # N base: jump to i+1, no seed
    live = m1 & ~ended & ~amb
    cf = (3 - q_i).clamp(0, 3)
    okc = _take_row(ok, cf)
    hit = live & (okc[:, 2] < max_mem_intv) & ((i - x) >= min_seed_len)
    emit = hit & (okc[:, 2] > 0)
    info = _pack_info(x, i + 1, okc.dtype)
    new_mem = torch.cat([okc, info[:, None]], dim=1)
    mem_ovf = emit & (s["n_mem"] >= NP3)
    _scatter_slot_(s["mems"], (B, 4, NP3), s["n_mem"], new_mem,
                   emit & ~mem_ovf)
    n_mem = torch.where(emit & ~mem_ovf, s["n_mem"] + 1, s["n_mem"])
    walk = live & ~hit
    ik = torch.where(walk[:, None], okc, ik)
    i2 = torch.where(walk, i + 1, i)
    # pivot jumps
    x = torch.where(ended, qlen, torch.where(amb | hit, i + 1, x))
    mode = torch.where(ended | amb | hit, 0, mode).to(I32)
    return dict(s, mode=mode, x=x, i=i2, ik=ik, n_mem=n_mem,
                ovf=s["ovf"] | mem_ovf)


def _fwd_pre2(dfm: DeviceFM, L: int, val, s):
    """Pass-1 mode-0 pivot acquisition from one prefetched sym-table
    value. Returns (state, q_i)."""
    mode, x = s["mode"], s["x"]
    m0 = mode == 0
    cand = torch.where(x < L, val >> 6, L)
    found = cand < L
    start = m0 & found
    x = torch.where(start, cand, x)
    mode = torch.where(m0, torch.where(found, 1, 3).to(I32), mode)
    init_ik = set_intv_batch(dfm, ((val >> 3) & 7).clamp(0, 3))
    return dict(s, mode=mode, x=x,
                ik=torch.where(start[:, None], init_ik, s["ik"]),
                ik_info=torch.where(start, x + 1, s["ik_info"]),
                i=torch.where(start, x + 1, s["i"]),
                g=torch.where(start, s["g"] + 1, s["g"])), val & 7


def _fwd_post(NB: int, qlen_l, mi, task_mode: bool, s, ok, q_i):
    """Forward-scan step after the shared occ probe."""
    mode, x, i, ik, ik_info, g, nb = (s["mode"], s["x"], s["i"], s["ik"],
                                      s["ik_info"], s["g"], s["nb"])
    NL = mode.shape[0]
    m1 = mode == 1
    end_now = m1 & ((i >= qlen_l) | (q_i > 3))
    cf = (3 - q_i).clamp(0, 3)
    okc = _take_row(ok, cf)
    changed = okc[:, 2] != ik[:, 2]
    die = changed & (okc[:, 2] < mi)
    push = m1 & (end_now | changed)
    to_next = m1 & (end_now | die)
    adv = m1 & ~to_next

    nb_ovf = push & (nb >= NB)
    do = push & ~nb_ovf
    _scatter_slot_(s["brk_kls"], (NL, 3, NB), nb, ik, do)
    _scatter_slot_(s["brk_meta"], (NL, 3, NB), nb,
                   torch.stack([ik_info, x, g], dim=1), do)
    nb = torch.where(do, nb + 1, nb)

    ik = torch.where(adv[:, None], okc, ik)
    ik_info = torch.where(adv, i + 1, ik_info)
    i = torch.where(adv, i + 1, i)
    if task_mode:
        mode = torch.where(to_next, 3, mode)
    else:
        # next pivot = end of longest match (= last push's end)
        x = torch.where(to_next, ik_info, x)
        mode = torch.where(to_next, 0, mode)
    mode = torch.where(nb_ovf, 3, mode).to(I32)
    return dict(s, mode=mode, x=x, i=i, ik=ik, ik_info=ik_info, g=g,
                nb=nb, ovf=s["ovf"] | nb_ovf)


def _sym_tab(q2, qlen2, L: int):
    """Packed per-position lookup table, ONE [2*B*L] int32 array:
    [0, B*L) the plain symbols q[b, j]; [B*L, 2*B*L) nv[b, j] =
    (p << 6) | (q[b, p] << 3) | q[b, p+1] where p is the smallest valid
    pivot position >= j (j' < qlen and q < 4), or p = L when none. A
    scan lane needs either the next pivot (mode 0) or the symbol at i
    (mode 1), never both, so one gather per lane serves both. nv is a
    reverse cummin: the position sits in the high bits."""
    B2 = q2.shape[0]
    dev = q2.device
    jl = _ar(L, dev)[None, :]
    valid_base = (jl < qlen2[:, None]) & (q2 < 4)
    q_next = torch.cat([q2[:, 1:], torch.full((B2, 1), 4, dtype=q2.dtype,
                                              device=dev)], dim=1)
    packed = torch.where(valid_base, (jl << 6) | (q2 << 3) | q_next, L << 6)
    nv = torch.cummin(packed.flip(1), dim=1).values.flip(1)
    return torch.cat([q2.reshape(-1), nv.reshape(-1)]).to(I32)


def _fresh(NL: int, NBc: int, dt, dev) -> dict:
    z = torch.zeros(NL, dtype=I32, device=dev)
    return dict(
        mode=z.clone(), x=z.clone(), i=z.clone(),
        ik=torch.zeros((NL, 3), dtype=dt, device=dev),
        ik_info=z.clone(), g=z.clone(), nb=z.clone(),
        # flat [NL, 3, NBc] break stores + one drop-sentinel slot
        brk_kls=torch.zeros(NL * 3 * NBc + 1, dtype=dt, device=dev),
        brk_meta=torch.zeros(NL * 3 * NBc + 1, dtype=I32, device=dev),
        ovf=torch.zeros(NL, dtype=torch.bool, device=dev))


def _fwd_scan_machine(dfm: DeviceFM, L: int, NB: int, ITERS: int,
                      q_flat, read_id, qlen_l, mi, st0, fetch):
    """Pass-2 forward scans (task mode: lanes arrive initialized in mode
    1/3; no pivot acquisition), recording break intervals."""
    NL = st0["mode"].shape[0]
    dev = q_flat.device
    back = torch.zeros(NL, dtype=torch.bool, device=dev)

    def step(s):
        q_i = q_flat[(read_id * L + s["i"].clamp(0, L - 1)).long()]
        ok = bwt_extend_dir_batch(dfm, s["ik"], back)
        return _fwd_post(NB, qlen_l, mi, True, s, ok, q_i)

    out = _run(step, st0, lambda s: (s["mode"] != 3).any(), ITERS, fetch)
    out["ovf"] = out["ovf"] | (out["mode"] != 3)
    return out


def _p1p3_machine(dfm: DeviceFM, L: int, NB: int, ITERS: int, read_id,
                  qlen_l, st1, q2, qlen2, NP3: int, min_seed_len,
                  max_mem_intv, st3, fetch):
    """Pass 1's forward scan and pass 3, fused into ONE loop: both are
    serial per-read scans of ~qlen steps over a shared batched
    bwt_extend, so their 2B lanes share one probe per step."""
    B = st1["mode"].shape[0]
    dev = q2.device
    sym = _sym_tab(q2, qlen2, L)
    BL = B * L
    mi1 = torch.ones(B, dtype=st1["ik"].dtype, device=dev)
    rid3 = _ar(B, dev)
    back = torch.zeros(2 * B, dtype=torch.bool, device=dev)

    def step(s):
        s1, s3 = s
        m0_1 = s1["mode"] == 0
        m0_3 = s3["mode"] == 0
        idx = torch.cat([
            read_id * L + torch.where(m0_1, s1["x"].clamp(0, L - 1) + BL,
                                      s1["i"].clamp(0, L - 1)),
            rid3 * L + torch.where(m0_3, s3["x"].clamp(0, L - 1) + BL,
                                   s3["i"].clamp(0, L - 1))])
        vals = sym[idx.long()]
        s1, q_i1 = _fwd_pre2(dfm, L, vals[:B], s1)
        s3, q_i3 = _p3_pre2(dfm, L, vals[B:], s3)
        ok = bwt_extend_dir_batch(dfm, torch.cat([s1["ik"], s3["ik"]]),
                                  back)
        s1 = _fwd_post(NB, qlen_l, mi1, False, s1, ok[:B], q_i1)
        s3 = _p3_post(NP3, qlen2, min_seed_len, max_mem_intv, s3, ok[B:],
                      q_i3)
        return s1, s3

    s1, s3 = _run(step, (st1, st3),
                  lambda s: ((s[0]["mode"] != 3) | (s[1]["mode"] != 3)).any(),
                  ITERS, fetch)
    s1["ovf"] = s1["ovf"] | (s1["mode"] != 3)
    mems3 = _view3(s3["mems"], (B, 4, NP3))
    return s1, (mems3, s3["n_mem"], s3["ovf"] | (s3["mode"] != 3))


def _bwd_lanes(CS: int, M: int) -> int:
    """A, the worklist's lane count."""
    return min(max(4 * CS, 2048), M)


def _bwd_budget(M: int, L: int, A: int) -> int:
    """ITB, the worklist's safety budget of steps: total work / A + one
    longest walk (never binds)."""
    return (M * (L + 2)) // A + L + 8


def _bwd_walk_machine(dfm: DeviceFM, L: int, q_flat, read_id, bst0, i_b0,
                      mi, alive0, CS: int, fetch):
    """Recorded break intervals walk backward via a persistent WORKLIST
    of A active lanes (_bwd_lanes) over the front-packed break queue: a
    lane whose walk dies writes its result and pulls the next queue
    entry, so the step count is ~max(total_steps/A, longest walk).

    Returns (r int32[M] death step, bst [M, 3] state at maximal backward
    reach); lanes with alive0=False report r = i_b0."""
    M = i_b0.shape[0]
    dev = q_flat.device
    A = _bwd_lanes(CS, M)
    dt = bst0.dtype
    total = alive0.to(I32).sum(dtype=I32)        # live prefix

    z = torch.zeros(M, dtype=dt, device=dev)
    qtab = torch.stack([bst0[:, 0], bst0[:, 1], bst0[:, 2],
                        i_b0.to(dt), read_id.to(dt), mi.to(dt), z, z],
                       dim=1)
    # outputs (+1 drop-sentinel slot) default to the dead-on-entry
    # convention (r=i_b0, bst=bst0); bst columns share one flat buffer
    r_out = torch.cat([i_b0.to(I32), torch.zeros(1, dtype=I32,
                                                 device=dev)])
    bflat = torch.cat([bst0[:, 0], bst0[:, 1], bst0[:, 2],
                       torch.zeros(1, dtype=dt, device=dev)])
    lane = _ar(A, dev)
    qi0 = lane
    row0 = qtab[qi0.clamp_max(M - 1).long()]
    st0 = dict(qi=qi0, act=qi0 < total, bst=row0[:, :3],
               i_b=row0[:, 3].to(I32), rid=row0[:, 4].to(I32),
               mi=row0[:, 5], nxt=torch.clamp_max(total, A))
    ITB = _bwd_budget(M, L, A)

    def write_dead(s, dead):
        widx = torch.where(dead, s["qi"], M)
        _scatter_set_(r_out, widx, s["i_b"])
        widx3 = torch.where(dead.repeat(3),
                            torch.cat([widx, widx + M, widx + 2 * M]),
                            3 * M)
        bst = s["bst"]
        _scatter_set_(bflat, widx3, torch.cat([bst[:, 0], bst[:, 1],
                                               bst[:, 2]]))

    def step(s):
        act, i_b, bst = s["act"], s["i_b"], s["bst"]
        qb = q_flat[(s["rid"] * L + i_b.clamp(0, L - 1)).long()]
        valid_c = (i_b >= 0) & (qb < 4)
        ok = bwt_extend_dir_batch(dfm, bst, torch.ones(A, dtype=torch.bool,
                                                       device=dev))
        okc = _take_row(ok, qb.clamp(0, 3))
        dead = act & (~valid_c | (okc[:, 2] < s["mi"]))
        walk = act & ~dead
        # finished entries: result at their queue index (state at
        # maximal reach = bst BEFORE this failed step)
        write_dead(s, dead)
        # survivors advance
        bst = torch.where(walk[:, None], okc, bst)
        i_b = torch.where(walk, i_b - 1, i_b)
        # dead lanes refill from the queue head
        d32 = dead.to(I32)
        cs = torch.cumsum(d32, 0, dtype=I32)
        new_qi = s["nxt"] + cs - d32
        refill = dead & (new_qi < total)
        qsrc = torch.where(refill, new_qi, 0).clamp_max(M - 1)
        row = qtab[qsrc.long()]
        bst = torch.where(refill[:, None], row[:, :3], bst)
        i_b = torch.where(refill, row[:, 3].to(I32), i_b)
        rid = torch.where(refill, row[:, 4].to(I32), s["rid"])
        mi_a = torch.where(refill, row[:, 5], s["mi"])
        qi = torch.where(dead, torch.where(refill, new_qi, M), s["qi"])
        return dict(qi=qi, act=walk | refill, bst=bst, i_b=i_b, rid=rid,
                    mi=mi_a, nxt=s["nxt"] + cs[-1])

    out = _run(step, st0, lambda s: s["act"].any(), ITB, fetch)
    # iteration budget blown (never for the ITB above): record as death
    write_dead(out, out["act"])
    return r_out[:M], bflat[:3 * M].reshape(3, M).T.to(dt)


def _cohort_emit(r, brk_g, valid, NB: int):
    """min of r over later slots in the same group (groups are processed
    in slot order, longest-forward first): the r_prev value each break's
    emission test compares against."""
    NL = r.shape[0]
    dev = r.device
    m_out = torch.full((NL, NB), BIG32, dtype=I32, device=dev)
    g_c = torch.full((NL,), -1, dtype=I32, device=dev)
    m_c = torch.full((NL,), BIG32, dtype=I32, device=dev)
    for jj in range(NB):
        j = NB - 1 - jj
        gj = brk_g[:, j]
        vj = valid[:, j]
        same = vj & (gj == g_c)
        m_out[:, j] = torch.where(same, m_c, BIG32)
        m_new = torch.where(same, torch.minimum(m_c, r[:, j]), r[:, j])
        m_c = torch.where(vj, m_new, m_c)
        g_c = torch.where(vj, gj, g_c)
    return m_out


def _copies(st: dict) -> dict:
    return {k: v.clone() for k, v in st.items()}


def p1p3_machine(dfm: DeviceFM, L: int, NB: int, ITERS: int, read_id,
                 qlen_l, st1, q2, qlen2, NP3: int, min_seed_len,
                 max_mem_intv, st3, fetch):
    """_p1p3_machine: on a CUDA tensor the seed_p1p3 kernel (one launch,
    no read of the card), on a CPU tensor the plain version (its stop
    reads through `fetch`). Same outputs; the inputs are not changed."""
    if not _on_card(q2, "p1p3_machine"):
        return _p1p3_machine(dfm, L, NB, ITERS, read_id, qlen_l, st1, q2,
                             qlen2, NP3, min_seed_len, max_mem_intv, st3,
                             fetch)
    B = st1["mode"].shape[0]
    s1, s3 = _copies(st1), _copies(st3)
    smem_cuda.p1p3(dfm, L, NB, ITERS, NP3, min_seed_len, max_mem_intv,
                   _sym_tab(q2, qlen2, L), read_id.to(I32).contiguous(),
                   qlen_l.to(I32).contiguous(), qlen2.to(I32).contiguous(),
                   s1, s3)
    return s1, (_view3(s3["mems"], (B, 4, NP3)), s3["n_mem"], s3["ovf"])


def fwd_scan_machine(dfm: DeviceFM, L: int, NB: int, ITERS: int, q_flat,
                     read_id, qlen_l, mi, st0, fetch):
    """_fwd_scan_machine: the seed_fwd kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if not _on_card(q_flat, "fwd_scan_machine"):
        return _fwd_scan_machine(dfm, L, NB, ITERS, q_flat, read_id,
                                 qlen_l, mi, st0, fetch)
    s = _copies(st0)
    smem_cuda.fwd_scan(dfm, L, NB, ITERS, q_flat.contiguous(),
                       read_id.to(I32).contiguous(),
                       qlen_l.to(I32).contiguous(), mi.contiguous(), s)
    return s


def bwd_walk_machine(dfm: DeviceFM, L: int, q_flat, read_id, bst0, i_b0,
                     mi, alive0, CS: int, fetch):
    """_bwd_walk_machine: the seed_bwd kernel (one thread a queue entry)
    on a CUDA tensor, the plain version on a CPU one."""
    if not _on_card(q_flat, "bwd_walk_machine"):
        return _bwd_walk_machine(dfm, L, q_flat, read_id, bst0, i_b0, mi,
                                 alive0, CS, fetch)
    M = i_b0.shape[0]
    total = alive0.to(I32).sum(dtype=I32)        # live prefix
    return smem_cuda.bwd_walk(dfm, L, _bwd_budget(M, L, _bwd_lanes(CS, M)),
                              q_flat.contiguous(),
                              read_id.to(I32).contiguous(),
                              bst0.contiguous(), i_b0.to(I32).contiguous(),
                              mi.contiguous(), total)


def cohort_emit(r, brk_g, valid, NB: int):
    """_cohort_emit: the seed_cohort kernel (blocks of 32 rows, a row's
    slots staged in shared memory a chunk at a time) on a CUDA tensor,
    the plain version on a CPU one."""
    if not _on_card(r, "cohort_emit"):
        return _cohort_emit(r, brk_g, valid, NB)
    if brk_g.stride(1) != 1:
        brk_g = brk_g.contiguous()
    return smem_cuda.cohort_emit(r.to(I32).contiguous(), brk_g,
                                 valid.contiguous())


def _compact(vflat, budget: int):
    """Pack the True positions of vflat into `budget` dense lanes,
    order-preserving. Returns (src int32[budget] = flat index feeding
    each lane, dst int32[N] = lane of each flat position (== budget when
    dropped), lane_ok bool[budget], dropped bool[N])."""
    n = vflat.shape[0]
    dev = vflat.device
    v32 = vflat.to(I32)
    rank = torch.cumsum(v32, 0, dtype=I32) - v32     # exclusive prefix
    dropped = vflat & (rank >= budget)
    dst = torch.where(vflat & ~dropped, rank, budget)
    src = _set_drop(budget, dst, _ar(n, dev), I32, dev)
    total = torch.clamp_max(rank[-1] + v32[-1], budget)
    lane_ok = _ar(budget, dev) < total
    return src, dst, lane_ok, dropped


SORT_BWD_POOL = True  # walk-length-sorted backward pools


def _smem_pass_post(dfm: DeviceFM, L: int, NB: int, q_flat, read_id,
                    mi, min_seed_len, s, PBUD: int, CS: int, fetch):
    """Backward walks + cohort emission for a finished forward scan.

    The walk runs over a batch-global pool of PBUD lanes packed from the
    valid break slots; reads whose breaks do not fit overflow to the
    redo path. Returns (mems [NL, 4, NB] dense-front in bwa emission
    order, n1 int32[NL], fwd ovf bool[NL], pool ovf bool[NL])."""
    NL = s["mode"].shape[0]
    dev = q_flat.device
    nb = s["nb"]
    brk_kls = _view3(s["brk_kls"], (NL, 3, NB))
    brk_meta = _view3(s["brk_meta"], (NL, 3, NB))
    slot = _ar(NB, dev)[None, :]
    valid = slot < nb[:, None]
    brk_end = brk_meta[:, 0, :]
    brk_x = brk_meta[:, 1, :]
    # breaks recorded at pivot x=0 die before their first probe: r=-1,
    # state = the recorded break interval, no pool lane needed
    doa = valid & (brk_x == 0)

    src, dst, lane_ok, dropped = _compact((valid & ~doa).reshape(-1), PBUD)
    # order the pool by walk-length bound, longest first, so the
    # worklist's drain tail runs on the shortest walks
    i_b0_all = (brk_x - 1).reshape(-1)
    if SORT_BWD_POOL:
        order_key = torch.where(lane_ok, -i_b0_all[src.long()], BIG32)
        perm = torch.argsort(order_key, stable=True)
        src = src[perm]
        lane_ok = _ar(PBUD, dev) < lane_ok.to(I32).sum(dtype=I32)
        # inv[PBUD] = PBUD: the dropped positions' lane stays the
        # sentinel (filled on the device: a Python scalar set into a
        # CUDA tensor is a blocking copy)
        inv = torch.full((PBUD + 1,), PBUD, dtype=I32, device=dev)
        inv[perm] = _ar(PBUD, dev)
        dst = inv[dst.long()]                     # compose permutation
    srcl = src.long()
    lane_nl = (src // NB).long()
    bst0 = brk_kls.transpose(1, 2).reshape(NL * NB, 3)[srcl]
    i_b0 = i_b0_all[srcl]
    rid_b = read_id[lane_nl]
    mi_b = mi[lane_nl]
    r_l, bst_l = bwd_walk_machine(dfm, L, q_flat, rid_b, bst0, i_b0,
                                  mi_b, lane_ok, CS, fetch)
    # scatter-back = gather through dst (index PBUD -> sentinel row)
    r_pad = torch.cat([r_l, torch.full((1,), BIG32, dtype=I32,
                                       device=dev)])
    bst_pad = torch.cat([bst_l, torch.zeros((1, 3), dtype=bst_l.dtype,
                                            device=dev)])
    dl = dst.long()
    r = r_pad[dl].reshape(NL, NB)
    bst = bst_pad[dl].reshape(NL, NB, 3).transpose(1, 2)   # [NL, 3, NB]
    r = torch.where(doa, -1, r)
    bst = torch.where(doa[:, None, :], brk_kls, bst)
    valid = valid & ~dropped.reshape(NL, NB)
    ovf_pool = dropped.reshape(NL, NB).any(dim=1)

    # cohort emission: first break of each distinct-death-step cohort
    brk_g = brk_meta[:, 2, :]
    m_prev = cohort_emit(r, brk_g, valid, NB)
    emit = valid & (r < m_prev) & ((brk_end - (r + 1)) >= min_seed_len)
    info = _pack_info(r + 1, brk_end, bst.dtype)
    # bwa appends in death order: group ascending, slot descending
    key = torch.where(emit, brk_g * (2 * NB) + (NB - slot), BIG32)
    order = torch.argsort(key, dim=1, stable=True)
    mems = torch.cat([bst, info[:, None, :]], dim=1)      # [NL, 4, NB]
    mems = mems.gather(2, order[:, None, :].expand(-1, 4, -1))
    n1 = emit.sum(dim=1).to(I32)
    return mems, n1, s["ovf"], ovf_pool


# overflow-source bits (nonzero -> redo)
OVF_P1_FWD = 1     # pass-1 forward scan: NB break cap or ITERS
OVF_P1_POOL = 2    # pass-1 backward pool (PBUD1) exhausted
OVF_TASKPOOL = 4   # pass-2 re-seed task pool (TBUD) exhausted
OVF_P2_FWD = 8     # pass-2 forward scan: NB2 cap or ITERS
OVF_P2_POOL = 16   # pass-2 backward pool (PBUD2) exhausted
OVF_P2_EMIT = 32   # pass-2 per-read emission cap (M2)
OVF_P3 = 64        # pass-3 mem-slot cap (NP3)
OVF_MEMS = 128     # total mems > MAXM
OVF_SA = 256       # fused SA walk overflow (budget/pool)

# ragged-bundle sizing: flat mem entries / fused-SA values per read
# (global pools: only the batch mean matters; reads past a pool fall back
# to the dense refetch / probe path — a latency cliff, not a correctness
# one)
CAPM_PER = 14
CAPO_PER = 40
# fused-walk pool of genomes without a dense SA
CAPO_PER_BIG = 144


def collect_intv_device(dfm: DeviceFM, L: int, MAXB: int, MAXM: int,
                        ITERS: int, q: torch.Tensor, qlen: torch.Tensor,
                        min_seed_len: int, split_len: int, split_width: int,
                        max_mem_intv: int, max_occ: int, pack_H: int = 0,
                        big: int = 0, p2x: int = 1,
                        sa_intv_s: int = 0, fetch=to_host
                        ) -> tuple[torch.Tensor, ...]:
    """All seeding intervals for a batch of reads (mem_collect_intv,
    bwa/bwamem.c:120-168), sorted by info.

    q: uint8 or int32 [B, L] (0..4; pad >= 4 beyond qlen); qlen int32[B].
    Returns (mems [B, 4, MAXM] = (k, l, s, info) rows in the coordinate
    dtype, n_mem int32[B], ovf int32[B] OVF_* bitmask, occ_sa (the seeds'
    SA values, a batch-global ragged pool), occ_total int32[B]) and, with
    pack_H, the one-array bundle of _pack_ragged. The machines read their
    stop conditions with `fetch`."""
    dev = q.device
    q = q.to(I32)
    B = q.shape[0]
    dt = dfm.L2.dtype         # int32 on a narrow view, else int64
    # budget profile: the default covers repeat-realistic batches; `big`
    # (1, 2, ...) is the device redo's for the overflowed residue, each
    # level twice the budgets of the one before; p2x deepens the pass-2
    # pools (Gbp genomes / adaptive escalation)
    g = 1 << (int(big) - 1) if big else 0
    NB = max(MAXB, 384 * g if big else (160 if p2x > 1 else 128))
    NB2 = 192 * g if big else (128 if p2x > 1 else 64)
    NP3 = 64 * g if big else 24
    M2 = min(128 * g if big else (96 if p2x > 1 else 64), MAXM)
    PBUD1 = (128 * g if big else 48) * B
    if big:
        TBUD, PBUD2 = 8 * g * B, 128 * g * B
    elif p2x == 1:
        TBUD, PBUD2 = 2 * B, 32 * B
    else:
        TBUD, PBUD2 = p2x * B, 24 * p2x * B
    CS = min(4096, max(2048, B // 2))
    q_flat = q.reshape(-1)
    rid = _ar(B, dev)

    # pass 1's forward scan fused with pass 3, then pass 1's backward
    # walks + emission
    st3 = dict(mode=torch.zeros(B, dtype=I32, device=dev),
               x=torch.zeros(B, dtype=I32, device=dev),
               i=torch.zeros(B, dtype=I32, device=dev),
               ik=torch.zeros((B, 3), dtype=dt, device=dev),
               mems=torch.zeros(B * 4 * NP3 + 1, dtype=dt, device=dev),
               n_mem=torch.zeros(B, dtype=I32, device=dev),
               ovf=torch.zeros(B, dtype=torch.bool, device=dev))
    s1, (mems3, n3, ovf3) = p1p3_machine(
        dfm, L, NB, ITERS, rid, qlen, _fresh(B, NB, dt, dev), q, qlen,
        NP3, min_seed_len, max_mem_intv, st3, fetch)
    mems1, n1, ovf_f1, ovf_p1 = _smem_pass_post(
        dfm, L, NB, q_flat, rid, torch.ones(B, dtype=dt, device=dev),
        min_seed_len, s1, PBUD1, CS, fetch)
    ovf = ovf_f1.to(I32) * OVF_P1_FWD + ovf_p1.to(I32) * OVF_P1_POOL

    # pass 2: re-seed long low-occ SMEMs from the middle, min_intv = s+1,
    # one lane per task from a batch-global compacted task pool
    slot1 = _ar(NB, dev)[None, :]
    ish = 16 if dt == I32 else 32
    start = (mems1[:, 3, :] >> ish).to(I32)
    end = (mems1[:, 3, :] & ((1 << ish) - 1)).to(I32)
    want = ((slot1 < n1[:, None]) & ((end - start) >= split_len)
            & (mems1[:, 2, :] <= split_width))
    mid = ((start + end) >> 1).to(I32)
    tsrc, _tdst, tv, tdrop = _compact(want.reshape(-1), TBUD)
    ovf = ovf | tdrop.reshape(B, NB).any(dim=1).to(I32) * OVF_TASKPOOL
    tsl = tsrc.long()
    rid2 = (tsrc // NB).to(I32)                       # owning read
    tx = torch.where(tv, mid.reshape(-1)[tsl], 0).to(I32)
    tmi = torch.where(tv, (mems1[:, 2, :] + 1).reshape(-1)[tsl], 1).to(dt)
    qx = q_flat[(rid2 * L + tx.clamp(0, L - 1)).long()]
    st2 = _fresh(TBUD, NB2, dt, dev)
    st2.update(mode=torch.where(tv, 1, 3).to(I32), x=tx, i=tx + 1,
               ik=set_intv_batch(dfm, qx.clamp(0, 3)), ik_info=tx + 1)
    qlen2 = qlen[rid2.long()]
    s2 = fwd_scan_machine(dfm, L, NB2, ITERS, q_flat, rid2, qlen2, tmi,
                          st2, fetch)
    mems2l, n2l, ovf2f, ovf2p = _smem_pass_post(
        dfm, L, NB2, q_flat, rid2, tmi, min_seed_len, s2, PBUD2, CS, fetch)
    ovf2l = ovf2f.to(I32) * OVF_P2_FWD + ovf2p.to(I32) * OVF_P2_POOL
    ovf = ovf | _max_drop(B, rid2, torch.where(tv, ovf2l, 0), dev)
    # merge task-lane emissions per read: lanes are read-major and
    # dense-front, so the flat entry order IS bwa's append order
    slot2 = _ar(NB2, dev)[None, :]
    v2 = ((slot2 < n2l[:, None]) & tv[:, None]).reshape(-1)
    rid2e = rid2[:, None].expand(-1, NB2).reshape(-1)  # entry -> read
    v32 = v2.to(I32)
    grank = torch.cumsum(v32, 0, dtype=I32) - v32
    cnt2 = torch.zeros(B, dtype=I32, device=dev).index_add_(
        0, rid2e.long(), v32)
    base2 = torch.cumsum(cnt2, 0, dtype=I32) - cnt2
    p2 = grank - base2[rid2e.long()]                  # pos within read
    keep2 = v2 & (p2 < M2)
    ovf = ovf | _max_drop(B, rid2e, (v2 & (p2 >= M2)).to(I32) * OVF_P2_EMIT,
                          dev)
    dst2 = torch.where(keep2, rid2e * M2 + p2, B * M2)
    cols = [_set_drop(B * M2, dst2, mems2l[:, c, :].reshape(-1), dt, dev)
            for c in range(4)]
    mems2 = torch.stack(cols, 0).reshape(4, B, M2).permute(1, 0, 2)
    n2 = torch.clamp_max(cnt2, M2)

    # pass 3 ran fused with pass 1 (skipped if max_mem_intv <= 0)
    if max_mem_intv > 0:
        ovf = ovf | ovf3.to(I32) * OVF_P3
    else:
        n3 = torch.zeros_like(n3)

    # concatenate in bwa append order, then the final stable sort by info
    mems = torch.cat([mems1, mems2, mems3], dim=2)
    valid_all = torch.cat(
        [slot1 < n1[:, None], _ar(M2, dev)[None, :] < n2[:, None],
         _ar(NP3, dev)[None, :] < n3[:, None]], dim=1)
    n_mem = n1 + n2 + n3
    ovf = ovf | (n_mem > MAXM).to(I32) * OVF_MEMS
    n_mem = torch.clamp_max(n_mem, MAXM)
    key = torch.where(valid_all, mems[:, 3, :], torch.iinfo(dt).max)
    order = torch.argsort(key, dim=1, stable=True)
    mems = mems.gather(2, order[:, None, :].expand(-1, 4, -1))[:, :, :MAXM]
    slot_i = _ar(MAXM, dev)[None, :]

    # fused SA resolution of the FULL occurrence enumeration, in exactly
    # sa_probe_layout's order (read-major, sorted-slot-major, occurrence
    # j at x0 + j*step with cnt = min(s, max_occ) — mem_chain's rule),
    # into a batch-global ragged pool of CAPO lanes
    if dfm.sa_dense is not None or sa_intv_s > 0:
        per = CAPO_PER if dfm.sa_dense is not None else CAPO_PER_BIG
        CAPO = (per * 16 * g if big else per) * B
        valid = slot_i < n_mem[:, None]
        s_col = torch.where(valid, mems[:, 2, :], 0)
        x0_col = mems[:, 0, :]
        over = s_col > max_occ
        cnt = torch.where(over, max_occ, s_col).to(I32)
        step = torch.where(over, s_col // max(max_occ, 1), 1).to(dt)
        # int64 prefix sums: an int32 cumsum over B*MAXM slots can wrap
        # with -c in the thousands; totals clamp back to int32 after
        cntf = cnt.reshape(-1).to(I64)
        gcum = torch.cumsum(cntf, 0)
        gcum0 = gcum - cntf
        occ_total = (gcum.reshape(B, MAXM)[:, -1]
                     - gcum0.reshape(B, MAXM)[:, 0]).clamp(
                         0, torch.iinfo(I32).max).to(I32)
        p = _ar(CAPO, dev)
        # owning slot of each pool position: each real slot's id at its
        # segment start (distinct starts by construction), then a
        # running max
        sid = _ar(B * MAXM, dev)
        starts = torch.where(cntf > 0, torch.clamp_max(gcum0, CAPO), CAPO)
        marks = _max_drop(CAPO, starts, sid + 1, dev)
        seg = (torch.cummax(marks, 0).values - 1).clamp(
            0, B * MAXM - 1).long()
        ok = p < torch.clamp_max(gcum[-1], CAPO)
        rows = (x0_col.reshape(-1)[seg]
                + (p - gcum0[seg]).to(dt) * step.reshape(-1)[seg])
        if dfm.sa_dense is not None:
            idx = torch.where(ok, rows, 0).clamp(
                0, dfm.sa_dense.shape[0] - 1).long()
            occ_sa = torch.where(ok, dfm.sa_dense[idx].to(dt), 0)
        else:
            # no dense SA: the phased LF walk against the sampled SA; a
            # read whose walk blew the budget/pool is flagged OVF_SA
            # (occ_total must NOT change: the host derives segment
            # offsets from the totals)
            vals, ovf_w = sa_batch(dfm, torch.where(ok, rows, 0), 256,
                                   sa_intv_s, fetch)
            bad = _max_drop(B, torch.where(ok & ovf_w, seg // MAXM, B),
                            torch.ones(CAPO, dtype=I32, device=dev), dev)
            ovf = ovf | bad * OVF_SA
            occ_sa = torch.where(ok, vals.to(dt), 0)
    else:
        occ_sa = torch.zeros(1, dtype=I64, device=dev)
        occ_total = torch.full((B,), -1, dtype=I32, device=dev)
    if pack_H:
        packed = _pack_ragged(mems, n_mem, ovf, occ_sa, occ_total, B)
        return mems, n_mem, ovf, occ_sa, occ_total, packed
    return mems, n_mem, ovf, occ_sa, occ_total


def _pack_ragged(mems, n_mem, ovf, occ_sa, occ_total, B: int):
    """Bundle a narrow batch's seeding result as ONE 1-D int32 array of
    only the real entries (one device->host copy per batch). Layout:

      [0] total flat mem entries   [1] total flat SA values  [2..3] pad
      [4        .. 4+B)    n_mem          [4+B   .. 4+2B)  ovf bits
      [4+2B     .. 4+3B)   occ_total
      [hdr      .. +CAPM)  info (start<<16|end), per-read segments in
                           order; then x0 [CAPM], then s [CAPM]
      [..       .. +CAPO)  fused SA values (read-major segments)

    If the totals exceed the CAPM/CAPO pools ([0]/[1] report this), the
    host refetches the dense mems instead."""
    dev = mems.device
    MAXM = mems.shape[2]
    CAPM = CAPM_PER * B
    CAPO = occ_sa.shape[0] if occ_sa.shape[0] > 1 else CAPO_PER * B
    slot_i = _ar(MAXM, dev)[None, :]
    valid = slot_i < n_mem[:, None]
    base = torch.cumsum(n_mem, 0, dtype=I32) - n_mem
    total_m = base[-1] + n_mem[-1]
    dstm = torch.where(valid, base[:, None] + slot_i, CAPM).reshape(-1)

    def flat(vals):
        return _set_drop(CAPM, dstm, vals.to(I32).reshape(-1), I32, dev)

    info = mems[:, 3, :]
    if info.dtype != I32:
        info = ((info >> 32) << 16) | (info & 0xFFFF)
    # x1 (the reverse-complement interval coordinate) is not consumed by
    # the host chain/SA stages; the lists() view refetches it
    fm_ie, fm_k, fm_s = flat(info), flat(mems[:, 0, :]), flat(mems[:, 2, :])
    ocnt = torch.where(occ_total >= 0, occ_total, 0)
    total_o = ocnt.sum(dtype=I32)
    fo = occ_sa.to(I32)
    if fo.shape[0] != CAPO:               # no-dense-SA sentinel shape
        fo = torch.zeros(CAPO, dtype=I32, device=dev)
    zero = torch.zeros((), dtype=I32, device=dev)
    hdr = torch.stack([total_m.to(I32), total_o, zero, zero])
    return torch.cat([hdr, n_mem.to(I32), ovf.to(I32), occ_total.to(I32),
                      fm_ie, fm_k, fm_s, fo])


def pad_reads(reads: list[np.ndarray], L: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Pad reads to a [B, L] uint8 batch (pad symbol 4), B a power-of-two
    bucket (>= 64)."""
    B = 64
    while B < len(reads):
        B <<= 1
    q = np.full((B, L), 4, dtype=np.uint8)
    qlen = np.zeros(B, dtype=np.int32)
    for b, r in enumerate(reads):
        n = min(len(r), L)
        q[b, :n] = r[:n]
        qlen[b] = n
    return q, qlen


SEED_HEAD = 32  # leading mem slots of the dense view


def _opt_params(opt: MemOpt) -> tuple:
    return (int(opt.min_seed_len), int(opt.split_len),
            int(opt.split_width), int(opt.max_mem_intv), int(opt.max_occ))


def _narrow(fm: FMIndex, L: int) -> bool:
    """The int32 machine: below 2^31 rows (index.io.wide, whose test
    hook FORCE_WIDE forces the int64 one) and reads below 2^15."""
    return not wide(fm.seq_len) and L < 32768


def _mark(dev: torch.device):
    """A CUDA event recorded on `dev`'s current stream now (None on the
    CPU): the end of the work queued so far, which a reader on another
    stream waits for (pipeline/batch.py: BatchAligner._seed_fetch)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def seed_dispatch(opt: MemOpt, fm: FMIndex, dfm: DeviceFM,
                  reads: list[np.ndarray], L: int = 256,
                  MAXB: int = 64, MAXM: int = 128,
                  iters_factor: int = 16, padded=None,
                  fetch=to_host) -> dict:
    """Queue the device SMEM machine for a batch on the current stream;
    returns a handle for seed_collect_batch, whose "event" marks the
    program's end on a card. On a card nothing here reads it: the
    machines are kernels, and so is the fused LF walk of an index
    without a dense SA (one launch, which reads nothing back); on
    the CPU the plain versions read their stop conditions through
    `fetch`. The padded read batch (device tensors) stays in the handle
    so the extension stage can address it."""
    if padded is not None:
        q_dev, qlen_dev = padded
    else:
        q, qlen = pad_reads(reads, L)
        q_dev = torch.as_tensor(q, device=dfm.device)
        qlen_dev = torch.as_tensor(qlen, device=dfm.device)
    params = _opt_params(opt)
    H = min(SEED_HEAD, MAXM)
    narrow = _narrow(fm, L)
    # Gbp-class genomes are ~unique at seed length: nearly every SMEM
    # re-seeds in pass 2, so those loads get 4x-deep pass-2 pools
    p2x = 4 if fm.seq_len >= (1 << 28) else 1
    p2x = max(p2x, _ADAPT.get(id(fm), 1))
    # no dense SA: fuse the phased LF walk against the sampled SA
    sa_s = int(fm.sa_intv) if (dfm.sa_dense is None
                               and fm.sa_intv <= 64) else 0
    out = collect_intv_device(
        dfm.narrow() if narrow else dfm, L, MAXB, MAXM, L * iters_factor,
        q_dev, qlen_dev, *params, pack_H=H if narrow else 0, p2x=p2x,
        sa_intv_s=sa_s, fetch=fetch)
    h = dict(reads=reads, opt=opt, fm=fm, dfm=dfm, L=L, MAXB=MAXB,
             MAXM=MAXM, iters=L * iters_factor, q_dev=q_dev, mems=out[0],
             p2x=p2x)
    if narrow:
        h["packed"] = out[5]
    else:
        mems, n_mem, ovf, occ_sa, occ_total = out
        h["meta"] = torch.stack([n_mem.to(I32), ovf.to(I32), occ_total])
        if occ_sa.shape[0] > 1:
            h["occ_sa_dev"] = occ_sa
        h["head"] = mems[:, :, :H]
    h["event"] = _mark(q_dev.device)
    return h


def _fire_post_redo(handle: dict) -> None:
    """Call the handle's "_post_redo_dispatch" hook once: the batch's
    seed program, and its first device-redo level if any, are queued
    (JAX smem_jax.py:1264, :1289, :1379)."""
    cb = handle.pop("_post_redo_dispatch", None)
    if cb is not None:
        cb()


def seed_collect_batch(handle: dict, fetch=to_host
                       ) -> smem_golden.IntvBatch:
    """Finish a seed_dispatch as an array-native IntvBatch, reading the
    device with `fetch`. Overflowed reads are redone by the big-budget
    device machine, in two levels (queued on the current stream; the
    handle's "event" then marks the end of the last queued), then by
    the golden implementation, and spliced in. The handle's
    "_post_redo_dispatch" hook fires once: with no redo, after the
    results are read; else once the first redo level's programs are
    queued, before their results are read. A second level, rare (the
    reads the first leaves), then queues behind what the hook queued
    (the next batch's seed program); its own event orders its reads."""
    opt, fm, reads = handle["opt"], handle["fm"], handle["reads"]
    L, MAXM = handle["L"], handle["MAXM"]
    n = len(reads)
    H = min(SEED_HEAD, MAXM)
    packed = handle.get("packed")
    flats = None            # (k, l, s, st, en) flat arrays
    occ_flat = None
    if packed is not None:
        pk = fetch(packed)
        Bp = handle["q_dev"].shape[0]
        CAPM = CAPM_PER * Bp
        CAPO = (CAPO_PER if handle["dfm"].sa_dense is not None
                else CAPO_PER_BIG) * Bp
        total_m = int(pk[0])
        o = 4
        n_mem = pk[o:o + Bp]
        o += Bp
        ovf = pk[o:o + Bp] != 0
        o += Bp
        occ_total = pk[o:o + Bp]
        o += Bp
        if total_m <= CAPM:
            fm_ie = pk[o:o + CAPM][:total_m]
            fm_k = pk[o + CAPM:o + 2 * CAPM][:total_m]
            fm_s = pk[o + 2 * CAPM:o + 3 * CAPM][:total_m]
            flats = (fm_k, np.zeros(total_m, np.int32), fm_s,
                     (fm_ie >> 16).astype(np.int32),
                     (fm_ie & 0xFFFF).astype(np.int32))
        # reads whose segment fits inside CAPO are fused even when the
        # batch total overflows (per-read fit check below)
        occ_flat = pk[o + 3 * CAPM:o + 3 * CAPM + CAPO]
    else:
        meta = fetch(handle["meta"])
        n_mem = meta[0]
        ovf = meta[1] != 0
        occ_total = meta[2]
    if flats is None:
        # wide genome, or the ragged mem pool overflowed (dense refetch):
        # the tracer's span `seed.refetch`, the copy and its unpacking
        with tracer.span("seed.refetch"):
            used = int(n_mem.max()) if len(n_mem) else 0
            width = H
            while width < used:
                width <<= 1
            width = min(width, MAXM)
            if packed is None and used <= H:
                mems = fetch(handle["head"])
            else:
                mems = fetch(handle["mems"][:, :, :width])
            W = mems.shape[2]
            ish = INFO_SHIFT[mems.dtype]  # narrow machine packs start<<16
            counts = np.minimum(n_mem[:n].astype(np.int64), W)
            redo = np.fromiter(
                (bool(ovf[b]) or len(reads[b]) > L for b in range(n)),
                bool, n)
            counts = np.where(redo, 0, counts)
            m = (np.arange(W)[None, :] < counts[:, None]).ravel()
            k_c = mems[:n, 0, :].ravel()[m]
            l_c = mems[:n, 1, :].ravel()[m]
            s_c = mems[:n, 2, :].ravel()[m]
            st_c = (mems[:n, 3, :] >> ish).astype(np.int32).ravel()[m]
            en_c = (mems[:n, 3, :] & ((1 << ish) - 1)).astype(
                np.int32).ravel()[m]
    else:
        counts = n_mem[:n].astype(np.int64)
        redo = np.fromiter(
            (bool(ovf[b]) or len(reads[b]) > L for b in range(n)), bool, n)
        owner = np.repeat(np.arange(len(n_mem)), n_mem)
        keep = (owner < n) & ~np.pad(redo, (0, len(n_mem) - n))[owner]
        counts = np.where(redo, 0, counts)
        k_c, l_c, s_c, st_c, en_c = (c[keep] for c in flats)
        handle["_x1_elided"] = (n_mem, redo)
    iv_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=iv_off[1:])
    batch = smem_golden.IntvBatch(iv_off, k_c.astype(np.int64),
                                  l_c.astype(np.int64),
                                  s_c.astype(np.int64), st_c, en_c)
    # per-read fused SA values, or None when the read must go through the
    # probe path (redone / pool exceeded / not resolved on device)
    sa_vals: list = [None] * n
    occ_np = None
    ocnt = np.where(occ_total >= 0, occ_total, 0)
    baseo = np.cumsum(ocnt, dtype=np.int64) - ocnt
    CAPO_n = len(occ_flat) if occ_flat is not None else 0
    for b in np.nonzero(~redo)[0]:
        t = int(occ_total[b])
        if t >= 0:
            if occ_flat is not None:
                if baseo[b] + t <= CAPO_n:   # segment fully in the pool
                    sa_vals[b] = occ_flat[baseo[b]:baseo[b] + t]
            elif packed is None and handle.get("occ_sa_dev") is not None:
                if occ_np is None:
                    dev = handle["occ_sa_dev"]
                    width = min(int(ocnt.sum()), dev.shape[0])
                    occ_np = fetch(dev[:width])
                if baseo[b] + t <= len(occ_np):
                    sa_vals[b] = occ_np[baseo[b]:baseo[b] + t]
    handle["sa_vals"] = sa_vals
    if not redo.any():
        _fire_post_redo(handle)
    if n and redo.sum() > ADAPT_THRESH * n:
        # overflow cliff on this index: escalate the pool profile for
        # every subsequent dispatch (one-way, capped at p2x=8)
        cur = handle.get("p2x", 1)
        nxt_p2x = 4 if cur < 4 else 8
        if cur < 8 and _ADAPT.get(id(fm), 1) < nxt_p2x:
            _ADAPT[id(fm)] = nxt_p2x
            import sys as _sys
            print(f"[M::seed] {int(redo.sum())}/{n} reads overflowed "
                  f"the p2x={cur} pools; escalating to p2x={nxt_p2x} "
                  "for subsequent batches", file=_sys.stderr)
    if redo.any():
        # redo overflowed reads: first the big-budget DEVICE machine,
        # then the host golden for what exhausts even that
        repl: dict = {}   # read -> {name: replacement array}
        todo = [int(b) for b in np.nonzero(redo)[0]]
        if DEVICE_REDO and handle.get("dfm") is not None:
            todo = _device_redo(handle, todo, repl, counts, sa_vals, fetch)
        _fire_post_redo(handle)   # the redo skipped the device
        # the reads each redo seeded (BatchAligner.stats)
        handle["redo_device"] = int(redo.sum()) - len(todo)
        handle["redo_golden"] = len(todo)
        for b in todo:
            iv = smem_golden.collect_intv(opt, fm, reads[b])
            rb = smem_golden.IntvBatch.from_lists([iv])
            repl[b] = {name: getattr(rb, name)
                       for name in ("x0", "x1", "sv", "st", "en")}
            counts[b] = len(iv)
        batch = _splice_batch(batch, counts, repl, n)
    return batch


def _splice_batch(batch, counts, repl: dict, n: int):
    """Rebuild an IntvBatch with per-read replacement segments, copying
    the unchanged runs between redo reads in bulk."""
    old_off = batch.iv_off
    iv_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=iv_off[1:])
    names = ("x0", "x1", "sv", "st", "en")
    outs = {name: np.empty(int(iv_off[-1]),
                           getattr(batch, name).dtype) for name in names}
    prev = 0
    for b in sorted(repl) + [n]:
        s_lo, s_hi = int(old_off[prev]), int(old_off[min(b, n)])
        d_lo = int(iv_off[prev])
        for name in names:
            outs[name][d_lo:d_lo + (s_hi - s_lo)] = \
                getattr(batch, name)[s_lo:s_hi]
        if b < n:
            d = int(iv_off[b])
            for name in names:
                seg = repl[b][name]
                outs[name][d:d + len(seg)] = seg
            prev = b + 1
    return smem_golden.IntvBatch(iv_off, *(outs[name] for name in names))


DEVICE_REDO = True   # test hook: False forces every overflow to golden
REDO_B = 512         # max reads per device-redo call

# Adaptive budget escalation: a genome whose reads overflow the default
# pools (>ADAPT_THRESH of a batch) permanently escalates the p2x profile
# of its index for subsequent dispatches.
_ADAPT: dict[int, int] = {}
ADAPT_THRESH = 0.05


def _device_redo(handle: dict, idx: list, repl: dict, counts, sa_vals,
                 fetch=to_host) -> list:
    """Re-run budget-overflowed reads with the big-budget device machine
    and record replacement segments in ``repl``: level 1, then level 2
    with twice its budgets, mem slots and steps for the reads level 1
    left. At each level every chunk's program is queued first; then
    the handle's "event" marks their end, after level 1 its
    "_post_redo_dispatch" hook fires, and the results are read. Returns
    the residue that must still go to the host golden."""
    opt, fm, dfm, reads = (handle[k] for k in ("opt", "fm", "dfm", "reads"))
    L, MAXB = handle["L"], handle["MAXB"]
    fit = [b for b in idx if len(reads[b]) <= L]
    rest = [b for b in idx if len(reads[b]) > L]
    d = dfm.narrow() if _narrow(fm, L) else dfm
    params = _opt_params(opt)
    sa_s = int(fm.sa_intv) if (dfm.sa_dense is None
                               and fm.sa_intv <= 64) else 0
    for level in (1, 2):
        if not fit:
            break
        g = 1 << (level - 1)
        # OVF_MEMS overflows need more mem slots, not just bigger pools
        MAXM = max(256, 2 * handle["MAXM"]) * g
        chunks = []
        for c0 in range(0, len(fit), REDO_B):
            sub = fit[c0:c0 + REDO_B]
            q, qlen = pad_reads([reads[b] for b in sub], L)
            chunks.append((sub, collect_intv_device(
                d, L, MAXB, MAXM, handle["iters"] * g,
                torch.as_tensor(q, device=dfm.device),
                torch.as_tensor(qlen, device=dfm.device), *params,
                pack_H=0, big=level, sa_intv_s=sa_s, fetch=fetch)))
        handle["event"] = _mark(dfm.device)
        _fire_post_redo(handle)
        fit = _redo_results(chunks, repl, counts, sa_vals, fetch)
    return rest + fit


def _redo_results(chunks: list, repl: dict, counts, sa_vals,
                  fetch=to_host) -> list:
    """Read one device-redo level's results into ``repl``, ``counts``
    and ``sa_vals``; returns the reads that overflowed again."""
    left = []
    for sub, out in chunks:
        mems, n_mem, ovf, occ_sa, occ_total = (fetch(o) for o in out)
        ish = INFO_SHIFT[mems.dtype]
        ocnt_r = np.where(occ_total >= 0, occ_total, 0)
        baseo_r = np.cumsum(ocnt_r, dtype=np.int64) - ocnt_r
        for j, b in enumerate(sub):
            if ovf[j]:
                left.append(b)
                continue
            c = int(n_mem[j])
            repl[b] = dict(
                x0=mems[j, 0, :c].astype(np.int64),
                x1=mems[j, 1, :c].astype(np.int64),
                sv=mems[j, 2, :c].astype(np.int64),
                st=(mems[j, 3, :c] >> ish).astype(np.int32),
                en=(mems[j, 3, :c] & ((1 << ish) - 1)).astype(np.int32))
            counts[b] = c
            t = int(occ_total[j])
            if (t >= 0 and occ_sa.ndim == 1 and len(occ_sa) > 1
                    and baseo_r[j] + t <= len(occ_sa)):
                sa_vals[b] = occ_sa[baseo_r[j]:baseo_r[j] + t]
    return left


def seed_collect(handle: dict, fetch=to_host
                 ) -> list[list[smem_golden.Intv]]:
    """Finish a seed_dispatch as per-read Intv lists (the Python-object
    view of seed_collect_batch). The ragged bundle elides x1; this view
    restores it from the device-resident dense mems."""
    batch = seed_collect_batch(handle, fetch)
    info = handle.pop("_x1_elided", None)
    if info is not None:
        n_mem, redo = info
        used = int(n_mem.max()) if len(n_mem) else 0
        width = min(max(used, 1), handle["MAXM"])
        mems = fetch(handle["mems"][:, :, :width])
        off = batch.iv_off
        x1 = batch.x1.copy()
        for r in np.nonzero(~redo)[0]:
            c = off[r + 1] - off[r]
            x1[off[r]:off[r + 1]] = mems[r, 1, :c]
        batch.x1 = x1
    return batch.lists()


def collect_intv_batch(opt: MemOpt, fm: FMIndex, dfm: DeviceFM,
                       reads: list[np.ndarray], L: int = 256,
                       MAXB: int = 64, MAXM: int = 128,
                       iters_factor: int = 16, padded=None
                       ) -> list[list[smem_golden.Intv]]:
    """Synchronous wrapper: seed_dispatch + seed_collect."""
    h = seed_dispatch(opt, fm, dfm, reads, L, MAXB, MAXM, iters_factor,
                      padded)
    return seed_collect(h)
