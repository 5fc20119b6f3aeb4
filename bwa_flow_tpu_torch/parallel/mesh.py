"""One process on several devices: the mesh, read shards, index replicas
and the sharded device step.

Port of bwa_flow_tpu/parallel/mesh.py. The reference scales by data
parallelism over reads with the genome uploaded to every FPGA's DDR
(the reference's src/fpga/BWAOCLEnv.h:67-216). PyTorch has no Mesh and
no shard_map, so here:

  - a mesh is an ordered list of torch devices (make_mesh); a list may
    name one device more than once, so one card, or the CPU, can host
    several shards;
  - a shard is a contiguous block of a batch's rows on one of them
    (shard_rows, shard_reads), as P("dp") places it;
  - the index is replicated: one DeviceFM per device (replicate_fm);
  - each shard's program runs in a thread of its own (run_shards): torch
    releases the interpreter lock in its ops and blocking copies, so the
    shards of different cards overlap; the pipeline gives each shard on
    a card a stream of its own for its seed program, and one for copying
    its results back (shard_streams, on_stream), so two shards of one
    card need not take turns on one stream;
  - a collective (psum) is the sum of the shards' tensors on the first
    device.

The production pipeline shards through the same pieces
(pipeline/batch.py with `devices`).
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import torch

from .. import resolve_device
from ..ops import smem_torch
from ..ops.chain2aln_torch import seed_extend_batch
from ..ops.fm_torch import DeviceFM

I32 = torch.int32
# the sharded steps' fixed seeding constants (bwa defaults: min_seed_len,
# split_len, split_width, max_mem_intv, max_occ), as in the JAX module
SEED_ARGS = (19, 28, 10, 20, 500)
# ... and extension constants (o_del, e_del, o_ins, e_ins, w, pen_clip5,
# pen_clip3, zdrop)
EXT_ARGS = (6, 1, 6, 1, 100, 5, 5, 100)


def make_mesh(n_devices: int | None = None, device="cuda"
              ) -> list[torch.device]:
    """The first n_devices cards (all of them for None); raises when the
    host has fewer. With device="cpu", n_devices CPU shards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (n_devices or 1)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"need {n} CUDA devices, have {count}")
    return [torch.device("cuda", i) for i in range(n)]


def replicate_fm(dfm: DeviceFM, devices) -> list[DeviceFM]:
    """One copy of the index per device of the list."""
    return [dfm.replica(d) for d in devices]


def shard_rows(a, devices) -> list[torch.Tensor]:
    """Contiguous equal blocks of the rows of `a` (a numpy array or a
    tensor), block i on devices[i]. Raises when the rows do not divide
    evenly, as P("dp") does."""
    n, D = a.shape[0], len(devices)
    if n % D:
        raise ValueError(f"{n} rows do not shard evenly over {D} devices")
    per = n // D
    t = torch.as_tensor(a)
    return [t[i * per:(i + 1) * per].contiguous().to(d)
            for i, d in enumerate(devices)]


def shard_reads(q, qlen, devices):
    """A padded [B, L] read batch and its lengths, sharded by rows:
    (list of q blocks, list of qlen blocks)."""
    return shard_rows(q, devices), shard_rows(qlen, devices)


def shard_streams(devices) -> list:
    """A new CUDA stream for each card of the list (None for a CPU
    shard), each ordered after the work queued so far on its card's
    current stream (the upload of the index and its replicas)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            out.append(None)
            continue
        s = torch.cuda.Stream(d)
        s.wait_stream(torch.cuda.current_stream(d))
        out.append(s)
    return out


def on_stream(stream):
    """A context in which `stream` is the current stream of its card; no
    change for None (a CPU shard)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def run_shards(fn: Callable[[int], object], n: int) -> list:
    """fn(i) for every shard i < n, one thread each (inline for one
    shard); returns the results in shard order. Waits for every shard,
    then raises the first shard's failure: no shard's error is
    dropped."""
    if n == 1:
        return [fn(0)]
    with ThreadPoolExecutor(max_workers=n,
                            thread_name_prefix="shard") as ex:
        futs = [ex.submit(fn, i) for i in range(n)]
    return [f.result() for f in futs]


def _seed_hist(dfm, L, MAXB, MAXM, ITERS, q, qlen):
    """One shard's seed program and its seed-count histogram."""
    mems, n_mem, ovf, _occ_sa, _occ_total = smem_torch.collect_intv_device(
        dfm, L, MAXB, MAXM, ITERS, q, qlen, *SEED_ARGS)
    hist = torch.zeros(MAXM + 1, dtype=I32, device=q.device).index_add_(
        0, n_mem.clamp(0, MAXM).long(),
        torch.ones_like(n_mem, dtype=I32))
    return mems, n_mem, ovf, hist


def _gather(parts, dev) -> torch.Tensor:
    return torch.cat([p.to(dev) for p in parts])


def _psum(parts, dev) -> torch.Tensor:
    return torch.stack([p.to(dev) for p in parts]).sum(0)


def sharded_seed_step(devices, L: int, MAXB: int, MAXM: int, ITERS: int):
    """The multi-device seeding step: per shard the SMEM seed program on
    its read block against its own index replica, plus the psum'd
    seed-count histogram. Returns step(dfms, qs, qlens) -> (mems, n_mem,
    ovf, hist): the shards' outputs concatenated in shard order and the
    histogram summed, all on devices[0]."""
    dev0 = torch.device(devices[0])

    def step(dfms, qs, qlens):
        outs = run_shards(lambda i: _seed_hist(
            dfms[i], L, MAXB, MAXM, ITERS, qs[i], qlens[i]), len(devices))
        mems, n_mem, ovf, hist = zip(*outs)
        return (_gather(mems, dev0), _gather(n_mem, dev0),
                _gather(ovf, dev0), _psum(hist, dev0))
    return step


def sharded_align_step(devices, L: int, MAXB: int, MAXM: int, ITERS: int,
                       QMAX: int, TMAX: int):
    """The full per-batch device step over the shards: the seed program
    and the coupled banded extension (seed_extend_batch, right side only:
    the left windows are empty) on each shard, plus two psum merges, the
    seed-count histogram and the sum of the extension scores. Returns
    step(dfms, qs, qlens, qr_qs, qr_ns, tr_ts, tr_ns, h0s, mat) ->
    (mems, n_mem, ext int32[B, 2] = (rscore, ovf), hist, score_sum) on
    devices[0]; `mat` (int32[5, 5], any device) is copied to each
    shard's device."""
    dev0 = torch.device(devices[0])

    def shard(i, dfms, qs, qlens, qr_qs, qr_ns, tr_ts, tr_ns, h0s, mat):
        q = qs[i]
        mems, n_mem, ovf, hist = _seed_hist(dfms[i], L, MAXB, MAXM, ITERS,
                                            q, qlens[i])
        B, dev = q.shape[0], q.device
        zn = torch.zeros(B, dtype=I32, device=dev)
        ext = seed_extend_batch(
            QMAX, TMAX, torch.zeros((B, QMAX), dtype=I32, device=dev), zn,
            torch.zeros((B, TMAX), dtype=I32, device=dev), zn, qr_qs[i],
            qr_ns[i], tr_ts[i], tr_ns[i], h0s[i], mat.to(dev), *EXT_ARGS)
        rscore = ext[6]
        return (mems, n_mem, torch.stack([rscore, ovf.to(rscore.dtype)], 1),
                hist, rscore.sum(dtype=torch.int64))

    def step(*args):
        outs = run_shards(lambda i: shard(i, *args), len(devices))
        mems, n_mem, ext, hist, ssum = zip(*outs)
        return (_gather(mems, dev0), _gather(n_mem, dev0),
                _gather(ext, dev0), _psum(hist, dev0), _psum(ssum, dev0))
    return step
