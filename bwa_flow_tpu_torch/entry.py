"""Entry points: one device step, and a sharded dry run.

The counterparts of the repository root's __graft_entry__.py for this
package:

  - entry(device) returns the flagship device step, the fused device
    compute of one pipeline batch (the SMEM seed program, then the
    coupled two-try seed extension), with example arguments built from a
    small synthetic genome;
  - dryrun_multichip(n, devices) runs one full sharded step over an
    n-device mesh (index replicas, read shards, seed program and coupled
    extension per shard, the psum merges), then the production pipeline
    with n shards, whose SAM must equal the one-device SAM. The JAX
    package skips that second half without its native extensions; the
    port's host libraries build at first use, so it always runs, with
    device waves on every shard (--ext-mode waves, nothing drained on
    the host, no harvester).

Both run on `cuda` unless the caller asks for the CPU. A device list may
repeat a device, so one card, or the CPU, can host n shards.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .index.build import build_index
from .io.sam import Read
from .ops import smem_torch
from .ops.chain2aln_torch import seed_extend_batch
from .ops.fm_torch import DeviceFM
from .parallel.mesh import (make_mesh, replicate_fm, shard_reads,
                            shard_rows, sharded_align_step)
from .pipeline.dataflow import AlignPipeline
from .utils.opts import MemOpt

I32 = torch.int32


def _build_example(device, genome_len=4096, n_reads=8, read_len=64,
                   pad_to=None):
    """(fm, dfm on device, q int32[n_reads, pad_to], qlen) from seed
    0xE17: the inputs of __graft_entry__._build_example."""
    rng = np.random.default_rng(0xE17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, genome_len)]
    fm = build_index([("chr1", "", genome.tobytes())])
    dfm = DeviceFM.from_host(fm, device)
    code = np.full(256, 4, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        code[ch] = i
    q = np.full((n_reads, pad_to or read_len), 4, np.int32)
    qlen = np.full(n_reads, read_len, np.int32)
    for b in range(n_reads):
        pos = int(rng.integers(0, genome_len - read_len))
        r = code[genome[pos:pos + read_len]].astype(np.int32)
        m = rng.random(read_len) < 0.03
        r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        q[b, :read_len] = r
    return fm, dfm, q, qlen


def entry(device="cuda"):
    """(fn, example_args): the one-device flagship step and its inputs
    on `device`. fn returns (mems, n_mem, ovf, occ_sa, occ_total, ext),
    ext the 12 outputs of seed_extend_batch."""
    dev = resolve_device(device)
    L, MAXB, MAXM, ITERS = 64, 32, 64, 512
    QMAX, TMAX = 64, 128
    opt = MemOpt()
    _fm, dfm, q, qlen = _build_example(dev, read_len=48, pad_to=L)
    B = q.shape[0]

    # synthetic but real extension tasks: right-extend a 20 bp seed
    qr_q = np.zeros((B, QMAX), np.int32)
    qr_q[:, :28] = q[:, 20:48]
    tr_t = np.zeros((B, TMAX), np.int32)
    tr_t[:, :48] = q[:, :48]

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=dev)

    def fn(dfm, q, qlen, ql_q, ql_n, qr_q, qr_n, tr_t, tr_n, h0, mat):
        mems, n_mem, ovf, occ_sa, occ_total = \
            smem_torch.collect_intv_device(
                dfm, L, MAXB, MAXM, ITERS, q, qlen, opt.min_seed_len,
                opt.split_len, opt.split_width, opt.max_mem_intv,
                opt.max_occ)
        ext = seed_extend_batch(
            QMAX, TMAX, ql_q, ql_n,
            torch.zeros((B, TMAX), dtype=I32, device=q.device),
            torch.zeros(B, dtype=I32, device=q.device), qr_q, qr_n, tr_t,
            tr_n, h0, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.w, opt.pen_clip5, opt.pen_clip3, opt.zdrop)
        return mems, n_mem, ovf, occ_sa, occ_total, ext

    example_args = (dfm, put(q), put(qlen), put(np.zeros((B, QMAX))),
                    put(np.zeros(B)), put(qr_q), put(np.full(B, 28)),
                    put(tr_t), put(np.full(B, 48)), put(np.full(B, 20)),
                    put(opt.mat[:5, :5]))
    return fn, example_args


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One full sharded device step over n_devices shards on tiny shapes,
    then the production pipeline with n shards against one device.
    `devices` (default: the first n cards) may repeat a device. Raises
    when a check fails; returns the step's merged histogram and score
    sum and the sharded run's per-shard counters."""
    devices = make_mesh(n_devices) if devices is None else \
        [resolve_device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for {n_devices}")
    L, MAXB, MAXM, ITERS = 64, 16, 32, 256
    QMAX, TMAX = 64, 128
    B = 2 * n_devices
    fm, dfm, q, qlen = _build_example(devices[0], genome_len=2048,
                                      n_reads=B, read_len=40, pad_to=L)
    dfms = replicate_fm(dfm, devices)
    qs, qls = shard_reads(q, qlen, devices)

    # real extension tasks: right-extend each read's 16 bp seed prefix;
    # the reference window is the read's own remainder, so a perfect
    # extension scores h0 + 24 matches = 40
    qr_q = np.zeros((B, QMAX), np.int32)
    qr_q[:, :24] = q[:, 16:40]
    tr_t = np.zeros((B, TMAX), np.int32)
    tr_t[:, :24] = q[:, 16:40]
    ext_in = [shard_rows(a, devices) for a in (
        qr_q, np.full(B, 24, np.int32), tr_t, np.full(B, 24, np.int32),
        np.full(B, 16, np.int32))]
    mat = torch.as_tensor(np.ascontiguousarray(MemOpt().mat[:5, :5]),
                          dtype=I32)

    step = sharded_align_step(devices, L, MAXB, MAXM, ITERS, QMAX, TMAX)
    _mems, n_mem, ext, hist, score_sum = step(dfms, qs, qls, *ext_in, mat)
    n_mem, hist = n_mem.cpu().numpy(), hist.cpu().numpy()
    rscore = ext[:, 0].cpu().numpy()
    if hist.sum() != B:
        raise RuntimeError("psum histogram lost lanes")
    if not (n_mem > 0).any():
        raise RuntimeError("no seeds found in the dry run")
    # exact-match extension of a perfect seed must reach the full read
    if not (rscore >= 40).all():
        raise RuntimeError("sharded extension gave wrong scores")
    if int(score_sum) != int(rscore.sum()):
        raise RuntimeError("psum score merge wrong")

    # the production pipeline sharded over the same devices must give
    # the one-device SAM byte for byte
    def run_pipe(devs):
        # waves mode with no host drain and no harvester: every task
        # that fits runs in a device wave, on every shard
        pipe = AlignPipeline(MemOpt(), fm, paired=False, n_workers=0,
                             devices=devs, ext_mode="waves",
                             aligner_kw=dict(smem_L=L, wave_cap=64,
                                             qmax=64, tmax=192, drain_max=0,
                                             harvest_workers=0))
        done: list = []
        try:
            rds = [Read(name=f"d{i}", seq=q[i, :40].astype(np.uint8),
                        qual="I" * 40, id=i) for i in range(B)]
            step = max(2, B // 2)
            pipe.run(iter([rds[i:i + step] for i in range(0, B, step)]),
                     done.extend)
        finally:
            pipe.close()
        return [r.sam for r in done], pipe.ba.stats

    sam_one, _ = run_pipe(devices[:1])
    sam_n, stats = run_pipe(devices)
    if sam_n != sam_one:
        raise RuntimeError("the sharded production pipeline diverges from "
                           "the one-device run")
    if any(sh["waves"] == 0 for sh in stats["shards"]):
        raise RuntimeError("a shard of the sharded production pipeline "
                           "ran no device wave")
    return dict(hist=hist.tolist(), score_sum=int(score_sum),
                shards=stats["shards"])
