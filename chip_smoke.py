"""Smoke run of bwa_flow_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases:
  1. device and build: prints the card (nvidia-smi name, power limit),
     the torch/CUDA versions, and builds every CUDA kernel of the main
     path from bwa_flow_tpu_torch/csrc/ (one nvcc per source, in
     parallel).
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: ksw_extend2 on 4096 right-extension tasks of
     151 bp reads (qmax=160, tmax=512, some degenerate lanes) under
     three scorings; every output must be equal (tolerance 0: all values
     are integers). Both are timed with CUDA events.
  3. the main path: a 4.6 Mbp repeat-realistic genome and 8192 x 151 bp
     reads (1% substitutions) from fixed seeds; `index`, then
     `mem -t 8 --batch-reads 4096` on the card through the CLI. Every
     read must have exactly one primary record, >= 95% mapped, and the
     kernel must have launched. Then a 256-read subset on the card and
     with --no-device (the port's host golden): the two SAMs must be
     byte-identical apart from @PG.
  4. one JSON line describing the kernels, the device line, and as the
     last line {"ok": true, "device": {...}}.

Exits non-zero without a CUDA device. Imports nothing of JAX or of the
JAX package. Work files go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

GENOME_LEN = 4_641_652       # E. coli K-12 MG1655 size
GENOME_SEED = 0xEC011
READ_LEN = 151
N_READS = 8192
BATCH = 4096
N_SUB = 256
QMAX, TMAX = 160, 512        # the wave shapes of the main path
B_EXT = 4096
# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM; int32 ops run on the 64
# INT32 lanes per SM, half the FP32 lanes behind the 67 TFLOP/s float32
# rate (an FMA counts 2): 132 SMs x 64 x 1.98 GHz = 16.7e12 int32 op/s
HBM_BPS = 3.35e12
INT32_OPS = 16.7e12
OPS_PER_CELL = 20            # int32 ops of one DP cell (csrc/ksw_extend.cu)

CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i


# --------------------------------------------------------------- genome
# Repeat-realistic synthetic genome: dispersed LINE/SINE-like families
# and tandem arrays at human-like fractions over a random backbone.

def _consensus(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _paste_dispersed(rng, g, consensus, frac, div, truncate=False,
                     chunk=200_000):
    """Scatter diverged copies of `consensus` over `g` (in place)."""
    elen = len(consensus)
    total_bp = int(len(g) * frac)
    if truncate:
        lens = (elen * (0.05 + 0.95 * rng.random(
            max(1, int(total_bp / (elen * 0.52)))))).astype(np.int64)
        lens = lens[np.cumsum(lens) <= total_bp]
    else:
        lens = np.full(max(1, total_bp // elen), elen, np.int64)
    pos = rng.integers(0, len(g) - elen - 1, len(lens))
    done = 0
    while done < len(lens):
        hi = done
        bp = 0
        while hi < len(lens) and bp < chunk * 64:
            bp += int(lens[hi])
            hi += 1
        for i in range(done, hi):
            L = int(lens[i])
            cp = consensus[elen - L:].copy()
            nmut = rng.binomial(L, div)
            if nmut:
                at = rng.integers(0, L, nmut)
                cp[at] = (cp[at] + rng.integers(1, 4, nmut)) & 3
            g[pos[i]:pos[i] + L] = cp
        done = hi


def _paste_tandems(rng, g, frac):
    total_bp = int(len(g) * frac)
    placed = 0
    while placed < total_bp:
        unit_len = int(rng.integers(2, 65))
        n_copies = int(rng.integers(8, 200))
        arr = np.tile(_consensus(rng, unit_len), n_copies)
        nmut = rng.binomial(len(arr), 0.02)
        if nmut:
            at = rng.integers(0, len(arr), nmut)
            arr[at] = (arr[at] + rng.integers(1, 4, nmut)) & 3
        p = int(rng.integers(0, len(g) - len(arr) - 1))
        g[p:p + len(arr)] = arr
        placed += len(arr)


def make_genome(length: int, seed: int, sine_frac=0.28, line_frac=0.12,
                tandem_frac=0.04) -> np.ndarray:
    """Symbols 0..3 of a repeat-realistic genome."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, length, dtype=np.uint8)
    if line_frac:
        _paste_dispersed(rng, g, _consensus(rng, 6000), line_frac, 0.12,
                         truncate=True)
    if sine_frac:
        anc = _consensus(rng, 300)
        young = anc.copy()
        at = rng.integers(0, 300, 15)
        young[at] = (young[at] + rng.integers(1, 4, 15)) & 3
        _paste_dispersed(rng, g, anc, sine_frac * 0.6, 0.12)
        _paste_dispersed(rng, g, young, sine_frac * 0.4, 0.04)
    if tandem_frac:
        _paste_tandems(rng, g, tandem_frac)
    return g


def write_inputs(work: Path, genome: np.ndarray, n_reads: int, seed: int):
    """ref.fa, reads.fq (n_reads x 151 bp, 1% substitutions, both
    strands) and sub.fq (the first N_SUB reads)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    text = bases[genome].tobytes().decode()
    with open(work / "ref.fa", "w") as f:
        f.write(">chr1 synthetic repeat-realistic genome\n")
        for i in range(0, len(text), 80):
            f.write(text[i:i + 80] + "\n")
    rng = np.random.default_rng(seed)
    comp = np.array([3, 2, 1, 0], np.uint8)
    recs = []
    for i in range(n_reads):
        pos = int(rng.integers(0, len(genome) - READ_LEN))
        r = genome[pos:pos + READ_LEN].copy()
        m = rng.random(READ_LEN) < 0.01
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if rng.random() < 0.5:
            r = comp[r[::-1]]
        recs.append(f"@r{i}\n{bases[r].tobytes().decode()}\n+\n"
                    f"{'I' * READ_LEN}\n")
    (work / "reads.fq").write_text("".join(recs))
    (work / "sub.fq").write_text("".join(recs[:N_SUB]))


# ------------------------------------------------------------ kernels

def make_ext_tasks(rng, genome, n):
    """Right extensions after a 19-32 bp seed of 151 bp reads with 1%
    substitutions, target window qlen + 100 (the bench's task shape),
    plus degenerate lanes (qlen == 0 or tlen == 0)."""
    q = np.zeros((n, QMAX), np.int32)
    t = np.zeros((n, TMAX), np.int32)
    ql = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    h0 = np.zeros(n, np.int32)
    for b in range(n):
        pos = int(rng.integers(0, len(genome) - READ_LEN - 200))
        seed = int(rng.integers(19, 33))
        qn = READ_LEN - seed
        tn = min(TMAX, qn + 100)
        r = genome[pos + seed:pos + seed + qn].astype(np.int32)
        m = rng.random(qn) < 0.01
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        q[b, :qn] = r
        t[b, :tn] = genome[pos + seed:pos + seed + tn]
        ql[b], tl[b], h0[b] = qn, tn, seed
    ql[::97] = 0                 # degenerate lanes
    tl[5::101] = 0
    return q, ql, t, tl, h0


def _time_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def phase_kernels(genome: np.ndarray, device) -> dict:
    """ksw_extend2 kernel vs its plain version at the wave shapes."""
    import torch

    from bwa_flow_tpu_torch.ops import extend_cuda, extend_torch
    from bwa_flow_tpu_torch.utils.opts import MemOpt

    rng = np.random.default_rng(0x5EED)
    q, ql, t, tl, h0 = make_ext_tasks(rng, genome, B_EXT)
    args = [torch.as_tensor(a, device=device) for a in (q, ql, t, tl, h0)]
    opt = MemOpt()
    asym = MemOpt(o_del=5, e_del=2, o_ins=9, e_ins=1, a=2, b=5)
    asym.refresh_mat()
    scorings = [("bwa defaults", opt, opt.w, opt.zdrop),
                ("narrow band w=10", opt, 10, opt.zdrop),
                ("zdrop=0 asymmetric gaps", asym, asym.w, 0)]
    res = dict(max_abs_err=0)
    for name, o, w, zd in scorings:
        mat = torch.as_tensor(np.ascontiguousarray(o.mat[:5, :5]),
                              dtype=torch.int32, device=device)
        sc = (o.o_del, o.e_del, o.o_ins, o.e_ins, w, o.pen_clip3, zd)
        got = extend_cuda.extend_core_cuda(QMAX, TMAX, *args[:5], mat, *sc)
        torch.cuda.synchronize()
        stats: dict = {}
        want = extend_torch.extend_core(QMAX, TMAX, *args[:5], mat, *sc,
                                        stats=stats)
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        bad = sum(int((a != b).sum()) for a, b in zip(got, want))
        ms = _time_ms(lambda: extend_cuda.extend_core_cuda(
            QMAX, TMAX, *args[:5], mat, *sc), 50)
        plain_ms = _time_ms(lambda: extend_torch.extend_core(
            QMAX, TMAX, *args[:5], mat, *sc), 20)
        cells = stats["cells"]
        print(f"[kernel] ksw_extend2 {name}: B={B_EXT} mismatching "
              f"values {bad}, max |err| {err}; kernel {ms:.4f} ms "
              f"({cells / ms / 1e6:.3f} GCUPS), plain {plain_ms:.3f} ms "
              f"({cells / plain_ms / 1e6:.3f} GCUPS), {cells} cells")
        if bad:
            raise SystemExit(f"ksw_extend2 disagrees with its plain "
                             f"version under {name}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if "ms" not in res:   # the defaults are the main path's scoring
            nbytes = (sum(a.numel() for a in args) + B_EXT + 25
                      + 6 * B_EXT) * 4
            t_bytes = nbytes / HBM_BPS * 1e3
            t_ops = cells * OPS_PER_CELL / INT32_OPS * 1e3
            res.update(ms=ms, plain_ms=plain_ms, cells=cells, bytes=nbytes,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
    return res


# ----------------------------------------------------------- main path

def _records(path: Path) -> list[list[str]]:
    return [l.split("\t") for l in path.read_text().splitlines()
            if l and not l.startswith("@")]


def phase_main_path(work: Path, device: str) -> dict:
    """index + mem through the port's CLI; returns the run's numbers."""
    import torch

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.ops import extend_cuda
    from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

    t0 = time.perf_counter()
    assert cli.main(["index", str(work / "ref.fa")]) == 0
    t_index = time.perf_counter() - t0
    print(f"[main] index of {GENOME_LEN} bp: {t_index:.1f} s")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    extend_cuda.n_launches = 0            # count only the main path run
    tracer.totals.clear()
    tracer.counts.clear()
    t0 = time.perf_counter()
    assert cli.main(["mem", "-t", "8", "--batch-reads", str(BATCH),
                     "--device", device, "-o", str(work / "full.sam"),
                     str(work / "ref.fa"), str(work / "reads.fq")]) == 0
    dt = time.perf_counter() - t0
    launches = extend_cuda.n_launches
    st = dict(cli.last_run_stats)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    seed_per_batch = st["seed_s"] / max(1, st["seed_batches"])
    print(f"[main] mem {N_READS} reads: {dt:.2f} s, "
          f"{N_READS / dt:.1f} reads/s (index load included); seed "
          f"program {seed_per_batch:.3f} s/batch over "
          f"{st['seed_batches']} batches; waves {st['waves']}, device "
          f"tasks {st['ext_tasks_device']}, host tasks "
          f"{st['ext_tasks_host']}, band retries {st['band_retries']}; "
          f"ksw_extend2 launches {launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    print(f"[main] spans (host wall clock, s): {tracer.as_json()}")

    recs = _records(work / "full.sam")
    primary: dict = {}
    mapped = 0
    for f in recs:
        flag = int(f[1])
        if not flag & 0x900:
            primary[f[0]] = primary.get(f[0], 0) + 1
            mapped += 0 if flag & 0x4 else 1
    names = {f[0] for f in recs}
    if len(names) != N_READS or any(primary.get(n) != 1 for n in names):
        raise SystemExit("full.sam: not exactly one primary record per "
                         "read")
    frac = mapped / N_READS
    print(f"[main] {N_READS} reads, {len(recs)} records, mapped "
          f"{frac:.4f}")
    if frac < 0.95:
        raise SystemExit(f"full.sam: only {frac:.4f} of reads mapped")
    if device == "cuda" and launches <= 0:
        raise SystemExit("the main path never launched ksw_extend2")

    # device SAM == host golden SAM on a subset, apart from @PG
    assert cli.main(["mem", "--device", device, "-o",
                     str(work / "sub_dev.sam"), str(work / "ref.fa"),
                     str(work / "sub.fq")]) == 0
    assert cli.main(["mem", "--no-device", "-o", str(work / "sub_host.sam"),
                     str(work / "ref.fa"), str(work / "sub.fq")]) == 0

    def body(p):
        return [l for l in p.read_text().splitlines()
                if not l.startswith("@PG")]
    dev_sam, host_sam = body(work / "sub_dev.sam"), body(work / "sub_host.sam")
    if dev_sam != host_sam:
        raise SystemExit("device SAM differs from the --no-device SAM on "
                         f"the {N_SUB}-read subset")
    print(f"[main] {N_SUB}-read subset: device SAM == --no-device SAM "
          f"({len(dev_sam)} lines)")
    return dict(launches=launches, reads_per_s=N_READS / dt,
                seed_s_per_batch=seed_per_batch, stats=st, peak=peak)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bwa_flow_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all(["ksw_extend"])
    print(f"[build] csrc/ksw_extend.cu: {time.perf_counter() - t0:.2f} s")

    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    genome = make_genome(GENOME_LEN, GENOME_SEED)
    write_inputs(WORK, genome, N_READS, GENOME_SEED + 1)
    print(f"[data] genome {GENOME_LEN} bp + {N_READS} reads: "
          f"{time.perf_counter() - t0:.1f} s")

    kres = phase_kernels(genome, torch.device("cuda"))
    mres = phase_main_path(WORK, "cuda")

    kern = {
        "name": "ksw_extend2", "route": "cuda",
        "source": "bwa_flow_tpu_torch/csrc/ksw_extend.cu",
        "replaces": "bwa_flow_tpu/ops/extend_pallas.py:550",
        "replaces_kernel": "bwa_flow_tpu/ops/extend_pallas.py::_make_kernel",
        "checked": True, "launches": mres["launches"],
        "max_abs_err": kres["max_abs_err"], "ms": kres["ms"],
        "plain_ms": kres["plain_ms"], "bound_ms": kres["bound_ms"],
        "bound_by": kres["bound_by"], "library_ms": None,
        "cells": kres["cells"], "bytes": kres["bytes"]}
    print(json.dumps({"kernels": [kern]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
