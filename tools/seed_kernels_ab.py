"""Time the seed kernels, or the LF walk of SA lookup, of two checkouts
of bwa_flow_tpu_torch on one CUDA card, in turns, with chip_smoke.py's
machinery.

    python3 tools/seed_kernels_ab.py OLD_ROOT NEW_ROOT
    python3 tools/seed_kernels_ab.py --one ROOT
    python3 tools/seed_kernels_ab.py --sa-batch OLD_ROOT NEW_ROOT
    python3 tools/seed_kernels_ab.py --sa-batch --one ROOT

With two roots it runs OLD, NEW, NEW, OLD, each in a process of its own
(``--one ROOT``), and prints each run's numbers and, last, a JSON line
with the numbers of both sides. A ``--one`` run imports ROOT's package
and ROOT's chip_smoke.py, builds ROOT's kernels (nvcc, printing each
kernel's ptxas registers and stack), makes chip_smoke.py's genome and
reads in ROOT/build/chip_smoke and indexes the genome. Both roots make
the same data from the same seeds. Exits non-zero without a CUDA card.

Seed kernels (the default): chip_smoke's ``_seed_batch`` on the SE batch
(the first 4096 reads) and the PE batch (2048 pairs), timed: each kernel
call of the seed program held against its plain version (tolerance 0)
and its ms a launch from CUDA events. It prints one JSON line: ms a
launch by kernel and batch.

``--sa-batch``: the index loaded with its SA re-sampled to interval 4
and no dense SA (chip_smoke.py phase 11(e)'s index), the seed program
run on the SE batch and resolve_sa_flat on its intervals with no seed
handle, every fm_torch.sa_batch call of both recorded (the fused walk's
and the probe path's chunks). Each recorded call then runs again on
ROOT's sa_batch: its device ms (CUDA events around the whole call, the
L2 flushed, the stream held, so every launch and torch op of the call is
counted) and its host enqueue ms (the host's clock around the call while
a spin kernel holds the stream), means of WALK_REPS runs, and the
kernel's launches a call. It prints one JSON line with each call's
numbers.
"""

from __future__ import annotations

import importlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

SEED_KERNELS = ("seed_p1p3", "seed_fwd", "seed_bwd", "seed_cohort")


def one(root: Path) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("seed_kernels_ab: no CUDA device")
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")
    from bwa_flow_tpu_torch import _build, cli
    from bwa_flow_tpu_torch.io.fastq import read_batches
    from bwa_flow_tpu_torch.ops import smem_torch
    from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
    from bwa_flow_tpu_torch.utils.opts import MemOpt

    t0 = time.perf_counter()
    _build.build_all(SEED_KERNELS)
    for name in SEED_KERNELS:
        for line in _build.build_log(name).splitlines():
            if "stack frame" in line or "Used" in line:
                print(f"[ab] {root.name} {name}.cu ptxas: {line.strip()}")
    work = cs.WORK
    work.mkdir(parents=True, exist_ok=True)
    genome = cs.make_genome(cs.GENOME_LEN, cs.GENOME_SEED)
    cs.write_inputs(work, genome, cs.N_READS, cs.GENOME_SEED + 1)
    cs.write_pe_inputs(work, genome, cs.N_PAIRS, cs.GENOME_SEED + 2)
    assert cli.main(["index", str(work / "ref.fa")]) == 0
    from bwa_flow_tpu_torch.index.io import load_index
    ba = BatchAligner(MemOpt(), load_index(str(work / "ref.fa")),
                      smem_L=cs.SEED_L, device="cuda")
    se = [r.seq for r in itertools.islice(itertools.chain.from_iterable(
        read_batches(work / "reads.fq")), cs.SEED_B)]
    pe = [r.seq for r in itertools.islice(itertools.chain.from_iterable(
        read_batches(work / "r1.fq", work / "r2.fq")), cs.SEED_B // 2 * 2)]
    out = {}
    for tag, reads in (("se", se), ("pe", pe)):
        q, qlen = smem_torch.pad_reads(reads, cs.SEED_L)
        res = cs._seed_batch(tag, ba.dfm.narrow(), ba.put(q, ba.device),
                             ba.put(qlen, ba.device), 128, dict(pack_H=32),
                             True)
        out[tag] = {n: sum(c["ms"] for c in res[n]) / len(res[n])
                    for n in SEED_KERNELS}
    rec = dict(root=str(root), card=torch.cuda.get_device_name(0),
               ms=out, seconds=time.perf_counter() - t0)
    print(json.dumps(rec))
    return rec


def one_sa_batch(root: Path) -> dict:
    import os

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("seed_kernels_ab: no CUDA device")
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")
    from bwa_flow_tpu_torch import _build, cli
    from bwa_flow_tpu_torch.index import io as idx_io
    from bwa_flow_tpu_torch.io.fastq import read_batches
    from bwa_flow_tpu_torch.ops import fm_cuda, fm_torch, smem_torch
    from bwa_flow_tpu_torch.pipeline import batch
    from bwa_flow_tpu_torch.utils.opts import MemOpt

    t0 = time.perf_counter()
    _build.build_all(("sa_walk",) + SEED_KERNELS)
    for line in _build.build_log("sa_walk").splitlines():
        if "stack frame" in line or "Used" in line:
            print(f"[ab] {root.name} sa_walk.cu ptxas: {line.strip()}")
    work = cs.WORK
    work.mkdir(parents=True, exist_ok=True)
    genome = cs.make_genome(cs.GENOME_LEN, cs.GENOME_SEED)
    cs.write_inputs(work, genome, cs.SEED_B, cs.GENOME_SEED + 1)
    assert cli.main(["index", str(work / "ref.fa")]) == 0
    idx_io.RESAMPLE_MIN = 0
    os.environ["BWA_TPU_DENSE_SA_MAX"] = "0"
    fm = idx_io.load_index(str(work / "ref.fa"))
    assert fm.sa_intv == 4
    ba = batch.BatchAligner(MemOpt(), fm, smem_L=cs.SEED_L, device="cuda")
    seqs = [r.seq for r in itertools.islice(itertools.chain.from_iterable(
        read_batches(work / "reads.fq")), cs.SEED_B)]
    calls = []
    real = fm_torch.sa_batch

    def rec(dfm, k, max_iters=256, intv=0, fetch=fm_torch.to_host):
        calls.append((dfm, k.clone(), max_iters, intv))
        return real(dfm, k, max_iters, intv, fetch)
    smem_torch.sa_batch = batch.sa_batch = rec
    try:
        h = ba.seeds_dispatch(seqs)
        ba.resolve_sa_flat(ba.seeds_collect(h), None)
        torch.cuda.synchronize()
    finally:
        smem_torch.sa_batch = batch.sa_batch = real
    flush_buf = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.int32,
                            device="cuda")

    def flush():
        flush_buf.fill_(1)
    out = []
    for ci, (dfm, k, max_iters, intv) in enumerate(calls):
        def call():
            return real(dfm, k, max_iters, intv)
        n0 = fm_cuda.n_launches["sa_walk"]
        dev_ms = cs._held_launch_ms([call] * (WALK_REPS + 1), flush)
        launches = (fm_cuda.n_launches["sa_walk"] - n0) / (WALK_REPS + 1)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(cs.HOLD_S * cs.SPIN_HZ))
        host = []
        for _ in range(WALK_REPS):
            t1 = time.perf_counter()
            call()
            host.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        out.append(dict(call=ci, slots=k.numel(), intv=intv,
                        max_iters=max_iters, device_ms=dev_ms,
                        host_ms=sum(host) / len(host) * 1e3,
                        launches=launches))
        print(f"[ab] {root.name} call {ci}: {k.numel()} rows, intv {intv}: "
              f"device {dev_ms:.4f} ms, host enqueue "
              f"{out[-1]['host_ms']:.4f} ms, {launches:g} launches a call")
    rec_ = dict(root=str(root), card=torch.cuda.get_device_name(0),
                calls=out, seconds=time.perf_counter() - t0)
    print(json.dumps(rec_))
    return rec_


WALK_REPS = 5      # timed runs of each recorded sa_batch call


def main(argv: list[str]) -> int:
    sa = argv[:1] == ["--sa-batch"]
    argv = argv[1:] if sa else argv
    if argv[:1] == ["--one"]:
        (one_sa_batch if sa else one)(Path(argv[1]).resolve())
        return 0
    old, new = (Path(a).resolve() for a in argv[:2])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[ab] card: {smi.stdout.strip()}")
    runs = {"old": [], "new": []}
    for side, root in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        r = subprocess.run([sys.executable, __file__,
                            *(["--sa-batch"] if sa else []), "--one",
                            str(root)],
                           capture_output=True, text=True, timeout=1200)
        print(r.stdout[-6000:], r.stderr[-3000:], sep="\n")
        if r.returncode != 0:
            raise SystemExit(f"the {side} run failed ({r.returncode})")
        runs[side].append(json.loads(r.stdout.strip().splitlines()[-1]))
    print(json.dumps({side: [x["calls" if sa else "ms"] for x in v]
                      for side, v in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
