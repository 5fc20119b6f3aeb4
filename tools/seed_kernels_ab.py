"""Time the seed kernels of two checkouts of bwa_flow_tpu_torch on one
CUDA card, in turns, with chip_smoke.py's phase 12 machinery.

    python3 tools/seed_kernels_ab.py OLD_ROOT NEW_ROOT
    python3 tools/seed_kernels_ab.py --one ROOT

With two roots it runs OLD, NEW, NEW, OLD, each in a process of its own
(``--one ROOT``), and prints each run's numbers and, last, a JSON line
with the per-kernel times of both sides. A ``--one`` run imports ROOT's
package and ROOT's chip_smoke.py, builds ROOT's four seed kernels
(nvcc, printing each kernel's ptxas registers and stack), makes
chip_smoke.py's genome and reads in ROOT/build/chip_smoke, indexes the
genome, and runs chip_smoke's ``_seed_batch`` on the SE batch (the
first 4096 reads) and the PE batch (2048 pairs), timed: each kernel call
of the seed program held against its plain version (tolerance 0) and
its ms a launch from CUDA events. It prints one JSON line: ms a launch
by kernel and batch. Both roots make the same data from the same seeds.
Exits non-zero without a CUDA card.
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
    from bwa_flow_tpu_torch.io.fastq import read_seqs
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
    se = [r.seq for r in itertools.islice(read_seqs(work / "reads.fq"),
                                          cs.SEED_B)]
    pe = [r.seq for pair in itertools.islice(
        zip(read_seqs(work / "r1.fq"), read_seqs(work / "r2.fq")),
        cs.SEED_B // 2) for r in pair]
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


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve())
        return 0
    old, new = (Path(a).resolve() for a in argv[:2])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[ab] card: {smi.stdout.strip()}")
    runs = {"old": [], "new": []}
    for side, root in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        r = subprocess.run([sys.executable, __file__, "--one", str(root)],
                           capture_output=True, text=True, timeout=1200)
        print(r.stdout[-6000:], r.stderr[-3000:], sep="\n")
        if r.returncode != 0:
            raise SystemExit(f"the {side} run failed ({r.returncode})")
        runs[side].append(json.loads(r.stdout.strip().splitlines()[-1]))
    print(json.dumps({side: [x["ms"] for x in v]
                      for side, v in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
