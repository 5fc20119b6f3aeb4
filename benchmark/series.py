#!/usr/bin/env python3
"""Run benchmark cells several times in a row and report their spread.

    python3 benchmark/series.py OUT_DIR SPEC [SPEC ...]

SPEC is `CELL:SEED,SEED,...:SECONDS:TRACE` for runs of
`benchmark/run.py`, one process a run, one after another, or
`control:CELL:SEED,...:BATCHES` for the control of `control.py`. Each
run's standard output and error go to OUT_DIR; the summary (each run's
result line, and for each cell and metric the median and the spread,
the distance between the first and the third quartile of
`statistics.quantiles(values, n=4)` as a share of the median) is
printed and written to OUT_DIR/summary.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list) -> dict:
    med = statistics.median(values)
    if len(values) < 2:
        return {"median": med, "spread": None, "n": len(values)}
    q = statistics.quantiles(values, n=4)
    return {"median": med, "spread": (q[2] - q[0]) / med if med else None,
            "n": len(values)}


def main(argv: list) -> int:
    out = Path(argv[0])
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = []
    for spec in argv[1:]:
        parts = spec.split(":")
        if parts[0] == "control":
            cell, seeds, batches = parts[1], parts[2], parts[3]
            cmd = [sys.executable, str(HERE / "control.py"), cell,
                   batches] + seeds.split(",")
            tag = f"control_{cell}"
            t0 = time.time()
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=3000)
            (out / f"{tag}.out").write_text(p.stdout)
            (out / f"{tag}.err").write_text(p.stderr)
            print(f"{tag} rc {p.returncode} {time.time() - t0:.1f} s\n"
                  + p.stdout[-3000:], flush=True)
            continue
        cell, seeds, secs, trace = parts
        for seed in seeds.split(","):
            cmd = [sys.executable, str(HERE / "run.py"), "--workload", cell,
                   "--seed", seed, "--seconds", secs, "--trace", trace]
            tag = f"{cell}_s{seed}_t{trace}_{len(runs)}"
            t0 = time.time()
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1300)
            wall = time.time() - t0
            (out / f"{tag}.err").write_text(p.stderr)
            last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else ""
            try:
                res = json.loads(last)
            except ValueError:
                res = None
            runs.append(dict(cell=cell, seed=int(seed), trace=int(trace),
                             rc=p.returncode, wall=wall, result=res))
            print(f"{tag} rc {p.returncode} wall {wall:.1f} s: {last}",
                  flush=True)
            if res is None or not res.get("correct"):
                print(p.stderr[-4000:], flush=True)
            else:
                print("\n".join(l for l in p.stderr.splitlines()
                                if l.startswith("[bench] set-up")
                                or l.startswith("[bench] window ")
                                or l.startswith("[bench] cpu s")
                                or l.startswith("[bench] reads/s by")
                                or l.startswith("[bench] reference")),
                      flush=True)
    summary: dict = {}
    for r in runs:
        if r["result"] is None:
            continue
        for m, v in r["result"]["metrics"].items():
            summary.setdefault(r["cell"], {}).setdefault(
                f"{m}@t{r['trace']}", []).append(v["value"])
    table = {c: {m: spread(v) | {"values": v} for m, v in ms.items()}
             for c, ms in summary.items()}
    (out / "summary.json").write_text(json.dumps(
        {"card": card, "runs": runs, "spreads": table}, indent=1))
    print(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
