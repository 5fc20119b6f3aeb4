#!/usr/bin/env python3
"""The control of `correct`: the plain reference put in the program's
place with one guarantee broken (ungapped alignment), judged by the same
comparison and limits as a run.

    python3 benchmark/control.py CELL BATCHES SEED [SEED ...]

For each seed it draws the sample a run of BATCHES batches would judge
(BATCHES: what a window of the cell holds), aligns it with the
ungapped control, and prints each number beside the cell's limit and
whether the control came out correct (it must not). It needs only the
configuration's genome, which it makes if the cache lacks it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import genome as genome_mod  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402


def control(bench: dict, cell_name: str, n_batches: int, seed: int) -> dict:
    cell, config, mix, limits = run.resolve(bench, cell_name)
    genome_mod.ensure_genome(config)
    g = genome_mod.genome_of(config)
    paired = mix["layout"] == "pe"
    s = run.draw_sample(config, mix, seed, n_batches)
    per = 2 if paired else 1
    records = reference.ungapped_records(
        g, s["reads"], s["rev"], s["lo"], s["hi"], s["name"],
        config["scoring"], paired)
    # the control marks the duplicates it knows of, every fragment of a
    # place after its first: only the guarantee of gapped alignment is
    # broken
    firsts: dict = {}
    for name, grp, f in zip(s["name"][::per], s["group"][::per],
                            s["frag"][::per]):
        if grp >= 0:
            firsts[grp] = min(firsts.get(grp, f), f)
    for name, grp, f in zip(s["name"][::per], s["group"][::per],
                            s["frag"][::per]):
        if grp >= 0 and f != firsts[grp]:
            records[name] = [_dup(line) for line in records[name]]
    judged = reference.compare(s, records, g, config["scoring"], paired,
                               genome_mod.repeats_of(config))
    checks = {k: {"value": judged[k], "limit": limits[k]} for k in limits
              if k in judged}
    return dict(seed=seed, batches=n_batches, reads=judged["reads"],
                correct=all(c["value"] <= c["limit"]
                            for c in checks.values()), checks=checks,
                why=judged["why"][-1:])


def _dup(line: str) -> str:
    f = line.split("\t")
    f[1] = str(int(f[1]) | reference.F_DUP)
    return "\t".join(f)


def main(argv: list) -> int:
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, n_batches = argv[0], int(argv[1])
    for seed in argv[2:]:
        t0 = time.perf_counter()
        res = control(bench, cell, n_batches, int(seed))
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
