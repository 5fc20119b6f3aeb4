"""Fixtures of the benchmark's own tests: the harness's modules on the
path, and a tiny configuration whose genome and index live in a
temporary cache, so the CPU runs never touch `benchmark/.cache/`."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LEN = 60_000


# Cells whose files the benchmark keeps while BENCHMARK.json leaves them
# out, because their rate spreads too widely on a shared host (PERF.md):
# the harness still has to drive them, at a tiny size, for their return.
KEPT_OUT = [("ecoli.pe151", "ecoli_k12", "pe151"),
            ("dm6.se151", "dm6", "se151")]


@pytest.fixture
def bench():
    import run
    return run.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def bench_kept(bench):
    """BENCHMARK.json with the kept-out cells added back."""
    names = {w["name"] for w in bench["workloads"]}
    extra = [dict(name=n, config=c, traffic=t, chips=1, why="kept out")
             for n, c, t in KEPT_OUT if n not in names]
    return dict(bench, workloads=bench["workloads"] + extra)


@pytest.fixture
def tiny_cache(tmp_path_factory, monkeypatch):
    import genome
    cache = tmp_path_factory.getbasetemp() / "bench_cache"
    monkeypatch.setattr(genome, "CACHE", cache)
    return cache


def tiny_genome(spec: dict, length: int, full: int) -> dict:
    """A configuration's genome spec scaled from `full` to `length`
    bases: copies and arrays in proportion (at least one), consensus
    sequences and arrays no longer than a quarter of their region."""
    f = length / full

    def room(x):
        a, b = x.get("region", (0.0, 1.0))
        return int((b - a) * length) // 4

    def scaled(x, count):
        return dict(x, **{count: max(1, round(x[count] * f))})
    reps = []
    for fam in spec.get("repeats", []):
        places = [scaled(p, "copies")
                  for p in fam.get("placements", [fam])]
        elen = min(int(fam["length"]), min(room(p) for p in places))
        fam = dict(fam, length=elen)
        if "placements" in fam:
            fam["placements"] = places
        else:
            fam = dict(places[0], length=elen)
        reps.append(fam)
    sats = [dict(scaled(x, "arrays"), units=max(2, min(
        int(x["units"]), room(x) // int(x["unit"]))))
        for x in spec.get("satellites", [])]
    return dict(spec, repeats=reps, satellites=sats)


def tiny_cell(bench, cell_name: str, batch_reads: int = 256, **mix_keys):
    """The cell `cell_name` at a size a CPU test holds: its configuration
    cut to TINY_LEN bases (its repeats in proportion), batches of
    `batch_reads` reads, one warm-up batch, and `mix_keys` over its mix."""
    import run
    cell, config, mix, limits = run.resolve(bench, cell_name)
    config = dict(config, name=f"tiny_{config['name']}", length=TINY_LEN,
                  genome=tiny_genome(config["genome"], TINY_LEN,
                                     int(config["length"])))
    mix = dict(mix, batch_reads=batch_reads, warmup_batches=1, **mix_keys)
    return cell, config, mix, limits
