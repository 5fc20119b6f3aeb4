"""The zebrafish configuration (GRCz11) and its cell: the file with its
length cut (the one key reduced) and still above 2^31 BWT rows, its
assumptions stated, its repeat classes at the published 52.2% in
proportion at a thousandth of the length, and a whole traced run of the
cell on the CPU at a tiny size, forced onto the wide path (the int64
machine, the int64 SA at interval 8) that the configuration's genome
takes, correct and reading its new metrics."""

import json

import pytest

import genome
import run
from conftest import BENCH, ROOT, tiny_cell, tiny_genome

FULL = 1_373_454_788      # GRCz11's golden path
CUT = 1_080_000_000       # what a run's set-up builds within its limit


@pytest.fixture
def cfg():
    return run.load_json(BENCH / "configs" / "grcz11.json")


def test_length_cut_above_2_31_rows(bench, cfg):
    assert cfg["length"] == CUT and cfg["reduced"] == ["length"]
    assert "1,373,454,788" in cfg["source"]
    assert cfg["assumed"] and all(isinstance(a, str) for a in cfg["assumed"])
    entry = {c["name"]: c for c in bench["configs"]}["grcz11"]
    assert entry["file"] == "benchmark/configs/grcz11.json"
    assert entry["reduced"] == ["length"] and len(cfg["source"]) <= 200
    # above 2^31 BWT rows, below 2^32, as at the full length
    assert 2**31 < 2 * cfg["length"] < 2 * FULL < 2**32


def test_cell_is_pe151_on_one_chip_with_exact_limits(bench):
    cell = {w["name"]: w for w in bench["workloads"]}["grcz11.pe151"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("grcz11", "pe151", 1)
    limits = run.load_json(BENCH / "limits" / "grcz11.pe151.json")
    assert {k: limits[k] for k in ("missing", "record_faults",
                                   "dup_unmarked", "mapq_faults")} == \
        dict.fromkeys(("missing", "record_faults", "dup_unmarked",
                       "mapq_faults"), 0)


def test_repeat_classes_add_up_to_the_published_share(cfg):
    """Pasted bases at 0.70-0.80 of the genome: random placement covers
    1 - e^-x of it, 0.50-0.55; DNA transposons 39 of the 52.2 points."""
    pasted = {}
    for fam in cfg["genome"]["repeats"]:
        mean = fam.get("mean_length", fam["length"])
        pasted[fam["name"]] = mean * sum(p["copies"]
                                         for p in fam["placements"])
    x = sum(pasted.values()) / cfg["length"]
    assert 0.70 < x < 0.80
    assert pasted["DNA"] / sum(pasted.values()) == \
        pytest.approx(39 / 52.2, abs=0.01)


def test_scaled_genome_repeat_share_in_proportion(cfg):
    n = cfg["length"] // 1000
    small = tiny_genome(cfg["genome"], n, cfg["length"])
    g, spans = genome.make_genome(n, small)
    assert 0.48 < genome.repeat_share(spans, n) < 0.57
    assert len(spans) == sum(p["copies"] for f in small["repeats"]
                             for p in f["placements"])


@pytest.fixture
def wide(monkeypatch):
    """The hooks that put a tiny genome on the full genome's path."""
    from bwa_flow_tpu_torch.index import io as idx_io
    monkeypatch.setattr(idx_io, "RESAMPLE_MIN", 0)
    monkeypatch.setattr(idx_io, "FORCE_WIDE", True)
    monkeypatch.setenv("BWA_TPU_DENSE_SA_MAX", "0")
    # 2 x 60,000 rows: interval 4 at 8 bytes does not fit, 8 does
    monkeypatch.setenv("BWA_TPU_SA_BYTES", str(16_000 * 8))


def test_tiny_traced_run_on_the_wide_path(bench, tiny_cache, wide):
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell, config, mix, limits = tiny_cell(bench, "grcz11.pe151")
        res = run.run_cell(bench, cell, config, mix, limits, 2**31 + 1911,
                           4.0, True, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert res.pop("_forbidden") == []
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["batch.seed_wide_share"] == 1.0
    assert m["batch.seed_fetch_kib"] > 0 and m["batch.sa_values_per_read"] > 0
    assert json.loads(json.dumps(res))   # the result line is plain JSON
