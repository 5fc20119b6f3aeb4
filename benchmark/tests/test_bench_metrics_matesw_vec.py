"""The reader of tail.matesw_vec_share, the share of the PE tail's
rescue calls that ran the striped ksw_align2, on canned records: a value
on a paired-end record, nothing without calls or without the counter
(the parent's program)."""

import pytest

import run

STATS = {"tail_matesw": 20480, "tail_matesw_vec": 15360,
         "tail_pairs": 81920}


def _read(stats):
    return run.reader("tail.matesw_vec_share")(dict(stats=stats))


def test_entry(bench):
    entry = {m["name"]: m for m in bench["per_layer"]}[
        "tail.matesw_vec_share"]
    assert entry["moves"] == "reads_per_s" and entry["layer"] == "tail"
    assert entry["workloads"] == ["dm6.pe151"]


@pytest.mark.parametrize("stats, want", [
    (STATS, 0.75),
    (dict(STATS, tail_matesw_vec=20480), 1.0),
    (dict(STATS, tail_matesw=0, tail_matesw_vec=0, tail_pairs=0), None),
    ({k: v for k, v in STATS.items() if k != "tail_matesw_vec"}, None),
    ({}, None)], ids=["pe", "all_striped", "no_calls", "parent", "empty"])
def test_matesw_vec_share(stats, want):
    got = _read(stats)
    assert got == (None if want is None else pytest.approx(want))
