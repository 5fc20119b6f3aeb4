"""The readers of the wide path's counters, batch.seed_wide_share,
batch.seed_fetch_kib and batch.sa_values_per_read, on canned records: a
value where the program counts, nothing where it has no such counter
(the parent's program) or counted no batch or read."""

import pytest

import run

STATS = {"seed_batches": 40, "seed_wide": 30, "seed_fetch_bytes": 40 << 20,
         "sa_values": 491520, "reads": 163840}
WANT = {"batch.seed_wide_share": 0.75, "batch.seed_fetch_kib": 1024.0,
        "batch.sa_values_per_read": 3.0}
NEEDS = {"batch.seed_wide_share": ("seed_wide", "seed_batches"),
         "batch.seed_fetch_kib": ("seed_fetch_bytes", "seed_batches"),
         "batch.sa_values_per_read": ("sa_values", "reads")}


def _read(name, stats):
    return run.reader(name)(dict(stats=stats))


@pytest.mark.parametrize("name", sorted(WANT))
def test_entry(bench, name):
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    assert entry["moves"] == "reads_per_s" and entry["layer"] == "batch"
    assert entry["source"] == "program_counter"
    if name == "batch.seed_wide_share":
        assert entry["workloads"] == ["grcz11.pe151"]
    else:
        assert "workloads" not in entry


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    assert _read(name, STATS) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("case", ["counter_absent", "divisor_zero",
                                  "empty"])
def test_reader_finds_nothing(name, case):
    counter, divisor = NEEDS[name]
    stats = {"counter_absent": {k: v for k, v in STATS.items()
                                if k != counter},
             "divisor_zero": dict(STATS, **{divisor: 0}),
             "empty": {}}[case]
    assert _read(name, stats) is None


def test_narrow_batches_read_zero_wide_share():
    assert _read("batch.seed_wide_share",
                 dict(STATS, seed_wide=0)) == 0.0
    assert _read("batch.seed_wide_share",
                 dict(STATS, seed_wide=40)) == 1.0
