"""The reader of io.parse_ready_share, the share of the window's batches
the FASTQ reader thread had parsed before the main thread asked, on
canned records: a value where the reader thread recorded its seconds,
0 where it never ran ahead, nothing without it (the parent's program) or
without batches."""

import pytest

import run

TRACER = {"parse": 0.4, "parse.cpu": 0.3, "parse.reader": 1.2,
          "parse.ready": 36.0}


def _read(tracer, batches=40):
    return run.reader("io.parse_ready_share")(dict(batches=batches,
                                                   tracer=tracer))


def test_entry(bench):
    entry = {m["name"]: m for m in bench["per_layer"]}[
        "io.parse_ready_share"]
    assert entry == {"name": "io.parse_ready_share", "unit": "share",
                     "better": "higher", "source": "program_counter",
                     "layer": "io", "moves": "reads_per_s"}
    assert bench["per_layer"][-1] is entry


@pytest.mark.parametrize("tracer, batches, want", [
    (TRACER, 40, 0.9),
    (dict(TRACER, **{"parse.ready": 40.0}), 40, 1.0),
    ({k: v for k, v in TRACER.items() if k != "parse.ready"}, 40, 0.0),
    ({k: v for k, v in TRACER.items() if k not in ("parse.reader",
                                                    "parse.ready")}, 40,
     None),
    (TRACER, 0, None)],
    ids=["reader", "all_ready", "never_ahead", "parent", "no_batches"])
def test_parse_ready_share(tracer, batches, want):
    got = _read(tracer, batches)
    assert got == (None if want is None else pytest.approx(want))
