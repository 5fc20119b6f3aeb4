"""The readers of the program's own spans and counters (the tail, the
parse, the seed stage and the extension worker), on canned records, and
nothing where their span or counter is absent or their divisor is 0."""

import pytest

import run

REC = dict(window_s=20.0, batches=40, reads=163840,
           spans={"parse": 2.0, "emit": 3.0},
           tracer={"emit_wait": 7.0, "extend_waves": 1.0, "seed": 4.0,
                   "tail": 16.0, "tail_wait": 6.0, "emit": 0.9,
                   "tail.dedup": 0.4, "tail.rescue": 12.0, "tail.pair": 0.8,
                   "tail.sam": 2.0, "parse": 4.0, "parse.cpu": 3.0,
                   "seed.dispatch": 0.2, "seed.fetch": 0.6, "sa.fetch": 0.2,
                   "extend": 10.0},
           stats={"seed_s": 3.2, "seed_batches": 40, "tail_matesw": 20480,
                  "tail_pairs": 81920, "harvest_idle_polls": 3000},
           cpu_s=100.0, peak_bytes=3 << 29, device=None)

WANT = {"pipeline.tail_busy_share": 0.8, "pipeline.tail_join_share": 0.3,
        "tail.dedup_ms": 10.0, "tail.rescue_ms": 300.0,
        "tail.pair_ms": 20.0, "tail.sam_ms": 50.0,
        "tail.matesw_per_pair": 0.25, "io.parse_offcpu_share": 0.25,
        "batch.seed_dispatch_ms": 5.0, "batch.seed_wait_ms": 20.0,
        "host_ext.busy_share": 0.5, "host_ext.idle_polls_per_s": 150.0}

# the span or counter each reader reads, and where it divides by one
NEEDS = {"pipeline.tail_busy_share": ("tracer", "tail"),
         "pipeline.tail_join_share": ("tracer", "tail_wait"),
         "tail.dedup_ms": ("tracer", "tail.dedup"),
         "tail.rescue_ms": ("tracer", "tail.rescue"),
         "tail.pair_ms": ("tracer", "tail.pair"),
         "tail.sam_ms": ("tracer", "tail.sam"),
         "tail.matesw_per_pair": ("stats", "tail_matesw"),
         "io.parse_offcpu_share": ("tracer", "parse.cpu"),
         "batch.seed_dispatch_ms": ("tracer", "seed.dispatch"),
         "batch.seed_wait_ms": ("tracer", "seed.fetch"),
         "host_ext.busy_share": ("tracer", "extend"),
         "host_ext.idle_polls_per_s": ("stats", "harvest_idle_polls")}
DIVISOR = {"pipeline.tail_busy_share": ("window_s",),
           "pipeline.tail_join_share": ("window_s",),
           "tail.dedup_ms": ("batches",), "tail.rescue_ms": ("batches",),
           "tail.pair_ms": ("batches",), "tail.sam_ms": ("batches",),
           "tail.matesw_per_pair": ("stats", "tail_pairs"),
           "io.parse_offcpu_share": ("tracer", "parse"),
           "batch.seed_dispatch_ms": ("stats", "seed_batches"),
           "batch.seed_wait_ms": ("stats", "seed_batches"),
           "host_ext.busy_share": ("window_s",),
           "host_ext.idle_polls_per_s": ("window_s",)}


def _with(rec, path, value=None, drop=False):
    """A copy of `rec` with the entry at `path` set to `value`, or
    dropped."""
    if len(path) == 1:
        out = dict(rec)
        if drop:
            out.pop(path[0])
        else:
            out[path[0]] = value
        return out
    inner = dict(rec[path[0]])
    if drop:
        inner.pop(path[1])
    else:
        inner[path[1]] = value
    return dict(rec, **{path[0]: inner})


@pytest.mark.parametrize("name", sorted(WANT))
def test_program_reader(bench, name):
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    assert entry["moves"] == "reads_per_s" and "workloads" not in entry
    assert run.reader(name)(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_program_reader_finds_nothing(name):
    """The parent's program, or a cell without the layer: nothing, never
    0; a divisor of 0: nothing."""
    read = run.reader(name)
    assert read(_with(REC, NEEDS[name], drop=True)) is None
    assert read(_with(REC, DIVISOR[name], 0)) is None
    if DIVISOR[name][0] != "window_s" and DIVISOR[name] != ("batches",):
        assert read(_with(REC, DIVISOR[name], drop=True)) is None


def test_seed_wait_without_sa_lookups():
    """Where the seed program resolved every SA value there is no
    `sa.fetch`: the collect's reads alone."""
    rec = _with(REC, ("tracer", "sa.fetch"), drop=True)
    assert run.reader("batch.seed_wait_ms")(rec) == pytest.approx(15.0)


def test_single_end_cell_has_no_pair_metrics():
    """A single-end tail adds dedup and SAM only, and counts no pairs."""
    tracer = {k: v for k, v in REC["tracer"].items()
              if k not in ("tail.rescue", "tail.pair")}
    rec = dict(REC, tracer=tracer,
               stats=dict(REC["stats"], tail_matesw=0, tail_pairs=0))
    for name in ("tail.rescue_ms", "tail.pair_ms", "tail.matesw_per_pair"):
        assert run.reader(name)(rec) is None
    assert run.reader("tail.sam_ms")(rec) == pytest.approx(50.0)
