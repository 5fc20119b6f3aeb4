"""The port's tracer (utils/trace.py) and the spans and counters the
pipeline feeds it: a span's wall and CPU seconds, `add`, spans from many
threads, the benchmark's span marks (benchmark/devtrace.py), the FASTQ
parse's span, the native tails' phase counters, and a paired-end
AlignPipeline run on the CPU that fills every span and counter the
benchmark's readers take."""

import importlib.util
import os
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.io.fastq import read_batches
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.ops import region_native
from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
from bwa_flow_tpu_torch.utils.opts import MEM_F_PE, MemOpt
from bwa_flow_tpu_torch.utils.trace import GLOBAL, Tracer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "bwa_flow_tpu_torch"
ACGT = np.frombuffer(b"ACGT", np.uint8)

# what the pipeline fills on a paired-end native run, for the readers
PE_SPANS = ("tail", "tail_wait", "emit", "emit_wait", "tail.dedup",
            "tail.rescue", "tail.pair", "tail.sam", "parse", "seed",
            "seed.dispatch", "seed.fetch", "sa", "extend")
PE_STATS = ("tail_matesw", "tail_matesw_vec", "tail_pairs",
            "harvest_idle_polls")


def _spin(seconds):
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        pass


def test_span_adds_wall_and_cpu_seconds_and_add_accumulates():
    tr = Tracer()
    with tr.span("busy"):
        _spin(0.05)
    with tr.span("asleep"):
        time.sleep(0.05)
    assert tr.totals["busy"] >= 0.05
    assert 0.02 < tr.totals["busy.cpu"] <= tr.totals["busy"] + 0.01
    assert tr.totals["asleep"] >= 0.05 and tr.totals["asleep.cpu"] < 0.02
    tr.add("ext", 0.25)
    tr.add("ext", 0.5)
    assert tr.totals["ext"] == pytest.approx(0.75)
    assert "ext.cpu" not in tr.totals
    assert tr.counts["busy"] == 1 and tr.counts["ext"] == 2
    assert '"busy.cpu"' in tr.as_json()


def test_spans_from_many_threads_sum():
    """Eight threads at least, and more than the cores, switching often:
    a lost update would leave a count short."""
    n = max(8, (os.cpu_count() or 1) + 1)
    tr = Tracer()
    start = threading.Barrier(n)

    def work():
        start.wait()
        for _ in range(200):
            with tr.span("t"):
                pass
            tr.add("x", 0.001)
    ts = [threading.Thread(target=work) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert tr.counts["t"] == 200 * n and tr.counts["x"] == 200 * n
    assert tr.totals["x"] == pytest.approx(0.2 * n)
    assert 0 <= tr.totals["t.cpu"] and 0 < tr.totals["t"]


def _program_spans() -> set:
    """Every span name the port opens (`tracer.span("...")`)."""
    pat = re.compile(r'tracer\.span\("([^"]+)"\)')
    return {m for p in PKG.rglob("*.py") for m in pat.findall(p.read_text())}


def _devtrace():
    spec = importlib.util.spec_from_file_location(
        "bench_devtrace", ROOT / "benchmark" / "devtrace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Marks:
    """A stand-in for torch.profiler.record_function that records the
    names of the ranges opened, from any thread."""

    def __init__(self):
        self.names = []
        self.lock = threading.Lock()

    def __call__(self, name):
        marks = self

        class Range:
            def __enter__(self):
                with marks.lock:
                    marks.names.append(name)

            def __exit__(self, *exc):
                return False
        return Range()


def test_devtrace_marks_every_program_span(monkeypatch):
    names = _program_spans()
    assert set(PE_SPANS) - {k for k in PE_SPANS if k.startswith("tail.")} \
        <= names
    assert {"sa.fetch", "extend_waves", "wave.fetch"} <= names
    marks = _Marks()
    monkeypatch.setattr(torch.profiler, "record_function", marks)
    tr = Tracer()
    undo = _devtrace().annotate_spans(tr)
    for n in sorted(names):
        with tr.span(n):
            pass
    assert marks.names == [f"span:{n}" for n in sorted(names)]
    assert all(tr.counts[n] == 1 for n in names)
    undo()
    assert "span" not in vars(tr)
    with tr.span("after"):
        pass
    assert len(marks.names) == len(names)


def _write_fastq(path, seqs, prefix):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@{prefix}{i}\n{ACGT[s].tobytes().decode()}\n+\n"
                    f"{'I' * len(s)}\n")


def test_parse_span_leaves_out_the_consumer(tmp_path):
    rng = np.random.default_rng(0x7A)
    _write_fastq(tmp_path / "r.fq",
                 [rng.integers(0, 4, 100) for _ in range(40)], "r")
    t0, n0 = GLOBAL.totals["parse"], GLOBAL.counts["parse"]
    n = 0
    for _ in read_batches(str(tmp_path / "r.fq"), chunk_bp=1000):
        n += 1
        time.sleep(0.1)
    assert n == 4
    assert GLOBAL.counts["parse"] - n0 == n + 1
    assert GLOBAL.totals["parse"] - t0 < 0.1


def _genome(rng, n=30000):
    return rng.integers(0, 4, n).astype(np.uint8)


def _pe_reads(rng, g, n_pairs, L=101):
    """Interleaved FR pairs of ~N(300, 20) inserts, and every eighth
    pair's read2 random, so mate rescue runs ksw_align2 for it."""
    seqs = []
    for k in range(n_pairs):
        isize = int(rng.normal(300, 20))
        p = int(rng.integers(0, len(g) - isize - 1))
        r1 = g[p:p + L].copy()
        r2 = (3 - g[p + isize - L:p + isize])[::-1].copy()
        if k % 8 == 7:
            r2 = rng.integers(0, 4, L).astype(np.uint8)
        seqs += [r1, r2]
    return seqs


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0x7B)
    g = _genome(rng)
    fm = build_index([("c1", "", ACGT[g].tobytes())])
    seqs = _pe_reads(rng, g, 48)
    return dict(fm=fm, seqs=seqs)


def _reads(seqs):
    return [Read(name=f"p{i >> 1}", seq=s, qual="I" * len(s), id=i)
            for i, s in enumerate(seqs)]


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_native_tail_counters_leave_the_sam_alone(world, paired):
    opt = MemOpt()
    if paired:
        opt.flag |= MEM_F_PE
    fm, seqs = world["fm"], world["seqs"]
    regs = BatchAligner(opt, fm, device="cpu").align_regs(seqs)
    if paired:
        plain, _ = region_native.pe_tail_batch(opt, fm, _reads(seqs), regs,
                                               "rg")
        ctr: dict = {}
        t0 = time.monotonic()
        got, _ = region_native.pe_tail_batch(opt, fm, _reads(seqs), regs,
                                             "rg", counters=ctr)
        wall = time.monotonic() - t0
        phases = ("dedup", "rescue", "pair", "sam")
        assert set(ctr) == set(phases) | {"matesw", "matesw_vec", "pairs"}
        assert ctr["pairs"] == len(seqs) // 2
        assert ctr["matesw"] >= 6       # the random mates
    else:
        plain = region_native.se_tail_batch(opt, fm, _reads(seqs), regs,
                                            "rg")
        ctr = {}
        t0 = time.monotonic()
        got = region_native.se_tail_batch(opt, fm, _reads(seqs), regs, "rg",
                                          counters=ctr)
        wall = time.monotonic() - t0
        phases = ("dedup", "sam")
        assert set(ctr) == set(phases)
    assert got == plain
    assert all(ctr[k] > 0 for k in phases)
    assert sum(ctr[k] for k in phases) <= wall


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_native_tail_counts_striped_rescue_calls(world, paired):
    """Every rescue call of 151 bp mates runs the striped ksw_align2
    (`matesw_vec` equals `matesw`); a single-end tail rescues nothing and
    reports neither."""
    opt = MemOpt()
    if paired:
        opt.flag |= MEM_F_PE
    fm, seqs = world["fm"], world["seqs"]
    regs = BatchAligner(opt, fm, device="cpu").align_regs(seqs)
    ctr: dict = {}
    if paired:
        region_native.pe_tail_batch(opt, fm, _reads(seqs), regs, "rg",
                                    counters=ctr)
        assert ctr["matesw"] >= 6
        assert ctr["matesw_vec"] == ctr["matesw"]
    else:
        region_native.se_tail_batch(opt, fm, _reads(seqs), regs, "rg",
                                    counters=ctr)
        assert not {"matesw", "matesw_vec"} & set(ctr)


def test_pe_pipeline_fills_every_span_and_counter(world, tmp_path,
                                                  monkeypatch):
    """A paired-end run on the native route from two FASTQs, under the
    benchmark's span marks: the main thread's, the tail thread's and the
    extension worker's spans all pass through them."""
    seqs = world["seqs"]
    _write_fastq(tmp_path / "r1.fq", seqs[0::2], "p")
    _write_fastq(tmp_path / "r2.fq", seqs[1::2], "p")
    opt = MemOpt()
    opt.flag |= MEM_F_PE
    marks = _Marks()
    monkeypatch.setattr(torch.profiler, "record_function", marks)
    undo = _devtrace().annotate_spans(GLOBAL)
    tr0 = dict(GLOBAL.totals)
    pipe = AlignPipeline(opt, world["fm"], paired=True, device="cpu")
    out = []
    try:
        pipe.run(read_batches(str(tmp_path / "r1.fq"),
                              str(tmp_path / "r2.fq"), chunk_bp=24 * 202),
                 out.extend)
    finally:
        pipe.close()
        undo()
    tr = {k: v - tr0.get(k, 0.0) for k, v in GLOBAL.totals.items()}
    assert len(out) == len(seqs)
    for k in PE_SPANS:
        assert tr.get(k, 0.0) > 0, k
    st = pipe.ba.stats
    assert all(k in st for k in PE_STATS)
    assert st["tail_pairs"] == len(seqs) // 2
    assert st["tail_matesw"] >= 6
    assert st["tail_matesw_vec"] == st["tail_matesw"]
    assert tr["tail_wait"] + tr["emit"] <= tr["emit_wait"]
    assert sum(tr[f"tail.{k}"] for k in ("dedup", "rescue", "pair",
                                          "sam")) <= tr["tail"]
    assert tr["seed.fetch"] <= tr["seed"]
    seen = set(marks.names)
    assert {f"span:{k}" for k in PE_SPANS if not k.startswith("tail.")} \
        <= seen
