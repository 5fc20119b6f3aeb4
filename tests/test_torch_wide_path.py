"""The wide path, which every genome of 2^31 BWT rows and more takes (the
int64 seed machine and its dense collect, the sampled SA re-sampled to
interval 8 as int64, the fused LF walk over it), through the normal
path: AlignPipeline's native route, paired-end, on the CPU. A small
genome with the repeat classes of the benchmark's zebrafish
configuration (benchmark/configs/grcz11.json, copies in proportion) is
forced wide with index.io.FORCE_WIDE, and its reads come from the
benchmark's generator. The wide path's SAM equals, byte for byte, the
JAX package's PE pipeline forced wide (smem_jax.FORCE_WIDE) on the same
index and reads, and the port's narrow path (the int32 machine and its
ragged pack, the SA at interval 4 as int32); every exact check of the
benchmark's plain reference is 0; and the batch aligner's counters of
the wide path count."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bwa_flow_tpu.dedup.markdup import \
    make_markdup_stage as jax_markdup_stage
from bwa_flow_tpu.index import io as jax_idx_io
from bwa_flow_tpu.io.fastq import read_batches as jax_read_batches
from bwa_flow_tpu.ops import smem_jax
from bwa_flow_tpu.pipeline.dataflow import AlignPipeline as JaxAlignPipeline
from bwa_flow_tpu.utils.opts import MEM_F_PE as JAX_MEM_F_PE
from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
from bwa_flow_tpu_torch.dedup.markdup import make_markdup_stage
from bwa_flow_tpu_torch.index import io as idx_io
from bwa_flow_tpu_torch.ops.fm_torch import DeviceFM
from bwa_flow_tpu_torch.io.fastq import read_batches
from bwa_flow_tpu_torch.ops import smem_torch
from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
from bwa_flow_tpu_torch.utils.opts import MEM_F_PE, MemOpt
from bwa_flow_tpu_torch.utils.trace import GLOBAL

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import genome as bench_genome  # noqa: E402
import readgen  # noqa: E402
import reference  # noqa: E402
import run as bench_run  # noqa: E402

LENGTH = 120_000
PAIRS = 128            # pairs a batch
BATCHES = 2
SEED = 2**31 + 19
EXACT = ("missing", "record_faults", "dup_unmarked", "mapq_faults")


def scaled_config(length: int = LENGTH) -> dict:
    """grcz11 at `length` bases: every class's copies in proportion (at
    least one a placement), consensus sequences no longer than a quarter
    of the contig."""
    cfg = json.loads((BENCH / "configs" / "grcz11.json").read_text())
    f = length / int(cfg["length"])
    reps = []
    for fam in cfg["genome"]["repeats"]:
        places = [dict(p, copies=max(1, round(p["copies"] * f)))
                  for p in fam["placements"]]
        reps.append(dict(fam, length=min(int(fam["length"]), length // 4),
                         placements=places))
    return dict(cfg, name="wide_grcz11", length=length,
                genome=dict(cfg["genome"], repeats=reps))


def sa_budget(seq_len: int) -> int:
    """A BWA_TPU_SA_BYTES under which an int64 SA lands on interval 8 (4
    does not fit) and an int32 one on interval 4, as GRCz11's 2.7e9 rows
    and dm6's 2.9e8 do under the default."""
    return (seq_len // 8 + 1) * 8 + (seq_len // 16) * 8


def run_path(prefix: str, cfg: dict, mix: dict, fq: tuple, wide: bool,
             device: str = "cpu") -> dict:
    """One run of the native PE pipeline over the FASTQ pair `fq` on the
    index at `prefix`, loaded narrow or forced wide; returns its SAM
    records in order, the batch aligner's stats, the tracer's span
    counts over the run and the index's SA."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(idx_io, "RESAMPLE_MIN", 0)
        mp.setattr(idx_io, "FORCE_WIDE", wide)
        mp.setenv("BWA_TPU_DENSE_SA_MAX", "0")
        mp.setenv("BWA_TPU_NO_INDEX_CACHE", "1")
        mp.setenv("BWA_TPU_SA_BYTES", str(sa_budget(2 * cfg["length"])))
        fm = idx_io.load_index(prefix)
        opt = MemOpt()
        opt.flag |= MEM_F_PE
        markdup = make_markdup_stage(fm, ignore_unmated=True)
        pipe = AlignPipeline(opt, fm, paired=True, device=device)
        sam: list = []

        def emit(chunk):
            markdup.process(chunk)
            sam.extend(r.sam for r in chunk)
        counts0 = dict(GLOBAL.counts)
        try:
            pipe.run(read_batches(*fq, chunk_bp=int(mix["batch_reads"])
                                  * int(mix["read_len"])), emit)
        finally:
            pipe.close()
        spans = {k: v - counts0.get(k, 0) for k, v in GLOBAL.counts.items()}
        return dict(sam=sam, stats=dict(pipe.ba.stats), spans=spans,
                    sa_intv=fm.sa_intv, sa_dtype=pipe.ba.dfm.sa.dtype)
    finally:
        mp.undo()


def run_jax_wide(prefix: str, mix: dict, fq: tuple) -> list:
    """The JAX package's PE pipeline over the same FASTQ pair in the same
    batches, on its wide int64 seed machine (smem_jax.FORCE_WIDE), with
    the same duplicate marking; returns its SAM records in order and
    the number of times it narrowed the index to int32."""
    mp = pytest.MonkeyPatch()
    narrowed = []
    real_narrow = smem_jax._narrow_dfm
    try:
        mp.setattr(smem_jax, "FORCE_WIDE", True)
        mp.setattr(smem_jax, "_narrow_dfm",
                   lambda d: narrowed.append(1) or real_narrow(d))
        mp.setenv("BWA_TPU_NO_INDEX_CACHE", "1")
        fm = jax_idx_io.load_index(prefix)
        opt = JaxMemOpt()
        opt.flag |= JAX_MEM_F_PE
        markdup = jax_markdup_stage(fm, ignore_unmated=True)
        pipe = JaxAlignPipeline(opt, fm, paired=True)
        sam: list = []

        def emit(chunk):
            markdup.process(chunk)
            sam.extend(r.sam for r in chunk)
        try:
            pipe.run(jax_read_batches(*fq, chunk_bp=int(mix["batch_reads"])
                                      * int(mix["read_len"])), emit)
        finally:
            pipe.close()
        return sam, len(narrowed)
    finally:
        mp.undo()


def make_world(tmp: Path, length: int = LENGTH, pairs: int = PAIRS,
               batches: int = BATCHES) -> dict:
    """The scaled genome and its index (the benchmark's own index build, in
    a cache under `tmp`) and `batches` batches of `pairs` pairs of the
    pe151 mix written as a FASTQ pair."""
    cfg = scaled_config(length)
    mix = json.loads((BENCH / "traffic" / "pe151.json").read_text())
    mix = dict(mix, batch_reads=2 * pairs)
    real_cache = bench_genome.CACHE
    bench_genome.CACHE = tmp / "cache"
    try:
        prefix, _ = bench_genome.ensure_index(cfg, log=lambda m: None)
        g = np.asarray(bench_genome.genome_of(cfg))
        repeats = bench_genome.repeats_of(cfg)
        sample = bench_run.draw_sample(cfg, mix, SEED, batches)
    finally:
        bench_genome.CACHE = real_cache
    gen = readgen.Batches(g, mix, SEED, 0)
    drawn = [gen.batch(b) for b in range(batches)]
    fq = tuple(str(tmp / f"r{m + 1}.fq") for m in range(2))
    for m, path in enumerate(fq):
        with open(path, "wb") as f:
            for bt in drawn:
                f.write(readgen.fastq_bytes(bt, 0, m))
    return dict(cfg=cfg, mix=mix, prefix=prefix, genome=g, repeats=repeats,
                sample=sample, fq=fq)


def judge(world: dict, sam: list) -> dict:
    """The benchmark's plain reference over the sample of the run."""
    names = set(world["sample"]["name"])
    width = 1 + readgen.NAME_DIGITS
    records: dict = {}
    for line in sam:
        if line[:width] in names and line[width] == "\t":
            records.setdefault(line[:width], []).append(line)
    return reference.compare(world["sample"], records, world["genome"],
                             world["cfg"]["scoring"], True,
                             world["repeats"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("wide"))


@pytest.fixture(scope="module")
def runs(world):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        narrow = run_path(world["prefix"], world["cfg"], world["mix"],
                          world["fq"], wide=False)
        wide = run_path(world["prefix"], world["cfg"], world["mix"],
                        world["fq"], wide=True)
    finally:
        torch.set_num_threads(n_threads)
    return dict(world=world, narrow=narrow, wide=wide)


def test_scaled_genome_keeps_the_repeat_share():
    cfg = scaled_config()
    g, spans = bench_genome.make_genome(cfg["length"], cfg["genome"])
    assert 0.4 < bench_genome.repeat_share(spans, len(g)) < 0.65


def test_paths_are_what_they_stand_for(runs):
    assert runs["narrow"]["sa_intv"] == 4
    assert runs["narrow"]["sa_dtype"] == torch.int32
    assert runs["wide"]["sa_intv"] == 8
    assert runs["wide"]["sa_dtype"] == torch.int64


def test_wide_sam_equals_jax_wide(runs):
    """The reference package's wide machine, from the same index files."""
    w = runs["world"]
    want, narrowed = run_jax_wide(w["prefix"], w["mix"], w["fq"])
    assert narrowed == 0
    assert len(want) >= 2 * PAIRS * BATCHES
    assert runs["wide"]["sam"] == want


def test_wide_sam_equals_narrow(runs):
    n, w = runs["narrow"]["sam"], runs["wide"]["sam"]
    assert len(n) >= 2 * PAIRS * BATCHES
    assert "".join(w) == "".join(n)


@pytest.mark.parametrize("path", ["narrow", "wide"])
def test_reference_finds_no_exact_fault(runs, path):
    judged = judge(runs["world"], runs[path]["sam"])
    assert judged["reads"] == len(runs["world"]["sample"]["name"]) > 0
    assert {k: judged[k] for k in EXACT} == dict.fromkeys(EXACT, 0), \
        judged["why"]


def test_wide_counters_count(runs):
    st, nst = runs["wide"]["stats"], runs["narrow"]["stats"]
    assert st["seed_batches"] == BATCHES
    assert st["seed_wide"] == st["seed_batches"]
    assert nst["seed_wide"] == 0 and nst["seed_batches"] == BATCHES
    assert st["sa_values"] > 0 and nst["sa_values"] > 0
    assert st["seed_fetch_bytes"] > nst["seed_fetch_bytes"] > 0
    assert runs["wide"]["spans"].get("seed.refetch", 0) == BATCHES
    for s in (st, nst):
        assert s["seed_redo_golden"] == 0
        assert s["reads"] == 2 * PAIRS * BATCHES


def _forced_overflow(real, levels_that_overflow, every=3):
    """collect_intv_device with OVF_P1_FWD set on every `every`-th read
    of the first pass (big 0) and on every read of the redo levels in
    `levels_that_overflow`."""
    def call(*a, **k):
        out = list(real(*a, **k))
        big = int(k.get("big", 0))
        ovf = out[2].clone()
        if big == 0:
            ovf[::every] |= smem_torch.OVF_P1_FWD
        elif big in levels_that_overflow:
            ovf |= smem_torch.OVF_P1_FWD
        out[2] = ovf
        return tuple(out)
    return call


@pytest.mark.parametrize("deepest", [1, 2])
def test_second_redo_level_keeps_reads_off_the_golden(world, monkeypatch,
                                                      deepest):
    """Reads the first device-redo level leaves go to a second level
    with twice its budgets, and only what that leaves to the golden
    (overflows forced on levels 1 to `deepest`); the seeds are the same
    either way."""
    monkeypatch.setattr(idx_io, "RESAMPLE_MIN", 0)
    monkeypatch.setattr(idx_io, "FORCE_WIDE", True)
    fm = idx_io.load_index(world["prefix"])
    dfm = DeviceFM.from_host(fm, "cpu", dense_sa_max=0)
    reads = [r.seq for r in next(read_batches(*world["fq"],
                                              chunk_bp=48 * 151))]
    opt = MemOpt()

    def collect():
        h = smem_torch.seed_dispatch(opt, fm, dfm, reads, L=160)
        return smem_torch.seed_collect_batch(h), h
    want, _ = collect()
    golden = []
    real_golden = smem_torch.smem_golden.collect_intv
    monkeypatch.setattr(smem_torch.smem_golden, "collect_intv",
                        lambda *a: golden.append(a) or real_golden(*a))
    monkeypatch.setattr(smem_torch, "collect_intv_device", _forced_overflow(
        smem_torch.collect_intv_device, set(range(1, deepest + 1))))
    got, h = collect()
    redone = len(range(0, len(reads), 3))
    assert (h["redo_device"], h["redo_golden"]) == \
        ((redone, 0) if deepest == 1 else (0, redone))
    assert len(golden) == h["redo_golden"]
    for name in ("iv_off", "x0", "x1", "sv", "st", "en"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
