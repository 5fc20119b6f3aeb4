"""One process on several devices: the port's AlignPipeline sharded over
CPU device lists (the analog of the JAX tests' virtual CPU devices)
against its one-device run and against the JAX package's
AlignPipeline(aligner_kw=dict(n_local_devices=2)) SAM, on the fixture of
tests/test_multidevice.py (a numpy-made 30 kbp genome with 15% repeats,
96 x 101 bp reads, batches of 48). Also: uneven and tiny shards, a
worker pool, the sharded seeds and SA values, per-shard counters, the
span accounting, and a shard failure failing the run. The pipelines here
run --ext-mode waves with no host drain and no harvester, so that device
waves run on every shard at this size."""

import time

import numpy as np
import pytest
import torch

import oracle as orc
from bwa_flow_tpu.index.build import build_index as jax_build_index
from bwa_flow_tpu.io.sam import Read as JRead
from bwa_flow_tpu.pipeline.dataflow import AlignPipeline as JaxPipeline
from bwa_flow_tpu.utils.opts import MEM_F_PE as JAX_MEM_F_PE
from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.ops import smem_torch
from bwa_flow_tpu_torch.pipeline import batch as batchmod
from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
from bwa_flow_tpu_torch.utils.opts import MEM_F_PE, MemOpt
from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
KW = dict(wave_cap=64, smem_L=128)


def _reads(recs, cls, pe=False):
    """Read objects (ids in file order; paired: interleaved mates)."""
    return [cls(name=nm, seq=CODE[np.frombuffer(sq, np.uint8)],
                qual=q.decode(), id=i)
            for i, (nm, sq, q) in enumerate(recs)]


def _batches(reads, size):
    return [reads[i:i + size] for i in range(0, len(reads), size)]


@pytest.fixture(scope="module")
def fx():
    rng = np.random.default_rng(91)
    contigs = orc.make_ref(rng, [("chr1", 30000)], repeat_frac=0.15)
    se = orc.sample_se(rng, contigs, 96, read_len=101)
    pe = [m for pair in orc.sample_pe(rng, contigs, 24, read_len=101)
          for m in pair]
    return dict(fm=build_index([(n, "", s) for n, s in contigs]),
                jfm=jax_build_index([(n, "", s) for n, s in contigs]),
                se=se, pe=pe)


def _port(fx, recs, devices, paired=False, n_workers=0, size=48):
    """(SAM records, stats) of the port's AlignPipeline on `devices`,
    with device waves for every task that fits."""
    opt = MemOpt()
    if paired:
        opt.flag |= MEM_F_PE
    pipe = AlignPipeline(opt, fx["fm"], paired=paired, n_workers=n_workers,
                         devices=devices, ext_mode="waves",
                         aligner_kw=dict(drain_max=0, harvest_workers=0,
                                         **KW))
    done = []
    try:
        pipe.run(_batches(_reads(recs, Read), size), done.extend)
    finally:
        pipe.close()
    return [r.sam for r in done], pipe.ba.stats


def _jax(fx, recs, paired=False):
    """SAM records of the JAX package's AlignPipeline on two devices."""
    opt = JaxMemOpt()
    if paired:
        opt.flag |= JAX_MEM_F_PE
    pipe = JaxPipeline(opt, fx["jfm"], paired=paired, n_workers=0,
                       aligner_kw=dict(n_local_devices=2, **KW))
    done = []
    try:
        pipe.run(iter(_batches(_reads(recs, JRead), 48)), done.extend)
    finally:
        pipe.close()
    assert pipe.ba.stats["device_errors"] == 0
    return [r.sam for r in done]


@pytest.fixture(scope="module")
def se_sams(fx):
    one, _ = _port(fx, fx["se"], ["cpu"])
    return dict(one=one, jax=_jax(fx, fx["se"]))


@pytest.mark.parametrize("n_shards", [2, 3])
def test_se_shards_equal_one_device_and_jax(fx, se_sams, n_shards):
    tracer.totals.clear()
    tracer.counts.clear()
    t0 = time.monotonic()
    got, stats = _port(fx, fx["se"], ["cpu"] * n_shards)
    wall = time.monotonic() - t0
    assert got == se_sams["one"]
    assert got == se_sams["jax"]
    assert stats["reads"] == 96 and stats["seed_batches"] == 2
    # every shard seeded its reads and ran waves of its own
    assert len(stats["shards"]) == n_shards
    for sh in stats["shards"]:
        assert sh["device"] == "cpu"
        assert sh["waves"] > 0 and sh["ext_tasks_device"] > 0
        assert sh["seed_s"] > 0
    assert sum(sh["waves"] for sh in stats["shards"]) == stats["waves"]
    # the main thread's seed span runs once for the first batch's
    # dispatch and once a collect (the next batch's dispatch runs inside
    # the collect, from its hook); its top-level spans do not overlap, so
    # they sum to no more than the run's wall (spans nested in them,
    # other threads' spans and the `.cpu` totals are left out)
    assert tracer.counts["seed"] == 3
    assert sum(tracer.totals[k] for k in ("seed", "sa", "emit_wait")) \
        <= wall + 0.5


def test_pe_two_shards_equal_one_device_and_jax(fx):
    one, _ = _port(fx, fx["pe"], ["cpu"], paired=True)
    two, stats = _port(fx, fx["pe"], ["cpu", "cpu"], paired=True)
    assert two == one
    assert two == _jax(fx, fx["pe"], paired=True)
    assert all(sh["ext_tasks_device"] > 0 for sh in stats["shards"])
    assert sum(int(s.split("\t")[1]) & 0x2 > 0 for s in two) >= 30


@pytest.mark.parametrize("case", ["50_reads_3_shards", "1_read_2_shards"])
def test_uneven_and_tiny_shards(fx, se_sams, case):
    """ceil(n / D) bounds: 50 reads over 3 shards (17, 17, 16); a
    one-read batch over 2 shards uses one shard."""
    n, devs, size = {"50_reads_3_shards": (50, 3, 50),
                     "1_read_2_shards": (3, 2, 1)}[case]
    got, stats = _port(fx, fx["se"][:n], ["cpu"] * devs, size=size)
    assert got == se_sams["one"][:n]
    used = [sh["ext_tasks_device"] > 0 for sh in stats["shards"]]
    assert used == ([True] * 3 if devs == 3 else [True, False])


def test_two_shards_with_a_pool_of_two_workers(fx, se_sams):
    got, stats = _port(fx, fx["se"], ["cpu", "cpu"], n_workers=2)
    assert got == se_sams["one"]
    assert all(sh["waves"] > 0 for sh in stats["shards"])


@pytest.mark.parametrize("dense", [True, False], ids=["fused_sa",
                                                      "probe_sa"])
def test_sharded_seeds_and_sa_equal_one_device(fx, monkeypatch, dense):
    """seeds_collect's IntvBatch (offsets shifted per shard) and
    resolve_sa_flat (probe chunks round-robin over the replicas, forced
    with no dense SA and small chunks) equal the one-device ones."""
    if not dense:
        monkeypatch.setenv("BWA_TPU_DENSE_SA_MAX", "0")
        monkeypatch.setattr(batchmod, "SA_CHUNK", 64)
    seqs = [r.seq for r in _reads(fx["se"][:40], Read)]
    out = []
    for devs in (["cpu"], ["cpu"] * 3):
        ba = BatchAligner(MemOpt(), fx["fm"], devices=devs, **KW)
        assert (ba.dfm.sa_dense is not None) == dense
        h = ba.seeds_dispatch(seqs)
        assert h["bounds"] == ([(0, 40)] if len(devs) == 1 else
                               [(0, 14), (14, 28), (28, 40)])
        ivs = ba.seeds_collect(h)
        out.append((ivs, h["sa_vals"], ba.resolve_sa_flat(ivs, h)))
    (iv1, sv1, sa1), (iv3, sv3, sa3) = out
    for f in ("iv_off", "x0", "x1", "sv", "st", "en"):
        np.testing.assert_array_equal(getattr(iv3, f), getattr(iv1, f), f)
    assert len(sv3) == len(sv1) == 40
    for a, b in zip(sv3, sv1):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa3[0], sa1[0])
    np.testing.assert_array_equal(sa3[1], sa1[1])
    assert sa3[2] == sa1[2]
    if not dense:
        assert len(sa1[0]) > 3 * 64   # chunks on every replica


def test_a_failing_shard_fails_the_run(fx, monkeypatch):
    """A seed program failing on the second shard raises out of the
    pipeline; no shard moves to the host."""
    real = smem_torch.seed_dispatch
    calls = []

    def failing(opt, fm, dfm, reads, **kw):
        calls.append(dfm)
        if len(calls) == 2:
            raise RuntimeError("seed program failed on shard 1")
        return real(opt, fm, dfm, reads, **kw)
    monkeypatch.setattr(smem_torch, "seed_dispatch", failing)
    with pytest.raises(RuntimeError, match="shard 1"):
        _port(fx, fx["se"][:8], ["cpu", "cpu"], size=8)
