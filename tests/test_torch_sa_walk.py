"""The LF walk's callers on the kernel's code, on the CPU, and the bound
chip_smoke.py puts beside each walk launch.

Here the sa_walk kernel's own code runs behind ops/fm_cuda.py: the host
harness of tests/test_torch_sa_walk_host.py (csrc/sa_walk.cuh compiled
with the host's c++, run for every slot of a launch) stands in for the
card's launcher, and fm_torch._on_card sends CPU tensors to it. So the
wrapper's handling around the kernel runs as on the card: the first
walk in place on a copy of the caller's rows, the pools' live counts
read by the kernel, the padding slots left as they are and scattered
into the sink slot. sa_batch (phased and unphased, narrow and wide, full
B/4 and B/16 pools at B=64, lane 0 live in pools that are not full),
_densify_sa and the seed program on an index re-sampled to interval 4
are held to the JAX package's, exactly; on the card's path the walk
reads nothing (a fetch that raises), and with no nvcc the wrapper
raises for the card."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from bwa_flow_tpu.index.build import build_index as jax_build_index
from bwa_flow_tpu.ops import fm as jfmops
from bwa_flow_tpu.ops import fm_jax, smem_jax
from bwa_flow_tpu_torch.index import io as idx_io
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.ops import fm_cuda, fm_torch, smem_torch
from bwa_flow_tpu_torch.utils.opts import MemOpt
from tests.test_torch_sa_walk_host import build_harness
from tests.test_torch_smem import _contigs, _sample_reads

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("sa_walk_callers"))


@pytest.fixture
def on_harness(lib, monkeypatch):
    """CPU tensors take the kernel's path, with the harness as the
    card's launcher; the plain walk must not run."""
    monkeypatch.setattr(fm_torch, "_on_card", lambda t, who: True)
    monkeypatch.setattr(fm_cuda, "_device", lambda t: t.device)
    monkeypatch.setattr(fm_cuda, "_fn", lambda: (
        lib.sa_walk_launch, lib.sa_walk_error_string))
    monkeypatch.setattr(fm_cuda, "_on_device",
                        lambda dev: contextlib.nullcontext(None))
    monkeypatch.setattr(fm_torch, "_lf_walk_plain", lambda *a, **k:
                        pytest.fail("the plain walk ran on the card's path"))
    before = fm_cuda.n_launches["sa_walk"]
    return lambda: fm_cuda.n_launches["sa_walk"] - before


def _raise(t):
    raise AssertionError("the walk read the card")


@pytest.fixture(scope="module")
def idx():
    contigs = _contigs(np.random.default_rng(0x5A8), length=8000)
    fm = jax_build_index(contigs)
    dt = fm_torch.DeviceFM.from_host(fm, "cpu", dense_sa_max=0)
    dj = fm_jax.DeviceFM.from_host(fm, dense_sa_max=0)
    # each row's LF steps to a sampled row (the plain walk, unbounded)
    mask = int(fm.sa_intv) - 1
    rows = torch.arange(int(fm.seq_len) + 1, dtype=torch.int64)
    _, length = fm_torch._lf_walk_plain(dt, mask, rows,
                                        torch.zeros_like(rows), 1 << 14)
    return dict(contigs=contigs, fm=fm, length=length.numpy(),
                torch={"wide": dt, "narrow": dt.narrow()},
                jax={"wide": dj, "narrow": fm_jax._narrow_view(dj)})


def _rows(idx, case: str) -> np.ndarray:
    """The rows of a case: "random" (200 rows); "full_pools" (B=64: 8
    rows longer than 6 intervals first, then 24 longer than 2, so both
    pools fill and lanes drop); "lane0_live" (B=64: lane 0 longer than 6
    intervals, two more longer than 2, the rest shorter, so lane 0 is
    live in two pools that are not full)."""
    rng = np.random.default_rng(len(case))
    length, intv = idx["length"], int(idx["fm"].sa_intv)
    if case == "random":
        return rng.integers(0, len(length), 200)
    long6 = np.nonzero(length > 6 * intv)[0]
    long2 = np.nonzero((length > 2 * intv) & (length <= 6 * intv))[0]
    short = np.nonzero(length <= 2 * intv)[0]
    assert len(long6) >= 8 and len(long2) >= 24
    if case == "full_pools":
        return np.concatenate([rng.choice(long6, 8, replace=False),
                               rng.choice(long2, 24, replace=False),
                               rng.choice(short, 32, replace=False)])
    return np.concatenate([rng.choice(long6, 1), rng.choice(long2, 2),
                           rng.choice(short, 61, replace=False)])


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("intv", ["phased", "unphased"])
@pytest.mark.parametrize("case", ["random", "full_pools", "lane0_live"])
def test_sa_batch_on_the_kernel_equals_jax(idx, on_harness, case, intv,
                                           width):
    fm = idx["fm"]
    intv = int(fm.sa_intv) if intv == "phased" else 0
    ty = np.int32 if width == "narrow" else np.int64
    ks = _rows(idx, case).astype(ty)
    for budget in (4096, 3):
        got = fm_torch.sa_batch(idx["torch"][width], torch.as_tensor(ks),
                                budget, intv, fetch=_raise)
        want = fm_jax.sa_batch(idx["jax"][width], jnp.asarray(ks), budget,
                               intv)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # three launches a phased call, one an unphased one: two calls
    assert on_harness() == (6 if intv else 2)
    ovf = got[1].numpy()
    exact = np.array([jfmops.bwt_sa(fm, int(k)) for k in ks])
    assert ((got[0].numpy() == exact) | ovf).all()
    if case == "full_pools":
        vals, ovf = fm_torch.sa_batch(idx["torch"][width],
                                      torch.as_tensor(ks), 4096, intv)
        # at budget 4096 only the lanes dropped from a full pool
        # overflow: 32 survive 2 intervals into the B/4 pool of 16, and 8
        # of its 16 survive 6 into the B/16 pool of 4
        assert ovf.sum() == (20 if intv else 0)
        assert ((vals.numpy() == exact) | ovf.numpy()).all()
    if case == "lane0_live":
        vals, ovf = fm_torch.sa_batch(idx["torch"][width],
                                      torch.as_tensor(ks), 4096, intv)
        assert not ovf.any() and (vals.numpy() == exact).all()


def test_sa_batch_leaves_the_callers_rows(idx, on_harness):
    ks = torch.as_tensor(_rows(idx, "random"))
    keep = ks.clone()
    fm_torch.sa_batch(idx["torch"]["wide"], ks, 256, 32)
    fm_torch.sa_batch(idx["torch"]["wide"], ks, 256, 0)
    assert torch.equal(ks, keep)


def test_densify_sa_on_the_kernel_equals_jax(idx, on_harness):
    fm = idx["fm"]
    got = fm_torch._densify_sa(idx["torch"]["wide"], fm)
    assert on_harness() >= 3
    want = fm_jax._densify_sa(idx["jax"]["wide"], fm)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def resampled(tmp_path_factory):
    """An index the port saves and loads with RESAMPLE_MIN lowered: its
    SA re-sampled from interval 32 to 4."""
    d = tmp_path_factory.mktemp("resampled4")
    contigs = _contigs(np.random.default_rng(0x4A4), length=8000)
    idx_io.save_index(str(d / "ref"), build_index(contigs))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(idx_io, "RESAMPLE_MIN", 0)
        fm = idx_io.load_index(str(d / "ref"))
    assert fm.sa_intv == 4
    return contigs, fm


@pytest.mark.parametrize("case", ["narrow_packed", "wide_p2x4"])
def test_seed_program_on_a_resampled_index_equals_jax(resampled, on_harness,
                                                      case):
    """The seed program's fused LF walk over the interval-4 table, on
    the kernel's code, against the JAX package's collect_intv_device."""
    contigs, fm = resampled
    dt = fm_torch.DeviceFM.from_host(fm, "cpu", dense_sa_max=0)
    dj = fm_jax.DeviceFM.from_host(fm, dense_sa_max=0)
    assert dt.sa_dense is None and dt.sa_intv == 4
    narrow = case == "narrow_packed"
    kw = dict(pack_H=32) if narrow else dict(p2x=4)
    reads = _sample_reads(np.random.default_rng(0x4A5), contigs, 48)
    q, qlen = smem_jax.pad_reads(reads, 128)
    opt = MemOpt()
    oj = smem_jax.collect_intv_device(
        fm_jax._narrow_view(dj) if narrow else dj, 128, 64, 128, 128 * 16,
        jnp.asarray(q), jnp.asarray(qlen), *smem_jax._opt_params(opt),
        sa_intv_s=4, **kw)
    ot = smem_torch.collect_intv_device(
        dt.narrow() if narrow else dt, 128, 64, 128, 128 * 16,
        torch.as_tensor(q), torch.as_tensor(qlen),
        *smem_torch._opt_params(opt), sa_intv_s=4, **kw)
    assert on_harness() == 3
    assert len(oj) == len(ot)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_walk_on_the_card_launches_or_raises(idx, monkeypatch):
    """A CUDA tensor takes the kernel and never the plain walk: with no
    nvcc, loading the kernel raises (no fallback); the launcher refuses
    CPU tensors; a tensor on another device raises."""
    dt = idx["torch"]["wide"]
    ks = torch.as_tensor(_rows(idx, "random"))
    monkeypatch.setattr(fm_torch, "_lf_walk_plain", lambda *a, **k:
                        pytest.fail("the plain walk ran"))
    monkeypatch.setattr(fm_torch, "_on_card", lambda t, who: True)
    with pytest.raises(ValueError, match="tensors must be on a CUDA"):
        fm_torch.sa_batch(dt, ks, 256, 32)
    monkeypatch.setattr(fm_cuda, "_device", lambda t: t.device)
    monkeypatch.setattr(fm_cuda._build, "nvcc", lambda: (_ for _ in ())
                        .throw(RuntimeError("nvcc not found")))
    monkeypatch.setattr(fm_cuda, "_FNS", {})
    before = dict(fm_cuda.n_launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fm_torch.sa_batch(dt, ks, 256, 32)
    assert fm_cuda.n_launches == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="expected cuda"):
        fm_torch._on_card(torch.empty(4, device="meta"), "_lf_walk")


def test_walk_on_the_cpu_takes_the_plain_version(idx):
    before = dict(fm_cuda.n_launches)
    ks = torch.as_tensor(_rows(idx, "random"))
    vals, _ = fm_torch.sa_batch(idx["torch"]["wide"], ks, 4096, 32)
    assert fm_cuda.n_launches == before
    want = fm_jax.sa_batch(idx["jax"]["wide"], jnp.asarray(ks.numpy()),
                           4096, 32)[0]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want))


# ------------------------------------------------------- the walk's bound

def test_walk_work_counts_distinct_rows_and_chains_once():
    """chip_smoke.walk_work on a hand-made launch: 8 slots, the first 6
    hold lanes (live count 6), 2 are padding. Lanes (rows, sa_intv 4 so
    mask 3): 5, 5 (a duplicate start), 130, 8 (dead on entry: 8 & 3 ==
    0), 70, and 129, which is where lane 0's chain goes after one step.
    Hand-made trace (the rows each step starts from), primary 10:
      step 1: 5, 5, 130, 70, 129
      step 2: 129, 129, 63, 66      (lanes 0 and 1 reach 129)
      step 3: 66, 66, 67            (lane 5: 129 -> 66 like lanes 0, 1)
    Distinct rows stepped from: 5, 130, 70, 129, 63, 66, 67 = 7.
    Their fm_blocks rows ((row - (row >= 10)) // 64): 5 -> 0, 130 ->
    2 (129), 70 -> 1 (69), 129 -> 2 (128), 63 -> 0 (62), 66 -> 1 (65),
    67 -> 1 (66): distinct 0, 1, 2 = 3, 96 bytes. Lanes that walk: 5; dead on
    entry: 1; int32: 5 x 16 + 1 x 4 = 84 bytes; in all 180 bytes.
    Operations: 7 x OPS_PER_LF. Longest lane: 3 steps; 12 steps."""
    kk0 = torch.tensor([5, 5, 130, 8, 70, 129, 5, 5], dtype=torch.int32)
    trace = [torch.tensor(r, dtype=torch.int32) for r in (
        [5, 5, 130, 70, 129], [129, 129, 63, 66], [66, 66, 67])]
    w = chip_smoke.walk_work(kk0, torch.tensor([6], dtype=torch.int32),
                             trace, 3, 10, 1000)
    assert w == dict(slots=8, live=6, walking=5, dead_on_entry=1, blocks=3,
                     stepped_rows=7, steps=12, longest=3, bytes=180,
                     ops=7 * chip_smoke.OPS_PER_LF)
    # wide rows: 8 bytes a row and a step count
    w64 = chip_smoke.walk_work(kk0.long(), 6, trace, 3, 10, 1000)
    assert w64["bytes"] == 96 + 5 * 32 + 8
    # no live count: every slot holds a lane (both padding copies of
    # lane 0 walk, the same rows, so the trace and its counts hold)
    wall = chip_smoke.walk_work(kk0, None, trace, 3, 10, 1000)
    assert (wall["walking"], wall["dead_on_entry"], wall["bytes"]) == \
        (7, 1, 96 + 7 * 16 + 4)


def test_walk_trace_is_the_plain_walks_steps(idx):
    """walk_trace's rows are the rows the plain walk steps from: lane by
    lane they sum to the walk's steps, and padding slots take none."""
    dt = idx["torch"]["wide"]
    mask = int(idx["fm"].sa_intv) - 1
    kk = torch.as_tensor(_rows(idx, "full_pools"))
    live = torch.tensor([40], dtype=torch.int32)
    trace = chip_smoke.walk_trace(dt, mask, kk, 64, live)
    _, steps = fm_torch._lf_walk_plain(dt, mask, kk, torch.zeros_like(kk),
                                       64, live=live)
    assert sum(len(t) for t in trace) == int(steps.sum())
    assert int(steps[40:].sum()) == 0
    assert len(trace) == int(steps.max())
    w = chip_smoke.walk_work(kk, live, trace, mask, dt.primary, dt.seq_len)
    assert w["steps"] == int(steps.sum()) and w["walking"] == int(
        ((kk[:40] & mask) != 0).sum())
