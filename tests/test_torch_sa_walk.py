"""The LF walk's callers on the kernel's code, on the CPU, and the bound
chip_smoke.py puts beside each sa_batch call.

Here the sa_walk kernel's own code runs behind ops/fm_cuda.py: the host
harness of tests/test_torch_sa_walk_host.py (csrc/sa_walk.cuh compiled
with the host's c++, its logical blocks run one after another in ticket
order, a block's threads as host threads, blocks of 32 slots so a call
spans many blocks) stands in for the card's launcher, and
fm_torch._on_card sends CPU tensors to it. So the wrapper's handling
around the kernel runs as on the card: one launch a sa_batch call, the
outputs and the call's scratch allocated by the launcher, the caller's
rows left as they were. sa_batch (phased and unphased, narrow and wide,
full B/4 and B/16 pools at B=64, both pools filling across block
boundaries at B=1024, lane 0 live in pools that are not full),
_densify_sa and the seed program on an index re-sampled to interval 4
are held to the JAX package's, exactly; on the card's path the walk
reads nothing (a fetch that raises), and with no nvcc the wrapper raises
for the card."""

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
    card's launcher (blocks of 32 slots); the plain walk must not run.
    Returns the count of launches since."""
    monkeypatch.setattr(fm_torch, "_on_card", lambda t, who: True)
    monkeypatch.setattr(fm_cuda, "_device", lambda t: t.device)
    monkeypatch.setattr(fm_cuda, "_fn", lambda: (
        lib.sa_walk_launch, lib.sa_walk_slots(), lib.sa_walk_error_string))
    monkeypatch.setattr(fm_cuda, "_on_device",
                        lambda dev: contextlib.nullcontext(None))
    monkeypatch.setattr(fm_torch, "_sa_walk_plain", lambda *a, **k:
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
    live in two pools that are not full); "multi_block" (B=1024: 300
    rows longer than 2 intervals, more than the B/4 pool of 256, 80 of
    them longer than 6, more than the B/16 pool of 64, at random places,
    so with blocks of 32 slots both pools fill in a middle block and
    drop lanes from it and every later block)."""
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
    if case == "multi_block":
        k = rng.choice(short, 1024)
        at = rng.permutation(1024)[:300]
        k[at[:80]] = rng.choice(long6, 80)
        k[at[80:]] = rng.choice(long2, 220)
        return k
    return np.concatenate([rng.choice(long6, 1), rng.choice(long2, 2),
                           rng.choice(short, 61, replace=False)])


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("intv", ["phased", "unphased"])
@pytest.mark.parametrize("case", ["random", "full_pools", "lane0_live",
                                  "multi_block"])
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
    # one launch a call: two calls
    assert on_harness() == 2
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
    if case == "multi_block" and intv:
        # the last 44 of the 300 lanes past 2 intervals drop from the B/4
        # pool; of those still live after it, the first 64 walk the B/16
        # pool: the rest overflow, and no lane shorter than 2 intervals
        vals, ovf = fm_torch.sa_batch(idx["torch"][width],
                                      torch.as_tensor(ks), 4096, intv)
        length = idx["length"][ks]
        assert ovf.sum() > 0 and not ovf.numpy()[length <= 2 * intv].any()
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


def test_densify_sa_on_the_kernel_equals_jax(idx, on_harness, monkeypatch):
    fm = idx["fm"]
    calls = []
    real = fm_torch.sa_batch
    monkeypatch.setattr(fm_torch, "sa_batch", lambda *a: calls.append(
        a[3]) or real(*a))
    got = fm_torch._densify_sa(idx["torch"]["wide"], fm)
    # one launch a call: each chunk, and the deep redo if one ran
    assert on_harness() == len(calls) >= 1 and calls[0] == fm.sa_intv
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
    assert on_harness() == 1
    assert len(oj) == len(ot)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_walk_on_the_card_launches_or_raises(idx, monkeypatch):
    """A CUDA tensor takes the kernel and never the plain walk: with no
    nvcc, loading the kernel raises (no fallback); the launcher refuses
    CPU tensors; a tensor on another device raises."""
    dt = idx["torch"]["wide"]
    ks = torch.as_tensor(_rows(idx, "random"))
    monkeypatch.setattr(fm_torch, "_sa_walk_plain", lambda *a, **k:
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
        fm_torch._on_card(torch.empty(4, device="meta"), "sa_batch")


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
    """chip_smoke.walk_work on a call worked out by hand: 8 slots, rows
    (sa_intv 4, so mask 3) 5, 5, 130, 8 (dead on entry: 8 & 3 == 0), 70,
    129, 5, 5; primary 10. The LF chains, made up: 5 -> 129 -> 66 -> a
    sampled row, 130 -> 63 -> a sampled row, 70 -> 66, 129 -> 66. The
    rows each step starts from:
      step 1: 5, 5, 130, 70, 129, 5, 5
      step 2: 129, 129, 63, 66, 66, 129, 129
      step 3: 66, 66, 66, 66          (lanes 0, 1, 6, 7)
    Each lane's steps: 3, 3, 2, 0, 2, 2, 3, 3 (18 in all, the longest
    3). Distinct rows stepped from: 5, 130, 70, 129, 63, 66 = 6. Their
    fm_blocks rows ((row - (row >= 10)) // 64): 5 -> 0, 130 -> 2 (129),
    70 -> 1 (69), 129 -> 2 (128), 63 -> 0 (62), 66 -> 1 (65): 0, 1, 2 =
    3, 96 bytes. Int32 rows and samples: 8 x (4 rows + 9 out + 4
    samples) = 136 bytes, in all 232. Operations: 6 x OPS_PER_LF."""
    k = torch.tensor([5, 5, 130, 8, 70, 129, 5, 5], dtype=torch.int32)
    trace = dict(rows=[torch.tensor(r, dtype=torch.int32) for r in (
        [5, 5, 130, 70, 129, 5, 5], [129, 129, 63, 66, 66, 129, 129],
        [66, 66, 66, 66])], steps=torch.tensor([3, 3, 2, 0, 2, 2, 3, 3]))
    w = chip_smoke.walk_work(k, 4, trace, 3, 10, 1000)
    assert w == dict(slots=8, walking=7, dead_on_entry=1, blocks=3,
                     stepped_rows=6, steps=18, longest=3, bytes=232,
                     ops=6 * chip_smoke.OPS_PER_LF)
    # wide rows: 8 bytes a row; an int64 sampled SA: 8 bytes a sample
    assert chip_smoke.walk_work(k.long(), 4, trace, 3, 10, 1000)[
        "bytes"] == 96 + 8 * (8 + 9 + 4)
    assert chip_smoke.walk_work(k.long(), 8, trace, 3, 10, 1000)[
        "bytes"] == 96 + 8 * (8 + 9 + 8)


@pytest.mark.parametrize("case", ["full_pools", "multi_block"])
def test_walk_trace_is_the_plain_walks_steps(idx, case):
    """walk_trace follows the plain version lane by lane through the
    phases: its steps and last rows give the plain version's values and
    overflow flags, its rows sum to its steps, and the pools' padding
    copies of lane 0 take no steps of their own."""
    dt = idx["torch"]["wide"]
    mask = int(idx["fm"].sa_intv) - 1
    k = torch.as_tensor(_rows(idx, case))
    intv = int(idx["fm"].sa_intv)
    tr = chip_smoke.walk_trace(dt, k, 256, intv)
    sa, ovf = fm_torch._sa_walk_plain(dt, k, 256, intv)
    j = (tr["k"] // dt.sa_intv).clamp(0, dt.sa.numel() - 1)
    assert torch.equal(tr["steps"] + dt.sa[j], sa)
    assert torch.equal((tr["k"] & mask) != 0, ovf) and ovf.any()
    assert sum(len(r) for r in tr["rows"]) == int(tr["steps"].sum())
    w = chip_smoke.walk_work(k, 4, tr, mask, dt.primary, dt.seq_len)
    assert w["longest"] == int(tr["steps"].max()) > 6 * intv
    assert w["walking"] == int(((k & mask) != 0).sum())
