"""bwa_flow_tpu_torch.ops.smem_torch (the device seed program) against
bwa_flow_tpu.ops.smem_jax on the same inputs: raw outputs (mems, n_mem,
OVF_* bits, fused SA pool, occ totals, packed bundle), the collected
IntvBatch and SA values, and the golden collect_intv. Mirrors
tests/test_smem_jax.py and the seed-only tests of
tests/test_seed_bundle.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwa_flow_tpu.index.build import build_index
from bwa_flow_tpu.ops import fm_jax, smem_jax
from bwa_flow_tpu.ops import smem as jax_golden
from bwa_flow_tpu.utils.opts import MemOpt
from bwa_flow_tpu_torch.index import io as idx_io
from bwa_flow_tpu_torch.ops import fm_torch, smem_torch
from bwa_flow_tpu_torch.ops import smem as port_golden
from bwa_flow_tpu_torch.ops.probe_layout import sa_probe_layout

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

CODE = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    CODE[_ch] = _i


def _contigs(rng, length=6000, n_contigs=2):
    out = []
    per = length // n_contigs
    for i in range(n_contigs):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, per)].copy()
        st = int(rng.integers(10, per - 20))
        seq[st:st + 5] = ord("N")
        out.append((f"ctg{i}", "", seq.tobytes()))
    return out


def _sample_reads(rng, contigs, n, L=101):
    """Reads with SNPs, N runs, deletions and unmappable ones."""
    seqs = [np.frombuffer(s, dtype=np.uint8) for _, _, s in contigs]
    reads = []
    for _ in range(n):
        seq = seqs[int(rng.integers(0, len(seqs)))]
        pos = int(rng.integers(0, max(1, len(seq) - L)))
        r = CODE[seq[pos:pos + L]].astype(np.int32).copy()
        kind = rng.random()
        if kind < 0.35:
            m = rng.random(len(r)) < 0.05
            r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        elif kind < 0.5:
            st = int(rng.integers(0, max(1, len(r) - 6)))
            r[st:st + 4] = 4
        elif kind < 0.65:
            cut = int(rng.integers(1, len(r) - 2))
            r = np.concatenate([r[:cut], r[cut + 2:]])
        elif kind < 0.75:
            r = rng.integers(0, 4, size=len(r)).astype(np.int32)
        reads.append(r.astype(np.uint8))
    return reads


@pytest.fixture(scope="module")
def idx():
    contigs = _contigs(np.random.default_rng(0x5EE))
    fm = build_index(contigs)
    return dict(contigs=contigs, fm=fm,
                djax=fm_jax.DeviceFM.from_host(fm),
                dt=fm_torch.DeviceFM.from_host(fm, "cpu"))


def _key(lst):
    return [(m.x0, m.x1, m.s, m.info) for m in lst]


def _both_lists(idx, opt, reads, **kw):
    got_j = smem_jax.collect_intv_batch(opt, idx["fm"], idx["djax"], reads,
                                        **kw)
    got_t = smem_torch.collect_intv_batch(opt, idx["fm"], idx["dt"], reads,
                                          **kw)
    return got_j, got_t


def _check_lists(idx, opt, reads, got_j, got_t):
    for b, r in enumerate(reads):
        assert _key(got_t[b]) == _key(got_j[b]), f"read {b}"
        want = jax_golden.collect_intv(opt, idx["fm"], r)
        assert sorted(_key(got_t[b])) == sorted(_key(want)), f"read {b}"


@pytest.mark.parametrize("case", ["narrow_packed", "wide", "big", "p2x4"])
def test_collect_intv_device_raw_outputs(idx, case):
    """Every output of the seed program, bit for bit, including the
    OVF_* bits and the packed one-array bundle."""
    reads = _sample_reads(np.random.default_rng(31), idx["contigs"], 48)
    q, qlen = smem_jax.pad_reads(reads, 128)
    opt = MemOpt()
    wide = case == "wide"
    kw = {"narrow_packed": dict(pack_H=32), "wide": {},
          "big": dict(big=True), "p2x4": dict(p2x=4)}[case]
    dj = idx["djax"] if wide else fm_jax._narrow_view(idx["djax"])
    dt = idx["dt"] if wide else idx["dt"].narrow()
    oj = smem_jax.collect_intv_device(dj, 128, 64, 128, 128 * 16,
                                      jnp.asarray(q), jnp.asarray(qlen),
                                      *smem_jax._opt_params(opt), **kw)
    ot = smem_torch.collect_intv_device(dt, 128, 64, 128, 128 * 16,
                                        torch.as_tensor(q),
                                        torch.as_tensor(qlen),
                                        *smem_torch._opt_params(opt), **kw)
    assert len(oj) == len(ot)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_seed_collect_batch_equals_jax(idx):
    """The IntvBatch and per-read fused SA values of seed_collect_batch."""
    reads = _sample_reads(np.random.default_rng(32), idx["contigs"], 40)
    opt = MemOpt()
    hj = smem_jax.seed_dispatch(opt, idx["fm"], idx["djax"], reads, L=128)
    bj = smem_jax.seed_collect_batch(hj)
    ht = smem_torch.seed_dispatch(opt, idx["fm"], idx["dt"], reads, L=128)
    bt = smem_torch.seed_collect_batch(ht)
    for name in ("iv_off", "x0", "x1", "sv", "st", "en"):
        np.testing.assert_array_equal(getattr(bt, name), getattr(bj, name))
    assert len(ht["sa_vals"]) == len(hj["sa_vals"])
    for a, b in zip(hj["sa_vals"], ht["sa_vals"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)


def test_collect_intv_device_matches_golden(idx):
    opt = MemOpt()
    reads = _sample_reads(np.random.default_rng(33), idx["contigs"], 48)
    _check_lists(idx, opt, reads, *_both_lists(idx, opt, reads, L=128))


def test_collect_intv_device_no_pass3(idx):
    opt = MemOpt(max_mem_intv=0)
    reads = _sample_reads(np.random.default_rng(34), idx["contigs"], 16)
    _check_lists(idx, opt, reads, *_both_lists(idx, opt, reads, L=128))


def test_collect_intv_overflow_fallback(idx, monkeypatch):
    """Tiny budgets overflow every read; with the device redo off both
    packages fall back to the host golden."""
    opt = MemOpt()
    reads = _sample_reads(np.random.default_rng(35), idx["contigs"], 8)
    monkeypatch.setattr(smem_jax, "DEVICE_REDO", False)
    monkeypatch.setattr(smem_torch, "DEVICE_REDO", False)
    _check_lists(idx, opt, reads, *_both_lists(
        idx, opt, reads, L=128, MAXB=2, MAXM=4, iters_factor=1))


def test_collect_intv_device_redo(idx, monkeypatch):
    """MAXM=4 overflows every read (OVF_MEMS); the big-budget device
    machine resolves all of them without the host golden."""
    opt = MemOpt()
    reads = _sample_reads(np.random.default_rng(36), idx["contigs"], 8)
    calls = []
    real = port_golden.collect_intv
    monkeypatch.setattr(port_golden, "collect_intv",
                        lambda *a: calls.append(a) or real(*a))
    got_j, got_t = _both_lists(idx, opt, reads, L=128, MAXB=2, MAXM=4,
                               iters_factor=1)
    assert not calls, "the device redo should resolve every overflow"
    _check_lists(idx, opt, reads, got_j, got_t)


def test_collect_intv_all_n_read(idx):
    got = smem_torch.collect_intv_batch(MemOpt(), idx["fm"], idx["dt"],
                                        [np.full(50, 4, dtype=np.uint8)],
                                        L=128)
    assert got[0] == []


def test_collect_intv_wide_path_matches_golden(idx, monkeypatch):
    """The int64 (wide) machine, forced on a small genome."""
    opt = MemOpt()
    reads = _sample_reads(np.random.default_rng(37), idx["contigs"], 24)
    monkeypatch.setattr(smem_jax, "FORCE_WIDE", True)
    monkeypatch.setattr(idx_io, "FORCE_WIDE", True)
    ht = smem_torch.seed_dispatch(opt, idx["fm"], idx["dt"], reads, L=128)
    assert "packed" not in ht
    assert ht["mems"].dtype == torch.int64
    got_t = smem_torch.seed_collect(ht)
    got_j = smem_jax.seed_collect(smem_jax.seed_dispatch(
        opt, idx["fm"], idx["djax"], reads, L=128))
    _check_lists(idx, opt, reads, got_j, got_t)


def _snp_reads(rng, contigs, n, L=101):
    seqs = [np.frombuffer(s, dtype=np.uint8) for _, _, s in contigs]
    out = []
    for _ in range(n):
        seq = seqs[int(rng.integers(0, len(seqs)))]
        pos = int(rng.integers(0, max(1, len(seq) - L)))
        r = CODE[seq[pos:pos + L]].astype(np.int32).copy()
        m = rng.random(len(r)) < 0.04
        r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        out.append(r.astype(np.uint8))
    return out


def test_ragged_pool_overflow_dense_refetch(idx, monkeypatch):
    """CAPM/CAPO pools far below the batch totals: the host refetches
    the dense mems and the probe path takes over the SA values."""
    opt = MemOpt()
    reads = _snp_reads(np.random.default_rng(38), idx["contigs"], 24)
    monkeypatch.setattr(smem_jax, "CAPM_PER", 1)
    monkeypatch.setattr(smem_jax, "CAPO_PER", 1)
    monkeypatch.setattr(smem_torch, "CAPM_PER", 1)
    monkeypatch.setattr(smem_torch, "CAPO_PER", 1)
    smem_jax.collect_intv_device.clear_cache()
    try:
        got_j, got_t = _both_lists(idx, opt, reads, L=128)
    finally:
        smem_jax.collect_intv_device.clear_cache()
    _check_lists(idx, opt, reads, got_j, got_t)


def test_batch_view_elides_x1_lists_view_restores(idx):
    opt = MemOpt()
    reads = _snp_reads(np.random.default_rng(39), idx["contigs"], 8)
    batch = smem_torch.seed_collect_batch(
        smem_torch.seed_dispatch(opt, idx["fm"], idx["dt"], reads, L=128))
    lists = smem_torch.seed_collect(
        smem_torch.seed_dispatch(opt, idx["fm"], idx["dt"], reads, L=128))
    for b, r in enumerate(reads):
        want = port_golden.collect_intv(opt, idx["fm"], r)
        assert _key(lists[b]) == _key(want)
        lo, hi = batch.iv_off[b], batch.iv_off[b + 1]
        assert list(batch.x0[lo:hi]) == [m.x0 for m in want]


def test_global_fused_sa_heavy_occ_reads():
    """Reads whose occurrence totals exceed 64 resolve SA through the
    global fused pool; values equal the JAX package's."""
    rng = np.random.default_rng(40)
    unit = rng.integers(0, 4, 97)
    flank = rng.integers(0, 4, 800)
    g = np.concatenate([flank, np.tile(unit, 120), flank[::-1]])
    seq = bytes(bytearray(b"ACGT"[int(c)] for c in g))
    fm = build_index([("chr1", "", seq)])
    opt = MemOpt()
    seqs = []
    for _ in range(12):
        pos = int(rng.integers(0, len(g) - 101))
        r = CODE[np.frombuffer(seq[pos:pos + 101], np.uint8)].copy()
        m = rng.random(101) < 0.02
        r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        seqs.append(r.astype(np.uint8))
    hj = smem_jax.seed_dispatch(opt, fm, fm_jax.DeviceFM.from_host(fm),
                                seqs, L=160)
    smem_jax.seed_collect_batch(hj)
    ht = smem_torch.seed_dispatch(opt, fm,
                                  fm_torch.DeviceFM.from_host(fm, "cpu"),
                                  seqs, L=160)
    smem_torch.seed_collect_batch(ht)
    heavy = [v for v in ht["sa_vals"] if v is not None and len(v) > 64]
    assert heavy, "expected reads with >64 fused SA occurrences"
    for a, b in zip(hj["sa_vals"], ht["sa_vals"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)


def test_fused_sa_walk_sparse_intv(idx):
    """No dense SA and a sparse sampled SA (intv 32): the seed program
    resolves SA through the fused phased LF walk. Values equal the JAX
    package's and the host bwt_sa."""
    from bwa_flow_tpu.ops import fm as fmops
    fm32 = build_index(list(idx["contigs"]), sa_intv=32)
    opt = MemOpt()
    seqs = _snp_reads(np.random.default_rng(41), idx["contigs"], 24)
    dt = fm_torch.DeviceFM.from_host(fm32, "cpu", dense_sa_max=0)
    assert dt.sa_dense is None
    ht = smem_torch.seed_dispatch(opt, fm32, dt, seqs, L=128)
    batch = smem_torch.seed_collect_batch(ht)
    hj = smem_jax.seed_dispatch(
        opt, fm32, fm_jax.DeviceFM.from_host(fm32, dense_sa_max=0), seqs,
        L=128)
    smem_jax.seed_collect_batch(hj)
    sav = ht["sa_vals"]
    assert sum(1 for v in sav if v is not None) >= 20
    for a, b in zip(hj["sa_vals"], sav):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
    rows, offs, _ = sa_probe_layout(opt, batch, build_owners=False)
    checked = 0
    for b in range(len(seqs)):
        if sav[b] is None:
            continue
        lo, hi = int(offs[b]), int(offs[b + 1])
        assert hi - lo == len(sav[b])
        for j in range(lo, hi):
            assert int(sav[b][j - lo]) == fmops.bwt_sa(fm32, int(rows[j]))
            checked += 1
    assert checked > 50


def test_adaptive_pool_escalation():
    """Reads with ~5 re-seed tasks each overflow the 2/read pass-2 pool:
    both packages escalate p2x after the first batch and stay exact."""
    rng = np.random.default_rng(42)
    g = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 40000)].tobytes()
    fm = build_index([("chr1", "", g)])
    gi = CODE[np.frombuffer(g, np.uint8)]
    opt = MemOpt()
    batch = [np.concatenate([gi[p:p + 30] for p in
                             rng.integers(0, len(gi) - 30, 5)]
                            ).astype(np.uint8) for _ in range(64)]
    dfm_j = fm_jax.DeviceFM.from_host(fm)
    dfm_t = fm_torch.DeviceFM.from_host(fm, "cpu")
    smem_jax._ADAPT.clear()
    smem_torch._ADAPT.clear()
    try:
        out = []
        for mod, dfm in ((smem_jax, dfm_j), (smem_torch, dfm_t)):
            h1 = mod.seed_dispatch(opt, fm, dfm, batch, L=160)
            assert h1["p2x"] == 1
            got1 = mod.seed_collect(h1)
            assert mod._ADAPT.get(id(fm), 1) > 1
            h2 = mod.seed_dispatch(opt, fm, dfm, batch, L=160)
            assert h2["p2x"] > 1
            out.append((got1, mod.seed_collect(h2)))
    finally:
        smem_jax._ADAPT.clear()
        smem_torch._ADAPT.clear()
    (j1, j2), (t1, t2) = out
    for b, r in enumerate(batch):
        want = sorted(_key(port_golden.collect_intv(opt, fm, r)))
        for gj, gt in ((j1, t1), (j2, t2)):
            assert _key(gt[b]) == _key(gj[b]), f"read {b}"
            assert sorted(_key(gt[b])) == want, f"read {b}"
