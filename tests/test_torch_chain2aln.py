"""bwa_flow_tpu_torch.ops.chain2aln_torch against
bwa_flow_tpu.ops.chain2aln_jax: reference-window decoding from the packed
pac (both walk directions, both strands) and the descriptor-driven
coupled extension wave (incl. right-only retries and empty sides), with
the int32 and the int16 extension core, and the fits_i16 gate that picks
between them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwa_flow_tpu.index.build import build_index
from bwa_flow_tpu.ops import chain2aln_jax, extend_pallas, fm_jax
from bwa_flow_tpu.utils.opts import MemOpt
from bwa_flow_tpu_torch.ops import (chain2aln_torch, extend_cuda,
                                    extend_torch, fm_torch)

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def idx():
    rng = np.random.default_rng(0xC2A)
    contigs = [(f"c{i}", "", np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 1500)].tobytes()) for i in range(2)]
    fm = build_index(contigs)
    djax = fm_jax.DeviceFM.from_host(fm)
    leaves = {k: None if v is None else np.asarray(v)
              for k, v in djax._asdict().items()}
    return dict(fm=fm, djax=djax,
                dt=fm_torch.DeviceFM.from_numpy(leaves, "cpu"))


@pytest.mark.parametrize("step_down", [False, True])
def test_pac_window_batch(idx, step_down):
    l_pac = idx["fm"].bns.l_pac
    rng = np.random.default_rng(51 + step_down)
    N = 64
    fwd = rng.integers(N + 1, l_pac - N - 1, 40)
    rev = rng.integers(l_pac + N + 1, 2 * l_pac - N - 1, 40)
    edge = np.array([N, l_pac - N, l_pac + N, 2 * l_pac - N, 0, l_pac,
                     2 * l_pac])
    start = np.concatenate([fwd, rev, edge]).astype(np.int64)
    want = chain2aln_jax._pac_window_batch(idx["djax"], jnp.asarray(start),
                                           step_down, N)
    got = chain2aln_torch._pac_window_batch(idx["dt"], torch.as_tensor(start),
                                            step_down, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _descs(rng, l_pac, n_reads, L, T, qmax):
    """Descriptor columns of plausible tasks: seed [qbeg, qbeg+slen) of a
    read placed at rbeg on either strand, windows inside the strand."""
    cols = []
    for t in range(T):
        l_query = int(rng.integers(20, L + 1))
        slen = int(rng.integers(5, min(20, l_query) + 1))
        qbeg = int(rng.integers(0, min(l_query - slen, qmax) + 1))
        rev = rng.random() < 0.5
        lo, hi = (l_pac, 2 * l_pac) if rev else (0, l_pac)
        rbeg = int(rng.integers(lo + 80, hi - 80 - slen))
        rmax0 = max(lo, rbeg - qbeg - int(rng.integers(0, 40)))
        rmax1 = min(hi, rbeg + slen + (l_query - qbeg - slen)
                    + int(rng.integers(0, 40)))
        h0 = slen
        w = int(rng.choice([5, 20, 100]))
        skip = int(rng.random() < 0.2)
        cols.append((int(rng.integers(0, n_reads)), qbeg, slen, l_query,
                     rbeg, rmax0, rmax1, h0 + (7 if skip else 0), w,
                     int(rng.choice([5, 20, 100])), skip))
    # empty sides: no left query (qbeg 0), no right query (seed at end)
    cols.append((0, 0, 10, 30, 200, 150, 300, 10, 20, 20, 0))
    cols.append((1, 20, 10, 30, 200, 150, 300, 10, 20, 20, 0))
    cols.append((2, 0, 30, 30, 200, 150, 300, 30, 20, 20, 0))
    return np.array(cols, np.int64).T.copy()


def _desc_wave(idx, use16):
    """One descriptor wave through both packages; (port, JAX) results."""
    rng = np.random.default_rng(52)
    qmax, tmax, L = 48, 96, 60
    n_reads = 8
    reads = rng.integers(0, 5, (n_reads, L)).astype(np.uint8)
    desc = _descs(rng, idx["fm"].bns.l_pac, n_reads, L, 40, qmax)
    opt = MemOpt()
    mat = np.ascontiguousarray(opt.mat[:5, :5]).astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.pen_clip5,
          opt.pen_clip3, opt.zdrop)
    want = chain2aln_jax.seed_extend_desc_batch(
        qmax, tmax, L, idx["djax"], jnp.asarray(reads), jnp.asarray(desc),
        jnp.asarray(mat), *(jnp.asarray(v, jnp.int32) for v in sc),
        use16=use16)
    got = chain2aln_torch.seed_extend_desc_batch(
        qmax, tmax, L, idx["dt"], torch.as_tensor(reads),
        torch.as_tensor(desc), torch.as_tensor(mat), *sc, use16=use16)
    return got, want


def test_seed_extend_desc_batch(idx):
    got, want = _desc_wave(idx, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # empty sides fall through to the incoming scores
    g = got.numpy()
    assert g[0, -3] == 10 and g[6, -2] == g[0, -2]


def test_desc_task_buffer_runs_filled_slots(idx):
    """DescTaskBuffer.run gives the filled slots the same rows as a full
    JAX wave over the padded buffer."""
    from types import SimpleNamespace
    rng = np.random.default_rng(53)
    qmax, tmax, L = 48, 96, 60
    reads = rng.integers(0, 4, (4, L)).astype(np.uint8)
    desc = _descs(rng, idx["fm"].bns.l_pac, 4, L, 6, qmax)
    opt = MemOpt()
    bt = chain2aln_torch.DescTaskBuffer(16, qmax, tmax)
    bj = chain2aln_jax.DescTaskBuffer(16, qmax, tmax)
    for c in range(desc.shape[1]):
        r, qb, sl, lq, rb, r0, r1, h0, wl, wr, sk = (int(v)
                                                     for v in desc[:, c])
        task = SimpleNamespace(qbeg=qb, slen=sl, l_query=lq, rbeg=rb,
                               rmax0=r0, rmax1=r1, h0=h0)
        assert bt.add(task, r, wl, wr, bool(sk), h0) == \
            bj.add(task, r, wl, wr, bool(sk), h0)
    got = bt.run(opt, idx["dt"], torch.as_tensor(reads), L)
    want = bj.run(opt, idx["djax"], jnp.asarray(reads), L)
    assert got.shape == (12, bt.n)
    np.testing.assert_array_equal(got, want[:, :bt.n])


def test_seed_extend_desc_batch_int16(idx):
    """use16 runs both sides on the int16 core (on the CPU the JAX
    package runs its XLA extend_core for either)."""
    got, want = _desc_wave(idx, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gate", ["set", "unset"])
def test_fits_i16_equals_jax(monkeypatch, gate):
    if gate == "set":
        monkeypatch.setenv("BWA_TPU_EXTEND16", "1")
    else:
        monkeypatch.delenv("BWA_TPU_EXTEND16", raising=False)
    got = []
    for qmax in (16, 160, 512, 2000, 7800):
        for h0max in (0, 160, 5000):
            for max_mat in (-1, 0, 1, 2, 5):
                for eb in (-3, 0, 5, 100):
                    args = (qmax, h0max, max_mat, eb)
                    mine = extend_cuda.fits_i16(*args)
                    assert mine == extend_pallas.fits_i16(*args), args
                    got.append(mine)
    assert any(got) == (gate == "set")
    assert not all(got)


@pytest.mark.parametrize("gate", ["set", "unset"])
def test_desc_task_buffer_gate_selects_int16(idx, monkeypatch, gate):
    """BWA_TPU_EXTEND16 picks the int16 core for a wave, read at call
    time; results equal the JAX package's buffer either way."""
    from types import SimpleNamespace
    if gate == "set":
        monkeypatch.setenv("BWA_TPU_EXTEND16", "1")
    else:
        monkeypatch.delenv("BWA_TPU_EXTEND16", raising=False)
    calls = []
    core16 = extend_torch.extend_core16

    def counting(*a, **k):
        calls.append(1)
        return core16(*a, **k)
    monkeypatch.setattr(extend_torch, "extend_core16", counting)
    rng = np.random.default_rng(54)
    qmax, tmax, L = 48, 96, 60
    reads = rng.integers(0, 4, (4, L)).astype(np.uint8)
    desc = _descs(rng, idx["fm"].bns.l_pac, 4, L, 6, qmax)
    opt = MemOpt()
    bt = chain2aln_torch.DescTaskBuffer(16, qmax, tmax)
    bj = chain2aln_jax.DescTaskBuffer(16, qmax, tmax)
    for c in range(desc.shape[1]):
        r, qb, sl, lq, rb, r0, r1, h0, wl, wr, sk = (int(v)
                                                     for v in desc[:, c])
        task = SimpleNamespace(qbeg=qb, slen=sl, l_query=lq, rbeg=rb,
                               rmax0=r0, rmax1=r1, h0=h0)
        bt.add(task, r, wl, wr, bool(sk), h0)
        bj.add(task, r, wl, wr, bool(sk), h0)
    got = bt.run(opt, idx["dt"], torch.as_tensor(reads), L)
    want = bj.run(opt, idx["djax"], jnp.asarray(reads), L)
    np.testing.assert_array_equal(got, want[:, :bt.n])
    assert len(calls) == (2 if gate == "set" else 0)
