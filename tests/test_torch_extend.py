"""The plain PyTorch ksw_extend2 (ops/extend_torch.py, the CUDA kernels'
CPU path and yardstick), with int32 and with int16 DP rows, against the
JAX package: the Pallas kernel _extend_pallas (both bodies) run in
interpret mode, and the XLA extend_core, over the task mixes of
tests/test_extend_jax.py and over chip_smoke.py's chunk-edge mix (the
inputs its phase 2 hands the CUDA kernels on the card). Exact equality
on all six outputs."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from bwa_flow_tpu.ops.extend_jax import extend_batch_np
from bwa_flow_tpu.ops.extend_pallas import _extend_pallas
from bwa_flow_tpu.utils.opts import MemOpt
from bwa_flow_tpu_torch.ops.extend_torch import extend_core, extend_core16

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

NAMES = ("score", "qle", "tle", "gtle", "gscore", "max_off")


def _rand_tasks(rng, n, qmax, tmax, mut=0.08):
    """Extension-shaped tasks: target = mutated copy of the query."""
    query = np.zeros((n, qmax), dtype=np.int32)
    target = np.zeros((n, tmax), dtype=np.int32)
    qlen = np.zeros(n, dtype=np.int32)
    tlen = np.zeros(n, dtype=np.int32)
    h0 = np.zeros(n, dtype=np.int32)
    for b in range(n):
        ql = int(rng.integers(1, qmax + 1))
        tl = int(rng.integers(1, tmax + 1))
        q = rng.integers(0, 4, size=ql)
        t = np.resize(q, tl).copy()
        m = rng.random(tl) < mut
        t[m] = rng.integers(0, 4, size=m.sum())
        if tl > 4 and rng.random() < 0.5:
            cut = int(rng.integers(1, tl - 1))
            t = np.concatenate([t[:cut], t[cut + 1:],
                                [int(rng.integers(0, 4))]])
        query[b, :ql] = q
        target[b, :tl] = t[:tl]
        qlen[b] = ql
        tlen[b] = tl
        h0[b] = int(rng.integers(1, 60))
    return query, qlen, target, tlen, h0


def _torch_run(q, ql, t, tl, h0, mat, sc, core=extend_core):
    return [o.numpy() for o in core(
        q.shape[1], t.shape[1], *(torch.as_tensor(a) for a in
                                  (q, ql, t, tl, h0, mat)), *sc)]


def _assert_same(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        bad = np.nonzero(np.asarray(g) != np.asarray(w))[0]
        assert not len(bad), (f"{NAMES[k]} differs on lanes {bad[:8]}: "
                              f"{np.asarray(g)[bad[:8]]} vs "
                              f"{np.asarray(w)[bad[:8]]}")


def _asym():
    opt = MemOpt(o_del=5, e_del=2, o_ins=9, e_ins=1, a=2, b=5)
    opt.refresh_mat()
    return opt


# (n, qmax, tmax, opt, w, zdrop, mut) — the cases of test_extend_jax.py
CASES = {
    "default_params": (64, 96, 128, MemOpt, None, None, 0.08),
    "narrow_band": (48, 80, 96, MemOpt, 8, None, 0.08),
    "no_zdrop": (32, 64, 80, MemOpt, None, 0, 0.08),
    "tight_zdrop_noisy": (48, 96, 128, MemOpt, None, 25, 0.3),
    "asym_gaps": (48, 72, 96, _asym, None, None, 0.08),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_extend_equals_jax_extend_core(case):
    n, qmax, tmax, mk, w, zd, mut = CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    opt = mk()
    q, ql, t, tl, h0 = _rand_tasks(rng, n, qmax, tmax, mut)
    mat = opt.mat[:5, :5].astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
          opt.w if w is None else w, 5, opt.zdrop if zd is None else zd)
    want = extend_batch_np(q, ql, t, tl, h0, mat, *sc)
    _assert_same(_torch_run(q, ql, t, tl, h0, mat, sc), want)


def test_plain_extend_degenerate_lanes():
    opt = MemOpt()
    mat = opt.mat[:5, :5].astype(np.int32)
    query = np.zeros((3, 16), dtype=np.int32)
    target = np.zeros((3, 16), dtype=np.int32)
    qlen = np.array([0, 8, 8], dtype=np.int32)
    tlen = np.array([8, 0, 8], dtype=np.int32)
    h0 = np.array([7, 7, 7], dtype=np.int32)
    query[2, :8] = target[2, :8] = [0, 1, 2, 3, 0, 1, 2, 3]
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w, 5, opt.zdrop)
    got = _torch_run(query, qlen, target, tlen, h0, mat, sc)
    _assert_same(got, extend_batch_np(query, qlen, target, tlen, h0, mat,
                                      *sc))
    for b in (0, 1):
        assert [int(o[b]) for o in got] == [7, 0, 0, 0, -1, 0]
    assert int(got[0][2]) == 7 + 8 and int(got[4][2]) == 7 + 8


def test_plain_extend_per_lane_band():
    """Per-lane w (the band-doubling retry's 2w lanes)."""
    rng = np.random.default_rng(21)
    opt = MemOpt()
    q, ql, t, tl, h0 = _rand_tasks(rng, 24, 48, 64)
    mat = opt.mat[:5, :5].astype(np.int32)
    w = rng.choice([4, 8, 100, 200], 24).astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    got = [o.numpy() for o in extend_core(
        48, 64, *(torch.as_tensor(a) for a in (q, ql, t, tl, h0, mat)),
        *sc, torch.as_tensor(w), 5, opt.zdrop)]
    # extend_batch_np takes a scalar w: compare the lanes of each width
    for wv in np.unique(w):
        want = extend_batch_np(q, ql, t, tl, h0, mat, *sc, int(wv), 5,
                               opt.zdrop)
        sel = w == wv
        _assert_same([g[sel] for g in got], [np.asarray(x)[sel]
                                             for x in want])


@pytest.fixture(scope="module")
def pallas_case():
    """One Pallas interpret-mode run (the TPU kernel's reference
    semantics) at B=16, qmax=32, tmax=64; with degenerate lanes."""
    rng = np.random.default_rng(0xE47)
    opt = MemOpt()
    q, ql, t, tl, h0 = _rand_tasks(rng, 16, 32, 64)
    ql[3] = 0
    tl[7] = 0
    mat = opt.mat[:5, :5].astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w, 5, opt.zdrop)
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    out = _extend_pallas(32, 64, 256, True,
                         *(jnp.asarray(a) for a in (q, ql, t, tl, h0)),
                         jnp.asarray(mat), *(i32(v) for v in sc))
    return (q, ql, t, tl, h0, mat, sc), [np.asarray(o) for o in out]


def test_plain_extend_equals_pallas_interpret(pallas_case):
    """Holds the plain version against the TPU kernel itself (run
    unjitted in interpret mode, as extend_core_pallas explains)."""
    args, want = pallas_case
    _assert_same(_torch_run(*args), want)


def test_pallas_interpret_equals_jax_extend_core(pallas_case):
    """The TPU kernel's first test in any mode: it equals the XLA
    extend_core it replaced."""
    (q, ql, t, tl, h0, mat, sc), want = pallas_case
    _assert_same(want, extend_batch_np(q, ql, t, tl, h0, mat, *sc))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_extend16_equals_jax_extend_core(case):
    """The int16-row plain version (every case is inside fits_i16)."""
    n, qmax, tmax, mk, w, zd, mut = CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    opt = mk()
    q, ql, t, tl, h0 = _rand_tasks(rng, n, qmax, tmax, mut)
    mat = opt.mat[:5, :5].astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
          opt.w if w is None else w, 5, opt.zdrop if zd is None else zd)
    want = extend_batch_np(q, ql, t, tl, h0, mat, *sc)
    _assert_same(_torch_run(q, ql, t, tl, h0, mat, sc, extend_core16), want)


@pytest.fixture(scope="module", params=[0xE47, 0x16B])
def pallas16_case(request):
    """The int16 Pallas body (use16=True) in interpret mode at B=16,
    qmax=32, tmax=64, with degenerate lanes; two input seeds."""
    rng = np.random.default_rng(request.param)
    opt = MemOpt()
    q, ql, t, tl, h0 = _rand_tasks(rng, 16, 32, 64)
    ql[3] = 0
    tl[7] = 0
    mat = opt.mat[:5, :5].astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w, 5, opt.zdrop)
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    out = _extend_pallas(32, 64, 256, True,
                         *(jnp.asarray(a) for a in (q, ql, t, tl, h0)),
                         jnp.asarray(mat), *(i32(v) for v in sc),
                         use16=True)
    return (q, ql, t, tl, h0, mat, sc), [np.asarray(o) for o in out]


def test_plain_extend16_equals_pallas16_interpret(pallas16_case):
    args, want = pallas16_case
    _assert_same(_torch_run(*args, core=extend_core16), want)


def test_pallas16_interpret_equals_jax_extend_core(pallas16_case):
    """The int16 TPU kernel is exact under the interpreter: it equals
    the XLA extend_core."""
    (q, ql, t, tl, h0, mat, sc), want = pallas16_case
    _assert_same(want, extend_batch_np(q, ql, t, tl, h0, mat, *sc))


@pytest.fixture(scope="module", params=[0, 1], ids=["defaults", "asym"])
def edge_case(request):
    """chip_smoke.py's chunk-edge mix at its card shapes (B=96, qmax=160,
    tmax=512, per-lane w), with the JAX package's extend_core run on
    each band width's lanes."""
    _, opt, zd = chip_smoke.scorings()[request.param]
    q, ql, t, tl, h0, w = chip_smoke.make_edge_tasks(
        np.random.default_rng(chip_smoke.EDGE_SEED), chip_smoke.EDGE_B,
        chip_smoke.edge_h0max())
    mat = opt.mat[:5, :5].astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    want = [np.zeros(len(q), np.int32) for _ in range(6)]
    for wv in np.unique(w):
        out = extend_batch_np(q, ql, t, tl, h0, mat, *sc, int(wv),
                              opt.pen_clip3, zd)
        sel = w == wv
        for k in range(6):
            want[k][sel] = np.asarray(out[k])[sel]
    return (q, ql, t, tl, h0, mat, sc, w, opt.pen_clip3, zd), want


@pytest.mark.parametrize("core", [extend_core, extend_core16],
                         ids=["int32", "int16"])
def test_plain_extend_chunk_edge_mix(edge_case, core):
    """Query lengths at the warp kernels' 32- and 64-column chunk edges,
    the band-doubling retry's widths, h0 up to the int16 bound and
    degenerate lanes: both plain versions equal the JAX extend_core."""
    (q, ql, t, tl, h0, mat, sc, w, eb, zd), want = edge_case
    got = [o.numpy() for o in core(
        q.shape[1], t.shape[1],
        *(torch.as_tensor(a) for a in (q, ql, t, tl, h0, mat)), *sc,
        torch.as_tensor(w), eb, zd)]
    _assert_same(got, want)
