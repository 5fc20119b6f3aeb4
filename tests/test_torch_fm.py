"""bwa_flow_tpu_torch.ops.fm_torch against bwa_flow_tpu.ops.fm_jax (and the
golden NumPy FM ops) on the same index: exact equality. Mirrors
tests/test_fm_jax.py, plus pac_sym_batch, the DeviceFM carry-over from
the JAX leaves, and the port's own index build."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwa_flow_tpu.index.build import build_index as jax_build_index
from bwa_flow_tpu.ops import fm as fmops
from bwa_flow_tpu.ops import fm_jax
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.ops import fm_torch

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)


def _contigs(rng, length=6000, n_contigs=2):
    contigs = []
    per = length // n_contigs
    for i in range(n_contigs):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, per)].copy()
        st = int(rng.integers(10, per - 20))
        seq[st:st + 5] = ord("N")
        contigs.append((f"ctg{i}", "", seq.tobytes()))
    return contigs


@pytest.fixture(scope="module")
def idx():
    contigs = _contigs(np.random.default_rng(0xF11))
    fm = jax_build_index(contigs)
    djax = fm_jax.DeviceFM.from_host(fm)
    leaves = {k: None if v is None else np.asarray(v)
              for k, v in djax._asdict().items()}
    return dict(contigs=contigs, fm=fm, djax=djax,
                dt=fm_torch.DeviceFM.from_numpy(leaves, "cpu"))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_build_index_equals_jax_package(idx):
    fm = idx["fm"]
    mine = build_index(idx["contigs"])
    for name in ("seq_len", "primary", "sa_intv"):
        assert int(getattr(mine, name)) == int(getattr(fm, name))
    for name in ("L2", "fm_blocks", "sa"):
        np.testing.assert_array_equal(np.asarray(getattr(mine, name)),
                                      np.asarray(getattr(fm, name)))
    np.testing.assert_array_equal(mine.bns.pac, fm.bns.pac)


def test_device_fm_from_host_equals_carry_over(idx):
    """The port's own upload (incl. the densified SA) equals the state
    carried over from the JAX DeviceFM leaves."""
    fm, dt = idx["fm"], idx["dt"]
    mine = fm_torch.DeviceFM.from_host(fm, "cpu")
    n_blocks = fm.fm_blocks.shape[0]
    assert (mine.seq_len, mine.primary, mine.l_pac, mine.sa_intv) == \
        (dt.seq_len, dt.primary, dt.l_pac, dt.sa_intv)
    _eq(mine.L2, dt.L2)
    _eq(mine.fm_blocks, dt.fm_blocks[:n_blocks])
    _eq(mine.sa, dt.sa[:len(fm.sa)])
    _eq(mine.pac_words, dt.pac_words[:mine.pac_words.shape[0]])
    _eq(mine.sa_dense, dt.sa_dense[:fm.seq_len + 1])


def test_occ_batch(idx):
    fm, dj, dt = idx["fm"], idx["djax"], idx["dt"]
    rng = np.random.default_rng(11)
    ks = np.concatenate([
        rng.integers(0, fm.seq_len, size=200),
        np.array([-1, 0, 1, fm.seq_len - 1, fm.seq_len,
                  fm.primary - 1, fm.primary, fm.primary + 1]),
    ]).astype(np.int64)
    cs = rng.integers(0, 4, size=len(ks)).astype(np.int32)
    got = fm_torch.occ_batch(dt, _t(ks), _t(cs))
    _eq(got, fm_jax.occ_batch(dj, jnp.asarray(ks), jnp.asarray(cs)))
    _eq(got, [fmops.occ(fm, int(k), int(c)) for k, c in zip(ks, cs)])


def test_occ4_batch(idx):
    fm, dj, dt = idx["fm"], idx["djax"], idx["dt"]
    rng = np.random.default_rng(12)
    ks = np.concatenate([
        rng.integers(-1, fm.seq_len + 1, size=200),
        np.array([-1, fm.seq_len, fm.primary]),
    ]).astype(np.int64)
    for view in (False, True):
        d = dt.narrow() if view else dt
        kk = ks.astype(np.int32 if view else np.int64)
        got = fm_torch.occ4_batch(d, _t(kk))
        _eq(got, fm_jax.occ4_batch(dj, jnp.asarray(ks)))
    _eq(got, np.stack([fmops.occ4(fm, int(k)) for k in ks]))


def test_extend_batch(idx):
    fm, dj, dt = idx["fm"], idx["djax"], idx["dt"]
    rng = np.random.default_rng(13)
    iks = []
    for c in range(4):
        ik = fmops.set_intv(fm, c)
        iks.append(ik.copy())
        for _ in range(6):
            ok = fmops.bwt_extend(fm, ik, is_back=False)
            nz = [i for i in range(4) if ok[i, 2] > 0]
            if not nz:
                break
            ik = ok[int(rng.choice(nz))].copy()
            iks.append(ik.copy())
    iks = np.stack(iks).astype(np.int64)
    for is_back in (False, True):
        got = fm_torch.bwt_extend_batch(dt, _t(iks), is_back)
        _eq(got, fm_jax.bwt_extend_batch(dj, jnp.asarray(iks), is_back))
        _eq(got, np.stack([fmops.bwt_extend(fm, ik, is_back)
                           for ik in iks]))


def test_set_intv_batch(idx):
    fm, dj, dt = idx["fm"], idx["djax"], idx["dt"]
    cs = np.arange(4, dtype=np.int32)
    got = fm_torch.set_intv_batch(dt, _t(cs))
    _eq(got, fm_jax.set_intv_batch(dj, jnp.asarray(cs)))
    _eq(got, np.stack([fmops.set_intv(fm, c) for c in range(4)]))


def test_bwt_b0_and_sa_batch(idx):
    fm, dj, dt = idx["fm"], idx["djax"], idx["dt"]
    rng = np.random.default_rng(14)
    ks = rng.integers(0, fm.seq_len, size=300).astype(np.int64)
    got = fm_torch.bwt_b0_batch(dt, _t(ks))
    _eq(got, fm_jax.bwt_b0_batch(dj, jnp.asarray(ks)))
    _eq(fm_torch._inv_psi_batch(dt, _t(ks)),
        fm_jax._inv_psi_batch(dj, jnp.asarray(ks)))
    ks2 = rng.integers(0, fm.seq_len + 1, size=300).astype(np.int64)
    sa, ovf = fm_torch.sa_batch(dt, _t(ks2), max_iters=4096)
    assert not ovf.any()
    sj, _ = fm_jax.sa_batch(dj, jnp.asarray(ks2), max_iters=4096)
    _eq(sa, sj)
    _eq(sa, [fmops.bwt_sa(fm, int(k)) for k in ks2])


def test_sa_batch_overflow_flags(idx):
    """A 1-step budget on the walk branch: values and overflow flags
    equal the JAX package's; unflagged lanes are exact."""
    fm = idx["fm"]
    dj = fm_jax.DeviceFM.from_host(fm, dense_sa_max=0)
    dt = fm_torch.DeviceFM.from_host(fm, "cpu", dense_sa_max=0)
    ks = np.arange(1, 65, dtype=np.int64) * 17 % fm.seq_len
    sa, ovf = fm_torch.sa_batch(dt, _t(ks), max_iters=1)
    sj, oj = fm_jax.sa_batch(dj, jnp.asarray(ks), max_iters=1)
    _eq(sa, sj)
    _eq(ovf, oj)
    exact = np.array([fmops.bwt_sa(fm, int(k)) for k in ks])
    assert ((sa.numpy() == exact) | ovf.numpy()).all()
    assert ovf.any()


def test_dense_sa_covers_last_row(idx):
    fm, dt = idx["fm"], idx["dt"]
    ks = np.array([0, fm.seq_len // 2, fm.seq_len - 1, fm.seq_len],
                  np.int64)
    vals, ovf = fm_torch.sa_batch(dt, _t(ks))
    assert not ovf.any()
    assert vals.tolist() == [fmops.bwt_sa(fm, int(k)) for k in ks]


@pytest.mark.parametrize("intv", [0, 32])
def test_sa_batch_walk_branch_narrow_and_wide(idx, intv):
    """The LF-walk branch (no dense SA) in both probe dtypes, plain and
    phased (intv > 0 with B >= 64), against the JAX package."""
    fm = idx["fm"]
    dj = fm_jax.DeviceFM.from_host(fm, dense_sa_max=0)
    dt = fm_torch.DeviceFM.from_host(fm, "cpu", dense_sa_max=0)
    assert dt.sa_dense is None
    rng = np.random.default_rng(15)
    ks = rng.integers(0, fm.seq_len + 1, size=200)
    want = np.array([fmops.bwt_sa(fm, int(k)) for k in ks])
    for narrow in (False, True):
        d = dt.narrow() if narrow else dt
        djv = fm_jax._narrow_view(dj) if narrow else dj
        ty = np.int32 if narrow else np.int64
        for budget in (4096, 3):
            sa, ovf = fm_torch.sa_batch(d, _t(ks.astype(ty)), budget, intv)
            sj, oj = fm_jax.sa_batch(djv, jnp.asarray(ks.astype(ty)),
                                     budget, intv)
            _eq(sa, sj)
            _eq(ovf, oj)
        sa, ovf = fm_torch.sa_batch(d, _t(ks.astype(ty)), 4096, intv)
        assert not ovf.any()
        _eq(sa, want)


def test_pac_sym_batch(idx):
    fm, dj, dt = idx["fm"], idx["djax"], idx["dt"]
    rng = np.random.default_rng(16)
    pos = np.concatenate([rng.integers(0, 2 * fm.bns.l_pac, 400),
                          [-3, 0, fm.bns.l_pac - 1, fm.bns.l_pac,
                           2 * fm.bns.l_pac - 1, 2 * fm.bns.l_pac + 5]])
    got = fm_torch.pac_sym_batch(dt, _t(pos.astype(np.int64)))
    _eq(got, fm_jax.pac_sym_batch(dj, jnp.asarray(pos.astype(np.int64))))
    # the narrow view reads the same bases
    _eq(fm_torch.pac_sym_batch(dt.narrow(), _t(pos.astype(np.int32))), got)
