"""The port's coupled two-try extension (seed_extend_batch,
SeedExtendTaskBuffer), its mesh module (bwa_flow_tpu_torch/parallel/
mesh.py: sharded seed and align steps over CPU device lists) and its
entry points (bwa_flow_tpu_torch/entry.py) against the JAX package's
chain2aln_jax, parallel/mesh.py over the virtual CPU mesh of conftest,
and __graft_entry__.py. Inputs come from numpy with fixed seeds; every
comparison is exact. Also: the kernel wrapper launches with the tensors'
card current, and its launch counts survive concurrent shard threads."""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
import chip_smoke
from bwa_flow_tpu.ops import chain2aln_jax
from bwa_flow_tpu.parallel import mesh as jmesh
from bwa_flow_tpu_torch import entry
from bwa_flow_tpu_torch.ops import chain2aln_torch, extend_cuda
from bwa_flow_tpu_torch.parallel import mesh

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

QMAX, TMAX = 64, 128
GENOME = np.random.default_rng(0x3E5).integers(0, 4, 20000).astype(np.uint8)


def _tasks(n=64, seed=0x5EB):
    return chip_smoke.make_coupled_tasks(np.random.default_rng(seed),
                                         GENOME, n, QMAX, TMAX)


@pytest.mark.parametrize("scoring", range(3),
                         ids=[s[0] for s in chip_smoke.ext_scorings()])
def test_seed_extend_batch_equals_jax(scoring):
    sname, o, w, zd = chip_smoke.ext_scorings()[scoring]
    a = _tasks()
    mat = np.ascontiguousarray(o.mat[:5, :5], dtype=np.int32)
    sc = (o.o_del, o.e_del, o.o_ins, o.e_ins, w, o.pen_clip5, o.pen_clip3,
          zd)
    got = chain2aln_torch.seed_extend_batch(
        QMAX, TMAX, *(torch.as_tensor(x) for x in a), torch.as_tensor(mat),
        *sc)
    want = chain2aln_jax.seed_extend_batch(
        QMAX, TMAX, *(jnp.asarray(x) for x in a), jnp.asarray(mat),
        *(jnp.asarray(v, jnp.int32) for v in sc))
    assert len(got) == 12
    for k, (g, wv) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), str(k))
    g = [x.numpy() for x in got]
    # lanes without a side report the incoming score and band w
    no_left, no_right = a[1] == 0, a[5] == 0
    assert no_left.any() and no_right.any()
    np.testing.assert_array_equal(g[0][no_left], a[8][no_left])
    assert (g[5][no_left] == w).all()
    np.testing.assert_array_equal(g[6][no_right], g[0][no_right])
    assert (g[11][no_right] == w).all()
    if sname.startswith("narrow band"):
        # the 9-12 base gaps take bwa's 2w retry on each side
        assert (g[5] == 2 * w).any() and (g[11] == 2 * w).any()


def test_seed_extend_task_buffer_equals_jax():
    """add (slots, -1 on an oversized piece and on a full buffer), run
    over every slot, reset and refill: the same as the JAX buffer."""
    from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
    from bwa_flow_tpu_torch.utils.opts import MemOpt
    a = _tasks(24, seed=0x5EC)
    bt = chain2aln_torch.SeedExtendTaskBuffer(16, QMAX, TMAX)
    bj = chain2aln_jax.SeedExtendTaskBuffer(16, QMAX, TMAX)

    def add(i):
        return [buf.add(a[0][i, :a[1][i]], a[2][i, :a[3][i]],
                        a[4][i, :a[5][i]], a[6][i, :a[7][i]], int(a[8][i]))
                for buf in (bt, bj)]
    too_long = np.zeros(QMAX + 1, np.int32)
    assert bt.add(too_long, [], [], [], 5) == \
        bj.add(too_long, [], [], [], 5) == -1
    slots = [add(i) for i in range(18)]
    assert [s[0] for s in slots] == [s[1] for s in slots]
    assert [s[0] for s in slots] == list(range(16)) + [-1, -1]

    def run_both():
        got = bt.run(MemOpt(), device="cpu")
        want = bj.run(JaxMemOpt())
        assert len(got) == len(want) == 12
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.shape == (16,)
            np.testing.assert_array_equal(g, np.asarray(w), str(k))
    run_both()
    bt.reset()
    bj.reset()
    assert bt.n == 0 and (bt.h0 == 1).all()
    assert [add(i) for i in (20, 21, 22)] == [[0, 0], [1, 1], [2, 2]]
    run_both()


L, MAXB, MAXM, ITERS = 64, 16, 32, 256
B_MESH = 8


@pytest.fixture(scope="module")
def mesh_inputs():
    """The dry run's inputs at B=8 from both packages (seed 0xE17), on a
    two-device JAX mesh and two CPU shards."""
    _fm, djax, qj, qlj = graft._build_example(genome_len=2048,
                                              n_reads=B_MESH, read_len=40,
                                              pad_to=L)
    _fm2, dt, q, qlen = entry._build_example("cpu", genome_len=2048,
                                             n_reads=B_MESH, read_len=40,
                                             pad_to=L)
    np.testing.assert_array_equal(q, np.asarray(qj))
    jm = jmesh.make_mesh(2)
    devs = mesh.make_mesh(2, "cpu")
    assert devs == [torch.device("cpu")] * 2
    return dict(q=q, qlen=qlen, jm=jm, djax=jmesh.replicate_fm(djax, jm),
                devs=devs, dfms=mesh.replicate_fm(dt, devs))


def test_sharded_seed_step_equals_jax(mesh_inputs):
    m = mesh_inputs
    want = jmesh.sharded_seed_step(m["jm"], L, MAXB, MAXM, ITERS)(
        m["djax"], *jmesh.shard_reads(m["q"], m["qlen"], m["jm"]))
    qs, qls = mesh.shard_reads(m["q"], m["qlen"], m["devs"])
    assert [x.shape[0] for x in qs] == [B_MESH // 2] * 2
    got = mesh.sharded_seed_step(m["devs"], L, MAXB, MAXM, ITERS)(
        m["dfms"], qs, qls)
    for name, g, w in zip(("mems", "n_mem", "ovf", "hist"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[3].sum()) == B_MESH


def test_sharded_align_step_equals_jax(mesh_inputs):
    m = mesh_inputs
    q = m["q"]
    qr_q = np.zeros((B_MESH, QMAX), np.int32)
    qr_q[:, :24] = q[:, 16:40]
    tr_t = np.zeros((B_MESH, TMAX), np.int32)
    tr_t[:, :24] = q[:, 16:40]
    # a few lanes with a mismatch, so the scores differ between shards
    tr_t[::3, 10] = (tr_t[::3, 10] + 1) % 4
    ext_in = (qr_q, np.full(B_MESH, 24, np.int32), tr_t,
              np.full(B_MESH, 24, np.int32), np.full(B_MESH, 16, np.int32))
    from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
    mat = np.ascontiguousarray(JaxMemOpt().mat[:5, :5], dtype=np.int32)
    jm = m["jm"]
    sb, s1 = NamedSharding(jm, P("dp", None)), NamedSharding(jm, P("dp"))
    put = jax.device_put
    want = jmesh.sharded_align_step(jm, L, MAXB, MAXM, ITERS, QMAX, TMAX)(
        m["djax"], *jmesh.shard_reads(q, m["qlen"], jm),
        *(put(jnp.asarray(x), sb if x.ndim == 2 else s1) for x in ext_in),
        put(jnp.asarray(mat), NamedSharding(jm, P())))
    devs = m["devs"]
    got = mesh.sharded_align_step(devs, L, MAXB, MAXM, ITERS, QMAX, TMAX)(
        m["dfms"], *mesh.shard_reads(q, m["qlen"], devs),
        *(mesh.shard_rows(x, devs) for x in ext_in), torch.as_tensor(mat))
    for name, g, w in zip(("mems", "n_mem", "ext", "hist", "score_sum"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[4]) == int(got[2][:, 0].sum())


def test_shard_rows_refuses_uneven_split():
    with pytest.raises(ValueError, match="evenly"):
        mesh.shard_rows(np.zeros((5, 3)), ["cpu", "cpu"])


def test_entry_equals_graft_entry():
    fn, args = entry.entry("cpu")
    got = fn(*args)
    jfn, jargs = graft.entry()
    want = jfn(*jargs)
    for k in range(5):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      str(k))
    assert len(got[5]) == len(want[5]) == 12
    for k, (g, w) in enumerate(zip(got[5], want[5])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), f"ext {k}")


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip_on_cpu_shards(n):
    out = entry.dryrun_multichip(n, ["cpu"] * n)
    assert sum(out["hist"]) == 2 * n
    assert len(out["shards"]) == n
    assert all(s["ext_tasks_device"] > 0 for s in out["shards"])


def test_launch_runs_with_the_tensors_card_current(monkeypatch):
    """extend_cuda._launch calls the C launcher inside the device guard
    of the tensors' card, with that card's stream (shown without a card:
    the guard and the stream are stand-ins)."""
    seen = {"inside": False, "calls": []}

    class Guard:
        def __init__(self, dev):
            seen["guard_dev"] = dev

        def __enter__(self):
            seen["inside"] = True

        def __exit__(self, *exc):
            seen["inside"] = False

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=4242))

    def fake_launcher(*a):
        seen["calls"].append((seen["inside"], a[-1]))
        return 0
    t = torch.zeros(4, dtype=torch.int32)
    dev = torch.device("cuda", 1)
    extend_cuda._launch(fake_launcher, None, dev, 4, 8, 8, t, t, t, t, t, t,
                        t, 6, 1, 6, 1, 5, 100, t)
    assert seen["guard_dev"] == dev
    assert seen["calls"] == [(True, 4242)]


def test_launch_counts_survive_shard_threads(monkeypatch):
    """The wrappers' launch counts lose no update when many shard
    threads launch at once (the checks and the launch are stand-ins)."""
    monkeypatch.setattr(extend_cuda, "n_launches", 0)
    monkeypatch.setattr(extend_cuda, "n_launches16", 0)
    monkeypatch.setattr(extend_cuda, "_checked",
                        lambda who, qmax, tmax, q, *a: (q.device, 1, None))
    monkeypatch.setattr(extend_cuda, "_fn", lambda name, entry: (None, None))
    monkeypatch.setattr(extend_cuda, "_launch", lambda *a: None)
    t = torch.zeros(1, dtype=torch.int32)
    n_threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            fn = extend_cuda.extend_core_cuda16 if i % 2 else \
                extend_cuda.extend_core_cuda
            for _ in range(per):
                fn(8, 8, t, t, t, t, t, t, 6, 1, 6, 1, 100, 5, 100)
            return threading.get_ident()
        idents = mesh.run_shards(work, n_threads)
    finally:
        sys.setswitchinterval(old)
    assert len(set(idents)) > 1
    assert extend_cuda.n_launches == extend_cuda.n_launches16 == \
        n_threads // 2 * per


def test_run_shards_raises_a_shard_failure_after_all_finish():
    done = []

    def work(i):
        if i == 1:
            raise RuntimeError("shard 1 failed")
        done.append(i)
        return i
    with pytest.raises(RuntimeError, match="shard 1"):
        mesh.run_shards(work, 3)
    assert sorted(done) == [0, 2]
    assert mesh.run_shards(lambda i: i * 10, 1) == [0]
