"""The seed program's loops as kernels (ops/smem_cuda.py, csrc/seed_*.cu)
and the dataflow's early enqueue of the next batch's seed program, on the
CPU.

A seed kernel runs each lane of its machine to the lane's end in one
thread. That gives the plain version's outputs only because every
output of _p1p3_machine and _fwd_scan_machine is lane-wise and a
finished lane is a fixed point: these tests hold the plain versions to
that (a batch split in two, its lanes reversed, the stop condition read
every 1, 8 or 64 steps: the same state, lane for lane, bit for bit), the
backward walk's results to their independence of the worklist's width A
and of the queue order, and the port's cohort emission to the JAX
package's. The wrappers take the plain version for CPU tensors and, for
a CUDA tensor, launch the kernel or raise. The dataflow tests drive
AlignPipeline with a recording BatchAligner: each batch's seed program
is enqueued exactly once, by whichever hook comes first, and an error
inside that enqueue ends the run with that error; a stalled seed fetch
ends the run after one device timeout, and the seed_s stat counts each
dispatch once. Inputs are made with
numpy from a seed (the fixtures of tests/test_torch_smem.py)."""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwa_flow_tpu.ops import fm_jax, smem_jax
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.models import golden
from bwa_flow_tpu_torch.ops import fm_torch, smem_cuda, smem_torch
from bwa_flow_tpu_torch.pipeline import dataflow
from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
from bwa_flow_tpu_torch.utils.opts import MemOpt
from tests.test_torch_pipeline import _reads, _seqs
from tests.test_torch_smem import _contigs, _sample_reads

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

L = 128
# a machine state's flat stores: name -> rows a lane ([NL, K, N] + a
# drop-sentinel slot)
FLAT = {"brk_kls": 3, "brk_meta": 3, "mems": 4}


@pytest.fixture(scope="module")
def idx():
    contigs = _contigs(np.random.default_rng(0x5EE))
    fm = build_index(contigs)
    return dict(contigs=contigs, fm=fm,
                dfm=fm_torch.DeviceFM.from_host(fm, "cpu"))


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x


def _capture(monkeypatch, names):
    """Record copies of the arguments of every call of the named
    smem_torch wrappers (a plain machine fills its state's stores in
    place); returns name -> [args]."""
    log = {n: [] for n in names}
    for n in names:
        real = getattr(smem_torch, n)

        def rec(*a, _real=real, _log=log[n]):
            _log.append(_clone(a))
            return _real(*a)
        monkeypatch.setattr(smem_torch, n, rec)
    return log


@pytest.fixture(scope="module")
def machine_args(idx):
    """The arguments of each machine call of collect_intv_device on 48
    reads, narrow (int32) and wide (int64) coordinates."""
    reads = _sample_reads(np.random.default_rng(0x51), idx["contigs"], 48)
    q, qlen = smem_torch.pad_reads(reads, L)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        log = _capture(mp, ["p1p3_machine", "fwd_scan_machine",
                            "bwd_walk_machine", "cohort_emit"])
        for case, dfm in (("narrow", idx["dfm"].narrow()),
                          ("wide", idx["dfm"])):
            for v in log.values():
                v.clear()
            smem_torch.collect_intv_device(
                dfm, L, 64, 128, L * 16, torch.as_tensor(q),
                torch.as_tensor(qlen), *smem_torch._opt_params(MemOpt()))
            out[case] = {k: list(v) for k, v in log.items()}
    return out


def _lanes(st: dict, idx: torch.Tensor, shape: dict) -> dict:
    """The state of lanes `idx` (in that order): per-lane arrays indexed,
    flat stores viewed [NL, K, N] and indexed, a fresh sentinel slot."""
    out = {}
    for k, v in st.items():
        if k in FLAT:
            rows = v[:-1].view(-1, FLAT[k], shape[k])[idx]
            out[k] = torch.cat([rows.reshape(-1), v[-1:].clone()])
        else:
            out[k] = v[idx].clone()
    return out


def _per_lane(st: dict, shape: dict) -> dict:
    """A machine's output state as per-lane arrays [NL, ...] (flat stores
    without their sentinel slot)."""
    return {k: (v[:-1].view(-1, FLAT[k], shape[k]) if k in FLAT else v)
            for k, v in st.items()}


def _assert_state(got: dict, want: dict, idx=None) -> None:
    for k, w in want.items():
        w = w if idx is None else w[idx]
        assert torch.equal(got[k], w), k


def _p1p3(args, st1, st3, q2, qlen2, read_id, qlen_l):
    (dfm, L_, NB, ITERS, _rid, _ql, _st1, _q2, _qlen2, NP3, msl, mmi,
     _st3, fetch) = args
    s1, (mems3, n3, ovf3) = smem_torch._p1p3_machine(
        dfm, L_, NB, ITERS, read_id, qlen_l, st1, q2, qlen2, NP3, msl, mmi,
        st3, fetch)
    shape = {"brk_kls": NB, "brk_meta": NB}
    return _per_lane(s1, shape), dict(mems=mems3, n_mem=n3, ovf=ovf3)


@pytest.mark.parametrize("case", ["narrow", "wide"])
@pytest.mark.parametrize("variant", ["split", "reversed", "check_1",
                                     "check_8", "check_64"])
def test_p1p3_machine_is_lane_wise(machine_args, monkeypatch, case,
                                   variant):
    """_p1p3_machine's every output, lane by lane: on the whole batch, on
    its two halves, on its lanes reversed, and with the stop condition
    read every 1, 8 or 64 steps."""
    args = machine_args[case]["p1p3_machine"][0]
    st1, q2, qlen2, st3 = args[6], args[7], args[8], args[12]
    NB, NP3 = args[2], args[9]
    B = q2.shape[0]
    want1, want3 = _p1p3(args, _clone(st1), _clone(st3), q2, qlen2,
                         args[4], args[5])
    s1shape = {"brk_kls": NB, "brk_meta": NB}
    s3shape = {"mems": NP3}
    if variant.startswith("check"):
        monkeypatch.setattr(smem_torch, "CHECK_EVERY",
                            int(variant.split("_")[1]))
        got1, got3 = _p1p3(args, _clone(st1), _clone(st3), q2, qlen2,
                           args[4], args[5])
        _assert_state(got1, want1)
        _assert_state(got3, want3)
        return
    parts = ([torch.arange(0, B // 2), torch.arange(B // 2, B)]
             if variant == "split" else [torch.arange(B - 1, -1, -1)])
    for lanes in parts:
        # the lanes' reads, in lane order; read ids into that sub-batch
        got1, got3 = _p1p3(
            args, _lanes(st1, lanes, s1shape), _lanes(st3, lanes, s3shape),
            q2[lanes], qlen2[lanes], torch.arange(len(lanes),
                                                  dtype=torch.int32),
            args[5][lanes])
        _assert_state(got1, want1, lanes)
        _assert_state(got3, want3, lanes)


@pytest.mark.parametrize("case", ["narrow", "wide"])
@pytest.mark.parametrize("variant", ["split", "reversed", "check_1",
                                     "check_8", "check_64"])
def test_fwd_scan_machine_is_lane_wise(machine_args, monkeypatch, case,
                                       variant):
    """_fwd_scan_machine (pass 2's task lanes), the same variants."""
    args = machine_args[case]["fwd_scan_machine"][0]
    dfm, L_, NB, ITERS, q_flat, read_id, qlen_l, mi, st0, fetch = args
    NL = st0["mode"].shape[0]
    shape = {"brk_kls": NB, "brk_meta": NB}

    def run(lanes, st):
        out = smem_torch._fwd_scan_machine(dfm, L_, NB, ITERS, q_flat,
                                           read_id[lanes], qlen_l[lanes],
                                           mi[lanes], st, fetch)
        return _per_lane(out, shape)
    every = torch.arange(NL)
    want = run(every, _clone(st0))
    assert int((want["nb"] > 0).sum()) > 0
    if variant.startswith("check"):
        monkeypatch.setattr(smem_torch, "CHECK_EVERY",
                            int(variant.split("_")[1]))
        _assert_state(run(every, _clone(st0)), want)
        return
    parts = ([every[:NL // 3], every[NL // 3:]] if variant == "split"
             else [every.flip(0)])
    for lanes in parts:
        _assert_state(run(lanes, _lanes(st0, lanes, shape)), want, lanes)


@pytest.mark.parametrize("case", ["narrow", "wide"])
@pytest.mark.parametrize("call", [0, 1], ids=["pass1", "pass2"])
def test_bwd_walk_independent_of_width_and_order(machine_args, monkeypatch,
                                                 case, call):
    """_bwd_walk_machine's r and bst at worklist widths 7, 64 and the
    default, and with the live queue entries in another order (outputs
    permuted alike): the same for every entry; entries past the live
    prefix keep r = i_b0, bst = bst0."""
    args = machine_args[case]["bwd_walk_machine"][call]
    dfm, L_, q_flat, rid, bst0, i_b0, mi, alive0, CS, fetch = args
    total = int(alive0.sum())
    assert total > 0 and bool(alive0[:total].all())
    r0, b0 = smem_torch._bwd_walk_machine(*args)
    for A in (7, 64):
        monkeypatch.setattr(smem_torch, "_bwd_lanes", lambda CS, M, A=A: A)
        r, b = smem_torch._bwd_walk_machine(*args)
        assert torch.equal(r, r0) and torch.equal(b, b0), A
    monkeypatch.undo()
    perm = torch.cat([torch.as_tensor(np.random.default_rng(0xB0D + call)
                                      .permutation(total)),
                      torch.arange(total, rid.shape[0])])
    r, b = smem_torch._bwd_walk_machine(dfm, L_, q_flat, rid[perm],
                                        bst0[perm], i_b0[perm], mi[perm],
                                        alive0, CS, fetch)
    assert torch.equal(r, r0[perm]) and torch.equal(b, b0[perm])
    assert torch.equal(r0[total:], i_b0[total:])
    assert torch.equal(b0[total:], bst0[total:])
    assert bool((r0[:total] < i_b0[:total]).any())


@pytest.mark.parametrize("NL,NB", [(48, 64), (7, 128), (1, 1)])
def test_cohort_emit_equals_jax(NL, NB):
    """The port's _cohort_emit against smem_jax._cohort_emit: random death
    steps, group runs and valid prefixes, and the machines' own calls."""
    rng = np.random.default_rng(NL * 1000 + NB)
    r = rng.integers(-1, 200, (NL, NB)).astype(np.int32)
    g = np.sort(rng.integers(0, 6, (NL, NB)), axis=1).astype(np.int32)
    valid = np.arange(NB)[None, :] < rng.integers(0, NB + 1, NL)[:, None]
    valid &= rng.random((NL, NB)) < 0.9
    got = smem_torch._cohort_emit(torch.as_tensor(r), torch.as_tensor(g),
                                  torch.as_tensor(valid), NB)
    want = smem_jax._cohort_emit(jnp.asarray(r), jnp.asarray(g),
                                 jnp.asarray(valid), NB)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cohort_emit_equals_jax_on_machine_calls(machine_args):
    for case in ("narrow", "wide"):
        for r, g, valid, NB in machine_args[case]["cohort_emit"]:
            got = smem_torch._cohort_emit(r, g, valid, NB)
            want = smem_jax._cohort_emit(jnp.asarray(r.numpy()),
                                         jnp.asarray(g.numpy()),
                                         jnp.asarray(valid.numpy()), NB)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["narrow", "wide"])
def test_collect_intv_device_long_reads_equal_jax(idx, case):
    """Reads longer than seed_p1p3's int16 symbol stage holds (620 bp with
    SNPs, N runs, deletions, unmappable ones) at smem_L = 640: the port's
    seed program (its plain machines on the CPU) and the JAX package's
    give the same outputs, bit for bit; nothing refuses the length."""
    L_ = 640
    assert L_ > smem_cuda.P1P3_MAX_L
    reads = _sample_reads(np.random.default_rng(0x10E6), idx["contigs"], 6,
                          L=620)
    q, qlen = smem_jax.pad_reads(reads, L_)
    opt = MemOpt()
    dj = fm_jax.DeviceFM.from_host(idx["fm"])
    dt = idx["dfm"]
    if case == "narrow":
        dj, dt = fm_jax._narrow_view(dj), dt.narrow()
    oj = smem_jax.collect_intv_device(dj, L_, 64, 128, L_ * 16,
                                      jnp.asarray(q), jnp.asarray(qlen),
                                      *smem_jax._opt_params(opt))
    ot = smem_torch.collect_intv_device(dt, L_, 64, 128, L_ * 16,
                                        torch.as_tensor(q),
                                        torch.as_tensor(qlen),
                                        *smem_torch._opt_params(opt))
    assert len(oj) == len(ot)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(ot[1].sum()) > 0


@pytest.mark.parametrize("wrapper,plain", [
    ("p1p3_machine", "_p1p3_machine"),
    ("fwd_scan_machine", "_fwd_scan_machine"),
    ("bwd_walk_machine", "_bwd_walk_machine"),
    ("cohort_emit", "_cohort_emit")])
def test_wrapper_takes_the_plain_version_on_the_cpu(machine_args,
                                                    monkeypatch, wrapper,
                                                    plain):
    """On CPU tensors each wrapper returns its plain version's result
    and launches nothing."""
    args = machine_args["narrow"][wrapper][0]
    calls = []
    real = getattr(smem_torch, plain)
    monkeypatch.setattr(smem_torch, plain,
                        lambda *a: calls.append(1) or real(*a))
    before = dict(smem_cuda.n_launches)
    got = getattr(smem_torch, wrapper)(*_clone(args))
    want = real(*_clone(args))
    flat = (lambda o: [t for x in o for t in flat(x)]
            if isinstance(o, (tuple, list)) else
            [o[k] for k in sorted(o)] if isinstance(o, dict) else [o])
    assert calls == [1]
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    assert smem_cuda.n_launches == before


@pytest.mark.parametrize("wrapper", ["p1p3_machine", "fwd_scan_machine",
                                     "bwd_walk_machine", "cohort_emit"])
def test_wrapper_on_the_card_launches_or_raises(machine_args, monkeypatch,
                                                wrapper):
    """A CUDA tensor takes the kernel and never the plain version: here,
    with no nvcc, loading the kernel raises (no fallback); a tensor on
    another device than cuda or cpu raises; the launchers refuse CPU
    tensors."""
    args = machine_args["narrow"][wrapper][0]
    name = {"p1p3_machine": "_p1p3_machine",
            "fwd_scan_machine": "_fwd_scan_machine",
            "bwd_walk_machine": "_bwd_walk_machine",
            "cohort_emit": "_cohort_emit"}[wrapper]
    monkeypatch.setattr(smem_torch, name,
                        lambda *a: pytest.fail("plain version ran"))
    with pytest.raises(ValueError, match="tensors must be on a CUDA"):
        # the launchers check the device themselves
        monkeypatch.setattr(smem_torch, "_on_card", lambda t, who: True)
        getattr(smem_torch, wrapper)(*_clone(args))
    monkeypatch.setattr(smem_cuda, "_device", lambda who, t: t.device)
    monkeypatch.setattr(smem_cuda._build, "nvcc", lambda: (_ for _ in ())
                        .throw(RuntimeError("nvcc not found")))
    monkeypatch.setattr(smem_cuda, "_FNS", {})
    before = dict(smem_cuda.n_launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(smem_torch, wrapper)(*_clone(args))
    assert smem_cuda.n_launches == before
    monkeypatch.undo()
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        smem_torch._on_card(meta, wrapper)


@pytest.mark.parametrize("B", [4096, 2048, 512, 300, 64, 1])
def test_p1p3_geometry_fills_the_card_and_covers_every_lane(B):
    """seed_p1p3 runs four threads a lane over 2B lanes: its blocks cover
    every lane, and give each of an H100's 132 SMs a block whenever
    there are lanes enough for one warp a SM (the main path's B = 4096:
    256 blocks of 128 threads; a redo's B = 512: 128 blocks of 32). It
    stages the symbol table in shared memory up to L = 511 and takes
    the unstaged variant above."""
    sms = 132
    lanes = 2 * B
    threads, blocks, stage = smem_cuda.p1p3_geometry(lanes, sms, 160)
    assert threads in (32, 64, 128) and stage
    assert blocks * threads // 4 >= lanes > (blocks - 1) * threads // 4
    if lanes >= 8 * sms:
        assert blocks >= sms
    if B == 4096:
        assert (threads, blocks) == (128, 256)
    for L, want in ((1, True), (511, True), (512, False), (720, False),
                    (5000, False)):
        assert smem_cuda.p1p3_geometry(lanes, sms, L) == (threads, blocks,
                                                          want)


def test_p1p3_wrapper_checks_L_and_passes_the_geometry(machine_args,
                                                       monkeypatch):
    """With the CUDA calls stubbed out: the launcher takes any L >= 1,
    passes p1p3_geometry's block size and stage flag to the kernel's
    launcher (staged at the machines' L, unstaged for L = 512 and 1000,
    reads padded to that L), and refuses L = 0 before it launches
    anything."""
    args = machine_args["narrow"]["p1p3_machine"][0]
    (dfm, L, NB, ITERS, read_id, qlen_l, st1, q2, qlen2, NP3, msl, mmi,
     st3, _) = _clone(args)
    monkeypatch.setattr(smem_cuda, "_device", lambda who, t: t.device)
    monkeypatch.setattr(smem_cuda, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(smem_cuda, "_fn", lambda name: None)
    calls = []
    monkeypatch.setattr(smem_cuda, "_launch",
                        lambda name, dev, *a: calls.append((name, a)))
    I32 = torch.int32
    fixed = (read_id.to(I32), qlen_l.to(I32), qlen2.to(I32))
    B = st1["mode"].shape[0]
    with pytest.raises(ValueError, match="L = 0"):
        smem_cuda.p1p3(dfm, 0, NB, ITERS, NP3, msl, mmi,
                       torch.zeros(0, dtype=I32), *fixed, st1, st3)
    assert calls == []
    for L_ in (L, 512, 1000):
        q_l = torch.nn.functional.pad(q2, (0, L_ - q2.shape[1]), value=4)
        sym = smem_torch._sym_tab(q_l, qlen2, L_)
        smem_cuda.p1p3(dfm, L_, NB, ITERS, NP3, msl, mmi, sym, *fixed, st1,
                       st3)
        name, a = calls.pop()
        threads, _, stage = smem_cuda.p1p3_geometry(2 * B, 132, L_)
        assert name == "seed_p1p3"
        assert a[1:5] == (threads, int(stage), B, L_)
        assert a[2] == int(L_ <= smem_cuda.P1P3_MAX_L)


@pytest.mark.parametrize("lanes", [8192, 16384, 4096, 1000, 96, 7, 1])
def test_fwd_geometry_covers_every_lane_and_spreads_the_prefix(lanes):
    """seed_fwd runs four threads a lane and deals the lanes to its blocks
    in turn (csrc/seed_fwd.cu: lane = local lane x gridDim.x + blockIdx.x):
    with fwd_geometry's blocks every lane is run by exactly one quad, and
    the pool's dense prefix of k live lanes lands on min(k, blocks)
    distinct blocks, so every SM gets live lanes once k >= blocks >= 132
    (the main path's 8192 lanes: 256 blocks of 128 threads)."""
    sms = 132
    threads, blocks = smem_cuda.fwd_geometry(lanes, sms)
    assert smem_cuda.p1p3_geometry(lanes, sms, 160) == (threads, blocks,
                                                        True)
    if lanes == 8192:
        assert (threads, blocks) == (128, 256)
    per = threads // 4
    block = np.repeat(np.arange(blocks), per)
    local = np.tile(np.arange(per), blocks)
    lane = local * blocks + block
    run = lane < lanes
    assert np.array_equal(np.sort(lane[run]), np.arange(lanes))
    assert run.sum() == lanes
    for k in sorted({1, 2, lanes // 3, lanes // 2, blocks, lanes}):
        if 0 < k <= lanes:
            assert len(set(block[run & (lane < k)])) == min(k, blocks), k
    if lanes >= 8 * sms:
        assert blocks >= sms


# ---------------------------------------------------------------- dataflow

@pytest.fixture(scope="module")
def pipe_fx():
    rng = np.random.default_rng(0x91BE)
    contigs = []
    for i in range(2):
        seq = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, 3000)].copy()
        contigs.append((f"ctg{i}", "", seq.tobytes()))
    fm = build_index(contigs)
    seqs = _seqs(np.random.default_rng(0xE0), contigs, 20)
    want = _reads(seqs, Read)
    golden.align_se(MemOpt(), fm, want, n_processed=0)
    return dict(fm=fm, seqs=seqs, want=[r.sam for r in want])


class RecordingAligner(BatchAligner):
    """A BatchAligner that records each seeds_dispatch (the batch it
    seeds, the thread), lets through only the hooks named in `allow`
    (calling each twice: a hook acts once), and raises `fail` at the
    dispatch numbered `fail_at`."""
    allow = ("post_redo", "post_dispatch")
    fail_at = None
    fail = None
    last = None

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.log = []
        RecordingAligner.last = self

    def seeds_dispatch(self, seqs):
        import threading
        self.log.append((bytes(seqs[0]), threading.current_thread().name))
        if len(self.log) == self.fail_at:
            raise self.fail
        return super().seeds_dispatch(seqs)

    @staticmethod
    def _twice(cb):
        def both():
            cb()
            cb()
        return both

    def seeds_collect(self, h):
        cb = h.pop("_post_redo_dispatch", None)
        if cb is not None and "post_redo" in self.allow:
            h["_post_redo_dispatch"] = self._twice(cb)
        return super().seeds_collect(h)

    def resolve_sa_flat(self, all_intvs, seed_handle=None,
                        post_dispatch=None):
        if post_dispatch is not None and "post_dispatch" in self.allow:
            return super().resolve_sa_flat(all_intvs, seed_handle,
                                           self._twice(post_dispatch))
        return super().resolve_sa_flat(all_intvs, seed_handle)


def _run(fx, monkeypatch, ext_mode=None, per=5, devices=None,
         device_timeout=300.0, **attrs):
    cls = type("Aligner", (RecordingAligner,), attrs)
    monkeypatch.setattr(dataflow, "BatchAligner", cls)
    reads = _reads(fx["seqs"], Read)
    batches = [reads[i:i + per] for i in range(0, len(reads), per)]
    out = []
    pipe = dataflow.AlignPipeline(MemOpt(), fx["fm"], device="cpu",
                                  devices=devices, ext_mode=ext_mode,
                                  device_timeout=device_timeout,
                                  aligner_kw=dict(wave_cap=32))
    try:
        pipe.run(batches, out.extend)
    finally:
        pipe.close()
    return pipe.ba, batches, out


HOOKS = ("post_redo", "post_dispatch", "late")


@pytest.mark.parametrize("ext_mode", ["host", "waves"])
@pytest.mark.parametrize("hook", ["post_redo", "post_dispatch", "late"])
def test_next_batch_enqueued_once_by_the_first_hook(pipe_fx, monkeypatch,
                                                    ext_mode, hook):
    """Each batch's seed program is dispatched once and in order. The
    dense-SA path enqueues the next one from the seed collect's hook,
    the probe path (no dense SA) from the SA probes' hook; with those
    held back, the pipeline's own call after the collect and SA (the
    JAX package's `finally`), before the extension starts. The SAM
    equals the golden model's."""
    if hook == "post_dispatch":
        monkeypatch.setenv("BWA_TPU_DENSE_SA_MAX", "0")
    allow = {"post_redo": ("post_redo",),
             "post_dispatch": ("post_dispatch",), "late": ()}[hook]
    ba, batches, out = _run(pipe_fx, monkeypatch, ext_mode, allow=allow)
    assert (ba.dfm.sa_dense is None) == (hook == "post_dispatch")
    assert [s for s, _ in ba.log] == [bytes(b[0].seq) for b in batches]
    assert all(t == "MainThread" for _, t in ba.log)
    n = len(batches) - 1
    assert {h: ba.stats[f"enqueue_{h}"] for h in HOOKS} == {
        h: (n if h == hook else 0) for h in HOOKS}
    assert ba.stats["seed_downgrades"] == 0
    assert [r.sam for r in out] == pipe_fx["want"]


def test_next_batch_enqueued_from_a_shard_thread(pipe_fx, monkeypatch):
    """With two shards the seed collect runs in a thread a shard; the
    hook fires once, from the shard that queues its last dependent work
    last, and the SAM is unchanged."""
    ba, batches, out = _run(pipe_fx, monkeypatch,
                            devices=["cpu", "cpu"])
    assert [s for s, _ in ba.log] == [bytes(b[0].seq) for b in batches]
    assert all(t.startswith("shard") for _, t in ba.log[1:])
    assert ba.stats["enqueue_post_redo"] == len(batches) - 1
    assert [r.sam for r in out] == pipe_fx["want"]


@pytest.mark.parametrize("where", ["main", "shard"])
def test_failed_enqueue_ends_the_run(pipe_fx, monkeypatch, where):
    """The third batch's dispatch raises inside the seed collect's hook,
    on the main thread (one device) or in a shard's thread (two shards):
    the error is kept, and AlignPipeline.run ends with it at the third
    batch's seeds collect, before any later batch is dispatched."""
    err = RuntimeError("device lost at dispatch 3")
    collects = []
    real = RecordingAligner.seeds_collect

    def counted(self, h):
        collects.append(1)
        return real(self, h)
    monkeypatch.setattr(RecordingAligner, "seeds_collect", counted)
    with pytest.raises(RuntimeError, match="device lost at dispatch 3"):
        _run(pipe_fx, monkeypatch, fail_at=3, fail=err,
             devices=["cpu", "cpu"] if where == "shard" else None)
    ba = RecordingAligner.last
    assert len(collects) == 2 and len(ba.log) == 3
    assert ba.log[2][1].startswith("shard" if where == "shard"
                                   else "MainThread")


def test_adaptive_downgrade_enqueues_late(pipe_fx, monkeypatch):
    """Seed spans over 3x the best twice in a row switch the early hooks
    off for the following batches: those are enqueued after the
    fetches, and counted."""
    spans = iter([1.0, 5.0, 5.0, 5.0, 5.0])
    monkeypatch.setattr(dataflow.AlignPipeline, "_seed_span",
                        lambda self, dt, _real=dataflow.AlignPipeline.
                        _seed_span: _real(self, next(spans)))
    ba, batches, out = _run(pipe_fx, monkeypatch, per=4)
    # batches 4 and 5 start with two slow spans behind them; batch 5 is
    # the one enqueued late (by batch 4's pipeline call)
    assert len(batches) == 5
    assert ba.stats["seed_downgrades"] == 2
    assert ba.stats["enqueue_late"] == 1
    assert ba.stats["enqueue_post_redo"] == 3
    assert [r.sam for r in out] == pipe_fx["want"]


def test_stalled_seed_fetch_exits_within_one_timeout(pipe_fx, monkeypatch):
    """The device stops finishing as the second batch's seeds collect
    starts: its fetch times out once, and the run ends with that
    TimeoutError about one device_timeout after the stall. No enqueue of
    the third batch waits out a second timeout behind the hung work (the
    pipeline does not dispatch after a failed collect, and a dispatch's
    upload does not wait for the device)."""
    timeout = 1.5
    real = RecordingAligner.seeds_collect
    stalled = []

    def stall(self, h):
        if len(self.log) == 2 and not stalled:
            self._ready = lambda device: (lambda: False)
            stalled.append(time.monotonic())
        return real(self, h)
    monkeypatch.setattr(RecordingAligner, "seeds_collect", stall)
    with pytest.raises(TimeoutError):
        _run(pipe_fx, monkeypatch, device_timeout=timeout)
    dt = time.monotonic() - stalled[0]
    assert timeout <= dt < timeout + 1.0, dt
    assert len(RecordingAligner.last.log) == 2


def test_seed_s_counts_each_dispatch_once(pipe_fx, monkeypatch):
    """seed_s sums each seeds_dispatch and each seeds_collect once: the
    next batch's dispatch, run inside a collect by its hook, is counted
    by the dispatch and not again by the collect."""
    import threading
    D = 0.3
    real = smem_torch.seed_dispatch

    def slow(*a, **k):
        time.sleep(D)
        return real(*a, **k)
    monkeypatch.setattr(smem_torch, "seed_dispatch", slow)
    walls = dict(dispatch=0.0, collect=0.0, nested=0.0)
    in_collect = threading.Event()

    def timed(name, fn):
        def run(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                dt = time.perf_counter() - t0
                walls[name] += dt
                if name == "dispatch" and in_collect.is_set():
                    walls["nested"] += dt
        return run
    collect = timed("collect", RecordingAligner.seeds_collect)

    def flagged(self, h):
        in_collect.set()
        try:
            return collect(self, h)
        finally:
            in_collect.clear()
    monkeypatch.setattr(RecordingAligner, "seeds_dispatch",
                        timed("dispatch", RecordingAligner.seeds_dispatch))
    monkeypatch.setattr(RecordingAligner, "seeds_collect", flagged)
    ba, batches, out = _run(pipe_fx, monkeypatch, per=7)
    assert len(batches) == 3 and ba.stats["enqueue_post_redo"] == 2
    assert walls["nested"] >= 2 * D
    seed_s = ba.stats["seed_s"]
    assert 3 * D <= seed_s
    assert seed_s <= walls["dispatch"] + walls["collect"] - walls["nested"] \
        + 0.1, (seed_s, walls)
    assert [r.sam for r in out] == pipe_fx["want"]
