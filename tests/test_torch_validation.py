"""Result validation, the structural check of wave rows and the hang
watchdog of the port, against tests/test_validation.py: the same
injections on inputs made by numpy from a seed and given to both
packages. Where the JAX package degrades to the host (device_ok =
False, bit-identical SAM), the port raises (DeviceResultError,
TimeoutError, the dispatch's own error); clean runs equal the JAX
package's SAM exactly. The tests that need device waves run --ext-mode
waves with no host drain and no harvester (WAVES)."""

import time

import numpy as np
import pytest
import torch

from bwa_flow_tpu.index.build import build_index as jax_build_index
from bwa_flow_tpu.io.sam import Read as JRead
from bwa_flow_tpu.models import golden as jax_golden
from bwa_flow_tpu.pipeline.batch import BatchAligner as JaxBatchAligner
from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.pipeline import batch as batchmod
from bwa_flow_tpu_torch.pipeline.batch import (BatchAligner,
                                               DeviceResultError)
from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
from bwa_flow_tpu_torch.utils.opts import MEM_F_PE, MemOpt

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
_COMP = np.array([3, 2, 1, 0, 4], np.uint8)
# BatchAligner keywords: device waves for every task that fits
WAVES = dict(ext_mode="waves", drain_max=0, harvest_workers=0)


@pytest.fixture(scope="module")
def fx():
    """Two 3 kbp contigs (one N run each) indexed by both packages, 12
    single-end reads with substitutions on both strands and 8 FR pairs,
    all from one numpy seed; `want` is the JAX golden SAM of the reads."""
    rng = np.random.default_rng(0x7A11D)
    contigs = []
    for i in range(2):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)]
        seq = seq.copy()
        st = int(rng.integers(10, 2980))
        seq[st:st + 5] = ord("N")
        contigs.append((f"ctg{i}", "", seq.tobytes()))
    gen = [CODE[np.frombuffer(s, np.uint8)] for _, _, s in contigs]
    se = []
    for k in range(12):
        g = gen[k % 2]
        p = int(rng.integers(0, len(g) - 101))
        r = g[p:p + 101].copy()
        m = rng.random(101) < 0.03
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        se.append(_COMP[r[::-1]] if k % 3 == 0 else r)
    pe = []
    for k in range(8):
        g = gen[k % 2]
        p = int(rng.integers(0, len(g) - 400))
        r1 = g[p:p + 101].copy()
        r2 = _COMP[g[p + 299:p + 400][::-1]]
        j = int(rng.integers(0, 101))
        r1[j] = (r1[j] + 1) % 4
        pe += [r1, r2]
    jfm = jax_build_index(contigs)
    want = _reads(se, JRead)
    jax_golden.align_se(JaxMemOpt(), jfm, want)
    return dict(fm=build_index(contigs), jfm=jfm, se=se, pe=pe,
                want=[r.sam for r in want])


def _reads(seqs, cls):
    return [cls(name=f"r{i}", seq=s, qual="I" * len(s), id=i)
            for i, s in enumerate(seqs)]


def _corrupt_scores(real, delta):
    """The JAX package's extend_waves whose regions come back with score
    + delta (the wrong-result injection of tests/test_validation.py)."""
    def corrupted(seqs, chains, *a, **k):
        regs = real(seqs, chains, *a, **k)
        for rr in regs:
            for r in rr:
                r.score += delta
        return regs
    return corrupted


def _corrupt_packed(real, delta):
    """The port's extend_waves_packed whose packed regions come back with
    score (column 5) + delta: the same injection."""
    def corrupted(*a, **k):
        rows, frac, off = real(*a, **k)
        rows = rows.copy()
        rows[:, 5] += delta
        return rows, frac, off
    return corrupted


def _run_pipe(fm, reads, batches, **kw):
    pipe = AlignPipeline(MemOpt(), fm, device="cpu",
                         aligner_kw=dict(wave_cap=32), **kw)
    done = []
    try:
        pipe.run([reads[i:i + batches] for i in range(0, len(reads),
                                                       batches)],
                 done.extend)
    finally:
        pipe.close()
    return pipe, done


def test_clean_validation_equals_jax_sam(fx):
    """validate_every=1 on a clean run: the JAX package stays on the
    device and the port's SAM equals its SAM (tests/test_validation.py
    :15); one validation a batch."""
    ja = _reads(fx["se"], JRead)
    jba = JaxBatchAligner(JaxMemOpt(), fx["jfm"], wave_cap=32,
                          validate_every=1, drain_max=0)
    jba.align_se(ja)
    assert jba.device_ok and jba.stats["validations"] == 1
    reads = _reads(fx["se"], Read)
    ba = BatchAligner(MemOpt(), fx["fm"], wave_cap=32, validate_every=1,
                      device="cpu")
    ba.align_se(reads)
    assert [r.sam for r in reads] == [r.sam for r in ja] == fx["want"]
    assert ba.stats["validations"] == 1


def test_clean_pipeline_validation_every_batch(fx):
    """AlignPipeline with validate_every=1 over three batches: three
    validations, the JAX golden SAM (tests/test_validation.py:135)."""
    pipe, done = _run_pipe(fx["fm"], _reads(fx["se"], Read), 4,
                           validate_every=1, validate_sample=4)
    assert [r.sam for r in done] == fx["want"]
    assert pipe.ba.stats["validations"] == 3


@pytest.mark.parametrize("where", ["batch_aligner", "pipeline"])
def test_raising_dispatch_propagates(fx, monkeypatch, where):
    """A seeds_dispatch that raises fails the port's run, where the JAX
    package degrades to the host (tests/test_validation.py:25, :102)."""
    def lost(seqs):
        raise RuntimeError("device lost")
    jba = JaxBatchAligner(JaxMemOpt(), fx["jfm"], wave_cap=32)
    monkeypatch.setattr(jba, "seeds_dispatch", lost)
    ja = _reads(fx["se"], JRead)
    jba.align_se(ja)
    assert not jba.device_ok and [r.sam for r in ja] == fx["want"]
    monkeypatch.setattr(BatchAligner, "seeds_dispatch",
                        lambda self, seqs: lost(seqs))
    with pytest.raises(RuntimeError, match="device lost"):
        if where == "pipeline":
            _run_pipe(fx["fm"], _reads(fx["se"], Read), 6)
        else:
            BatchAligner(MemOpt(), fx["fm"], wave_cap=32,
                         device="cpu").align_se(_reads(fx["se"], Read))


def test_corrupted_regions_raise_naming_read_and_fields(fx, monkeypatch):
    """Corrupted extension results: the JAX package's validator degrades
    (device_ok = False, golden SAM); the port's raises DeviceResultError
    naming the read, each differing field with both values, and the
    batch (tests/test_validation.py:49)."""
    jba = JaxBatchAligner(JaxMemOpt(), fx["jfm"], wave_cap=32,
                          validate_every=1, validate_sample=6,
                          drain_max=0)
    monkeypatch.setattr(jba, "extend_waves",
                        _corrupt_scores(jba.extend_waves, 7))
    ja = _reads(fx["se"], JRead)
    jba.align_se(ja)
    assert not jba.device_ok and [r.sam for r in ja] == fx["want"]
    ba = BatchAligner(MemOpt(), fx["fm"], wave_cap=32, validate_every=1,
                      validate_sample=6, device="cpu")
    monkeypatch.setattr(ba, "extend_waves_packed",
                        _corrupt_packed(ba.extend_waves_packed, 7))
    with pytest.raises(DeviceResultError) as e:
        ba.align_se(_reads(fx["se"], Read))
    msg = str(e.value)
    assert "read 0 (r0) of batch 1" in msg
    want = jax_golden.mem_align1_core(JaxMemOpt(), fx["jfm"], fx["se"][0])
    assert (f"region 0 score: device {want[0].score + 7}, golden "
            f"{want[0].score}") in msg


def test_pipeline_corrupted_regions_raise(fx, monkeypatch):
    """The same injection on the AlignPipeline path (its own sample, on
    the pre-dedup regions; tests/test_validation.py:135): raises before
    any batch is emitted."""
    monkeypatch.setattr(BatchAligner, "extend_waves_packed",
                        _corrupt_packed(BatchAligner.extend_waves_packed, 3))
    emitted = []
    pipe = AlignPipeline(MemOpt(), fx["fm"], device="cpu", validate_every=1,
                         validate_sample=12, aligner_kw=dict(wave_cap=32))
    try:
        with pytest.raises(DeviceResultError, match=r"read 0 \(r0\) of "
                           r"batch 1: .*score: device"):
            pipe.run([_reads(fx["se"], Read)], emitted.extend)
    finally:
        pipe.close()
    assert not emitted and pipe.ba.stats["validations"] == 1


def test_corrupt_wave_row_raises_without_validation(fx, monkeypatch):
    """qle = -3 in every lane of a wave (no kernel can emit it) with the
    default validate_every=0: the structural check raises naming the
    read and the field (tests/test_validation.py:178)."""
    ba = BatchAligner(MemOpt(), fx["fm"], wave_cap=32, device="cpu",
                      **WAVES)
    real = ba.fetch

    def corrupt(t, *a):
        out = real(t, *a)
        if out.ndim == 2 and out.shape[0] == 12:
            out = out.copy()
            out[1, :] = -3
        return out
    monkeypatch.setattr(ba, "fetch", corrupt)
    with pytest.raises(DeviceResultError,
                       match=r"wave row of read \d+ \(r\d+\): lqle = -3"):
        ba.align_se(_reads(fx["se"], Read))


def _row_ok(d, row, max_mat):
    """row_ok of native/_wave.cpp:508-545, line for line, on one lane's
    descriptor and row: the reference of bad_rows."""
    _, qbeg, slen, l_query, rbeg, rmax0, rmax1, h0, _, _, skip = map(int, d)
    ls, lq, lt, lg, _, lmo, rs, rq, rt, rg, _, rmo = map(int, row)
    qlen_l, tlen_l = qbeg, rbeg - rmax0
    qlen_r, tlen_r = l_query - (qbeg + slen), rmax1 - (rbeg + slen)
    if skip:
        h0r = h0
    else:
        if qbeg > 0:
            if lq < 0 or lq > qlen_l or lt < 0 or lt > tlen_l:
                return False
            if lg < 0 or lg > tlen_l:
                return False
            if ls < h0 or ls > h0 + qlen_l * max_mat:
                return False
            if lmo < 0 or lmo > max(qlen_l, tlen_l):
                return False
        elif ls != h0 or lq != 0 or lt != 0:
            return False
        h0r = ls
    if qlen_r != 0:
        if rq < 0 or rq > qlen_r or rt < 0 or rt > tlen_r:
            return False
        if rg < 0 or rg > tlen_r:
            return False
        if rs < h0r or rs > h0r + qlen_r * max_mat:
            return False
        if rmo < 0 or rmo > max(qlen_r, tlen_r):
            return False
    elif rs != h0r or rq != 0 or rt != 0:
        return False
    return True


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_clean_waves_pass_structural_check(fx, monkeypatch, paired):
    """Every wave of a clean run passes the always-on check, SE and PE
    (tests/test_validation.py:214); on those waves, with single values
    pushed just outside and inside their ranges, bad_rows flags exactly
    the lanes the scalar row_ok rejects."""
    waves = []
    real = batchmod.bad_rows

    def keep(desc, rows, max_mat):
        waves.append((desc.copy(), rows.copy()))
        return real(desc, rows, max_mat)
    monkeypatch.setattr(batchmod, "bad_rows", keep)
    opt = MemOpt()
    if paired:
        opt.flag |= MEM_F_PE
    seqs = fx["pe"] if paired else fx["se"]
    ba = BatchAligner(opt, fx["fm"], wave_cap=8, device="cpu", **WAVES)
    reads = _reads(seqs, Read)
    if paired:
        for r in reads:
            r.name = f"p{r.id >> 1}"     # mates share a name
    (ba.align_pe if paired else ba.align_se)(reads)
    assert waves and ba.stats["ext_tasks_device"] > 0
    rng = np.random.default_rng(0xB0B)
    mm = int(opt.mat.max())
    for desc, rows in waves:
        assert real(desc, rows, mm) is None
        assert all(_row_ok(desc[:, j], rows[:, j], mm)
                   for j in range(rows.shape[1]))
        for _ in range(8):
            bad = rows.copy()
            j = int(rng.integers(0, rows.shape[1]))
            f = int(rng.integers(0, 12))
            bad[f, j] += int(rng.choice([-200, -1, 1, 3, 200]))
            got = real(desc, bad, mm)
            ok = [_row_ok(desc[:, i], bad[:, i], mm)
                  for i in range(bad.shape[1])]
            assert (got is None) == all(ok)
            if got is not None:
                assert got[0] == ok.index(False)


def test_stalled_wait_times_out(fx, monkeypatch):
    """A device that never finishes (the ready-check replaced) raises
    TimeoutError within device_timeout + 2 s."""
    ba = BatchAligner(MemOpt(), fx["fm"], wave_cap=32, device="cpu",
                      device_timeout=0.5)
    monkeypatch.setattr(ba, "_ready", lambda device: (lambda: False))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="0.5 s"):
        ba.align_se(_reads(fx["se"], Read))
    assert 0.5 <= time.monotonic() - t0 < 2.5


def test_zero_timeout_never_polls(fx, monkeypatch):
    """device_timeout=0: no ready-check at all, and the plain copies give
    the golden SAM; with the default timeout the CPU is checked and is
    always ready."""
    polls = []

    def ready(device):
        polls.append(device)
        return lambda: True
    for timeout, want_polls in ((0, False), (300.0, True)):
        polls.clear()
        reads = _reads(fx["se"], Read)
        ba = BatchAligner(MemOpt(), fx["fm"], wave_cap=32, device="cpu",
                          device_timeout=timeout)
        monkeypatch.setattr(ba, "_ready", ready)
        ba.align_se(reads)
        assert [r.sam for r in reads] == fx["want"]
        assert bool(polls) == want_polls


def test_wait_ready_polls_until_ready():
    """wait_ready returns once ready() holds, and times out when it never
    does."""
    calls = []

    def ready():
        calls.append(1)
        return len(calls) >= 50
    batchmod.wait_ready(ready, 5.0)
    assert len(calls) == 50
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        batchmod.wait_ready(lambda: False, 0.05)
    assert time.monotonic() - t0 < 1.0
