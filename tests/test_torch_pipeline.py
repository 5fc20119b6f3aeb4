"""The port's batch pipeline on the CPU against the JAX package's
BatchAligner and the golden straight-line aligner: SAM-for-SAM equality
(the SE tests of tests/test_pipeline_batch.py), and the dataflow
AlignPipeline, single-end and paired-end, inline and with a worker
pool. The tests that count device waves run --ext-mode waves with no
host drain and no harvester (WAVES), so that the device waves carry
every task that fits even on these few reads."""

import numpy as np
import pytest
import torch

from bwa_flow_tpu.index.build import build_index
from bwa_flow_tpu.io.sam import Read as JRead
from bwa_flow_tpu.models import golden as jax_golden
from bwa_flow_tpu.pipeline.batch import BatchAligner as JaxBatchAligner
from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.models import golden
from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
from bwa_flow_tpu_torch.utils.opts import MEM_F_PE, MemOpt

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

CODE = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    CODE[_ch] = _i
_COMP = np.array([3, 2, 1, 0, 4], np.int32)
# BatchAligner keywords: device waves for every task that fits
WAVES = dict(ext_mode="waves", drain_max=0, harvest_workers=0)


def _seqs(rng, contigs, n, L=101):
    """SE reads with SNPs, reverse strand, N runs, deletions and
    insertions (the mix of tests/test_pipeline_batch.py)."""
    gen = [np.frombuffer(s, dtype=np.uint8) for _, _, s in contigs]
    out = []
    for _ in range(n):
        seq = gen[int(rng.integers(0, len(gen)))]
        pos = int(rng.integers(0, max(1, len(seq) - L)))
        r = CODE[seq[pos:pos + L]].astype(np.int32).copy()
        kind = rng.random()
        if kind < 0.4:
            m = rng.random(len(r)) < 0.04
            r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        elif kind < 0.55:
            r = _COMP[r[::-1]]
        elif kind < 0.65:
            st = int(rng.integers(0, max(1, len(r) - 8)))
            r[st:st + 5] = 4
        elif kind < 0.75:
            cut = int(rng.integers(1, len(r) - 2))
            r = np.concatenate([r[:cut], r[cut + 3:]])
        elif kind < 0.85:
            cut = int(rng.integers(1, len(r) - 2))
            r = np.concatenate([r[:cut], rng.integers(0, 4, 2),
                                r[cut:]])[:L]
        out.append(r.astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def idx():
    rng = np.random.default_rng(0x91BE)
    contigs = []
    for i in range(2):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)].copy()
        st = int(rng.integers(10, 2980))
        seq[st:st + 5] = ord("N")
        contigs.append((f"ctg{i}", "", seq.tobytes()))
    return build_index(contigs), contigs


def _reads(seqs, cls, prefix="r"):
    return [cls(name=f"{prefix}{i}", seq=s, qual="I" * len(s), id=i)
            for i, s in enumerate(seqs)]


def _jax_sams(fm, seqs, **kw):
    """SAM of the JAX package's BatchAligner and of its golden model."""
    want = _reads(seqs, JRead)
    jax_golden.align_se(JaxMemOpt(), fm, want, n_processed=0)
    ja = _reads(seqs, JRead)
    JaxBatchAligner(JaxMemOpt(), fm, **kw).align_se(ja, n_processed=0)
    return [r.sam for r in want], [r.sam for r in ja]


@pytest.mark.parametrize("case", ["waves", "small_wave_buffer",
                                  "oversized_fallback"])
def test_batch_se_matches_jax_and_golden(idx, case):
    fm, contigs = idx
    n, kw = {"waves": (24, dict(wave_cap=64)),
             "small_wave_buffer": (12, dict(wave_cap=4)),
             "oversized_fallback": (8, dict(wave_cap=8, qmax=16, tmax=32)),
             }[case]
    seqs = _seqs(np.random.default_rng(61 + len(case)), contigs, n)
    gold, jax_sam = _jax_sams(fm, seqs, drain_max=0, **kw)
    reads = _reads(seqs, Read)
    ba = BatchAligner(MemOpt(), fm, device="cpu", **WAVES, **kw)
    ba.align_se(reads, n_processed=0)
    for got, want_g, want_j in zip(reads, gold, jax_sam):
        assert got.sam == want_j, f"{got.name}:\n{got.sam!r}\n{want_j!r}"
        assert got.sam == want_g
    if case == "oversized_fallback":
        assert ba.stats["ext_tasks_host"] > 0
    else:
        assert ba.stats["ext_tasks_device"] > 0


def test_batch_no_dense_sa_probe_path(idx, monkeypatch):
    """No dense SA: SA values come from the LF-walk probe path."""
    monkeypatch.setenv("BWA_TPU_DENSE_SA_MAX", "0")
    fm, contigs = idx
    seqs = _seqs(np.random.default_rng(65), contigs, 12)
    gold = _reads(seqs, Read)
    golden.align_se(MemOpt(), fm, gold, n_processed=0)
    reads = _reads(seqs, Read)
    ba = BatchAligner(MemOpt(), fm, wave_cap=64, device="cpu")
    assert ba.dfm.sa_dense is None
    ba.align_se(reads, n_processed=0)
    assert [r.sam for r in reads] == [r.sam for r in gold]


@pytest.mark.parametrize("n_workers", [0, 2])
def test_align_pipeline_matches_golden(idx, n_workers):
    fm, contigs = idx
    seqs = _seqs(np.random.default_rng(66), contigs, 20)
    want = _reads(seqs, Read)
    golden.align_se(MemOpt(), fm, want, n_processed=0)
    reads = _reads(seqs, Read)
    out = []
    pipe = AlignPipeline(MemOpt(), fm, n_workers=n_workers, device="cpu",
                         aligner_kw=dict(wave_cap=32))
    try:
        n = pipe.run([reads[:7], reads[7:14], reads[14:]], out.extend)
    finally:
        pipe.close()
    assert n == len(reads)
    assert [r.name for r in out] == [r.name for r in want]
    for got, w in zip(out, want):
        assert got.sam == w.sam, got.name
    assert pipe.ba.stats["seed_batches"] == 3


def _pairs(rng, contigs, n, L=101):
    """Interleaved FR pairs (insert ~N(300, 20), a few substitutions),
    plus one pair whose read2 no seed survives (mate rescue)."""
    out = []
    for k in range(n):
        seq = CODE[np.frombuffer(contigs[k % len(contigs)][2], np.uint8)]
        isize = int(rng.normal(300, 20))
        p = int(rng.integers(0, len(seq) - isize - 1))
        r1 = seq[p:p + L].astype(np.int32)
        r2 = _COMP[seq[p + isize - L:p + isize][::-1]]
        if k == n - 1:
            r2[5::12] = (r2[5::12] + 1) % 4
        else:
            for r in (r1, r2):
                m = rng.random(L) < 0.02
                r[m] = (r[m] + 1) % 4
        out += [r1.astype(np.uint8), r2.astype(np.uint8)]
    return out


def test_batch_pe_matches_golden(idx):
    """BatchAligner.align_pe on the CPU equals golden.align_pe."""
    fm, contigs = idx
    seqs = _pairs(np.random.default_rng(68), contigs, 16)
    opt = MemOpt()
    opt.flag |= MEM_F_PE
    want = [Read(name=f"p{i >> 1}", seq=s, id=i) for i, s in enumerate(seqs)]
    golden.align_pe(opt, fm, want, 0)
    reads = [Read(name=f"p{i >> 1}", seq=s, id=i) for i, s in enumerate(seqs)]
    ba = BatchAligner(opt, fm, wave_cap=32, device="cpu", **WAVES)
    ba.align_pe(reads, n_processed=0)
    assert [r.sam for r in reads] == [r.sam for r in want]
    assert ba.stats["ext_tasks_device"] > 0


def test_align_pipeline_refuses_paired(idx):
    """Paired input is not refused: the PE AlignPipeline on the CPU
    (device waves; per-batch insert size; the native tail's dedup,
    rescue and pairing, beside a pool of two workers) equals
    golden.align_pe batch by batch."""
    fm, contigs = idx
    seqs = _pairs(np.random.default_rng(67), contigs, 24)
    opt = MemOpt()
    opt.flag |= MEM_F_PE
    want = [Read(name=f"p{i >> 1}", seq=s, qual="I" * len(s), id=i)
            for i, s in enumerate(seqs)]
    golden.align_pe(opt, fm, want[:24], 0)
    golden.align_pe(opt, fm, want[24:], 24)
    reads = [Read(name=f"p{i >> 1}", seq=s, qual="I" * len(s), id=i)
             for i, s in enumerate(seqs)]
    out = []
    pipe = AlignPipeline(opt, fm, paired=True, n_workers=2,
                         device="cpu", ext_mode="waves",
                         aligner_kw=dict(wave_cap=32, drain_max=0,
                                         harvest_workers=0))
    try:
        n = pipe.run([reads[:24], reads[24:]], out.extend)
    finally:
        pipe.close()
    assert n == len(reads)
    assert [r.name for r in out] == [r.name for r in want]
    for got, w in zip(out, want):
        assert got.sam == w.sam, got.name
    assert sum(int(r.sam.split("\t")[1]) & 0x2 > 0 for r in out) >= 40
    assert pipe.ba.stats["ext_tasks_device"] > 0


def test_align_pipeline_has_one_route(idx):
    """AlignPipeline keeps a `native` keyword only for callers that pass
    True; False, which took the deleted pure-Python route, raises
    ValueError naming the one route, before a pool or an index is
    made."""
    fm, _ = idx
    pure_python = False
    with pytest.raises(ValueError, match="one route, the native route"):
        AlignPipeline(MemOpt(), fm, n_workers=2, device="cpu",
                      native=pure_python)
