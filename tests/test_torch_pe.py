"""The port's paired-end host code (ops/pe.py, golden.align_pe, the -I
override) against the JAX package on the same simulated read pairs (the
inputs of tests/test_golden_pe.py): insert-size statistics, mate rescue,
pair scoring and the PE SAM, all exactly equal."""

import copy
import dataclasses

import numpy as np
import pytest

from bwa_flow_tpu import cli as jax_cli
from bwa_flow_tpu.index.build import build_index as jax_build_index
from bwa_flow_tpu.index.build import encode_reference
from bwa_flow_tpu.io.sam import Read as JRead
from bwa_flow_tpu.models import golden as jax_golden
from bwa_flow_tpu.ops import pe as jax_pe
from bwa_flow_tpu.ops import region as jax_region
from bwa_flow_tpu.utils.opts import MEM_F_PE
from bwa_flow_tpu.utils.opts import MemOpt as JMemOpt
from bwa_flow_tpu_torch import cli
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.models import golden
from bwa_flow_tpu_torch.ops import pe, region
from bwa_flow_tpu_torch.utils.opts import MemOpt
from conftest import make_genome

N_PAIRS = 40


def _opt(cls):
    opt = cls()
    opt.flag |= MEM_F_PE
    return opt


def _pairs(fwd, rng, n_pairs, isize_mean=300, isize_sd=20, rlen=100,
           snps=2):
    """FR pairs as in tests/test_golden_pe.py, plus a pair whose read2 is
    mutated every 12 bp (no seed survives; mate rescue finds it) and a
    pair whose read2 is random (an orphan)."""
    seqs = []
    for _ in range(n_pairs):
        isize = max(int(rng.normal(isize_mean, isize_sd)), rlen + 10)
        p = int(rng.integers(0, len(fwd) - isize - 1))
        r1 = fwd[p:p + rlen].copy()
        r2 = (3 - fwd[p + isize - rlen:p + isize])[::-1].copy()
        for r in (r1, r2):
            for _ in range(snps):
                q = int(rng.integers(0, rlen))
                r[q] = (r[q] + 1 + rng.integers(0, 3)) % 4
        seqs += [r1, r2]
    p = 12000
    r2 = (3 - fwd[p + 200:p + 300])[::-1].copy()
    r2[5::12] = (r2[5::12] + 1) % 4
    seqs += [fwd[p:p + rlen].copy(), r2]
    seqs += [fwd[20000:20100].copy(),
             rng.integers(0, 4, 100).astype(np.uint8)]
    return [s.astype(np.uint8) for s in seqs]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(777)
    contigs = make_genome(rng, 30000, n_contigs=1)
    _, fwd = encode_reference(contigs)
    seqs = _pairs(fwd, np.random.default_rng(778), N_PAIRS)
    fm, jfm = build_index(contigs), jax_build_index(contigs)
    opt, jopt = _opt(MemOpt), _opt(JMemOpt)
    regs = [golden.mem_align1_core(opt, fm, s) for s in seqs]
    jregs = [jax_golden.mem_align1_core(jopt, jfm, s) for s in seqs]
    return dict(fm=fm, jfm=jfm, opt=opt, jopt=jopt, seqs=seqs, regs=regs,
                jregs=jregs)


def _tup(regs):
    return [dataclasses.astuple(r) for r in regs]


def test_regions_and_pestat_equal_jax(world):
    assert [_tup(r) for r in world["regs"]] == \
        [_tup(r) for r in world["jregs"]]
    pes = pe.mem_pestat(world["opt"], world["fm"].bns.l_pac, world["regs"])
    jpes = jax_pe.mem_pestat(world["jopt"], world["jfm"].bns.l_pac,
                             world["jregs"])
    assert [dataclasses.astuple(p) for p in pes] == \
        [dataclasses.astuple(p) for p in jpes]
    assert pes[1].failed == 0 and 250 < pes[1].avg < 350


def _pes(world, source):
    if source == "estimated":
        return (pe.mem_pestat(world["opt"], world["fm"].bns.l_pac,
                              world["regs"]),
                jax_pe.mem_pestat(world["jopt"], world["jfm"].bns.l_pac,
                                  world["jregs"]))
    pes, jpes = (cli.parse_insert_override("300,30"),
                 jax_cli.parse_insert_override("300,30"))
    assert [dataclasses.astuple(p) for p in pes] == \
        [dataclasses.astuple(p) for p in jpes]
    return pes, jpes


def test_mem_matesw_equals_jax(world):
    pes, jpes = _pes(world, "estimated")
    seqs = world["seqs"]
    rescued = 0
    for k in range(len(seqs) >> 1):
        for i in range(2):
            a, ja = world["regs"][2 * k + i], world["jregs"][2 * k + i]
            ms = seqs[2 * k + 1 - i]
            for j in range(min(2, len(a))):
                n, ma = pe.mem_matesw(
                    world["opt"], world["fm"], pes, a[j], len(ms), ms,
                    copy.deepcopy(world["regs"][2 * k + 1 - i]))
                jn, jma = jax_pe.mem_matesw(
                    world["jopt"], world["jfm"], jpes, ja[j], len(ms), ms,
                    copy.deepcopy(world["jregs"][2 * k + 1 - i]))
                assert (n, _tup(ma)) == (jn, _tup(jma)), (k, i, j)
                rescued += n
    assert rescued > 0


def test_mem_pair_equals_jax(world):
    pes, jpes = _pes(world, "estimated")
    paired = 0
    for k in range(len(world["seqs"]) >> 1):
        a = copy.deepcopy(world["regs"][2 * k:2 * k + 2])
        ja = copy.deepcopy(world["jregs"][2 * k:2 * k + 2])
        n_pri = [region.mem_mark_primary_se(world["opt"], a[i], k << 1 | i)
                 for i in range(2)]
        jn_pri = [jax_region.mem_mark_primary_se(world["jopt"], ja[i],
                                                 k << 1 | i)
                  for i in range(2)]
        assert n_pri == jn_pri
        if not (n_pri[0] and n_pri[1]):
            continue
        got = pe.mem_pair(world["opt"], world["fm"], pes, a, k, n_pri)
        assert got == jax_pe.mem_pair(world["jopt"], world["jfm"], jpes, ja,
                                      k, jn_pri), k
        paired += got[0] > 0
    assert paired >= N_PAIRS - 5


@pytest.mark.parametrize("source", ["estimated", "override"])
def test_mem_sam_pe_equals_jax(world, source):
    pes, jpes = _pes(world, source)
    seqs = world["seqs"]
    for k in range(len(seqs) >> 1):
        s = [Read(name=f"p{k}", seq=seqs[2 * k + i], qual="I" * 100)
             for i in range(2)]
        js = [JRead(name=f"p{k}", seq=seqs[2 * k + i], qual="I" * 100)
              for i in range(2)]
        n = pe.mem_sam_pe(world["opt"], world["fm"], pes, k, s,
                          copy.deepcopy(world["regs"][2 * k:2 * k + 2]))
        jn = jax_pe.mem_sam_pe(world["jopt"], world["jfm"], jpes, k, js,
                               copy.deepcopy(world["jregs"][2 * k:2 * k + 2]))
        assert n == jn
        assert [r.sam for r in s] == [r.sam for r in js], k


def test_golden_align_pe_equals_jax(world):
    """The whole golden PE route, with a read-id offset (pair ids are
    (n_processed >> 1) + i)."""
    seqs = world["seqs"]
    reads = [Read(name=f"p{i >> 1}", seq=s, id=6 + i)
             for i, s in enumerate(seqs)]
    jreads = [JRead(name=f"p{i >> 1}", seq=s, id=6 + i)
              for i, s in enumerate(seqs)]
    golden.align_pe(world["opt"], world["fm"], reads, 6)
    jax_golden.align_pe(world["jopt"], world["jfm"], jreads, 6)
    assert [r.sam for r in reads] == [r.sam for r in jreads]
    assert sum(int(r.sam.split("\t")[1]) & 0x2 > 0 for r in reads) >= \
        2 * (N_PAIRS - 5)
