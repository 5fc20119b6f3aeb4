"""The port's native route (csrc/host: _chain, _wave, _region; the
ops/*_native.py wrappers; BatchAligner/AlignPipeline) on the CPU against
the JAX package's pure-Python route, which it takes here since its
extensions are not built. Inputs are made with numpy from a seed and
handed to both packages; every comparison is exact: chains, regions
(extend_waves_packed for both extension modes, with and without
harvester threads, on one device and on two shards), the native SE and
PE tails, the Python tails in the pool (-V and reads without
qualities), and the failures that must raise (a failed host build, a
corrupted wave row, a hung device in the extension worker, a validated
mismatch)."""

import copy
import gc
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bwa_flow_tpu.cli import parse_insert_override as jax_insert_override
from bwa_flow_tpu.index.build import build_index as jax_build_index
from bwa_flow_tpu.io.sam import Read as JRead
from bwa_flow_tpu.io.sam import mem_reg2sam as jax_reg2sam
from bwa_flow_tpu.models import golden as jax_golden
from bwa_flow_tpu.ops import chain as jax_chain
from bwa_flow_tpu.ops import region as jax_region
from bwa_flow_tpu.ops import smem as jax_smem
from bwa_flow_tpu.pipeline.batch import BatchAligner as JaxBatchAligner
from bwa_flow_tpu.pipeline.dataflow import AlignPipeline as JaxPipeline
from bwa_flow_tpu.utils.opts import (MEM_F_ALL, MEM_F_PE, MEM_F_PRIMARY5,
                                     MEM_F_REF_HDR)
from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
from bwa_flow_tpu_torch import _build
from bwa_flow_tpu_torch.cli import parse_insert_override
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.ops import chain_native, region_native, wave_native
from bwa_flow_tpu_torch.pipeline import batch as batchmod
from bwa_flow_tpu_torch.pipeline import dataflow
from bwa_flow_tpu_torch.pipeline.batch import BatchAligner, DeviceResultError
from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
from bwa_flow_tpu_torch.utils.opts import MemOpt
from tests.test_torch_pipeline import _pairs, _seqs

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i


def _sig(regs):
    """The fields tests/test_native_wave.py compares."""
    return [(p.rb, p.re, p.qb, p.qe, p.rid, p.score, p.truesc, p.w,
             p.seedcov, p.seedlen0, round(p.frac_rep, 9)) for p in regs]


def _chains_sig(chains):
    return [(c.rid, round(c.frac_rep, 9),
             [(s.rbeg, s.qbeg, s.len, s.score) for s in c.seeds])
            for c in chains]


@pytest.fixture(scope="module")
def fx():
    """Two contigs (planted repeats and an N run in the first) indexed by
    both packages; 24 single-end reads of the pipeline tests' mix plus
    one 1100 bp read, which the seed-SW filter applies to."""
    rng = np.random.default_rng(0x4A71)
    bases = np.frombuffer(b"ACGT", np.uint8)
    g1 = bases[rng.integers(0, 4, 5000)].copy()
    for dst in (2500, 3700):
        g1[dst:dst + 300] = g1[600:900]
    g1[4200:4206] = ord("N")
    g2 = bases[rng.integers(0, 4, 3000)].copy()
    contigs = [("c1", "", g1.tobytes()), ("c2", "", g2.tobytes())]
    seqs = _seqs(np.random.default_rng(0x4A72), contigs, 24)
    seqs.append(CODE[g2[100:1200]].copy())
    return dict(fm=build_index(contigs), jfm=jax_build_index(contigs),
                contigs=contigs, seqs=seqs)


def _jax_front(fx, **kw):
    """The JAX package's BatchAligner after seeding and SA resolution:
    (aligner, intvs, sa_flat)."""
    ba = JaxBatchAligner(JaxMemOpt(), fx["jfm"], **kw)
    h = ba.seeds_dispatch(fx["seqs"])
    intvs = ba.seeds_collect(h)
    return ba, intvs, ba.resolve_sa_flat(intvs, h)


@pytest.fixture(scope="module")
def jax_ref(fx):
    """The JAX package's chains (its BatchAligner's chain_reads) and
    pre-dedup regions (its mem_chain2aln over each chain) of fx's
    reads."""
    ba, intvs, sa_flat = _jax_front(fx, wave_cap=32, drain_max=0)
    chains = ba.chain_reads(fx["seqs"], intvs, sa_flat)
    regs = []
    for seq, cs in zip(fx["seqs"], chains):
        regs.append([])
        for c in cs:
            jax_region.mem_chain2aln(ba.opt, fx["jfm"], len(seq), seq, c,
                                     regs[-1])
    return dict(chains=chains, regs=regs)


def _port(fx, **kw):
    ba = BatchAligner(MemOpt(), fx["fm"], device="cpu", **kw)
    h = ba.seeds_dispatch(fx["seqs"])
    intvs = ba.seeds_collect(h)
    return ba, intvs, ba.resolve_sa_flat(intvs, h)


def test_host_libraries_build_from_the_port_and_load_alone():
    """The three host libraries import from build/host/ as modules of
    bwa_flow_tpu_torch, built from csrc/host/, with no bwa_flow_tpu
    module loaded."""
    code = (
        "import sys\n"
        "from bwa_flow_tpu_torch import _build\n"
        "from bwa_flow_tpu_torch.ops import chain_native, region_native, "
        "wave_native\n"
        "mods = [m.ext() for m in (chain_native, region_native, "
        "wave_native)]\n"
        "for m, name in zip(mods, _build.HOST_LIBS):\n"
        "    assert m.__name__ == 'bwa_flow_tpu_torch.' + name, m\n"
        "    assert m.__file__.startswith(str(_build.HOST_BUILD_DIR)), "
        "m.__file__\n"
        "    assert m.__file__ == str(_build.host_lib_path(name))\n"
        "    assert sys.modules[m.__name__] is m\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'bwa_flow_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", \
        r.stdout + r.stderr[-3000:]
    assert _build.HOST_BUILD_DIR == ROOT / "build" / "host"
    for name in _build.HOST_LIBS:
        assert (_build.HOST_SRC / f"{name}.cpp").is_file()


@pytest.mark.parametrize("fault", ["compile_error", "no_compiler",
                                   "no_python_h"])
def test_failed_host_build_raises(tmp_path, monkeypatch, fault):
    """A failed build raises with the compiler's output; a missing c++ or
    Python.h raises too. Nothing falls back to Python."""
    src = tmp_path / "src"
    src.mkdir()
    for name in _build.HOST_LIBS:
        (src / f"{name}.cpp").write_text("#include <Python.h>\nint broken(\n")
    monkeypatch.setattr(_build, "HOST_SRC", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_HOST_MODS", {})
    if fault == "no_compiler":
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        want = r"c\+\+ not found"
    elif fault == "no_python_h":
        monkeypatch.setattr(_build.sysconfig, "get_paths",
                            lambda: {"include": str(tmp_path)})
        want = "Python.h not found"
    else:
        want = r"c\+\+ failed for csrc/host/_chain.cpp(.|\n)*error"
    with pytest.raises(RuntimeError, match=want):
        _build.host_module("_chain")
    assert not list((tmp_path / "out").glob("*.so"))


def test_chain_batch_equals_jax_chain_reads(fx, jax_ref):
    """chain_native.chain_batch equals the JAX package's chain_reads; the
    1100 bp read comes back None (the Python path), and the port's
    native chain_reads fills it in with the same chains."""
    ba, intvs, sa_flat = _port(fx)
    vals, off, owners = sa_flat
    assert owners is None   # the native route builds no owners
    got = chain_native.chain_batch(ba.opt, ba.fm, fx["seqs"], intvs, vals,
                                   off)
    want = jax_ref["chains"]
    assert got[-1] is None and len(fx["seqs"][-1]) == 1100
    assert want[-1], "the long read has chains"
    for r in range(len(fx["seqs"]) - 1):
        assert got[r] is not None, r
        assert _chains_sig(got[r]) == _chains_sig(want[r]), r
    full = ba.chain_reads(fx["seqs"], intvs, sa_flat)
    assert [_chains_sig(c) for c in full] == \
        [_chains_sig(c) for c in want]


@pytest.mark.parametrize("ext_mode", ["host", "waves"])
@pytest.mark.parametrize("harvest", [0, 3], ids=["no_harvest", "harvest3"])
@pytest.mark.parametrize("shapes", [dict(wave_cap=32),
                                    dict(wave_cap=8, qmax=16, tmax=32)],
                         ids=["cap32", "oversize"])
def test_extend_waves_packed_equals_jax_extend_waves(fx, jax_ref, shapes,
                                                     harvest, ext_mode):
    """extend_waves_packed -> unpack_regs equals the JAX package's
    regions field for field, the long read spliced in from the Python
    path. Host mode runs no wave; waves mode without harvesters
    and drain runs the device waves on the plain versions; the oversize
    shapes send tasks to the inline scalar kernel."""
    drain = dict(drain_max=0) if ext_mode == "waves" else {}
    ba, intvs, sa_flat = _port(fx, ext_mode=ext_mode,
                               harvest_workers=harvest, **drain, **shapes)
    rows, frac, off = ba.extend_waves_packed(fx["seqs"], intvs, sa_flat)
    got = region_native.unpack_regs(rows, frac, off)
    assert len(got) == len(fx["seqs"])
    for r, want in enumerate(jax_ref["regs"]):
        assert _sig(got[r]) == _sig(want), r
    st = ba.stats
    if ext_mode == "host":
        assert st["waves"] == st["ext_tasks_device"] == 0
        assert st["host_sched"] > 0
    elif harvest == 0:
        assert st["waves"] > 0 and st["ext_tasks_device"] > 0
    if "qmax" in shapes:
        assert st["host_oversize_q"] + st["host_oversize_t"] > 0
    assert st["ext_tasks_host"] > 0   # the long read at least


def test_native_align_se_equals_jax_and_python_route(fx):
    """align_se on the native route equals the JAX package's align_se."""
    want = [JRead(name=f"r{i}", seq=s, qual="I" * len(s), id=i)
            for i, s in enumerate(fx["seqs"])]
    JaxBatchAligner(JaxMemOpt(), fx["jfm"], wave_cap=32).align_se(want)
    reads = [Read(name=f"r{i}", seq=s, qual="I" * len(s), id=i)
             for i, s in enumerate(fx["seqs"])]
    BatchAligner(MemOpt(), fx["fm"], device="cpu",
                 wave_cap=32).align_se(reads)
    assert [r.sam for r in reads] == [r.sam for r in want]


@pytest.fixture(scope="module")
def tail_fx():
    """Repeats (XA/SA/secondary paths), an N run, an ALT contig and
    chimeric reads with qualities, indexed by both packages; pre-dedup
    regions of every read from the JAX package's golden chain +
    mem_chain2aln."""
    rng = np.random.default_rng(0xAE61)
    bases = np.frombuffer(b"ACGT", np.uint8)
    g1 = bases[rng.integers(0, 4, 12000)].copy()
    for dst in (5000, 8000, 10500):
        g1[dst:dst + 500] = g1[2000:2500]
    g1[6000:6006] = ord("N")
    alt = g1[3000:4500].copy()
    for i in range(0, len(alt), 83):
        alt[i] = bases[(np.searchsorted(bases, alt[i]) + 1) % 4]
    contigs = [("c1", "", g1.tobytes()),
               ("c2", "", bases[rng.integers(0, 4, 4000)].tobytes()),
               ("c1_alt", "", alt.tobytes())]
    fm, jfm = build_index(contigs), jax_build_index(contigs)
    fm.bns.anns[2].is_alt = jfm.bns.anns[2].is_alt = 1
    reads = []
    for k in range(60):
        ln = int(rng.integers(70, 152))
        pos = int(rng.integers(0, len(g1) - ln))
        r = CODE[g1[pos:pos + ln]].copy()
        m = rng.random(ln) < 0.03
        r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        if k % 17 == 0:   # chimeric: SA / supplementary
            pos2 = int(rng.integers(0, len(g1) - ln))
            r[ln // 2:] = CODE[g1[pos2:pos2 + ln - ln // 2]]
        q = "".join(chr(33 + int(x)) for x in rng.integers(20, 40, ln))
        reads.append((f"r{k:04d}", r, q))
    return dict(fm=fm, jfm=jfm, reads=reads,
                regs=[_jax_pre_dedup(JaxMemOpt(), jfm, r)
                      for _, r, _ in reads])


def _jax_pre_dedup(opt, fm, seq):
    intvs = jax_smem.collect_intv(opt, fm, seq)
    chains = jax_chain.mem_chain(opt, fm, len(seq), intvs)
    chains = jax_chain.mem_chain_flt(opt, chains)
    jax_chain.mem_flt_chained_seeds(opt, fm, len(seq), seq, chains)
    regs = []
    for c in chains:
        jax_region.mem_chain2aln(opt, fm, len(seq), seq, c, regs)
    return regs


def _read_objs(cls, reads):
    return [cls(name=n, seq=s, qual=q, id=i)
            for i, (n, s, q) in enumerate(reads)]


def _jax_dedup(opt, fm, seq, regs):
    regs = jax_region.mem_sort_dedup_patch(
        opt, fm, seq, copy.deepcopy(regs),
        jax_golden.make_patch_scorer(opt, fm, seq))
    for p in regs:
        if p.rid >= 0 and fm.bns.anns[p.rid].is_alt:
            p.is_alt = 1
    return regs


@pytest.mark.parametrize("flags", [0, MEM_F_ALL, MEM_F_PRIMARY5],
                         ids=["default", "all", "primary5"])
@pytest.mark.parametrize("packed", [False, True], ids=["lists", "packed"])
def test_se_tail_batch_equals_jax_python_tail(tail_fx, flags, packed):
    """The native SE tail (from AlnReg lists, and from packed regions as
    the wave driver hands them over) equals the JAX package's Python
    tail: dedup, ALT flags, primary marking, -5 reorder, SAM."""
    jopt, opt = JaxMemOpt(), MemOpt()
    jopt.flag |= flags
    opt.flag |= flags
    want = []
    for jr, regs in zip(_read_objs(JRead, tail_fx["reads"]),
                        tail_fx["regs"]):
        regs = _jax_dedup(jopt, tail_fx["jfm"], jr.seq, regs)
        jax_region.mem_mark_primary_se(jopt, regs, jr.id)
        if jopt.flag & MEM_F_PRIMARY5:
            jax_region.mem_reorder_primary5(jopt.T, regs)
        jax_reg2sam(jopt, tail_fx["jfm"], jr, regs, 0, None, "rg1")
        want.append(jr.sam)
    reads = _read_objs(Read, tail_fx["reads"])
    assert region_native.se_tail_ok(opt, reads)
    if packed:
        got = region_native.se_tail_batch(
            opt, tail_fx["fm"], reads, None, "rg1",
            packed=region_native.pack_regs(tail_fx["regs"]))
    else:
        got = region_native.se_tail_batch(opt, tail_fx["fm"], reads,
                                          tail_fx["regs"], "rg1")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"read {i}:\n got {g!r}\nwant {w!r}"


def test_dedup_batch_equals_jax_dedup(tail_fx):
    jopt = JaxMemOpt()
    seqs = [s for _, s, _ in tail_fx["reads"]]
    got = region_native.dedup_batch(MemOpt(), tail_fx["fm"], seqs,
                                    tail_fx["regs"])
    for r, (seq, regs) in enumerate(zip(seqs, tail_fx["regs"])):
        want = _jax_dedup(jopt, tail_fx["jfm"], seq, regs)
        assert [_sig(got[r]), [p.is_alt for p in got[r]]] == \
            [_sig(want), [p.is_alt for p in want]], r


def test_tail_gates_send_xr_and_qual_less_reads_to_python(tail_fx):
    opt = MemOpt()
    reads = _read_objs(Read, tail_fx["reads"][:2])
    assert region_native.se_tail_ok(opt, reads)
    assert region_native.pe_tail_ok(opt, reads)
    opt.flag |= 0x100   # -V: the XR tag
    assert not region_native.se_tail_ok(opt, reads)
    assert not region_native.pe_tail_ok(opt, reads)
    reads[1].qual = None
    assert not region_native.se_tail_ok(MemOpt(), reads)
    assert not region_native.pe_tail_ok(MemOpt(), reads)


@pytest.fixture(scope="module")
def pe_fx():
    """24 FR pairs with qualities from the pipeline tests' pair maker
    (the last pair's read2 needs mate rescue) on the tail fixture's first
    two contigs, and their JAX pre-dedup regions."""
    rng = np.random.default_rng(0x9E)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contigs = [(f"k{i}", "", bases[rng.integers(0, 4, 4000)].tobytes())
               for i in range(2)]
    seqs = _pairs(np.random.default_rng(0x9F), contigs, 24)
    reads = [(f"p{i >> 1}", s, "I" * len(s)) for i, s in enumerate(seqs)]
    jfm = jax_build_index(contigs)
    jopt = JaxMemOpt()
    jopt.flag |= MEM_F_PE
    return dict(fm=build_index(contigs), jfm=jfm, reads=reads,
                regs=[_jax_pre_dedup(jopt, jfm, s) for s in seqs])


@pytest.mark.parametrize("insert", [None, "300,40"], ids=["pestat", "I"])
def test_pe_tail_batch_equals_jax_python_tail(pe_fx, insert):
    """The native PE tail (dedup, insert-size estimate or -I, rescue,
    pairing, SAM) equals the JAX package's golden align_pe."""
    jopt, opt = JaxMemOpt(), MemOpt()
    jopt.flag |= MEM_F_PE
    opt.flag |= MEM_F_PE
    want = _read_objs(JRead, pe_fx["reads"])
    jax_golden.align_pe(jopt, pe_fx["jfm"], want, 0,
                        jax_insert_override(insert) if insert else None,
                        "rg7")
    reads = _read_objs(Read, pe_fx["reads"])
    sams, pes = region_native.pe_tail_batch(
        opt, pe_fx["fm"], reads, pe_fx["regs"], "rg7",
        pes0=parse_insert_override(insert) if insert else None)
    for i, (g, w) in enumerate(zip(sams, want)):
        assert g == w.sam, f"read {i}:\n got {g!r}\nwant {w.sam!r}"
    assert sum(int(s.split("\t")[1]) & 0x2 > 0 for s in sams) >= 40
    if insert:
        assert (pes[1].avg, pes[1].std) == (300.0, 40.0)


def _pipe_sams(fm, reads, batch, opt=None, paired=False, **kw):
    out = []
    pipe = AlignPipeline(opt or MemOpt(), fm, paired=paired,
                         device="cpu", **kw)
    try:
        pipe.run([reads[i:i + batch] for i in range(0, len(reads), batch)],
                 out.extend)
    finally:
        pipe.close()
    return [r.sam for r in out], pipe.ba.stats


@pytest.mark.parametrize("ext_mode", ["host", "waves"])
def test_pipeline_pe_native_equals_jax(pe_fx, ext_mode):
    """AlignPipeline on the native route, paired-end in batches of 16
    pairs with a pool of two workers (which the native tail leaves
    idle): the JAX package's golden SAM batch by batch."""
    jopt, opt = JaxMemOpt(), MemOpt()
    jopt.flag |= MEM_F_PE
    opt.flag |= MEM_F_PE
    want = _read_objs(JRead, pe_fx["reads"])
    jax_golden.align_pe(jopt, pe_fx["jfm"], want[:32], 0)
    jax_golden.align_pe(jopt, pe_fx["jfm"], want[32:], 32)
    got, st = _pipe_sams(pe_fx["fm"], _read_objs(Read, pe_fx["reads"]), 32,
                         opt, paired=True, n_workers=2, ext_mode=ext_mode,
                         aligner_kw=dict(wave_cap=32))
    assert got == [r.sam for r in want]
    assert (st["ext_tasks_device"] == 0) == (ext_mode == "host")


@pytest.fixture(scope="module")
def py_tail_fx():
    """12 FR pairs (the last one's read2 needs mate rescue) on two
    contigs whose FASTA headers carry comments (-V's XR tag), indexed by
    both packages."""
    rng = np.random.default_rng(0x7A1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contigs = [(f"v{i}", f"v{i} chromosome {i}; assembled",
                bases[rng.integers(0, 4, 3000)].tobytes()) for i in range(2)]
    return dict(fm=build_index(contigs), jfm=jax_build_index(contigs),
                seqs=_pairs(np.random.default_rng(0x7A2), contigs, 12))


@pytest.mark.parametrize("case", ["fasta", "ref_hdr"])
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_python_tail_inputs_equal_jax(py_tail_fx, paired, case):
    """The inputs the native tails leave to Python: reads without
    qualities (FASTA), and -V (MEM_F_REF_HDR, the XR tag). AlignPipeline
    with a pool of two workers, in two batches, runs their tails in the
    pool (after the native dedup_batch for pairs) and gives the JAX
    package's AlignPipeline SAM."""
    seqs = py_tail_fx["seqs"]
    opt, jopt = MemOpt(), JaxMemOpt()
    for o in (opt, jopt):
        o.flag |= (MEM_F_PE if paired else 0) | \
            (MEM_F_REF_HDR if case == "ref_hdr" else 0)

    def reads(cls):
        return [cls(name=f"p{i >> 1}" if paired else f"r{i}", seq=s,
                    qual=None if case == "fasta" else "I" * len(s), id=i)
                for i, s in enumerate(seqs)]
    jpipe = JaxPipeline(jopt, py_tail_fx["jfm"], paired, n_workers=0,
                        aligner_kw=dict(wave_cap=32))
    want: list = []
    try:
        jr = reads(JRead)
        jpipe.run(iter([jr[:12], jr[12:]]), want.extend)
    finally:
        jpipe.close()
    pipe = AlignPipeline(opt, py_tail_fx["fm"], paired=paired, n_workers=2,
                         device="cpu", aligner_kw=dict(wave_cap=32))
    ran = []
    pool_map = pipe.pool.map

    def recording_map(fn, parts):
        ran.append(getattr(fn, "func", fn))
        return pool_map(fn, parts)
    pipe.pool.map = recording_map
    got: list = []
    try:
        pr = reads(Read)
        pipe.run(iter([pr[:12], pr[12:]]), got.extend)
    finally:
        pipe.close()
    assert [r.sam for r in got] == [r.sam for r in want]
    tail = dataflow._pe_pair_worker if paired else dataflow._se_tail_worker
    assert ran == [tail, tail]
    assert pipe.ba.stats["tail_pairs"] == 0
    sam = "".join(r.sam for r in got)
    if case == "ref_hdr":
        assert "\tXR:Z:v0 chromosome 0; assembled" in sam
    else:
        assert all(l.split("\t")[10] == "*" for l in sam.splitlines())


@pytest.fixture(scope="module")
def shard_fx():
    """150 single-end reads (75 a shard: more than the 64 a shard drains
    on the host) on a 6 kbp genome, and the JAX package's SAM."""
    rng = np.random.default_rng(0x5A)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contigs = [("s1", "", bases[rng.integers(0, 4, 6000)].tobytes())]
    seqs = _seqs(np.random.default_rng(0x5B), contigs, 150)
    reads = [(f"r{i}", s, "I" * len(s)) for i, s in enumerate(seqs)]
    want = _read_objs(JRead, reads)
    jax_golden.align_se(JaxMemOpt(), jax_build_index(contigs), want, 0)
    return dict(fm=build_index(contigs), reads=reads,
                want=[r.sam for r in want])


@pytest.mark.parametrize("ext_mode", ["host", "waves"])
def test_two_shards_native_equal_one_device(shard_fx, ext_mode):
    """The native route over two CPU shards (one wave driver a shard,
    harvesters stealing across them) equals one device and the JAX
    package; in waves mode both shards run waves."""
    kw = dict(ext_mode=ext_mode, aligner_kw=dict(wave_cap=64))
    if ext_mode == "waves":
        kw["aligner_kw"].update(harvest_workers=0)
    one, _ = _pipe_sams(shard_fx["fm"], _read_objs(Read, shard_fx["reads"]),
                        150, **kw)
    two, st = _pipe_sams(shard_fx["fm"], _read_objs(Read, shard_fx["reads"]),
                         150, devices=["cpu", "cpu"], **kw)
    assert one == two == shard_fx["want"]
    shards = st["shards"]
    assert len(shards) == 2
    if ext_mode == "waves":
        assert all(sh["waves"] > 0 and sh["ext_tasks_device"] > 0
                   for sh in shards)
        assert sum(sh["ext_tasks_device"] for sh in shards) == \
            st["ext_tasks_device"]
    else:
        assert st["ext_tasks_device"] == 0 and st["host_sched"] > 0


def _waves_only(fx, **kw):
    return BatchAligner(MemOpt(), fx["fm"], device="cpu", wave_cap=32,
                        ext_mode="waves", drain_max=0, harvest_workers=0,
                        **kw)


def test_corrupted_wave_row_raises(fx, monkeypatch):
    """A wave row outside its task's range (lqle = -3 in lane 0) raises
    DeviceResultError naming the read, the field and the wave lane; it is
    not recomputed on the host."""
    real = batchmod.seed_extend_desc_batch

    def corrupt(*a, **k):
        out = real(*a, **k).clone()
        out[1, 0] = -3
        return out
    monkeypatch.setattr(batchmod, "seed_extend_desc_batch", corrupt)
    reads = [Read(name=f"r{i}", seq=s, qual="I" * len(s), id=i)
             for i, s in enumerate(fx["seqs"])]
    ba = _waves_only(fx)
    with pytest.raises(DeviceResultError,
                       match=r"wave row of read \d+ \(r\d+\): lqle = -3 "
                             r".*wave lane 0$"):
        ba.align_se(reads)
    assert ba.stats["ext_tasks_host"] == 0


def test_native_apply_checks_rows_itself(fx, monkeypatch):
    """With the Python check bypassed, the driver's own row check
    (row_ok) refuses the row and names its wave lane."""
    real = batchmod.seed_extend_desc_batch

    def corrupt(*a, **k):
        out = real(*a, **k).clone()
        out[8, 1] = -7   # rtle of lane 1
        return out
    monkeypatch.setattr(batchmod, "seed_extend_desc_batch", corrupt)
    monkeypatch.setattr(batchmod, "bad_rows", lambda *a: None)
    ba, intvs, sa_flat = _port(fx, wave_cap=32, ext_mode="waves",
                               drain_max=0, harvest_workers=0)
    with pytest.raises(ValueError, match="wave lane 1, read"):
        ba.extend_waves_packed(fx["seqs"], intvs, sa_flat)


def test_hung_device_in_the_extension_worker_times_out(shard_fx,
                                                       monkeypatch):
    """The native pipeline's extension worker waits for its waves under
    the watchdog: a device that stops finishing there raises
    TimeoutError at the join, and the run fails."""
    real = BatchAligner.extend_waves_packed

    def stall(self, *a, **k):
        self._ready = lambda device: (lambda: False)
        return real(self, *a, **k)
    monkeypatch.setattr(BatchAligner, "extend_waves_packed", stall)
    with pytest.raises(TimeoutError, match="0.5 s"):
        _pipe_sams(shard_fx["fm"], _read_objs(Read, shard_fx["reads"]), 150,
                   ext_mode="waves", device_timeout=0.5,
                   aligner_kw=dict(wave_cap=32, drain_max=0,
                                   harvest_workers=0))


def test_failed_run_abandons_the_extension_worker(shard_fx, monkeypatch):
    """The card stops finishing just as batch 2's extension starts; the
    main thread's wait for batch 3's seeding times out first, while the
    worker's own wait began later. The run raises the main thread's
    TimeoutError one device timeout after the stall, not when the
    worker's deadline also passes: the worker's wait is abandoned."""
    timeout, late_s = 2.0, 1.6
    start, ext = BatchAligner.extend_async, BatchAligner.extend_waves_packed
    calls, t_stall = [], []

    def stall(self, *a, **k):
        calls.append(1)
        if len(calls) == 2:
            self._ready = lambda device: (lambda: False)
            t_stall.append(time.monotonic())
        return start(self, *a, **k)

    def late(self, *a, **k):
        if len(calls) == 2:
            time.sleep(late_s)
        return ext(self, *a, **k)
    monkeypatch.setattr(BatchAligner, "extend_async", stall)
    monkeypatch.setattr(BatchAligner, "extend_waves_packed", late)
    with pytest.raises(TimeoutError, match="2 s"):
        _pipe_sams(shard_fx["fm"], _read_objs(Read, shard_fx["reads"]), 50,
                   ext_mode="waves", device_timeout=timeout,
                   aligner_kw=dict(wave_cap=32, drain_max=0,
                                   harvest_workers=0))
    elapsed = time.monotonic() - t_stall[0]
    assert timeout <= elapsed < timeout + late_s / 2, elapsed


def test_native_uploads_go_through_the_watchdog(fx, monkeypatch):
    """Every upload of the native extension goes through the watched,
    abandonable BatchAligner.put: each wave's descriptors, and the
    scoring matrix once (cached across batches), so no copy there can
    wait on a hung card past the deadline."""
    ba, intvs, sa_flat = _port(fx, wave_cap=32, ext_mode="waves",
                               drain_max=0, harvest_workers=0)
    shapes = []
    real = BatchAligner.put

    def recording(self, a, device, abort=None):
        shapes.append(np.shape(a))
        assert abort is not None
        return real(self, a, device, abort)
    monkeypatch.setattr(BatchAligner, "put", recording)
    for _ in range(2):
        ba.extend_waves_packed(fx["seqs"], intvs, sa_flat,
                               abort=threading.Event())
    assert shapes.count((5, 5)) == 1
    assert sum(len(s) == 2 and s[0] == 11 for s in shapes) >= 2


def _tiny_index(name: str):
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = bases[np.random.default_rng(len(name)).integers(0, 4, 400)]
    return build_index([(name, "", g.tobytes())])


def test_native_arrays_go_with_their_index():
    """The native stages' per-index arrays (region_native.bns_arrays,
    shared by the three wrappers, with the wave driver's RefBlock) are
    made once an index and dropped when the index is freed, so a later
    index at the same address gets its own."""
    fm = _tiny_index("old")
    key = id(fm)
    b = region_native.bns_arrays(fm)
    assert region_native.bns_arrays(fm) is b
    assert chain_native.ann_arrays(fm)[0] is b["ann_off"]
    assert wave_native._ref(fm) is wave_native._ref(fm) is b["ref"]
    assert key in region_native._BNS
    del fm, b
    gc.collect()
    assert key not in region_native._BNS
    fm2 = _tiny_index("a_new_contig")
    assert region_native.bns_arrays(fm2)["name_cat"] == b"a_new_contig"
    assert region_native.bns_arrays(fm2)["pac"].tobytes() == \
        np.ascontiguousarray(fm2.bns.pac, np.uint8).tobytes()


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean",
                                                        "corrupted"])
def test_native_validation(shard_fx, monkeypatch, corrupt):
    """--validate-every on the native route checks the unpacked regions of
    each batch: clean batches pass with the JAX SAM, a corrupted score
    raises DeviceResultError."""
    if corrupt:
        real = BatchAligner.extend_waves_packed

        def bad(self, *a, **k):
            rows, frac, off = real(self, *a, **k)
            rows = rows.copy()
            rows[:, 5] += 1
            return rows, frac, off
        monkeypatch.setattr(BatchAligner, "extend_waves_packed", bad)
        with pytest.raises(DeviceResultError, match="golden model"):
            _pipe_sams(shard_fx["fm"], _read_objs(Read, shard_fx["reads"]),
                       50, validate_every=1)
        return
    got, st = _pipe_sams(shard_fx["fm"], _read_objs(Read, shard_fx["reads"]),
                         50, validate_every=1)
    assert got == shard_fx["want"]
    assert st["validations"] == 3
