"""The port's last native host libraries (csrc/host: _native with SA-IS,
ksw_extend2/ksw_global2/ksw_align2 and SA re-sampling; _markdup; _bam)
on the CPU against the JAX package's Python code, which is its golden
path here because its extensions are not built. Inputs are made with
numpy from a local seed and handed to both packages; every comparison
is exact: suffix arrays, index artifacts, alignment tuples and CIGARs,
re-sampled SA tables and the LF walk over them, duplicate marks and
signatures, BAM records, bucket files and merged BAMs, and the CLI's
SAM and BAM against the JAX package's CLI. Malformed input
must raise ValueError (in a subprocess, so an interpreter abort fails
the test and not the suite), and a failed build must raise with no
Python version run in its place."""

import copy
import gzip
import json
import os
import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from bwa_flow_tpu import cli as jcli
from bwa_flow_tpu.dedup import markdup as jmd
from bwa_flow_tpu.index.build import build_index as jax_build_index
from bwa_flow_tpu.index.build import encode_reference as jax_encode
from bwa_flow_tpu.index.suffix import suffix_array as jax_suffix_array
from bwa_flow_tpu.io import bam as jbam
from bwa_flow_tpu.io.sam import Read as JRead
from bwa_flow_tpu.models import golden as jax_golden
from bwa_flow_tpu.ops import ksw as jksw
from bwa_flow_tpu.pipeline import sort as jsort
from bwa_flow_tpu.utils.opts import MEM_F_PE
from bwa_flow_tpu.utils.opts import MemOpt as JaxMemOpt
from bwa_flow_tpu_torch import _build, cli
from bwa_flow_tpu_torch.dedup import markdup as md
from bwa_flow_tpu_torch.index import io as idx_io
from bwa_flow_tpu_torch.index.build import build_index, suffix_array_sais
from bwa_flow_tpu_torch.io import bam
from bwa_flow_tpu_torch.io.fastq import read_batches
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.ops import fm_torch, ksw
from bwa_flow_tpu_torch.parallel import distributed as dist
from bwa_flow_tpu_torch.pipeline import sort
from tests.test_torch_bam_sort import ANNS, NAMES, _lines, _spread_lines
from tests.test_torch_distributed import _env, _free_port, _run_ranks

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASES = np.frombuffer(b"ACGT", np.uint8)


# ------------------------------------------------------------- SA-IS

def _sais_cases():
    """tests/test_index.py's ten adversarial texts, from a local seed."""
    rng = np.random.default_rng(0x5A15)
    cases = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (1, 2, 7, 64, 1000, 65537)]
    cases += [np.zeros(100, np.uint8),
              np.tile(np.array([3, 0], np.uint8), 500),
              np.tile(np.array([1, 1, 0], np.uint8), 333),
              np.arange(4, dtype=np.uint8).repeat(25)]
    return cases


@pytest.mark.parametrize("case", range(10))
def test_sais_equals_jax_suffix_array(case):
    seq = _sais_cases()[case]
    got = suffix_array_sais(seq)
    want = jax_suffix_array(seq)
    assert got.dtype == np.int64 and got.shape == want.shape
    assert (got == want).all()


def test_sais_rejects_symbols_outside_the_alphabet():
    nat = _build.host_module("_native")
    with pytest.raises(ValueError, match="symbol"):
        nat.sais(np.array([0, 1, 4, 2], np.uint8), 4)
    with pytest.raises(ValueError):
        nat.sais(np.zeros(3, np.uint8), 0)


def _genome(seed=0x1DB, n=50_000):
    """Two contigs, an N run in the first."""
    rng = np.random.default_rng(seed)
    g1 = BASES[rng.integers(0, 4, n - n // 5)].copy()
    g1[7000:7040] = ord("N")
    g2 = BASES[rng.integers(0, 4, n // 5)].copy()
    return [("c1", "first", g1.tobytes()), ("c2", "", g2.tobytes())]


def test_build_index_equals_jax():
    """SA-IS behind build_index gives the JAX package's index (its
    prefix-doubling build): BWT blocks, primary, L2, SA samples, pac and
    the contig records."""
    contigs = _genome()
    fm, jfm = build_index(contigs), jax_build_index(contigs)
    assert fm.seq_len == jfm.seq_len == 2 * 50_000
    assert fm.primary == jfm.primary and fm.sa_intv == jfm.sa_intv == 32
    assert (fm.L2 == jfm.L2).all()
    assert (fm.fm_blocks == jfm.fm_blocks).all()
    assert (fm.bwt_symbols() == jfm.bwt_symbols()).all()
    assert fm.sa.dtype == jfm.sa.dtype and (fm.sa == jfm.sa).all()
    assert (fm.bns.pac == jfm.bns.pac).all()
    assert [vars(a) for a in fm.bns.anns] == [vars(a) for a in jfm.bns.anns]
    assert [vars(a) for a in fm.bns.ambs] == [vars(a) for a in jfm.bns.ambs]


@pytest.mark.parametrize("n", [1, 17, 128, 129, 16_001, 100_003])
def test_write_bwt_equals_jax(tmp_path, n):
    """The .bwt writer (one write for the whole file) gives the JAX
    package's bytes, also where the last occ block is partial."""
    from bwa_flow_tpu.index import io as jax_idx_io
    bwt = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    L2 = np.concatenate([[0], np.cumsum([(bwt == c).sum()
                                         for c in range(4)])])
    idx_io.write_bwt(str(tmp_path / "a.bwt"), bwt, n // 3, L2)
    jax_idx_io.write_bwt(str(tmp_path / "b.bwt"), bwt, n // 3, L2)
    assert (tmp_path / "a.bwt").read_bytes() == \
        (tmp_path / "b.bwt").read_bytes()
    got, primary, l2 = idx_io.read_bwt(str(tmp_path / "a.bwt"))
    assert (got == bwt).all() and primary == n // 3


# ---------------------------------------------------------------- ksw

MAT = np.full((5, 5), -4, np.int8)
np.fill_diagonal(MAT, 1)
MAT[4, :] = MAT[:, 4] = -1


def _ext_tasks(kind, n=300):
    """(qlen, q, tlen, t, w, h0) tasks: random, band width 0, h0 at its
    bounds (1 and 2^23, the wide-score path), an empty target."""
    rng = np.random.default_rng(0xE27 + len(kind))
    out = []
    for _ in range(n):
        ql = int(rng.integers(1, 160))
        tl = 0 if kind == "empty_target" else int(rng.integers(1, 400))
        q = rng.integers(0, 5, ql).astype(np.uint8)
        t = rng.integers(0, 5, tl).astype(np.uint8)
        if tl and rng.random() < 0.5:      # a target that holds the query
            t[:min(ql, tl)] = q[:min(ql, tl)]
        w = 0 if kind == "w0" else int(rng.integers(1, 120))
        h0 = {"h0_min": 1, "h0_wide": 1 << 23}.get(
            kind, int(rng.integers(1, 200)))
        out.append((ql, q, tl, t, w, h0))
    return out


@pytest.mark.parametrize("kind", ["random", "w0", "h0_min", "h0_wide",
                                  "empty_target"])
def test_ksw_extend2_native_equals_jax_py(kind):
    for ql, q, tl, t, w, h0 in _ext_tasks(kind):
        for o_del, e_del, zdrop, bonus in ((6, 1, 100, 5), (5, 2, 40, 0)):
            got = ksw.ksw_extend2(ql, q, tl, t, MAT, o_del, e_del, 6, 1, w,
                                  bonus, zdrop, h0)
            want = jksw.ksw_extend2_py(ql, q, tl, t, MAT, o_del, e_del, 6,
                                       1, w, bonus, zdrop, h0)
            assert tuple(got) == tuple(want), (ql, tl, w, h0)
            assert got == ksw.ksw_extend2_py(ql, q, tl, t, MAT, o_del,
                                             e_del, 6, 1, w, bonus, zdrop,
                                             h0)


def test_ksw_extend2_keeps_the_h0_assert():
    q = np.zeros(4, np.uint8)
    with pytest.raises(AssertionError):
        ksw.ksw_extend2(4, q, 4, q, MAT, 6, 1, 6, 1, 10, 5, 100, 0)


@pytest.mark.parametrize("cigar", [True, False], ids=["cigar", "no_cigar"])
def test_ksw_global2_native_equals_jax_py(cigar):
    rng = np.random.default_rng(0x61B)
    for _ in range(400):
        ql = int(rng.integers(1, 160))
        tl = max(1, ql + int(rng.integers(-12, 12)))
        q = rng.integers(0, 5, ql).astype(np.uint8)
        t = rng.integers(0, 5, tl).astype(np.uint8)
        t[:min(ql, tl)] = np.where(rng.random(min(ql, tl)) < 0.9,
                                   q[:min(ql, tl)], t[:min(ql, tl)])
        w = abs(ql - tl) + int(rng.integers(0, 40))
        got = ksw.ksw_global2(ql, q, tl, t, MAT, 6, 1, 6, 1, w, cigar)
        want = jksw.ksw_global2_py(ql, q, tl, t, MAT, 6, 1, 6, 1, w, cigar)
        assert got == want, (ql, tl, w)
        assert got == ksw.ksw_global2_py(ql, q, tl, t, MAT, 6, 1, 6, 1, w,
                                         cigar)


@pytest.mark.parametrize("xtra", [0, jksw.KSW_XSTART,
                                  jksw.KSW_XSUBO | jksw.KSW_XSTART | 20,
                                  jksw.KSW_XBYTE | jksw.KSW_XSTART | 30,
                                  jksw.KSW_XSTOP | 60])
def test_native_ksw_align2_equals_jax(xtra):
    """_native.ksw_align2 (exported, as in the JAX package; mate rescue
    calls the NumPy ksw_align2 in both) against the JAX package's."""
    nat = _build.host_module("_native")
    rng = np.random.default_rng(0xA12 + xtra % 97)
    for _ in range(150):
        ql = int(rng.integers(1, 120))
        tl = int(rng.integers(1, 500))
        q = rng.integers(0, 5, ql).astype(np.uint8)
        t = rng.integers(0, 5, tl).astype(np.uint8)
        if rng.random() < 0.6 and tl > ql:
            p = int(rng.integers(0, tl - ql))
            t[p:p + ql] = q
        r = jksw.ksw_align2(ql, q, tl, t, MAT, 6, 1, 6, 1, xtra)
        got = nat.ksw_align2(ql, q, tl, t, MAT, 5, 6, 1, 6, 1, xtra)
        assert got == (r.score, r.te, r.qe, r.score2, r.te2, r.tb, r.qb)


# the PE tail's rescue call on a 151 bp mate (csrc/host/_region.cpp matesw)
RESCUE_XTRA = (jksw.KSW_XSUBO | jksw.KSW_XSTART | jksw.KSW_XBYTE | 19)
PENS = (6, 1, 6, 1)


def _mate_in(rng, q, tlen, sub=0.02, indel=0, at=None):
    """A window of `tlen` random bases holding `q` with `sub` of its bases
    substituted and an `indel`-bp deletion (> 0) or insertion (< 0) in
    its middle."""
    m = q.copy()
    k = rng.random(len(m)) < sub
    m[k] = (m[k] + rng.integers(1, 4, int(k.sum()))) % 4
    c = len(m) // 2
    if indel > 0:
        m = np.concatenate([m[:c], m[c + indel:]])
    elif indel < 0:
        m = np.concatenate([m[:c], rng.integers(0, 4, -indel), m[c:]])
    t = rng.integers(0, 4, tlen).astype(np.uint8)
    at = int(rng.integers(0, tlen - len(m))) if at is None else at
    t[at:at + len(m)] = m.astype(np.uint8)
    return t


def _align2_case(case, rng):
    """(query, target, mat, xtra, striped) of one call of `case`."""
    q = rng.integers(0, 4, 151).astype(np.uint8)
    tlen = int(rng.integers(400, 701))
    xtra = RESCUE_XTRA
    if case == "rescue_mate":
        t = _mate_in(rng, q, tlen, indel=int(rng.choice([-3, -2, -1, 1, 2,
                                                          3])))
    elif case == "rescue_no_mate":
        t = rng.integers(0, 4, tlen).astype(np.uint8)
    elif case == "rescue_n":
        t = _mate_in(rng, q, tlen, indel=int(rng.integers(1, 4)))
        q[rng.random(151) < 0.03] = 4
        t[rng.random(tlen) < 0.03] = 4
    elif case in ("qlen_odd", "qlen_tiny"):
        ql = int(rng.choice([n for n in range(9, 200) if n % 8])
                 if case == "qlen_odd" else rng.integers(1, 8))
        q = rng.integers(0, 5, ql).astype(np.uint8)
        tlen = int(rng.integers(ql + 1, 500))
        t = _mate_in(rng, q, tlen, sub=0.05)
        xtra = int(rng.choice([RESCUE_XTRA, jksw.KSW_XSTART, 0,
                               jksw.KSW_XSUBO | jksw.KSW_XSTART | 4]))
    elif case == "byte_255":   # 300 bp: the score passes 255 - shift
        q = rng.integers(0, 4, 300).astype(np.uint8)
        t = _mate_in(rng, q, 700, sub=0.0)
        xtra = jksw.KSW_XBYTE | jksw.KSW_XSUBO | 19
    elif case == "long_insertion":
        # the mate with 40-42 extra bases in its middle: the gap's F runs
        # across two or three lanes of 19, and the two flanks with it
        # outscore either flank alone
        g = int(rng.integers(40, 43))
        c = (151 - g) // 2 + int(rng.integers(-3, 4))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        t[200:200 + 151 - g] = np.concatenate([q[:c], q[c + g:]])
    elif case == "xstop":      # the mate's score reaches 60 mid-window
        t = _mate_in(rng, q, tlen, sub=0.0, at=100)
        xtra = jksw.KSW_XSTOP | 60
    elif case in ("xsubo_near", "xsubo_far"):
        # a second, weaker copy (its first 80 bases) beside the mate, or
        # more than the score's radius away
        t = _mate_in(rng, q, 700, sub=0.0, at=20)
        at = 180 if case == "xsubo_near" else 500
        t[at:at + 80] = q[:80]
    elif case == "ties":       # periodic query and two equal copies
        q = np.tile(rng.integers(0, 4, 4).astype(np.uint8), 38)[:151]
        t = _mate_in(rng, q, tlen, sub=0.0, at=10)
        t[-170:-19] = q
    else:                      # past int16: 300 x 120 > 32767 - 255
        assert case == "past_i16"
        q = rng.integers(0, 4, 300).astype(np.uint8)
        t = _mate_in(rng, q, 420, sub=0.03)
        mat = MAT.copy()
        np.fill_diagonal(mat[:4, :4], 120)
        return q, t, mat, jksw.KSW_XSUBO | jksw.KSW_XSTART | 19, False
    return q, t, MAT, xtra, True


ALIGN2_CASES = ("rescue_mate", "rescue_no_mate", "rescue_n", "qlen_odd",
                "qlen_tiny", "long_insertion", "byte_255", "xstop",
                "xsubo_near", "xsubo_far", "ties", "past_i16")


@pytest.mark.parametrize("case", ALIGN2_CASES)
def test_striped_ksw_align2_equals_jax(case):
    """_native.ksw_align2 on the mate rescue's shapes and at each of its
    edges against the JAX package's NumPy ksw_align2; every case but
    past_i16 takes the striped pass, past_i16 the scalar one."""
    nat = _build.host_module("_native")
    rng = np.random.default_rng(0x5172 + ALIGN2_CASES.index(case))
    got_all = []
    for _ in range(12):
        q, t, mat, xtra, striped = _align2_case(case, rng)
        args = (len(q), q, len(t), t, mat.ravel(), 5, *PENS, xtra)
        assert nat.ksw_striped_ok(len(q), mat.ravel(), 5, *PENS,
                                  xtra) == striped
        got = nat.ksw_align2(*args)
        r = jksw.ksw_align2(len(q), q, len(t), t, mat, *PENS, xtra)
        assert got == (r.score, r.te, r.qe, r.score2, r.te2, r.tb, r.qb)
        assert got == nat.ksw_align2_scalar(*args)
        got_all.append(got)
    score, te, score2, te2 = (np.array([g[i] for g in got_all])
                              for i in (0, 1, 3, 4))
    if case == "byte_255":
        assert (score == 255).all()
    elif case == "xstop":
        assert (score >= 60).all() and (te < 100 + 151 - 1).all()
    elif case == "xsubo_far":
        assert (score2 >= 60).all() and (abs(te2 - te) > score).all()
    elif case == "xsubo_near":
        assert (score2 < 60).all()
    elif case == "ties":
        assert (te < 200).all()
    elif case == "rescue_mate":
        assert (score >= 100).all()
    elif case == "long_insertion":   # both flanks and the gap: 151 - 2g - 6
        assert (score >= 151 - 2 * 42 - 6).all()


@pytest.mark.parametrize("pens", [PENS, (0, 0, 0, 0), (0, 1, 0, 1),
                                  (5, 0, 1, 3), (2, 2, 9, 1)],
                         ids=["bwa", "free", "extend_only", "mixed",
                              "uneven"])
@pytest.mark.parametrize("match", [1, 3])
def test_striped_ksw_align2_equals_scalar(pens, match):
    """The striped pass against ksw_local_scalar (_native.ksw_align2_scalar)
    on random queries of 1-300 bases, windows with and without the
    query, N, and every xtra flag; zero penalties let F and E run
    without decay across every lane."""
    nat = _build.host_module("_native")
    mat = MAT.copy()
    np.fill_diagonal(mat[:4, :4], match)
    flags = (0, jksw.KSW_XSTART, RESCUE_XTRA, jksw.KSW_XSTOP | 40,
             jksw.KSW_XBYTE | jksw.KSW_XSTART,
             jksw.KSW_XSUBO | jksw.KSW_XSTART | 30)
    rng = np.random.default_rng(0x57A1 + 7 * match + sum(pens))
    for i in range(240):
        ql = int(rng.integers(1, 301))
        q = rng.integers(0, 5, ql).astype(np.uint8)
        tl = int(rng.integers(ql + 1, 700))
        t = (_mate_in(rng, q, tl, sub=0.04) if i % 3
             else rng.integers(0, 5, tl).astype(np.uint8))
        xtra = flags[i % len(flags)]
        args = (ql, q, tl, t, mat.ravel(), 5, *pens, xtra)
        assert nat.ksw_striped_ok(ql, mat.ravel(), 5, *pens, xtra)
        assert nat.ksw_align2(*args) == nat.ksw_align2_scalar(*args), \
            (ql, tl, xtra)


def test_native_ksw_rejects_short_buffers_and_bad_symbols():
    nat = _build.host_module("_native")
    q = np.zeros(8, np.uint8)
    with pytest.raises(ValueError):
        nat.ksw_extend2(9, q, 8, q, MAT, 5, 6, 1, 6, 1, 10, 5, 100, 10)
    with pytest.raises(ValueError):
        nat.ksw_global2(8, q + 5, 8, q, MAT, 5, 6, 1, 6, 1, 10)


# ------------------------------------------------------ SA re-sampling

@pytest.fixture(scope="module")
def saved_index(tmp_path_factory):
    """A 2 x 24 kbp genome indexed by the port and saved; its full SA
    (JAX suffix_array over both strands) for the checks."""
    d = tmp_path_factory.mktemp("resample")
    contigs = _genome(0x5A3, 30_000)
    idx_io.save_index(str(d / "ref"), build_index(contigs))
    _, fwd = jax_encode(contigs)
    both = np.concatenate([fwd, (3 - fwd)[::-1]])
    return d, jax_suffix_array(both)


def _fresh_prefix(saved_index, tmp_path):
    d, _ = saved_index
    for ext in (".bwt", ".sa", ".pac", ".ann", ".amb"):
        (tmp_path / f"ref{ext}").write_bytes((d / f"ref{ext}").read_bytes())
    return str(tmp_path / "ref")


@pytest.mark.parametrize("intv", [4, 8, 16])
def test_resample_sa_equals_every_nth_sa_entry(saved_index, tmp_path,
                                               monkeypatch, intv):
    """RESAMPLE_MIN lowered: load_index densifies the SA to the smallest
    of 4/8/16 that fits BWA_TPU_SA_BYTES; the table equals every intv-th
    entry of the full SA (bwa's -1 at row 0), the .tpu.sa<N>.npy cache
    loads memmapped, and the LF walk over the table (no dense SA) gives
    the full SA's values."""
    _, full = saved_index
    prefix = _fresh_prefix(saved_index, tmp_path)
    seq_len = len(full) - 1
    monkeypatch.setattr(idx_io, "RESAMPLE_MIN", 0)
    monkeypatch.setenv("BWA_TPU_SA_BYTES", str((seq_len // intv + 1) * 4))
    fm = idx_io.load_index(prefix)
    want = full[::intv].copy()
    want[0] = -1
    assert fm.sa_intv == intv and (np.asarray(fm.sa) == want).all()
    cache = Path(f"{prefix}.tpu.sa{intv}.npy")
    assert cache.exists() and np.load(cache).dtype == np.int32
    fm2 = idx_io.load_index(prefix)
    assert isinstance(fm2.sa, np.memmap) and fm2.sa.dtype == np.int32
    assert fm2.sa_intv == intv and (np.asarray(fm2.sa) == want).all()
    dfm = fm_torch.DeviceFM.from_host(fm2, "cpu", dense_sa_max=0)
    assert dfm.sa_dense is None and dfm.sa_intv == intv
    rng = np.random.default_rng(intv)
    rows = np.concatenate([[1, seq_len, int(fm2.primary)],
                           rng.integers(1, seq_len + 1, 509)])
    vals, ovf = fm_torch.sa_batch(dfm, torch.as_tensor(rows), 256, intv)
    assert not ovf.any()
    assert (vals.numpy() == full[rows]).all()


def test_resample_sa_off(saved_index, tmp_path, monkeypatch):
    """BWA_TPU_SA_BYTES=0 disables the re-sampling; at the default
    RESAMPLE_MIN a small genome keeps bwa's interval too."""
    prefix = _fresh_prefix(saved_index, tmp_path)
    assert idx_io.load_index(prefix).sa_intv == 32
    monkeypatch.setattr(idx_io, "RESAMPLE_MIN", 0)
    monkeypatch.setenv("BWA_TPU_SA_BYTES", "0")
    assert idx_io.load_index(prefix).sa_intv == 32
    assert not list(tmp_path.glob("ref.tpu.sa[0-9]*.npy"))


# ------------------------------------------------------------- markdup

@pytest.fixture(scope="module")
def md_fx():
    """SAM of a small single-end and paired-end run (the JAX package's
    golden model) with duplicates injected: copies of reads and pairs
    under new names, and a non-ASCII tag on some reads."""
    rng = np.random.default_rng(0x3D0)
    contigs = [(f"ctg{i}", "", BASES[rng.integers(0, 4, 6000)].tobytes())
               for i in range(2)]
    jfm = jax_build_index(contigs)
    code = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        code[c] = i
    gen = [code[np.frombuffer(s, np.uint8)] for _, _, s in contigs]

    def mut(r):
        r = r.copy()
        m = rng.random(len(r)) < 0.02
        r[m] = (r[m] + 1) % 4
        return r
    se = []
    for i in range(40):
        g = gen[i % 2]
        p = int(rng.integers(0, len(g) - 101))
        r = mut(g[p:p + 101]) if i % 5 else (3 - g[p:p + 101])[::-1].copy()
        se.append(JRead(name=f"s{i}", seq=r, qual="I" * 101, id=i))
    for k in range(0, 12, 2):
        se.append(JRead(name=f"sdup{k}", seq=se[k].seq.copy(),
                        qual="I" * 101, id=len(se)))
    jax_golden.align_se(JaxMemOpt(), jfm, se)
    pe = []
    for i in range(24):
        g = gen[i % 2]
        span = 300 + int(rng.integers(-30, 30))
        p = int(rng.integers(0, len(g) - span))
        r1 = mut(g[p:p + 101])
        r2 = mut((3 - g[p + span - 101:p + span])[::-1].copy())
        for j, r in enumerate((r1, r2)):
            pe.append(JRead(name=f"p{i}", seq=r, qual="I" * 101,
                            id=2 * i + j))
    for k in range(0, 16, 2):
        for j in (0, 1):
            src = pe[2 * k + j]
            pe.append(JRead(name=f"pdup{k}", seq=src.seq.copy(),
                            qual="I" * 101, id=len(pe)))
    opt = JaxMemOpt()
    opt.flag |= MEM_F_PE
    jax_golden.align_pe(opt, jfm, pe)
    for reads in (se, pe):
        for r in reads[3::7]:
            r.sam = r.sam.replace("\n", "\tXU:Z:résumé\n", 1)
    return dict(jfm=jfm, fm=build_index(contigs), se=se, pe=pe)


def _port_reads(jreads):
    return [Read(name=r.name, seq=r.seq, sam=r.sam) for r in jreads]


@pytest.mark.parametrize("inputs", ["se", "pe"])
@pytest.mark.parametrize("ignore_unmated", [True, False],
                         ids=["ignore_unmated", "strict"])
def test_native_markdup_equals_jax_markdup(md_fx, inputs, ignore_unmated):
    """NativeMarkDupStage against the JAX package's MarkDupStage (regex),
    in batches: the same SAM, dup_count, unmated_count and signatures."""
    jreads = copy.deepcopy(md_fx[inputs])
    nreads = _port_reads(md_fx[inputs])
    jst = jmd.MarkDupStage(md_fx["jfm"], ignore_unmated)
    nst = md.make_markdup_stage(md_fx["fm"], ignore_unmated)
    assert isinstance(nst, md.NativeMarkDupStage)
    cut = [0, 10, 11, 30, len(jreads)] if inputs == "se" else \
        [0, 10, 30, len(jreads)]
    for a, b in zip(cut, cut[1:]):
        jst.process(jreads[a:b])
        nst.process(nreads[a:b])
    assert [r.sam for r in nreads] == [r.sam for r in jreads]
    assert nst.state.dup_count == jst.state.dup_count >= 6
    assert nst.state.unmated_count == jst.state.unmated_count
    assert sorted(nst.state.signature_items()) == \
        sorted(jst.state.signature_items())
    assert any("é" in r.sam for r in nreads)


def _sam(name, flag, rname, pos, cigar="101M"):
    return (f"{name}\t{flag}\t{rname}\t{pos}\t60\t{cigar}\t=\t{pos + 200}"
            f"\t300\tA\tI\n")


def test_native_markdup_ungrouped_block_raises(md_fx):
    """A pair's mates in different blocks: strict mode raises ValueError
    in both stages."""
    sams = [("a", _sam("a", 99, "ctg0", 100)), ("b", _sam("b", 99, "ctg0",
                                                          500)),
            ("a", _sam("a", 147, "ctg0", 300))]
    with pytest.raises(ValueError, match="grouped"):
        jmd.MarkDupStage(md_fx["jfm"]).process(
            [JRead(name=n, seq=np.zeros(1, np.uint8), sam=s)
             for n, s in sams])
    with pytest.raises(ValueError, match="grouped"):
        md.NativeMarkDupStage(md_fx["fm"]).process(
            [Read(name=n, seq=np.zeros(1, np.uint8), sam=s)
             for n, s in sams])


def test_native_markdup_items_survive_merge(md_fx):
    """signature_items -> merge_markdup_signatures (one process: the
    allgather is the identity) -> merge: a second state then marks the
    first one's pairs as duplicates; an item with a high sig survives the
    int64 allgather unchanged."""
    reads = _port_reads(md_fx["pe"])
    a = md.NativeMarkDupStage(md_fx["fm"], True)
    a.process(reads[:20])
    high = (3, 5, (((1 << 27) - 1) << 32) | ((1 << 27) - 1))
    a.state.merge([high])
    items = a.state.signature_items()
    assert high in items and all(0 <= x < 1 << 63 for t in items for x in t)
    b = md.NativeMarkDupStage(md_fx["fm"], True)
    b.state.merge(items)
    dist.merge_markdup_signatures(b.state)
    assert sorted(b.state.signature_items()) == sorted(items)
    again = _port_reads(md_fx["pe"])[:20]
    b.process(again)
    assert b.state.dup_count == a.state.dup_count + len(items) - 1


MERGE_WORKER = textwrap.dedent("""
    import json, sys
    from bwa_flow_tpu_torch.dedup.markdup import NativeMarkDupState
    from bwa_flow_tpu_torch.parallel import distributed as dist

    pid, n, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert dist.init_distributed(coord, n, pid) == (pid, n)

    class A:
        def __init__(s, name, l): s.name, s.len = name, l
    st = NativeMarkDupState([A("c1", 1000)])
    st.merge([(pid, 0, 1234 + pid), (9, 9, 9),
              (7, 7, (((1 << 27) - 1) << 32) | pid)])
    dist.merge_markdup_signatures(st)
    print(json.dumps(sorted(st.signature_items())))
    dist.shutdown()
""")


def test_gloo_merge_native_markdup_signatures(tmp_path):
    """Two ranks (gloo) union their native states' uint64 items through
    the int64 allgather, high bits intact."""
    (tmp_path / "w.py").write_text(MERGE_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_ranks([[sys.executable, str(tmp_path / "w.py"), str(i),
                        "2", coord] for i in range(2)], _env(tmp_path),
                      tmp_path)
    hi = ((1 << 27) - 1) << 32
    want = sorted([[0, 0, 1234], [1, 0, 1235], [9, 9, 9], [7, 7, hi],
                   [7, 7, hi | 1]])
    assert [json.loads(o.strip().splitlines()[-1]) for o in outs] == \
        [want, want]


# ----------------------------------------------------------------- BAM

def _bgzf_blocks(data: bytes):
    """[(payload size, inflated payload)] of each BGZF member."""
    out, off = [], 0
    while off < len(data):
        bsize = struct.unpack_from("<H", data, off + 16)[0] + 1
        block = data[off:off + bsize]
        isize = struct.unpack_from("<I", block, bsize - 4)[0]
        out.append((isize, zlib.decompress(block[18:bsize - 8], -15)))
        off += bsize
    return out


def _same_zlib() -> bool:
    return _build.host_module("_bam").zlib_version() == \
        zlib.ZLIB_RUNTIME_VERSION


def test_sam_to_bam_equals_jax_encoder():
    lines = _lines() + _spread_lines()
    sam = "@HD\tVN:1.6\n\n" + "\n".join(lines) + "\n"
    names = b"".join(a.name.encode() + b"\x00" for a in ANNS)
    got = _build.host_module("_bam").sam_to_bam(sam, names)
    assert got == b"".join(jbam.sam_line_to_bam(l, NAMES) for l in lines)


@pytest.mark.parametrize("size", [1, 0xFF00, 3 * 0xFF00 + 17, 200_000])
def test_bgzf_native_blocks_equal_jax(size):
    """Native BGZF (threaded) against the JAX package's bgzf_compress:
    the same block boundaries and payloads; the same bytes where the
    library links the zlib Python runs."""
    data = np.random.default_rng(size).integers(0, 8, size,
                                                dtype=np.uint8).tobytes()
    got = _build.host_module("_bam").bgzf(data, 6, 3)
    want = jbam.bgzf_compress(data)
    assert _bgzf_blocks(got) == _bgzf_blocks(want)
    assert gzip.decompress(got + bam.BGZF_EOF) == data
    if _same_zlib():
        assert got == want


def test_bam_writer_equals_jax(tmp_path):
    """BamWriter on _bam against the JAX package's BamWriter: the same
    payload in the same blocks; the same bytes where the library links
    the zlib Python runs."""
    sam = "@HD\tVN:1.6\n" + "\n".join(_lines() * 40) + "\n"
    w = bam.BamWriter(str(tmp_path / "mine.bam"), ANNS, "@HD\tVN:1.6\n")
    w.write_sam_text(sam)
    w.close()
    jw = jbam.BamWriter(str(tmp_path / "theirs.bam"), ANNS, "@HD\tVN:1.6\n")
    jw.write_sam_text(sam)
    jw.close()
    mine = (tmp_path / "mine.bam").read_bytes()
    theirs = (tmp_path / "theirs.bam").read_bytes()
    assert _bgzf_blocks(mine) == _bgzf_blocks(theirs)
    if _same_zlib():
        assert mine == theirs


def _bucket(mod, root, lines, nb, drop, **kw):
    bs = mod.BucketSort(ANNS, str(root), num_buckets=nb, drop_dups=drop,
                        **kw)
    for i in range(0, len(lines), 37):     # several SAM chunks
        bs.write_sam_text("\n".join(lines[i:i + 37]) + "\n")
    return bs.close()


@pytest.mark.parametrize("drop", [False, True], ids=["keep", "drop_dups"])
@pytest.mark.parametrize("nb", [4, 16])
def test_sam_to_bam_bucketed_equals_jax(tmp_path, nb, drop):
    """BucketSort on _bam's sam_to_bam_bucketed: the JAX package's bucket
    files, byte for byte."""
    lines = _spread_lines() + _lines()
    mine = _bucket(sort, tmp_path / "mine", lines, nb, drop)
    theirs = _bucket(jsort, tmp_path / "theirs", lines, nb, drop)
    assert len(mine) == nb + 1
    for a, b in zip(mine, theirs):
        assert Path(a).read_bytes() == Path(b).read_bytes(), a
    assert sum(Path(p).stat().st_size for p in mine) > 0


@pytest.mark.parametrize("nb", [4, 16])
def test_scan_records_gather_and_merge_equal_jax(tmp_path, nb):
    """scan_records' order and gather's records against the JAX
    package's bucket scan, and the merged BAM against its
    merge_sorted_bam: the same payload in the same blocks."""
    lines = _spread_lines() + _lines()
    hdr = "@HD\tVN:1.6\tSO:coordinate\n"
    paths = _bucket(jsort, tmp_path / "b", lines, nb, False)
    lib = _build.host_module("_bam")
    for p in paths:
        data, offs, lens, order = sort._load_sorted_bucket(p, lib)
        jdata, joffs, jlens, jorder = jsort._load_sorted_bucket(p)
        assert list(offs) == joffs and list(lens) == jlens
        assert list(order) == list(jorder)
        so = np.asarray(offs, np.int64)[np.asarray(order, np.int64)]
        sl = np.asarray(lens, np.int64)[np.asarray(order, np.int64)]
        assert lib.gather(data, so.tobytes(), sl.tobytes()) == b"".join(
            jdata[joffs[i]:joffs[i] + jlens[i]] for i in jorder)
    sort.merge_sorted_bam(paths, str(tmp_path / "mine.bam"), ANNS, hdr)
    jsort.merge_sorted_bam(paths, str(tmp_path / "theirs.bam"), ANNS, hdr)
    mine = (tmp_path / "mine.bam").read_bytes()
    theirs = (tmp_path / "theirs.bam").read_bytes()
    assert _bgzf_blocks(mine) == _bgzf_blocks(theirs)
    text, _, recs = bam.decode_bam_records(gzip.decompress(mine))
    assert text == hdr and len(recs) == len(lines)


# Each malformed input, in a subprocess: it must raise ValueError (exit
# 1), not abort the interpreter.
_LINE = "r\t0\tchr1\t10\t60\t4M\t*\t0\t0\tACGT\tIIII"
MALFORMED = {
    "bad_cigar_op": ("sam", _LINE.replace("4M", "4Z")),
    "short_line": ("sam", "r\t0\tchr1\t10"),
    "bad_tag_type": ("sam", _LINE + "\tXX:Q:1"),
    "tag_int_range": ("sam", _LINE + "\tNM:i:99999999999"),
    "bad_integer": ("sam", _LINE.replace("\t10\t", "\tten\t")),
    "bucketed_bad_cigar": ("bucketed", _LINE.replace("4M", "4Z")),
    "qual_seq_mismatch": ("sam", _LINE.replace("IIII", "III")),
    "qname_255": ("sam", "q" * 255 + _LINE[1:]),
    "flag_65536": ("sam", _LINE.replace("r\t0\t", "r\t65536\t")),
    "bgzf_failed_block": ("bgzf", ""),
    "gather_negative_length": ("gather", "neg"),
    "gather_lengths_differ": ("gather", "differ"),
}

MALFORMED_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from bwa_flow_tpu_torch import _build
    b = _build.host_module("_bam")
    kind, arg = sys.argv[1], sys.argv[2]
    names = b"chr1\\x00chr2\\x00"
    try:
        if kind == "sam":
            b.sam_to_bam(arg + "\\n", names)
        elif kind == "bucketed":
            acc = np.array([0, 5000, 8000], np.int64).tobytes()
            b.sam_to_bam_bucketed(arg + "\\n", names, acc, 1000, 8, False,
                                  False)
        elif kind == "bgzf":
            b.bgzf(b"x" * 200000, 42, 3)      # no such zlib level
        else:
            data = b"\\x00" * 64
            offs = np.array([0, 8], np.int64)
            lens = np.array([-5, 8] if arg == "neg" else [8], np.int64)
            b.gather(data, offs.tobytes(), lens.tobytes())
    except ValueError as e:
        print("ValueError:", e)
        sys.exit(1)
    print("no error")
""")


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_input_raises_value_error(tmp_path, case):
    kind, arg = MALFORMED[case]
    (tmp_path / "m.py").write_text(MALFORMED_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, str(tmp_path / "m.py"), kind, arg],
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 1, (r.returncode, r.stdout, r.stderr[-2000:])
    assert r.stdout.startswith("ValueError:"), r.stdout


# ------------------------------------------------------- failed build

def _entry_points(tmp_path):
    contigs = [("c", "", BASES[np.random.default_rng(3).integers(
        0, 4, 3000)].tobytes())]
    q = np.zeros(20, np.uint8)
    fm_ = type("FM", (), {"bns": type("B", (), {"anns": ANNS})})
    fq = tmp_path / "r.fq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    return {
        "build_index": lambda: build_index(contigs),
        "ksw_extend2": lambda: ksw.ksw_extend2(20, q, 20, q, MAT, 6, 1, 6,
                                               1, 10, 5, 100, 10),
        "ksw_global2": lambda: ksw.ksw_global2(20, q, 20, q, MAT, 6, 1, 6,
                                               1, 10),
        "markdup": lambda: md.make_markdup_stage(fm_),
        "bam_writer": lambda: bam.BamWriter(str(tmp_path / "x.bam"), ANNS),
        "bucket_sort": lambda: sort.BucketSort(ANNS, str(tmp_path / "t")),
        "read_batches": lambda: next(read_batches(fq)),
    }


@pytest.mark.parametrize("entry", ["build_index", "ksw_extend2",
                                   "ksw_global2", "markdup", "bam_writer",
                                   "bucket_sort", "read_batches"])
def test_failed_build_raises_and_no_python_version_runs(tmp_path,
                                                        monkeypatch, entry):
    """A compiler that fails: the entry point raises with its output, and
    no Python version runs in its place."""
    fake = tmp_path / "fail-cxx"
    fake.write_text("#!/bin/sh\necho 'fatal: this compiler fails' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "cxx", lambda: str(fake))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(_build, "_HOST_MODS", {})

    def ran(*a, **k):
        raise AssertionError("a Python version ran")
    for mod, name in ((ksw, "ksw_extend2_py"), (ksw, "ksw_global2_py"),
                      (bam, "bgzf_block")):
        monkeypatch.setattr(mod, name, ran)
    import bwa_flow_tpu_torch.index.suffix as suffix
    monkeypatch.setattr(suffix, "suffix_array", ran)
    with pytest.raises(RuntimeError, match="this compiler fails"):
        _entry_points(tmp_path)[entry]()
    assert not list((tmp_path / "host").glob("*.so"))


def test_six_host_libraries_load_alone():
    """All seven host libraries import from build/host/ as modules of
    bwa_flow_tpu_torch, with no JAX or bwa_flow_tpu module loaded; each
    build hashes only the headers its source includes."""
    code = (
        "import sys\n"
        "from bwa_flow_tpu_torch import _build\n"
        "for n in _build.HOST_LIBS:\n"
        "    m = _build.host_module(n)\n"
        "    assert m.__name__ == 'bwa_flow_tpu_torch.' + n\n"
        "    assert m.__file__ == str(_build.host_lib_path(n))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'bwa_flow_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", \
        r.stdout + r.stderr[-3000:]
    assert len(_build.HOST_LIBS) == 7
    heads = {n: [p.name for p in _build.host_headers(n)]
             for n in _build.HOST_LIBS}
    assert heads["_chain"] == ["introsort.h"]
    assert heads["_fastq"] == []
    assert heads["_markdup"] == heads["_bam"] == ["nogil.h"]
    assert sorted(heads["_native"]) == ["ksw_impl.h", "nogil.h",
                                        "sais_impl.h"]


# ------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def cli_fx(tmp_path_factory):
    """An 8 kbp genome; 40 single-end reads and 20 pairs, with copies of
    some under new names (duplicates for markdup)."""
    d = tmp_path_factory.mktemp("hostlibs_cli")
    rng = np.random.default_rng(0xC1D)
    g = BASES[rng.integers(0, 4, 8000)].tobytes()
    (d / "ref.fa").write_text(">chrA\n" + "\n".join(
        g.decode()[i:i + 70] for i in range(0, 8000, 70)) + "\n")
    comp = bytes.maketrans(b"ACGT", b"TGCA")

    def fq(recs):
        return "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in recs)
    se, r1, r2 = [], [], []
    for i in range(40):
        p = int(rng.integers(0, 8000 - 101))
        se.append((f"s{i}", g[p:p + 101].decode()))
    se += [(f"sd{i}", se[i][1]) for i in range(0, 10, 2)]
    for i in range(20):
        p = int(rng.integers(0, 8000 - 420))
        r1.append((f"p{i}/1", g[p:p + 101].decode()))
        r2.append((f"p{i}/2", g[p + 300:p + 401].translate(comp)[::-1]
                   .decode()))
    for i in range(0, 8, 2):
        r1.append((f"pd{i}/1", r1[i][1]))
        r2.append((f"pd{i}/2", r2[i][1]))
    (d / "se.fq").write_text(fq(se))
    (d / "r1.fq").write_text(fq(r1))
    (d / "r2.fq").write_text(fq(r2))
    assert cli.main(["index", str(d / "ref.fa")]) == 0
    return d


def _records(out: Path, sort_out: bool):
    """A run's output without its @PG lines: the SAM body, or the sorted
    BAM's header lines, references and raw records."""
    if sort_out:
        text, refs, recs = bam.decode_bam_records(
            gzip.decompress(out.read_bytes()))
        return ([l for l in text.splitlines() if not l.startswith("@PG")],
                refs, [r["raw"] for r in recs])
    return [l for l in out.read_text().splitlines()
            if not l.startswith("@PG")]


def _cli_run(d, inputs, sort_out, main, tag, capsys):
    """`mem` of the CLI `main` (the port's on the CPU, or the JAX
    package's --no-device in d/jax, its own index beside it); returns
    (records, markdup line)."""
    fq = ["se.fq"] if inputs == "se" else ["r1.fq", "r2.fq"]
    out = d / f"{inputs}_{tag}.{'bam' if sort_out else 'sam'}"
    extra = ["--sort", "--num-buckets", "4", "--temp-dir",
             str(d / f"td_{inputs}_{tag}")] if sort_out else []
    ref = d / "ref.fa"
    if main is jcli.main:
        (d / "jax").mkdir(exist_ok=True)
        ref = d / "jax" / "ref.fa"
        if not ref.exists():
            ref.write_bytes((d / "ref.fa").read_bytes())
            assert jcli.main(["index", str(ref)]) == 0
        extra = ["--no-device"] + extra
    else:
        extra = ["--device", "cpu"] + extra
    capsys.readouterr()
    assert main(["mem"] + extra + ["-o", str(out), str(ref)]
                + [str(d / f) for f in fq]) == 0
    err = capsys.readouterr().err
    return (_records(out, sort_out),
            [l for l in err.splitlines() if "[M::mem] markdup:" in l])


@pytest.mark.parametrize("sort_out", [False, True], ids=["sam", "sort"])
@pytest.mark.parametrize("inputs", ["se", "pe"])
def test_cli_native_route_equals_python_route(cli_fx, inputs, sort_out,
                                              monkeypatch, capsys):
    """The CLI's route (native markdup, native BAM encoder) against the
    JAX package's CLI (regex markdup, Python encoder): the same SAM, or
    the same records in the same sorted BAM, and the same markdup line,
    with duplicates marked by the native stage."""
    log: list = []
    real = md.NativeMarkDupStage.process

    def spy(self, reads):
        log.append(type(self).__name__)
        return real(self, reads)
    monkeypatch.setattr(md.NativeMarkDupStage, "process", spy)
    nat = _cli_run(cli_fx, inputs, sort_out, cli.main, "port", capsys)
    want = _cli_run(cli_fx, inputs, sort_out, jcli.main, "jax", capsys)
    assert nat[0] == want[0]
    assert nat[1] == want[1] and len(nat[1]) == 1
    n_dup = int(nat[1][0].split()[2])
    assert n_dup >= (5 if inputs == "se" else 4), nat[1]
    assert log and set(log) == {"NativeMarkDupStage"}
