"""The port's BAM encoder (the _bam host library behind
bwa_flow_tpu_torch/io/bam.py) and bucket sort (pipeline/sort.py) against
the JAX package's on the same numpy-made inputs, exactly: record bytes,
BGZF bytes, bucket and .bed files, the merged BAM, sort keys. The JAX
package runs its pure-Python route here (its native `_bam` extension,
when built, is held byte-equal to that route by
tests/test_bam_sort.py::test_native_bam_parity)."""

import gzip
import struct
from pathlib import Path

import numpy as np
import pytest

from bwa_flow_tpu.io import bam as jbam
from bwa_flow_tpu.pipeline import sort as jsort
from bwa_flow_tpu_torch import _build
from bwa_flow_tpu_torch.io import bam
from bwa_flow_tpu_torch.pipeline import sort


class _Ann:
    def __init__(self, name, length):
        self.name = name
        self.len = length


ANNS = [_Ann("chr1", 5000), _Ann("chr2", 3000)]
NAMES = {"chr1": 0, "chr2": 1}


def _lines(seed=7, n=200):
    """The varied fixture of tests/test_bam_sort.py::test_native_bam_parity:
    N bases, lower case, `*` quality, unmapped reads, every flag kind,
    XA:Z and B:s tags; positions over both contigs."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        l = int(rng.integers(20, 150))
        seq = "".join("ACGTNacgtn"[j] for j in rng.integers(0, 10, l))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, l))
        if i % 17 == 0:
            lines.append(f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*")
            continue
        chrom = "chr1" if i % 3 else "chr2"
        pos = int(rng.integers(1, 2000))
        s = int(rng.integers(0, 5))
        cig = (f"{s}S" if s else "") + f"{l - s}M"
        flag = int(rng.choice([0, 16, 99, 147, 83, 1024, 256]))
        tags = "\tNM:i:3\tAS:i:77\tXA:Z:chr2,-5,10M,1;\tZb:B:s,-4,9"
        lines.append(f"r{i}\t{flag}\t{chrom}\t{pos}\t37\t{cig}\t=\t"
                     f"{pos + 7}\t{l}\t{seq}\t{qual}{tags}")
    return lines


def _spread_lines(seed=0x5077, n=300):
    """Records over the whole of both contigs (every bucket of 16), with
    ties on (tid, pos) across strands, duplicates and unmapped reads."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        if i % 29 == 0:
            lines.append(f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\tACGTN\tIIIII")
            continue
        tid = int(rng.integers(0, 2))
        pos = int(rng.integers(1, ANNS[tid].len - 60)) if i % 7 else 1000
        flag = int(rng.choice([0, 16, 1024, 16 | 1024, 99, 147]))
        lines.append(f"q{i}\t{flag}\tchr{tid + 1}\t{pos}\t60\t50M\t*\t0\t0\t"
                     + "ACGT" * 12 + "AC\t" + "I" * 50 + "\tAS:i:50"
                     "\tZf:B:f,1.5,-2\tZc:B:C,1,255\tZh:H:1AE3\tZa:A:x"
                     "\tZg:f:0.25")
    return lines


def _encode(line: str) -> bytes:
    """One SAM line as a raw BAM record, by the port's encoder."""
    names = b"".join(a.name.encode() + b"\x00" for a in ANNS)
    return _build.host_module("_bam").sam_to_bam(line + "\n", names)


def test_sam_line_to_bam_equals_jax():
    for line in _lines() + _spread_lines():
        assert _encode(line) == jbam.sam_line_to_bam(line, NAMES), line


def test_decode_bam_records_and_reg2bin_equal_jax():
    """decode_bam_records, and the bin field of the encoder's records:
    the JAX package's reg2bin over spans of every bin level."""
    lines = _lines()
    data = bam.bam_header_bytes(ANNS, "@HD\tVN:1.6\n") + b"".join(
        _encode(l) for l in lines)
    assert data == jbam.bam_header_bytes(ANNS, "@HD\tVN:1.6\n") + b"".join(
        jbam.sam_line_to_bam(l, NAMES) for l in lines)
    assert bam.decode_bam_records(data) == jbam.decode_bam_records(data)
    rng = np.random.default_rng(0xB1)
    for beg in rng.integers(0, 1 << 29, 500):
        for span in (1, 100, 1 << 14, 1 << 17, 1 << 20, 1 << 23, 1 << 26):
            raw = _encode(f"b\t0\tchr1\t{int(beg) + 1}\t0\t{span}M\t*\t0"
                          "\t0\t*\t*")
            assert struct.unpack_from("<H", raw, 14)[0] == \
                jbam.reg2bin(int(beg), int(beg) + span)


@pytest.mark.parametrize("size", [1, 0xFF00, 3 * 0xFF00 + 17, 200_000])
def test_bgzf_compress_equals_jax(size):
    data = np.random.default_rng(size).integers(0, 8, size,
                                                dtype=np.uint8).tobytes()
    comp = bam.bgzf_compress(data)
    assert comp == jbam.bgzf_compress(data)
    assert bam.bgzf_decompress(comp + bam.BGZF_EOF) == data
    assert gzip.decompress(comp + bam.BGZF_EOF) == data
    assert bam.BGZF_EOF == jbam.BGZF_EOF


def test_bam_writer_equals_jax(tmp_path):
    sam = "@HD\tVN:1.6\n" + "\n".join(_lines() * 40) + "\n"
    for mod, name in ((bam, "mine.bam"), (jbam, "theirs.bam")):
        w = mod.BamWriter(str(tmp_path / name), ANNS, "@HD\tVN:1.6\n")
        w.write_sam_text(sam)
        w.close()
    mine = (tmp_path / "mine.bam").read_bytes()
    assert mine == (tmp_path / "theirs.bam").read_bytes()
    assert mine.endswith(bam.BGZF_EOF)
    assert len(gzip.decompress(mine)) > 2 * 0xFF00     # several blocks


def test_sort_key_from_raw_equals_jax():
    for line in _lines() + _spread_lines():
        raw = _encode(line)
        assert sort.sort_key_from_raw(raw) == jsort.sort_key_from_raw(raw)


def _bucket(mod, root: Path, lines, nb, drop):
    bs = mod.BucketSort(ANNS, str(root), num_buckets=nb, drop_dups=drop)
    for i in range(0, len(lines), 37):     # several SAM chunks
        bs.write_sam_text("\n".join(lines[i:i + 37]) + "\n")
    return bs.close()


@pytest.mark.parametrize("drop", [False, True], ids=["keep", "drop_dups"])
@pytest.mark.parametrize("nb", [4, 16])
def test_bucket_files_equal_jax(tmp_path, nb, drop):
    lines = _spread_lines() + _lines()
    mine = _bucket(sort, tmp_path / "mine", lines, nb, drop)
    theirs = _bucket(jsort, tmp_path / "theirs", lines, nb, drop)
    assert [Path(p).name for p in mine] == [Path(p).name for p in theirs]
    assert len(mine) == nb + 1
    n_recs = 0
    for a, b in zip(mine, theirs):
        assert Path(a).read_bytes() == Path(b).read_bytes(), a
        n_recs += len(jsort._load_sorted_bucket(a)[1])
    for b in range(nb):
        name = f"bucket-{b:06d}.bed"
        assert (tmp_path / "mine" / name).read_text() == \
            (tmp_path / "theirs" / name).read_text()
    n_dup = sum(1 for l in lines if int(l.split("\t")[1]) & 0x400)
    assert n_dup and n_recs == len(lines) - (n_dup if drop else 0)


@pytest.mark.parametrize("nb", [4, 16])
def test_merge_sorted_bam_equals_jax(tmp_path, nb):
    lines = _spread_lines() + _lines()
    hdr = "@HD\tVN:1.6\tSO:coordinate\n"
    paths = _bucket(sort, tmp_path / "b", lines, nb, False)
    lib = _build.host_module("_bam")
    for i, p in enumerate(paths):     # the loaded order of every bucket
        got, want = sort._load_sorted_bucket(p, lib), \
            jsort._load_sorted_bucket(p)
        assert got[0] == want[0], i
        assert [list(got[k]) for k in (1, 2, 3)] == \
            [list(want[k]) for k in (1, 2, 3)], i
    sort.merge_sorted_bam(paths, str(tmp_path / "mine.bam"), ANNS, hdr)
    jsort.merge_sorted_bam(paths, str(tmp_path / "theirs.bam"), ANNS, hdr)
    mine = gzip.decompress((tmp_path / "mine.bam").read_bytes())
    assert mine == gzip.decompress((tmp_path / "theirs.bam").read_bytes())
    text, refs, recs = bam.decode_bam_records(mine)
    assert text == hdr and refs == [("chr1", 5000), ("chr2", 3000)]
    assert len(recs) == len(lines)
    keys = [sort.sort_key_from_raw(r["raw"]) for r in recs]
    assert keys == sorted(keys) and recs[-1]["tid"] == -1


def test_sam_file_to_sorted_bam_equals_jax(tmp_path):
    sam = tmp_path / "in.sam"
    sam.write_text("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:5000\n@SQ\tSN:chr2\tLN:3000"
                   "\n@PG\tID:x\n" + "\n".join(_spread_lines()) + "\n")
    sort.sam_file_to_sorted_bam(str(sam), str(tmp_path / "mine.bam"), ANNS,
                                str(tmp_path / "t1"), num_buckets=8)
    jsort.sam_file_to_sorted_bam(str(sam), str(tmp_path / "theirs.bam"),
                                 ANNS, str(tmp_path / "t2"), num_buckets=8)
    mine = (tmp_path / "mine.bam").read_bytes()
    assert mine == (tmp_path / "theirs.bam").read_bytes()
    text, _, recs = bam.decode_bam_records(gzip.decompress(mine))
    assert text == "@HD\tVN:1.6\n@PG\tID:x\n" and len(recs) == 300
    flags = [struct.unpack_from("<H", r["raw"], 18)[0] for r in recs]
    assert any(f & 0x400 for f in flags)
