"""The port's native FASTQ/FASTA reader (`io/fastq.py::read_batches` over
`csrc/host/_fastq.cpp`) held to the JAX package's `read_batches`, batch
by batch and field by field: multi-line records, FASTA, CRLF, gzip (one
member and several), comments, mate suffixes, non-ACGT bases, paired
files, smart pairing, chunk boundaries, start ids, empty input, a FIFO
fed in small writes and standard input; the same exceptions for
malformed input; a reader closed while its writer is alive and silent;
the tracer's `parse.reader` and `parse.ready`."""

import dataclasses
import gzip
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from bwa_flow_tpu.io.fastq import read_batches as jax_read_batches
from bwa_flow_tpu_torch import _build
from bwa_flow_tpu_torch.io.fastq import read_batches
from bwa_flow_tpu_torch.io.sam import Read
from bwa_flow_tpu_torch.utils.trace import GLOBAL

ROOT = Path(__file__).resolve().parents[1]


def _fields(r):
    return (r.name, r.seq.tolist(), r.qual, r.comment, r.id, r.sam)


def _same(got, want):
    """Batches equal field by field; each seq a writable uint8 array."""
    assert [len(b) for b in got] == [len(b) for b in want]
    for bg, bw in zip(got, want):
        for g, w in zip(bg, bw):
            assert isinstance(g, Read)
            assert g.seq.dtype == np.uint8 and g.seq.ndim == 1
            assert g.seq.flags.writeable
            assert _fields(g) == _fields(w)


def _fq(recs, seq_w=None, crlf=False):
    """FASTQ text of (header, seq, qual) records, seq and qual cut into
    lines of seq_w."""
    eol = "\r\n" if crlf else "\n"
    out = []
    for head, seq, qual in recs:
        cut = (lambda s: [s[i:i + seq_w] for i in range(0, len(s), seq_w)]
               or [""]) if seq_w else (lambda s: [s])
        out += ["@" + head, *cut(seq), "+", *cut(qual)]
    return eol.join(out) + eol


def _fa(recs, w=None, crlf=False):
    eol = "\r\n" if crlf else "\n"
    out = []
    for head, seq in recs:
        out.append(">" + head)
        out += [seq[i:i + w] for i in range(0, len(seq), w)] if w else [seq]
    return eol.join(out) + eol


def _recs(rng, n, lo=40, hi=160, alphabet="ACGT", prefix="r"):
    out = []
    for i in range(n):
        k = int(rng.integers(lo, hi))
        seq = "".join(rng.choice(list(alphabet), k))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 41, k))
        out.append((f"{prefix}{i}", seq, qual))
    return out


def _case_files(case, d):
    """The input files and read_batches keywords of one case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    w = lambda name, text, mode="w": (  # noqa: E731
        (d / name).write_bytes(text) if mode == "wb"
        else (d / name).write_text(text), str(d / name))[1]
    if case == "multiline_fastq":
        recs = _recs(rng, 60)
        # quality lines that start with '@' and '+' still count as quality
        recs[3] = ("q3", "ACGTACGTAC", "@@@@@+++++")
        return [w("a.fq", _fq(recs, seq_w=37))], dict(chunk_bp=2000)
    if case == "multiline_fasta":
        recs = [(f"c{i} contig {i}", "".join(rng.choice(list("ACGT"), n)))
                for i, n in enumerate((0, 70, 71, 500, 3))]
        text = _fa(recs, w=70).replace(">c3", "\n>c3")  # a blank line
        return [w("a.fa", text)], dict(chunk_bp=100)
    if case == "crlf_fastq":
        return [w("a.fq", _fq(_recs(rng, 30), seq_w=50, crlf=True))], \
            dict(chunk_bp=700)
    if case == "crlf_fasta":
        recs = [(f"s{i}", "".join(rng.choice(list("ACGTN"), 90)))
                for i in range(8)]
        return [w("a.fa", _fa(recs, w=60, crlf=True))], dict(chunk_bp=200)
    if case == "gzip":
        data = gzip.compress(_fq(_recs(rng, 80)).encode())
        return [w("a.fq.gz", data, "wb")], dict(chunk_bp=3000)
    if case == "gzip_two_members":
        text = _fq(_recs(rng, 80)).encode()
        cut = len(text) // 2 + 7   # the second member starts mid-record
        data = gzip.compress(text[:cut]) + gzip.compress(text[cut:])
        return [w("a.fq.gz", data, "wb")], dict(chunk_bp=3000)
    if case == "comments":
        heads = ["a1 plain comment", "a2\tBC:Z:ACGT\tRG:Z:x",
                 "a3   three  spaces  ", " a4 leading space", "a5\t \tmixed",
                 "a6", "a7 ", "a8\x0bvt\x0cff"]
        recs = [(h, "ACGTAC", "IIIIII") for h in heads]
        return [w("a.fq", _fq(recs))], dict(chunk_bp=10)
    if case == "mate_suffixes":
        heads = ["p/1", "p/2", "q/3", "/1", "x/12", "r/1 c", "s/2\tBC:Z:A",
                 "t_1", "u/1/2"]
        recs = [(h, "ACGT", "IIII") for h in heads]
        return [w("a.fq", _fq(recs))], dict(chunk_bp=9)
    if case == "non_acgt":
        recs = _recs(rng, 40, alphabet="ACGTacgtNnRYKM.-*U")
        return [w("a.fq", _fq(recs))], dict(chunk_bp=1500)
    if case == "paired":
        r1 = _recs(rng, 51, prefix="p")
        r2 = [(h + "/2", s[::-1], q[::-1])
              for h, s, q in r1]
        r1 = [(h + "/1 BC:Z:AC", s, q) for h, s, q in r1]
        return [w("r1.fq", _fq(r1)), w("r2.fq", _fq(r2, seq_w=33))], \
            dict(chunk_bp=1234)
    if case == "interleaved_odd_boundary":
        recs = [(f"i{i // 2}/{1 + i % 2}", "A" * 10, "I" * 10)
                for i in range(22)]
        # 25 bp a chunk: the count is odd (3) where the bases reach it
        return [w("a.fq", _fq(recs))], dict(chunk_bp=25, interleaved=True)
    if case == "chunk_bp_1":
        recs = _recs(rng, 12)
        # an empty sequence has no quality line: the next line is a header
        text = _fq(recs[:5]) + "@empty\n\n+\n" + _fq(recs[5:])
        return [w("a.fq", text)], dict(chunk_bp=1)
    if case == "start_id":
        return [w("a.fq", _fq(_recs(rng, 33)))], \
            dict(chunk_bp=1000, start_id=1_000_003)
    if case == "empty":
        return [w("a.fq", "")], {}
    if case == "empty_paired":
        return [w("r1.fq", ""), w("r2.fq", "")], {}
    if case == "past_the_buffer":
        # lines across the reader's 1 MiB buffers, plain and gzip
        recs = _recs(rng, 9000, lo=100, hi=300)
        recs[4000] = ("long", "ACGT" * 400_000, "I" * 1_600_000)
        return [w("a.fq.gz", gzip.compress(_fq(recs).encode(), 1), "wb")], \
            dict(chunk_bp=400_000)
    if case == "past_the_buffer_plain":
        recs = [(f"chr{i}", "".join(rng.choice(list("ACGTN"), n)))
                for i, n in enumerate((1_500_000, 10, 2_300_000))]
        return [w("a.fa", _fa(recs))], dict(chunk_bp=10_000_000)
    raise KeyError(case)


CASES = ["multiline_fastq", "multiline_fasta", "crlf_fastq", "crlf_fasta",
         "gzip", "gzip_two_members", "comments", "mate_suffixes",
         "non_acgt", "paired", "interleaved_odd_boundary", "chunk_bp_1",
         "start_id", "empty", "empty_paired", "past_the_buffer",
         "past_the_buffer_plain"]


@pytest.mark.parametrize("case", CASES)
def test_batches_equal_the_jax_reader(tmp_path, case):
    paths, kw = _case_files(case, tmp_path)
    want = list(jax_read_batches(*paths, **kw))
    got = list(read_batches(*paths, **kw))
    _same(got, want)
    if case not in ("empty", "empty_paired"):
        assert got


def _slow_writer(fifo, data, step, pause):
    def run():
        with open(fifo, "wb", buffering=0) as f:
            for i in range(0, len(data), step):
                f.write(data[i:i + step])
                if pause:
                    time.sleep(pause)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("gz", [False, True])
def test_fifo_fed_in_small_writes(tmp_path, gz):
    rng = np.random.default_rng(0xF1F0 + gz)
    text = _fq(_recs(rng, 120), seq_w=61).encode()
    data = gzip.compress(text) if gz else text
    (tmp_path / "ref.fq").write_bytes(data)
    fifo = tmp_path / "in.fq"
    os.mkfifo(fifo)
    writer = _slow_writer(fifo, data, 7, 0.0)
    got = list(read_batches(str(fifo), chunk_bp=900))
    writer.join(10)
    assert not writer.is_alive()
    _same(got, list(jax_read_batches(str(tmp_path / "ref.fq"),
                                     chunk_bp=900)))


def test_standard_input(tmp_path):
    rng = np.random.default_rng(0x57D)
    (tmp_path / "a.fq").write_text(_fq(_recs(rng, 25)))
    code = ("import json, sys\n"
            "from bwa_flow_tpu_torch.io.fastq import read_batches\n"
            "print(json.dumps([[[r.name, r.seq.tolist(), r.qual, r.comment,"
            " r.id] for r in b] for b in read_batches('-', chunk_bp=500)]))\n")
    with open(tmp_path / "a.fq", "rb") as f:
        r = subprocess.run([sys.executable, "-c", code], stdin=f,
                           capture_output=True, text=True, timeout=120,
                           cwd=str(ROOT),
                           env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr[-3000:]
    want = [[[x.name, x.seq.tolist(), x.qual, x.comment, x.id] for x in b]
            for b in jax_read_batches(str(tmp_path / "a.fq"), chunk_bp=500)]
    assert json.loads(r.stdout) == want


def _error_files(case, d):
    good = _fq([(f"e{i}", "ACGTACGT", "IIIIIIII") for i in range(6)])
    if case == "truncated_quality":
        return [d / "a.fq"], good + "@bad\nACGTACGT\n+\nIII\n", {}
    if case == "truncated_no_plus":
        return [d / "a.fq"], good + "@bad\nACGTACGT\n", {}
    if case == "quality_longer":
        return [d / "a.fq"], good + "@bad\nACGT\n+\nIIIIII\n", {}
    if case == "paired_second_shorter":
        return [d / "r1.fq", d / "r2.fq"], (good, good.rsplit("@", 1)[0]), {}
    if case == "paired_second_longer":
        return [d / "r1.fq", d / "r2.fq"], (good, good + "@x\nA\n+\nI\n"), {}
    if case == "missing_file":
        return [d / "nothere.fq"], None, {}
    raise KeyError(case)


@pytest.mark.parametrize("chunk_bp", [1, 20, 10_000])
@pytest.mark.parametrize("case", ["truncated_quality", "truncated_no_plus",
                                  "quality_longer", "paired_second_shorter",
                                  "paired_second_longer", "missing_file"])
def test_malformed_input_raises_as_the_jax_reader(tmp_path, case, chunk_bp):
    """The same batches before the error, then the same exception type
    and message."""
    paths, text, _ = _error_files(case, tmp_path)
    if isinstance(text, tuple):
        for p, t in zip(paths, text):
            p.write_text(t)
    elif text is not None:
        paths[0].write_text(text)

    def drain(fn):
        out = []
        with pytest.raises(Exception) as e:
            for b in fn(*map(str, paths), chunk_bp=chunk_bp):
                out.append(b)
        return out, e.value
    got, gerr = drain(read_batches)
    want, werr = drain(jax_read_batches)
    _same(got, want)
    assert type(gerr) is type(werr)
    assert str(gerr) == str(werr)


def test_not_fasta_or_fastq_raises(tmp_path):
    (tmp_path / "a.txt").write_text("hello\n")
    with pytest.raises(ValueError, match="not FASTA/FASTQ input"):
        next(read_batches(str(tmp_path / "a.txt")))


def test_truncated_gzip_raises_eof(tmp_path):
    data = gzip.compress(_fq([("a", "ACGT" * 50, "I" * 200)] * 50).encode())
    (tmp_path / "a.fq.gz").write_bytes(data[:len(data) // 2])
    with pytest.raises(EOFError, match="end-of-stream marker"):
        list(read_batches(str(tmp_path / "a.fq.gz")))


def _live():
    return _build.host_module("_fastq").live_threads()


@pytest.mark.parametrize("how", ["close", "del"])
def test_closing_while_the_writer_is_silent(tmp_path, how):
    """The writer has sent one batch and holds its end open: closing the
    generator, or dropping it, returns at once and leaves no reader
    thread; the writer's descriptor stays its own."""
    fifo = tmp_path / "in.fq"
    os.mkfifo(fifo)
    first = _fq([("a", "ACGT", "IIII"), ("b", "ACGT", "IIII")]).encode()
    release = threading.Event()

    def writer():
        with open(fifo, "wb", buffering=0) as f:
            f.write(first)
            release.wait(30)
    t = threading.Thread(target=writer, daemon=True)
    t.start()
    base = _live()
    try:
        it = read_batches(str(fifo), chunk_bp=4)
        assert [r.name for r in next(it)] == ["a"]
        assert [r.name for r in next(it)] == ["b"]
        assert _live() == base + 1      # waiting in poll() for more
        t0 = time.monotonic()
        if how == "close":
            it.close()
        else:
            del it
        took = time.monotonic() - t0
        assert _live() == base
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive()
    assert took < 1.0


def test_reader_thread_starts_at_the_first_next(tmp_path):
    (tmp_path / "a.fq").write_text(_fq([("a", "ACGT", "IIII")]))
    base = _live()
    it = read_batches(str(tmp_path / "a.fq"))
    assert _live() == base
    assert [r.name for b in it for r in b] == ["a"]
    assert _live() == base


def test_many_readers_at_once(tmp_path):
    """More readers than cores, each on its own Python thread, switching
    often: every one yields exactly its file's batches, and every reader
    thread is gone after."""
    rng = np.random.default_rng(0x5EED)
    n = 2 * (os.cpu_count() or 4)
    for k in range(n):
        (tmp_path / f"{k}.fq").write_text(_fq(_recs(rng, 60 + k)))
    want = [[[_fields(r) for r in b]
             for b in jax_read_batches(str(tmp_path / f"{k}.fq"),
                                       chunk_bp=700 + 13 * k)]
            for k in range(n)]
    got = [None] * n
    base = _live()

    def one(k):
        got[k] = [[_fields(r) for r in b]
                  for b in read_batches(str(tmp_path / f"{k}.fq"),
                                        chunk_bp=700 + 13 * k)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=one, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == want
    assert _live() == base


def test_reader_counters(tmp_path):
    """`parse.reader` once a batch; `parse.ready` for each batch parsed
    ahead before its `next()` (all but the first, with a slow consumer)."""
    rng = np.random.default_rng(0xC0)
    (tmp_path / "a.fq").write_text(_fq(_recs(rng, 40)))
    n_reader, n_ready = GLOBAL.counts["parse.reader"], \
        GLOBAL.counts["parse.ready"]
    t_reader, t_ready = GLOBAL.totals["parse.reader"], \
        GLOBAL.totals["parse.ready"]
    n = 0
    for _ in read_batches(str(tmp_path / "a.fq"), chunk_bp=1000):
        n += 1
        time.sleep(0.05)
    assert n >= 4
    assert GLOBAL.counts["parse.reader"] - n_reader == n
    assert 0 < GLOBAL.totals["parse.reader"] - t_reader < 1.0
    assert GLOBAL.counts["parse.ready"] - n_ready == n - 1
    assert GLOBAL.totals["parse.ready"] - t_ready == n - 1


def test_read_fields_are_the_ones_the_reader_sets():
    """The reader sets Read's dataclass fields itself, in this order."""
    assert [f.name for f in dataclasses.fields(Read)] == \
        ["name", "seq", "qual", "comment", "id", "sam"]
