"""The one read generator: every traffic mix is a file of its parameters.

A mix (`benchmark/traffic/<name>.json`) gives the layout (`se` or `pe`),
the read length, the reads a batch, the sequencing error rate, the
mutation model (wgsim's `-r -R -X`: the rate of mutated sites, the share
of them that are indels, the chance that an indel grows by one more
base), the fragment length distribution of pairs and the share of
fragments that are exact duplicates of an earlier fragment of the
stream, from any earlier batch.

A stream is drawn batch after batch (`Batches`): batch `b` of stream
`stream` comes from (seed, stream, b) and the batches before it (the
sources of its duplicates), so a writer process and the harness's
reference draw the same reads without talking to each other. Stream 0
is the measured stream, stream 1 the warm-up stream. Read names are
fixed width: `<prefix><10 digits>`, the fragment's index in its stream.

    python3 benchmark/readgen.py --writer GENOME MIX SEED STREAM MATE FIFO STATS

writes mate MATE (0 for single-end) of the stream into the FIFO as
FASTQ, batch after batch, until it is stopped (SIGTERM or a closed
reader), then writes its own timings to STATS.
"""

from __future__ import annotations

import fcntl
import json
import os
import signal
import sys
import termios
import time

import numpy as np

COMP = np.array([3, 2, 1, 0], np.uint8)
BASES = np.frombuffer(b"ACGT", np.uint8)
PREFIX = {0: b"r", 1: b"w"}       # stream -> read name prefix
NAME_DIGITS = 10
PAD = 64                          # genome bases beyond a fragment: deletions
MARGIN = 64                       # a read's truth window beyond its span
MAX_INDEL = 32
END = 32                          # bases at a fragment's end (end_indel)
F_SETPIPE_SZ = 1031


def frags_per_batch(mix: dict) -> int:
    n = int(mix["batch_reads"])
    return n // 2 if mix["layout"] == "pe" else n


def batch_rng(seed: int, stream: int, b: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), stream, b])


def _geometric_len(rng, ext: float, n: int) -> np.ndarray:
    return np.minimum(rng.geometric(1.0 - ext, n), MAX_INDEL)


def make_batch(genome: np.ndarray, mix: dict, seed: int, stream: int,
               b: int) -> dict:
    """Batch b before its duplicates are copied in: reads (n, L) symbols
    as written (PE: mates interleaved), `rev` (read is the reverse
    complement of the forward genome), `lo`/`hi` (the genome window the
    read came from, margins included), `span` (the genome bases from the
    fragment's first base to its last, -1 where an end is an inserted
    base), `indel` (its fragment carries an indel), `end_indel` (one
    within END bases of an end of the fragment), `dup_of` (the stream
    index of a fragment's source, -1 if none; copied in by `Batches`)
    and `frag0` (the stream index of the batch's first fragment)."""
    rng = batch_rng(seed, stream, b)
    L = int(mix["read_len"])
    pe = mix["layout"] == "pe"
    n = frags_per_batch(mix)
    G = len(genome)
    if pe:
        mean, sd = float(mix["frag_mean"]), float(mix["frag_sd"])
        fmax = int(mean + 6 * sd)
        flen = np.clip(np.rint(rng.normal(mean, sd, n)), L, fmax
                       ).astype(np.int64)
    else:
        fmax = L
        flen = np.full(n, L, np.int64)
    width = fmax + PAD
    pos = rng.integers(MARGIN, G - width - MARGIN, n)
    frag = np.asarray(genome[pos[:, None] + np.arange(width)], np.uint8)
    span = flen.copy()
    # wgsim's mutations: sites at rate mut_rate, a share of them indels
    n_mut = rng.binomial(flen, float(mix["mut_rate"]))
    f_idx = np.repeat(np.arange(n), n_mut)
    off = (rng.random(len(f_idx)) * flen[f_idx]).astype(np.int64)
    is_indel = rng.random(len(f_idx)) < float(mix["indel_frac"])
    sub = ~is_indel
    frag[f_idx[sub], off[sub]] = (frag[f_idx[sub], off[sub]]
                                  + rng.integers(1, 4, int(sub.sum()))) & 3
    ilen = _geometric_len(rng, float(mix["indel_ext"]), int(is_indel.sum()))
    ins = rng.random(len(ilen)) < 0.5
    indel = np.zeros(n, bool)
    real = np.full(n, width, np.int64)    # genome bases left in a row
    order = np.lexsort((-off[is_indel], f_idx[is_indel]))
    fi, oi = f_idx[is_indel][order], off[is_indel][order]
    ilen, ins = ilen[order], ins[order]
    coord = {}                       # a row's genome offsets, -1 inserted
    for k in range(len(fi)):         # a few a batch: one row at a time
        f, o, ln = int(fi[k]), int(oi[k]), int(ilen[k])
        row = frag[f]
        c = coord.get(f, np.arange(width))
        if ins[k]:
            row = np.concatenate([row[:o], rng.integers(0, 4, ln).astype(
                np.uint8), row[o:]])[:width]
            c = np.concatenate([c[:o], np.full(ln, -1), c[o:]])[:width]
            real[f] = min(width, real[f] + ln)
        else:
            if real[f] - ln < flen[f]:
                continue
            row = np.concatenate([row[:o], row[o + ln:],
                                  np.zeros(ln, np.uint8)])
            c = np.concatenate([c[:o], c[o + ln:], np.full(ln, -1)])
            real[f] -= ln
        frag[f] = row
        coord[f] = c
        indel[f] = True
    for f, c in coord.items():
        first, last = int(c[0]), int(c[flen[f] - 1])
        span[f] = last - first + 1 if first >= 0 and last >= 0 else -1
    # an indel this near a fragment's end may be clipped away with it
    near = (oi < END) | (oi >= flen[fi] - END)
    end_indel = np.zeros(n, bool)
    end_indel[fi[near]] = True
    cols = np.arange(L)
    if pe:
        a = frag[:, :L]
        tail = frag[np.arange(n)[:, None], (flen - L)[:, None] + cols]
        bm = COMP[tail[:, ::-1]]
        flip = rng.random(n) < 0.5
        m1 = np.where(flip[:, None], bm, a)
        m2 = np.where(flip[:, None], a, bm)
        reads = np.empty((2 * n, L), np.uint8)
        reads[0::2], reads[1::2] = m1, m2
        rev = np.empty(2 * n, bool)
        rev[0::2], rev[1::2] = flip, ~flip
    else:
        reads = frag[:, :L].copy()
        rev = rng.random(n) < 0.5
        reads[rev] = COMP[reads[rev][:, ::-1]]
    err = rng.random(reads.shape) < float(mix["sub_rate"])
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) & 3
    per = 2 if pe else 1
    lo = np.repeat(pos - MARGIN, per)
    hi = np.repeat(pos + flen + PAD + MARGIN, per)
    dup_of = np.full(n, -1, np.int64)
    frag0 = b * n
    n_dup = int(rng.binomial(n, float(mix.get("dup_frac", 0.0))))
    if n_dup:
        dst = np.sort(rng.choice(np.arange(1 if b == 0 else 0, n),
                                 min(n_dup, n - (b == 0)), replace=False))
        # the source: any earlier fragment of the stream
        dup_of[dst] = (rng.random(len(dst)) * (frag0 + dst)).astype(np.int64)
    return dict(reads=reads, rev=rev, lo=lo, hi=hi, span=span, indel=indel,
                end_indel=end_indel, dup_of=dup_of, frag0=frag0, per=per)


_ROW = ("reads", "rev", "lo", "hi")     # one entry a read
_FRAG = ("span", "indel", "end_indel")  # one entry a fragment


class Batches:
    """The batches of one stream in order, each with its duplicates
    copied in from their sources, in this batch or an earlier one (kept
    here while the mix has duplicates)."""

    def __init__(self, genome, mix: dict, seed: int, stream: int):
        self.genome, self.mix, self.seed, self.stream = \
            genome, mix, seed, stream
        self.n = frags_per_batch(mix)
        self.keep = float(mix.get("dup_frac", 0.0)) > 0
        self.done: list = []

    def __iter__(self):
        b = 0
        while True:
            yield self.batch(b)
            b += 1

    def batch(self, b: int) -> dict:
        """Batch b (each batch once, in order, when the mix has
        duplicates)."""
        bt = make_batch(self.genome, self.mix, self.seed, self.stream, b)
        per, n = bt["per"], self.n
        for d in np.flatnonzero(bt["dup_of"] >= 0):   # ascending
            s = int(bt["dup_of"][d])
            sb, sj = divmod(s, n)
            src = bt if sb == b else self.done[sb]
            for k in _ROW:
                bt[k][per * d:per * d + per] = src[k][per * sj:per * sj + per]
            for k in _FRAG:
                bt[k][d] = src[k][sj]
        if self.keep:
            assert b == len(self.done), "a stream with duplicates is drawn in order"
            self.done.append({k: bt[k] for k in _ROW + _FRAG})
        return bt


def places(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """For each fragment (the window `lo`/`hi` of its first read), the
    id of the group of fragments that came from the same place of the
    genome (the same start and length), or -1 where it is alone."""
    _, inv, cnt = np.unique(np.asarray(lo) * (1 << 24)
                            + (np.asarray(hi) - np.asarray(lo)),
                            return_inverse=True, return_counts=True)
    return np.where(cnt[inv] > 1, inv, -1)


def names(stream: int, frag0: int, n: int) -> np.ndarray:
    """(n, 11) bytes of the names of fragments frag0 .. frag0+n-1."""
    idx = frag0 + np.arange(n, dtype=np.int64)
    out = np.empty((n, 1 + NAME_DIGITS), np.uint8)
    out[:, 0] = PREFIX[stream][0]
    for k in range(NAME_DIGITS):
        out[:, NAME_DIGITS - k] = 48 + (idx // 10 ** k) % 10
    return out


def name_str(stream: int, frag: int) -> str:
    return PREFIX[stream].decode() + str(frag).zfill(NAME_DIGITS)


def fastq_bytes(batch: dict, stream: int, mate: int) -> bytes:
    """The FASTQ text of one mate (0 for single-end) of a batch."""
    per = batch["per"]
    reads = batch["reads"][mate::per]
    n, L = reads.shape
    nm = names(stream, batch["frag0"], n)
    w = 1 + nm.shape[1] + 1 + L + 3 + L + 1
    rec = np.empty((n, w), np.uint8)
    c = 0
    rec[:, c] = ord("@")
    c += 1
    rec[:, c:c + nm.shape[1]] = nm
    c += nm.shape[1]
    rec[:, c] = 10
    c += 1
    rec[:, c:c + L] = BASES[reads]
    c += L
    rec[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    c += 3
    rec[:, c:c + L] = ord("I")
    c += L
    rec[:, c] = 10
    return rec.tobytes()


class _Stop(Exception):
    pass


def _stop(signum, frame):
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    raise _Stop()


def writer(genome_path: str, mix_path: str, seed: int, stream: int,
           mate: int, fifo: str, stats_path: str) -> None:
    """Write mate `mate` of the stream into `fifo`, batch after batch,
    until stopped. Counts the seconds spent making batches, the seconds
    blocked on a full FIFO (the writer was ahead), and the writes that
    found the FIFO empty (the reader may have waited)."""
    signal.signal(signal.SIGTERM, _stop)
    st = {"batches": 0, "gen_s": 0.0, "blocked_s": 0.0, "empty_writes": 0,
          "writes": 0}
    try:
        genome = np.load(genome_path, mmap_mode="r")
        with open(mix_path) as f:
            mix = json.load(f)
        with open(fifo, "wb", buffering=0) as out:
            _write(out.fileno(), genome, mix, seed, stream, mate, st)
    except (_Stop, BrokenPipeError):
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    with open(stats_path, "w") as f:
        json.dump(st, f)


def _write(fd: int, genome, mix: dict, seed: int, stream: int, mate: int,
           st: dict) -> None:
    try:
        fcntl.fcntl(fd, F_SETPIPE_SZ, 1 << 20)
    except OSError:
        pass
    buf = bytearray(4)
    b = 0
    gen = iter(Batches(genome, mix, seed, stream))
    while True:
        t0 = time.perf_counter()
        data = memoryview(fastq_bytes(next(gen), stream, mate))
        st["gen_s"] += time.perf_counter() - t0
        while data:
            fcntl.ioctl(fd, termios.FIONREAD, buf)
            if int.from_bytes(buf, sys.byteorder) == 0 and b > 0:
                st["empty_writes"] += 1
            st["writes"] += 1
            t0 = time.perf_counter()
            k = os.write(fd, data[:1 << 18])
            st["blocked_s"] += time.perf_counter() - t0
            data = data[k:]
        st["batches"] += 1
        b += 1


if __name__ == "__main__":
    if len(sys.argv) == 9 and sys.argv[1] == "--writer":
        a = sys.argv[2:]
        writer(a[0], a[1], int(a[2]), int(a[3]), int(a[4]), a[5], a[6])
    else:
        sys.exit(__doc__)
