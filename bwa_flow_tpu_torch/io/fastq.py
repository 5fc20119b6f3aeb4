"""FASTQ/FASTA reading — the kseq.h + KseqsRead analog.

Chunked batch reading with a base-pair budget per batch (the reference
reads ~10 Mbp per pipeline record: actual_chunk_size,
src/Pipeline.cpp:98-163), gzip support, and paired-end
interleaving from two files (mirroring kseq_read_new + the smart-pairing
single-file mode, src/preprocess.cpp:333-372).
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from .sam import Read

_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    _NT4[ord(_ch)] = _i
    _NT4[ord(_ch.lower())] = _i


def _open(path):
    if str(path) == "-":
        import sys
        return sys.stdin.buffer
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def encode_seq(s: bytes) -> np.ndarray:
    return _NT4[np.frombuffer(s, dtype=np.uint8)].copy()


def read_seqs(path) -> Iterator[Read]:
    """Yield reads from FASTQ or FASTA (auto-detected, kseq semantics)."""
    fh = _open(path)
    first = fh.read(1)
    if not first:
        return
    if first == b">":  # FASTA
        head = fh.readline().rstrip(b"\r\n").split(None, 1)
        name = head[0].decode()
        comment = head[1].decode() if len(head) > 1 else None
        chunks: list[bytes] = []
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                yield Read(name=name, seq=encode_seq(b"".join(chunks)),
                           qual=None, comment=comment)
                head = line[1:].split(None, 1)
                name = head[0].decode()
                comment = head[1].decode() if len(head) > 1 else None
                chunks = []
            else:
                chunks.append(line)
        yield Read(name=name, seq=encode_seq(b"".join(chunks)),
                   qual=None, comment=comment)
        return
    assert first == b"@", f"not FASTA/FASTQ input: leading {first!r}"
    line = first + fh.readline()
    while line:
        head = line.rstrip(b"\r\n")[1:].split(None, 1)
        # kseq semantics: sequence may span multiple lines until '+'
        seq_parts: list[bytes] = []
        line = fh.readline()
        while line and not line.startswith(b"+"):
            seq_parts.append(line.rstrip(b"\r\n"))
            line = fh.readline()
        seq = b"".join(seq_parts)
        # quality accumulates until it covers the sequence length
        qual_parts: list[bytes] = []
        qlen = 0
        while qlen < len(seq):
            line = fh.readline()
            if not line:
                raise ValueError(
                    f"truncated FASTQ record '{head[0].decode()}': "
                    f"quality shorter than sequence")
            part = line.rstrip(b"\r\n")
            qual_parts.append(part)
            qlen += len(part)
        qual = b"".join(qual_parts)
        if len(qual) != len(seq):
            raise ValueError(
                f"malformed FASTQ record '{head[0].decode()}': "
                f"quality length {len(qual)} != sequence length {len(seq)}")
        yield Read(name=head[0].decode(), seq=encode_seq(seq),
                   qual=qual.decode() if qual else None,
                   comment=head[1].decode() if len(head) > 1 else None)
        line = fh.readline()


def _strip_mate_suffix(reads: list[Read]) -> None:
    """Drop /1 /2 name suffixes on pairs (kseq/bwa behavior)."""
    for r in reads:
        if len(r.name) > 2 and r.name[-2] == "/" and r.name[-1] in "12":
            r.name = r.name[:-2]


def read_batches(path1, path2=None, chunk_bp: int = 10_000_000,
                 interleaved: bool = False, start_id: int = 0
                 ) -> Iterator[list[Read]]:
    """Yield batches of reads up to ~chunk_bp bases (PE: interleaved in
    the batch, always an even count). Each batch's parse is the tracer's
    span `parse`, closed before the batch is yielded, so the time the
    consumer holds the generator suspended is not counted."""
    from ..utils.trace import GLOBAL as tracer
    it = _batches(path1, path2, chunk_bp, interleaved, start_id)
    while True:
        with tracer.span("parse"):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def _batches(path1, path2, chunk_bp: int, interleaved: bool, start_id: int
             ) -> Iterator[list[Read]]:
    n_id = start_id
    if path2 is not None:
        it1, it2 = read_seqs(path1), read_seqs(path2)
        batch: list[Read] = []
        bp = 0
        for r1 in it1:
            r2 = next(it2, None)
            if r2 is None:
                raise ValueError("paired FASTQs differ in length")
            batch += [r1, r2]
            bp += r1.l_seq + r2.l_seq
            if bp >= chunk_bp:
                _strip_mate_suffix(batch)
                for i, r in enumerate(batch):
                    r.id = n_id + i
                n_id += len(batch)
                yield batch
                batch, bp = [], 0
        if next(it2, None) is not None:
            raise ValueError("paired FASTQs differ in length")
        if batch:
            _strip_mate_suffix(batch)
            for i, r in enumerate(batch):
                r.id = n_id + i
            yield batch
        return
    batch = []
    bp = 0
    for r in read_seqs(path1):
        batch.append(r)
        bp += r.l_seq
        if bp >= chunk_bp and (not interleaved or len(batch) % 2 == 0):
            _strip_mate_suffix(batch)
            for i, r2 in enumerate(batch):
                r2.id = n_id + i
            n_id += len(batch)
            yield batch
            batch, bp = [], 0
    if batch:
        _strip_mate_suffix(batch)
        for i, r2 in enumerate(batch):
            r2.id = n_id + i
        yield batch
