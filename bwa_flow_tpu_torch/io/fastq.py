"""FASTQ/FASTA reading — the kseq.h + KseqsRead analog.

Chunked batch reading with a base-pair budget per batch (the reference
reads ~10 Mbp per pipeline record: actual_chunk_size,
src/Pipeline.cpp:98-163), gzip support, and paired-end
interleaving from two files (mirroring kseq_read_new + the smart-pairing
single-file mode, src/preprocess.cpp:333-372).

The parse is native (`csrc/host/_fastq.cpp`), a reading stage of its own
as the reference's KseqsRead and bwa's kt_pipeline step 0: a thread that
never holds the interpreter lock parses the next batch while the
consumer holds this one. The JAX package's `bwa_flow_tpu.io.fastq` is
its specification, and `tests/test_torch_fastq.py` holds it there.
"""

from __future__ import annotations

import functools
import os
from typing import Iterator

import numpy as np

from .sam import Read

_seq_view = functools.partial(np.frombuffer, dtype=np.uint8)


def read_batches(path1, path2=None, chunk_bp: int = 10_000_000,
                 interleaved: bool = False, start_id: int = 0
                 ) -> Iterator[list[Read]]:
    """Yield batches of reads up to ~chunk_bp bases (PE: interleaved in
    the batch, always an even count); `-` reads standard input.

    A reader thread parses one batch ahead, from the first `next()` on,
    so one batch more is held in memory (tens of MB at the CLI's
    `chunk_size * n_threads`). A batch's `seq` arrays are views of one
    uint8 array. The tracer's span `parse` is the consumer's part of each
    `next()` (the wait and the `Read` objects), closed before the batch
    is yielded; `parse.reader` adds the thread's seconds on that batch,
    and `parse.ready` counts the batches complete when asked for.
    Closing the generator, or dropping it, stops and joins the thread.
    """
    from .._build import host_module
    from ..utils.trace import GLOBAL as tracer
    reader = host_module("_fastq").Reader(
        os.fspath(path1), None if path2 is None else os.fspath(path2),
        int(chunk_bp), bool(interleaved), int(start_id), Read, _seq_view)
    try:
        while True:
            with tracer.span("parse"):
                got = reader.next()
            if got is None:
                return
            batch, reader_s, ready = got
            tracer.add("parse.reader", reader_s)
            if ready:
                tracer.add("parse.ready", 1.0)
            yield batch
    finally:
        reader.close()
