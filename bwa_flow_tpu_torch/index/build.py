"""Reference index construction (``bwa index`` equivalent).

Produces the same artifacts as the reference's offline index build
(bwa/bwtindex.c:256-324: pac encode, BWT over forward+RC, occ interleave,
SA sampling) from a FASTA, as in-memory objects and optionally as
bwa-compatible files so stock indexes interoperate both ways.
"""

from __future__ import annotations

import gzip
import io as _io

import numpy as np

from .. import _build
from .fmindex import Amb, Annotation, FMIndex, ReferenceMeta, pack_pac, unpack_pac
from .rand48 import Rand48
from .suffix import bwt_from_sa

_NT4 = np.full(256, 4, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    _NT4[ord(ch)] = i
    _NT4[ord(ch.lower())] = i

SA_INTV = 32  # bwa default (bwtindex.c:317)


def parse_fasta(path_or_bytes) -> list[tuple[str, str, bytes]]:
    """Returns [(name, comment, seq_bytes)] per contig."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        fh = _io.BytesIO(bytes(path_or_bytes))
    else:
        fh = gzip.open(path_or_bytes, "rb") if str(path_or_bytes).endswith(".gz") \
            else open(path_or_bytes, "rb")
    out = []
    name = None
    comment = ""
    chunks: list[bytes] = []
    with fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, comment, b"".join(chunks)))
                hdr = line[1:].split(None, 1)
                name = hdr[0].decode()
                comment = hdr[1].decode() if len(hdr) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, comment, b"".join(chunks)))
    return out


def encode_reference(contigs: list[tuple[str, str, bytes]]) -> tuple[ReferenceMeta, np.ndarray]:
    """FASTA contigs -> (ReferenceMeta, forward 2-bit base array).

    Ambiguous bases are replaced with lrand48()&3 after srand48(11), and N
    runs recorded as holes, exactly like the reference (bwa/bntseq.c:227-296).
    """
    rng = Rand48(11)
    anns: list[Annotation] = []
    ambs: list[Amb] = []
    parts: list[np.ndarray] = []
    offset = 0
    for name, comment, seq in contigs:
        raw = np.frombuffer(seq, dtype=np.uint8)
        code = _NT4[raw].copy()
        n_ambs = 0
        amb_mask = code >= 4
        if amb_mask.any():
            idx = np.nonzero(amb_mask)[0]
            # group runs of identical raw ambiguity characters (the reference
            # merges runs only when the raw char repeats, bntseq.c:244)
            run_start = 0
            for t in range(1, len(idx) + 1):
                if (t == len(idx) or idx[t] != idx[t - 1] + 1
                        or raw[idx[t]] != raw[idx[t - 1]]):
                    ambs.append(Amb(offset=offset + int(idx[run_start]),
                                    len=int(t - run_start),
                                    amb=chr(raw[idx[run_start]])))
                    n_ambs += 1
                    run_start = t
            # deterministic random fill, in sequence order
            fill = np.fromiter((rng.lrand48() & 3 for _ in range(len(idx))),
                               dtype=np.uint8, count=len(idx))
            code[idx] = fill
        anns.append(Annotation(name=name, anno=comment if comment else "(null)",
                               offset=offset, len=len(seq), n_ambs=n_ambs))
        # bwa stores "(null)" for empty comments when building, and writes
        # the anno only if non-empty at dump time; we keep the literal.
        parts.append(code)
        offset += len(seq)
    fwd = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
    bns = ReferenceMeta(l_pac=offset, anns=anns, ambs=ambs, pac=pack_pac(fwd))
    return bns, fwd


def suffix_array_sais(both: np.ndarray) -> np.ndarray:
    """Suffix array of `both` + sentinel (int64[n+1], out[0] == n) by
    the native SA-IS (csrc/host/sais_impl.h), at any scale: the
    reference needs two programs, is.c for short references and the
    blockwise bwt_gen.c for Gbp (bwa/bwtindex.c:210-324).
    suffix.suffix_array (NumPy prefix doubling) is its oracle."""
    nat = _build.host_module("_native")
    return np.frombuffer(
        nat.sais(np.ascontiguousarray(both, np.uint8), 4), np.int64)


def build_index(contigs: list[tuple[str, str, bytes]], sa_intv: int = SA_INTV) -> FMIndex:
    bns, fwd = encode_reference(contigs)
    both = np.concatenate([fwd, (3 - fwd)[::-1]])  # forward + reverse complement
    del fwd
    sa_full = suffix_array_sais(both)
    samples = sa_full[::sa_intv].astype(np.int64).copy()
    samples[0] = -1  # bwa sentinel (bwa/bwt.c:83)
    bwt, primary = bwt_from_sa(both, sa_full)
    # human-scale frees: the SA (8 B/symbol) and text must not stay live
    # through the occ-block build's own temporaries
    del sa_full, both
    return FMIndex.from_bwt(bwt, primary, sa_intv, samples, bns=bns)


def index_fasta(path) -> FMIndex:
    return build_index(parse_fasta(path))
