"""BAM/BGZF encoding — htslib-equivalent output without htslib.

Port of bwa_flow_tpu/io/bam.py. The reference emits BAM via htslib
(sam_parse1 + bgzf, src/bwa_wrapper.cpp:452-591, BamFileBuffer
src/BamFileBuffer.h:14-142). This module implements the same on-disk
format directly: BGZF members (RFC1952 gzip + BSIZE extra field), the
BAM header, and SAM-line -> BAM record encoding (SAM spec §4.2), so the
writer stays dependency-free.

The writers encode and compress with the _bam host library
(csrc/host/_bam.cpp: batch encoder, threaded BGZF). Its golden
specification is the JAX package's Python encoder
(bwa_flow_tpu/io/bam.py), which the tests hold its records to byte for
byte.
"""

from __future__ import annotations

import struct
import zlib

from .. import _build

BGZF_THREADS = 4   # the _bam library's deflate threads a BGZF call
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def bgzf_block(payload: bytes) -> bytes:
    """One BGZF member for <= 65536 bytes of payload."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    bsize = len(cdata) + 25 + 1
    assert bsize <= 0x10000
    head = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6,
                       66, 67, 2, bsize - 1)
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload))
    return head + cdata + tail


def bgzf_compress(data: bytes, block: int = 0xFF00) -> bytes:
    out = []
    for off in range(0, len(data), block):
        out.append(bgzf_block(data[off:off + block]))
    return b"".join(out)


def bgzf_decompress(data: bytes) -> bytes:
    """Inflate a BGZF stream (for tests / the merge phase)."""
    out = []
    off = 0
    while off < len(data):
        assert data[off:off + 2] == b"\x1f\x8b", "not a BGZF member"
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        extra = data[off + 12:off + 12 + xlen]
        bsize = None
        eoff = 0
        while eoff < len(extra):
            si1, si2, slen = extra[eoff], extra[eoff + 1], \
                struct.unpack_from("<H", extra, eoff + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, eoff + 4)[0] + 1
            eoff += 4 + slen
        assert bsize is not None
        cdata = data[off + 12 + xlen:off + bsize - 8]
        out.append(zlib.decompress(cdata, -15))
        off += bsize
    return b"".join(out)


def bam_header_bytes(anns, text: str = "") -> bytes:
    out = [b"BAM\x01", struct.pack("<i", len(text))]
    out.append(text.encode())
    out.append(struct.pack("<i", len(anns)))
    for ann in anns:
        name = ann.name.encode() + b"\x00"
        out.append(struct.pack("<i", len(name)))
        out.append(name)
        out.append(struct.pack("<i", ann.len))
    return b"".join(out)


def decode_bam_records(data: bytes):
    """Parse uncompressed BAM (post-header) records -> dict fields (for
    tests and the merge phase). Returns (header_text, refs, records)."""
    assert data[:4] == b"BAM\x01"
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = data[8:8 + l_text].decode()
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        name = data[off + 4:off + 4 + l_name - 1].decode()
        l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
        refs.append((name, l_ref))
        off += 8 + l_name
    recs = []
    while off < len(data):
        bs = struct.unpack_from("<i", data, off)[0]
        body = data[off + 4:off + 4 + bs]
        tid, pos, l_qname, mapq, bin_, n_cig, flag, l_seq, mtid, mpos, \
            tlen = struct.unpack_from("<iiBBHHHiiii", body, 0)
        qname = body[32:32 + l_qname - 1].decode()
        recs.append(dict(tid=tid, pos=pos, mapq=mapq, flag=flag,
                         l_seq=l_seq, mtid=mtid, mpos=mpos, tlen=tlen,
                         qname=qname, raw=data[off:off + 4 + bs]))
        off += 4 + bs
    return text, refs, recs


class BamWriter:
    """Streaming BGZF BAM writer (WriteOutput stage analog,
    src/Pipeline.cpp:828-892)."""

    def __init__(self, path, anns, header_text: str = ""):
        self._bam = _build.host_module("_bam")
        self.fh = open(path, "wb") if not hasattr(path, "write") else path
        self._names = b"".join(a.name.encode() + b"\x00" for a in anns)
        self._buf = bytearray()
        self._write_raw(bam_header_bytes(anns, header_text))

    def _write_raw(self, data: bytes) -> None:
        self._buf += data
        n_full = (len(self._buf) // 0xFF00) * 0xFF00
        if not n_full:
            return
        self.fh.write(self._bam.bgzf(bytes(self._buf[:n_full]), 6,
                                     BGZF_THREADS))
        del self._buf[:n_full]

    def write_sam_text(self, sam: str) -> None:
        self._write_raw(self._bam.sam_to_bam(sam, self._names))

    def write_record(self, raw: bytes) -> None:
        self._write_raw(raw)

    def close(self) -> None:
        if self._buf:
            self.fh.write(bgzf_block(bytes(self._buf)))
            self._buf.clear()
        self.fh.write(BGZF_EOF)
        self.fh.close()
