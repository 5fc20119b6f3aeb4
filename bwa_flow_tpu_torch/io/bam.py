"""BAM/BGZF encoding — htslib-equivalent output without htslib.

Port of bwa_flow_tpu/io/bam.py. The reference emits BAM via htslib
(sam_parse1 + bgzf, src/bwa_wrapper.cpp:452-591, BamFileBuffer
src/BamFileBuffer.h:14-142). This module implements the same on-disk
format directly: BGZF members (RFC1952 gzip + BSIZE extra field), the
BAM header, and SAM-line -> BAM record encoding (SAM spec §4.2), so the
writer stays dependency-free.

The writers encode and compress with the _bam host library
(csrc/host/_bam.cpp: batch encoder, threaded BGZF; byte-identical
records). The Python encoder here is its golden specification, taken
when the caller passes native=False or sets BWA_TPU_NO_NATIVE_BAM (the
JAX package's switch).
"""

from __future__ import annotations

import os
import struct
import zlib

from .. import _build

BGZF_THREADS = 4   # the _bam library's deflate threads a BGZF call
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OP = {c: i for i, c in enumerate("MIDNSHP=X")}


def native_bam(native: bool = True):
    """The _bam host library, or None when the caller asks for the
    Python encoder: native=False, or BWA_TPU_NO_NATIVE_BAM set."""
    if not native or os.environ.get("BWA_TPU_NO_NATIVE_BAM"):
        return None
    return _build.host_module("_bam")


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


def reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3 bin calculation."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


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


def _encode_tags(fields: list[str]) -> bytes:
    out = bytearray()
    for tag in fields:
        name, typ, val = tag.split(":", 2)
        out += name.encode()
        if typ == "i":
            v = int(val)
            if -(1 << 31) <= v < (1 << 31):
                out += b"i" + struct.pack("<i", v)
            else:
                raise ValueError(f"tag int out of range: {tag}")
        elif typ == "A":
            out += b"A" + val.encode()[:1]
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ == "Z":
            out += b"Z" + val.encode() + b"\x00"
        elif typ == "H":
            out += b"H" + val.encode() + b"\x00"
        elif typ == "B":
            sub = val.split(",")
            code = sub[0]
            nums = sub[1:]
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I", "f": "f"}[code]
            out += b"B" + code.encode() + struct.pack("<i", len(nums))
            conv = float if code == "f" else int
            for x in nums:
                out += struct.pack("<" + fmt, conv(x))
        else:
            raise ValueError(f"unsupported tag type {typ}")
    return bytes(out)


def _parse_cigar(cigar: str):
    ops = []
    n = 0
    for c in cigar:
        if c.isdigit():
            n = n * 10 + ord(c) - 48
        else:
            ops.append((n, _CIGAR_OP[c]))
            n = 0
    return ops


def sam_line_to_bam(line: str, name_to_tid) -> bytes:
    """Encode one SAM alignment line as a raw (uncompressed) BAM record,
    including the leading block_size."""
    f = line.rstrip("\n").split("\t")
    qname, flag, rname, pos, mapq, cigar = \
        f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5]
    rnext, pnext, tlen, seq, qual = f[6], int(f[7]), int(f[8]), f[9], f[10]
    tid = name_to_tid.get(rname, -1)
    mtid = tid if rnext == "=" else name_to_tid.get(rnext, -1)
    cig = [] if cigar == "*" else _parse_cigar(cigar)
    l_seq = 0 if seq == "*" else len(seq)
    rlen = sum(ln for ln, op in cig if op in (0, 2, 3, 7, 8)) or 1
    bin_ = reg2bin(pos - 1, pos - 1 + rlen) if pos > 0 else 4680
    name_b = qname.encode() + b"\x00"
    body = bytearray()
    body += struct.pack("<iiBBHHHiiii", tid, pos - 1, len(name_b), mapq,
                        bin_, len(cig), flag, l_seq, mtid, pnext - 1, tlen)
    body += name_b
    for ln, op in cig:
        body += struct.pack("<I", (ln << 4) | op)
    if l_seq:
        nib = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(seq):
            code = _SEQ_CODE.get(ch.upper(), 15)
            if i % 2 == 0:
                nib[i // 2] = code << 4
            else:
                nib[i // 2] |= code
        body += bytes(nib)
        if qual == "*":
            body += b"\xff" * l_seq
        else:
            body += bytes((min(max(ord(c) - 33, 0), 93) for c in qual))
    body += _encode_tags(f[11:])
    return struct.pack("<i", len(body)) + bytes(body)


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

    def __init__(self, path, anns, header_text: str = "",
                 native: bool = True):
        self._bam = native_bam(native)
        self.fh = open(path, "wb") if not hasattr(path, "write") else path
        self.name_to_tid = {ann.name: i for i, ann in enumerate(anns)}
        self._names = b"".join(a.name.encode() + b"\x00" for a in anns)
        self._buf = bytearray()
        self._write_raw(bam_header_bytes(anns, header_text))

    def _write_raw(self, data: bytes) -> None:
        self._buf += data
        n_full = (len(self._buf) // 0xFF00) * 0xFF00
        if not n_full:
            return
        if self._bam is not None:
            self.fh.write(self._bam.bgzf(bytes(self._buf[:n_full]), 6,
                                         BGZF_THREADS))
            del self._buf[:n_full]
            return
        while len(self._buf) >= 0xFF00:
            self.fh.write(bgzf_block(bytes(self._buf[:0xFF00])))
            del self._buf[:0xFF00]

    def write_sam_text(self, sam: str) -> None:
        if self._bam is not None:
            self._write_raw(self._bam.sam_to_bam(sam, self._names))
            return
        for line in sam.splitlines():
            if line and not line.startswith("@"):
                self._write_raw(sam_line_to_bam(line, self.name_to_tid))

    def write_record(self, raw: bytes) -> None:
        self._write_raw(raw)

    def close(self) -> None:
        if self._buf:
            self.fh.write(bgzf_block(bytes(self._buf)))
            self._buf.clear()
        self.fh.write(BGZF_EOF)
        self.fh.close()
