"""Bucket-partitioned sorting and sorted-BAM merge (two-phase design).

Port of bwa_flow_tpu/pipeline/sort.py. Bucket writes, the bucket scan
and the merge's gather run in the _bam host library (csrc/host/_bam.cpp).

Phase 1 (during alignment): BucketSort partitions finished alignments into
`num_buckets` genome-position buckets, each a self-contained temp file plus
a .bed interval file — the reference's restartable artifact boundary
(BucketSortStage, src/BucketSortStage.cpp:43-164).

Phase 2 (after alignment): each bucket is loaded, sorted in memory by the
samtools key ((tid<<32|pos+1)<<1|is_rev — bam1_lt,
src/Pipeline.cpp:31-42), and appended to the output BAM
(IndexGen -> BamRead -> BamSort -> BamWrite pipeline,
src/Bam*Stage.cpp). Unmapped reads go to the final bucket.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import _build
from ..io.bam import BamWriter


def sort_key_from_raw(raw: bytes) -> int:
    """bam1_lt key from a raw BAM record (tid, pos, strand)."""
    tid, pos = struct.unpack_from("<ii", raw, 4)
    flag = struct.unpack_from("<H", raw, 18)[0]
    utid = tid & 0xFFFFFFFF  # -1 (unmapped) sorts last
    return (((utid << 32) | (pos + 1)) << 1) | ((flag >> 4) & 1)


class BucketSort:
    """Partition SAM output into genome buckets (BucketSortStage analog)."""

    def __init__(self, anns, temp_dir: str, num_buckets: int = 64,
                 drop_dups: bool = False, filter_unmap: bool = False):
        self._bam = _build.host_module("_bam")
        self.anns = anns
        self.temp_dir = temp_dir
        os.makedirs(temp_dir, exist_ok=True)
        self.n = num_buckets
        self.drop_dups = drop_dups
        self.filter_unmap = filter_unmap
        self.acc = [0]
        for a in anns:
            self.acc.append(self.acc[-1] + a.len)
        self._names = b"".join(a.name.encode() + b"\x00" for a in anns)
        self._acc64 = np.asarray(self.acc, np.int64).tobytes()
        total = self.acc[-1]
        self.bucket_size = (total + num_buckets - 1) // num_buckets
        self.files = [open(os.path.join(temp_dir, f"bucket-{i:06d}.bamr"),
                           "wb") for i in range(num_buckets + 1)]
        self._write_beds()

    def _write_beds(self) -> None:
        """Per-bucket interval files (get_intervals,
        BucketSortStage.cpp:11-41)."""
        for b in range(self.n):
            lo = b * self.bucket_size
            hi = min((b + 1) * self.bucket_size, self.acc[-1])
            lines = []
            for i, a in enumerate(self.anns):
                s = max(lo, self.acc[i])
                e = min(hi, self.acc[i + 1])
                if s < e:
                    lines.append(f"{a.name}\t{s - self.acc[i]}"
                                 f"\t{e - self.acc[i]}\n")
            with open(os.path.join(self.temp_dir,
                                   f"bucket-{b:06d}.bed"), "w") as f:
                f.writelines(lines)

    def write_sam_text(self, sam: str) -> None:
        chunks = self._bam.sam_to_bam_bucketed(
            sam, self._names, self._acc64, self.bucket_size, self.n,
            self.drop_dups, self.filter_unmap)
        for b, raw in enumerate(chunks):
            if raw:
                self.files[b].write(raw)

    def close(self) -> list[str]:
        for f in self.files:
            f.close()
        return [os.path.join(self.temp_dir, f"bucket-{i:06d}.bamr")
                for i in range(self.n + 1)]


def _load_sorted_bucket(path: str, bam):
    """Read one bucket file and compute its stable sort order on the
    (tid, pos, strand) key, scanned by `bam`, the _bam library. Memory is
    bounded by the bucket size (output_size / num_buckets), the same
    bounded-memory property as the reference's per-bucket mergesort
    (BamSortStage.cpp:6-36)."""
    with open(path, "rb") as f:
        data = f.read()
    rows = np.frombuffer(bam.scan_records(data), np.int64).reshape(-1, 5)
    if len(rows):
        order = np.lexsort((rows[:, 4], rows[:, 3], rows[:, 2]))
        return data, rows[:, 0], rows[:, 1], order
    return data, rows[:, 0], rows[:, 1], []


def merge_sorted_bam(bucket_paths: list[str], out_path: str, anns,
                     header_text: str = "") -> None:
    """Phase-2 pipeline: per-bucket stable sort + streamed write, with
    the next bucket loading/sorting in a background thread while the
    current one compresses — the BamRead -> BamSort -> BamWrite stage
    pipeline (src/Bam*Stage.cpp) collapsed to a two-deep prefetch."""
    w = BamWriter(out_path, anns, header_text)
    bam = w._bam
    with ThreadPoolExecutor(max_workers=1) as ex:
        nxt = ex.submit(_load_sorted_bucket, bucket_paths[0], bam) \
            if bucket_paths else None
        for i in range(len(bucket_paths)):
            data, offs, lens, order = nxt.result()
            nxt = ex.submit(_load_sorted_bucket, bucket_paths[i + 1], bam) \
                if i + 1 < len(bucket_paths) else None
            if len(order):
                o = np.asarray(order)
                so = np.ascontiguousarray(np.asarray(offs, np.int64)[o])
                sl = np.ascontiguousarray(np.asarray(lens, np.int64)[o])
                w.write_record(bam.gather(data, so.tobytes(), sl.tobytes()))
    w.close()


def sam_file_to_sorted_bam(sam_path: str, out_path: str, anns,
                           temp_dir: str, num_buckets: int = 64) -> None:
    """Convenience: sort an existing SAM file into a coordinate-sorted BAM."""
    header_lines = []
    bs = BucketSort(anns, temp_dir, num_buckets)
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                header_lines.append(line)
            else:
                bs.write_sam_text(line)
    buckets = bs.close()
    hdr = "".join(l for l in header_lines if not l.startswith("@SQ"))
    merge_sorted_bam(buckets, out_path, anns, hdr)
