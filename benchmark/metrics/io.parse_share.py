"""io.parse_share: the share of the window the main thread spent in
`io.fastq.read_batches` (the harness's span around each `next()` of the
batch iterator; the FIFO writers stay ahead, see the writers' line)."""


def read(rec: dict):
    w = rec["window_s"]
    return rec["spans"]["parse"] / w if w > 0 else None
