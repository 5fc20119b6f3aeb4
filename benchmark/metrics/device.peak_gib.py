"""device.peak_gib: torch's `max_memory_allocated` on the card over
set-up and window, in GiB."""


def read(rec: dict):
    p = rec["peak_bytes"]
    return p / float(1 << 30) if p else None
