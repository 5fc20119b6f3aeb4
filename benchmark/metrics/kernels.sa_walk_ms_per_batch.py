"""kernels.sa_walk_ms_per_batch: device milliseconds of the LF walk's
kernel (sa_walk) a batch, from the profiler's trace of the window. It
runs in the window only on an index without a dense SA (a BWT above
2^28 rows); elsewhere there is nothing to read."""


def read(rec: dict):
    dev = rec.get("device")
    if not dev or not rec["batches"]:
        return None
    t = dev["kernels"].get("sa_walk_kernel")
    return 1e3 * t / rec["batches"] if t else None
