"""kernels.seed_ms_per_batch: device milliseconds of the seed program's
four kernels (seed_p1p3, seed_fwd, seed_bwd, seed_cohort) a batch, from
the profiler's trace of the window."""

KERNELS = ("p1p3_kernel", "fwd_kernel", "bwd_kernel", "cohort_kernel")


def read(rec: dict):
    dev = rec.get("device")
    if not dev or not rec["batches"]:
        return None
    found = [v for k, v in dev["kernels"].items() if k in KERNELS]
    return 1e3 * sum(found) / rec["batches"] if found else None
