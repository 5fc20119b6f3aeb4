"""tail.dedup_ms: milliseconds a batch the native tail spent in phase 1's
region dedup and ALT flags, and the batch's insert-size estimate, on the
C++ tail's steady clock: the program's `tail.dedup` counter over the
window's batches."""


def read(rec: dict):
    n = rec["batches"]
    if not n or "tail.dedup" not in rec["tracer"]:
        return None
    return 1e3 * rec["tracer"]["tail.dedup"] / n
