"""tail.sam_ms: milliseconds a batch the native tail spent in the SAM
records' text and the per-pair loads, on the C++ tail's steady clock:
the program's `tail.sam` counter over the window's batches."""


def read(rec: dict):
    n = rec["batches"]
    if not n or "tail.sam" not in rec["tracer"]:
        return None
    return 1e3 * rec["tracer"]["tail.sam"] / n
