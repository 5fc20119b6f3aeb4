"""tail.pair_ms: milliseconds a batch the native tail spent in primary
marking, mem_pair and the paired/unpaired decision, on the C++ tail's
steady clock: the program's `tail.pair` counter over the window's
batches."""


def read(rec: dict):
    n = rec["batches"]
    if not n or "tail.pair" not in rec["tracer"]:
        return None
    return 1e3 * rec["tracer"]["tail.pair"] / n
