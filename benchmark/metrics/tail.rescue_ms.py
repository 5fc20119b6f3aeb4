"""tail.rescue_ms: milliseconds a batch the native tail spent in mate
rescue (ksw_align2 in the window the insert size gives), on the C++
tail's steady clock: the program's `tail.rescue` counter over the
window's batches."""


def read(rec: dict):
    n = rec["batches"]
    if not n or "tail.rescue" not in rec["tracer"]:
        return None
    return 1e3 * rec["tracer"]["tail.rescue"] / n
