"""host_ext.busy_share: the share of the window the native route's
extension worker was running a batch (C++ chaining, the wave driver and
its harvesters): the program's `extend` span."""


def read(rec: dict):
    w = rec["window_s"]
    if w <= 0 or "extend" not in rec["tracer"]:
        return None
    return rec["tracer"]["extend"] / w
