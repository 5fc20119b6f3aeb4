"""host_ext.wait_share: the share of the window the main thread waited
at the join of a batch's chaining and extension (the native route's
worker thread and its harvesters): the program's `extend_waves` span."""


def read(rec: dict):
    w = rec["window_s"]
    if w <= 0 or "extend_waves" not in rec["tracer"]:
        return None
    return rec["tracer"]["extend_waves"] / w
