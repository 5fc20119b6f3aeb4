"""pipeline.tail_wait_share: the share of the window the main thread
waited for a batch's tail (dedup, insert size, mate rescue, pairing and
SAM in the native tail thread). The program's `emit_wait` span holds the
join of the tail and the emit that follows it; the emit's own seconds
(the harness's span) are taken out."""


def read(rec: dict):
    w = rec["window_s"]
    if w <= 0 or "emit_wait" not in rec["tracer"]:
        return None
    return max(0.0, rec["tracer"]["emit_wait"] - rec["spans"]["emit"]) / w
