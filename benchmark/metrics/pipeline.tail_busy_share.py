"""pipeline.tail_busy_share: the share of the window the tail thread was
running a batch's tail (dedup, insert size, mate rescue, pairing and SAM;
one tail at a time): the program's `tail` span."""


def read(rec: dict):
    w = rec["window_s"]
    if w <= 0 or "tail" not in rec["tracer"]:
        return None
    return rec["tracer"]["tail"] / w
