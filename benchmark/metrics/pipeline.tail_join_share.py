"""pipeline.tail_join_share: the share of the window the main thread
waited at the join of a batch's tail: the program's `tail_wait` span,
inside `emit_wait` and without the emit that follows the join."""


def read(rec: dict):
    w = rec["window_s"]
    if w <= 0 or "tail_wait" not in rec["tracer"]:
        return None
    return rec["tracer"]["tail_wait"] / w
