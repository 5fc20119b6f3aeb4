"""io.emit_share: the share of the window the main thread spent in the
emit (markdup's `process`, then each record's SAM written): the
harness's span around each call."""


def read(rec: dict):
    w = rec["window_s"]
    return rec["spans"]["emit"] / w if w > 0 else None
