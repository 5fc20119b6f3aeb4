"""io.parse_ready_share: the share of the window's batches that the FASTQ
reader thread had parsed before the main thread asked for them: the
program's `parse.ready` count over the batches handed. Nothing where the
program has no reader thread (no `parse.reader`)."""


def read(rec: dict):
    n = rec["batches"]
    tr = rec["tracer"]
    if not n or "parse.reader" not in tr:
        return None
    return tr.get("parse.ready", 0.0) / n
