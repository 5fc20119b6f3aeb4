"""io.parse_offcpu_share: the share of the FASTQ parse's wall time in
which its thread was not on a CPU (waiting for the interpreter lock, for
the FIFO, or for a core): 1 minus the program's `parse.cpu` (the
thread's CPU seconds) over its `parse` span."""


def read(rec: dict):
    tr = rec["tracer"]
    wall = tr.get("parse", 0.0)
    if wall <= 0 or "parse.cpu" not in tr:
        return None
    return 1.0 - tr["parse.cpu"] / wall
