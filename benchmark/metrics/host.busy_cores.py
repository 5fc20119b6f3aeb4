"""host.busy_cores: CPU seconds of the aligner's process (all its
threads) and of its worker pool's processes, from /proc, over the
window's seconds. The read writers are not counted."""


def read(rec: dict):
    w = rec["window_s"]
    return rec["cpu_s"] / w if w > 0 else None
