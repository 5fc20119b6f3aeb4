"""device.idle_share: the share of the traced window in which no
kernel, copy or set ran on the card (1 minus the union of their
intervals in the profiler's trace, over the window)."""


def read(rec: dict):
    dev = rec.get("device")
    if not dev or dev["busy_s"] <= 0 or dev["window_s"] <= 0:
        return None
    return 1.0 - dev["busy_s"] / dev["window_s"]
