#!/usr/bin/env python3
"""Sample one thread's scheduler state from /proc, from another process,
so that the sampling takes nothing from the sampled process's
interpreter lock.

    python3 benchmark/threadstate.py PID TID OUT PERIOD_S

reads /proc/PID/task/TID/stat every PERIOD_S seconds until it is
stopped (SIGTERM) or the thread ends, then writes OUT (.npz): `t`, the
CLOCK_MONOTONIC seconds of each sample, and `state`, the state letter's
byte (R: running or runnable; S, D: waiting, for a lock, a pipe, the
disk). The harness reads what share of the samples inside its parse
spans found the main thread waiting.
"""

from __future__ import annotations

import signal
import sys
import time

import numpy as np


class _Stop(Exception):
    pass


def _stop(signum, frame):
    raise _Stop()


def sample(pid: int, tid: int, out: str, period: float) -> None:
    signal.signal(signal.SIGTERM, _stop)
    path = f"/proc/{pid}/task/{tid}/stat"
    ts, st = [], []
    try:
        with open(path, "rb", buffering=0) as f:
            while True:
                f.seek(0)
                raw = f.read(512)
                ts.append(time.monotonic())
                st.append(raw[raw.rindex(b")") + 2])
                time.sleep(period)
    except (_Stop, OSError, ValueError):
        pass
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    np.savez(out, t=np.asarray(ts, np.float64), state=np.asarray(st, np.uint8))


def waiting_share(path, spans) -> tuple[float, int]:
    """The share of the samples inside the (start, end) spans that found
    the thread not running, and how many samples fell inside them."""
    with np.load(path) as z:
        t, state = z["t"], z["state"]
    if not len(spans) or not len(t):
        return 0.0, 0
    a = np.asarray(spans, np.float64)
    i = np.searchsorted(a[:, 0], t, side="right") - 1
    inside = (i >= 0) & (t <= a[np.maximum(i, 0), 1])
    n = int(inside.sum())
    if not n:
        return 0.0, 0
    return float((state[inside] != ord("R")).sum() / n), n


if __name__ == "__main__":
    if len(sys.argv) != 5:
        sys.exit(__doc__)
    sample(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
           float(sys.argv[4]))
