"""Per-stage wall-clock and CPU-time span tracing (the reference's VLOG
span pattern).

The reference logs microsecond spans around every stage compute and every
FPGA phase (getUs() + VLOG, src/util.h:33-38,
src/Pipeline.cpp:145-150, src/fpga/FPGAPipeline.cpp:557-579) and sums them
offline (bin/profile.sh). Here spans accumulate in-process per stage name,
from any thread: `totals[stage]` holds the wall seconds and
`totals[stage + ".cpu"]` the CPU seconds of the thread that opened the
span; `add` takes time measured elsewhere (the native tails' phases,
the FASTQ reader thread's `parse.reader`). One entry is a count, not
seconds: `parse.ready` adds 1.0 for each batch the reader thread had
parsed before the consumer asked for it (`io/fastq.py`).
A reader takes differences of `totals` over the interval it measures.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict


class Tracer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, stage: str):
        t0, c0 = time.monotonic(), time.thread_time()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            dc = time.thread_time() - c0
            with self._lock:
                self.totals[stage] += dt
                self.totals[stage + ".cpu"] += dc
                self.counts[stage] += 1

    def add(self, stage: str, seconds: float) -> None:
        """Add `seconds` measured outside a span to `stage`."""
        with self._lock:
            self.totals[stage] += seconds
            self.counts[stage] += 1

    def as_json(self) -> str:
        with self._lock:
            return json.dumps({k: {"total_s": round(v, 4),
                                   "calls": self.counts.get(k, 0)}
                               for k, v in self.totals.items()})


GLOBAL = Tracer()
