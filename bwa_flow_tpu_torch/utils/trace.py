"""Per-stage wall-clock span tracing (the reference's VLOG span pattern).

The reference logs microsecond spans around every stage compute and every
FPGA phase (getUs() + VLOG, src/util.h:33-38,
src/Pipeline.cpp:145-150, src/fpga/FPGAPipeline.cpp:557-579) and sums them
offline (bin/profile.sh). Here spans accumulate in-process per stage name
and dump as a table or JSON; enable wire-level logging with
BWA_TPU_TRACE=1 (one line per span, greppable the same way).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import defaultdict

_TRACE_ENV = "BWA_TPU_TRACE"


class Tracer:
    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self.log_spans = os.environ.get(_TRACE_ENV, "0") not in ("", "0")

    @contextlib.contextmanager
    def span(self, stage: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self.totals[stage] += dt
                self.counts[stage] += 1
            if self.log_spans:
                print(f"[T::{self.name}] {stage}: {dt*1e6:.0f} us",
                      file=sys.stderr)

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k, _ in rows), default=5)
        out = [f"{'stage':<{width}}  total_s   calls   avg_ms"]
        for k, v in rows:
            n = self.counts[k]
            out.append(f"{k:<{width}}  {v:7.2f}  {n:6d}  {v/n*1e3:7.2f}")
        return "\n".join(out)

    def as_json(self) -> str:
        return json.dumps({k: {"total_s": round(v, 4),
                               "calls": self.counts[k]}
                           for k, v in self.totals.items()})


GLOBAL = Tracer()
span = GLOBAL.span
