"""The traced window: torch.profiler over the card, reduced to numbers.

With `--trace 1` the window runs under `torch.profiler` (CPU and CUDA
activity). The harness marks the window (`bench:window`), each parse of
a batch (`bench:parse`) and each emit (`bench:emit`), and the program's
own `utils.trace.GLOBAL` spans are marked as `span:<stage>` while the
window runs, all as `record_function` ranges, so they share the trace's
clock with the device's kernels and copies. `reduce` turns the exported
trace into the device's busy seconds (the union of kernel, copy and set
intervals inside the window), device seconds by kernel, and the
breakdown: the device operations that took most time, and the longest
device-idle gaps, each named by the innermost range the main thread was
in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench:window"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's function name without its signature, template
    arguments or return type."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split(" ")[-1] if head else name


class Profile:
    def __init__(self, on_card: bool):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def window(self):
        import torch
        return torch.profiler.record_function(WINDOW)

    def stop(self, host_window_s: float) -> dict:
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return reduce(events, host_window_s)


def reduce(events: list, host_window_s: float) -> dict:
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X"]
    if not win:
        return {"busy_s": 0.0, "window_s": host_window_s, "kernels": {},
                "launches": {}, "breakdown": {"device_ops": [],
                                              "idle_gaps": []}}
    w = win[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    main_tid = w.get("tid")
    dev = []
    by_op: dict = {}
    kernels: dict = {}
    launches: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(t0, float(e["ts"]))
        b = min(t1, float(e["ts"]) + float(e.get("dur", 0)))
        if b <= a:
            continue
        dev.append((a, b))
        name = short_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
            launches[name] = launches.get(name, 0) + 1
    dev.sort()
    busy = []
    for a, b in dev:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    gaps = []
    prev = t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("tid") == main_tid
                   and e.get("cat") == "user_annotation"
                   and e.get("name") != WINDOW)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        name = max(inner)[2] if inner else "outside any span"
        idle.append([name, (b - a) * 1e-6])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (t1 - t0) * 1e-6, "kernels": kernels,
            "launches": launches,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": idle}}


def annotated(gen, name: str):
    """Yield from `gen`, each step inside a record_function range."""
    import torch
    while True:
        with torch.profiler.record_function(name):
            try:
                item = next(gen)
            except StopIteration:
                return
        yield item


def annotated_fn(fn, name: str):
    import torch

    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def annotate_spans(tracer):
    """Mark the program's tracer spans as `span:<stage>` ranges (an
    attribute of the tracer instance, so its class is untouched);
    returns the function that takes the marks away."""
    import torch
    inner = tracer.span

    @contextlib.contextmanager
    def span(stage: str):
        with torch.profiler.record_function(f"span:{stage}"):
            with inner(stage):
                yield
    tracer.span = span

    def undo():
        del tracer.span
    return undo
