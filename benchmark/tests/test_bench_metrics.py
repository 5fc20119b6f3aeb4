"""Each per-layer metric's reader, and the reduction of a profiler
trace, on canned records."""

import pytest

import devtrace
import run

REC = dict(window_s=20.0, batches=40, reads=163840,
           spans={"parse": 2.0, "emit": 3.0},
           tracer={"emit_wait": 7.0, "extend_waves": 1.0, "seed": 4.0},
           stats={"seed_s": 3.2, "seed_batches": 40}, cpu_s=100.0,
           peak_bytes=3 << 29,
           device=dict(busy_s=0.05, window_s=20.0,
                       kernels={"p1p3_kernel": 0.004, "fwd_kernel": 0.002,
                                "bwd_kernel": 0.003, "cohort_kernel": 0.001,
                                "sa_walk_kernel": 0.002,
                                "vectorized_elementwise_kernel": 0.03}))

WANT = {"io.parse_share": 0.1, "io.emit_share": 0.15,
        "pipeline.tail_wait_share": 0.2, "batch.seed_ms": 80.0,
        "host_ext.wait_share": 0.05, "host.busy_cores": 5.0,
        "kernels.seed_ms_per_batch": 0.25,
        "kernels.sa_walk_ms_per_batch": 0.05,
        "device.idle_share": 0.9975, "device.peak_gib": 1.5}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(bench, name):
    assert name in {m["name"] for m in bench["per_layer"]}
    assert run.reader(name)(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["kernels.seed_ms_per_batch",
                                  "kernels.sa_walk_ms_per_batch",
                                  "device.idle_share", "device.peak_gib"])
def test_reader_finds_nothing(name):
    """No trace, no kernel of its own or no card: nothing, never 0."""
    rec = dict(REC, device=None, peak_bytes=0)
    assert run.reader(name)(rec) is None
    rec = dict(REC, device=dict(busy_s=0.0, window_s=20.0, kernels={}))
    assert run.reader(name)(rec) is None or name == "device.peak_gib"


def _ev(name, cat, ts, dur, tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid)


def test_reduce_trace():
    events = [
        _ev(devtrace.WINDOW, "user_annotation", 1000, 1000),
        _ev("span:seed", "user_annotation", 1000, 300),
        _ev("bench:emit", "user_annotation", 1500, 400),
        _ev("span:wave.create", "user_annotation", 1000, 1000, tid=2),
        _ev("void p1p3_kernel<int>(P1P3Args<int>, void const*)", "kernel",
            1100, 50),
        _ev("void p1p3_kernel<int>(P1P3Args<int>, void const*)", "kernel",
            1120, 50),                   # overlaps the first
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1400, 100),
        _ev("void sa_walk_kernel<long>(x)", "kernel", 1950, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 1100, 5),
    ]
    d = devtrace.reduce(events, 0.001)
    assert d["window_s"] == pytest.approx(1e-3)
    # busy: [1100, 1170] + [1400, 1500] + [1950, 2000] (clipped)
    assert d["busy_s"] == pytest.approx(220e-6)
    assert d["kernels"]["p1p3_kernel"] == pytest.approx(100e-6)
    assert d["launches"]["p1p3_kernel"] == 2
    assert d["kernels"]["sa_walk_kernel"] == pytest.approx(50e-6)
    gaps = d["breakdown"]["idle_gaps"]
    assert gaps[0] == ["bench:emit", pytest.approx(450e-6)]   # 1500-1950
    assert ["span:seed", pytest.approx(100e-6)] in gaps        # 1000-1100
    assert ["span:seed", pytest.approx(230e-6)] in gaps   # 1170-1400: mid 1285
    ops = dict(d["breakdown"]["device_ops"])
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(1e-4)


def test_reduce_without_window():
    d = devtrace.reduce([], 2.0)
    assert d["busy_s"] == 0.0 and d["window_s"] == 2.0


def test_short_kernel_names():
    assert devtrace.short_name(
        "void at::native::vectorized_elementwise_kernel<4, F>(int, F)") == \
        "at::native::vectorized_elementwise_kernel"
    assert devtrace.short_name("bwd_kernel(int, int)") == "bwd_kernel"
    assert devtrace.short_name(
        "void (anonymous namespace)::p1p3_kernel<int, true>(P1P3Args<int>)"
    ) == "p1p3_kernel"


def test_waiting_share_counts_samples_inside_spans(tmp_path):
    import numpy as np
    import threadstate
    t = np.arange(0.0, 1.0, 0.1)
    state = np.frombuffer(b"RRSSRSRRRS", np.uint8)
    np.savez(tmp_path / "s.npz", t=t, state=state)
    share, n = threadstate.waiting_share(tmp_path / "s.npz",
                                         [(0.15, 0.35), (0.55, 0.75)])
    assert n == 4 and share == 0.5       # S S | S R
    assert threadstate.waiting_share(tmp_path / "s.npz", []) == (0.0, 0)


def test_sampler_records_a_live_thread(tmp_path):
    import os
    import subprocess
    import sys
    import threading
    import time
    import numpy as np
    import threadstate
    p = subprocess.Popen([sys.executable, threadstate.__file__,
                          str(os.getpid()),
                          str(threading.main_thread().native_id),
                          str(tmp_path / "m.npz"), "0.002"])
    t_end = time.monotonic() + 0.5
    while time.monotonic() < t_end:
        pass
    p.terminate()
    p.wait()
    with np.load(tmp_path / "m.npz") as z:
        assert len(z["t"]) > 20 and set(z["state"].tobytes()) <= set(b"RSD")
