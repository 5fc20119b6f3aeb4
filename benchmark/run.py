#!/usr/bin/env python3
"""The benchmark of bwa_flow_tpu_torch: streamed `mem` on one H100.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

run from the root of a checkout. The cell (an entry of `workloads` in
BENCHMARK.json) names a configuration, `benchmark/configs/<config>.json`,
and a traffic mix, `benchmark/traffic/<traffic>.json`; each per-layer
metric is read by `benchmark/metrics/<metric>.py`, and each cell's limits
for `correct` are in `benchmark/limits/<cell>.json`. Nothing here names a
cell, a configuration or a mix.

Set-up (timed as `setup_s`, from the start of the process): the builds
of the port's kernels and host libraries (cached in the checkout's
`build/`), the genome and the port's index (built on the first run of a
configuration, then loaded from `benchmark/.cache/`), the index load, the
markdup stage, the `AlignPipeline` (its worker pool and the upload of
the index), and a few warm-up batches of a separate read stream through
that same pipeline. Then the window: `AlignPipeline.run` over batches
that `io.fastq.read_batches` parses from FIFOs, fed by one writer
process a FASTQ (`readgen.py`), with the `emit` of `cli._mem` (markdup,
then each record's SAM written to a file under TMPDIR). No batch is
handed to the pipeline once `--seconds` have passed; the batches in
flight drain, and the window ends at the last emit. With `--trace 1` the
window runs under `torch.profiler` and the per-layer metrics are
printed in place of the end-to-end ones.

After the window (and outside `setup_s`), the plain reference
(`reference.py`) judges a sample of the window's reads drawn from the
seed. The last lines on standard error are the numbers compared, each
with its limit; the last line on standard output is the result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

import numpy as np  # noqa: E402

import genome as genome_mod  # noqa: E402
import reference  # noqa: E402
import devtrace  # noqa: E402
import readgen  # noqa: E402
import threadstate  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bwa_flow_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (the kernel's own record)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, name: str) -> tuple[dict, dict, dict, dict]:
    """The cell named `name`, its configuration, its mix and its limits,
    found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
    cell = cells[name]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return cell, config, mix, limits


def reader(metric: str):
    """The reader module of a per-layer metric."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def cpu_seconds(pids) -> float:
    tck = os.sysconf("SC_CLK_TCK")
    total = 0
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        total += int(fields[11]) + int(fields[12])
    return total / tck


def cpu_snapshot(pool_pids, writer_pids) -> dict:
    """CPU seconds so far: this process's main thread, the process (its
    threads, ended ones too), the pool's processes and the writers, and
    the machine's time by kind from /proc/stat (steal: time the
    machine's host gave to others while this machine wanted to run)."""
    tck = os.sysconf("SC_CLK_TCK")
    pid = os.getpid()
    with open(f"/proc/{pid}/task/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    snap = {"main": (int(fields[11]) + int(fields[12])) / tck,
            "process": cpu_seconds([pid]), "pool": cpu_seconds(pool_pids),
            "writers": cpu_seconds(writer_pids)}
    with open("/proc/stat") as f:
        cpu = [int(x) / tck for x in f.readline().split()[1:9]]
    for k, v in zip(("user", "nice", "system", "idle", "iowait", "irq",
                     "softirq", "steal"), cpu):
        snap["machine_" + k] = v
    return snap


def cpu_line(a: dict, b: dict, window_s: float) -> str:
    d = {k: b[k] - a[k] for k in a}
    busy = sum(d["machine_" + k] for k in ("user", "nice", "system", "irq",
                                           "softirq"))
    every = busy + d["machine_idle"] + d["machine_iowait"] + \
        d["machine_steal"]
    return (f"main thread {d['main']:.3f} ({d['main'] / window_s:.3f} of "
            f"the window), other threads {d['process'] - d['main']:.3f}, "
            f"pool {d['pool']:.3f}, writers {d['writers']:.3f}; machine: "
            f"busy {busy:.3f} of {every:.3f} core-s, steal "
            f"{d['machine_steal']:.3f}, iowait {d['machine_iowait']:.3f}")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class Stream:
    """The writer processes of one read stream (one a mate), each into
    its own FIFO."""

    def __init__(self, tmp: Path, genome_path: Path, mix_path: Path,
                 seed: int, stream: int, mates: int):
        self.fifos, self.stats, self.procs = [], [], []
        for mate in range(mates):
            fifo = tmp / f"s{stream}m{mate}.fq"
            os.mkfifo(fifo)
            st = tmp / f"s{stream}m{mate}.json"
            self.procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "readgen.py"), "--writer",
                 str(genome_path), str(mix_path), str(seed), str(stream),
                 str(mate), str(fifo), str(st)],
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL))
            self.fifos.append(str(fifo))
            self.stats.append(st)

    def stop(self) -> list[dict]:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        out = []
        for p, st in zip(self.procs, self.stats):
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            out.append(load_json(st) if st.exists() else {})
        return out


def run_cell(bench: dict, cell: dict, config: dict, mix: dict,
             limits: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of a cell on `device` (the harness's tests pass "cpu");
    returns the result object."""
    import torch

    split: dict = {"imports_s": process_age()}
    paired = mix["layout"] == "pe"
    mates = 2 if paired else 1
    on_card = device.startswith("cuda")

    t0 = time.perf_counter()
    from bwa_flow_tpu_torch import _build
    if on_card:
        cuda_builds = threading.Thread(
            target=_build.build_all, args=(_build.KERNELS,))
        cuda_builds.start()
    _build.build_host()
    if on_card:
        cuda_builds.join()
    split["builds_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prefix, built = genome_mod.ensure_index(config, log)
    split["genome_index_s"] = time.perf_counter() - t0
    split.update({f"first_{k}": v for k, v in built.items()})

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.dedup.markdup import make_markdup_stage
    from bwa_flow_tpu_torch.index.io import load_index
    from bwa_flow_tpu_torch.io.fastq import read_batches
    from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
    from bwa_flow_tpu_torch.utils import opts as opts_mod
    from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

    tmp = Path(tempfile.mkdtemp(prefix="bench_"))
    gpath = genome_mod.cache_dir(config) / "genome.npy"
    mpath = tmp / "mix.json"       # the writers draw from this very mix
    mpath.write_text(json.dumps(mix))
    warm = Stream(tmp, gpath, mpath, seed, 1, mates)
    main = Stream(tmp, gpath, mpath, seed, 0, mates)
    pipe = None
    sampler = None
    streams = [warm, main]
    try:
        t0 = time.perf_counter()
        fm = load_index(prefix)
        split["index_load_s"] = time.perf_counter() - t0
        argv = list(config["mem_argv"]) + ["--batch-reads",
                                           str(mix["batch_reads"])]
        args = cli._mem_parser().parse_args(argv + [prefix] + ["-"] * mates)
        opt = cli.build_opt(args)
        if paired:
            opt.flag |= opts_mod.MEM_F_PE
        t0 = time.perf_counter()
        markdup = make_markdup_stage(fm, ignore_unmated=True)
        split["markdup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipe = AlignPipeline(opt, fm, paired=paired,
                             n_workers=max(0, args.n_threads - 1),
                             device=device, native=True, ext_mode=None)
        if on_card:
            torch.cuda.synchronize()
        split["pipeline_s"] = time.perf_counter() - t0
        chunk_bp = int(mix["batch_reads"]) * int(mix["read_len"])
        header = cli.sam_header(fm, None, None, ["bwa_flow_tpu_torch",
                                                 "mem"] + argv)
        sam_path = tmp / "out.sam"
        out = open(sam_path, "w")
        out.write(header)
        tm: dict = {"parse": 0.0, "emit": 0.0, "last": 0.0}
        marks: list = []       # (time, reads) at each emit of the window
        parses: list = []      # seconds of each batch's parse
        parse_spans: list = []  # (start, end) of each batch's parse

        def make_emit(sink, seen):
            def emit(chunk):
                t = time.monotonic()
                markdup.process(chunk)
                for r in chunk:
                    sink.write(r.sam)
                if seen is not None:
                    seen.append(np.fromiter((r.id for r in chunk),
                                            np.int64, len(chunk)))
                t1 = time.monotonic()
                tm["emit"] += t1 - t
                tm["last"] = t1
                if seen is not None:
                    marks.append((t1, len(chunk)))
            return emit

        # warm-up: a separate stream through the same pipeline
        t0 = time.perf_counter()
        wit = read_batches(*warm.fifos, chunk_bp=chunk_bp)
        n_warm = int(mix["warmup_batches"])
        with open(os.devnull, "w") as null:
            pipe.run((next(wit) for _ in range(n_warm)),
                     make_emit(null, None))
        del wit
        if on_card:
            torch.cuda.synchronize()
        split["warmup_s"] = time.perf_counter() - t0
        warm_stats = warm.stop()
        streams = [main]

        seen: list = []
        emit = make_emit(out, seen)
        handed = {"reads": 0, "batches": 0}
        it = read_batches(*main.fifos, chunk_bp=chunk_bp)

        def window_batches(t_open):
            while time.monotonic() - t_open < seconds:
                t = time.monotonic()
                b = next(it)
                parses.append(time.monotonic() - t)
                parse_spans.append((t, t + parses[-1]))
                tm["parse"] += parses[-1]
                handed["reads"] += len(b)
                handed["batches"] += 1
                yield b

        tr0 = dict(tracer.totals)
        st0 = {k: v for k, v in pipe.ba.stats.items()
               if isinstance(v, (int, float))}
        pids = [os.getpid()] + [p.pid for p in (pipe.pool._pool
                                                if pipe.pool else [])]
        prof = devtrace.Profile(on_card) if trace else None
        unpatch = devtrace.annotate_spans(tracer) if trace else None
        cpu0 = cpu_seconds(pids)
        snap0 = cpu_snapshot(pids[1:], [p.pid for p in main.procs])
        sampler = subprocess.Popen(
            [sys.executable, str(HERE / "threadstate.py"), str(os.getpid()),
             str(threading.main_thread().native_id), str(tmp / "main.npz"),
             "0.002"], stdin=subprocess.DEVNULL)
        setup_s = process_age()
        if prof is not None:
            prof.start()
        t_open = time.monotonic()
        with (prof.window() if prof else contextlib.nullcontext()):
            pipe.run(devtrace.annotated(window_batches(t_open),
                                        "bench:parse")
                     if trace else window_batches(t_open),
                     devtrace.annotated_fn(emit, "bench:emit")
                     if trace else emit)
        t_close = time.monotonic()
        cpu1 = cpu_seconds(pids)
        snap1 = cpu_snapshot(pids[1:], [p.pid for p in main.procs])
        sampler.terminate()
        sampler.wait()
        sampler = None
        parse_wait = threadstate.waiting_share(tmp / "main.npz", parse_spans)
        window_s = tm["last"] - t_open
        dev_rec = prof.stop(t_close - t_open) if prof else None
        if unpatch:
            unpatch()
        peak = 0
        if on_card:
            torch.cuda.synchronize()
            peak = max(torch.cuda.max_memory_allocated(i)
                       for i in range(int(cell["chips"])))
        tr = {k: v - tr0.get(k, 0.0) for k, v in tracer.totals.items()}
        st = {k: pipe.ba.stats[k] - v for k, v in st0.items()}
        out.close()
        del it
        main_stats = main.stop()
        streams = []
        pipe.close()
        pipe = None
        del fm
        if on_card:
            torch.cuda.empty_cache()
        bad_mods = forbidden_modules()

        # ---- the reference, after the window
        t0 = time.perf_counter()
        ids = np.concatenate(seen) if seen else np.zeros(0, np.int64)
        counts = np.bincount(ids, minlength=handed["reads"]) \
            if len(ids) else np.zeros(handed["reads"], np.int64)
        not_emitted = int((counts[:handed["reads"]] != 1).sum()) + \
            int(counts[handed["reads"]:].sum())
        sample = draw_sample(config, mix, seed, handed["batches"])
        records = scan_sam(sam_path, set(sample["name"]))
        judged = reference.compare(sample, records,
                                   genome_mod.genome_of(config),
                                   config["scoring"], paired,
                                   genome_mod.repeats_of(config))
        judged["missing"] += not_emitted
        ref_s = time.perf_counter() - t0
        sam_bytes = sam_path.stat().st_size
    finally:
        if sampler is not None:
            sampler.kill()
            sampler.wait()
        for s in streams:
            s.stop()
        if pipe is not None:
            pipe.close()
        shutil.rmtree(tmp, ignore_errors=True)

    checks = {k: {"value": judged[k], "limit": limits[k]}
              for k in limits if k in judged}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and not bad_mods and handed["reads"] > 0
    n_out = len(ids)
    rec = dict(window_s=window_s, batches=handed["batches"],
               reads=n_out, spans={"parse": tm["parse"], "emit": tm["emit"]},
               tracer=tr, stats=st, cpu_s=cpu1 - cpu0, peak_bytes=peak,
               device=dev_rec)
    log(f"[bench] card: {card_line() if on_card else device}")
    log("[bench] set-up s: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in split.items())
        + f"; total {setup_s:.3f}")
    for name, ws in (("warm-up", warm_stats), ("window", main_stats)):
        log(f"[bench] {name} writers: " + "; ".join(
            f"mate {i}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                      else f"{k} {v}" for k, v in w.items())
            for i, w in enumerate(ws)))
    log(f"[bench] window {window_s:.3f} s ({t_close - t_open:.3f} s to "
        f"run's return), {handed['batches']} batches, {handed['reads']} "
        f"reads handed, {n_out} emitted, SAM {sam_bytes} bytes; parse "
        f"{tm['parse']:.3f} s, emit {tm['emit']:.3f} s; spans " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(tr.items())))
    log(f"[bench] stats: {json.dumps(st)}")
    log(f"[bench] cpu s over the run's {t_close - t_open:.3f} s: "
        + cpu_line(snap0, snap1, t_close - t_open)
        + f"; main thread not running in {parse_wait[0]:.3f} of "
        f"{parse_wait[1]} samples inside the parse spans")
    log("[bench] reads/s by thirds of the window: " + ", ".join(
        f"{v:.1f}" for v in thirds(marks, t_open, window_s))
        + "; parse ms a batch, quartiles: " + ", ".join(
            f"{1e3 * v:.1f}" for v in (np.percentile(parses, [0, 25, 50, 75,
                                                               100])
                                       if parses else [])))
    if dev_rec is not None:
        log("[bench] device seconds (launches) by kernel: " + ", ".join(
            f"{k} {v:.6f} ({dev_rec['launches'][k]})" for k, v in sorted(
                dev_rec["kernels"].items(), key=lambda kv: -kv[1])[:12]))
    log(f"[bench] reference: {ref_s:.2f} s over {judged['reads']} reads; "
        + ", ".join(f"{k} {v}" for k, v in judged.items() if k != "why"))
    for w in judged["why"]:
        log(f"[bench] judged: {w}")
    if bad_mods:
        log(f"[bench] forbidden modules loaded: {bad_mods}")

    metrics: dict = {}
    if trace:
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"reads_per_s": n_out / window_s if window_s > 0 else 0.0,
               "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": handed["reads"],
              "failed": not_emitted, "metrics": metrics, "device": dev}
    if trace and dev_rec is not None:
        dev["busy_s"] = dev_rec["busy_s"]
        dev["window_s"] = dev_rec["window_s"]
        result["breakdown"] = dev_rec["breakdown"]
    result["checks"] = checks
    result["_forbidden"] = bad_mods
    return result


def thirds(marks: list, t_open: float, window_s: float) -> list:
    """The emit rate in each third of the window (a steadiness check)."""
    out = []
    for k in range(3):
        a, b = t_open + window_s * k / 3, t_open + window_s * (k + 1) / 3
        n = sum(c for t, c in marks if a < t <= b)
        out.append(n / (b - a) if b > a else 0.0)
    return out


def draw_sample(config: dict, mix: dict, seed: int, n_batches: int
                ) -> dict:
    """The reads the reference judges, drawn from the seed among the
    window's fragments: a uniform share, fragments with an indel, and
    (pairs) every member of up to `sample.dup` groups of fragments that
    came from one place of the genome (an exact duplicate and its
    source, or fragments that coincide by chance), from any batches of
    the window. Each read has its fragment's `group` (-1 if none) and
    `frag` (its stream index)."""
    g = genome_mod.genome_of(config)
    nf = readgen.frags_per_batch(mix)
    per = 2 if mix["layout"] == "pe" else 1
    want = mix["sample"]
    rng = np.random.default_rng([seed & (2**64 - 1), 0x5A3])
    gen = readgen.Batches(g, mix, seed, 0)
    batches = [gen.batch(b) for b in range(n_batches)]
    total = nf * n_batches
    pick = set(rng.choice(total, min(total, int(want["fragments"])),
                          replace=False).tolist())
    indel = np.flatnonzero(np.concatenate([b["indel"] for b in batches]))
    pick |= set(rng.choice(indel, min(len(indel), int(want["indel"])),
                           replace=False).tolist())
    group_of: dict = {}
    if per == 2 and total:
        place = readgen.places(
            np.concatenate([b["lo"][0::2] for b in batches]),
            np.concatenate([b["hi"][0::2] for b in batches]))
        shared = np.unique(place[place >= 0])
        keep = rng.choice(shared, min(len(shared), int(want.get("dup", 0))),
                          replace=False) if len(shared) else []
        for gid, key in enumerate(sorted(int(k) for k in keep)):
            for f in np.flatnonzero(place == key).tolist():
                group_of[f] = gid
                pick.add(f)
    out = {k: [] for k in ("reads", "rev", "lo", "hi", "span", "end_indel",
                           "name", "mate", "group", "frag")}
    for f in sorted(pick):
        b, j = divmod(f, nf)
        bt = batches[b]
        for k in range(per):
            out["reads"].append(bt["reads"][per * j + k])
            out["rev"].append(bool(bt["rev"][per * j + k]))
            out["lo"].append(int(bt["lo"][per * j + k]))
            out["hi"].append(int(bt["hi"][per * j + k]))
            out["span"].append(int(bt["span"][j]))
            out["end_indel"].append(bool(bt["end_indel"][j]))
            out["name"].append(readgen.name_str(0, f))
            out["mate"].append(k)
            out["group"].append(group_of.get(f, -1))
            out["frag"].append(f)
    for k in ("lo", "hi", "span", "group", "frag"):
        out[k] = np.asarray(out[k], np.int64)
    for k in ("rev", "end_indel"):
        out[k] = np.asarray(out[k], bool)
    return out


def scan_sam(path: Path, names: set) -> dict:
    """{QNAME: [lines]} of the wanted names, in one pass over the SAM."""
    width = 1 + readgen.NAME_DIGITS
    out: dict = {}
    with open(path) as f:
        for line in f:
            key = line[:width]
            if key in names and line[width] == "\t":
                out.setdefault(key, []).append(line)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, mix, limits = resolve(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"[bench] {args.workload} needs {cell['chips']} CUDA "
            f"device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = run_cell(bench, cell, config, mix, limits, args.seed,
                   args.seconds, bool(args.trace))
    bad = res.pop("_forbidden")
    if bad:
        return 3
    for k, c in res["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
