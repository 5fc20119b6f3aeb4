"""Batched device aligner — the device compute path of the pipeline.

Port of bwa_flow_tpu/pipeline/batch.py's native route (the one the JAX
package takes when its extensions are built). Per batch:

  1. device SMEM seeding with fused SA resolution (ops/smem_torch.py)
  2. device SA probes for what the seed program did not resolve
  3. chaining + filters in the port's host library (ops/chain_native.py,
     exact bwa semantics); reads long enough for the seed-SW filter
     chain in Python (chain_read, ops/chain.py)
  4. extension: per-read state machines in the _wave driver
     (ops/wave_native.py), with Python moving descriptor waves to the
     device (ops/chain2aln_torch.py, a CUDA ksw_extend2 kernel on the
     card) and results back, and harvester threads running reads on the
     exact scalar kernel meanwhile. The extension mode (`ext_mode`,
     else BWA_TPU_EXT, else "host", as in the JAX package): "host" runs
     every task on the harvesters and no ksw kernel; "waves" runs device
     waves and leaves the harvesters a reserve.
  5. host dedup/patch/primary marking + SAM; paired-end batches
     (interleaved mates) estimate the insert size, rescue mates and
     pair (ops/pe.py) instead. AlignPipeline runs these in the port's
     host library (ops/region_native.py).

With several devices (`devices`), steps 1, 2 and 4 run per shard of the
batch on each device's index replica (parallel/mesh.py); the host
stages see the whole batch in read order, with global read ids.

On a card each shard seeds on a stream of its own and copies its seed
results back on another (mesh.shard_streams): the seed program, whose
machines are kernels, is queued whole and marks its end with an event,
the copies wait for that event only, and the extension waves on the
device's default stream wait for the reads' upload. So a batch's
results can be read while the next batch's seed program, queued early
by the pipeline's hooks (seeds_collect's "_post_redo_dispatch",
resolve_sa_flat's post_dispatch), runs. The seed program's reads are
uploaded from page-locked memory without a wait (upload), so queueing
it never waits behind the card's earlier work.

Tasks too large for the device shapes run on the host scalar kernel
inline. A device error, on any shard, propagates and fails the run;
nothing switches to the host on a failure. So do three checks the JAX
package runs, which here raise where it
degrades to the host for the rest of the run:

  - the hang watchdog: every read of the device from the host goes
    through BatchAligner.fetch (every upload through put), which waits
    for the device's queued work on the copy's stream (for seed
    results, the seed program's end event) with a deadline
    (device_timeout) and raises TimeoutError past it;
  - the structural check of every wave row against its task's shape
    (bad_rows), always on: DeviceResultError;
  - with validate_every, a sample of every Nth batch's reads against the
    golden model (check_against_golden): DeviceResultError.
"""

from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..index.fmindex import FMIndex
from ..index.io import wide
from ..io.sam import Read, mem_reg2sam
from ..models import golden
from ..ops import chain as chainops
from ..ops import fm as fmops
from ..ops import pe as peops
from ..ops import region as regionops
from ..ops import chain_native, extend_cuda, region_native, smem_torch
from ..ops import wave_native
from ..ops.chain2aln_torch import (DescTaskBuffer, narrow_desc,
                                   seed_extend_desc_batch)
from ..ops.fm_torch import DeviceFM, sa_batch, to_host
from ..ops.probe_layout import sa_probe_layout
from ..ops.smem import IntvBatch
from ..parallel.mesh import on_stream, replicate_fm, run_shards, shard_streams
from ..utils.opts import MEM_F_PRIMARY5, MemOpt

SA_CHUNK = 65536   # SA probes per device LF-walk call
# the extension's small kernel shape class: tasks whose query sides
# are both at most this long (JAX batch.py:617-620)
Q_SMALL = 96
# reads a harvester claims per steal
STEAL_READS = 16
# the watchdog's poll: for SPIN_S it checks again at once, yielding the
# core and the interpreter lock between checks (a timed sleep would wake
# late on a busy host); past that it sleeps NAP_S between checks
SPIN_S = 0.1
NAP_S = 1e-3
# the fields of a region that validation compares with the golden model
REG_FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w",
              "seedcov")
# the 12 fields of a wave row (seed_extend_desc_batch's output)
ROW_FIELDS = ("lscore", "lqle", "ltle", "lgtle", "lgscore", "lmax_off",
              "rscore", "rqle", "rtle", "rgtle", "rgscore", "rmax_off")


class DeviceResultError(RuntimeError):
    """A device result that cannot be right: a wave row outside its
    task's range, or a validated read whose regions differ from the
    golden model's. The run fails; the JAX package degrades to the host
    instead."""


ABANDONED = "device wait abandoned: the run failed elsewhere"


def wait_ready(ready, timeout: float, abort=None) -> None:
    """Poll ready() until it is true; raise TimeoutError once `timeout`
    seconds have passed (the reference's fpgaHangError, SWTask.cpp:
    115-121), and RuntimeError(ABANDONED) at once when the event `abort`
    is set (the run has failed on another thread). The blocked device
    work cannot be cancelled: the caller's run fails."""
    t0 = time.monotonic()
    while not ready():
        if abort is not None and abort.is_set():
            raise RuntimeError(ABANDONED)
        dt = time.monotonic() - t0
        if dt >= timeout:
            raise TimeoutError(f"device work did not finish within the "
                               f"device timeout of {timeout:g} s (hung "
                               "device)")
        if dt < SPIN_S:
            os.sched_yield()
        else:
            time.sleep(NAP_S)


def _done() -> bool:
    return True


def bad_rows(desc: np.ndarray, rows: np.ndarray, max_mat: int):
    """The structural check of one wave: row_ok of the JAX package's
    native wave driver (native/_wave.cpp:508-545) over every lane at
    once. desc int64[11, n] holds the wave's task descriptors
    (DescTaskBuffer), rows int[12, n] its results. A side with work must
    have qle in [0, qlen], tle and gtle in [0, tlen], score in [h0, h0 +
    qlen * max_mat] and max_off in [0, max(qlen, tlen)]; a side without
    work must be exactly (h0, 0, 0). The right side starts from the
    row's left score, or, in a right-only retry (skip_left), from the
    saved left score that the descriptor carries as h0; such a row's
    left half is not checked. Returns (lane, field, (qlen, tlen, h0)) of
    the first bad value in lane order, or None."""
    qbeg, slen, l_query, rbeg, rmax0, rmax1, h0 = desc[1:8].astype(np.int64)
    skip = desc[10] != 0
    r = rows.astype(np.int64)
    qlen_r = l_query - (qbeg + slen)
    sides = ((0, qbeg, rbeg - rmax0, h0, ~skip & (qbeg > 0),
              ~skip & (qbeg == 0)),
             (6, qlen_r, rmax1 - (rbeg + slen), np.where(skip, h0, r[0]),
              qlen_r != 0, qlen_r == 0))
    masks = []
    for off, qlen, tlen, h, work, idle in sides:
        sc, qle, tle, gtle, moff = r[off], r[off + 1], r[off + 2], \
            r[off + 3], r[off + 5]
        masks += [
            (off, work & ((sc < h) | (sc > h + qlen * max_mat))
             | idle & (sc != h)),
            (off + 1, work & ((qle < 0) | (qle > qlen)) | idle & (qle != 0)),
            (off + 2, work & ((tle < 0) | (tle > tlen)) | idle & (tle != 0)),
            (off + 3, work & ((gtle < 0) | (gtle > tlen))),
            (off + 5, work & ((moff < 0) | (moff > np.maximum(qlen, tlen))))]
    bad = np.stack([m for _, m in masks])
    lanes = np.nonzero(bad.any(axis=0))[0]
    if not len(lanes):
        return None
    j = int(lanes[0])
    field = next(f for f, m in masks if m[j])
    side = sides[0] if field < 6 else sides[1]
    return j, field, (int(side[1][j]), int(side[2][j]), int(side[3][j]))


def raise_bad_row(bad, rows: np.ndarray, ridx: int, names=None) -> None:
    """Raise DeviceResultError for bad_rows' finding `bad` in a wave's
    `rows`, naming the read (its index in the batch, and its name from
    `names`), the field, its range and the wave lane."""
    j, f, (qlen, tlen, h0) = bad
    name = f" ({names[ridx]})" if names else ""
    raise DeviceResultError(
        f"wave row of read {ridx}{name}: {ROW_FIELDS[f]} = "
        f"{int(rows[f, j])} is outside what its task allows (qlen {qlen}, "
        f"tlen {tlen}, h0 {h0}); wave lane {j}")


def check_against_golden(opt: MemOpt, fm: FMIndex, seq, got, what: str
                         ) -> None:
    """Raise DeviceResultError when `got`, one read's deduplicated
    regions from the device path, differs from the golden model's
    (mem_align1_core) in any of REG_FIELDS; the message names `what`
    (the read and its batch) and each differing field with both
    values."""
    want = golden.mem_align1_core(opt, fm, seq)
    diffs = [] if len(got) == len(want) else [
        f"regions: device {len(got)}, golden {len(want)}"]
    for j, (a, b) in enumerate(zip(got, want)):
        diffs += [f"region {j} {f}: device {getattr(a, f)}, golden "
                  f"{getattr(b, f)}" for f in REG_FIELDS
                  if getattr(a, f) != getattr(b, f)]
    if diffs:
        raise DeviceResultError(f"device result differs from the golden "
                                f"model on {what}: {'; '.join(diffs)}")


def chain_read(opt: MemOpt, fm: FMIndex, seq, intvs, lut: dict) -> list:
    """Seeds -> filtered chains of one read; `lut` maps (x0, k) to the
    occurrence's SA value."""
    if len(seq) < opt.min_seed_len:
        return []
    chains = chainops.mem_chain(opt, fm, len(seq), intvs,
                                sa_lookup=lambda x0, k: lut[(x0, k)])
    chains = chainops.mem_chain_flt(opt, chains)
    chainops.mem_flt_chained_seeds(opt, fm, len(seq), seq, chains)
    return chains


def dedup_regs(opt: MemOpt, fm: FMIndex, seq, regs) -> list:
    """Sort, dedup and patch one read's regions; flag ALT hits."""
    regs = regionops.mem_sort_dedup_patch(
        opt, fm, seq, regs, golden.make_patch_scorer(opt, fm, seq))
    for p in regs:
        if p.rid >= 0 and fm.bns.anns[p.rid].is_alt:
            p.is_alt = 1
    return regs


def se_sam(opt: MemOpt, fm: FMIndex, read: Read, regs, read_id: int,
           rg_id: str) -> None:
    """Primary marking and the SAM records of one single-end read."""
    regionops.mem_mark_primary_se(opt, regs, read_id)
    if opt.flag & MEM_F_PRIMARY5:
        regionops.mem_reorder_primary5(opt.T, regs)
    read.sam = ""
    mem_reg2sam(opt, fm, read, regs, 0, None, rg_id)


class BatchAligner:
    """Device batch aligner on one torch device (``cuda`` by default), or
    on several with `devices`.

    `wave_cap` bounds tasks per device extension call; `smem_L` is the
    padded read length of the seeding machine (longer reads are seeded
    on the host).

    `devices` (a list of torch devices, one shard each; it may name a
    device more than once) splits every batch into contiguous shards,
    as the JAX package's n_local_devices does (batch.py:73-85,
    309-325): the index is replicated on each device, and each shard
    seeds its reads on its own device (one thread a shard), keeps them
    resident there, and runs the extension waves of its reads there,
    two wave streams a shard (the JAX package's _extend_waves_sharded).
    SA probe chunks go round-robin over the replicas. None, or one
    device, is the one-device path: one shard.

    `device_timeout` (seconds; 0 or less disables) bounds every wait for
    the device (fetch, put): past it, TimeoutError. `validate_every` > 0
    checks `validate_sample` reads of every Nth batch of align_regs
    against the golden model (AlignPipeline runs its own sample); a
    mismatch raises DeviceResultError.

    `ext_mode`, `drain_max` and `harvest_workers` steer the extension
    as in the JAX package (batch.py:88-113): in "host" mode every wave
    is a drained tail (drain_max 2^30) and ncpu - 1 harvester threads
    run the reads; in "waves" mode waves of at most min(512, wave_cap //
    16) pending reads drain on the host, and min(2, ncpu - 2)
    harvesters share the work with the device. drain_max=0 drains
    nothing, on any number of shards."""

    def __init__(self, opt: MemOpt, fm: FMIndex, smem_L: int = 160,
                 wave_cap: int = 4096, qmax: int = 160, tmax: int = 512,
                 device=None, devices=None, validate_every: int = 0,
                 validate_sample: int = 2, device_timeout: float = 300.0,
                 ext_mode: str | None = None, drain_max: int | None = None,
                 harvest_workers: int | None = None):
        devs = [resolve_device(d) for d in (devices or [device])]
        self.device = devs[0]
        self.opt = opt
        self.fm = fm
        self.ext_mode = ext_mode or os.environ.get("BWA_TPU_EXT", "host")
        if self.ext_mode not in ("host", "waves"):
            raise ValueError(f"ext_mode {self.ext_mode!r}: expected host "
                             "or waves")
        host = self.ext_mode == "host"
        self.drain_max = drain_max if drain_max is not None \
            else (1 << 30 if host else min(512, wave_cap // 16))
        ncpu = os.cpu_count() or 2
        self.harvest_workers = harvest_workers \
            if harvest_workers is not None \
            else (max(1, ncpu - 1) if host else max(0, min(2, ncpu - 2)))
        self.validate_every = validate_every
        self.validate_sample = validate_sample
        self.device_timeout = device_timeout
        self._batch_no = 0
        self.dfm = DeviceFM.from_host(fm, self.device, fetch=self.fetch)
        self.smem_L = smem_L
        self.qmax, self.tmax = qmax, tmax
        # one shard a device: its index replica, its two wave buffers
        # (the streams ping-pong), and on a card the stream its seed
        # program runs on and the stream its results are copied back on
        # (parallel/mesh.py: shard_streams)
        self.shards = [
            dict(device=d, dfm=x, bufs=[DescTaskBuffer(wave_cap, qmax, tmax),
                                        DescTaskBuffer(wave_cap, qmax, tmax)],
                 seed_stream=ss, copy_stream=cs)
            for d, x, ss, cs in zip(
                devs, [self.dfm] + replicate_fm(self.dfm, devs[1:]),
                shard_streams(devs), shard_streams(devs))]
        # (lo, hi, padded reads on the shard's device) of each shard of
        # the batch seeded last: the device-resident reads of its waves
        self._dev_shards = None
        self._stats_lock = threading.Lock()
        self.stats = {"reads": 0, "sa_host_redo": 0,
                      "ext_tasks_device": 0, "ext_tasks_host": 0,
                      "host_oversize_q": 0, "host_oversize_t": 0,
                      "host_sched": 0, "waves": 0,
                      "validations": 0,
                      "seed_batches": 0, "seed_s": 0.0,
                      # the hook that enqueued each next batch's seed
                      # program (AlignPipeline.run), and the batches run
                      # with the adaptive downgrade's late enqueue
                      "enqueue_post_redo": 0, "enqueue_post_dispatch": 0,
                      "enqueue_late": 0,
                      "seed_downgrades": 0,
                      # batches seeded on the int64 (wide) machine; the
                      # bytes their collects copied from the device;
                      # the SA values the seed program's fused walk
                      # resolved; the reads each redo seeded (the
                      # big-budget device machine, the host golden)
                      "seed_wide": 0, "seed_fetch_bytes": 0,
                      "sa_values": 0, "seed_redo_device": 0,
                      "seed_redo_golden": 0,
                      # the native tails' mate rescue (ksw_align2 calls,
                      # those that ran striped) and pairs
                      # (AlignPipeline._record_tail), and the harvesters'
                      # steals that found nothing to run
                      "tail_matesw": 0, "tail_matesw_vec": 0,
                      "tail_pairs": 0,
                      "harvest_idle_polls": 0,
                      "shards": [dict(device=str(d), seed_s=0.0, waves=0,
                                      ext_tasks_device=0, launches=0,
                                      launches16=0) for d in devs]}

    def _stat(self, name: str, delta=1, shard: int | None = None) -> None:
        """Add to a counter of the batch aligner, or of one shard."""
        with self._stats_lock:
            st = self.stats if shard is None else self.stats["shards"][shard]
            st[name] = st.get(name, 0) + delta

    # ------------------------------------------------------------------
    @staticmethod
    def _ready(device: torch.device):
        """The check that `device`'s current stream, the one the host
        copies run on, has finished what is queued on it now: a CUDA
        event recorded there. The CPU queues nothing. Tests replace it
        to inject a stall."""
        if device.type != "cuda":
            return _done
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev.query

    def wait(self, device, abort=None) -> None:
        """Wait for the work queued on `device` under the watchdog:
        TimeoutError after device_timeout seconds, RuntimeError as soon
        as `abort` is set (wait_ready). With device_timeout <= 0 this
        returns at once, and the copy that follows waits with no
        deadline."""
        if self.device_timeout > 0:
            wait_ready(self._ready(torch.device(device)),
                       self.device_timeout, abort)

    def fetch(self, t, abort=None) -> np.ndarray:
        """Device -> host copy behind the watchdog; every read of the
        device on a batch's path goes through here."""
        if isinstance(t, torch.Tensor):
            self.wait(t.device, abort)
        return to_host(t)

    def put(self, a, device, abort=None) -> torch.Tensor:
        """Host -> device copy behind the watchdog: a copy from pageable
        memory waits for the stream's earlier work, so the watchdog
        waits first."""
        self.wait(device, abort)
        return torch.as_tensor(a, device=device)

    @staticmethod
    def upload(a, device) -> torch.Tensor:
        """Host -> device copy that does not wait for the device, so it
        needs no watchdog: to a card from page-locked memory, queued on
        the current stream after its earlier work (torch's host allocator
        keeps the page-locked buffer until the copy is done)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if torch.device(device).type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    # ------------------------------------------------------------------
    def resolve_sa_flat(self, all_intvs, seed_handle: dict | None = None,
                        post_dispatch=None):
        """SA values of every (interval, occurrence) probe of the batch;
        returns (vals int64[NO], off int64[n+1], owners) in
        sa_probe_layout order. Reads whose values the seed program
        resolved (fused SA) need no probe; the rest go through batched
        device LF walks, chunks round-robin over the index replicas (any
        replica serves any probe), and walk overflows through the host
        bwt_sa. post_dispatch (indexes without a dense SA) is called
        once every probe walk is on the card, before its results are
        read (JAX batch.py:181-196): the pipeline enqueues the next
        batch's seed program there. Each read of the device here, those
        of sa_batch included, is the tracer's span `sa.fetch`."""
        from ..utils.trace import GLOBAL as tracer

        def fetch(t):
            with tracer.span("sa.fetch"):
                return self.fetch(t)

        def fire():
            nonlocal post_dispatch
            cb, post_dispatch = post_dispatch, None
            if cb is not None:
                cb()
        # no owners triplets: the reads that chain in Python rebuild
        # theirs (_luts)
        rows, offs, owners = sa_probe_layout(self.opt, all_intvs,
                                             build_owners=False)
        vals_all = np.empty(len(rows), dtype=np.int64)
        if not len(rows):
            fire()
            return vals_all, offs, owners
        need = None
        sav = (seed_handle or {}).get("sa_vals")
        if sav is not None:
            need_idx = []
            for r in range(len(all_intvs)):
                lo, hi = int(offs[r]), int(offs[r + 1])
                v = sav[r] if r < len(sav) else None
                if v is not None and len(v) == hi - lo:
                    vals_all[lo:hi] = v
                else:
                    need_idx.append((lo, hi))
            if not need_idx:
                fire()
                return vals_all, offs, owners
            need = np.concatenate(
                [np.arange(lo, hi) for lo, hi in need_idx])
            rows = rows[need]
        # sub-2^31 genomes walk the LF chain in int32 on a narrow view
        narrow = not wide(self.fm.seq_len)
        dfm_sas = [s["dfm"].narrow() if narrow else s["dfm"]
                   for s in self.shards]
        pdt = np.int32 if narrow else np.int64
        walks = []
        for ci, off in enumerate(range(0, len(rows), SA_CHUNK)):
            dfm_sa = dfm_sas[ci % len(dfm_sas)]
            chunk = rows[off:off + SA_CHUNK]
            width = 4096
            while width < len(chunk):
                width <<= 1
            pad = np.zeros(width, dtype=pdt)
            pad[:len(chunk)] = chunk
            walks.append((off, chunk) + sa_batch(
                dfm_sa, self.put(pad, dfm_sa.device), 256,
                int(self.fm.sa_intv), fetch))
        fire()   # every probe walk is on the card; results pending
        for off, chunk, sa_t, ovf_t in walks:
            vals = fetch(sa_t[:len(chunk)]).copy()
            ovf = fetch(ovf_t[:len(chunk)])
            for j in np.nonzero(ovf)[0]:
                vals[j] = fmops.bwt_sa(self.fm, int(chunk[j]))
                self._stat("sa_host_redo")
            if need is None:
                vals_all[off:off + len(chunk)] = vals
            else:
                vals_all[need[off:off + len(chunk)]] = vals
        return vals_all, offs, owners

    # ------------------------------------------------------------------
    def seeds_dispatch(self, seqs: list[np.ndarray]) -> dict:
        """Stage 1 (device SMEM seeding): cuts the batch into contiguous
        shards of ceil(n / devices) reads (fewer shards than devices when
        the batch is small), uploads each padded shard to its device and
        runs the seed program on it, one thread a shard, each on its
        shard's seed stream; the handle feeds seeds_collect. On a card
        nothing here waits for the device: the uploads do not (upload),
        the seed program's kernels run each machine to its end on the
        card, and on an index without a dense SA its fused LF walk is a
        kernel too (fm_torch.sa_batch), so this returns once the program
        is queued, and its end event (smem_torch._mark) is in each
        shard's handle. The whole call is the tracer's span
        `seed.dispatch`, from whichever thread calls it."""
        from ..utils.trace import GLOBAL as tracer
        with tracer.span("seed.dispatch"):
            return self._seeds_dispatch(seqs)

    def _seeds_dispatch(self, seqs: list[np.ndarray]) -> dict:
        n = len(seqs)
        per = -(-max(n, 1) // len(self.shards))
        bounds = [(i, min(i + per, n)) for i in range(0, n, per)] or [(0, 0)]

        def dispatch(k):
            lo, hi = bounds[k]
            sh = self.shards[k]
            q, qlen = smem_torch.pad_reads(seqs[lo:hi], self.smem_L)
            with on_stream(sh["seed_stream"]):
                q_dev = self.upload(q, sh["device"])
                qlen_dev = self.upload(qlen, sh["device"])
                t0 = time.perf_counter()
                sub = smem_torch.seed_dispatch(
                    self.opt, self.fm, sh["dfm"], seqs[lo:hi],
                    L=self.smem_L, padded=(q_dev, qlen_dev),
                    fetch=self.fetch)
            self._stat("seed_s", time.perf_counter() - t0, shard=k)
            return q_dev, sub

        t0 = time.perf_counter()
        parts = run_shards(dispatch, len(bounds))
        self._stat("seed_s", time.perf_counter() - t0)
        return dict(n_reads=n, bounds=bounds, parts=parts)

    def _seed_fetch(self, k: int, sub: dict):
        """The fetch of shard k's seed results: on a card, the copy waits
        for the event of the program that made them (sub["event"]: the
        seed program's end, then a redo's) on the shard's copy stream,
        and the watchdog watches that stream, so neither waits behind a
        later batch's program queued on the seed stream. Each read is the
        tracer's span `seed.fetch`, and its bytes count in the stat
        `seed_fetch_bytes`."""
        from ..utils.trace import GLOBAL as tracer
        cs = self.shards[k]["copy_stream"]

        def fetch(t):
            with tracer.span("seed.fetch"):
                if cs is None:
                    a = self.fetch(t)
                else:
                    ev = sub.get("event")
                    if ev is not None:
                        cs.wait_event(ev)
                    with on_stream(cs):
                        a = self.fetch(t)
            self._stat("seed_fetch_bytes", a.nbytes)
            return a
        return fetch

    def seeds_collect(self, h: dict):
        """Finish a seeds_dispatch (each shard in its thread) as one
        array-native IntvBatch in read order; pins the shards' padded
        reads as the device-resident reads of the following extension
        waves. A shard's redo programs run on its seed stream. The
        handle's "_post_redo_dispatch" hook (AlignPipeline.run), if any,
        fires once every shard has queued its seed program and its
        first device-redo level, if any (smem_torch.seed_collect_batch:
        a second level, rare, queues after it; JAX batch.py:375-378). The hook's time (the next batch's
        seeds_dispatch, which counts its own) is left out of this
        collect's seed_s."""
        self._stat("reads", h["n_reads"])
        parts = h["parts"]
        self._dev_shards = [(lo, hi, q_dev) for (lo, hi), (q_dev, _)
                            in zip(h["bounds"], parts)]
        cb = h.pop("_post_redo_dispatch", None)
        hook_s = [0.0] * len(parts)     # a shard's time in the hook
        if cb is not None:
            left = [len(parts)]
            lock = threading.Lock()

            def shard_done(k):
                with lock:
                    left[0] -= 1
                    last = left[0] == 0
                if last:
                    t0 = time.perf_counter()
                    try:
                        cb()
                    finally:
                        hook_s[k] = time.perf_counter() - t0
            for k, (_, sub) in enumerate(parts):
                sub["_post_redo_dispatch"] = functools.partial(
                    shard_done, k)

        def collect(k):
            t0 = time.perf_counter()
            sub = parts[k][1]
            with on_stream(self.shards[k]["seed_stream"]):
                batch = smem_torch.seed_collect_batch(
                    sub, self._seed_fetch(k, sub))
            self._stat("seed_s", time.perf_counter() - t0 - hook_s[k],
                       shard=k)
            return batch

        t0 = time.perf_counter()
        batches = run_shards(collect, len(parts))
        self._stat("seed_s", time.perf_counter() - t0 - sum(hook_s))
        for q_dev, sub in parts:
            if q_dev.device.type == "cuda":
                # the waves read the padded reads on the device's default
                # stream: after their upload (complete: the results were
                # copied back after it), and never from a block the seed
                # stream's allocator has handed out again
                wave_stream = torch.cuda.default_stream(q_dev.device)
                wave_stream.wait_event(sub["event"])
                q_dev.record_stream(wave_stream)
        self._stat("seed_batches")
        if any("meta" in sub for _, sub in parts):
            self._stat("seed_wide")
        for name in ("redo_device", "redo_golden"):
            self._stat("seed_" + name, sum(sub.get(name, 0)
                                           for _, sub in parts))
        h["sa_vals"] = [v for _, sub in parts
                        for v in (sub.get("sa_vals")
                                  or [None] * len(sub["reads"]))]
        self._stat("sa_values", sum(len(v) for v in h["sa_vals"]
                                    if v is not None))
        return IntvBatch.concat(batches)

    def _luts(self, all_intvs, sa_flat):
        """Per read, (x0, k) -> the occurrence's SA value (sa_flat
        carries no owners: resolve_sa_flat)."""
        luts = [dict() for _ in range(len(all_intvs))]
        for (ridx, x0, k), v in zip(
                chain_native.owners_for(self.opt, all_intvs), sa_flat[0]):
            luts[ridx][(x0, k)] = int(v)
        return luts

    def chain_reads(self, seqs, all_intvs, sa_flat):
        """Stage 3: host chaining (exact bwa semantics) in the native C++
        stage; long reads the seed-SW filter applies to take the Python
        path."""
        vals, off, _ = sa_flat
        out = chain_native.chain_batch(self.opt, self.fm, seqs, all_intvs,
                                       vals, off)
        need = [r for r, c in enumerate(out) if c is None]
        if need:
            luts = self._luts(all_intvs, sa_flat)
            for r in need:
                out[r] = chain_read(self.opt, self.fm, seqs[r],
                                    all_intvs[r], luts[r])
        return out

    def align_regs(self, seqs: list[np.ndarray], names=None) -> list:
        """Seed + chain + extend + dedup for a batch of encoded reads;
        returns per-read AlnReg lists (mem_align1_core over a batch).
        Every validate_every-th batch is validated (_validate); `names`,
        the reads' names, go into the messages of DeviceResultError."""
        opt, fm = self.opt, self.fm
        self._batch_no += 1
        h = self.seeds_dispatch(seqs)
        all_intvs = self.seeds_collect(h)
        sa_flat = self.resolve_sa_flat(all_intvs, h)
        all_regs = region_native.unpack_regs(*self.extend_waves_packed(
            seqs, all_intvs, sa_flat, names=names))
        final = [dedup_regs(opt, fm, seq, regs)
                 for seq, regs in zip(seqs, all_regs)]
        if self.validate_every and self._batch_no % self.validate_every == 0:
            self._validate(seqs, final, names)
        return final

    def _validate(self, seqs, got_regs, names=None) -> None:
        """Cross-check an evenly spaced sample of validate_sample reads
        against the golden model, the reference's FPGA wrong-result
        detector (FPGAPipeline.cpp:29-130); a mismatch raises
        DeviceResultError, where the JAX package degrades to the
        host."""
        self._stat("validations")
        n = len(seqs)
        for i in range(0, n, max(1, n // max(1, self.validate_sample))):
            name = f" ({names[i]})" if names else ""
            check_against_golden(self.opt, self.fm, seqs[i], got_regs[i],
                                 f"read {i}{name} of batch "
                                 f"{self._batch_no}")

    # ------------------------------------------------------------------
    # the extension (JAX batch.py:516-952)

    def extend_async(self, seqs, all_intvs, sa_flat, names=None):
        """Run extend_waves_packed in a worker thread; returns join(),
        which waits, re-raises the worker's error and returns (rows,
        frac, off). join.abandon() is for a run that failed elsewhere: it
        makes the worker give up at its next device wait or loop turn
        (no second device timeout) and waits for it, its error dropped.
        The device-resident reads
        are taken HERE, on the caller's thread, because the caller goes
        on to seed the next batch, whose collect repoints them. One
        extension at a time. The worker's waves run on the device's
        default stream, which waits for the reads' upload on the seed
        stream (seeds_collect), and the watchdog's events (wait) watch
        the stream the waves ran on; the next batch's seed program runs
        beside them on its own stream. The worker's whole run is the
        tracer's span `extend`."""
        from ..utils.trace import GLOBAL as tracer
        pinned = self._dev_shards
        box: dict = {}
        abort = threading.Event()

        def work():
            try:
                with tracer.span("extend"):
                    box["v"] = self.extend_waves_packed(
                        seqs, all_intvs, sa_flat, pinned=pinned,
                        names=names, abort=abort)
            except BaseException as e:  # noqa: BLE001 - re-raised at join
                box["e"] = e

        th = threading.Thread(target=work, name="extend", daemon=True)
        th.start()

        def join():
            th.join()
            if "e" in box:
                raise box["e"]
            return box["v"]

        def abandon():
            abort.set()
            th.join()
        join.abandon = abandon
        return join

    def extend_waves_packed(self, seqs, all_intvs, sa_flat, pinned=None,
                            names=None, abort=None):
        """Stages 3-4: C++ chaining and per-read
        extension state machines (one _wave driver a shard), with this
        thread moving descriptor waves to each shard's device, two wave
        streams a shard served round-robin, while harvester threads run
        pending reads on the exact scalar kernel (they steal round-robin
        across the shards). Returns packed regions (rows int64[NR, 12],
        frac float64[NR], off int64[n+1]) in read order, which feed the
        native tails directly. Long reads the seed-SW filter applies to
        run through the Python chain and mem_chain2aln and are spliced
        in.

        Wave tasks come in two kernel shape classes, slots sorted by
        class: both query sides at most Q_SMALL, and the rest. Every
        packed task runs at band w (band retries are recomputed on the
        host), so the DP never touches target rows past qlen_side + w,
        and each class runs at tmax = ceil8(qmax_class + w + 1) — the
        exact clamp of seed_extend_desc_batch. Only the filled lanes
        launch. Every wave's rows pass the structural check (bad_rows)
        before the driver applies them: a bad row raises
        DeviceResultError naming the read, the field and the wave lane,
        and is never recomputed on the host. `pinned` is the shards'
        (lo, hi, resident reads) to use in place of the last collect's
        (extend_async). Once the event `abort` is set, the next device
        wait or loop turn raises RuntimeError(ABANDONED)."""
        from ..utils.trace import GLOBAL as tracer
        opt = self.opt
        n = len(seqs)
        qmax, tmax = self.qmax, self.tmax
        cap = self.shards[0]["bufs"][0].cap
        max_mat = int(opt.mat.max())
        dev_shards = pinned if pinned is not None else self._dev_shards
        dev_shards = dev_shards or [(0, n, None)]
        W = int(opt.w)
        q_small = min(Q_SMALL, qmax)
        shapes = [(q_small, -(-(q_small + W + 1) // 8) * 8),
                  (qmax, -(-(qmax + W + 1) // 8) * 8)]
        use16 = extend_cuda.fits_i16(qmax, self.smem_L * int(opt.a),
                                     max_mat,
                                     max(opt.pen_clip5, opt.pen_clip3, 0))
        S = len(dev_shards)
        ctxs = []
        needs_global: list = []
        with tracer.span("wave.create"):
            for k, (lo, hi, reads) in enumerate(dev_shards):
                hi = min(hi, n)
                dev_flags = np.fromiter(
                    (1 if reads is not None and len(seqs[r]) <= self.smem_L
                     else 0 for r in range(lo, hi)), np.uint8, hi - lo)
                sub_iv = all_intvs.slice_reads(lo, hi) \
                    if hasattr(all_intvs, "slice_reads") \
                    else all_intvs[lo:hi]
                vals, off, _ = sa_flat
                sub_sa = (vals[off[lo]:off[hi]], off[lo:hi + 1] - off[lo],
                          None)
                wd, needs = wave_native.create_driver(
                    opt, self.fm, seqs[lo:hi], sub_iv, sub_sa, dev_flags,
                    qmax, tmax, cap)
                sh = self.shards[k]
                ctxs.append(dict(k=k, lo=lo, wd=wd, reads=reads,
                                 device=sh["device"], dfm=sh["dfm"],
                                 params=sh["bufs"][0]._params(
                                     opt, sh["device"],
                                     lambda a, d: self.put(a, d, abort)),
                                 inflight=[0, 0]))
                needs_global.extend(lo + r for r in needs)
        # the tail a shard drains on the host instead of packing a wave
        drain_lim = self.drain_max if S == 1 or not self.drain_max \
            else max(64, self.drain_max // S)
        harvesting = self.harvest_workers > 0
        stop_ev = threading.Event()

        def live():
            if abort is not None and abort.is_set():
                raise RuntimeError(ABANDONED)
            return True

        def harvest(start):
            # steals that found nothing, each followed by a 1 ms wait:
            # counted here and added once, so the loop takes no lock
            i, idle = start, 0
            try:
                while not stop_ev.is_set():
                    got = 0
                    for j in range(S):
                        got = wave_native.steal(ctxs[(i + j) % S]["wd"],
                                                STEAL_READS)
                        if got:
                            break
                    i += 1
                    if got == 0:
                        idle += 1
                        stop_ev.wait(0.001)
            finally:
                self._stat("harvest_idle_polls", idle)

        hthreads = [threading.Thread(target=harvest, args=(j,),
                                     name=f"harvest{j}", daemon=True)
                    for j in range(self.harvest_workers)]

        def pack_run(ctx, si):
            wd = ctx["wd"]
            eligible = wave_native.n_pending(wd) - ctx["inflight"][1 - si]
            if 0 < eligible <= drain_lim:
                if harvesting:
                    return None   # the harvesters own the tail
                with tracer.span("wave.drain"):
                    wave_native.drain(wd)
                return None
            with tracer.span("wave.pack"):
                r = wave_native.pack(wd, si, -1 if harvesting else 0,
                                     q_small if q_small < qmax else 0)
            if r is None:
                return None
            slots, desc, n_small = r
            count = len(slots)
            desc = desc[:, :count]
            k = ctx["k"]
            n0 = (extend_cuda.n_launches, extend_cuda.n_launches16)
            with tracer.span("wave.dispatch"):
                dd = self.put(narrow_desc(desc), ctx["device"], abort)
                outs = [seed_extend_desc_batch(
                    qm, tm, self.smem_L, ctx["dfm"], ctx["reads"],
                    dd[:, lo_s:hi_s], *ctx["params"], use16=use16)
                    for lo_s, hi_s, (qm, tm) in ((0, n_small, shapes[0]),
                                                 (n_small, count, shapes[1]))
                    if hi_s > lo_s]
                out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
            # waves launch from this thread only, so the counts' change
            # is this wave's
            self._stat("launches", extend_cuda.n_launches - n0[0], shard=k)
            self._stat("launches16", extend_cuda.n_launches16 - n0[1],
                       shard=k)
            for shard in (None, k):
                self._stat("waves", shard=shard)
                self._stat("ext_tasks_device", count, shard=shard)
            ctx["inflight"][si] = count
            return out, slots, desc

        def apply(ctx, si, entry):
            out, slots, desc = entry
            with tracer.span("wave.fetch"):
                rows = self.fetch(out, abort)
            with tracer.span("wave.apply"):
                bad = bad_rows(desc, rows, max_mat)
                if bad is not None:
                    raise_bad_row(bad, rows, ctx["lo"] + int(slots[bad[0]]),
                                  names)
                wave_native.apply_results(ctx["wd"], si, rows)
            ctx["inflight"][si] = 0

        try:
            streams = [[ctx, si, None] for ctx in ctxs for si in (0, 1)]
            for s_ in streams:
                s_[2] = pack_run(s_[0], s_[1])
            # harvesters start after the first waves are packed: the
            # device gets first claim on full waves
            for t in hthreads:
                t.start()
            while live() and any(s_[2] is not None for s_ in streams):
                for s_ in streams:
                    ctx, si, entry = s_
                    if entry is not None:
                        apply(ctx, si, entry)
                    s_[2] = pack_run(ctx, si)
            if harvesting:
                # this thread joins the harvest until no claimable read
                # is left, then the harvesters stop
                with tracer.span("wave.drain"):
                    while live() and sum(wave_native.steal(ctx["wd"],
                                                           STEAL_READS)
                                         for ctx in ctxs):
                        pass
                stop_ev.set()
            with tracer.span("wave.drain"):
                for ctx in ctxs:
                    live()
                    wave_native.drain(ctx["wd"])
        finally:
            # the harvesters hold a raw pointer into each driver: they
            # must exit before the drivers are released, also on an
            # exception (a thread never started cannot be joined)
            stop_ev.set()
            for t in hthreads:
                if t.ident is not None:
                    t.join()
        rows_l, frac_l, off_parts = [], [], [np.zeros(1, np.int64)]
        total = 0
        for ctx in ctxs:
            wd = ctx["wd"]
            self._stat("ext_tasks_host", wave_native.host_tasks(wd))
            for name, v in zip(("host_oversize_q", "host_oversize_t",
                                "host_sched"),
                               wave_native.host_breakdown(wd)):
                self._stat(name, v)
            rows, frac, off = wave_native.finish(wd)
            rows_l.append(rows)
            frac_l.append(frac)
            off_parts.append(off[1:] + total)
            total += int(off[-1])
        rows = np.concatenate(rows_l)
        frac = np.concatenate(frac_l)
        off = np.concatenate(off_parts)
        if needs_global:
            luts = self._luts(all_intvs, sa_flat)
            py = {}
            for r in needs_global:
                chains = chain_read(opt, self.fm, seqs[r], all_intvs[r],
                                    luts[r])
                regs: list = []
                for c in chains:
                    regionops.mem_chain2aln(opt, self.fm, len(seqs[r]),
                                            seqs[r], c, regs)
                py[r] = regs
                self._stat("ext_tasks_host",
                           sum(len(c.seeds) for c in chains))
            rows, frac, off = wave_native.splice(rows, frac, off, py)
        return rows, frac, off

    # ------------------------------------------------------------------
    def align_se(self, reads: list[Read], n_processed: int = 0,
                 rg_id: str = "") -> None:
        """Batched single-end alignment: fills each read's .sam."""
        all_regs = self.align_regs([s.seq for s in reads],
                                   [s.name for s in reads])
        for i, (s, regs) in enumerate(zip(reads, all_regs)):
            se_sam(self.opt, self.fm, s, regs, n_processed + i, rg_id)

    def align_pe(self, reads: list[Read], n_processed: int = 0,
                 pes0=None, rg_id: str = "") -> None:
        """Batched paired-end alignment over interleaved reads: pestat
        of the batch unless `pes0` is given, then pairing and SAM."""
        opt, fm = self.opt, self.fm
        all_regs = self.align_regs([s.seq for s in reads],
                                   [s.name for s in reads])
        pes = pes0 if pes0 is not None else peops.mem_pestat(
            opt, fm.bns.l_pac, all_regs)
        for i in range(len(reads) >> 1):
            j = i << 1
            peops.mem_sam_pe(opt, fm, pes, (n_processed >> 1) + i,
                             reads[j:j + 2], all_regs[j:j + 2], rg_id)
