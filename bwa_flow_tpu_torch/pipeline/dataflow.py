"""Host dataflow runtime: device stages on the main process, host stages
in native code (a worker pool for the few reads that take the Python
tail), batches in a two-deep software pipeline.

Port of bwa_flow_tpu/pipeline/dataflow.py's native route. Batch N+1's
seed program is enqueued (dispatch_next, AlignPipeline.run) the moment
batch N's last dependent device work is queued, from the hook that
comes first: the seed collect's, after the redo programs (an index with
a dense SA); the SA probes', after the probe walks (without one); or the
pipeline's own call after a collect that succeeded. On a card the seed
program's machines are kernels (ops/smem_cuda.py) on the shard's own
seed stream, so the enqueue returns at once and the card seeds batch
N+1 while the host finishes batch N. Then (pipeline/batch.py):

  - the main thread collects batch N's seeds and SA values, then starts
    batch N's chaining and extension (BatchAligner.extend_async) in a
    worker thread;
  - batch N's packed regions feed the native tails in the tail thread
    (ops/region_native.py: se_tail_batch; pe_tail_batch, -I included),
    GIL released, while batch N+1's seeds are collected;
  - the -V flag (MEM_F_REF_HDR) and reads without qualities (FASTA)
    take the Python tail in the pool (after the native dedup_batch, for
    paired-end batches), whose workers get the FM index by fork
    copy-on-write;
  - finished batches are emitted in order on the main process.

With several devices (`devices`), the batch aligner cuts each batch
into per-device shards (pipeline/batch.py); the host stages and the
emission still see whole batches in read order.

The pool is created before the device upload of the index and its
replicas. Workers only run NumPy host stages (mate rescue included:
ksw_align2 is host code) and never touch torch.cuda.

With validate_every > 0, a sample of every Nth batch's regions is held
to the golden model before the batch's tail starts (_validate_sample); a
mismatch raises DeviceResultError and the run fails, as does a
TimeoutError of the batch aligner's watchdog (device_timeout), and an
error of the early enqueue (raised at the next seeds collect).
"""

from __future__ import annotations

import copy
import functools
import multiprocessing as mp
import threading
import time
from typing import Callable, Iterable

from .. import _build
from ..io.sam import Read
from ..ops import pe as peops
from ..ops import region_native
from ..utils.opts import MemOpt
from .batch import BatchAligner, check_against_golden, dedup_regs, se_sam

_G: dict = {}


def _init_worker(opt, fm, rg_id=""):
    _G["opt"] = opt
    _G["fm"] = fm
    _G["rg_id"] = rg_id


def _se_tail_worker(arg):
    """Stage: regions -> dedup/primary/SAM for a slice of reads."""
    opt, fm = _G["opt"], _G["fm"]
    out = []
    for seq, name, qual, comment, regs, rid_ in arg:
        s = Read(name=name, seq=seq, qual=qual, comment=comment, id=rid_)
        se_sam(opt, fm, s, dedup_regs(opt, fm, seq, regs), rid_,
               _G["rg_id"])
        out.append(s.sam)
    return out


def _pe_pair_worker(pes, pairs):
    """Stage: dedup'd regions -> mate rescue/pairing/SAM for a slice of
    read pairs, under one insert-size estimate `pes`."""
    opt, fm = _G["opt"], _G["fm"]
    out = []
    for r1, r2, regs1, regs2, pair_id in pairs:
        s1 = Read(name=r1[1], seq=r1[0], qual=r1[2], comment=r1[3],
                  id=2 * pair_id)
        s2 = Read(name=r2[1], seq=r2[0], qual=r2[2], comment=r2[3],
                  id=2 * pair_id + 1)
        peops.mem_sam_pe(opt, fm, pes, pair_id, [s1, s2], [regs1, regs2],
                         _G["rg_id"])
        out.append((s1.sam, s2.sam))
    return out


def _slices(items, n_slices):
    k = max(1, -(-len(items) // n_slices))
    return [items[i:i + k] for i in range(0, len(items), k)]


class AlignPipeline:
    """Device + worker-pool aligner over a batch stream. Paired-end
    batches hold mates interleaved; `pes0` (the -I option) replaces the
    per-batch insert-size estimate. `devices`, a list of torch devices,
    shards every batch over them (BatchAligner); else the run is on
    `device`. validate_every, validate_sample, device_timeout and
    `ext_mode` go to the BatchAligner (one device, every shard, every
    rank alike); validation runs here, on each validated batch's
    regions before its tail. The pool (`n_workers` > 0) runs the Python
    tails only (module docstring)."""

    def __init__(self, opt: MemOpt, fm, paired: bool = False,
                 n_workers: int = 0, rg_id: str = "", pes0=None,
                 aligner_kw: dict | None = None, mp_context: str = "fork",
                 device=None, devices=None, validate_every: int = 0,
                 validate_sample: int = 2, device_timeout: float = 300.0,
                 native: bool = True, ext_mode: str | None = None):
        # `native` stays only for callers that still pass native=True
        if native is not True:
            raise ValueError(f"native={native!r}: the port has one route, "
                             "the native route (native=True)")
        self.opt = opt
        self.fm = fm
        self.paired = paired
        self.pes0 = pes0
        self.rg_id = rg_id
        self.n_workers = n_workers
        self.pool = None
        # the adaptive downgrade of the early enqueue (run)
        self._best_seed_s = float("inf")
        self._slow_seed_streak = 0
        _init_worker(opt, fm, rg_id)
        if n_workers > 0:
            # before the device upload below: the workers fork from a
            # process that holds no index tensors of its own making, and
            # before any harvester, extension or tail thread exists. The
            # workers' ksw_extend2/ksw_global2 run the _native host
            # library: loaded here, no worker builds it or waits for it.
            _build.host_module("_native")
            ctx = mp.get_context(mp_context)
            self.pool = ctx.Pool(n_workers, initializer=_init_worker,
                                 initargs=(opt, fm, rg_id))
        try:
            self.ba = BatchAligner(opt, fm, device=device, devices=devices,
                                   validate_every=validate_every,
                                   validate_sample=validate_sample,
                                   device_timeout=device_timeout,
                                   ext_mode=ext_mode,
                                   **(aligner_kw or {}))
        except BaseException:
            self.close()
            raise

    def close(self):
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
            self.pool = None

    # -- stage drivers -------------------------------------------------
    def _run_parts(self, fn, work):
        """Map fn over slices of work (pool or inline), flattened."""
        if self.pool is None:
            return fn(work)
        parts = self.pool.map(fn, _slices(work, self.n_workers))
        return [x for p in parts for x in p]

    def _tail_async(self, batch, packed):
        """Run the post-extension tail in a background thread (its work
        uses the pool), inside the span `tail`; returns join() -> the
        finished batch. A tail failure is re-raised at join and fails the
        run."""
        from ..utils.trace import GLOBAL as tracer
        box: dict = {}
        tail = self._tail_pe if self.paired else self._tail_se

        def run_tail():
            try:
                with tracer.span("tail"):
                    tail(batch, packed)
            except BaseException as e:  # noqa: BLE001 - re-raised in join
                box["err"] = e

        t = threading.Thread(target=run_tail)
        t.start()

        def join():
            t.join()
            if "err" in box:
                raise box["err"]
            return batch
        return join

    def _tail_se(self, batch, packed) -> None:
        """Native SE tail on the packed regions where se_tail_ok holds,
        else dedup/primary/SAM in the pool."""
        if region_native.se_tail_ok(self.opt, batch):
            ctr: dict = {}
            sams = region_native.se_tail_batch(
                self.opt, self.fm, batch, None, self.rg_id, packed=packed,
                counters=ctr)
            self._record_tail(ctr)
            for r, s in zip(batch, sams):
                r.sam = s
            return
        all_regs = region_native.unpack_regs(*packed)
        work = [(r.seq, r.name, r.qual, r.comment, all_regs[i], r.id)
                for i, r in enumerate(batch)]
        sams = self._run_parts(_se_tail_worker, work)
        for r, s in zip(batch, sams):
            r.sam = s

    def _record_tail(self, ctr: dict) -> None:
        """A native tail's counters: its phases' seconds as the tracer's
        `tail.<phase>`; its rescue's ksw_align2 calls, those of them
        that ran striped, and its pairs as the stats `tail_matesw`,
        `tail_matesw_vec` and `tail_pairs`."""
        from ..utils.trace import GLOBAL as tracer
        for k in ("dedup", "rescue", "pair", "sam"):
            if k in ctr:
                tracer.add("tail." + k, ctr[k])
        for k in ("matesw", "matesw_vec", "pairs"):
            if k in ctr:
                self.ba._stat("tail_" + k, ctr[k])

    def _tail_pe(self, batch, packed) -> None:
        """The native PE tail on the packed regions where pe_tail_ok
        holds (dedup, insert size unless `pes0`, rescue, pairing, SAM).
        Otherwise the native dedup_batch; the insert-size estimate of the
        batch on the deduped regions (unless `pes0`); then rescue,
        pairing and SAM in the pool. Pair ids are r1.id >> 1, as on the
        golden route."""
        if region_native.pe_tail_ok(self.opt, batch):
            ctr: dict = {}
            sams, _ = region_native.pe_tail_batch(
                self.opt, self.fm, batch, None, self.rg_id, packed=packed,
                pes0=self.pes0, counters=ctr)
            self._record_tail(ctr)
            for r, s in zip(batch, sams):
                r.sam = s
            return
        regs = region_native.dedup_batch(
            self.opt, self.fm, [r.seq for r in batch],
            region_native.unpack_regs(*packed))
        pes = self.pes0 if self.pes0 is not None else peops.mem_pestat(
            self.opt, self.fm.bns.l_pac, regs)
        pairs = []
        for i in range(len(batch) >> 1):
            j = i << 1
            r1, r2 = batch[j], batch[j + 1]
            pairs.append(((r1.seq, r1.name, r1.qual, r1.comment),
                          (r2.seq, r2.name, r2.qual, r2.comment),
                          regs[j], regs[j + 1], r1.id >> 1))
        sams = self._run_parts(functools.partial(_pe_pair_worker, pes),
                               pairs)
        for i, (s1, s2) in enumerate(sams):
            batch[2 * i].sam = s1
            batch[2 * i + 1].sam = s2

    # -- the pipeline --------------------------------------------------
    def run(self, batches: Iterable[list[Read]],
            emit: Callable[[list[Read]], None]) -> int:
        """Pipelined batch loop (JAX dataflow.py:340-470): collect batch
        N's seeds and SA values; join batch N-1's extension and start
        its host tail (_finish_batch), which overlaps what follows;
        start batch N's extension in a worker thread
        (BatchAligner.extend_async). Batch N+1's seed program is enqueued by
        dispatch_next, once, the moment batch N's last dependent device
        work is queued: from the seed collect's hook after the redo
        programs (an index with a dense SA), after the SA probe walks
        (without one), or at the latest once the collect and SA are
        done, before the extension starts (so the JAX package's
        extension hook, on_started, could never come first: the port
        has none). Not after a failed collect: the device may hang, and
        a dispatch would queue behind it. The seed program uploads its
        reads without waiting and queues on its own stream, so on a card
        it returns at once, and the card seeds batch N+1 through batch
        N's collect tail, extension and tail window. Adaptive downgrade,
        as in the JAX package: once the seed span (collect + SA) of two
        batches in a row exceeds 3x the best, the early hooks are off
        and the next batch is enqueued after the fetches. An error
        inside dispatch_next (on any thread) is kept and raised on the
        main thread at that batch's seeds collect. Calls emit(batch) in
        order with .sam filled; returns reads processed. On an error, an
        extension in flight is abandoned (its device waits give up at
        once) and waited for, since its harvesters hold the driver; then
        the error is raised."""
        from ..utils.trace import GLOBAL as tracer
        ba = self.ba
        n_processed = 0
        pending = None  # join() of the previous batch's tail
        prev = None     # batch N-1: its extension's join
        it = iter(batches)
        cur = next(it, None)
        cur_box: dict = {}
        if cur is not None:
            with tracer.span("seed"):
                cur_box["h"] = ba.seeds_dispatch([r.seq for r in cur])
        try:
            while cur is not None:
                seqs = [r.seq for r in cur]
                nxt = next(it, None)
                nxt_box: dict = {}
                nxt_lock = threading.Lock()

                def dispatch_next(hook, nxt=nxt, box=nxt_box,
                                  lock=nxt_lock):
                    # from the main thread or a shard's collect thread:
                    # the lock makes it once only
                    if nxt is None:
                        return
                    with lock:
                        if box:
                            return
                        try:
                            box["h"] = ba.seeds_dispatch(
                                [r.seq for r in nxt])
                            ba._stat(f"enqueue_{hook}")
                        except BaseException as e:  # noqa: BLE001 - kept
                            box["e"] = e            # for the main thread
                if "e" in cur_box:
                    raise cur_box["e"]
                cur_h = cur_box["h"]
                probe_path = ba.dfm.sa_dense is None
                aggressive = self._slow_seed_streak < 2
                if not aggressive:
                    ba._stat("seed_downgrades")
                if not probe_path and aggressive:
                    cur_h["_post_redo_dispatch"] = functools.partial(
                        dispatch_next, "post_redo")
                t_seed = time.monotonic()
                with tracer.span("seed"):
                    intvs = ba.seeds_collect(cur_h)
                with tracer.span("sa"):
                    sa_flat = ba.resolve_sa_flat(
                        intvs, cur_h, post_dispatch=functools.partial(
                            dispatch_next, "post_dispatch")
                        if probe_path and aggressive else None)
                self._seed_span(time.monotonic() - t_seed)
                dispatch_next("late")   # none if a hook fired it
                if prev is not None:
                    pending = self._finish_batch(prev, pending, emit)
                    prev = None
                prev = dict(reads=cur, ext=ba.extend_async(
                    seqs, intvs, sa_flat, [r.name for r in cur]))
                n_processed += len(cur)
                cur, cur_box = nxt, nxt_box
            if prev is not None:
                pending = self._finish_batch(prev, pending, emit)
                prev = None
        except BaseException:
            if prev is not None:
                prev["ext"].abandon()
            raise
        if pending is not None:
            self._emit(pending, emit)
        return n_processed

    @staticmethod
    def _emit(pending, emit) -> None:
        """Join a batch's tail (span `tail_wait`) and emit it (span
        `emit`), both inside the span `emit_wait`."""
        from ..utils.trace import GLOBAL as tracer
        with tracer.span("emit_wait"):
            with tracer.span("tail_wait"):
                done = pending()
            with tracer.span("emit"):
                emit(done)

    def _seed_span(self, dt: float) -> None:
        """The adaptive downgrade's bookkeeping (JAX dataflow.py:423-429):
        a batch's seed span sets a new best, or extends or ends the
        streak of spans over 3x the best."""
        if dt < self._best_seed_s:
            self._best_seed_s = dt
            self._slow_seed_streak = 0
        elif dt > 3.0 * self._best_seed_s:
            self._slow_seed_streak += 1
        else:
            self._slow_seed_streak = 0

    def _validate_sample(self, batch, regs) -> None:
        """Cross-check an evenly spaced sample of validate_sample reads of
        a batch against the golden model, on their pre-dedup device
        regions deduplicated here (the JAX package's _validate_sample,
        the reference's FPGA wrong-result detector,
        FPGAPipeline.cpp:29-130). A mismatch raises DeviceResultError
        naming the read, the fields and the batch."""
        ba = self.ba
        ba._stat("validations")
        n = len(batch)
        for i in range(0, n, max(1, n // max(1, ba.validate_sample))):
            r = batch[i]
            got = dedup_regs(self.opt, self.fm, r.seq,
                             copy.deepcopy(regs[i]))
            check_against_golden(self.opt, self.fm, r.seq, got,
                                 f"read {r.id} ({r.name}) of batch "
                                 f"{ba._batch_no}")

    def _finish_batch(self, prev, pending, emit):
        """Join `prev`'s extension (span `extend_waves`; its regions come
        packed: (rows, frac, off)), validate `prev` every validate_every
        batches (on its unpacked regions), emit the batch before it and
        start `prev`'s tail."""
        from ..utils.trace import GLOBAL as tracer
        ba = self.ba
        with tracer.span("extend_waves"):
            packed = prev["ext"]()
        if ba.validate_every:
            ba._batch_no += 1
            if ba._batch_no % ba.validate_every == 0:
                self._validate_sample(prev["reads"],
                                      region_native.unpack_regs(*packed))
        if pending is not None:
            self._emit(pending, emit)
        return self._tail_async(prev["reads"], packed)
