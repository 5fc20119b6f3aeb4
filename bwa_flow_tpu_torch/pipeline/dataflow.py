"""Host dataflow runtime: device stages on the main process, host stages
in a worker pool, batches in a two-deep software pipeline.

Port of bwa_flow_tpu/pipeline/dataflow.py (single-end):

  - the device stages (SMEM seeding, SA probes, extension waves) run on
    the main process, which owns the torch device;
  - the host stages (seed chaining, region dedup/primary/SAM) are
    GIL-bound Python, so they run in a process pool; the FM index
    reaches the workers by fork copy-on-write;
  - while batch N's host tail runs in the pool (from a background
    thread), batch N+1's device work runs on the main thread;
  - finished batches are emitted in order on the main process.

The pool is created before the device upload of the index. Workers only
run NumPy host stages and never touch torch.cuda.
"""

from __future__ import annotations

import multiprocessing as mp
import threading
from typing import Callable, Iterable

from ..io.sam import Read
from ..utils.opts import MemOpt
from .batch import BatchAligner, chain_read, dedup_regs, se_sam

_G: dict = {}


def _init_worker(opt, fm, rg_id=""):
    _G["opt"] = opt
    _G["fm"] = fm
    _G["rg_id"] = rg_id


def _chain_worker(arg):
    """Stage: seeds -> filtered chains for a slice of reads."""
    return [chain_read(_G["opt"], _G["fm"], seq, intvs, lut)
            for seq, intvs, lut in arg]


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


def _slices(items, n_slices):
    k = max(1, -(-len(items) // n_slices))
    return [items[i:i + k] for i in range(0, len(items), k)]


class AlignPipeline:
    """Device + worker-pool single-end aligner over a batch stream."""

    def __init__(self, opt: MemOpt, fm, paired: bool = False,
                 n_workers: int = 0, rg_id: str = "",
                 aligner_kw: dict | None = None, mp_context: str = "fork",
                 device=None):
        if paired:
            raise NotImplementedError(
                "bwa_flow_tpu_torch: paired-end alignment is not ported "
                "yet (single-end only)")
        self.opt = opt
        self.fm = fm
        self.rg_id = rg_id
        self.n_workers = n_workers
        self.pool = None
        _init_worker(opt, fm, rg_id)
        if n_workers > 0:
            # before the device upload below: the workers fork from a
            # process that holds no index tensors of its own making
            ctx = mp.get_context(mp_context)
            self.pool = ctx.Pool(n_workers, initializer=_init_worker,
                                 initargs=(opt, fm, rg_id))
        try:
            self.ba = BatchAligner(opt, fm, device=device,
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

    def _chains(self, seqs, intvs, sa_flat):
        vals, _, owners = sa_flat
        luts = BatchAligner._luts_from(owners, vals, len(seqs))
        return self._run_parts(_chain_worker, list(zip(seqs, intvs, luts)))

    def _tail_async(self, batch, all_regs):
        """Run the post-extension tail in a background thread (its work
        uses the pool); returns join() -> the finished batch. A tail
        failure is re-raised at join and fails the run."""
        box: dict = {}

        def run_tail():
            try:
                work = [(r.seq, r.name, r.qual, r.comment, all_regs[i],
                         r.id) for i, r in enumerate(batch)]
                sams = self._run_parts(_se_tail_worker, work)
                for r, s in zip(batch, sams):
                    r.sam = s
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

    # -- the pipeline --------------------------------------------------
    def run(self, batches: Iterable[list[Read]],
            emit: Callable[[list[Read]], None]) -> int:
        """Pipelined batch loop: the next batch's seeding runs right after
        this batch's seed collect, and each batch's host tail overlaps
        the next batch's device work. Calls emit(batch) in order with
        .sam filled; returns reads processed."""
        from ..utils.trace import GLOBAL as tracer
        n_processed = 0
        pending = None  # join() of the previous batch's tail
        prev = None     # batch N-1, extended, waiting for its tail
        it = iter(batches)
        cur = next(it, None)
        cur_h = None
        if cur is not None:
            with tracer.span("seed"):
                cur_h = self.ba.seeds_dispatch([r.seq for r in cur])
        while cur is not None:
            seqs = [r.seq for r in cur]
            nxt = next(it, None)
            with tracer.span("seed"):
                intvs = self.ba.seeds_collect(cur_h)
            with tracer.span("sa"):
                sa_flat = self.ba.resolve_sa_flat(intvs, cur_h)
            nxt_h = None
            if nxt is not None:
                with tracer.span("seed"):
                    nxt_h = self.ba.seeds_dispatch([r.seq for r in nxt])
            if prev is not None:
                pending = self._finish_batch(prev, pending, emit)
                prev = None
            with tracer.span("chain"):
                chains = self._chains(seqs, intvs, sa_flat)
            with tracer.span("extend_waves"):
                regs = self.ba.extend_waves(seqs, chains)
            prev = dict(reads=cur, regs=regs)
            n_processed += len(cur)
            cur, cur_h = nxt, nxt_h
        if prev is not None:
            pending = self._finish_batch(prev, pending, emit)
        if pending is not None:
            with tracer.span("emit_wait"):
                emit(pending())
        return n_processed

    def _finish_batch(self, prev, pending, emit):
        """Emit the batch before `prev` and start `prev`'s tail."""
        from ..utils.trace import GLOBAL as tracer
        if pending is not None:
            with tracer.span("emit_wait"):
                emit(pending())
        return self._tail_async(prev["reads"], prev["regs"])
