"""A whole run of the harness on the CPU at a tiny size (the look for a
card skipped): sound, it comes out correct; with the timed path broken
underneath it comes out not correct, once for each fault the cells can
have. (A four-chip exchange does not exist here: every cell takes one
card.)"""

import sys

import pytest

from conftest import tiny_cell

SECONDS = 4.0
# planted duplicates, from earlier batches too, so that a markdup fault
# has pairs to miss in a window of a few tiny batches
DUPS = {"dup_frac": 0.1}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(bench, cell_name, seed=2**31 + 5, **mix_keys):
    import run
    cell, config, mix, limits = tiny_cell(bench, cell_name, **mix_keys)
    res = run.run_cell(bench, cell, config, mix, limits, seed, SECONDS,
                       False, device="cpu")
    assert res.pop("_forbidden") == []
    assert not {"jax", "jaxlib", "flax", "bwa_flow_tpu"} & {
        m.split(".", 1)[0] for m in sys.modules}
    return res


@pytest.mark.parametrize("cell,mix_keys", [
    ("ecoli.pe151", {}), ("ecoli.pe151", DUPS), ("dm6.se151", {}),
    ("dm6.pe151", {})])
def test_sound_run_is_correct(bench_kept, tiny_cache, cell, mix_keys):
    res = _run(bench_kept, cell, **mix_keys)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


def _markdup_state_unchanged(monkeypatch):
    """A step that returns its state unchanged: markdup's process marks
    nothing and keeps no signature."""
    from bwa_flow_tpu_torch.dedup import markdup
    real = markdup.make_markdup_stage

    def stage(*a, **k):
        st = real(*a, **k)
        st.process = lambda chunk: None
        return st
    monkeypatch.setattr(markdup, "make_markdup_stage", stage)


def _markdup_reset_each_chunk(monkeypatch):
    """Markdup's signature store lost at every chunk: duplicates within
    a batch are still marked, those of an earlier batch's pairs are not."""
    from bwa_flow_tpu_torch.dedup import markdup
    real = markdup.make_markdup_stage

    def stage(fm, *a, **k):
        st = real(fm, *a, **k)
        process = st.process

        def fresh(chunk):
            st.state = markdup.NativeMarkDupState(fm.bns.anns,
                                                  st.state.ignore_unmated)
            process(chunk)
        st.process = fresh
        return st
    monkeypatch.setattr(markdup, "make_markdup_stage", stage)


def _half_batch_dropped(monkeypatch):
    """Half of every batch left out: its reads come back with no record."""
    from bwa_flow_tpu_torch.pipeline import dataflow
    real = dataflow.AlignPipeline._tail_pe

    def tail(self, batch, regs):
        real(self, batch, regs)
        for r in batch[len(batch) // 2:]:
            r.sam = ""
    monkeypatch.setattr(dataflow.AlignPipeline, "_tail_pe", tail)


def _pe_tail_edit(monkeypatch, edit):
    """The native PE tail with `edit(i, fields)` applied to each of its
    SAM lines, where they are produced."""
    from bwa_flow_tpu_torch.ops import region_native
    real = region_native.pe_tail_batch

    def tail(*a, **k):
        sams, pes = real(*a, **k)
        out = []
        for i, s in enumerate(sams):
            f = s.split("\t")
            if f[2] != "*" and not int(f[1]) & 4:
                edit(i, f)
            out.append("\t".join(f))
        return out, pes
    monkeypatch.setattr(region_native, "pe_tail_batch", tail)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: the native PE tail puts
    every fifth read one base off."""
    def edit(i, f):
        if i % 5 == 0:
            f[3] = str(int(f[3]) + 1)
    _pe_tail_edit(monkeypatch, edit)


def _no_proper_pairs(monkeypatch):
    """A broken insert-size estimate: no pair is flagged proper."""
    def edit(i, f):
        f[1] = str(int(f[1]) & ~0x2)
    _pe_tail_edit(monkeypatch, edit)


def _mapq_zeroed(monkeypatch):
    """MAPQ lost where it is produced: every mapped record reads 0."""
    def edit(i, f):
        f[4] = "0"
    _pe_tail_edit(monkeypatch, edit)


@pytest.mark.parametrize("fault,number,mix_keys", [
    (_markdup_state_unchanged, "dup_unmarked", DUPS),
    (_markdup_reset_each_chunk, "dup_unmarked", DUPS),
    (_half_batch_dropped, "missing", {}),
    (_answer_altered, "record_faults", {}),
    (_no_proper_pairs, "pair_faults", {}),
    (_mapq_zeroed, "mapq_faults", {}),
])
def test_fault_is_not_correct(bench_kept, tiny_cache, monkeypatch, fault,
                              number, mix_keys):
    fault(monkeypatch)
    res = _run(bench_kept, "ecoli.pe151", **mix_keys)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]
