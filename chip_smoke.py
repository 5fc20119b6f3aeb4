"""Smoke run of bwa_flow_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

`mem` has one route (pipeline/batch.py), with two extension modes:
host (the default: harvester threads run every extension task, no ksw
kernel) and waves (device waves beside the harvesters). Phases 3, 4,
6, 7, 8 and 9 run --ext-mode waves, since they count device waves or
launches (phase 9's injections and stall, on a few reads, also with no
host drain and no harvester: waves_carry_every_task); phase 10 runs
both modes; phase 11 holds the host libraries to their Python versions
or to known answers.

Phases:
  1. device and build: prints the card (nvidia-smi name, power limit),
     the torch/CUDA versions and the host's CPU count, and builds every
     CUDA kernel of the main paths from bwa_flow_tpu_torch/csrc/ (both
     ksw_extend2 kernels, the four seed kernels and the LF walk) and
     the six host libraries from csrc/host/ (_chain, _region, _wave,
     _native, _markdup, _bam; one nvcc or c++ per source, all started
     together, each timed); prints each kernel's registers, shared
     memory, stack frame and spills as ptxas reports them, and fails if
     a kernel of a seed kernel redesigned for Hopper (REDESIGNED: all
     four) or of the LF walk has a stack frame.
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: the int32 and the int16 ksw_extend2 on 4096
     right-extension tasks of 151 bp reads (qmax=160, tmax=512, some
     degenerate lanes) under three scorings, all inside the int16
     bound; every output must be equal (tolerance 0: all values are
     integers), and the int16 kernel must also equal the int32 one.
     Kernels and plain versions are timed with CUDA events. Then both
     kernels on the chunk-edge mix (make_edge_tasks: query lengths at
     the 32- and 64-column chunk edges, per-lane band widths, h0 up to
     the int16 bound, degenerate lanes) at B=96 and in the partial
     blocks B=1 and B=5, under two scorings: again equal to their plain
     versions and to each other; and the int32 kernel on the same mix
     with 2^23 added to h0 (its wide-score path).
  3. the single-end path: a 4.6 Mbp repeat-realistic genome and 8192 x
     151 bp reads (1% substitutions) from fixed seeds; `index` (its
     seconds printed: the native SA-IS builds the suffix array), then
     `mem -t 8 --batch-reads 4096 --ext-mode waves` on the card through
     the CLI (int32 kernel). Every read must
     have exactly one primary record, >= 95%
     mapped, and the int32 kernel must have launched. Then a 256-read
     subset on the card and with --no-device (the port's host golden):
     the two SAMs must be byte-identical apart from @PG.
  4. the paired-end path on the same genome: 8192 FR pairs of 2 x 151
     bp, insert size N(400, 40), 1% substitutions; `mem -t 8
     --batch-reads 4096 --ext-mode waves ref.fa r1.fq r2.fq` with
     BWA_TPU_EXTEND16=1 (set for this phase only), so the waves run the
     int16 kernel. One
     primary record per read, >= 95% of reads mapped, >= 90% of pairs
     proper, the int16 kernel launched and the int32 one not; a 256-pair
     subset on the card equals its --no-device SAM apart from @PG.
     Phases 3 and 4 record CUDA events around every kernel call and print
     each kernel's summed device time over its path, and the markdup
     stage's class, duplicate count and seconds. Phases 3, 4 and 10 set
     the seed kernels' launch counts to 0 before each run and fail
     unless every seed kernel launched and no plain seed machine ran;
     they print the seed program's seconds a batch and which hook
     enqueued each next batch's seed program.
  5. each kernel at the mean wave size of the path that launched it
     (waves are trimmed to their filled slots): against its plain
     version, timed, with its bound; and the time a target row costs it
     (row_cost_ns), the latency that sets its time on the path.
  6. the sorted-BAM path: phase 4's paired-end run again with `--sort`
     (default 512 buckets), with --ext-mode waves and BWA_TPU_EXTEND16
     unset, so its waves run the int32 kernel. The int32 kernel must
     have launched and the int16 one not; the BAM must inflate with gzip
     and end in the BGZF EOF block, carry the index's contigs, have
     non-decreasing sort keys with unmapped records last, and hold the
     same multiset of records as phase 4's pe.sam, each record's fields
     as the SAM line's (bam_fields_check) and its bytes those of
     _bam.sam_to_bam on the line (so the two kernels' SAM agree over
     8192 pairs); the merge again on the run's buckets must give the
     same BAM. Prints the time split: alignment, bucket writes, merge.
  7. two ranks on the one card: `mem` of phase 3's reads in one process
     (batches of 1024 reads: -t 4 -K 38656 cuts the FASTQ every 1024 x
     151 bp; the native route, --ext-mode waves), then as two processes of `python -m bwa_flow_tpu_torch mem
     --nprocs 2 --dist pull` (gloo process group and the pull work queue
     on free local ports). Both must exit 0 having launched the int32
     kernel, both parts must hold records, and their union must equal
     the one-process SAM. This shows the path works, not scale-out
     speed: both ranks share one card and the host's cores.
  8. the coupled two-try seed_extend_batch on 4096 lanes of
     make_coupled_tasks (qmax=160, tmax=512; both sides, one side empty,
     2w retries on each side) against its plain version on the CPU
     under phase 2's three scorings, timed with CUDA events. Then one
     process on two shards (--local-devices): two distinct cards when
     the host has two, else two shards, each with its own index
     replica, on the one card. The mesh dry run (entry.dryrun_multichip:
     the sharded seed + coupled-extension step with its psum checks,
     then the production pipeline with two shards, SAM equal to one
     device); entry()'s step on the card against the CPU; then phase
     3's single-end run over the shards through the CLI's _mem with
     --ext-mode waves: every shard must have run waves on the int32
     kernel, and the records must equal phase 3's full.sam byte for
     byte.
  9. the paths no earlier phase runs, and the checks that make a run
     fail, with --ext-mode waves (the injections and the stalls on a few
     reads with no host drain and no harvester, so that device waves
     carry every task): the first 2048 of
     phase 3's reads on the wide path (index.io.FORCE_WIDE: the int64
     seed machine and SA) and with no dense SA (BWA_TPU_DENSE_SA_MAX=0:
     the fused LF walk, which must have launched the sa_walk kernel once
     a sa_batch call and run no plain walk on the card; each call then
     held to the plain version on the card), records equal to the default
     path's in the same phase; -I 400,40 on phase 4's pairs (int16 kernel): 64
     pairs equal to --no-device, >= 90% proper of 2048. Then --validate-every 1 on
     phase 3's reads (SAM == full.sam, one validation a batch), the same
     run with the watchdog off (--device-timeout 0) and on, in turns (its
     cost, beside phase 3, and where it goes: watched waits a batch, the
     seconds inside wait_ready, and the seconds of the device reads, all
     and the seed collect's), one lane's score off by one (the validation
     must name its read), qle = -3 with validation off (the structural
     check), and a
     ~10 s spin kernel queued before a wave's fetch under
     --device-timeout 2: TimeoutError within 2-5 s in process, and a CLI
     subprocess that must exit non-zero.
 10. the native route (the CLI's default): phase 3's reads and phase
     4's pairs at -t 8 in batches of 4096 with --ext-mode host (no ksw
     launch, no device task: the harvesters run every task) and
     --ext-mode waves (device waves: int32 for the reads, int16 for the
     pairs with BWA_TPU_EXTEND16=1), each SAM equal to phase 3's
     full.sam or phase 4's pe.sam byte for byte apart from @PG, with
     phase 3's or 4's duplicate count (both printed); phase
     3's reads over two shards of the one card in waves mode
     (AlignPipeline(devices=[cuda:0, cuda:0]) through _mem), equal to
     full.sam; and a wave row corrupted before the native driver's
     apply (lqle = -3), which must raise DeviceResultError naming its
     wave lane; and a ~10 s spin kernel queued as a CLI subprocess's
     second batch's extension starts (--ext-mode waves, batches of
     512, --device-timeout 2): it must exit non-zero with [E::mem]
     within the timeout plus 2 s (the extension worker's wait is
     abandoned, not waited out). Each run prints its wall, rate,
     spans, the native driver's counters, and each kernel's launches
     and device time. In each waves run every kernel call's inputs are
     copied on the card; afterwards, for each shape class (qmax, tmax)
     the run launched, the launch nearest the class's mean width is
     run again against the plain version on the same inputs (tolerance
     0), timed, with its bound.
 11. the host libraries against their Python versions, or known
     answers, on the card's host, each timed: (a) _native.sais against
     suffix_array on
     both strands of the genome's first 1 Mbp and on tests/test_index.py's
     adversarial texts; (b) ksw_extend2 and ksw_global2 (with CIGAR)
     against ksw_extend2_py and ksw_global2_py on 2000 tasks of
     make_ext_tasks; (c) NativeMarkDupStage on pe.sam, and again with
     its first 512 pairs repeated under new names: the first run's
     marks unchanged, every repeated pair with a mapped mate marked
     duplicate on every line and no other, the count up by as many, at
     least 512 duplicates; (d) bucket writes and the merge of pe.sam
     through the _bam encoder (records as phase 6 checks them, keys
     non-decreasing), and a malformed SAM line given to
     _bam.sam_to_bam in a subprocess, which must exit 1 with ValueError,
     not die by a signal; (e) phase 3's index loaded with RESAMPLE_MIN =
     0: sa_intv 32 -> 4, the table every 4th entry of the full SA, then
     phase 9's reads with BWA_TPU_DENSE_SA_MAX=0 on the LF walk over it
     (the sa_walk kernel once a sa_batch call, no plain walk on the card,
     each call held to the plain version on the card), records equal to
     phase 9's default run.
 12. the seed program's four kernels (seed_p1p3, seed_fwd, seed_bwd,
     seed_cohort) against their plain versions on the card, after phase
     4: collect_intv_device on phase 3's first 4096 reads and on 2048 of
     phase 4's pairs (narrow int32), on the wide int64 machine, with the
     big redo budgets (512 reads, MAXM 256), with p2x = 4, and on
     LONG_READS reads of LONG_LEN bp cut from the genome (1%
     substitutions, both strands) at smem_L = LONG_L, above the int16
     stage's limit (seed_p1p3's unstaged variant; timed). Each
     batch's whole program on the kernels must equal the same program on
     the plain versions, and each kernel call of it must equal its plain
     version on the same inputs, every output array, tolerance 0 (a
     machine state's drop-sentinel slot is a write sink, not an
     output). On the SE, PE and long batches each kernel (its launcher, on
     inputs made beforehand, the stream held by a spin kernel while the
     launches are queued) and each plain version is timed with CUDA
     events, beside a bound: the larger of its HBM bytes (the index,
     the reads or symbol table and each lane's inputs read once, the
     lanes' state and the stores written once; a lane's repeated FM row
     gathers hit the L2) over 3.35 TB/s and its int32 operations
     (OPS_PER_PROBE a probe) over 16.7e12/s, the steps counted on the
     plain run; seed_fwd's live lanes (mode 1 on entry) and probes a
     call are printed. Beside the bound, each timed call of seed_p1p3,
     seed_fwd and seed_bwd gets a chain floor: its longest lane's probes
     (counted per lane on the plain run, or for the backward walk from
     its results) times the card's dependent L2-hit latency, which the
     phase measures first (CHASE_CU: one thread's pointer chase over
     random 32-byte sectors of a buffer the index's size, warm). Then a
     BatchAligner's seeds_dispatch of the SE batch must upload its reads
     without a wait, make no fetch, wait or put, and torch's sync debug
     mode must report no synchronising call in the whole dispatch.
 14. the LF walk (csrc/sa_walk.cu, one launch a sa_batch call) on the
     card, after phase 11: (a) phase 3's index with its dense-SA cache
     unread, _densify_sa on the kernel and on the plain walk on the card,
     both timed, both equal to phase 3's cache, one launch a call, each
     call held to the plain version on the card, the first chunk and the
     first deep redo timed as below; (b) a genome of BIG_LEN bp (D.
     melanogaster's dm6 length, made by make_genome from a seed), whose
     BWT has more than 2^28 rows: no dense SA, the SA re-sampled 32 -> 4
     at load, 4x-deep pass-2 pools. `index` through the CLI (SA-IS split
     out); a load that prints the re-sampling's time; BIG_READS SE reads
     and BIG_PAIRS FR pairs through the CLI's default route (native, host
     mode, -t 8, batches of 4096): one primary record a read, >= 95%
     mapped, >= 90% of pairs proper, the walk kernel launched once a
     sa_batch call and no plain walk on the card, spans and the enqueue
     hooks printed; a BIG_SUB-read and a BIG_SUB-pair subset equal to
     --no-device apart from @PG. Every sa_batch call of both runs
     (recorded through each module that imported it) runs again on the
     kernel, which must launch once, and on the plain version on the
     card: the values and the overflow flags equal (tolerance 0). Each
     call of the seed program's walk, and one probe chunk, is timed whole
     (outputs and scratch included) with CUDA events after an L2 flush,
     the stream held, beside its lanes (slots, live and dead on entry),
     its bound (the larger of: each slot's row read, its value and flag
     written, one sampled-SA entry read a lane, and 32 bytes a distinct
     fm_blocks row its chains touch, over 3.35 TB/s; OPS_PER_LF int32
     operations a distinct row stepped from over 16.7e12/s; walk_work
     over walk_trace), its chain floor (the longest lane's total steps x
     the dependent-load latency over a buffer of fm_blocks' size,
     CHASE_CU) and an empty kernel launched with the call's grid; a call
     measured below its bound fails the phase. Then
     BatchAligner.resolve_sa_flat on a 4096-read batch's own intervals
     with no seed handle (every probe walked): equal to the seed
     program's fused values and to the plain walk on the card, each
     chunk held to the plain version; and phase 12's dispatch check on
     this index.
 13. one JSON line describing the kernels (launches on the native
     route's waves runs, with ms, plain_ms and bound_ms at that path's
     shapes: the launch-weighted mean over its classes, each class
     under "native_classes"; path_* at the mean wave of phase 3's
     (int32) or phase 4's (int16) run; *_b4096 at B=4096; launches on
     each path) and, under
     "host_libraries", the six host libraries with their build seconds
     and phase 11's times; the device line; and as the last line {"ok":
     true, "device": {...}}. The seed kernels' launches are those of the
     native host-mode SE run (the CLI's default), their ms, plain_ms and
     bound_ms phase 12's at the SE batch, with its chain floor, the
     latency under it, each kernel's ptxas report and what its redesign
     for Hopper changed ("redesigned"); the LF walk's launches are those
     of phase 14's SE run, its ms (a whole sa_batch call), plain_ms,
     bound_ms, chain floor and launch cost a call's mean over that run's
     seed-walk calls; the
     line also holds the seed program's seconds a batch on each main
     path and phase 14's index and mapping numbers.

Exits non-zero without a CUDA device. Imports nothing of JAX or of the
JAX package. Work files go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

GENOME_LEN = 4_641_652       # E. coli K-12 MG1655 size
GENOME_SEED = 0xEC011
READ_LEN = 151
N_READS = 8192
BATCH = 4096
N_SUB = 256
N_PAIRS = 8192
INSERT_MEAN, INSERT_SD = 400, 40
RANK_BATCH = 1024            # reads a work-queue batch in phase 7
RANK_TIMEOUT = 600           # seconds a rank of phase 7 may take
LD_SHARDS = 2                # shards of phase 8's one process
P9_READS = 2048              # reads of phase 9's wide / no-dense-SA runs
P9_PAIRS = 2048              # pairs of phase 9's -I share check
P9_I_PAIRS = 64              # pairs of phase 9's -I device vs --no-device
STALL_S = 10                 # seconds phase 9's spin kernel holds the card
STALL_TIMEOUT = 2            # --device-timeout of phase 9's stalls
SPIN_HZ = 1.98e9             # the H100 SXM's boost clock: _sleep cycles/s
QMAX, TMAX = 160, 512        # the wave shapes of the main path
B_EXT = 4096
# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM; int32 ops run on the 64
# INT32 lanes per SM, half the FP32 lanes behind the 67 TFLOP/s float32
# rate (an FMA counts 2): 132 SMs x 64 x 1.98 GHz = 16.7e12 int32 op/s
HBM_BPS = 3.35e12
INT32_OPS = 16.7e12
L2_BYTES = 50 << 20          # the H100's L2 cache
# Operations of one DP cell, from the recurrence (bwa ksw.c:409-422) at
# the fewest instructions Hopper has for it: M = H(i-1, j-1) + score,
# zero where H(i-1, j-1) is 0 (2); H = max(M, E, F) (1, __vimax3); the
# row's argmax m, mj (3); E = max(E - e_del, max(M - oe_del, 0)) (2,
# two fused add-max __viaddmax); F the same way (2).
OPS_PER_CELL = 10
# Cells per 32-bit operation: int16 rows pack two cells a word for the
# 16x2 DPX instructions (__viaddmax_s16x2, __vimax3_s16x2). The data
# sheet gives no DPX rate, so a packed op counts at the int32 rate.
CELLS_PER_OP = {"ksw_extend2": 1, "ksw_extend2_i16": 2}

# The chunk-edge mix of the warp kernels (32 columns a chunk for int32
# rows, 64 for int16): query lengths on both sides of each edge up to
# QMAX, and the band widths of the band-doubling retry's lanes
EDGE_QLENS = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 159, 160)
EDGE_WS = (1, 4, 8, 100, 200)
EDGE_B = 96
EDGE_SEED = 0xED6E

CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i


# --------------------------------------------------------------- genome
# Repeat-realistic synthetic genome: dispersed LINE/SINE-like families
# and tandem arrays at human-like fractions over a random backbone.

def _consensus(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _paste_dispersed(rng, g, consensus, frac, div, truncate=False,
                     chunk=200_000):
    """Scatter diverged copies of `consensus` over `g` (in place)."""
    elen = len(consensus)
    total_bp = int(len(g) * frac)
    if truncate:
        lens = (elen * (0.05 + 0.95 * rng.random(
            max(1, int(total_bp / (elen * 0.52)))))).astype(np.int64)
        lens = lens[np.cumsum(lens) <= total_bp]
    else:
        lens = np.full(max(1, total_bp // elen), elen, np.int64)
    pos = rng.integers(0, len(g) - elen - 1, len(lens))
    done = 0
    while done < len(lens):
        hi = done
        bp = 0
        while hi < len(lens) and bp < chunk * 64:
            bp += int(lens[hi])
            hi += 1
        for i in range(done, hi):
            L = int(lens[i])
            cp = consensus[elen - L:].copy()
            nmut = rng.binomial(L, div)
            if nmut:
                at = rng.integers(0, L, nmut)
                cp[at] = (cp[at] + rng.integers(1, 4, nmut)) & 3
            g[pos[i]:pos[i] + L] = cp
        done = hi


def _paste_tandems(rng, g, frac):
    total_bp = int(len(g) * frac)
    placed = 0
    while placed < total_bp:
        unit_len = int(rng.integers(2, 65))
        n_copies = int(rng.integers(8, 200))
        arr = np.tile(_consensus(rng, unit_len), n_copies)
        nmut = rng.binomial(len(arr), 0.02)
        if nmut:
            at = rng.integers(0, len(arr), nmut)
            arr[at] = (arr[at] + rng.integers(1, 4, nmut)) & 3
        p = int(rng.integers(0, len(g) - len(arr) - 1))
        g[p:p + len(arr)] = arr
        placed += len(arr)


def make_genome(length: int, seed: int, sine_frac=0.28, line_frac=0.12,
                tandem_frac=0.04) -> np.ndarray:
    """Symbols 0..3 of a repeat-realistic genome."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, length, dtype=np.uint8)
    if line_frac:
        _paste_dispersed(rng, g, _consensus(rng, 6000), line_frac, 0.12,
                         truncate=True)
    if sine_frac:
        anc = _consensus(rng, 300)
        young = anc.copy()
        at = rng.integers(0, 300, 15)
        young[at] = (young[at] + rng.integers(1, 4, 15)) & 3
        _paste_dispersed(rng, g, anc, sine_frac * 0.6, 0.12)
        _paste_dispersed(rng, g, young, sine_frac * 0.4, 0.04)
    if tandem_frac:
        _paste_tandems(rng, g, tandem_frac)
    return g


def cut_reads(genome: np.ndarray, n: int, length: int, seed: int) -> list:
    """n reads of `length` symbols cut from the genome at random, 1%
    substitutions, half of them reverse-complemented."""
    rng = np.random.default_rng(seed)
    comp = np.array([3, 2, 1, 0], np.uint8)
    out = []
    for _ in range(n):
        pos = int(rng.integers(0, len(genome) - length))
        r = genome[pos:pos + length].copy()
        m = rng.random(length) < 0.01
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        out.append(comp[r[::-1]] if rng.random() < 0.5 else r)
    return out


def write_inputs(work: Path, genome: np.ndarray, n_reads: int, seed: int,
                 n_sub: int = N_SUB):
    """ref.fa, reads.fq (n_reads x 151 bp, 1% substitutions, both
    strands) and sub.fq (the first n_sub reads)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    text = bases[genome].tobytes().decode()
    with open(work / "ref.fa", "w") as f:
        f.write(">chr1 synthetic repeat-realistic genome\n")
        for i in range(0, len(text), 80):
            f.write(text[i:i + 80] + "\n")
    recs = [f"@r{i}\n{bases[r].tobytes().decode()}\n+\n{'I' * READ_LEN}\n"
            for i, r in enumerate(cut_reads(genome, n_reads, READ_LEN,
                                            seed))]
    (work / "reads.fq").write_text("".join(recs))
    (work / "sub.fq").write_text("".join(recs[:n_sub]))


def write_pe_inputs(work: Path, genome: np.ndarray, n_pairs: int,
                    seed: int, n_sub: int = N_SUB):
    """r1.fq/r2.fq: FR pairs of 151 bp reads from fragments of N(400,
    40) bp on either strand, 1% substitutions; sub1.fq/sub2.fq hold the
    first n_sub pairs."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    comp = np.array([3, 2, 1, 0], np.uint8)
    isize = np.maximum(rng.normal(INSERT_MEAN, INSERT_SD, n_pairs)
                       .astype(np.int64), READ_LEN)
    recs: tuple[list, list] = ([], [])
    for i in range(n_pairs):
        pos = int(rng.integers(0, len(genome) - isize[i]))
        frag = genome[pos:pos + isize[i]]
        ends = [frag[:READ_LEN].copy(), comp[frag[-READ_LEN:][::-1]]]
        if rng.random() < 0.5:
            ends.reverse()       # the fragment of the other strand
        for k, r in enumerate(ends):
            m = rng.random(READ_LEN) < 0.01
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            recs[k].append(f"@p{i}/{k + 1}\n{bases[r].tobytes().decode()}"
                           f"\n+\n{'I' * READ_LEN}\n")
    for k in range(2):
        (work / f"r{k + 1}.fq").write_text("".join(recs[k]))
        (work / f"sub{k + 1}.fq").write_text("".join(recs[k][:n_sub]))


# ------------------------------------------------------------ kernels

def make_ext_tasks(rng, genome, n):
    """Right extensions after a 19-32 bp seed of 151 bp reads with 1%
    substitutions, target window qlen + 100 (the bench's task shape),
    plus degenerate lanes (qlen == 0 or tlen == 0)."""
    q = np.zeros((n, QMAX), np.int32)
    t = np.zeros((n, TMAX), np.int32)
    ql = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    h0 = np.zeros(n, np.int32)
    for b in range(n):
        pos = int(rng.integers(0, len(genome) - READ_LEN - 200))
        seed = int(rng.integers(19, 33))
        qn = READ_LEN - seed
        tn = min(TMAX, qn + 100)
        r = genome[pos + seed:pos + seed + qn].astype(np.int32)
        m = rng.random(qn) < 0.01
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        q[b, :qn] = r
        t[b, :tn] = genome[pos + seed:pos + seed + tn]
        ql[b], tl[b], h0[b] = qn, tn, seed
    ql[::97] = 0                 # degenerate lanes
    tl[5::101] = 0
    return q, ql, t, tl, h0


def edge_h0max(max_mat: int = 2, end_bonus: int = 5) -> int:
    """The largest h0 that keeps the int16 rows exact (i16_exact) at
    qmax=QMAX for scores up to max_mat and the end bonus."""
    return (1 << 13) - 256 - 1 - (QMAX + 2) * max(max_mat, 1) \
        - max(end_bonus, 0)


def make_edge_tasks(rng, n: int, h0max: int):
    """The chunk-edge mix: qlen cycling through EDGE_QLENS, tlen in 1..TMAX,
    per-lane w from EDGE_WS, h0 log-uniform in 1..h0max, symbols 0..4
    (4% N), the query random past qlen, targets copied from the query
    with 0-40% substitutions, and degenerate lanes (qlen == 0, tlen ==
    0). Returns (q, qlen, t, tlen, h0, w) as int32 arrays."""
    sym = np.array([0.24, 0.24, 0.24, 0.24, 0.04])
    q = rng.choice(5, (n, QMAX), p=sym).astype(np.int32)
    ql = np.asarray(EDGE_QLENS, np.int32)[np.arange(n) % len(EDGE_QLENS)]
    tl = rng.integers(1, TMAX + 1, n).astype(np.int32)
    h0 = np.exp(rng.uniform(0, np.log(h0max), n)).astype(np.int32)
    h0 = np.clip(h0, 1, h0max)
    t = np.zeros((n, TMAX), np.int32)
    for b in range(n):
        src = np.resize(q[b, :ql[b]], tl[b])
        m = rng.random(tl[b]) < rng.choice([0.0, 0.02, 0.1, 0.4])
        src[m] = rng.choice(5, int(m.sum()), p=sym)
        t[b, :tl[b]] = src
    w = rng.choice(EDGE_WS, n).astype(np.int32)
    ql[7::23] = 0                # degenerate lanes
    tl[11::29] = 0
    return q, ql, t, tl, h0, w


def scorings():
    """(name, MemOpt, zdrop) of the kernel checks: bwa defaults, and
    asymmetric gaps without z-drop."""
    from bwa_flow_tpu_torch.utils.opts import MemOpt
    opt = MemOpt()
    asym = MemOpt(o_del=5, e_del=2, o_ins=9, e_ins=1, a=2, b=5)
    asym.refresh_mat()
    return [("bwa defaults", opt, opt.zdrop),
            ("zdrop=0 asymmetric gaps", asym, 0)]


def ext_scorings():
    """(name, MemOpt, w, zdrop) of phase 2's extension checks: bwa
    defaults, the defaults with a narrow band, and asymmetric gaps
    without z-drop."""
    (dname, opt, dzd), (aname, asym, azd) = scorings()
    return [(dname, opt, opt.w, dzd), ("narrow band w=10", opt, 10, dzd),
            (aname, asym, asym.w, azd)]


def make_coupled_tasks(rng, genome: np.ndarray, n: int, qmax: int = QMAX,
                       tmax: int = TMAX):
    """Coupled seed-extension tasks (the inputs of seed_extend_batch)
    around 19-32 bp seeds (h0 = seed length) of reads of `genome`
    (symbols 0..3) with 1% substitutions: left query/target reversed,
    each side up to qmax query bases and a target window 0-40 bases
    longer (at most tmax). Lane kinds by lane % 8: 0 no left side, 1 no
    right side, 2 and 3 a block of random bases inserted in the left (2)
    or right (3) target a few bases from the seed (80 bases in every
    other group of 8 lanes, with a 90-110 bp seed on the left; else
    9-12), so that the best path leaves the diagonal and bwa's 2w retry
    runs (80 under a band of 100, 9-12 under a band of 10); the rest
    plain. Returns (ql_q, ql_n, tl_t, tl_n, qr_q, qr_n, tr_t, tr_n, h0)
    as int32 arrays."""
    qs = {s: np.zeros((n, qmax), np.int32) for s in "lr"}
    ts = {s: np.zeros((n, tmax), np.int32) for s in "lr"}
    qn = {s: np.zeros(n, np.int32) for s in "lr"}
    tn = {s: np.zeros(n, np.int32) for s in "lr"}
    h0 = np.zeros(n, np.int32)
    for b in range(n):
        kind = b % 8
        gap = 80 if (b // 8) % 2 == 0 else int(rng.integers(9, 13))
        # the left side's rows cross an 80-base gap only from a score
        # above its cost (o_del + 80 e_del): those lanes get a long SMEM
        slen = int(rng.integers(90, 111) if kind == 2 and gap == 80
                   else rng.integers(19, 33))
        pos = int(rng.integers(tmax + 1, len(genome) - slen - tmax - 1))
        for side, empty, gapped in (("l", 0, 2), ("r", 1, 3)):
            if kind == empty:
                continue
            g = gap if kind == gapped else 0
            nq = int(rng.integers(qmax * 3 // 4 if g else 1, qmax + 1))
            span = min(tmax, nq + g + int(rng.integers(0, 41)))
            # reference read away from the seed: leftwards, reversed,
            # for the left side
            ref = genome[pos - span:pos][::-1] if side == "l" else \
                genome[pos + slen:pos + slen + span]
            q = ref[:nq].astype(np.int32)
            m = rng.random(nq) < 0.01
            q[m] = (q[m] + rng.integers(1, 4, int(m.sum()))) % 4
            t = ref.astype(np.int32)
            if g:
                k = int(rng.integers(2, 8))
                t = np.concatenate([t[:k], rng.integers(0, 4, g),
                                    t[k:]])[:span]
            qs[side][b, :nq] = q
            qn[side][b] = nq
            ts[side][b, :span] = t
            tn[side][b] = span
        h0[b] = slen
    return (qs["l"], qn["l"], ts["l"], tn["l"], qs["r"], qn["r"], ts["r"],
            tn["r"], h0)


def _time_ms(fn, n: int, fill: bool = False) -> float:
    """Mean device ms of fn over n calls, from CUDA events. With fill, a
    spin kernel (torch.cuda._sleep) first holds the stream for about
    twice the host's time to enqueue the n calls, so that the events
    time the calls' device work back to back and not the host's enqueue
    rate (a wrapper's host work can outlast a short kernel)."""
    import torch
    fn()
    torch.cuda.synchronize()
    if fill:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(2 * n * host_s, 5.0) * 2e9))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _diff(got, want) -> tuple[int, int]:
    """(max |err|, mismatching values) over two sequences of output
    tensors, on any devices; an element may itself be a sequence (the
    ext tuple of entry()'s outputs). A shape mismatch counts every value
    as mismatching."""
    pairs = []
    for g, w in zip(got, want):
        pairs += list(zip(g, w)) if isinstance(g, (tuple, list)) \
            else [(g, w)]
    err = bad = 0
    for g, w in pairs:
        g, w = g.cpu().long(), w.cpu().long()
        if g.shape != w.shape:
            return -1, max(g.numel(), w.numel())
        if g.numel():
            err = max(err, int((g - w).abs().max()))
        bad += int((g != w).sum())
    return err, bad


def _kernels() -> dict:
    """name -> (kernel wrapper, plain version) of every kernel."""
    from bwa_flow_tpu_torch.ops import extend_cuda, extend_torch
    return {"ksw_extend2": (extend_cuda.extend_core_cuda,
                            extend_torch.extend_core),
            "ksw_extend2_i16": (extend_cuda.extend_core_cuda16,
                                extend_torch.extend_core16)}


def _bound(name: str, args: list, cells: int) -> dict:
    """The least time of a kernel's work on these inputs: each input read
    once and each output written once over HBM, or the cells' operations
    over the int32 rate, whichever is larger."""
    B = args[0].shape[0]
    nbytes = (sum(a.numel() for a in args) + B + 25 + 6 * B) * 4
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = cells * OPS_PER_CELL / CELLS_PER_OP[name] / INT32_OPS * 1e3
    return dict(cells=cells, bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _ext_args(genome: np.ndarray, device, n: int = B_EXT) -> list:
    """The first n of phase 2's extension tasks as tensors on `device`."""
    import torch
    q, ql, t, tl, h0 = make_ext_tasks(np.random.default_rng(0x5EED),
                                      genome, B_EXT)
    return [torch.as_tensor(np.ascontiguousarray(a[:n]), device=device)
            for a in (q, ql, t, tl, h0)]


def phase_kernels(genome: np.ndarray, device) -> dict:
    """Both ksw_extend2 kernels vs their plain versions at the widest
    wave (B=4096), and the int16 kernel vs the int32 one; returns the
    numbers of each kernel by name."""
    import torch

    from bwa_flow_tpu_torch.ops import extend_cuda, extend_torch

    args = _ext_args(genome, device)
    h0 = args[4].cpu().numpy()
    kernels = _kernels()
    res = {name: dict(max_abs_err=0) for name in kernels}
    for si, (sname, o, w, zd) in enumerate(ext_scorings()):
        if not extend_cuda.i16_exact(QMAX, int(h0.max()), int(o.mat.max()),
                                     o.pen_clip3):
            raise SystemExit(f"scoring {sname} is outside the int16 bound")
        mat = torch.as_tensor(np.ascontiguousarray(o.mat[:5, :5]),
                              dtype=torch.int32, device=device)
        sc = (o.o_del, o.e_del, o.o_ins, o.e_ins, w, o.pen_clip3, zd)
        stats: dict = {}
        want32 = extend_torch.extend_core(QMAX, TMAX, *args, mat, *sc,
                                          stats=stats)
        cells = stats["cells"]
        got32 = None
        for name, (kern, plain) in kernels.items():
            got = kern(QMAX, TMAX, *args, mat, *sc)
            torch.cuda.synchronize()
            want = want32 if plain is extend_torch.extend_core else plain(
                QMAX, TMAX, *args, mat, *sc)
            err, bad = _diff(got, want)
            what = f"mismatching values {bad} vs plain"
            if got32 is None:
                got32 = got
            else:
                err32, bad32 = _diff(got, got32)
                err, bad = max(err, err32), bad + bad32
                what += f", {bad32} vs the int32 kernel"
            ms = _time_ms(lambda: kern(QMAX, TMAX, *args, mat, *sc), 50,
                          fill=True)
            plain_ms = _time_ms(lambda: plain(QMAX, TMAX, *args, mat, *sc),
                                20 if si == 0 else 5)
            print(f"[kernel] {name} {sname}: B={B_EXT} {what}, max |err| "
                  f"{err}; kernel {ms:.4f} ms ({cells / ms / 1e6:.3f} "
                  f"GCUPS), plain {plain_ms:.3f} ms "
                  f"({cells / plain_ms / 1e6:.3f} GCUPS), {cells} cells")
            if bad:
                raise SystemExit(f"{name} disagrees under {sname}")
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if si == 0:   # the defaults are the main path's scoring
                r.update(ms=ms, plain_ms=plain_ms,
                         **_bound(name, args, cells))
    return res


def phase_edge_mix(device, res: dict) -> None:
    """Both kernels on the chunk-edge mix at B=EDGE_B, B=1 and B=5 (4
    tasks a block, so the last two are partial blocks): each equal to
    its plain version and to the other kernel, 0 mismatching values.
    Refuses a scoring for which the mix is outside i16_exact."""
    import torch

    from bwa_flow_tpu_torch.ops import extend_cuda

    q, ql, t, tl, h0, w = make_edge_tasks(np.random.default_rng(EDGE_SEED),
                                          EDGE_B, edge_h0max())
    kernels = _kernels()
    for sname, o, zd in scorings():
        if not extend_cuda.i16_exact(QMAX, int(h0.max()), int(o.mat.max()),
                                     o.pen_clip3):
            raise SystemExit(f"the edge mix is outside the int16 bound "
                             f"under {sname}")
        mat = torch.as_tensor(np.ascontiguousarray(o.mat[:5, :5]),
                              dtype=torch.int32, device=device)
        for n in (EDGE_B, 1, 5):
            args = [torch.as_tensor(np.ascontiguousarray(a[:n]),
                                    device=device)
                    for a in (q, ql, t, tl, h0)]
            sc = (o.o_del, o.e_del, o.o_ins, o.e_ins,
                  torch.as_tensor(w[:n].copy(), device=device),
                  o.pen_clip3, zd)
            got = {}
            for name, (kern, plain) in kernels.items():
                got[name] = kern(QMAX, TMAX, *args, mat, *sc)
                torch.cuda.synchronize()
                err, bad = _diff(got[name], plain(QMAX, TMAX, *args, mat,
                                                  *sc))
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                               err)
                print(f"[edge] {name} {sname}: B={n} mismatching values "
                      f"{bad} vs plain, max |err| {err}")
                if bad:
                    raise SystemExit(f"{name} disagrees on the edge mix "
                                     f"at B={n} under {sname}")
            err, bad = _diff(got["ksw_extend2_i16"], got["ksw_extend2"])
            print(f"[edge] ksw_extend2_i16 vs ksw_extend2 {sname}: B={n} "
                  f"mismatching values {bad}")
            if bad:
                raise SystemExit(f"the kernels disagree on the edge mix at "
                                 f"B={n} under {sname}")
        # scores of 2^23 and more, where the int32 kernel reduces the row
        # max and its column apart (outside the int16 bound)
        kern, plain = kernels["ksw_extend2"]
        args = [torch.as_tensor(np.ascontiguousarray(a), device=device)
                for a in (q, ql, t, tl, h0 + np.int32(1 << 23))]
        sc = (o.o_del, o.e_del, o.o_ins, o.e_ins,
              torch.as_tensor(w, device=device), o.pen_clip3, zd)
        err, bad = _diff(kern(QMAX, TMAX, *args, mat, *sc),
                         plain(QMAX, TMAX, *args, mat, *sc))
        res["ksw_extend2"]["max_abs_err"] = max(
            res["ksw_extend2"]["max_abs_err"], err)
        print(f"[edge] ksw_extend2 {sname}, h0 + 2^23: B={EDGE_B} "
              f"mismatching values {bad} vs plain, max |err| {err}")
        if bad:
            raise SystemExit(f"ksw_extend2 disagrees at h0 + 2^23 under "
                             f"{sname}")


def phase_wave_shape(genome: np.ndarray, device, res: dict,
                     path: dict) -> None:
    """Each kernel at the mean wave of the path that launched it (the
    waves are trimmed to their filled slots): the first `tasks` of phase
    2's tasks, bwa defaults, against the plain version and timed; adds
    the numbers to res[name] under `path_*` keys."""
    import torch

    from bwa_flow_tpu_torch.utils.opts import MemOpt

    o = MemOpt()
    kernels = _kernels()
    for name, (kern, plain) in kernels.items():
        n = max(1, round(path[name]["tasks_per_launch"]))
        args = _ext_args(genome, device, n)
        mat = torch.as_tensor(np.ascontiguousarray(o.mat[:5, :5]),
                              dtype=torch.int32, device=device)
        sc = (o.o_del, o.e_del, o.o_ins, o.e_ins, o.w, o.pen_clip3,
              o.zdrop)
        stats: dict = {}
        want = plain(QMAX, TMAX, *args, mat, *sc, stats=stats)
        got = kern(QMAX, TMAX, *args, mat, *sc)
        torch.cuda.synchronize()
        err, bad = _diff(got, want)
        ms = _time_ms(lambda: kern(QMAX, TMAX, *args, mat, *sc), 200,
                      fill=True)
        plain_ms = _time_ms(lambda: plain(QMAX, TMAX, *args, mat, *sc), 3)
        b = _bound(name, args, stats["cells"])
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update({f"path_{k}": v for k, v in b.items()},
                 path_B=n, path_ms=ms, path_plain_ms=plain_ms)
        print(f"[wave] {name} at its path's mean wave B={n}: mismatching "
              f"values {bad}, max |err| {err}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}), {b['cells']} cells")
        if bad:
            raise SystemExit(f"{name} disagrees at B={n}")
        # the other kernel on the same wave, in the same call
        other = next(k for k in kernels if k != name)
        r["path_other_ms"] = _time_ms(
            lambda: kernels[other][0](QMAX, TMAX, *args, mat, *sc), 200,
            fill=True)
        print(f"[wave] {other} on the same B={n} wave: "
              f"{r['path_other_ms']:.4f} ms")
        r["row_ns"] = row_cost_ns(device, kern, plain)
        print(f"[wave] {name}: {r['row_ns']:.1f} ns a target row at qlen 130 "
              f"(B=84 tasks of 60 and 250 rows)")


def row_cost_ns(device, kern, plain, qlen: int = 130,
                tlens=(60, 250), n: int = 84) -> float:
    """ns a target row costs the kernel: n tasks whose target repeats the
    query (qlen columns), h0 = 3000, w = 500 and no z-drop run exactly
    min(tlen, 2 qlen) rows each (the band cap makes w = qlen; no row
    breaks, none shrinks the band), so the difference of the kernel's
    times at the two tlens over the rows between them is one row's
    dependency chain. The kernel must equal its plain version there."""
    import torch

    from bwa_flow_tpu_torch.utils.opts import MemOpt

    o = MemOpt()
    mat = torch.as_tensor(np.ascontiguousarray(o.mat[:5, :5]),
                          dtype=torch.int32, device=device)
    sc = (o.o_del, o.e_del, o.o_ins, o.e_ins, 500, o.pen_clip3, 0)
    q = np.random.default_rng(0x20E).integers(0, 4, (n, QMAX), np.int32)
    ms = []
    for tl in tlens:
        t = np.zeros((n, TMAX), np.int32)
        t[:, :tl] = np.resize(q[0, :qlen], tl)
        q[:, :qlen] = q[0, :qlen]
        args = [torch.as_tensor(a, device=device) for a in
                (q, np.full(n, qlen, np.int32), t, np.full(n, tl, np.int32),
                 np.full(n, 3000, np.int32))]
        got = kern(QMAX, TMAX, *args, mat, *sc)
        torch.cuda.synchronize()
        if _diff(got, plain(QMAX, TMAX, *args, mat, *sc))[1]:
            raise SystemExit("a kernel disagrees on the row-cost tasks")
        ms.append(_time_ms(lambda: kern(QMAX, TMAX, *args, mat, *sc), 100,
                           fill=True))
    rows = [min(tl, 2 * qlen) for tl in tlens]
    return (ms[1] - ms[0]) / (rows[1] - rows[0]) * 1e6


@contextlib.contextmanager
def timed_launches(capture: bool = False):
    """While the block runs, record CUDA events around every call of the
    kernel wrappers; yields name -> [(start, end, tasks, inputs)]. With
    capture, inputs is a copy of the call's arguments (tensors cloned on
    the card before the start event), else None. The wrappers (and their
    launch counts) run unchanged inside."""
    import torch

    from bwa_flow_tpu_torch.ops import extend_cuda
    log: dict = {}
    saved = {}
    for name, attr in (("ksw_extend2", "extend_core_cuda"),
                       ("ksw_extend2_i16", "extend_core_cuda16")):
        saved[attr] = fn = getattr(extend_cuda, attr)
        events = log.setdefault(name, [])

        def timed(*a, _fn=fn, _events=events):
            kept = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                         for x in a) if capture else None
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _fn(*a)
            e1.record()
            _events.append((e0, e1, int(a[2].shape[0]), kept))
            return out
        setattr(extend_cuda, attr, timed)
    try:
        yield log
    finally:
        for attr, fn in saved.items():
            setattr(extend_cuda, attr, fn)


@contextlib.contextmanager
def timed_calls(owner, attr: str):
    """While the block runs, sum the host seconds of every call of
    owner.attr (a module function or a method); yields {"s", "calls"}.
    The function runs unchanged inside."""
    fn = getattr(owner, attr)
    acc = {"s": 0.0, "calls": 0}

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc["s"] += time.perf_counter() - t0
            acc["calls"] += 1
    setattr(owner, attr, timed)
    try:
        yield acc
    finally:
        setattr(owner, attr, fn)


def launch_times(log: dict, tag: str) -> dict:
    """Sum the recorded device time of each kernel over a path's run."""
    import torch
    torch.cuda.synchronize()
    out = {}
    for name, events in log.items():
        if not events:
            continue
        total = sum(e0.elapsed_time(e1) for e0, e1, _, _ in events)
        tasks = sum(b for _, _, b, _ in events)
        out[name] = dict(device_ms=total, launches=len(events),
                         tasks_per_launch=tasks / len(events))
        print(f"[{tag}] {name} on the path: {len(events)} launches, "
              f"{tasks / len(events):.1f} tasks a launch, device time "
              f"{total:.3f} ms in all, {total / len(events):.4f} ms a "
              f"launch (CUDA events around each wrapper call)")
    return out


def ptxas_report(log: str) -> dict:
    """Each kernel entry of an nvcc -Xptxas -v log, by its name and
    template arguments as mangled (p1p3_kernelIiE: int32 coordinates,
    IlE: int64): registers and the stack frame, spill stores and spill
    loads in bytes."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out.setdefault(fn, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    named = {}
    for k, v in out.items():
        # a mangled name is <length><name>: the name ending in _kernel
        for m in re.finditer(r"\d+", k):
            digits, end = m.group(0), m.end()
            names = [k[end:end + int(digits[i:])]
                     for i in range(len(digits))]
            name = next((n for n in names if n.endswith("_kernel")), None)
            if name:
                tmpl = re.match(r"I\w+?E", k[end + len(name):])
                named[name + (tmpl.group(0) if tmpl else "")] = v
                break
    return named


def build_everything(_build) -> dict:
    """Build every CUDA kernel (_build.KERNELS) and the six host
    libraries, one thread (one nvcc or c++) each, all at once; prints and
    returns each build's seconds (0 when it was built already)."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = {n: lambda n=n: _build.build_all([n]) for n in _build.KERNELS}
    for n in _build.HOST_LIBS:
        jobs[n] = lambda n=n: _build.build_host([n])

    def timed(item):
        t0 = time.perf_counter()
        item[1]()
        return item[0], time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        secs = dict(ex.map(timed, jobs.items()))
    for n, dt in secs.items():
        src = f"csrc/{n}.cu" if n in _build.KERNELS else \
            f"csrc/host/{n}.cpp"
        print(f"[build] {src}: {dt:.2f} s")
    print(f"[build] all {len(jobs)} in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    return secs


# ----------------------------------------------------------- main path

@contextlib.contextmanager
def waves_carry_every_task():
    """While the block runs, a batch aligner in --ext-mode waves drains
    nothing on the host and starts no harvester, so that device waves
    carry every task that fits, also on a few reads."""
    from bwa_flow_tpu_torch.pipeline.batch import BatchAligner

    init = BatchAligner.__init__

    def no_drain(self, *a, **k):
        init(self, *a, **k)
        if self.ext_mode == "waves":
            self.drain_max, self.harvest_workers = 0, 0
    BatchAligner.__init__ = no_drain
    try:
        yield
    finally:
        BatchAligner.__init__ = init


@contextlib.contextmanager
def markdup_stages():
    """While the block runs, every markdup stage a `mem` run makes is
    recorded; yields the list of records: the stage, its class name, and
    the seconds and calls of its process()."""
    from bwa_flow_tpu_torch.dedup import markdup

    real = markdup.make_markdup_stage
    seen: list = []

    def make(*a, **k):
        stage = real(*a, **k)
        rec = dict(stage=stage, cls=type(stage).__name__, s=0.0, calls=0)
        process = stage.process

        def timed(reads):
            t0 = time.perf_counter()
            process(reads)
            rec["s"] += time.perf_counter() - t0
            rec["calls"] += 1
        stage.process = timed
        seen.append(rec)
        return stage
    markdup.make_markdup_stage = make
    try:
        yield seen
    finally:
        markdup.make_markdup_stage = real


def markdup_summary(tag: str, seen: list, want_cls: str) -> dict:
    """The one markdup stage of a run: prints and returns its class,
    duplicate count and seconds; raises unless it is want_cls."""
    if len(seen) != 1 or seen[0]["cls"] != want_cls:
        raise SystemExit(f"{tag}: markdup stages "
                         f"{[r['cls'] for r in seen]}, not one {want_cls}")
    r = seen[0]
    out = dict(cls=r["cls"], dup_count=r["stage"].state.dup_count,
               s=r["s"], calls=r["calls"])
    print(f"[{tag}] markdup ({out['cls']}): {out['dup_count']} duplicate "
          f"blocks, {out['s']:.4f} s over {out['calls']} batches")
    return out


def _records(path: Path) -> list[list[str]]:
    return [l.split("\t") for l in path.read_text().splitlines()
            if l and not l.startswith("@")]


def _body(p: Path) -> list[str]:
    return [l for l in p.read_text().splitlines() if not l.startswith("@PG")]


def phase_main_path(work: Path, device: str) -> dict:
    """index + single-end mem through the port's CLI in --ext-mode waves
    (int32 kernel); returns the run's numbers."""
    import torch

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.ops import extend_cuda, smem_cuda
    from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

    from bwa_flow_tpu_torch.index import build

    t0 = time.perf_counter()
    with timed_calls(build, "suffix_array_sais") as t_sa, \
            timed_calls(cli, "save_index") as t_save:
        assert cli.main(["index", str(work / "ref.fa")]) == 0
    t_index = time.perf_counter() - t0
    print(f"[main] index of {GENOME_LEN} bp: {t_index:.2f} s (SA-IS "
          f"suffix array {t_sa['s']:.2f} s, writing the files "
          f"{t_save['s']:.2f} s)")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    os.environ.pop("BWA_TPU_EXTEND16", None)   # the int32 kernel's path
    extend_cuda.n_launches = 0            # count only the main path run
    extend_cuda.n_launches16 = 0
    smem_cuda.n_launches.update(dict.fromkeys(smem_cuda.KERNELS, 0))
    tracer.totals.clear()
    tracer.counts.clear()
    t0 = time.perf_counter()
    with timed_launches() as log, markdup_stages() as mds, \
            plain_seed_calls() as plain:
        assert cli.main(["mem", "-t", "8", "--batch-reads", str(BATCH),
                         "--device", device, "--ext-mode", "waves", "-o",
                         str(work / "full.sam"), str(work / "ref.fa"),
                         str(work / "reads.fq")]) == 0
    dt = time.perf_counter() - t0
    seed_launches = dict(smem_cuda.n_launches)
    seed_launch_check("main", seed_launches, plain)
    path = launch_times(log, "main")
    mdup = markdup_summary("main", mds, "NativeMarkDupStage")
    launches = extend_cuda.n_launches
    launches16 = extend_cuda.n_launches16
    st = dict(cli.last_run_stats)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    seed_per_batch = st["seed_s"] / max(1, st["seed_batches"])
    print(f"[main] mem {N_READS} reads: {dt:.2f} s, "
          f"{N_READS / dt:.1f} reads/s (index load included); seed "
          f"program {seed_per_batch:.3f} s/batch over "
          f"{st['seed_batches']} batches; waves {st['waves']}, device "
          f"tasks {st['ext_tasks_device']}, host tasks "
          f"{st['ext_tasks_host']}; ksw_extend2 launches {launches}; "
          f"peak device memory "
          f"{peak / 2**20:.1f} MiB")
    print(f"[main] spans (host wall clock, s): {tracer.as_json()}")
    print(f"[main] {enqueue_summary(st)}")
    spans = dict(tracer.totals)

    recs = _records(work / "full.sam")
    primary: dict = {}
    mapped = 0
    for f in recs:
        flag = int(f[1])
        if not flag & 0x900:
            primary[f[0]] = primary.get(f[0], 0) + 1
            mapped += 0 if flag & 0x4 else 1
    names = {f[0] for f in recs}
    if len(names) != N_READS or any(primary.get(n) != 1 for n in names):
        raise SystemExit("full.sam: not exactly one primary record per "
                         "read")
    frac = mapped / N_READS
    print(f"[main] {N_READS} reads, {len(recs)} records, mapped "
          f"{frac:.4f}")
    if frac < 0.95:
        raise SystemExit(f"full.sam: only {frac:.4f} of reads mapped")
    if device == "cuda" and (launches <= 0 or launches16):
        raise SystemExit(f"the single-end path launched ksw_extend2 "
                         f"{launches} times and ksw_extend2_i16 "
                         f"{launches16} times")

    # device SAM == host golden SAM on a subset, apart from @PG
    assert cli.main(["mem", "--device", device, "-o",
                     str(work / "sub_dev.sam"), str(work / "ref.fa"),
                     str(work / "sub.fq")]) == 0
    assert cli.main(["mem", "--no-device", "-o", str(work / "sub_host.sam"),
                     str(work / "ref.fa"), str(work / "sub.fq")]) == 0

    dev_sam, host_sam = _body(work / "sub_dev.sam"), _body(work /
                                                          "sub_host.sam")
    if dev_sam != host_sam:
        raise SystemExit("device SAM differs from the --no-device SAM on "
                         f"the {N_SUB}-read subset")
    print(f"[main] {N_SUB}-read subset: device SAM == --no-device SAM "
          f"({len(dev_sam)} lines)")
    return dict(launches=launches, reads_per_s=N_READS / dt,
                seed_launches=seed_launches,
                seed_s_per_batch=seed_per_batch, stats=st, peak=peak,
                path=path["ksw_extend2"], wall_s=dt, spans=spans,
                index_s=t_index, index_sa_s=t_sa["s"],
                index_save_s=t_save["s"], markdup=mdup)


def phase_pe_path(work: Path, device: str) -> dict:
    """Paired-end mem through the port's CLI in --ext-mode waves with
    BWA_TPU_EXTEND16=1 (the int16 kernel); returns the run's numbers."""
    import torch

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.ops import extend_cuda, smem_cuda
    from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

    ref = str(work / "ref.fa")
    os.environ["BWA_TPU_EXTEND16"] = "1"
    try:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        extend_cuda.n_launches = 0        # count only the PE path run
        extend_cuda.n_launches16 = 0
        smem_cuda.n_launches.update(dict.fromkeys(smem_cuda.KERNELS, 0))
        tracer.totals.clear()
        tracer.counts.clear()
        t0 = time.perf_counter()
        with timed_launches() as log, markdup_stages() as mds, \
                plain_seed_calls() as plain:
            assert cli.main(["mem", "-t", "8", "--batch-reads", str(BATCH),
                             "--device", device, "--ext-mode", "waves",
                             "-o", str(work / "pe.sam"), ref,
                             str(work / "r1.fq"), str(work / "r2.fq")]) == 0
        dt = time.perf_counter() - t0
        seed_launches = dict(smem_cuda.n_launches)
        seed_launch_check("pe", seed_launches, plain)
        path = launch_times(log, "pe")
        mdup = markdup_summary("pe", mds, "NativeMarkDupStage")
        launches = extend_cuda.n_launches
        launches16 = extend_cuda.n_launches16
        st = dict(cli.last_run_stats)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        print(f"[pe] mem {N_PAIRS} pairs: {dt:.2f} s, {N_PAIRS / dt:.1f} "
              f"pairs/s ({2 * N_PAIRS / dt:.1f} reads/s, index load "
              f"included); seed program "
              f"{st['seed_s'] / max(1, st['seed_batches']):.3f} s/batch "
              f"over {st['seed_batches']} batches; waves {st['waves']}, "
              f"device tasks {st['ext_tasks_device']}, host tasks "
              f"{st['ext_tasks_host']}; ksw_extend2_i16 launches "
              f"{launches16}, ksw_extend2 "
              f"launches {launches}; peak device memory "
              f"{peak / 2**20:.1f} MiB")
        print(f"[pe] spans (host wall clock, s): {tracer.as_json()}")
        print(f"[pe] {enqueue_summary(st)}")

        recs = _records(work / "pe.sam")
        primary: dict = {}
        mapped = proper = 0
        for f in recs:
            flag = int(f[1])
            if flag & 0x900:
                continue
            key = (f[0], flag & 0xC0)
            primary[key] = primary.get(key, 0) + 1
            mapped += 0 if flag & 0x4 else 1
            proper += 1 if flag & 0x42 == 0x42 else 0
        keys = {(f[0], int(f[1]) & 0xC0) for f in recs}
        if len(keys) != 2 * N_PAIRS or any(primary.get(k) != 1
                                           for k in keys):
            raise SystemExit("pe.sam: not exactly one primary record per "
                             "read")
        frac, frac_p = mapped / (2 * N_PAIRS), proper / N_PAIRS
        print(f"[pe] {N_PAIRS} pairs, {len(recs)} records, reads mapped "
              f"{frac:.4f}, pairs proper {frac_p:.4f}")
        if frac < 0.95 or frac_p < 0.90:
            raise SystemExit(f"pe.sam: {frac:.4f} of reads mapped, "
                             f"{frac_p:.4f} of pairs proper")
        if device == "cuda" and (launches16 <= 0 or launches):
            raise SystemExit(f"the paired-end path launched "
                             f"ksw_extend2_i16 {launches16} times and "
                             f"ksw_extend2 {launches} times")

        # device SAM == host golden SAM on a subset of pairs, apart from @PG
        sub = [str(work / "sub1.fq"), str(work / "sub2.fq")]
        assert cli.main(["mem", "--device", device, "-o",
                         str(work / "pe_sub_dev.sam"), ref] + sub) == 0
        assert cli.main(["mem", "--no-device", "-o",
                         str(work / "pe_sub_host.sam"), ref] + sub) == 0
    finally:
        del os.environ["BWA_TPU_EXTEND16"]
    dev_sam = _body(work / "pe_sub_dev.sam")
    if dev_sam != _body(work / "pe_sub_host.sam"):
        raise SystemExit("device SAM differs from the --no-device SAM on "
                         f"the {N_SUB}-pair subset")
    print(f"[pe] {N_SUB}-pair subset: device SAM == --no-device SAM "
          f"({len(dev_sam)} lines)")
    return dict(launches=launches16, pairs_per_s=N_PAIRS / dt, stats=st,
                seed_launches=seed_launches,
                seed_s_per_batch=st["seed_s"] / max(1, st["seed_batches"]),
                peak=peak, path=path["ksw_extend2_i16"], markdup=mdup)


def phase_sort_path(work: Path, device: str) -> dict:
    """Phase 4's paired-end run with --sort on the native route's device
    waves (--ext-mode waves), int32 kernel; checks the BAM and returns
    the run's numbers."""
    import gzip

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.index.io import load_index
    from bwa_flow_tpu_torch.io import bam
    from bwa_flow_tpu_torch.ops import extend_cuda
    from bwa_flow_tpu_torch.pipeline import sort

    ref = str(work / "ref.fa")
    out = work / "pe.bam"
    os.environ.pop("BWA_TPU_EXTEND16", None)   # the int32 kernel's path
    extend_cuda.n_launches = 0            # count only the sort path run
    extend_cuda.n_launches16 = 0
    t0 = time.perf_counter()
    with timed_launches() as log, \
            timed_calls(sort, "merge_sorted_bam") as merge, \
            timed_calls(sort.BucketSort, "write_sam_text") as writes:
        assert cli.main(["mem", "-t", "8", "--batch-reads", str(BATCH),
                         "--device", device, "--ext-mode", "waves",
                         "--sort", "--temp-dir",
                         str(work / "sort_tmp"), "-o", str(out), ref,
                         str(work / "r1.fq"), str(work / "r2.fq")]) == 0
    dt = time.perf_counter() - t0
    path = launch_times(log, "sort")
    launches = extend_cuda.n_launches
    launches16 = extend_cuda.n_launches16
    size = out.stat().st_size
    print(f"[sort] mem --sort {N_PAIRS} pairs: {dt:.2f} s, "
          f"{N_PAIRS / dt:.1f} pairs/s (index load included); bucket "
          f"writes {writes['s']:.3f} s over {writes['calls']} calls, "
          f"merge_sorted_bam {merge['s']:.3f} s, alignment and the rest "
          f"{dt - writes['s'] - merge['s']:.3f} s; BAM {size} bytes; "
          f"ksw_extend2 launches {launches}, ksw_extend2_i16 launches "
          f"{launches16}")
    if device == "cuda" and (launches <= 0 or launches16):
        raise SystemExit(f"the sort path launched ksw_extend2 {launches} "
                         f"times and ksw_extend2_i16 {launches16} times")

    data = out.read_bytes()
    if not data.endswith(bam.BGZF_EOF):
        raise SystemExit("pe.bam does not end in the BGZF EOF block")
    text, refs, recs = bam.decode_bam_records(gzip.decompress(data))
    anns = load_index(ref).bns.anns
    if refs != [(a.name, a.len) for a in anns]:
        raise SystemExit(f"pe.bam refs {refs} differ from the index's")
    keys = [sort.sort_key_from_raw(r["raw"]) for r in recs]
    if any(a > b for a, b in zip(keys, keys[1:])):
        raise SystemExit("pe.bam: sort keys decrease")
    tids = [r["tid"] for r in recs]
    n_unmapped = tids.count(-1)
    if n_unmapped and -1 in tids[:len(tids) - n_unmapped]:
        raise SystemExit("pe.bam: an unmapped record before a mapped one")
    bam_fields_check("pe.bam", recs, _records(work / "pe.sam"), anns)
    print(f"[sort] pe.bam: {len(recs)} records ({n_unmapped} unmapped, "
          f"last), keys non-decreasing, refs == index, records == phase "
          f"4's pe.sam as BAM (int32 kernel == int16 kernel over "
          f"{N_PAIRS} pairs); header {text.count(chr(10))} lines")

    # the merge again, alone, on the run's buckets
    paths = sorted(str(p) for p in (work / "sort_tmp").glob("*.bamr"))
    dst = work / "pe_remerge.bam"
    t0 = time.perf_counter()
    sort.merge_sorted_bam(paths, str(dst), anns, text)
    remerge = time.perf_counter() - t0
    if gzip.decompress(dst.read_bytes()) != gzip.decompress(data):
        raise SystemExit("the merge again differs from pe.bam after "
                         "inflation")
    print(f"[sort] the merge again on the run's {len(paths)} buckets: "
          f"{remerge:.3f} s (in the run: {merge['s']:.3f} s); == pe.bam "
          f"inflated")
    return dict(launches=launches, path=path["ksw_extend2"],
                write_s=writes["s"], merge_s=merge["s"],
                remerge_s=remerge)


def bam_fields_check(tag: str, recs: list, lines: list, anns) -> None:
    """Raise unless the decoded BAM records `recs` hold, as a multiset,
    the SAM records `lines` (split lines): each record's QNAME, FLAG,
    reference and mate ids, 0-based positions, MAPQ, TLEN and sequence
    length as the SAM text gives them, and its bytes those of
    _bam.sam_to_bam on the line."""
    from collections import Counter

    from bwa_flow_tpu_torch import _build
    from bwa_flow_tpu_torch.io import bam

    tid = {a.name: i for i, a in enumerate(anns)}

    def fields(f):
        r = tid.get(f[2], -1)
        m = r if f[6] == "=" else tid.get(f[6], -1)
        return (f[0], int(f[1]), r, int(f[3]) - 1, int(f[4]), m,
                int(f[7]) - 1, int(f[8]), 0 if f[9] == "*" else len(f[9]))
    got = Counter((r["qname"], r["flag"], r["tid"], r["pos"], r["mapq"],
                   r["mtid"], r["mpos"], r["tlen"], r["l_seq"])
                  for r in recs)
    if got != Counter(fields(f) for f in lines):
        raise SystemExit(f"{tag}: the records' fields differ from the "
                         "SAM's")
    names = b"".join(a.name.encode() + b"\x00" for a in anns)
    raw = _build.host_module("_bam").sam_to_bam(
        "".join("\t".join(f) + "\n" for f in lines), names)
    _, _, enc = bam.decode_bam_records(bam.bam_header_bytes(anns) + raw)
    if Counter(r["raw"] for r in recs) != Counter(r["raw"] for r in enc):
        raise SystemExit(f"{tag}: the records differ from the SAM's lines "
                         "encoded by _bam.sam_to_bam")


def _free_port() -> int:
    """A free local TCP port p with p + 137 (the work queue's) free."""
    import socket
    for _ in range(100):
        with socket.socket() as a, socket.socket() as b:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            if p + 137 > 65535:
                continue
            try:
                b.bind(("127.0.0.1", p + 137))
            except OSError:
                continue
            return p
    raise SystemExit("no free local port pair for phase 7")


def _launches_line(err: str) -> int:
    """The int32 kernel's launches from a rank's `[M::mem] kernel
    launches` line."""
    for line in err.splitlines():
        if line.startswith("[M::mem] kernel launches: ksw_extend2 "):
            return int(line.split()[4].rstrip(","))
    raise SystemExit("a rank printed no kernel launch line")


def phase_two_ranks(work: Path, device: str) -> dict:
    """One-process mem of reads.fq in 1024-read batches, then two ranks
    of `python -m bwa_flow_tpu_torch mem --nprocs 2 --dist pull` on the
    card; their union must equal the one-process SAM."""
    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.ops import extend_cuda

    ref, fq = str(work / "ref.fa"), str(work / "reads.fq")
    # -K x -t bases a FASTQ batch: exactly RANK_BATCH reads of READ_LEN
    base = ["-t", "4", "-K", str(RANK_BATCH * READ_LEN // 4),
            "--batch-reads", str(RANK_BATCH), "--disable-markdup",
            "--device", device, "--ext-mode", "waves"]
    extend_cuda.n_launches = 0
    extend_cuda.n_launches16 = 0
    t0 = time.perf_counter()
    assert cli.main(["mem"] + base + ["-o", str(work / "one.sam"), ref,
                                      fq]) == 0
    t_one = time.perf_counter() - t0
    one_launches = extend_cuda.n_launches
    print(f"[ranks] one process: {t_one:.2f} s, {N_READS / t_one:.1f} "
          f"reads/s, {N_READS // RANK_BATCH} batches, ksw_extend2 "
          f"launches {one_launches}")

    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("BWA_TPU_NPROCS", "BWA_TPU_PROC_ID", "BWA_TPU_COORDINATOR",
              "BWA_TPU_RUN_TOKEN", "BWA_TPU_EXTEND16"):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwa_flow_tpu_torch", "mem", "--nprocs", "2",
         "--proc-id", str(pid), "--coordinator", coord, "--dist", "pull"]
        + base + ["-o", str(work / "two.sam"), ref, fq],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(work)) for pid in range(2)]
    errs = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            _, errs[i] = p.communicate(
                timeout=max(1.0, RANK_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        raise SystemExit(f"a rank ran past {RANK_TIMEOUT} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    t_two = time.perf_counter() - t0
    for i, p in enumerate(procs):
        if p.returncode != 0:
            for q, e in enumerate(errs):
                print(f"[ranks] rank {q} stderr:\n{e[-4000:]}",
                      file=sys.stderr)
            raise SystemExit(f"rank {i} exited {p.returncode}")
    parts = [_records(work / f"two.part{i:03d}.sam") for i in range(2)]
    batches = [len({f[0] for f in part}) / RANK_BATCH for part in parts]
    launches = [_launches_line(e) for e in errs]
    print(f"[ranks] two ranks on one card: {t_two:.2f} s wall (process "
          f"start-up and index load included), {N_READS / t_two:.1f} "
          f"reads/s; batches per rank {batches}; records per rank "
          f"{[len(part) for part in parts]}; ksw_extend2 launches per "
          f"rank {launches}")
    if not all(parts):
        raise SystemExit("a rank's part holds no records")
    if device == "cuda" and min(launches) <= 0:
        raise SystemExit(f"a rank launched ksw_extend2 {launches} times")
    one = sorted("\t".join(f) for f in _records(work / "one.sam"))
    if sorted("\t".join(f) for part in parts for f in part) != one:
        raise SystemExit("the two ranks' union differs from the "
                         "one-process SAM")
    print(f"[ranks] union of two.part000.sam and two.part001.sam == "
          f"one.sam ({len(one)} records)")
    return dict(launches=launches, one_launches=one_launches)


def phase_seed_extend_batch(genome: np.ndarray, device: str) -> dict:
    """The coupled two-try seed_extend_batch on B_EXT lanes of
    make_coupled_tasks at the main path's shapes, on the card against
    its plain version on the CPU, under phase 2's three scorings; timed
    with CUDA events. The defaults must have lanes with both sides, with
    one, and 2w retries on each side."""
    import torch

    from bwa_flow_tpu_torch.ops import extend_cuda
    from bwa_flow_tpu_torch.ops.chain2aln_torch import seed_extend_batch

    a = make_coupled_tasks(np.random.default_rng(0xC0DE), genome, B_EXT)
    both = int(((a[1] > 0) & (a[5] > 0)).sum())
    one = int(((a[1] > 0) != (a[5] > 0)).sum())
    cpu_args = [torch.as_tensor(x) for x in a]
    dev_args = [x.to(device) for x in cpu_args]
    out: dict = {}
    for si, (sname, o, w, zd) in enumerate(ext_scorings()):
        mat = torch.as_tensor(np.ascontiguousarray(o.mat[:5, :5]),
                              dtype=torch.int32)
        mat_dev = mat.to(device)
        sc = (o.o_del, o.e_del, o.o_ins, o.e_ins, w, o.pen_clip5,
              o.pen_clip3, zd)

        def run_dev():
            return seed_extend_batch(QMAX, TMAX, *dev_args, mat_dev, *sc)
        extend_cuda.n_launches = extend_cuda.n_launches16 = 0
        got = run_dev()
        launches = extend_cuda.n_launches
        t0 = time.perf_counter()
        want = seed_extend_batch(QMAX, TMAX, *cpu_args, mat, *sc)
        cpu_s = time.perf_counter() - t0
        err, bad = _diff(got, want)
        nl = int((got[5] == 2 * w).sum())
        nr = int((got[11] == 2 * w).sum())
        ms = _time_ms(run_dev, 10, fill=True) if device == "cuda" else 0.0
        print(f"[seb] seed_extend_batch {sname}: B={B_EXT} ({both} lanes "
              f"with both sides, {one} with one), 2w retries left {nl} "
              f"right {nr}; mismatching values {bad} vs the CPU, max "
              f"|err| {err}; {launches} ksw_extend2 launches, {ms:.4f} "
              f"ms on the card (CUDA events), CPU {cpu_s:.2f} s")
        if bad:
            raise SystemExit(f"seed_extend_batch disagrees under {sname}")
        if device == "cuda" and launches != 4:
            raise SystemExit(f"seed_extend_batch launched ksw_extend2 "
                             f"{launches} times, not 4")
        if si == 0:
            if not (nl and nr and both and one):
                raise SystemExit("the coupled mix lacks retry lanes or "
                                 "empty sides under the defaults")
            out = dict(launches=launches, ms=ms, cpu_s=cpu_s,
                       retries=[nl, nr], max_abs_err=err)
    return out


def phase_local_devices(work: Path, device: str, n_shards: int) -> dict:
    """One process on n_shards shards, shard i on card i % device_count
    (distinct cards when the host has n_shards, else several shards,
    each with its own index replica, on one card): the mesh dry run,
    entry() on the card against the CPU, then phase 3's single-end run
    sharded through the CLI's _mem; its records must equal phase 3's
    full.sam, and every shard must have run waves on the int32
    kernel."""
    import torch

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch import entry as port_entry
    from bwa_flow_tpu_torch.ops import extend_cuda
    from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

    count = torch.cuda.device_count() if device == "cuda" else 1
    devices = [torch.device(device, i % count) if device == "cuda"
               else torch.device(device) for i in range(n_shards)]
    print(f"[ld] {n_shards} shards on {', '.join(map(str, devices))}: "
          + ("distinct cards" if count >= n_shards else
             f"{count} card(s), one index replica a shard"))
    out: dict = {}

    # the sharded device step and the production pipeline, tiny shapes
    t0 = time.perf_counter()
    extend_cuda.n_launches = extend_cuda.n_launches16 = 0
    dry = port_entry.dryrun_multichip(n_shards, devices)
    out["mesh_launches"] = extend_cuda.n_launches
    print(f"[ld] dryrun_multichip({n_shards}): checks passed, hist sum "
          f"{sum(dry['hist'])}, score_sum {dry['score_sum']}, production "
          f"pipeline SAM == one device; per shard waves "
          f"{[s['waves'] for s in dry['shards']]}; ksw_extend2 launches "
          f"{out['mesh_launches']}; {time.perf_counter() - t0:.1f} s")
    if device == "cuda" and out["mesh_launches"] <= 0:
        raise SystemExit("the mesh dry run launched no ksw_extend2")

    # entry(): the card against the plain versions on the CPU
    fn, args = port_entry.entry(device)
    got = fn(*args)
    fn_c, args_c = port_entry.entry("cpu")
    err, bad = _diff(got, fn_c(*args_c))
    print(f"[ld] entry(): {device} vs cpu, mismatching values {bad}, max "
          f"|err| {err}")
    if bad:
        raise SystemExit("entry() on the card differs from the CPU")
    # phase 3's single-end run over the shards, the CLI's own emit
    ref, fq = str(work / "ref.fa"), str(work / "reads.fq")
    argv = ["-t", "8", "--batch-reads", str(BATCH), "--device", device,
            "--ext-mode", "waves", "-o", str(work / "ld.sam"), ref, fq]
    args = cli._mem_parser().parse_args(argv)
    os.environ.pop("BWA_TPU_EXTEND16", None)   # the int32 kernel's path
    extend_cuda.n_launches = extend_cuda.n_launches16 = 0
    tracer.totals.clear()
    tracer.counts.clear()
    t0 = time.perf_counter()
    assert cli._mem(args, argv, cli.build_opt(args), 0, 1,
                    devices=devices) == 0
    dt = time.perf_counter() - t0
    launches, launches16 = extend_cuda.n_launches, extend_cuda.n_launches16
    st = dict(cli.last_run_stats)
    print(f"[ld] mem {N_READS} reads over {n_shards} shards: {dt:.2f} s, "
          f"{N_READS / dt:.1f} reads/s (index load included); waves "
          f"{st['waves']}, device tasks {st['ext_tasks_device']}, host "
          f"tasks {st['ext_tasks_host']}; ksw_extend2 launches {launches}, "
          f"ksw_extend2_i16 {launches16}")
    for i, sh in enumerate(st["shards"]):
        print(f"[ld] shard {i} on {sh['device']}: seed_s "
              f"{sh['seed_s']:.3f}, waves {sh['waves']}, device tasks "
              f"{sh['ext_tasks_device']}, ksw_extend2 launches "
              f"{sh['launches']}, ksw_extend2_i16 {sh['launches16']}")
    print(f"[ld] spans (host wall clock, s): {tracer.as_json()}")
    if len(st["shards"]) != n_shards or any(
            sh["ext_tasks_device"] <= 0 for sh in st["shards"]) or (
            device == "cuda" and (launches16 or any(
                sh["launches"] <= 0 for sh in st["shards"]))):
        raise SystemExit("a shard ran no waves on the int32 kernel")
    mine, want = _body(work / "ld.sam"), _body(work / "full.sam")
    if mine != want:
        raise SystemExit(f"the {n_shards}-shard SAM differs from phase "
                         "3's full.sam")
    print(f"[ld] ld.sam == full.sam ({len(mine)} lines, @PG aside)")
    out.update(launches=launches, reads_per_s=N_READS / dt, wall_s=dt,
               shard_launches=[sh["launches"] for sh in st["shards"]])
    return out


# ------------------------------------------------------------ phase 9

def _head_fastq(src: Path, dst: Path, n: int) -> Path:
    """The first n records of a FASTQ."""
    with open(src) as f:
        lines = [next(f) for _ in range(4 * n)]
    dst.write_text("".join(lines))
    return dst


def _cli_run(tag: str, argv: list, phase: str = "p9") -> dict:
    """One in-process `mem` run through the CLI with the kernels' counts
    and the spans set to 0 just before it; prints it under [phase] and
    returns its wall s, launches of each kernel, stats and spans."""
    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.ops import extend_cuda
    from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

    extend_cuda.n_launches = extend_cuda.n_launches16 = 0
    tracer.totals.clear()
    tracer.counts.clear()
    t0 = time.perf_counter()
    assert cli.main(["mem"] + argv) == 0
    dt = time.perf_counter() - t0
    st = dict(cli.last_run_stats)
    spans = {k: round(v, 3) for k, v in tracer.totals.items()}
    out = dict(wall_s=dt, launches=extend_cuda.n_launches,
               launches16=extend_cuda.n_launches16, stats=st, spans=spans,
               seed_s_per_batch=st["seed_s"] / max(1, st["seed_batches"]))
    print(f"[{phase}] {tag}: {dt:.2f} s; spans seed {spans.get('seed', 0)} s, "
          f"sa {spans.get('sa', 0)} s, extend_waves "
          f"{spans.get('extend_waves', 0)} s; seed_s "
          f"{out['seed_s_per_batch']:.3f} s/batch over "
          f"{st['seed_batches']} batches; sa_host_redo "
          f"{st['sa_host_redo']}; ksw_extend2 launches {out['launches']}, "
          f"ksw_extend2_i16 {out['launches16']}")
    return out


def _failing_run(argv: list):
    """The error behind an in-process `mem` run's non-zero exit (the
    SystemExit itself where it has no cause), or None when it exits 0."""
    from bwa_flow_tpu_torch import cli
    try:
        cli.main(["mem"] + argv)
    except SystemExit as e:
        return e.__cause__ or e
    return None


def _inexact_reads(work: Path, dst: Path, n: int) -> Path:
    """The first n reads of reads.fq that are no exact substring of the
    genome on either strand (they carry a substitution, so each has an
    extension to make)."""
    text = "".join(l.strip() for l in open(work / "ref.fa")
                   if not l.startswith(">"))
    rc = text.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    out = []
    with open(work / "reads.fq") as f:
        for rec in zip(f, f, f, f):
            if rec[1].strip() not in text and rec[1].strip() not in rc:
                out.append("".join(rec))
                if len(out) == n:
                    break
    dst.write_text("".join(out))
    return dst


@contextlib.contextmanager
def _recording(owner, attr: str, record):
    """While the block runs, call record(args) before each call of
    owner.attr; yields the list of what record returned."""
    fn = getattr(owner, attr)
    seen: list = []

    def wrapped(*a, **k):
        seen.append(record(a))
        return fn(*a, **k)
    setattr(owner, attr, wrapped)
    try:
        yield seen
    finally:
        setattr(owner, attr, fn)


def phase_bypassed_paths(work: Path, device: str) -> dict:
    """The device paths no earlier phase runs: the first P9_READS of
    phase 3's reads on the wide path (index.io.FORCE_WIDE: the int64 seed
    machine and SA) and with no dense SA (BWA_TPU_DENSE_SA_MAX=0: the
    seed program's fused LF
    walk, and resolve_sa_flat's walks of the redone reads), against the
    default path in the same phase; then -I 400,40 on phase 4's pairs
    (int16 kernel): 64 pairs equal to --no-device, and the mapped and
    proper shares of P9_PAIRS pairs."""
    import torch

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.index import io as idx_io
    from bwa_flow_tpu_torch.ops import fm_cuda, smem_torch

    ref = str(work / "ref.fa")
    fq = str(_head_fastq(work / "reads.fq", work / "p9_reads.fq", P9_READS))
    base = ["-t", "8", "--batch-reads", str(BATCH), "--device", device,
            "--ext-mode", "waves"]
    os.environ.pop("BWA_TPU_EXTEND16", None)   # the int32 kernel's path
    runs: dict = {}
    dtype = (smem_torch, "collect_intv_device", lambda a: a[0].L2.dtype)
    with _recording(*dtype) as dts:
        runs["default"] = _cli_run("default", base + [
            "-o", str(work / "p9_default.sam"), ref, fq])
    idx_io.FORCE_WIDE = True
    try:
        with _recording(*dtype) as dts_wide:
            runs["wide"] = _cli_run("wide int64 machine", base + [
                "-o", str(work / "p9_wide.sam"), ref, fq])
    finally:
        idx_io.FORCE_WIDE = False
    print(f"[p9] seed machines' coordinates: default {set(dts)}, wide "
          f"{set(dts_wide)}")
    if set(dts) != {torch.int32} or set(dts_wide) != {torch.int64}:
        raise SystemExit("the default run's seed machines were not int32, "
                         "or the wide run's not int64")
    os.environ["BWA_TPU_DENSE_SA_MAX"] = "0"
    fm_cuda.n_launches["sa_walk"] = 0
    try:
        # recorded_sa_batch first: it replaces only the real sa_batch
        with recorded_sa_batch() as calls, \
                timed_calls(smem_torch, "sa_batch") as walks, \
                plain_walk_calls() as plain:
            runs["no_dense_sa"] = _cli_run("no dense SA", base + [
                "-o", str(work / "p9_nodense.sam"), ref, fq])
    finally:
        del os.environ["BWA_TPU_DENSE_SA_MAX"]
    runs["no_dense_sa"]["walk_launches"] = fm_cuda.n_launches["sa_walk"]
    print(f"[p9] no dense SA: the seed program's fused LF walk ran "
          f"{walks['calls']} times, {walks['s']:.3f} s")
    if not walks["calls"]:
        raise SystemExit("the no-dense-SA run took no fused LF walk")
    walk_launch_check("p9 no dense SA", fm_cuda.n_launches["sa_walk"],
                      calls, plain)
    runs["no_dense_sa"]["walk_calls"] = walk_calls_check("p9 no dense SA",
                                                         calls)
    del calls
    want = _body(work / "p9_default.sam")
    for tag, name in (("wide", "p9_wide.sam"),
                      ("no_dense_sa", "p9_nodense.sam")):
        if _body(work / name) != want:
            raise SystemExit(f"the {tag} run's SAM differs from the "
                             "default path's")
        if device == "cuda" and runs[tag]["launches"] <= 0:
            raise SystemExit(f"the {tag} run launched no ksw_extend2")
    print(f"[p9] wide, no-dense-SA and default SAMs equal ({len(want)} "
          f"lines, @PG aside, {P9_READS} reads)")

    # -I: pairing with a fixed insert size does not depend on the batch
    pe = ["-I", f"{INSERT_MEAN},{INSERT_SD}", "--disable-markdup"]
    sub = [str(_head_fastq(work / f"sub{k}.fq", work / f"p9_sub{k}.fq",
                           P9_I_PAIRS)) for k in (1, 2)]
    os.environ["BWA_TPU_EXTEND16"] = "1"
    try:
        runs["insert_sub"] = _cli_run(f"-I on {P9_I_PAIRS} pairs", base + pe + [
            "-o", str(work / "p9_I_dev.sam"), ref] + sub)
        t0 = time.perf_counter()
        assert cli.main(["mem", "--no-device"] + pe + [
            "-o", str(work / "p9_I_host.sam"), ref] + sub) == 0
        t_host = time.perf_counter() - t0
        r12 = [str(_head_fastq(work / f"r{k}.fq", work / f"p9_r{k}.fq",
                               P9_PAIRS)) for k in (1, 2)]
        runs["insert"] = _cli_run(f"-I on {P9_PAIRS} pairs", base + pe + [
            "-o", str(work / "p9_I.sam"), ref] + r12)
    finally:
        del os.environ["BWA_TPU_EXTEND16"]
    if _body(work / "p9_I_dev.sam") != _body(work / "p9_I_host.sam"):
        raise SystemExit(f"-I: the device SAM differs from --no-device on "
                         f"{P9_I_PAIRS} pairs")
    print(f"[p9] -I {INSERT_MEAN},{INSERT_SD}: device SAM == --no-device "
          f"SAM on {P9_I_PAIRS} pairs (--no-device {t_host:.1f} s)")
    mapped = proper = 0
    for f in _records(work / "p9_I.sam"):
        flag = int(f[1])
        if not flag & 0x900:
            mapped += 0 if flag & 0x4 else 1
            proper += 1 if flag & 0x42 == 0x42 else 0
    frac, frac_p = mapped / (2 * P9_PAIRS), proper / P9_PAIRS
    print(f"[p9] -I on {P9_PAIRS} pairs: reads mapped {frac:.4f}, pairs "
          f"proper {frac_p:.4f}")
    if frac_p < 0.90:
        raise SystemExit(f"-I: only {frac_p:.4f} of pairs proper")
    for tag in ("insert_sub", "insert"):
        if device == "cuda" and (runs[tag]["launches16"] <= 0
                                 or runs[tag]["launches"]):
            raise SystemExit(f"the {tag} run did not run on the int16 "
                             "kernel alone")
    return runs


# a `mem` run in --ext-mode waves (no host drain, no harvester) whose
# second batch's first wave fetch, in the extension worker, finds the
# card held by a spin kernel of argv[1] cycles; prints when it was queued
_STALL_SCRIPT = """\
import sys, time, torch
from bwa_flow_tpu_torch import cli
from bwa_flow_tpu_torch.pipeline import batch
B = batch.BatchAligner
init, fetch, start = B.__init__, B.fetch, B.extend_async
def waves_only(self, *a, **k):
    init(self, *a, **k)
    self.drain_max, self.harvest_workers = 0, 0
armed = []
def stalled_fetch(self, t, *a):
    if armed and torch.is_tensor(t) and t.dim() == 2 and t.shape[0] == 12:
        armed.clear()
        torch.cuda._sleep(int(sys.argv[1]))
        print(f"[stall] queued at {time.time():.3f}", file=sys.stderr,
              flush=True)
    return fetch(self, t, *a)
calls = []
def arm(self, *a, **k):
    calls.append(1)
    if len(calls) == 2:
        armed.append(1)
    return start(self, *a, **k)
B.__init__, B.fetch, B.extend_async = waves_only, stalled_fetch, arm
cli.entry_main(sys.argv[2:])
"""


@contextlib.contextmanager
def watchdog_split():
    """While the block runs, split the batch aligner's device reads: the
    watched waits (BatchAligner.wait calls; with --device-timeout 0 each
    returns at once), the seconds inside wait_ready (the watchdog's own
    wait), and the seconds of every fetch and put (wait and copy), all of
    them and those inside seeds_collect (the seed span's reads); yields
    the sums."""
    import threading

    from bwa_flow_tpu_torch.pipeline import batch as bm
    acc = dict(waits=0, seed_waits=0, wait_ready_s=0.0, read_s=0.0,
               seed_read_s=0.0)
    inside = threading.local()
    cls = bm.BatchAligner
    real = dict(wait_ready=bm.wait_ready, wait=cls.wait, fetch=cls.fetch,
                put=cls.put, seeds_collect=cls.seeds_collect)

    def seeding() -> bool:
        return getattr(inside, "seed", False)

    def wait_ready(*a, **k):
        t0 = time.perf_counter()
        try:
            return real["wait_ready"](*a, **k)
        finally:
            acc["wait_ready_s"] += time.perf_counter() - t0

    def wait(self, *a, **k):
        acc["waits"] += 1
        acc["seed_waits"] += seeding()
        return real["wait"](self, *a, **k)

    def reader(name):
        def read(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return real[name](self, *a, **k)
            finally:
                dt = time.perf_counter() - t0
                acc["read_s"] += dt
                if seeding():
                    acc["seed_read_s"] += dt
        return read

    def seeds_collect(self, *a, **k):
        inside.seed = True
        try:
            return real["seeds_collect"](self, *a, **k)
        finally:
            inside.seed = False
    bm.wait_ready = wait_ready
    cls.wait, cls.fetch, cls.put = wait, reader("fetch"), reader("put")
    cls.seeds_collect = seeds_collect
    try:
        yield acc
    finally:
        bm.wait_ready = real["wait_ready"]
        for name in ("wait", "fetch", "put", "seeds_collect"):
            setattr(cls, name, real[name])


def phase_validation_watchdog(work: Path, device: str, main: dict) -> dict:
    """--validate-every 1 on phase 3's reads (SAM == full.sam, one
    validation a batch); the corrupted-result injections (one lane's
    score: the validation names the read; qle = -3 with validation off:
    the structural check); a real stall (a spin kernel on the wave's
    stream before its fetch) under --device-timeout STALL_TIMEOUT, in
    process and in a CLI subprocess; and phase 3's run with the watchdog
    off and on in turns, its cost and where it goes (watchdog_split)."""
    import torch

    from bwa_flow_tpu_torch.ops import extend_cuda
    from bwa_flow_tpu_torch.pipeline import batch
    from bwa_flow_tpu_torch.pipeline.batch import (BatchAligner,
                                                   DeviceResultError)
    from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline

    ref, fq = str(work / "ref.fa"), str(work / "reads.fq")
    base = ["-t", "8", "--batch-reads", str(BATCH), "--device", device,
            "--ext-mode", "waves"]
    os.environ.pop("BWA_TPU_EXTEND16", None)   # the int32 kernel's path
    runs: dict = {}
    with timed_calls(AlignPipeline, "_validate_sample") as val:
        runs["validate"] = _cli_run("--validate-every 1", base + [
            "--validate-every", "1", "-o", str(work / "p9_valid.sam"), ref,
            fq])
    v = runs["validate"]["stats"]
    print(f"[p9] --validate-every 1: {v['validations']} validations of "
          f"{v['seed_batches']} batches, {val['s']:.2f} s of golden "
          "checks")
    if _body(work / "p9_valid.sam") != _body(work / "full.sam"):
        raise SystemExit("the --validate-every 1 SAM differs from phase "
                         "3's full.sam")
    if v["validations"] != v["seed_batches"]:
        raise SystemExit("not one validation a batch")
    # the watchdog's cost: the same run with it off and on, in turns, and
    # where it goes (watchdog_split)
    on, off = [], []
    for i, timeout in enumerate(("0", "300", "300", "0")):
        with watchdog_split() as split:
            r = _cli_run(f"--device-timeout {timeout}", base + [
                "--device-timeout", timeout, "-o",
                str(work / f"p9_t{i}.sam"), ref, fq])
        r["split"] = split
        batches = max(1, r["stats"]["seed_batches"])
        print(f"[p9] --device-timeout {timeout}: {split['waits']} watched "
              f"waits ({split['waits'] / batches:.1f} a batch), "
              f"{split['seed_waits']} of them in the seed collect; "
              f"wait_ready {split['wait_ready_s']:.4f} s; device reads "
              f"(fetch and put, wait and copy) {split['read_s']:.4f} s, "
              f"{split['seed_read_s']:.4f} s of them in the seed collect")
        if _body(work / f"p9_t{i}.sam") != _body(work / "full.sam"):
            raise SystemExit(f"the --device-timeout {timeout} SAM differs "
                             "from phase 3's full.sam")
        (off if timeout == "0" else on).append(r)
    runs["timeout0"] = off[0]

    def mean(rs, key):
        return sum(r["wall_s"] if key == "wall_s" else
                   r["split"][key] if key in r["split"] else
                   r["spans"][key] for r in rs) / len(rs)
    cost = {k: (mean(on, k), mean(off, k))
            for k in ("seed", "extend_waves", "wall_s", "waits",
                      "wait_ready_s", "read_s", "seed_read_s")}
    print(f"[p9] watchdog cost over whole runs (means of 2 on, 2 off, in "
          f"turns): seed span {cost['seed'][0]:.3f} s on, "
          f"{cost['seed'][1]:.3f} s off ({cost['seed'][0] / cost['seed'][1]:.3f}x); "
          f"extend_waves {cost['extend_waves'][0]:.3f} / "
          f"{cost['extend_waves'][1]:.3f} s; wall {cost['wall_s'][0]:.2f} / "
          f"{cost['wall_s'][1]:.2f} s ({cost['wall_s'][0] / cost['wall_s'][1]:.3f}x); "
          f"device reads {cost['read_s'][0]:.4f} / {cost['read_s'][1]:.4f} s "
          f"(seed collect's {cost['seed_read_s'][0]:.4f} / "
          f"{cost['seed_read_s'][1]:.4f} s), wait_ready "
          f"{cost['wait_ready_s'][0]:.4f} s on; {cost['waits'][0]:.0f} "
          f"watched waits a run; phase 3 (on, first index load included): "
          f"seed {main['spans']['seed']:.3f} s, wall {main['wall_s']:.2f} s")
    # the watchdog's own cost: what its waits add to the device reads,
    # against the seed span and the wall with it off
    own = dict(seed=cost["seed_read_s"][0] - cost["seed_read_s"][1],
               wall=cost["read_s"][0] - cost["read_s"][1])
    print(f"[p9] the watchdog's own cost (device reads on less off): "
          f"{own['seed'] * 1e3:+.2f} ms in the seed collect, "
          f"{own['seed'] / cost['seed'][1] * 100:+.2f}% of the seed span; "
          f"{own['wall'] * 1e3:+.2f} ms in all device reads, "
          f"{own['wall'] / cost['wall_s'][1] * 100:+.3f}% of the wall")
    runs["watchdog"] = dict(
        own_s=own, own_seed_share=own["seed"] / cost["seed"][1],
        own_wall_share=own["wall"] / cost["wall_s"][1],
        runs={k: [[round(r["spans"]["seed"], 3), round(r["wall_s"], 2)]
                  for r in rs] for k, rs in (("on", on), ("off", off))},
        seed_ratio=cost["seed"][0] / cost["seed"][1],
        wall_ratio=cost["wall_s"][0] / cost["wall_s"][1],
        waits=cost["waits"][0], split={k: v for k, v in cost.items()})

    # one lane's score off by one, in a lane of a read the validation
    # samples (reads 0 and N_SUB / 2 of the batch; each of these reads
    # has an extension to make), inside the structural check's range: the
    # validation must name that read
    sub = str(_inexact_reads(work, work / "p9_bad.fq", N_SUB))
    targets = (0, N_SUB // 2)
    hit: dict = {}
    real_core = extend_cuda.extend_core_cuda

    def off_by_one(qmax, tmax, q, qlen, t, tlen, h0, *rest):
        out = real_core(qmax, tmax, q, qlen, t, tlen, h0, *rest)
        if "read" not in hit:
            ql, hh = qlen.cpu().numpy(), h0.cpu().numpy()
            sc = out[0].cpu().numpy()
            for target in targets:
                lane = np.nonzero((rows[-1] == target) & (ql > 0))[0]
                if len(lane):
                    j = int(lane[0])
                    delta = -1 if sc[j] > hh[j] else 1
                    out[0][j:j + 1].add_(delta)
                    hit.update(read=target, lane=j, delta=delta)
                    break
        return out
    # each wave launch's read rows (its descriptors' row 0)
    with _recording(batch, "seed_extend_desc_batch",
                    lambda a: a[5][0].cpu().numpy()) as rows:
        extend_cuda.extend_core_cuda = off_by_one
        try:
            err = _failing_run(base + ["--validate-every", "1", "-o",
                                       str(work / "p9_bad.sam"), ref, sub])
        finally:
            extend_cuda.extend_core_cuda = real_core
    names = [l[1:].split()[0] for l in open(sub).read().splitlines()[::4]]
    name = f"read {hit['read']} ({names[hit['read']]})" if hit else "?"
    if not isinstance(err, DeviceResultError) or name not in str(err) \
            or "golden model" not in str(err):
        raise SystemExit(f"the corrupted score gave {err!r}, not a "
                         f"validation error naming {name}")
    print(f"[p9] score {hit['delta']:+d} in lane {hit['lane']} ("
          f"{name}): DeviceResultError: {str(err)[:300]}")

    # qle = -3 in every lane of the first left extension, validation off
    def bad_qle(*a):
        out = real_core(*a)
        out[1].fill_(-3)
        return out
    extend_cuda.extend_core_cuda = bad_qle
    try:
        err = _failing_run(base + ["-o", str(work / "p9_bad.sam"), ref,
                                   sub])
    finally:
        extend_cuda.extend_core_cuda = real_core
    if not isinstance(err, DeviceResultError) or "qle = -3" not in str(err):
        raise SystemExit(f"qle = -3 gave {err!r}, not a structural check "
                         "error")
    print(f"[p9] qle = -3 with --validate-every 0: DeviceResultError: "
          f"{err}")

    # a real stall: the card held by a spin kernel of ~STALL_S s queued on
    # the wave's stream just before its fetch
    cycles = int(STALL_S * SPIN_HZ)
    real_fetch = BatchAligner.fetch
    stall: dict = {}

    def stalled_fetch(self, t, *a):
        if not stall and torch.is_tensor(t) and t.dim() == 2 \
                and t.shape[0] == 12:
            torch.cuda._sleep(cycles)
            stall["t0"] = time.perf_counter()
        return real_fetch(self, t, *a)
    BatchAligner.fetch = stalled_fetch
    try:
        err = _failing_run(base + ["--device-timeout", str(STALL_TIMEOUT),
                                   "-o", str(work / "p9_stall.sam"), ref,
                                   sub])
        t_err = time.perf_counter() - stall.get("t0", time.perf_counter())
    finally:
        BatchAligner.fetch = real_fetch
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t_sync = time.perf_counter() - t0
    print(f"[p9] stall of ~{STALL_S} s under --device-timeout "
          f"{STALL_TIMEOUT}: {type(err).__name__} {t_err:.2f} s after the "
          f"spin kernel was queued; the card was free {t_sync:.2f} s later")
    if not isinstance(err, TimeoutError) or not 2 <= t_err <= 5:
        raise SystemExit(f"the stall gave {err!r} after {t_err:.2f} s")
    runs["stall_s"] = t_err

    # the same stall in a CLI subprocess (its second batch): exits non-zero
    script = work / "stall_run.py"
    script.write_text(_STALL_SCRIPT)
    fq2 = str(_head_fastq(work / "reads.fq", work / "p9_stall.fq",
                          P9_READS))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, str(script), str(cycles), "mem", "-t", "8",
         "--batch-reads", str(P9_READS // 2), "--device", device,
         "--device-timeout",
         str(STALL_TIMEOUT), "-o", str(work / "p9_stall2.sam"), ref, fq2],
        capture_output=True, text=True, env=env, timeout=300)
    t_end = time.time()
    queued = [float(l.split()[-1]) for l in r.stderr.splitlines()
              if l.startswith("[stall] queued at ")]
    errs = [l for l in r.stderr.splitlines() if l.startswith("[E::mem]")]
    print(f"[p9] stalled CLI subprocess: exit {r.returncode}, wall "
          f"{t_end - t0:.2f} s, exit {t_end - queued[0]:.2f} s after the "
          f"spin kernel was queued; {errs[:1]}" if queued else
          f"[p9] stalled CLI subprocess: exit {r.returncode}, no stall "
          f"queued; stderr {r.stderr[-2000:]}")
    if r.returncode == 0 or not queued or not errs:
        raise SystemExit("the stalled CLI run did not fail with [E::mem]")
    runs["stall_cli"] = dict(wall_s=t_end - t0, after_stall_s=t_end
                             - queued[0])
    return runs


# ----------------------------------------------------------- phase 10

def _native_run(tag: str, argv: list, extend16: bool = False,
                devices=None, capture: bool = False, n: int | None = None,
                phase: str = "p10") -> dict:
    """One in-process `mem` run on the native route (the CLI's own, or
    _mem over `devices`) of n reads or pairs (N_READS or N_PAIRS by
    default), with the kernels' counts and the spans set to 0 just
    before it and CUDA events around every kernel call; prints under
    [phase] and returns its wall s, rate, spans, the native driver's
    counters, and each kernel's launches and device ms (the LF walk's
    under "walk_launches"). With capture, each kernel is then held
    against its plain version at the run's shapes (native_shapes),
    under "shapes"."""
    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.ops import extend_cuda, fm_cuda, smem_cuda
    from bwa_flow_tpu_torch.utils.trace import GLOBAL as tracer

    if extend16:
        os.environ["BWA_TPU_EXTEND16"] = "1"
    else:
        os.environ.pop("BWA_TPU_EXTEND16", None)
    extend_cuda.n_launches = extend_cuda.n_launches16 = 0
    smem_cuda.n_launches.update(dict.fromkeys(smem_cuda.KERNELS, 0))
    fm_cuda.n_launches.update(dict.fromkeys(fm_cuda.KERNELS, 0))
    tracer.totals.clear()
    tracer.counts.clear()
    try:
        t0 = time.perf_counter()
        with timed_launches(capture) as log, markdup_stages() as mds, \
                plain_seed_calls() as plain:
            if devices is None:
                assert cli.main(["mem"] + argv) == 0
            else:
                args = cli._mem_parser().parse_args(argv)
                assert cli._mem(args, argv, cli.build_opt(args), 0, 1,
                                devices=devices) == 0
        dt = time.perf_counter() - t0
    finally:
        os.environ.pop("BWA_TPU_EXTEND16", None)
    seed_launches = dict(smem_cuda.n_launches)
    walk_launches = fm_cuda.n_launches["sa_walk"]
    seed_launch_check(f"{phase} {tag}", seed_launches, plain)
    path = launch_times(log, f"{phase} {tag}")
    mdup = markdup_summary(f"{phase} {tag}", mds, "NativeMarkDupStage")
    st = dict(cli.last_run_stats)
    spans = {k: round(v, 3) for k, v in sorted(tracer.totals.items())}
    pairs = len([a for a in argv if a.endswith(".fq")]) == 2
    n = n or (N_PAIRS if pairs else N_READS)
    out = dict(wall_s=dt, rate=n / dt, launches=extend_cuda.n_launches,
               launches16=extend_cuda.n_launches16, stats=st, spans=spans,
               seed_launches=seed_launches, walk_launches=walk_launches,
               seed_s_per_batch=st["seed_s"] / max(1, st["seed_batches"]),
               device_ms={k: v["device_ms"] for k, v in path.items()},
               markdup=mdup)
    keys = ("waves", "ext_tasks_device", "ext_tasks_host", "host_oversize_q",
            "host_oversize_t", "host_sched")
    print(f"[{phase}] {tag}: {dt:.2f} s, {n / dt:.1f} "
          f"{'pairs' if pairs else 'reads'}/s (index load included); "
          f"{', '.join(f'{k} {st[k]}' for k in keys)}; ksw_extend2 "
          f"launches {out['launches']}, ksw_extend2_i16 "
          f"{out['launches16']}, sa_walk {walk_launches}; device ms "
          f"{out['device_ms']}")
    print(f"[{phase}] {tag} spans (host wall clock, s): {json.dumps(spans)}")
    print(f"[{phase}] {tag}: seed {out['seed_s_per_batch']:.3f} s/batch "
          f"over {st['seed_batches']} batches; {enqueue_summary(st)}")
    if capture:
        out["shapes"] = native_shapes(log)
    return out


def native_shapes(log: dict) -> dict:
    """Each kernel at the native route's own shapes: for each (qmax,
    tmax) class its waves launched with, the launch of this run whose
    width is nearest the class's mean, its inputs as captured
    (timed_launches(capture=True)), against the plain version on the
    same inputs (tolerance 0), timed, with its bound. Returns per kernel
    the classes and their launch-weighted means: the time, plain time
    and bound of one launch of this path."""
    import torch
    kernels = _kernels()
    out = {}
    for name, events in log.items():
        if not events:
            continue
        kern, plain = kernels[name]
        classes: dict = {}
        for _, _, b, a in events:
            classes.setdefault((a[0], a[1]), []).append((b, a))
        rows = []
        for (qm, tm), launches in sorted(classes.items()):
            mean_b = sum(b for b, _ in launches) / len(launches)
            b, a = min(launches, key=lambda x: abs(x[0] - mean_b))
            stats: dict = {}
            want = plain(*a, stats=stats)
            got = kern(*a)
            torch.cuda.synchronize()
            err, bad = _diff(got, want)
            if bad:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"on a native wave at ({qm}, {tm}), B={b}: "
                                 f"{bad} values")
            ms = _time_ms(lambda: kern(*a), 200, fill=True)
            plain_ms = _time_ms(lambda: plain(*a), 1)
            bd = _bound(name, list(a[2:7]), stats["cells"])
            rows.append(dict(qmax=qm, tmax=tm, launches=len(launches),
                             mean_B=mean_b, B=b, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, **bd))
            print(f"[p10] {name} at ({qm}, {tm}): {len(launches)} launches, "
                  f"mean B {mean_b:.1f}; a wave of B={b} from the run: "
                  f"mismatching values {bad} vs plain, max |err| {err}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bd['bound_ms']:.5f} ms ({bd['bound_by']}), "
                  f"{bd['cells']} cells")
        n = sum(r["launches"] for r in rows)
        out[name] = dict(classes=rows, **{
            k: sum(r["launches"] * r[k] for r in rows) / n
            for k in ("ms", "plain_ms", "bound_ms")},
            bound_by=max(rows, key=lambda r: r["launches"] * r["bound_ms"]
                         )["bound_by"],
            max_abs_err=max(r["max_abs_err"] for r in rows))
    return out


# a `mem` run on the native route (--ext-mode waves) whose second batch's
# extension starts behind a spin kernel of argv[1] cycles on the card;
# prints when the spin kernel was queued
_NATIVE_STALL_SCRIPT = """\
import sys, time, torch
from bwa_flow_tpu_torch import cli
from bwa_flow_tpu_torch.pipeline import batch
start = batch.BatchAligner.extend_async
calls = []
def stall(self, *a, **k):
    calls.append(1)
    if len(calls) == 2:
        torch.cuda._sleep(int(sys.argv[1]))
        print(f"[stall] queued at {time.time():.3f}", file=sys.stderr,
              flush=True)
    return start(self, *a, **k)
batch.BatchAligner.extend_async = stall
cli.entry_main(sys.argv[2:])
"""


def phase_native_route(work: Path, device: str, p34_md: dict) -> dict:
    """The native route at phase 3's and phase 4's full width: host and
    waves modes, single-end and paired-end, each SAM equal to phase 3's
    or 4's and each duplicate count equal to theirs (p34_md holds their
    markdup summaries by SAM name); two shards of the one card in waves
    mode; a corrupted wave row before the native apply."""
    import torch

    from bwa_flow_tpu_torch.pipeline import batch
    from bwa_flow_tpu_torch.pipeline.batch import DeviceResultError

    ref = str(work / "ref.fa")
    se = [str(work / "reads.fq")]
    pe = [str(work / "r1.fq"), str(work / "r2.fq")]
    base = ["-t", "8", "--batch-reads", str(BATCH), "--device", device]
    ncpu = os.cpu_count() or 2
    print(f"[p10] host CPUs {ncpu}: harvester threads {max(1, ncpu - 1)} "
          f"in host mode, {max(0, min(2, ncpu - 2))} in waves mode")
    runs: dict = {}
    for tag, fq, mode, want, e16 in (
            ("se_host", se, "host", "full.sam", False),
            ("se_waves", se, "waves", "full.sam", False),
            ("pe_host", pe, "host", "pe.sam", False),
            ("pe_waves", pe, "waves", "pe.sam", True)):
        out = work / f"p10_{tag}.sam"
        runs[tag] = r = _native_run(
            tag, base + ["--ext-mode", mode, "-o", str(out), ref] + fq,
            extend16=e16, capture=mode == "waves")
        if _body(out) != _body(work / want):
            raise SystemExit(f"phase 10 {tag}: the SAM differs from "
                             f"{want}")
        dups, p34_dups = r["markdup"]["dup_count"], \
            p34_md[want]["dup_count"]
        print(f"[p10] {tag}: markdup duplicate blocks {dups} "
              f"({r['markdup']['s']:.4f} s), {want}'s run {p34_dups} "
              f"({p34_md[want]['s']:.4f} s)")
        if dups != p34_dups:
            raise SystemExit(f"phase 10 {tag}: markdup counted {dups} "
                             f"duplicates, {want}'s run {p34_dups}")
        st = r["stats"]
        if mode == "host":
            ok = r["launches"] == r["launches16"] == 0 \
                and st["ext_tasks_device"] == 0 and st["waves"] == 0
        else:
            kern = r["launches16"] if e16 else r["launches"]
            other = r["launches"] if e16 else r["launches16"]
            ok = kern > 0 and other == 0 and st["ext_tasks_device"] > 0
        if not ok:
            raise SystemExit(f"phase 10 {tag}: launches "
                             f"{r['launches']} + {r['launches16']} "
                             f"(int16), device tasks "
                             f"{st['ext_tasks_device']}")
        print(f"[p10] {tag}: SAM == {want} (@PG aside)")

    devs = [torch.device(device, 0)] * LD_SHARDS
    out = work / "p10_shards.sam"
    runs["shards"] = r = _native_run(
        f"{LD_SHARDS} shards of {devs[0]}, waves",
        base + ["--ext-mode", "waves", "-o", str(out), ref] + se,
        devices=devs)
    shards = r["stats"]["shards"]
    for i, sh in enumerate(shards):
        print(f"[p10] shard {i} on {sh['device']}: seed_s "
              f"{sh['seed_s']:.3f}, waves {sh['waves']}, device tasks "
              f"{sh['ext_tasks_device']}, ksw_extend2 launches "
              f"{sh['launches']}")
    if _body(out) != _body(work / "full.sam"):
        raise SystemExit("phase 10: the two-shard SAM differs from "
                         "full.sam")
    if len(shards) != LD_SHARDS or any(sh["launches"] <= 0
                                       for sh in shards):
        raise SystemExit("phase 10: a shard launched no ksw_extend2")
    runs["shards"]["shard_launches"] = [sh["launches"] for sh in shards]
    print("[p10] two shards: SAM == full.sam (@PG aside)")

    # a wave row outside its task's range, before the native apply
    fq = str(_head_fastq(work / "reads.fq", work / "p10_inject.fq",
                         P9_READS))
    real = batch.seed_extend_desc_batch

    def corrupt(*a, **k):
        rows = real(*a, **k)
        rows[1, 0] = -3   # lqle of the wave's first lane
        return rows
    batch.seed_extend_desc_batch = corrupt
    try:
        err = _failing_run(base + ["--ext-mode", "waves", "-o",
                                   str(work / "p10_inject.sam"), ref, fq])
    finally:
        batch.seed_extend_desc_batch = real
    if not isinstance(err, DeviceResultError) or "wave lane 0" not in \
            str(err) or "lqle = -3" not in str(err):
        raise SystemExit(f"phase 10: the corrupted row gave {err!r}")
    print(f"[p10] lqle = -3 in a native wave: DeviceResultError: {err}")

    # a hung card in a CLI subprocess on the native route: the main
    # thread's wait times out, the extension worker's wait is abandoned
    script = work / "native_stall_run.py"
    script.write_text(_NATIVE_STALL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, str(script), str(int(STALL_S * SPIN_HZ)), "mem",
         "-t", "8", "--batch-reads", str(P9_READS // 4), "--ext-mode",
         "waves", "--device", device, "--device-timeout",
         str(STALL_TIMEOUT), "-o", str(work / "p10_stall.sam"), ref, fq],
        capture_output=True, text=True, env=env, timeout=300)
    t_end = time.time()
    queued = [float(l.split()[-1]) for l in r.stderr.splitlines()
              if l.startswith("[stall] queued at ")]
    errs = [l for l in r.stderr.splitlines() if l.startswith("[E::mem]")]
    after = t_end - queued[0] if queued else float("nan")
    print(f"[p10] stalled native CLI subprocess (--ext-mode waves, "
          f"--device-timeout {STALL_TIMEOUT}): exit {r.returncode}, wall "
          f"{t_end - t0:.2f} s, out {after:.2f} s after the spin kernel "
          f"was queued; {errs[:1]}")
    if r.returncode == 0 or not queued or not errs \
            or not after <= STALL_TIMEOUT + 2:
        raise SystemExit(f"the stalled native run did not fail with "
                         f"[E::mem] within {STALL_TIMEOUT + 2} s: "
                         f"{r.stderr[-2000:]}")
    runs["stall_cli"] = dict(wall_s=t_end - t0, after_stall_s=after)
    return runs


# ----------------------------------------------------------- phase 11

P11_SA_LEN = 1_000_000       # genome bp whose two strands (a) sorts
P11_TASKS = 2000             # extension tasks of (b)
P11_DUP_PAIRS = 512          # pe.sam pairs (c) repeats under new names

# a malformed SAM line (an unknown CIGAR op) given to _bam.sam_to_bam:
# ValueError, exit 1
_MALFORMED_SCRIPT = """\
import sys
from bwa_flow_tpu_torch import _build
try:
    _build.host_module("_bam").sam_to_bam(
        "r\\t0\\tc1\\t10\\t60\\t4Z\\t*\\t0\\t0\\tACGT\\tIIII\\n", b"c1\\x00")
except ValueError as e:
    print("ValueError:", e)
    sys.exit(1)
print("no error")
"""


def _sais_cases():
    """tests/test_index.py's adversarial texts, from a fixed seed."""
    rng = np.random.default_rng(0x5A15)
    cases = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (1, 2, 7, 64, 1000, 65537)]
    return cases + [np.zeros(100, np.uint8),
                    np.tile(np.array([3, 0], np.uint8), 500),
                    np.tile(np.array([1, 1, 0], np.uint8), 333),
                    np.arange(4, dtype=np.uint8).repeat(25)]


def _timed(fn, *a):
    t0 = time.perf_counter()
    out = fn(*a)
    return out, time.perf_counter() - t0


def _sam_reads(path: Path, dup_pairs: int):
    """pe.sam as Reads (one a run of lines of a QNAME and mate), FLAG
    1024 cleared, with its first dup_pairs pairs repeated at the end
    under new names."""
    from bwa_flow_tpu_torch.io.sam import Read

    groups: list = []
    key = None
    for line in path.read_text().splitlines(True):
        if line.startswith("@"):
            continue
        f = line.split("\t", 2)
        flag = int(f[1])
        k = (f[0], flag & 0xC0)
        if k != key:
            groups.append([f[0], []])
            key = k
        groups[-1][1].append(f"{f[0]}\t{flag & ~0x400}\t{f[2]}")
    reads = [(n, "".join(ls)) for n, ls in groups]
    for n, sam in reads[:2 * dup_pairs]:
        reads.append((f"dup_{n}", "".join(f"dup_{l}" for l in
                                          sam.splitlines(True))))
    return [Read(name=n, seq=np.zeros(0, np.uint8), sam=s)
            for n, s in reads]


def phase_host_libraries(work: Path, genome: np.ndarray,
                         device: str) -> dict:
    """Each host library of this slice against its Python version, or
    known answers, on the card's host, each timed: (a) SA-IS, (b)
    ksw_extend2/ksw_global2, (c) markdup, (d) the BAM encoder (bucket
    writes, merge) and a malformed line, (e) SA re-sampling at load and
    the LF walk over its table."""
    import copy
    import gzip

    from bwa_flow_tpu_torch import _build
    from bwa_flow_tpu_torch.dedup import markdup
    from bwa_flow_tpu_torch.index import build, io as idx_io
    from bwa_flow_tpu_torch.index.suffix import suffix_array
    from bwa_flow_tpu_torch.io import bam
    from bwa_flow_tpu_torch.ops import fm_cuda, ksw, smem_torch
    from bwa_flow_tpu_torch.pipeline import sort
    from bwa_flow_tpu_torch.utils.opts import MemOpt

    res: dict = {}
    # (a) SA-IS against prefix doubling
    fwd = genome[:P11_SA_LEN].astype(np.uint8)
    both = np.concatenate([fwd, (3 - fwd)[::-1]])
    got, t_nat = _timed(build.suffix_array_sais, both)
    want, t_py = _timed(suffix_array, both)
    if not np.array_equal(got, want):
        raise SystemExit("phase 11 (a): SA-IS differs from suffix_array")
    t_cases = [0.0, 0.0]
    for seq in _sais_cases():
        g, tn = _timed(build.suffix_array_sais, seq)
        w, tp = _timed(suffix_array, seq)
        t_cases[0] += tn
        t_cases[1] += tp
        if not np.array_equal(g, w):
            raise SystemExit(f"phase 11 (a): SA-IS differs on an "
                             f"adversarial text of {len(seq)} symbols")
    res["sais"] = dict(symbols=len(both), native_s=t_nat, python_s=t_py,
                       cases_native_s=t_cases[0], cases_python_s=t_cases[1])
    print(f"[p11] (a) SA-IS == suffix_array on both strands of "
          f"{P11_SA_LEN} bp ({len(both)} symbols): native {t_nat:.3f} s, "
          f"prefix doubling {t_py:.3f} s; the 10 adversarial texts: "
          f"{t_cases[0]:.4f} s against {t_cases[1]:.3f} s")

    # (b) ksw_extend2 and ksw_global2 against their NumPy versions
    opt = MemOpt()
    q, ql, t, tl, h0 = make_ext_tasks(np.random.default_rng(0x11B), genome,
                                      P11_TASKS)
    tasks = [(int(ql[i]), q[i, :ql[i]].astype(np.uint8), int(tl[i]),
              t[i, :tl[i]].astype(np.uint8), int(h0[i]))
             for i in range(P11_TASKS) if ql[i] > 0]
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)

    def ext(fn):
        return [fn(a, qa, b, ta, opt.mat, *sc, opt.w, opt.pen_clip5,
                   opt.zdrop, h) for a, qa, b, ta, h in tasks]

    def glob(fn):     # the query against the window's first qlen + 5 bp
        return [fn(a, qa, min(b, a + 5), ta, opt.mat, *sc, opt.w, True)
                for a, qa, b, ta, _ in tasks if b > 0]
    for name, run, nat, py in (
            ("ksw_extend2", ext, ksw.ksw_extend2, ksw.ksw_extend2_py),
            ("ksw_global2", glob, ksw.ksw_global2, ksw.ksw_global2_py)):
        g, tn = _timed(run, nat)
        w, tp = _timed(run, py)
        if g != w:
            bad = sum(a != b for a, b in zip(g, w))
            raise SystemExit(f"phase 11 (b): {name} differs from its "
                             f"NumPy version on {bad} of {len(g)} tasks")
        res[name] = dict(tasks=len(g), native_s=tn, python_s=tp)
        print(f"[p11] (b) {name} == {name}_py on {len(g)} tasks: native "
              f"{tn:.4f} s, NumPy {tp:.3f} s")

    # (c) markdup against known answers: pe.sam, then pe.sam with its
    # first P11_DUP_PAIRS pairs repeated under new names. A repeated pair
    # has its original's signature, so it is a duplicate exactly when
    # its original has one: when a mate of it is mapped
    reads = _sam_reads(work / "pe.sam", P11_DUP_PAIRS)
    n0 = len(reads) - 2 * P11_DUP_PAIRS
    fm = idx_io.load_index(str(work / "ref.fa"))
    outs = []
    for rs in (copy.deepcopy(reads[:n0]), copy.deepcopy(reads)):
        stage = markdup.make_markdup_stage(fm, ignore_unmated=True)
        t0 = time.perf_counter()
        for i in range(0, len(rs), BATCH):
            stage.process(rs[i:i + BATCH])
        outs.append((rs, stage.state.dup_count, time.perf_counter() - t0,
                     type(stage).__name__))
    (plain, p_dup, _, _), (rs, n_dup, n_s, n_cls) = outs

    def flags(r):
        return [int(l.split("\t")[1]) for l in r.sam.splitlines()]

    def primary_mapped(r):
        return any(not f & 0x904 for f in flags(r))
    copies = rs[n0:]
    want_dup = [primary_mapped(a) or primary_mapped(b)
                for a, b in zip(copies[0::2], copies[1::2])]
    got_dup = [[all(f & 0x400 for f in flags(r)) for r in (a, b)]
               for a, b in zip(copies[0::2], copies[1::2])]
    any_dup = [[any(f & 0x400 for f in flags(r)) for r in (a, b)]
               for a, b in zip(copies[0::2], copies[1::2])]
    print(f"[p11] (c) markdup of {len(reads)} reads ({P11_DUP_PAIRS} "
          f"pairs repeated): {n_cls} {n_dup} duplicate blocks in "
          f"{n_s:.4f} s, {p_dup} without the repeats; "
          f"{sum(want_dup)} repeats with a mapped mate")
    if [r.sam for r in rs[:n0]] != [r.sam for r in plain] \
            or got_dup != [[w, w] for w in want_dup] \
            or any_dup != got_dup or n_dup != p_dup + sum(want_dup) \
            or n_dup < P11_DUP_PAIRS:
        raise SystemExit("phase 11 (c): the repeated pairs' marks or the "
                         "counts are not the known answer, or fewer than "
                         f"{P11_DUP_PAIRS} duplicates")
    res["markdup"] = dict(reads=len(reads), dup_count=n_dup, native_s=n_s)

    # (d) bucket writes and merge through the _bam encoder
    anns = fm.bns.anns
    hdr = "@HD\tVN:1.6\tSO:coordinate\n"
    sams = [r.sam for r in reads[:n0]]
    tmp = work / "p11_buckets"
    bs = sort.BucketSort(anns, str(tmp), 512)
    t0 = time.perf_counter()
    for s in sams:        # one call a read, as the CLI's emit does
        bs.write_sam_text(s)
    t_write = time.perf_counter() - t0
    paths = bs.close()
    out = work / "p11.bam"
    t0 = time.perf_counter()
    sort.merge_sorted_bam(paths, str(out), anns, hdr)
    t_merge = time.perf_counter() - t0
    shutil.rmtree(tmp)
    res["bam_native"] = dict(write_s=t_write, merge_s=t_merge)
    text, _, recs = bam.decode_bam_records(gzip.decompress(
        out.read_bytes()))
    keys = [sort.sort_key_from_raw(r["raw"]) for r in recs]
    print(f"[p11] (d) {len(sams)} reads of pe.sam into 512 buckets and "
          f"merged: _bam writes {t_write:.3f} s, merge {t_merge:.3f} s "
          f"(zlib {_build.host_module('_bam').zlib_version()} linked)")
    if text != hdr or any(a > b for a, b in zip(keys, keys[1:])):
        raise SystemExit("phase 11 (d): the merged BAM's header differs, "
                         "or its sort keys decrease")
    bam_fields_check("phase 11 (d)", recs,
                     [l.split("\t") for s in sams for l in s.splitlines()],
                     anns)
    script = work / "malformed_sam.py"
    script.write_text(_MALFORMED_SCRIPT)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       timeout=300)
    print(f"[p11] (d) malformed SAM line to _bam.sam_to_bam in a "
          f"subprocess: exit {r.returncode}, {r.stdout.strip()!r}")
    if r.returncode != 1 or not r.stdout.startswith("ValueError"):
        raise SystemExit(f"phase 11 (d): the malformed line gave exit "
                         f"{r.returncode}: {r.stdout} {r.stderr[-2000:]}")

    # (e) SA re-sampling at load, then the LF walk over its table
    ref = str(work / "ref.fa")
    contigs = build.parse_fasta(ref)
    _, gfwd = build.encode_reference(contigs)
    full = build.suffix_array_sais(np.concatenate([gfwd, (3 - gfwd)[::-1]]))
    cache = Path(f"{ref}.tpu.sa4.npy")
    idx_io.RESAMPLE_MIN = 0
    os.environ["BWA_TPU_DENSE_SA_MAX"] = "0"
    try:
        fm4, t_load = _timed(idx_io.load_index, ref)
        want = full[::4].copy()
        want[0] = -1
        if fm4.sa_intv != 4 or not np.array_equal(np.asarray(fm4.sa), want):
            raise SystemExit(f"phase 11 (e): sa_intv {fm4.sa_intv}, or the "
                             "table is not every 4th entry of the SA")
        print(f"[p11] (e) load_index with RESAMPLE_MIN = 0: sa_intv 32 -> "
              f"4 in {t_load:.3f} s (os.cpu_count() {os.cpu_count()} "
              f"threads), table == SA[::4] ({len(want)} entries)")
        fq = str(work / "p9_reads.fq")
        fm_cuda.n_launches["sa_walk"] = 0
        with recorded_sa_batch() as calls, \
                _recording(smem_torch, "sa_batch",
                           lambda a: int(a[0].sa_intv)) as intvs, \
                plain_walk_calls() as plain:
            run = _cli_run("(e) resampled SA, LF walk", [
                "-t", "8", "--batch-reads", str(BATCH), "--device", device,
                "-o", str(work / "p11_resampled.sam"), ref, fq], "p11")
    finally:
        idx_io.RESAMPLE_MIN = 1 << 28
        del os.environ["BWA_TPU_DENSE_SA_MAX"]
        cache.unlink(missing_ok=True)
    walk_launches = fm_cuda.n_launches["sa_walk"]
    walk_launch_check("p11 (e)", walk_launches, calls, plain)
    checked = walk_calls_check("p11 (e)", calls)
    del calls
    if set(intvs) != {4}:
        raise SystemExit(f"phase 11 (e): the LF walks ran at intervals "
                         f"{set(intvs)}, not 4")
    if _body(work / "p11_resampled.sam") != _body(work / "p9_default.sam"):
        raise SystemExit("phase 11 (e): the resampled run's SAM differs "
                         "from phase 9's default run")
    print(f"[p11] (e) {P9_READS} reads on the LF walk over the resampled "
          f"table ({len(intvs)} walks): SAM == phase 9's default run")
    res["resample"] = dict(load_s=t_load, walks=len(intvs),
                           mem_s=run["wall_s"], walk_launches=walk_launches,
                           walk_calls=checked)
    return res


# ----------------------------------------------------------- phase 12

SEED_L = 160        # BatchAligner's smem_L: the seed machines' read length
SEED_B = 4096       # reads of a main-path seed batch
SEED_REPS = 5       # timed launches of each seed kernel
LONG_READS = 256    # reads of phase 12's long-read batch ...
LONG_LEN = 700      # ... of this length ...
LONG_L = 720        # ... padded to this smem_L (above P1P3_MAX_L)
LONG_SEED = 0x10E6
# the seed kernels: name -> (wrapper in smem_torch, its plain version,
# the JAX loop it replaces)
SEED_KERNELS = {
    "seed_p1p3": ("p1p3_machine", "_p1p3_machine",
                  "bwa_flow_tpu/ops/smem_jax.py:400"),
    "seed_fwd": ("fwd_scan_machine", "_fwd_scan_machine",
                 "bwa_flow_tpu/ops/smem_jax.py:350"),
    "seed_bwd": ("bwd_walk_machine", "_bwd_walk_machine",
                 "bwa_flow_tpu/ops/smem_jax.py:505"),
    "seed_cohort": ("cohort_emit", "_cohort_emit",
                    "bwa_flow_tpu/ops/smem_jax.py:539"),
}
# the seed kernels redesigned for Hopper beyond one thread a lane: what
# the design changed
REDESIGNED = {
    "seed_p1p3": "four threads a lane, the lane's symbols staged in shared "
                 "memory (reads from global memory above smem_L 511), the "
                 "one-symbol FM probe, blocks over every SM",
    "seed_fwd": "four threads a lane, the one-symbol FM probe, the next "
                "read symbol loaded beside the rows, lanes dealt to the "
                "blocks in turn so the live prefix reaches every SM",
    "seed_bwd": "the one-symbol FM probe, the next read symbol loaded "
                "beside the rows",
    "seed_cohort": "blocks of 32 rows, each row's slots in chunks of 32 "
                   "loaded with coalesced reads and staged in shared "
                   "memory, one thread's scan a row, coalesced stores",
}
# a machine state's flat stores end in a drop-sentinel slot: a sink for
# the plain version's dropped scatters, not an output
SENTINEL_KEYS = ("brk_kls", "brk_meta", "mems")


def _clone(x):
    """A deep copy of a wrapper's arguments (tensors cloned on their
    device; the index, ints and callables shared)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def _outputs(out) -> list:
    """Every output array of a seed wrapper's result in a fixed order: a
    machine state by key, without its stores' sentinel slot."""
    if isinstance(out, dict):
        return [out[k][:-1] if k in SENTINEL_KEYS else out[k]
                for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _outputs(o)]
    return [out]


@contextlib.contextmanager
def captured_seed_calls():
    """While the block runs, every call of a seed wrapper in smem_torch
    is recorded with a copy of its arguments; yields name -> [args]. The
    wrappers run unchanged inside."""
    from bwa_flow_tpu_torch.ops import smem_torch
    log = {name: [] for name in SEED_KERNELS}
    saved = {}
    for name, (wrapper, _, _) in SEED_KERNELS.items():
        saved[wrapper] = fn = getattr(smem_torch, wrapper)

        def rec(*a, _fn=fn, _log=log[name]):
            _log.append(_clone(a))
            return _fn(*a)
        setattr(smem_torch, wrapper, rec)
    try:
        yield log
    finally:
        for wrapper, fn in saved.items():
            setattr(smem_torch, wrapper, fn)


@contextlib.contextmanager
def plain_seed_calls():
    """While the block runs, count the calls of the seed kernels' plain
    versions (the main path on the card must make none); yields name ->
    count."""
    from bwa_flow_tpu_torch.ops import smem_torch
    counts = dict.fromkeys(SEED_KERNELS, 0)
    saved = {}
    for name, (_, plain, _) in SEED_KERNELS.items():
        saved[plain] = fn = getattr(smem_torch, plain)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        setattr(smem_torch, plain, counted)
    try:
        yield counts
    finally:
        for plain, fn in saved.items():
            setattr(smem_torch, plain, fn)


def seed_launch_check(tag: str, launches: dict, plain: dict) -> None:
    """Raise unless every seed kernel launched in a main-path run and no
    plain seed machine ran there."""
    print(f"[{tag}] seed kernel launches {launches}; plain seed "
          f"versions called {plain}")
    if any(v <= 0 for v in launches.values()) or any(plain.values()):
        raise SystemExit(f"{tag}: a seed kernel did not launch "
                         f"({launches}), or a plain seed version ran "
                         f"({plain})")


def enqueue_summary(st: dict) -> str:
    """How a run's next batches were enqueued (BatchAligner.stats): by
    which hook of AlignPipeline.run, and how often the adaptive
    downgrade took over."""
    hooks = ", ".join(f"{h} {st[f'enqueue_{h}']}" for h in (
        "post_redo", "post_dispatch", "late"))
    return (f"next batch's seed program enqueued by: {hooks}; adaptive "
            f"downgrade fired on {st['seed_downgrades']} batches")


@contextlib.contextmanager
def counted_steps():
    """While the block runs, the plain seed machines count their lanes'
    steps on the card: "sym", a live lane's symbol gather (pivot
    acquisition and pass 1/3 steps), and "probe", a lane in mode 1 that
    probes the index (two FM rows); yields the lists of 0-d counts, and
    under "lanes" each step function's probes a lane (int32[lanes],
    summed over the steps)."""
    import torch

    from bwa_flow_tpu_torch.ops import smem_torch
    acc = {"sym": [], "probe": [], "lanes": {}}
    saved = {}
    for fname, key, mode_test in (
            ("_fwd_pre2", "sym", lambda m: m != 3),
            ("_p3_pre2", "sym", lambda m: m != 3),
            ("_fwd_post", "probe", lambda m: m == 1),
            ("_p3_post", "probe", lambda m: m == 1)):
        saved[fname] = fn = getattr(smem_torch, fname)
        argi = 3 if fname.endswith("pre2") else None

        def counted(*a, _fn=fn, _key=key, _test=mode_test, _i=argi,
                    _name=fname):
            s = a[_i] if _i is not None else a[-3]
            hit = _test(s["mode"])
            acc[_key].append(hit.sum())
            if _key == "probe":
                lanes = acc["lanes"]
                lanes[_name] = lanes.get(_name, 0) + hit.to(torch.int32)
            return _fn(*a)
        setattr(smem_torch, fname, counted)
    try:
        yield acc
    finally:
        for fname, fn in saved.items():
            setattr(smem_torch, fname, fn)


# int32 operations of one index probe: the row of one symbol c of
# bwt_extend, which is all the seed machines take from a probe (the
# one-symbol probe of csrc/seed_fm.cuh), at the fewest Hopper
# instructions. Per probe row, for each of its 4 words: the count of c
# (a three-input logic op (xnor with c's pattern), a shift, a logic op
# (pair, mask and keep), a popcount and an add: 5) and the count of the
# symbols above c (a shift, a logic op picking the pairs above c, a
# logic op with the keep mask, a popcount and an add: 5); 4 keep masks
# of 2 ops (a max and a clamping funnel shift); 8 to clamp the
# coordinate and split it into row and offset. Then 16 to pick c's
# counts and L2 entry and derive the interval: 2 x (40 + 8 + 8) + 16.
OPS_PER_PROBE = 128
# ... and of one slot of cohort emission: 3 loads' compares and
# selects, a min and a store
OPS_PER_SLOT = 8


def _seed_bound(name: str, args: list, acc: dict, want) -> dict:
    """The least time of a seed kernel's work on these inputs, counted
    as _bound counts a kernel's: the larger of the bytes it must move
    through HBM over HBM's rate (each input read once: the index's FM
    rows, the symbol table or reads, each lane's inputs and state; each
    output written once: each lane's state, the stores it writes) and
    its operations over the int32 rate (OPS_PER_PROBE a probe,
    OPS_PER_SLOT a cohort slot). A lane's repeated gathers of FM rows
    are hits in the 50 MB L2 that holds the index, so they count in the
    operations, not the bytes. Steps are counted on the plain run
    (counted_steps) or, for the backward walk, from its results; the
    longest lane's probes (None for cohort emission) are returned
    beside the bound, for the chain floor."""
    nbytes, ops, longest = _seed_work(name, args, acc, want)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / INT32_OPS * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                longest_lane_probes=longest)


def _seed_work(name: str, args: list, acc: dict, want) -> tuple:
    """(HBM bytes, int32 operations, the longest lane's probes) of a seed
    kernel's call (_seed_bound)."""
    import torch
    tot = (lambda xs: int(torch.stack(xs).sum()) if xs else 0)
    if name == "seed_cohort":
        r = args[0]
        return r.numel() * (4 + 4 + 1 + 4), r.numel() * OPS_PER_SLOT, None
    index = (args[0].fm_blocks.numel() * 4
             + args[0].L2.numel() * args[0].L2.element_size())
    if name == "seed_bwd":
        q_flat, read_id, bst0, i_b0, _mi, alive0 = args[2:8]
        L = args[1]
        t = bst0.element_size()
        r = want[0].cpu().long()
        ib0 = i_b0.cpu().long()
        total = int(alive0.sum())
        r, ib0 = r[:total], ib0[:total]
        rid = read_id.cpu().long()[:total]
        q = q_flat.cpu().long()
        died_valid = (r >= 0) & (q[rid * L + r.clamp(0, L - 1)] < 4)
        lane = ib0 - r + died_valid.long()
        M = i_b0.numel()
        # per queue entry: read id, i_b0, bst0 and mi in; r and bst out
        return (index + q_flat.numel() * 4 + M * (4 + 4 + 4 * t + 4 + 3 * t),
                int(lane.sum()) * OPS_PER_PROBE,
                int(lane.max()) if total else 0)
    probes = tot(acc["probe"])
    longest = max((int(v.max()) for v in acc["lanes"].values()
                   if isinstance(v, torch.Tensor) and v.numel()), default=0)
    if name == "seed_fwd":
        s0, q_flat = args[8], args[4]
        nl = s0["mode"].numel()
        # the reads, and per lane read id, qlen and mi
        inputs = q_flat.numel() * 4 + nl * (4 + 4 + s0["ik"].element_size())
    else:
        s0 = args[6]
        nl = s0["mode"].numel()
        # the symbol table (2 int32 a lane and position), and per lane
        # read id and the two qlens
        inputs = 2 * nl * args[1] * 4 + nl * (4 + 4 + 4)
    t = s0["ik"].element_size()
    state = 2 * nl * (6 * 4 + 3 * t + 1)
    nb = int(want[0]["nb"].sum()) if name == "seed_p1p3" else \
        int(want["nb"].sum())
    writes = nb * (3 * t + 3 * 4)
    if name == "seed_p1p3":
        s3 = args[12]
        t3 = s3["ik"].element_size()
        state += 2 * nl * (4 * 4 + 3 * t3 + 1)
        writes += int(want[1][1].sum()) * 4 * t3
    return (index + inputs + state + writes, probes * OPS_PER_PROBE,
            longest)


# a single thread's chain of dependent loads through the read-only cache
# over a random cyclic permutation of 32-byte sectors (one FM row each):
# the card's latency of a dependent load, the wall a lane's chain of FM
# row gathers stands against (an L2 hit over a buffer the L2 holds, an
# HBM read over a larger one); and a kernel that does nothing, whose
# launches measure what a launch itself costs on the card
CHASE_CU = r"""
#include <cuda_runtime.h>
__global__ void chase(const unsigned* __restrict__ next, long long hops,
                      unsigned* out) {
  unsigned p = 0;
  for (long long h = 0; h < hops; ++h) p = __ldg(next + p);
  *out = p;
}
__global__ void empty_kernel() {}
extern "C" int chase_launch(const void* next, long long hops, void* out,
                            void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const unsigned*)next, hops,
                                           (unsigned*)out);
  return (int)cudaGetLastError();
}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
CHASE_HOPS = 200_000
CHASE_SEED = 0xC4A5E
_CHASE: dict = {}


def _chase_lib():
    """CHASE_CU built with the kernels' nvcc flags (once a run) and
    loaded."""
    import ctypes

    from bwa_flow_tpu_torch import _build
    if "lib" not in _CHASE:
        src, lib = WORK / "chase.cu", WORK / "libchase.so"
        src.write_text(CHASE_CU)
        r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib), str(src)], capture_output=True,
                           text=True, timeout=300)
        if r.returncode != 0:
            raise SystemExit(f"nvcc failed for the pointer chase:\n"
                             f"{r.stdout}{r.stderr}")
        cdll = ctypes.CDLL(str(lib))
        cdll.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p, ctypes.c_void_p]
        cdll.chase_launch.restype = ctypes.c_int
        cdll.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
        cdll.empty_launch.restype = ctypes.c_int
        _CHASE["lib"] = cdll
    return _CHASE["lib"]


def l2_latency_ns(nbytes: int, device, tag: str = "p12") -> dict:
    """ns a dependent load over a buffer of nbytes (the index's size):
    CHASE_CU's chase, one pass over every sector first (the buffer warm
    in the L2 where it fits), then CHASE_HOPS hops timed with CUDA
    events."""
    import torch

    fn = _chase_lib().chase_launch
    n = max(2, nbytes // 32)
    order = np.random.default_rng(CHASE_SEED).permutation(n)
    nxt = np.zeros(n * 8, np.int32)
    nxt[order * 8] = np.roll(order, -1) * 8
    buf = torch.from_numpy(nxt).to(device)
    out = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run(hops):
        if fn(buf.data_ptr(), hops, out.data_ptr(), stream) != 0:
            raise SystemExit("the pointer chase did not launch")
    run(n)                                   # every sector once
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run(CHASE_HOPS)
    b.record()
    torch.cuda.synchronize()
    ns = a.elapsed_time(b) * 1e6 / CHASE_HOPS
    where = "L2 hit" if n * 32 <= L2_BYTES else "load beyond the L2"
    print(f"[{tag}] dependent {where} latency: {ns:.1f} ns a load "
          f"({CHASE_HOPS} hops of one thread over {n} random 32-byte "
          f"sectors, {n * 32} bytes, after one pass over all)")
    return dict(ns=ns, bytes=n * 32, hops=CHASE_HOPS)


def _launcher(name: str, args: tuple, n: int):
    """A call of the seed kernel's launcher (ops/smem_cuda.py) on inputs
    that the wrapper's args give, prepared here as the wrapper prepares
    them, so that a timing holds the kernel and the launcher's checks,
    not the wrapper's copies and casts. The machines update their state
    in place, so each of the n + 2 calls of _time_ms takes a fresh copy
    of it, made here."""
    import torch

    from bwa_flow_tpu_torch.ops import smem_cuda as sc
    from bwa_flow_tpu_torch.ops import smem_torch as st
    i32 = torch.int32
    if name == "seed_p1p3":
        (dfm, L, NB, ITERS, read_id, qlen_l, st1, q2, qlen2, NP3, msl,
         mmi, st3, _) = args
        fixed = (dfm, L, NB, ITERS, NP3, msl, mmi, st._sym_tab(q2, qlen2, L),
                 read_id.to(i32).contiguous(), qlen_l.to(i32).contiguous(),
                 qlen2.to(i32).contiguous())
        states = [(st._copies(st1), st._copies(st3)) for _ in range(n + 2)]
        return lambda: sc.p1p3(*fixed, *states.pop())
    if name == "seed_fwd":
        dfm, L, NB, ITERS, q_flat, read_id, qlen_l, mi, st0, _ = args
        fixed = (dfm, L, NB, ITERS, q_flat.contiguous(),
                 read_id.to(i32).contiguous(), qlen_l.to(i32).contiguous(),
                 mi.contiguous())
        states = [st._copies(st0) for _ in range(n + 2)]
        return lambda: sc.fwd_scan(*fixed, states.pop())
    if name == "seed_bwd":
        dfm, L, q_flat, read_id, bst0, i_b0, mi, alive0, CS, _ = args
        M = i_b0.shape[0]
        fixed = (dfm, L, st._bwd_budget(M, L, st._bwd_lanes(CS, M)),
                 q_flat.contiguous(), read_id.to(i32).contiguous(),
                 bst0.contiguous(), i_b0.to(i32).contiguous(),
                 mi.contiguous(), alive0.to(i32).sum(dtype=i32))
        return lambda: sc.bwd_walk(*fixed)
    r, brk_g, valid, _ = args
    fixed = (r.to(i32).contiguous(),
             brk_g if brk_g.stride(1) == 1 else brk_g.contiguous(),
             valid.contiguous())
    return lambda: sc.cohort_emit(*fixed)


def _seed_batch(tag: str, dfm, q, qlen, MAXM: int, kw: dict,
                timed: bool, lat_ns: float | None = None,
                L: int = SEED_L) -> dict:
    """collect_intv_device on one batch of reads padded to L on the card:
    the whole program on the kernels against the same program on the
    plain versions, then each kernel call of the program against its
    plain version on the same inputs (every output array, tolerance 0:
    all values are integers); with timed, each kernel and plain version
    timed with CUDA events, the kernel's bound and, given the dependent
    L2-hit latency lat_ns, its chain floor: the longest lane's probes
    times lat_ns. Each call of a scan machine records its probes (mode-1
    steps, counted on the plain run), seed_fwd's also its live lanes.
    Returns name -> [per-call record]."""
    import torch

    from bwa_flow_tpu_torch.ops import smem_torch as st
    from bwa_flow_tpu_torch.utils.opts import MemOpt

    params = st._opt_params(MemOpt())

    def program():
        return st.collect_intv_device(dfm, L, 64, MAXM, L * 16, q, qlen,
                                      *params, **kw)
    with captured_seed_calls() as log:
        got = program()
    torch.cuda.synchronize()
    real = st._on_card
    st._on_card = lambda t, who: False      # the plain versions, on the card
    try:
        want = program()
    finally:
        st._on_card = real
    err, bad = _diff(got, want)
    print(f"[p12] {tag}: B={q.shape[0]}, L={L}, {q.dtype} reads, coordinates "
          f"{dfm.L2.dtype}, {kw}: the seed program on the kernels vs on "
          f"the plain versions: {len(got)} outputs, mismatching values "
          f"{bad}, max |err| {err}")
    if bad:
        raise SystemExit(f"phase 12 {tag}: the seed program on the kernels "
                         "differs from the plain versions")
    res: dict = {}
    for name, calls in log.items():
        wrapper, plain, _ = SEED_KERNELS[name]
        kern, ref = getattr(st, wrapper), getattr(st, plain)
        for ci, args in enumerate(calls):
            g = kern(*_clone(args))
            with counted_steps() as acc:
                w = ref(*_clone(args))
            torch.cuda.synchronize()
            gl, wl = _outputs(g), _outputs(w)
            e, b = _diff(gl, wl)
            if len(gl) != len(wl):
                e, b = -1, 1
            lanes = {"seed_p1p3": lambda: args[6]["mode"],
                     "seed_fwd": lambda: args[8]["mode"],
                     "seed_bwd": lambda: args[5],
                     "seed_cohort": lambda: args[0]}[name]().shape[0]
            rec = dict(call=ci, outputs=len(gl), max_abs_err=e,
                       lanes=int(lanes))
            if name in ("seed_p1p3", "seed_fwd"):
                rec["probes"] = int(sum(int(v) for v in acc["probe"]))
            if name == "seed_fwd":
                rec["live_lanes"] = int((args[8]["mode"] == 1).sum())
            if timed:
                rec["ms"] = _time_ms(_launcher(name, args, SEED_REPS),
                                     SEED_REPS, fill=True)
                rec["plain_ms"] = _time_ms(lambda: ref(*_clone(args)), 1)
                rec.update(_seed_bound(name, args, acc, w))
                n_chain = rec["longest_lane_probes"]
                rec["chain_floor_ms"] = (
                    None if lat_ns is None or n_chain is None
                    else n_chain * lat_ns * 1e-6)
            live = (f" ({rec['live_lanes']} live)" if "live_lanes" in rec
                    else "")
            probes = (f", {rec['probes']} probes" if "probes" in rec
                      else "")
            print(f"[p12] {tag} {name} call {ci}: {rec['lanes']} lanes{live}"
                  f"{probes}, {len(gl)} output arrays, mismatching values "
                  f"{b}, max |err| {e}" + (
                      f"; kernel {rec['ms']:.4f} ms a launch, plain "
                      f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.5f}"
                      f" ms ({rec['bound_by']}: {rec['bytes']} bytes over "
                      f"3.35 TB/s, {rec['ops']} int32 ops over 16.7e12/s)"
                      f"; longest lane {rec['longest_lane_probes']} probes, "
                      f"chain floor {rec['chain_floor_ms']} ms"
                      if timed else ""))
            if b:
                raise SystemExit(f"phase 12 {tag}: {name} call {ci} "
                                 "differs from its plain version")
            res.setdefault(name, []).append(rec)
    return res


def seeds_dispatch_reads(ba, seqs) -> dict:
    """seeds_dispatch of one batch on the card, with every fetch, wait,
    put and upload of the batch aligner recorded, the start of its seed
    program (smem_torch.seed_dispatch) marked, and torch's sync debug
    mode on ("warn") for the whole dispatch: returns the calls before
    and after the program's start and the synchronising calls torch
    reported. Collects the batch afterwards."""
    import traceback
    import warnings

    import torch

    from bwa_flow_tpu_torch.ops import smem_torch

    seen: list = []
    methods = ("fetch", "wait", "put", "upload")
    for m in methods:
        real_m = getattr(ba, m)

        def logged(*a, _m=m, _real=real_m, **k):
            seen.append(_m)
            return _real(*a, **k)
        setattr(ba, m, logged)
    real_dispatch = smem_torch.seed_dispatch

    def marked(*a, **k):
        seen.append("program")
        return real_dispatch(*a, **k)
    syncs: list = []

    def show(message, category, filename, lineno, *rest):
        # each synchronising call, with the program's frames that made it
        # (not the mode's one-time prototype notice)
        if "called a synchronizing CUDA operation" in str(message):
            frames = [f"{f.filename.split('/')[-1]}:{f.lineno}"
                      for f in traceback.extract_stack()[:-1]
                      if "bwa_flow_tpu_torch" in f.filename]
            syncs.append(f"{filename}:{lineno} via {frames[-3:]}")
    smem_torch.seed_dispatch = marked
    shown = warnings.showwarning
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                h = ba.seeds_dispatch(seqs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                warnings.showwarning = shown
    finally:
        smem_torch.seed_dispatch = real_dispatch
        for m in methods:
            delattr(ba, m)
    ba.seeds_collect(h)
    i = seen.index("program") if "program" in seen else len(seen)
    return dict(before=seen[:i], after=seen[i + 1:], syncs=syncs)


def phase_seed_kernels(work: Path, genome: np.ndarray, device: str) -> dict:
    """The four seed kernels against their plain versions on the card at
    the main path's shapes and on long reads (smem_L above the int16
    stage's limit), and the seed dispatch's device reads; returns name ->
    numbers."""
    import itertools

    from bwa_flow_tpu_torch.index.io import load_index
    from bwa_flow_tpu_torch.io.fastq import read_batches
    from bwa_flow_tpu_torch.ops import smem_torch
    from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
    from bwa_flow_tpu_torch.utils.opts import MemOpt

    fm = load_index(str(work / "ref.fa"))
    ba = BatchAligner(MemOpt(), fm, smem_L=SEED_L, device=device)
    se = [r.seq for r in itertools.islice(itertools.chain.from_iterable(
        read_batches(work / "reads.fq")), SEED_B)]
    pe = [r.seq for r in itertools.islice(itertools.chain.from_iterable(
        read_batches(work / "r1.fq", work / "r2.fq")), SEED_B // 2 * 2)]

    def batch(reads, L=SEED_L):
        q, qlen = smem_torch.pad_reads(reads, L)
        return (ba.put(q, ba.device), ba.put(qlen, ba.device))
    narrow, wide = ba.dfm.narrow(), ba.dfm
    lat = l2_latency_ns(wide.fm_blocks.numel() * 4, wide.fm_blocks.device)
    out: dict = {}
    for tag, dfm, reads, MAXM, kw, timed in (
            ("se", narrow, se, 128, dict(pack_H=32), True),
            ("pe", narrow, pe, 128, dict(pack_H=32), True),
            ("wide", wide, se, 128, {}, False),
            ("big", narrow, se[:smem_torch.REDO_B], 256, dict(big=True),
             False),
            ("p2x4", narrow, se, 128, dict(pack_H=32, p2x=4), False)):
        out[tag] = _seed_batch(tag, dfm, *batch(reads), MAXM, kw, timed,
                               lat["ns"])
    # reads longer than the int16 stage of seed_p1p3 holds
    out["long"] = _seed_batch(
        "long", narrow, *batch(cut_reads(genome, LONG_READS, LONG_LEN,
                                         LONG_SEED), LONG_L),
        128, {}, True, lat["ns"], L=LONG_L)

    reads = seeds_dispatch_reads(ba, se)
    print(f"[p12] seeds_dispatch of {len(se)} reads on the dense-SA path: "
          f"{reads['before']} before the seed program, {reads['after']} "
          f"after it; synchronising calls in the dispatch "
          f"{len(reads['syncs'])} {reads['syncs'][:3]}")
    waits = [m for m in reads["before"] + reads["after"] if m != "upload"]
    if waits or reads["syncs"] or "upload" not in reads["before"]:
        raise SystemExit("phase 12: seeds_dispatch waited for the card or "
                         "read it")
    res = {}
    for name in SEED_KERNELS:
        calls = out["se"][name]
        n = len(calls)
        res[name] = dict(
            max_abs_err=max(c["max_abs_err"] for t in out.values()
                            for c in t[name]),
            ms=sum(c["ms"] for c in calls) / n,
            plain_ms=sum(c["plain_ms"] for c in calls) / n,
            bound_ms=sum(c["bound_ms"] for c in calls) / n,
            bound_by=max(calls, key=lambda c: c["bound_ms"])["bound_by"],
            chain_floor_ms=(None if calls[0]["chain_floor_ms"] is None else
                            sum(c["chain_floor_ms"] for c in calls) / n),
            longest_lane_probes=[c["longest_lane_probes"] for c in calls],
            launches_a_batch=n, calls={t: v[name] for t, v in out.items()})
        print(f"[p12] {name} at the SE batch (B={SEED_B}): {n} launches a "
              f"batch, kernel {res[name]['ms']:.4f} ms a launch, plain "
              f"{res[name]['plain_ms']:.3f} ms, bound "
              f"{res[name]['bound_ms']:.5f} ms ({res[name]['bound_by']}), "
              f"chain floor {res[name]['chain_floor_ms']} ms")
    res["dispatch_reads"] = reads
    res["l2_latency"] = lat
    return res


# ----------------------------------------------------------- phase 14

BIG_LEN = 143_726_002        # the length of D. melanogaster's dm6 assembly
BIG_MIN_ROWS = 1 << 28       # its BWT must have more rows: no dense SA
BIG_SEED = 0xD06
BIG_READS = 8192             # single-end reads of the large genome ...
BIG_PAIRS = 4096             # ... and FR pairs
BIG_SUB = 256                # reads and pairs held to --no-device
WALK_REPS = 5                # timed runs of each sa_batch call
FLUSH_BYTES = 128 << 20      # written before each timed launch: evicts the L2
HOLD_S = 0.05                # seconds the spin kernel holds the stream
# int32 operations of one LF step: FM::lf (csrc/seed_fm.cuh) and a turn of
# sawalk::walk_queue's loop (csrc/sa_walk.cuh), counted from the code at
# the fewest Hopper instructions, int32 coordinates (the int64 view's
# wider ops count the same, so the bound stays a lower one): the loop's
# test of k & mask, its budget test against the lane's end and the step
# count (4), its branch (1); k's shift past primary (2) and clamp (2);
# the row's index and address (3); the offset in the row (1); the word at
# it, a shift and three compares and selects (7); c, a mask, a
# subtraction, a shift, a shift and a mask (5); L2[c] and the row's count
# of c, three compares and six selects (9); count_row's count of c: c's
# pattern (1), per word an xnor, a shift, two logic ops and a popcount
# (4 x 5) and its keep mask, a subtraction (none for word 0), a max, a
# shift and a funnel shift (15), the four counts summed (2) and their low
# byte (1); the sum (1); the select at primary (2). The loads, and a
# lane's queue work (once a lane, not once a step), are not counted.
OPS_PER_LF = 76


def walk_trace(dfm, k, max_iters: int, intv: int) -> dict:
    """One sa_batch call followed lane by lane (the contract of
    csrc/sa_walk.cuh, on the tensors' device): each phase's pool (every
    lane, then the first B/4 live lanes in lane order, then the first
    B/16 still live), and in each step the rows of the lanes that take
    it. Returns {"rows": a tensor of rows for each step taken, "steps":
    each lane's total steps (int64), "k": each lane's last row}. A
    pool's padding copies of lane 0 (the plain version's) are not
    lanes: they walk lane 0's rows."""
    import torch

    from bwa_flow_tpu_torch.ops import fm_cuda, fm_torch
    mask = dfm.sa_intv - 1
    B = k.numel()
    budgets = fm_cuda.phases(B, max_iters, intv)
    caps = (B // 4, B // 16)
    kk = k.clone()
    steps = torch.zeros(B, dtype=torch.int64, device=k.device)
    pool = torch.ones(B, dtype=torch.bool, device=k.device)
    rows = []
    for ph, T in enumerate(budgets):
        if ph:
            live = (kk & mask) != 0
            rank = torch.cumsum(live, 0) - live.long()
            pool = live & (rank < caps[ph - 1])
        for _ in range(T):
            walking = pool & ((kk & mask) != 0)
            r = kk[walking]
            if not r.numel():
                break
            rows.append(r)
            kk = torch.where(walking, fm_torch._inv_psi_batch(dfm, kk), kk)
            steps += walking
    return dict(rows=rows, steps=steps, k=kk)


def walk_work(k, sa_bytes: int, trace: dict, mask: int, primary: int,
              seq_len: int) -> dict:
    """What one sa_batch call on the walk must do, for its bound: its
    slots (k, their rows), those live on entry and those dead on entry;
    the distinct fm_blocks rows the lanes' chains touch and the distinct
    rows stepped from (trace: walk_trace's), each one LF step (lanes on
    one chain, from one start or once a lane reaches another's row,
    share their steps); every lane's steps and the longest lane's total.
    Bytes: each slot's row read once, its value (8) and overflow flag (1)
    written once, one sampled-SA entry (sa_bytes) read for each lane, 32
    for each distinct block row; operations: OPS_PER_LF a distinct row
    stepped from."""
    import torch
    B = k.numel()
    walking = int(((k & mask) != 0).sum())
    if trace["rows"]:
        rows = torch.cat([r.long() for r in trace["rows"]])
        stepped = int(torch.unique(rows).numel())
        blk = (rows - (rows >= primary).long()).clamp(0, seq_len - 1) >> 6
        blocks = int(torch.unique(blk).numel())
    else:
        stepped = blocks = 0
    return dict(slots=B, walking=walking, dead_on_entry=B - walking,
                blocks=blocks, stepped_rows=stepped,
                steps=int(trace["steps"].sum()),
                longest=int(trace["steps"].max()) if B else 0,
                bytes=B * (k.element_size() + 9 + sa_bytes) + 32 * blocks,
                ops=stepped * OPS_PER_LF)


@contextlib.contextmanager
def recorded_sa_batch():
    """While the block runs, every call of fm_torch.sa_batch, through
    whichever module of the port imported it, is recorded (the module,
    the index, a copy of its rows, max_iters, intv); yields the list.
    sa_batch runs unchanged inside."""
    from bwa_flow_tpu_torch.ops import fm_torch
    real = fm_torch.sa_batch
    owners = [m for name, m in list(sys.modules.items())
              if name.startswith("bwa_flow_tpu_torch")
              and getattr(m, "sa_batch", None) is real]
    log: list = []
    for m in owners:
        def rec(dfm, k, max_iters=256, intv=0, fetch=fm_torch.to_host,
                _name=m.__name__):
            log.append(dict(module=_name.rsplit(".", 1)[-1], dfm=dfm,
                            k=k.clone(), max_iters=max_iters, intv=intv))
            return real(dfm, k, max_iters, intv, fetch)
        m.sa_batch = rec
    try:
        yield log
    finally:
        for m in owners:
            m.sa_batch = real


@contextlib.contextmanager
def plain_walk():
    """While the block runs, the walks take their plain version on the
    card (the comparisons' reference)."""
    from bwa_flow_tpu_torch.ops import fm_torch
    real = fm_torch._on_card
    fm_torch._on_card = lambda t, who: False
    try:
        yield
    finally:
        fm_torch._on_card = real


@contextlib.contextmanager
def plain_walk_calls():
    """While the block runs, count the plain walks that run on a CUDA
    tensor (a main path on the card must make none); yields {"cuda"}."""
    from bwa_flow_tpu_torch.ops import fm_torch
    real = fm_torch._sa_walk_plain
    seen = {"cuda": 0}

    def counted(dfm, k, *a, **kw):
        seen["cuda"] += k.device.type == "cuda"
        return real(dfm, k, *a, **kw)
    fm_torch._sa_walk_plain = counted
    try:
        yield seen
    finally:
        fm_torch._sa_walk_plain = real


def walk_launch_check(tag: str, launches: int, calls: list,
                      plain: dict) -> None:
    """Raise unless the LF-walk kernel launched once for each recorded
    sa_batch call of a run that made some (a call with a dense SA is a
    gather: none there) and no plain walk ran on the card there."""
    walks = sum(c["dfm"].sa_dense is None for c in calls)
    print(f"[{tag}] sa_walk launches {launches} for {walks} sa_batch calls "
          f"on the walk ({len(calls)} in all); plain walks on the card "
          f"{plain['cuda']}")
    if not walks or launches != walks or plain["cuda"]:
        raise SystemExit(f"{tag}: the LF-walk kernel launched {launches} "
                         f"times for {walks} walks, and the plain walk ran "
                         f"{plain['cuda']} times on the card")


def _held_launch_ms(calls: list, flush) -> float:
    """Mean device ms of calls[1:] (calls[0] warms up), each between its
    own pair of CUDA events after flush() has evicted the L2, all queued
    behind a spin kernel that holds the stream while the host enqueues
    them, so the events time the card, not the host."""
    import torch
    calls[0]()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(HOLD_S * SPIN_HZ))
    evs = []
    for fn in calls[1:]:
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / len(evs)


def _call_timing(c: dict, lat_ns: float, flush) -> dict:
    """One recorded sa_batch call (recorded_sa_batch) timed on the card:
    the whole call on the kernel (its outputs' and scratch's allocation
    and zeroing included: what a caller waits for), a launch of the empty
    kernel with the call's grid, and the plain version; beside them the
    bound (walk_work over walk_trace) and the chain floor (the longest
    lane's total steps x lat_ns)."""
    import torch

    from bwa_flow_tpu_torch.ops import fm_cuda, fm_torch
    dfm, k, T, intv = c["dfm"], c["k"], c["max_iters"], c["intv"]
    ms = _held_launch_ms(
        [lambda: fm_torch.sa_batch(dfm, k, T, intv)] * (WALK_REPS + 1),
        flush)
    B = k.numel()
    R = fm_cuda._fn()[1]              # slots, and threads, a block
    empty = _chase_lib().empty_launch
    stream = torch.cuda.current_stream().cuda_stream
    launch_ms = _held_launch_ms(
        [lambda: empty(-(-B // R), R, stream)] * (WALK_REPS + 1), flush)
    plain_ms = _time_ms(lambda: fm_torch._sa_walk_plain(dfm, k, T, intv), 1)
    mask = dfm.sa_intv - 1
    w = walk_work(k, dfm.sa.element_size(), walk_trace(dfm, k, T, intv),
                  mask, dfm.primary, dfm.seq_len)
    t_bytes = w["bytes"] / HBM_BPS * 1e3
    t_ops = w["ops"] / INT32_OPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, launch_ms=launch_ms,
                grid=-(-B // R), **w, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                chain_floor_ms=w["longest"] * lat_ns * 1e-6)


def walk_calls_check(tag: str, calls: list, timed: bool = False,
                     lat_ns: float = 0.0, flush=None) -> list:
    """Each recorded sa_batch call (recorded_sa_batch) on the walk run
    again on its inputs: on the kernel, which must launch once, and on
    the plain version on the card; the values and the overflow flags
    must be equal (tolerance 0: integers). With timed, each call is timed
    (_call_timing), and a call measured below its bound fails the phase.
    Returns a record per call."""
    import torch

    from bwa_flow_tpu_torch.ops import fm_cuda, fm_torch
    out = []
    for ci, c in enumerate(calls):
        if c["dfm"].sa_dense is not None:
            continue
        n0 = fm_cuda.n_launches["sa_walk"]
        got = fm_torch.sa_batch(c["dfm"], c["k"], c["max_iters"], c["intv"])
        launches = fm_cuda.n_launches["sa_walk"] - n0
        want = fm_torch._sa_walk_plain(c["dfm"], c["k"], c["max_iters"],
                                       c["intv"])
        torch.cuda.synchronize()
        err, bad = _diff(list(got), list(want))
        rec = dict(call=ci, module=c["module"], max_abs_err=err,
                   slots=c["k"].numel(), launches=launches,
                   dtype=str(c["k"].dtype).split(".")[-1],
                   max_iters=c["max_iters"], intv=c["intv"],
                   overflow=int(got[1].sum()))
        if timed:
            rec.update(_call_timing(c, lat_ns, flush))
        out.append(rec)
        print(f"[{tag}] call {ci} ({c['module']}, {rec['slots']} rows, "
              f"{rec['dtype']}, intv {c['intv']}, budget {c['max_iters']}):"
              f" {launches} launch, kernel vs plain: mismatching values "
              f"{bad}, overflow {rec['overflow']}" + (
                  f"; {rec['walking']} live on entry, "
                  f"{rec['dead_on_entry']} dead; {rec['grid']} blocks; "
                  f"call {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.5f} "
                  f"ms ({rec['bound_by']}: {rec['bytes']} bytes over 3.35 "
                  f"TB/s with {rec['blocks']} distinct rows, {rec['ops']} "
                  f"int32 ops over 16.7e12/s for {rec['stepped_rows']} "
                  f"distinct rows stepped from of {rec['steps']} steps); "
                  f"longest lane {rec['longest']} steps, chain floor "
                  f"{rec['chain_floor_ms']:.5f} ms; empty launch "
                  f"{rec['launch_ms']:.4f} ms" if timed else ""))
        if timed and rec["ms"] < rec["bound_ms"]:
            raise SystemExit(f"{tag}: an sa_batch call measured "
                             f"{rec['ms']} ms, below its bound "
                             f"{rec['bound_ms']} ms: the bound is wrong")
        if bad or launches != 1:
            raise SystemExit(f"{tag}: sa_batch call {ci} launched the "
                             f"kernel {launches} times, or differs from "
                             f"the plain version on the card ({bad} "
                             f"values, max |err| {err})")
    return out


def _mapping(path: Path, n: int, paired: bool, tag: str) -> dict:
    """One primary record a read, and the shares of reads mapped and (of
    pairs) proper, of a SAM of n reads or pairs."""
    recs = _records(path)
    primary: dict = {}
    mapped = proper = 0
    for f in recs:
        flag = int(f[1])
        if flag & 0x900:
            continue
        key = (f[0], flag & 0xC0)
        primary[key] = primary.get(key, 0) + 1
        mapped += 0 if flag & 0x4 else 1
        proper += 1 if flag & 0x42 == 0x42 else 0
    reads = 2 * n if paired else n
    if len(primary) != reads or any(v != 1 for v in primary.values()):
        raise SystemExit(f"{tag}: not exactly one primary record a read")
    out = dict(records=len(recs), mapped=mapped / reads,
               proper=proper / n if paired else None)
    print(f"[p14] {tag}: {reads} reads, {len(recs)} records, mapped "
          f"{out['mapped']:.4f}" + (f", pairs proper {out['proper']:.4f}"
                                    if paired else ""))
    if out["mapped"] < 0.95 or (paired and out["proper"] < 0.90):
        raise SystemExit(f"{tag}: too few reads mapped or pairs proper "
                         f"({out})")
    return out


def _device_vs_host(tag: str, ref: str, fqs: list, out: Path,
                    device: str) -> int:
    """A subset through the CLI on the card and with --no-device: the
    SAMs must be equal apart from @PG; returns their lines."""
    from bwa_flow_tpu_torch import cli
    dev, host = out.with_suffix(".dev.sam"), out.with_suffix(".host.sam")
    t0 = time.perf_counter()
    assert cli.main(["mem", "--device", device, "-o", str(dev), ref]
                    + fqs) == 0
    t_dev = time.perf_counter() - t0
    assert cli.main(["mem", "--no-device", "-o", str(host), ref] + fqs) == 0
    t_host = time.perf_counter() - t0 - t_dev
    if _body(dev) != _body(host):
        raise SystemExit(f"phase 14: the {tag} device SAM differs from "
                         "--no-device")
    print(f"[p14] {tag}: device SAM == --no-device SAM ({len(_body(dev))} "
          f"lines; device {t_dev:.1f} s, --no-device {t_host:.1f} s)")
    return len(_body(dev))


def densify_check(work: Path, device: str, flush) -> dict:
    """Phase 3's index (under 2^28 rows, so it gets a dense SA) with its
    .tpu.sadense.npy cache not read: _densify_sa on the kernel (one
    launch a sa_batch call), then on the plain version on the card, both
    timed; the two arrays and phase 3's cache must be equal. Each of the
    kernel run's calls is then held to the plain version on the card,
    and its first call and its first deep redo (an unphased call) timed
    (walk_calls_check)."""
    import torch

    from bwa_flow_tpu_torch.index.io import load_index
    from bwa_flow_tpu_torch.ops import fm_cuda, fm_torch

    cache = work / "ref.fa.tpu.sadense.npy"
    if not cache.exists():
        raise SystemExit(f"phase 14: no dense-SA cache {cache} from phase 3")
    fm = load_index(str(work / "ref.fa"))
    fm.cache_prefix = None            # neither read nor write the cache
    dfm = fm_torch.DeviceFM.from_host(fm, device, dense_sa_max=0)
    out = {}
    for tag in ("kernel", "plain"):
        fm_cuda.n_launches["sa_walk"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(recorded_sa_batch())
            if tag == "plain":
                stack.enter_context(plain_walk())
            dense = fm_torch._densify_sa(dfm, fm)
        torch.cuda.synchronize()
        out[tag] = dict(dense=dense, s=time.perf_counter() - t0,
                        launches=fm_cuda.n_launches["sa_walk"], calls=calls)
    want = np.load(cache)
    same = (np.array_equal(out["kernel"]["dense"], out["plain"]["dense"]),
            np.array_equal(out["kernel"]["dense"], want))
    calls = out["kernel"]["calls"]
    print(f"[p14] densify of phase 3's index ({int(fm.seq_len) + 1} rows, "
          f"sa_intv {fm.sa_intv}): kernel {out['kernel']['s']:.3f} s "
          f"({out['kernel']['launches']} launches for {len(calls)} "
          f"sa_batch calls), plain walk on the card "
          f"{out['plain']['s']:.3f} s; kernel == plain {same[0]}, kernel "
          f"== phase 3's cache {same[1]}")
    if not all(same) or out["kernel"]["launches"] != len(calls) \
            or not calls or out["plain"]["launches"]:
        raise SystemExit("phase 14: the dense SA on the kernel differs from "
                         "the plain walk's or phase 3's cache, or the "
                         "walks ran on the wrong version or launched other "
                         "than once a call")
    lat = l2_latency_ns(dfm.fm_blocks.numel() * 4, dfm.device, "p14")
    timed = [0] + [i for i, c in enumerate(calls) if not c["intv"]][:1]
    checked = walk_calls_check("p14 densify", [
        c for i, c in enumerate(calls) if i not in timed])
    checked += walk_calls_check("p14 densify", [calls[i] for i in timed],
                                True, lat["ns"], flush)
    return dict(rows=int(fm.seq_len) + 1, kernel_s=out["kernel"]["s"],
                plain_s=out["plain"]["s"],
                launches=out["kernel"]["launches"], calls=len(calls),
                checked=checked, l2_latency=lat)


def phase_large_genome(work: Path, device: str) -> dict:
    """The densify walk on phase 3's index (densify_check); then a
    genome of BIG_LEN bp, above 2^28 BWT rows: `index` through the CLI
    (SA-IS split out), a load that re-samples the SA 32 -> 4, SE and PE
    runs through the CLI's default route with the seed program's fused
    LF walk on the kernel, each walk of the SE run held to the plain
    walk on the card and timed, resolve_sa_flat on a batch's own
    intervals, and the dispatch check."""
    import io
    import itertools

    import torch

    from bwa_flow_tpu_torch import cli
    from bwa_flow_tpu_torch.index import build
    from bwa_flow_tpu_torch.index.io import load_index
    from bwa_flow_tpu_torch.io.fastq import read_batches
    from bwa_flow_tpu_torch.ops import fm_torch
    from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
    from bwa_flow_tpu_torch.utils.opts import MemOpt

    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                            device=device)
    flush = (lambda: flush_buf.fill_(1))
    res: dict = {"densify": densify_check(work, device, flush)}
    big = work / "large"
    big.mkdir()
    t0 = time.perf_counter()
    genome = make_genome(BIG_LEN, BIG_SEED)
    write_inputs(big, genome, BIG_READS, BIG_SEED + 1, BIG_SUB)
    write_pe_inputs(big, genome, BIG_PAIRS, BIG_SEED + 2, BIG_SUB)
    del genome
    print(f"[p14] genome {BIG_LEN} bp + {BIG_READS} reads + {BIG_PAIRS} "
          f"pairs: {time.perf_counter() - t0:.1f} s")
    ref = str(big / "ref.fa")
    t0 = time.perf_counter()
    with timed_calls(build, "suffix_array_sais") as t_sa:
        assert cli.main(["index", ref]) == 0
    res["index_s"], res["index_sa_s"] = time.perf_counter() - t0, t_sa["s"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        fm, t_load = _timed(load_index, ref)
    said = [l for l in err.getvalue().splitlines() if "resampled SA" in l]
    print(f"[p14] index of {BIG_LEN} bp: {res['index_s']:.1f} s (SA-IS "
          f"{t_sa['s']:.1f} s); seq_len {fm.seq_len}; first load "
          f"{t_load:.1f} s: {said}")
    if fm.seq_len <= BIG_MIN_ROWS or fm.sa_intv != 4 or not said:
        raise SystemExit(f"phase 14: seq_len {fm.seq_len}, sa_intv "
                         f"{fm.sa_intv}: expected above 2^28 and 4")
    res.update(seq_len=int(fm.seq_len), load_s=t_load, resampled=said[0])

    base = ["-t", "8", "--batch-reads", str(BATCH), "--device", device]
    with recorded_sa_batch() as se_calls, plain_walk_calls() as plain:
        se = _native_run("large SE", base + [
            "-o", str(big / "full.sam"), ref, str(big / "reads.fq")],
            n=BIG_READS, phase="p14")
    walk_launch_check("p14 large SE", se["walk_launches"], se_calls, plain)
    res["se"] = se
    res["se_map"] = _mapping(big / "full.sam", BIG_READS, False, "large SE")
    with recorded_sa_batch() as pe_calls, plain_walk_calls() as plain:
        pe = _native_run("large PE", base + [
            "-o", str(big / "pe.sam"), ref, str(big / "r1.fq"),
            str(big / "r2.fq")], n=BIG_PAIRS, phase="p14")
    walk_launch_check("p14 large PE", pe["walk_launches"], pe_calls, plain)
    res["pe_walk"] = walk_calls_check("p14 PE walk", pe_calls)
    del pe_calls
    res["pe"] = pe
    res["pe_map"] = _mapping(big / "pe.sam", BIG_PAIRS, True, "large PE")
    _device_vs_host(f"{BIG_SUB}-read subset", ref, [str(big / "sub.fq")],
                    big / "sub", device)
    _device_vs_host(f"{BIG_SUB}-pair subset", ref,
                    [str(big / "sub1.fq"), str(big / "sub2.fq")],
                    big / "pe_sub", device)

    # the walks of the SE run against the plain walk, timed
    dfm = se_calls[0]["dfm"] if se_calls else None
    if dfm is None or dfm.sa_dense is not None:
        raise SystemExit("phase 14: the SE run made no LF walk")
    lat = l2_latency_ns(dfm.fm_blocks.numel() * 4, dfm.device, "p14")
    print(f"[p14] the SE run's sa_batch calls: "
          f"{[(c['module'], c['k'].numel()) for c in se_calls]}")
    res["seed_walk"] = walk_calls_check(
        "p14 seed walk", [c for c in se_calls
                          if c["module"] == "smem_torch"],
        True, lat["ns"], flush)
    res["other_walks"] = walk_calls_check(
        "p14 probe walks of the SE run",
        [c for c in se_calls if c["module"] != "smem_torch"])
    del se_calls

    # the probe path on a batch's own intervals, every probe walked
    ba = BatchAligner(MemOpt(), fm, smem_L=SEED_L, device=device)
    seqs = [r.seq for r in itertools.islice(itertools.chain.from_iterable(
        read_batches(big / "reads.fq")), BATCH)]
    h = ba.seeds_dispatch(seqs)
    intvs = ba.seeds_collect(h)
    redo0 = ba.stats["sa_host_redo"]
    with recorded_sa_batch() as probe_calls:
        vals, offs, _ = ba.resolve_sa_flat(intvs, None)
    redo = ba.stats["sa_host_redo"] - redo0
    with plain_walk():
        vals_p, offs_p, _ = ba.resolve_sa_flat(intvs, None)
    fused = 0
    same_fused = True
    for r, v in enumerate(h["sa_vals"]):
        if v is not None:
            fused += len(v)
            same_fused &= bool(np.array_equal(
                vals[int(offs[r]):int(offs[r + 1])], v))
    same_plain = np.array_equal(vals, vals_p) and np.array_equal(offs, offs_p)
    print(f"[p14] resolve_sa_flat of {len(seqs)} reads' intervals, "
          f"seed_handle None: {len(vals)} probes in {len(probe_calls)} "
          f"chunks of widths {[c['k'].numel() for c in probe_calls]}; "
          f"sa_host_redo {redo}; == the plain walk {same_plain}; == the "
          f"seed program's fused values on {fused} probes {same_fused}")
    if not (same_plain and same_fused and fused and probe_calls):
        raise SystemExit("phase 14: resolve_sa_flat on the kernel differs "
                         "from the plain walk or the fused values")
    res["probe"] = dict(probes=len(vals), fused=fused, sa_host_redo=redo,
                        widths=[c["k"].numel() for c in probe_calls])
    res["probe_walk"] = walk_calls_check("p14 probe chunk",
                                         probe_calls[:1], True, lat["ns"],
                                         flush)
    res["probe_walk"] += walk_calls_check("p14 probe chunk",
                                          probe_calls[1:])
    del probe_calls

    reads = seeds_dispatch_reads(ba, seqs)
    print(f"[p14] seeds_dispatch of {len(seqs)} reads, no dense SA: "
          f"{reads['before']} before the seed program, {reads['after']} "
          f"after it; synchronising calls in the dispatch "
          f"{len(reads['syncs'])} {reads['syncs'][:3]}")
    waits = [m for m in reads["before"] + reads["after"] if m != "upload"]
    if waits or reads["syncs"] or "upload" not in reads["before"]:
        raise SystemExit("phase 14: seeds_dispatch waited for the card or "
                         "read it")
    res["dispatch_reads"] = reads
    res["hbm_latency"] = lat
    return res


def _mean(recs: list, key: str) -> float:
    return sum(r[key] for r in recs) / len(recs)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bwa_flow_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}; host "
          f"CPUs {os.cpu_count()}")
    build_s = build_everything(_build)
    ptxas = {}
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("Compiling entry", "spill", "Used")):
                print(f"[build] {name}.cu ptxas: {line.strip()}")
        ptxas[name] = ptxas_report(_build.build_log(name))
        print(f"[build] {name}.cu kernels: {ptxas[name]}")
    for name in (*REDESIGNED, "sa_walk"):
        if not ptxas[name] or any(k.get("stack", 1)
                                  for k in ptxas[name].values()):
            raise SystemExit(f"{name}: ptxas puts a stack frame on a kernel "
                             f"({ptxas[name]})")

    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    genome = make_genome(GENOME_LEN, GENOME_SEED)
    write_inputs(WORK, genome, N_READS, GENOME_SEED + 1)
    write_pe_inputs(WORK, genome, N_PAIRS, GENOME_SEED + 2)
    print(f"[data] genome {GENOME_LEN} bp + {N_READS} reads + {N_PAIRS} "
          f"pairs: {time.perf_counter() - t0:.1f} s")

    cuda = torch.device("cuda")

    def timed_phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out
    kres = timed_phase("2 kernels", phase_kernels, genome, cuda)
    timed_phase("2 edge mix", phase_edge_mix, cuda, kres)
    mres = timed_phase("3 single-end", phase_main_path, WORK, "cuda")
    pres = timed_phase("4 paired-end", phase_pe_path, WORK, "cuda")
    seedres = timed_phase("12 seed kernels", phase_seed_kernels, WORK,
                          genome, "cuda")
    timed_phase("5 mean waves", phase_wave_shape, genome, cuda, kres,
                {"ksw_extend2": mres["path"],
                 "ksw_extend2_i16": pres["path"]})
    sres = timed_phase("6 sorted BAM", phase_sort_path, WORK, "cuda")
    rres = timed_phase("7 two ranks", phase_two_ranks, WORK, "cuda")
    bres = timed_phase("8 seed_extend_batch", phase_seed_extend_batch, genome,
                       "cuda")
    lres = timed_phase("8 local devices", phase_local_devices, WORK, "cuda",
                       LD_SHARDS)
    with waves_carry_every_task():
        yres = timed_phase("9 bypassed paths", phase_bypassed_paths, WORK,
                           "cuda")
        vres = timed_phase("9 validation and watchdog",
                           phase_validation_watchdog, WORK, "cuda", mres)
    nres = timed_phase("10 native route", phase_native_route, WORK, "cuda",
                       {"full.sam": mres["markdup"],
                        "pe.sam": pres["markdup"]})
    hres = timed_phase("11 host libraries", phase_host_libraries, WORK,
                       genome, "cuda")
    del genome
    gres = timed_phase("14 large genome", phase_large_genome, WORK, "cuda")
    launches_by_path = {
        "ksw_extend2": {"single_end": mres["launches"],
                        "sort": sres["launches"],
                        "one_process": rres["one_launches"],
                        "ranks": rres["launches"],
                        "local_devices": lres["launches"],
                        "local_devices_shards": lres["shard_launches"],
                        "seed_extend_batch": bres["launches"],
                        "mesh_dryrun": lres["mesh_launches"],
                        "p9_default": yres["default"]["launches"],
                        "p9_wide": yres["wide"]["launches"],
                        "p9_no_dense_sa": yres["no_dense_sa"]["launches"],
                        "p9_validate": vres["validate"]["launches"],
                        "p9_timeout0": vres["timeout0"]["launches"],
                        "native_se_host": nres["se_host"]["launches"],
                        "native_se_waves": nres["se_waves"]["launches"],
                        "native_shards": nres["shards"]["launches"],
                        "native_shards_each":
                            nres["shards"]["shard_launches"]},
        "ksw_extend2_i16": {"paired_end": pres["launches"],
                            "p9_insert_sub": yres["insert_sub"]["launches16"],
                            "p9_insert": yres["insert"]["launches16"],
                            "native_pe_host": nres["pe_host"]["launches16"],
                            "native_pe_waves":
                                nres["pe_waves"]["launches16"]}}
    # the native route's waves runs: the launches of the CLI's route
    native = {"ksw_extend2": nres["se_waves"], "ksw_extend2_i16":
              nres["pe_waves"]}

    # launches, ms, plain_ms and bound_ms of phase 10's waves runs, at
    # their shapes; path_* at the mean wave of phase 3's or 4's run;
    # *_b4096 at the widest wave
    kernels = []
    for name, source, body, res in (
            ("ksw_extend2", "ksw_extend.cu", "_make_kernel", mres),
            ("ksw_extend2_i16", "ksw_extend16.cu", "_make_kernel16", pres)):
        k = kres[name]
        nat = native[name]["shapes"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bwa_flow_tpu_torch/csrc/{source}",
            "replaces": "bwa_flow_tpu/ops/extend_pallas.py:550",
            "replaces_kernel": f"bwa_flow_tpu/ops/extend_pallas.py::{body}",
            "checked": True, "launches": (
                native[name]["launches"] if name == "ksw_extend2"
                else native[name]["launches16"]),
            "max_abs_err": max(k["max_abs_err"], nat["max_abs_err"]),
            "ms": nat["ms"], "plain_ms": nat["plain_ms"],
            "bound_ms": nat["bound_ms"], "bound_by": nat["bound_by"],
            "library_ms": None, "native_classes": nat["classes"],
            "path_ms": k["path_ms"],
            "path_plain_ms": k["path_plain_ms"],
            "path_bound_ms": k["path_bound_ms"],
            "path_B": k["path_B"],
            "launches_by_path": launches_by_path[name],
            "path_device_ms": res["path"]["device_ms"],
            "native_path_device_ms": native[name]["device_ms"].get(name),
            "row_ns": k["row_ns"], "other_kernel_ms": k["path_other_ms"],
            "ms_b4096": k["ms"], "plain_ms_b4096": k["plain_ms"],
            "bound_ms_b4096": k["bound_ms"], "cells_b4096": k["cells"]})
    # the seed kernels: launches on the native route's host-mode SE run
    # (the CLI's default), ms, plain_ms and bound_ms at the SE batch
    # (phase 12; a launch's mean over the batch's calls)
    seed_paths = {"single_end": mres, "paired_end": pres,
                  "native_se_host": nres["se_host"],
                  "native_se_waves": nres["se_waves"],
                  "native_pe_host": nres["pe_host"],
                  "native_pe_waves": nres["pe_waves"],
                  "native_shards": nres["shards"],
                  "large_se": gres["se"], "large_pe": gres["pe"]}
    for name, (_, plain, replaces) in SEED_KERNELS.items():
        k = seedres[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bwa_flow_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "replaces_kernel": f"bwa_flow_tpu/ops/smem_jax.py::{plain}",
            "checked": True,
            "launches": nres["se_host"]["seed_launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "redesigned": REDESIGNED.get(name),
            "chain_floor_ms": k["chain_floor_ms"],
            "longest_lane_probes": k["longest_lane_probes"],
            "l2_latency_ns": seedres["l2_latency"]["ns"],
            "ptxas": ptxas[name],
            "launches_a_batch": k["launches_a_batch"],
            "launches_by_path": {t: r["seed_launches"][name]
                                 for t, r in seed_paths.items()},
            "calls": k["calls"]})
    # the LF walk: launches on the large genome's SE run (the CLI's
    # default route; the seed program's fused walk, one launch a call),
    # ms (a whole sa_batch call), plain_ms, bound_ms, chain floor and an
    # empty launch of the call's grid: a call's mean over that run's
    # seed-walk calls (phase 14)
    sw = gres["seed_walk"]
    checked = (sw + gres["other_walks"] + gres["probe_walk"]
               + gres["pe_walk"] + gres["densify"]["checked"]
               + yres["no_dense_sa"]["walk_calls"]
               + hres["resample"]["walk_calls"])
    kernels.append({
        "name": "sa_walk", "route": "cuda",
        "source": "bwa_flow_tpu_torch/csrc/sa_walk.cu",
        "replaces": "bwa_flow_tpu/ops/fm_jax.py:338",
        "replaces_kernel": "bwa_flow_tpu/ops/fm_jax.py::_lf_walk_fixed, "
                           "sa_batch's while_loops at :438 and :457 and "
                           "compact_pool at :409",
        "checked": True, "launches": gres["se"]["walk_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in checked),
        "calls_checked": len(checked),
        "ms": _mean(sw, "ms"), "plain_ms": _mean(sw, "plain_ms"),
        "bound_ms": _mean(sw, "bound_ms"),
        "bound_by": max(sw, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None, "chain_floor_ms": _mean(sw, "chain_floor_ms"),
        "launch_cost_ms": _mean(sw, "launch_ms"),
        "hbm_latency_ns": gres["hbm_latency"]["ns"],
        "ptxas": ptxas["sa_walk"],
        "redesigned": "one launch a sa_batch call (every phase and "
                      "pool), a block's live lanes queued in shared memory "
                      "in lane order, exact pool ranks by a decoupled "
                      "look-back",
        "launches_by_path": {
            "large_se": gres["se"]["walk_launches"],
            "large_pe": gres["pe"]["walk_launches"],
            "p9_no_dense_sa": yres["no_dense_sa"]["walk_launches"],
            "p11_resampled": hres["resample"]["walk_launches"],
            "densify_4_6_mbp": gres["densify"]["launches"]},
        "calls": {"seed_walk": sw, "probe_chunk": gres["probe_walk"][:1],
                  "densify": [r for r in gres["densify"]["checked"]
                              if "ms" in r]},
        "densify": {k: v for k, v in gres["densify"].items()
                    if k != "checked"},
        "probe": gres["probe"]})
    kernels[0]["sort_path_device_ms"] = sres["path"]["device_ms"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    bres["max_abs_err"])
    kernels[0]["seed_extend_batch_ms_b4096"] = bres["ms"]
    # phase 11's native and Python seconds, by the library that ran them
    p11 = {"_native": {k: hres[k] for k in ("sais", "ksw_extend2",
                                            "ksw_global2", "resample")},
           "_markdup": {"markdup": hres["markdup"],
                        "mem_se_host": nres["se_host"]["markdup"],
                        "mem_se_waves": mres["markdup"],
                        "mem_pe_host": nres["pe_host"]["markdup"],
                        "mem_pe_waves": pres["markdup"]},
           "_bam": {"native": hres["bam_native"]}}
    host_libs = [{"name": n, "source":
                  f"bwa_flow_tpu_torch/csrc/host/{n}.cpp",
                  "replaces": f"native/{n}.cpp", "build_s": build_s[n],
                  "checked": p11.get(n)}
                 for n in _build.HOST_LIBS]
    print(json.dumps({"kernels": kernels, "host_libraries": host_libs,
                      "index_s": mres["index_s"],
                      "seed_s_per_batch": {
                          t: r["seed_s_per_batch"]
                          for t, r in seed_paths.items()},
                      "seed_dispatch_reads": seedres["dispatch_reads"],
                      "large_genome": {
                          k: gres[k] for k in (
                              "seq_len", "index_s", "index_sa_s", "load_s",
                              "resampled", "se_map", "pe_map")} | {
                          "se_wall_s": gres["se"]["wall_s"],
                          "pe_wall_s": gres["pe"]["wall_s"],
                          "dispatch_reads": gres["dispatch_reads"]}}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
