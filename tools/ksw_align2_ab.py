"""Time the port's mate-rescue local alignment, ksw_align2 in
csrc/host/ksw_impl.h, on its striped pass and on its scalar pass, in one
process, on the shapes of the PE tail's rescue.

    python3 tools/ksw_align2_ab.py [--qlen 151] [--tlen 630] [--calls 400]
                                   [--blocks 8] [--seed 1]

The query is a 151 bp mate; the target is the window the insert size
gives (about 630 bp for N(500, 50) fragments). Two cases: the mate
present in the window (2% substitutions and a 2 bp deletion) and the
mate absent (random window). The call is the tail's: bwa mem's scoring
(match 1, mismatch 4, gaps 6+1), KSW_XSUBO | KSW_XSTART, KSW_XBYTE where
qlen * match < 250, and minsc 19. Each block times `--calls` calls of one
pass on the same inputs; blocks alternate scalar, striped, striped,
scalar, and every call's result is held equal between the passes. It
prints a table of microseconds a call (median over blocks, and the
least and most) and one JSON line. Host CPU only: no card is used.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bwa_flow_tpu_torch import _build  # noqa: E402
from bwa_flow_tpu_torch.ops import ksw  # noqa: E402
from bwa_flow_tpu_torch.utils.opts import MemOpt  # noqa: E402


def cases(rng, qlen: int, tlen: int) -> dict:
    """(query, target) of each case, as the tail hands them to ksw_align2."""
    q = rng.integers(0, 4, qlen).astype(np.uint8)
    absent = rng.integers(0, 4, tlen).astype(np.uint8)
    mate = q.copy()
    sub = rng.random(qlen) < 0.02
    mate[sub] = (mate[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    cut = qlen // 2
    mate = np.concatenate([mate[:cut], mate[cut + 2:]])
    present = rng.integers(0, 4, tlen).astype(np.uint8)
    at = (tlen - len(mate)) // 2
    present[at:at + len(mate)] = mate
    return {"present": (q, present), "absent": (q, absent)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qlen", type=int, default=151)
    ap.add_argument("--tlen", type=int, default=630)
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    nat = _build.host_module("_native")
    opt = MemOpt()
    mat = np.ascontiguousarray(opt.mat, np.int8).ravel()
    pens = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    xtra = (ksw.KSW_XSUBO | ksw.KSW_XSTART | opt.min_seed_len * opt.a
            | (ksw.KSW_XBYTE if a.qlen * opt.a < 250 else 0))
    passes = {"scalar": nat.ksw_align2_scalar, "striped": nat.ksw_align2}
    if not nat.ksw_striped_ok(a.qlen, mat, 5, *pens, xtra):
        raise SystemExit("this query does not take the striped pass here")
    rows, out = [], {}
    for name, (q, t) in cases(np.random.default_rng(a.seed), a.qlen,
                              a.tlen).items():
        args = (len(q), q, len(t), t, mat, 5, *pens, xtra)
        want = nat.ksw_align2_scalar(*args)
        assert nat.ksw_align2(*args) == want, (name, want)
        us = {"scalar": [], "striped": []}
        order = ["scalar", "striped", "striped", "scalar"]
        for b in range(a.blocks):
            p = order[b % 4]
            fn = passes[p]
            t0 = time.perf_counter()
            for _ in range(a.calls):
                fn(*args)
            us[p].append(1e6 * (time.perf_counter() - t0) / a.calls)
        med = {p: statistics.median(v) for p, v in us.items()}
        rows.append((name, want, med, us))
        out[name] = {"score": want[0], "scalar_us": med["scalar"],
                     "striped_us": med["striped"],
                     "speedup": med["scalar"] / med["striped"]}
    print(f"ksw_align2, {a.qlen} x {a.tlen}, {a.calls} calls a block, "
          f"{a.blocks} blocks; {platform.machine()}, "
          f"{platform.processor() or 'cpu'}")
    print("| case | score | scalar us/call | striped us/call | speed-up |")
    print("| --- | --- | --- | --- | --- |")
    for name, want, med, us in rows:
        print(f"| {name} | {want[0]} | {med['scalar']:.2f} "
              f"({min(us['scalar']):.2f}-{max(us['scalar']):.2f}) | "
              f"{med['striped']:.2f} ({min(us['striped']):.2f}-"
              f"{max(us['striped']):.2f}) | "
              f"{med['scalar'] / med['striped']:.2f}x |")
    print(json.dumps({"qlen": a.qlen, "tlen": a.tlen, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
