"""A configuration's reference genome and the port's index of it.

The genome is synthetic and fixed by the configuration (its own seed):
one contig, a random backbone with the configuration's repeat classes
pasted in at the counts, lengths and shares that its published
annotation gives (`genome.repeats`: diverged copies of a few consensus
sequences on both strands; `genome.satellites`: tandem arrays), each
class confined to a `region` of the contig where the configuration
says so (a fly's heterochromatin).

The first run of a configuration in a checkout makes the genome and
builds the port's index into `benchmark/.cache/<config>-<digest>/` (one
process at a time, under a file lock); later runs find them there, as a
`bwa mem` job finds the `bwa index` output it is given. The benchmark's
plain reference reads only `genome.npy` and `repeats.npy` (the spans of
the pasted copies), never the port's index files.

    python3 benchmark/genome.py CONFIG_NAME [--share]

builds one configuration's genome and index into the cache, or with
`--share` only prints the share of its genome that repeats cover.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
CONTIG = "chr1"
DONE = "complete.json"


def _diverged(rng, seq, div):
    out = seq.copy()
    nmut = rng.binomial(len(out), div)
    if nmut:
        at = rng.integers(0, len(out), nmut)
        out[at] = (out[at] + rng.integers(1, 4, nmut)) & 3
    return out


def _region(spec: dict, length: int) -> tuple[int, int]:
    a, b = spec.get("region", (0.0, 1.0))
    return int(a * length), int(b * length)


def _paste_family(rng, g, spec, spans):
    """Diverged copies of one repeat class: `families` consensus
    sequences of `length` bases, the copies dealt to them in turn, each
    copy on a random strand at a random place. A placement (`placements`,
    or the class itself) gives `copies`, their `divergence` from the
    consensus, and the `region` of the contig they fall in. With
    `mean_length` below `length` the copies are 5'-truncated, their
    lengths uniform with that mean."""
    elen = int(spec["length"])
    cons = [rng.integers(0, 4, elen, dtype=np.uint8)
            for _ in range(int(spec.get("families", 1)))]
    mean = float(spec.get("mean_length", elen))
    for place in spec.get("placements", [spec]):
        lo, hi = _region(place, len(g))
        n = int(place["copies"])
        if mean < elen:
            short = max(1, int(0.05 * elen))
            lens = rng.integers(short, int(2 * mean - short) + 1, n)
        else:
            lens = np.full(n, elen, np.int64)
        pos = rng.integers(lo, hi - elen - 1, n)
        strand = rng.random(n) < 0.5
        div = float(place["divergence"])
        for k in range(n):
            L = int(lens[k])
            cp = _diverged(rng, cons[k % len(cons)][elen - L:], div)
            if strand[k]:
                cp = (3 - cp)[::-1]
            g[pos[k]:pos[k] + L] = cp
            spans.append((int(pos[k]), int(pos[k]) + L))


def _paste_satellite(rng, g, spec, spans):
    """`arrays` tandem arrays of `units` copies of one `unit`-base
    repeat unit each, every unit diverged by `divergence`."""
    lo, hi = _region(spec, len(g))
    unit = rng.integers(0, 4, int(spec["unit"]), dtype=np.uint8)
    n_units = int(spec["units"])
    for _ in range(int(spec["arrays"])):
        arr = _diverged(rng, np.tile(unit, n_units),
                        float(spec["divergence"]))
        p = int(rng.integers(lo, hi - len(arr) - 1))
        g[p:p + len(arr)] = arr
        spans.append((p, p + len(arr)))


def make_genome(length: int, spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """Symbols 0..3 of the configuration's genome: a random backbone with
    its repeat classes (`spec["repeats"]`) and satellite arrays
    (`spec["satellites"]`) pasted in, in that order, from `spec["seed"]`.
    Returns the genome and the (start, end) spans of every pasted copy
    and array."""
    rng = np.random.default_rng(int(spec["seed"]))
    g = rng.integers(0, 4, length, dtype=np.uint8)
    spans: list = []
    for fam in spec.get("repeats", []):
        _paste_family(rng, g, fam, spans)
    for sat in spec.get("satellites", []):
        _paste_satellite(rng, g, sat, spans)
    sp = np.asarray(sorted(spans), np.int64).reshape(-1, 2)
    return g, sp


def repeat_share(spans: np.ndarray, length: int) -> float:
    """The share of the genome that pasted copies cover."""
    cover = np.zeros(length + 1, np.int32)
    np.add.at(cover, spans[:, 0], 1)
    np.add.at(cover, spans[:, 1], -1)
    return float((np.cumsum(cover[:-1]) > 0).mean())


def cache_dir(config: dict) -> Path:
    """The cache of one configuration, named by the configuration and a
    digest of its genome, so that a changed genome is never read from an
    older cache."""
    key = json.dumps([config["length"], config["genome"]], sort_keys=True)
    return CACHE / f"{config['name']}-{hashlib.sha1(key.encode()).hexdigest()[:10]}"


def genome_of(config: dict) -> np.ndarray:
    """The configuration's genome, memory-mapped from its cache."""
    return np.load(cache_dir(config) / "genome.npy", mmap_mode="r")


def repeats_of(config: dict) -> np.ndarray:
    """The (start, end) spans of the genome's pasted repeat copies."""
    return np.load(cache_dir(config) / "repeats.npy")


def ensure_genome(config: dict, log=print) -> dict:
    """Make the configuration's genome into its cache unless it is there;
    returns the seconds it took ({} when cached)."""
    d = cache_dir(config)
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if (d / "genome.npy").exists():
            return {}
        t0 = time.perf_counter()
        genome, spans = make_genome(int(config["length"]), config["genome"])
        np.save(d / "repeats.npy", spans)
        np.save(d / "genome.tmp.npy", genome)
        (d / "genome.tmp.npy").rename(d / "genome.npy")
        dt = time.perf_counter() - t0
        log(f"[bench] made the genome of {config['name']}: {dt:.1f} s")
        return {"genome_s": dt}


def ensure_index(config: dict, log=print) -> tuple[str, dict]:
    """The index prefix of `config`, built with the port's `index` on
    the first call in this checkout. Returns (prefix, what was made and
    its seconds)."""
    d = cache_dir(config)
    prefix = str(d / "ref")
    built = ensure_genome(config, log)
    with open(d / "lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if (d / DONE).exists():
            return prefix, built
        # the port's `bwa index`: index.build (index_fasta without the
        # FASTA round trip) and its writer of the bwa artifacts
        from bwa_flow_tpu_torch.index.build import build_index
        from bwa_flow_tpu_torch.index.io import save_index
        t0 = time.perf_counter()
        seq = np.frombuffer(b"ACGT", np.uint8)[genome_of(config)].tobytes()
        fm = build_index([(CONTIG, "", seq)])
        del seq
        save_index(prefix, fm)
        del fm
        built["index_s"] = time.perf_counter() - t0
        (d / DONE).write_text(json.dumps(built))
        log(f"[bench] built the index of {config['name']}: "
            f"{built['index_s']:.1f} s")
        return prefix, built


if __name__ == "__main__":
    cfg = json.loads((HERE / "configs" / f"{sys.argv[1]}.json").read_text())
    if sys.argv[2:] == ["--share"]:
        g, sp = make_genome(int(cfg["length"]), cfg["genome"])
        print(f"{cfg['name']}: {len(sp)} copies and arrays cover "
              f"{repeat_share(sp, len(g)):.4f} of {len(g)} bases")
    else:
        print(ensure_index(cfg))
