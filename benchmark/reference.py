"""The plain reference that decides `correct`, and its control.

NumPy only: it imports nothing of the port or of the JAX package and
reads none of the port's files. It works from the configuration's
genome (`genome.npy`), the reads the generator drew from the seed, and
the SAM records the timed path emitted.

For each sampled read it checks, from the genome alone:

- `missing`: the read has exactly one primary record (and the emit
  count, in the harness, that every read handed to the pipeline came
  back);
- `record_faults`: each record's SEQ is the read (reverse-complemented
  on the reverse strand, hard clips cut away), its CIGAR covers the SEQ,
  its NM is the edit distance of that CIGAR at that POS, and, for
  pairs, the mate fields agree with the mate's primary record;
- `suboptimal_reads`: the reads whose primary alignment scores below
  the best gapped local alignment of the read inside the genome window
  it was drawn from, both under bwa's scoring (-A -B -O -E, and -L for
  each clipped end), the program's taken from the genome at its POS and
  CIGAR, the best from a plain affine-gap dynamic program. bwa is a
  heuristic: in repeats it now and then places a read on another copy,
  so a few such reads are sound; the widest gap (`score_gap`) is
  reported beside the count, not compared, since it swings with which
  copy a repeat read lands on;
- `mapq_faults`: reads aligned inside their window, with no
  suboptimal hit (XS absent or 0), from a window that no pasted repeat
  of the genome touches (`repeats`), whose MAPQ is 0;
- `pair_faults` (pairs): pairs whose two primaries both align inside
  their fragment's window on opposite strands, but that are not flagged
  proper (0x2) on both records, or whose TLEN is not the distance of
  the two records' aligned 5' ends (bwa's TLEN), or, where no indel of
  the fragment lies near its ends, whose unclipped 5' ends lie
  elsewhere than the fragment's ends on the genome (a clip by
  sequencing errors moves the aligned end, not the unclipped one);
- `dup_unmarked` (pairs): of the fragments that came from one place of
  the genome (an exact copy of an earlier fragment, from any batch, or
  a chance coincidence), a pair whose two primaries align as an earlier
  one of them did (the same unclipped 5' ends and strands, the key of
  samblaster's signature) must carry the duplicate flag (0x400) on
  both primary records.

The control (`ungapped_records`) is the reference itself put in the
program's place with one guarantee broken: ungapped alignment, the best
clip-penalised diagonal segment in the same window. Its pairs are
proper, with bwa's TLEN, and its MAPQ is 60.
"""

from __future__ import annotations

import re

import numpy as np

COMP = np.array([3, 2, 1, 0], np.uint8)
CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
BASES = np.frombuffer(b"ACGT", np.uint8)
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
NEG = -(1 << 24)

F_PAIRED, F_PROPER, F_UNMAP, F_MUNMAP, F_REV, F_MREV = \
    0x1, 0x2, 0x4, 0x8, 0x10, 0x20
F_FIRST, F_SECOND, F_SECONDARY, F_DUP, F_SUPP = 0x40, 0x80, 0x100, 0x400, \
    0x800


def parse_line(line: str) -> dict:
    f = line.rstrip("\n").split("\t")
    tags = {}
    for t in f[11:]:
        k, _, v = t.split(":", 2)
        tags[k] = v
    return dict(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
                mapq=int(f[4]), cigar=f[5], rnext=f[6], pnext=int(f[7]),
                tlen=int(f[8]), seq=f[9], tags=tags)


def cigar_ops(cigar: str) -> list[tuple[int, str]]:
    return [(int(n), op) for n, op in _CIGAR.findall(cigar)]


def score_record(rec: dict, genome: np.ndarray, sc: dict) -> dict:
    """Walk a mapped record's CIGAR over the genome: its bwa score, edit
    distance, query length, soft clips at each end, hard clip at the
    front."""
    ops = cigar_ops(rec["cigar"])
    q = CODE[np.frombuffer(rec["seq"].encode(), np.uint8)]
    qi, ri = 0, rec["pos"] - 1
    score = nm = 0
    ok = ri >= 0
    for n, op in ops:
        if op in "M=X":
            if ri + n > len(genome) or qi + n > len(q):
                ok = False
                break
            mis = int(np.count_nonzero(q[qi:qi + n]
                                       != np.asarray(genome[ri:ri + n])))
            score += (n - mis) * sc["a"] - mis * sc["b"]
            nm += mis
            qi += n
            ri += n
        elif op == "I":
            score -= sc["o_ins"] + sc["e_ins"] * n
            nm += n
            qi += n
        elif op == "D":
            score -= sc["o_del"] + sc["e_del"] * n
            nm += n
            ri += n
        elif op == "S":
            qi += n
    clip5 = bool(ops) and ops[0][1] == "S"
    clip3 = bool(ops) and ops[-1][1] == "S"
    hard5 = ops[0][0] if ops and ops[0][1] == "H" else 0
    return dict(score=score, nm=nm, qlen=qi, ok=ok and qi == len(q),
                clip5=clip5, clip3=clip3, hard5=hard5,
                rlen=ri - (rec["pos"] - 1),
                clipped=score - sc["pen_clip"] * (clip5 + clip3))


def ref_len(cigar: str) -> int:
    return sum(n for n, op in cigar_ops(cigar) if op in "MDN=X")


def end5(rec: dict, unclipped: bool = False) -> int:
    """The 1-based genome position of a mapped record's 5' end: its
    aligned end (what bwa's TLEN counts from), or with `unclipped` the
    end its clips would reach (samblaster's signature)."""
    ops = cigar_ops(rec["cigar"])

    def clip(op):
        return op[0] if unclipped and op[1] in "SH" else 0
    if rec["flag"] & F_REV:
        return rec["pos"] + ref_len(rec["cigar"]) - 1 + clip(ops[-1])
    return rec["pos"] - clip(ops[0])


def covered(spans: np.ndarray, lo: np.ndarray, hi: np.ndarray
            ) -> np.ndarray:
    """Whether any of the sorted (start, end) spans meets [lo, hi)."""
    if spans is None or not len(spans):
        return np.zeros(len(lo), bool)
    reach = np.maximum.accumulate(spans[:, 1])
    i = np.searchsorted(spans[:, 0], hi, side="left")
    return (i > 0) & (reach[np.maximum(i - 1, 0)] > lo)


def best_local(Q: np.ndarray, R: np.ndarray, sc: dict) -> np.ndarray:
    """The best clip-penalised local score of each read Q[k] (symbols,
    genome orientation) inside its window R[k] (symbols, 4 pads): affine
    gaps, -L for a clipped 5' end and for a clipped 3' end."""
    n, m = Q.shape
    W = R.shape[1]
    a, b, clip = sc["a"], sc["b"], sc["pen_clip"]
    oe_d, e_d = sc["o_del"] + sc["e_del"], sc["e_del"]
    oe_i, e_i = sc["o_ins"] + sc["e_ins"], sc["e_ins"]
    jj = np.arange(W + 1, dtype=np.int32) * e_d
    H = np.zeros((n, W + 1), np.int32)
    F = np.full((n, W + 1), NEG, np.int32)
    diag = np.full((n, W + 1), NEG, np.int32)
    E = np.full((n, W + 1), NEG, np.int32)
    best = np.full(n, NEG, np.int64)
    for i in range(1, m + 1):
        s = np.where(R == Q[:, i - 1:i], a, -b).astype(np.int32)
        diag[:, 1:] = H[:, :-1] + s
        F = np.maximum(H - oe_i, F - e_i)
        H0 = np.maximum(np.maximum(diag, F), -clip)
        M = np.maximum.accumulate(H0 + jj, axis=1)
        E[:, 1:] = M[:, :-1] - oe_d - jj[:-1]
        H = np.maximum(H0, E)
        row = H.max(axis=1).astype(np.int64)
        best = np.maximum(best, row if i == m else row - clip)
    return best


def oriented(read: np.ndarray, rev: bool) -> np.ndarray:
    return COMP[read[::-1]] if rev else read


def windows(genome: np.ndarray, lo: np.ndarray, hi: np.ndarray
            ) -> np.ndarray:
    W = int((hi - lo).max())
    G = len(genome)
    idx = lo[:, None] + np.arange(W)
    inside = (idx < hi[:, None]) & (idx >= 0) & (idx < G)
    R = np.full(idx.shape, 4, np.uint8)
    R[inside] = np.asarray(genome[idx[inside]])
    return R


def ungapped_records(genome, reads, rev, lo, hi, names, sc,
                     paired: bool) -> dict:
    """The control: for each read the best clip-penalised ungapped
    segment in its window, as SAM records {name: [lines]} (pairs: mate
    fields filled, both mates under one name)."""
    Q = np.stack([oriented(r, v) for r, v in zip(reads, rev)])
    R = windows(genome, lo, hi)
    n, m = Q.shape
    a, b, clip = sc["a"], sc["b"], sc["pen_clip"]
    best = np.full(n, NEG, np.int64)
    arg = np.zeros((n, 3), np.int64)
    rows = np.arange(n)
    pen_a = np.r_[0, np.full(m, clip)]
    pen_b = np.r_[np.full(m, clip), 0]
    for d in range(R.shape[1] - m + 1):
        s = np.where(R[:, d:d + m] == Q, a, -b)
        P = np.zeros((n, m + 1), np.int64)
        P[:, 1:] = np.cumsum(s, axis=1)
        lead = P + pen_a
        cmin = np.minimum.accumulate(lead, axis=1)
        # the start of the best segment ending past each base: the latest
        # index that holds the running minimum
        amin = np.maximum.accumulate(
            np.where(lead == cmin, np.arange(m + 1), 0), axis=1)
        v = P[:, 1:] - cmin[:, :-1] - pen_b[1:]
        y = v.argmax(axis=1)
        got = v[rows, y]
        take = got > best
        best[take] = got[take]
        arg[take, 0] = d
        arg[take, 1] = amin[rows, y][take]
        arg[take, 2] = y[take] + 1
    out: dict = {}
    recs = []
    for k in range(n):
        d, x, y = (int(t) for t in arg[k])
        pos = int(lo[k]) + d + x + 1
        cig = (f"{x}S" if x else "") + f"{y - x}M" + \
            (f"{m - y}S" if y < m else "")
        seq = BASES[Q[k]].tobytes().decode()
        nm = int(np.count_nonzero(Q[k, x:y] != R[k, d + x:d + y]))
        recs.append(dict(name=names[k], flag=F_REV if rev[k] else 0,
                         pos=pos, end5=pos + (y - x - 1 if rev[k] else 0),
                         cigar=cig, seq=seq, nm=nm,
                         score=int(best[k]) + clip * ((x > 0) + (y < m))))
    per = 2 if paired else 1
    for k in range(0, n, per):
        grp = recs[k:k + per]
        lines = []
        for j, r in enumerate(grp):
            flag = r["flag"]
            rnext, pnext, tlen = "*", 0, 0
            if paired:
                mate = grp[1 - j]
                flag |= F_PAIRED | F_PROPER | (F_FIRST if j == 0
                                               else F_SECOND)
                flag |= F_MREV if mate["flag"] & F_REV else 0
                rnext, pnext = "=", mate["pos"]
                p0, p1 = r["end5"], mate["end5"]
                tlen = -(p0 - p1 + (p0 > p1) - (p0 < p1))
            lines.append(f"{r['name']}\t{flag}\tchr1\t{r['pos']}\t60\t"
                         f"{r['cigar']}\t{rnext}\t{pnext}\t{tlen}\t"
                         f"{r['seq']}\t*\tNM:i:{r['nm']}\t"
                         f"AS:i:{r['score']}")
        out[grp[0]["name"]] = lines
    return out


def compare(sample: dict, records: dict, genome: np.ndarray, sc: dict,
            paired: bool, repeats: np.ndarray | None = None) -> dict:
    """Judge the sampled reads' records. `sample`: reads (n, L) as
    written, rev, lo, hi, span (the fragment's span on the genome, -1
    unknown), end_indel (an indel lies near the fragment's ends), name
    (a read's QNAME), mate (0/1), group (the read's group
    of fragments from one place of the genome, -1 if none) and frag (its
    stream index) for each sampled read; `records`: {QNAME: [SAM
    lines]}; `repeats`: the sorted (start, end) spans of the genome's
    repeats. Returns the numbers compared and what they were taken
    from."""
    n = len(sample["name"])
    Q = np.stack([oriented(r, v) for r, v in zip(sample["reads"],
                                                  sample["rev"])])
    best = best_local(Q, windows(genome, sample["lo"], sample["hi"]), sc)
    unique = ~covered(repeats, np.asarray(sample["lo"]),
                      np.asarray(sample["hi"]))
    missing = faults = mapq_faults = mapq_checked = 0
    gaps = np.zeros(n, np.int64)
    as_differs = 0
    prim: dict = {}
    inside: dict = {}
    why: list = []
    for k in range(n):
        name, mate = sample["name"][k], int(sample["mate"][k])
        lines = [parse_line(l) for l in records.get(name, [])]
        if paired:
            bit = F_FIRST if mate == 0 else F_SECOND
            lines = [r for r in lines if r["flag"] & bit]
        mine = [r for r in lines if not r["flag"] & (F_SECONDARY | F_SUPP)]
        if len(mine) != 1:
            missing += 1
            gaps[k] = best[k]
            why.append(f"{name}/{mate}: {len(mine)} primary records")
            continue
        p = mine[0]
        prim[(name, mate)] = p
        read = sample["reads"][k]
        for r in lines:
            if r["flag"] & F_UNMAP:
                seq = BASES[oriented(read, bool(r["flag"] & F_REV))]
                if r["seq"] != seq.tobytes().decode():
                    faults += 1
                    why.append(f"{name}/{mate}: unmapped SEQ differs")
                continue
            s = score_record(r, genome, sc)
            full = BASES[oriented(read, bool(r["flag"] & F_REV))
                         ].tobytes().decode()
            want = full[s["hard5"]:s["hard5"] + len(r["seq"])]
            bad = []
            if r["seq"] != want:
                bad.append("SEQ")
            if not s["ok"]:
                bad.append("CIGAR")
            if int(r["tags"].get("NM", -1)) != s["nm"]:
                bad.append(f"NM {r['tags'].get('NM')} != {s['nm']}")
            if bad:
                faults += 1
                why.append(f"{name}/{mate} {r['cigar']}@{r['pos']}: "
                           + ", ".join(bad))
            if r is p and int(r["tags"].get("AS", -1)) != s["score"]:
                as_differs += 1
        if p["flag"] & F_UNMAP:
            gaps[k] = best[k]
            continue
        sp = score_record(p, genome, sc)
        gaps[k] = max(0, int(best[k]) - sp["clipped"])
        inside[(name, mate)] = (p["pos"] - 1 >= sample["lo"][k]
                                and p["pos"] - 1 + sp["rlen"]
                                <= sample["hi"][k])
        if inside[(name, mate)] and unique[k] and \
                int(p["tags"].get("XS", 0)) == 0:
            mapq_checked += 1
            if p["mapq"] == 0:
                mapq_faults += 1
                why.append(f"{name}/{mate}: MAPQ 0 in a unique window "
                           f"with no XS ({p['cigar']}@{p['pos']})")
    dup_checked = dup_unmarked = pair_checked = pair_faults = 0
    if paired:
        span = dict(zip(sample["name"], sample["span"]))
        end_indel = dict(zip(sample["name"], sample["end_indel"]))
        names = sorted({nm for nm, _ in prim})
        for nm in names:
            p1, p2 = prim.get((nm, 0)), prim.get((nm, 1))
            if p1 is None or p2 is None:
                continue
            bad = _mate_faults(p1, p2) + _mate_faults(p2, p1)
            if bad:
                faults += 1
                why.append(f"{nm}: mate fields " + ", ".join(bad))
            if not (inside.get((nm, 0)) and inside.get((nm, 1))) or \
                    span[nm] < 0 or \
                    bool(p1["flag"] & F_REV) == bool(p2["flag"] & F_REV):
                continue
            pair_checked += 1
            bad = [f"{r['flag']} not proper" for r in (p1, p2)
                   if not r["flag"] & F_PROPER]
            for r, m in ((p1, p2), (p2, p1)):
                a, b = end5(r), end5(m)
                if r["tlen"] != -(a - b + (a > b) - (a < b)):
                    bad.append(f"TLEN {r['tlen']} at 5' ends {a}, {b}")
            outer = abs(end5(p1, True) - end5(p2, True)) + 1
            if not end_indel[nm] and outer != span[nm]:
                bad.append(f"unclipped 5' ends {outer} apart, span "
                           f"{span[nm]}")
            if bad:
                pair_faults += 1
                why.append(f"{nm}: " + ", ".join(bad))
        dup_checked, dup_unmarked = _duplicates(sample, prim, why)
    worst = int(gaps.argmax()) if n else 0
    if n and gaps[worst] > 0:
        key = (sample["name"][worst], int(sample["mate"][worst]))
        p = prim.get(key)
        why.append(f"widest gap {int(gaps[worst])}: {key[0]}/{key[1]} "
                   f"window {sample['lo'][worst]}-{sample['hi'][worst]} "
                   f"best {int(best[worst])}; primary "
                   + (f"{p['flag']} {p['pos']} {p['cigar']} AS "
                      f"{p['tags'].get('AS')} XS {p['tags'].get('XS')}"
                      if p else "none"))
    out = dict(missing=missing, record_faults=faults,
               score_gap=int(gaps.max()) if n else 0,
               suboptimal_reads=int((gaps > 0).sum()),
               mapq_faults=mapq_faults, mapq_checked=mapq_checked,
               reads=n, as_differs=as_differs, why=why[-8:])
    if paired:
        out.update(pair_faults=pair_faults, pair_checked=pair_checked,
                   dup_unmarked=dup_unmarked, dup_checked=dup_checked)
    return out


def _duplicates(sample: dict, prim: dict, why: list) -> tuple[int, int]:
    """Within each group of fragments from one place of the genome, in
    stream order: a pair whose primaries have the unclipped 5' ends and
    strands of an earlier member's must be flagged duplicate on both."""
    groups: dict = {}
    for nm, g, f in zip(sample["name"], sample["group"], sample["frag"]):
        if g >= 0:
            groups.setdefault(int(g), {})[int(f)] = nm
    checked = unmarked = 0
    for members in groups.values():
        seen = set()
        for f in sorted(members):
            nm = members[f]
            pair = [prim.get((nm, j)) for j in (0, 1)]
            if None in pair or any(r["flag"] & F_UNMAP for r in pair):
                continue
            sig = tuple(sorted((end5(r, True), bool(r["flag"] & F_REV))
                               for r in pair))
            if sig in seen:
                checked += 1
                if not all(r["flag"] & F_DUP for r in pair):
                    unmarked += 1
                    why.append(f"{nm}: aligns as an earlier fragment of "
                               "its place, not flagged duplicate")
            seen.add(sig)
    return checked, unmarked


def _mate_faults(r: dict, m: dict) -> list:
    bad = []
    if not r["flag"] & F_PAIRED:
        bad.append("not paired")
    if bool(r["flag"] & F_MUNMAP) != bool(m["flag"] & F_UNMAP):
        bad.append("mate unmapped flag")
    if r["flag"] & F_UNMAP or m["flag"] & F_UNMAP:
        return bad
    if bool(r["flag"] & F_MREV) != bool(m["flag"] & F_REV):
        bad.append("mate strand flag")
    if r["rnext"] not in ("=", m["rname"]) or r["pnext"] != m["pos"]:
        bad.append("RNEXT/PNEXT")
    if r["rname"] == m["rname"] and r["tlen"] != -m["tlen"]:
        bad.append("TLEN")
    return bad
