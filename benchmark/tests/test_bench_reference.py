"""The plain reference: its dynamic program against a brute-force one,
and the comparison failing on planted faults and on the control."""

import numpy as np
import pytest

import readgen
import reference as ref

SC = dict(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1, pen_clip=5)
GENOME = np.random.default_rng(11).integers(0, 4, 300_000).astype(np.uint8)
MIX = dict(layout="se", read_len=151, batch_reads=256, sub_rate=0.01,
           mut_rate=0.001, indel_frac=0.15, indel_ext=0.3, dup_frac=0.0)


def _brute(q, r):
    """Clip-penalised affine-gap local alignment, cell by cell."""
    m, n = len(q), len(r)
    NEG = -10**9
    H = [[NEG] * (n + 1) for _ in range(m + 1)]
    E = [[NEG] * (n + 1) for _ in range(m + 1)]
    F = [[NEG] * (n + 1) for _ in range(m + 1)]
    best = NEG
    for i in range(m + 1):
        for j in range(n + 1):
            start = 0 if i == 0 else -SC["pen_clip"]
            h = start
            if i and j:
                h = max(h, H[i - 1][j - 1] + (SC["a"] if q[i - 1] == r[j - 1]
                                              else -SC["b"]))
            if j:
                E[i][j] = max(H[i][j - 1] - SC["o_del"] - SC["e_del"],
                              E[i][j - 1] - SC["e_del"])
            if i:
                F[i][j] = max(H[i - 1][j] - SC["o_ins"] - SC["e_ins"],
                              F[i - 1][j] - SC["e_ins"])
            H[i][j] = max(h, E[i][j], F[i][j])
            if i:
                best = max(best, H[i][j] - (0 if i == m else SC["pen_clip"]))
    return best


def test_best_local_matches_brute_force():
    rng = np.random.default_rng(3)
    Q, R, want = [], [], []
    for k in range(12):
        r = rng.integers(0, 4, 40).astype(np.uint8)
        q = r[5:30].copy()
        if k % 3 == 0:
            q = np.concatenate([q[:10], q[12:]])          # deletion
        if k % 3 == 1:
            q = np.concatenate([q[:8], [1, 2, 3], q[8:]])  # insertion
        q = q[:20]
        q[rng.integers(0, 20, 2)] ^= 1
        Q.append(q)
        R.append(r)
        want.append(_brute(list(q), list(r)))
    got = ref.best_local(np.stack(Q), np.stack(R), SC)
    assert got.tolist() == want


def _sample_and_truth(seed=5, paired=False):
    mix = dict(MIX, layout="pe", frag_mean=400, frag_sd=40,
               dup_frac=0.05) if paired else MIX
    b = readgen.Batches(GENOME, mix, seed, 0).batch(0)
    per = b["per"]
    n = len(b["reads"])
    place = readgen.places(b["lo"][::per], b["hi"][::per]) if paired \
        else np.full(n, -1)
    sample = dict(reads=list(b["reads"]), rev=b["rev"], lo=b["lo"],
                  hi=b["hi"], span=np.repeat(b["span"], per),
                  end_indel=np.repeat(b["end_indel"], per),
                  name=[readgen.name_str(0, k // per) for k in range(n)],
                  mate=[k % per for k in range(n)],
                  group=np.repeat(place, per),
                  frag=np.arange(n) // per)
    return sample, b


def _records(sample, paired, keep=lambda k: True):
    recs = ref.ungapped_records(GENOME, sample["reads"], sample["rev"],
                                sample["lo"], sample["hi"], sample["name"],
                                SC, paired)
    return recs


def _clean(paired=False):
    sample, b = _sample_and_truth(paired=paired)
    keep = ~np.repeat(b["indel"], b["per"])
    sub = {k: [v for v, t in zip(sample[k], keep) if t] for k in sample}
    for k in ("rev", "lo", "hi", "span", "end_indel", "group", "frag"):
        sub[k] = np.asarray(sub[k])
    return sub


def test_sound_records_pass():
    s = _clean()
    got = ref.compare(s, _records(s, False), GENOME, SC, False)
    assert got["missing"] == got["record_faults"] == got["score_gap"] == 0
    assert got["suboptimal_reads"] == 0


def _edit(recs, name, fn, line=0):
    recs = {k: list(v) for k, v in recs.items()}
    f = recs[name][line].split("\t")
    fn(f)
    recs[name][line] = "\t".join(f)
    return recs


def test_wrong_position_fails():
    s = _clean()
    name = s["name"][7]
    recs = _edit(_records(s, False), name,
                 lambda f: f.__setitem__(3, str(int(f[3]) + 1)))
    got = ref.compare(s, recs, GENOME, SC, False)
    assert got["record_faults"] == 1 and got["score_gap"] > 0
    assert got["suboptimal_reads"] == 1


def test_wrong_cigar_fails():
    s = _clean()
    name = s["name"][9]
    recs = _edit(_records(s, False), name,
                 lambda f: f.__setitem__(5, "70M1D81M"))
    got = ref.compare(s, recs, GENOME, SC, False)
    assert got["record_faults"] == 1


def test_altered_sequence_and_missing_read_fail():
    s = _clean()
    recs = _records(s, False)
    recs = _edit(recs, s["name"][3],
                 lambda f: f.__setitem__(9, "N" + f[9][1:]))
    del recs[s["name"][4]]
    got = ref.compare(s, recs, GENOME, SC, False)
    assert got["record_faults"] == 1 and got["missing"] == 1


def _mark(lines):
    out = []
    for line in lines:
        f = line.split("\t")
        f[1] = str(int(f[1]) | ref.F_DUP)
        out.append("\t".join(f))
    return out


def test_pairs_mates_and_duplicates():
    s = _clean(paired=True)
    recs = _records(s, True)
    later = sorted({nm for nm, g, f in zip(s["name"], s["group"], s["frag"])
                    if g >= 0 and f > min(ff for gg, ff in zip(
                        s["group"], s["frag"]) if gg == g)})
    assert later
    got = ref.compare(s, recs, GENOME, SC, True)
    assert got["record_faults"] == got["pair_faults"] == 0
    assert got["pair_checked"] > 100
    assert got["dup_checked"] == len(later)
    assert got["dup_unmarked"] == len(later)
    marked = {k: (_mark(v) if k in later else v) for k, v in recs.items()}
    assert ref.compare(s, marked, GENOME, SC, True)["dup_unmarked"] == 0
    bad = _edit(marked, s["name"][0],
                lambda f: f.__setitem__(7, str(int(f[7]) + 3)))
    assert ref.compare(s, bad, GENOME, SC, True)["record_faults"] == 1


def test_improper_pair_and_wrong_tlen_fail():
    s = _clean(paired=True)
    recs = _records(s, True)
    nm = s["name"][10]

    def unproper(lines):
        return ["\t".join([f[0], str(int(f[1]) & ~ref.F_PROPER)] + f[2:])
                for f in (x.split("\t") for x in lines)]

    def tlen(lines, d):
        out = []
        for x in lines:
            f = x.split("\t")
            t = int(f[8])
            f[8] = str(t + d if t > 0 else t - d)
            out.append("\t".join(f))
        return out
    got = ref.compare(s, dict(recs, **{nm: unproper(recs[nm])}), GENOME, SC,
                      True)
    assert got["pair_faults"] == 1 and got["record_faults"] == 0
    got = ref.compare(s, dict(recs, **{nm: tlen(recs[nm], 7)}), GENOME, SC,
                      True)
    assert got["pair_faults"] == 1 and got["record_faults"] == 0


def test_mapq_zero_in_a_unique_window_fails():
    s = _clean()
    recs = _records(s, False)
    got = ref.compare(s, recs, GENOME, SC, False, np.zeros((0, 2), np.int64))
    assert got["mapq_faults"] == 0 and got["mapq_checked"] == len(s["name"])
    name = s["name"][5]
    zero = _edit(recs, name, lambda f: f.__setitem__(4, "0"))
    got = ref.compare(s, zero, GENOME, SC, False, np.zeros((0, 2), np.int64))
    assert got["mapq_faults"] == 1
    # a repeat over the read's window exempts it
    k = s["name"].index(name)
    rep = np.array([[s["lo"][k] + 10, s["lo"][k] + 20]], np.int64)
    got = ref.compare(s, zero, GENOME, SC, False, rep)
    assert got["mapq_faults"] == 0
    assert got["mapq_checked"] == len(s["name"]) - 1


def test_covered_meets_spans():
    spans = np.array([[10, 20], [15, 100], [300, 310]], np.int64)
    lo = np.array([0, 0, 100, 99, 305, 310, 400])
    hi = np.array([10, 11, 300, 150, 306, 400, 500])
    assert ref.covered(spans, lo, hi).tolist() == [False, True, False,
                                                   True, True, False, False]


@pytest.mark.parametrize("cell", ["ecoli.pe151", "dm6.se151", "dm6.pe151"])
def test_control_is_not_correct(bench_kept, cell):
    """The control (ungapped alignment, duplicates marked, pairs proper
    with bwa's TLEN) fails the cell's suboptimal_reads limit on the reads
    with indels of one batch of the cell's size; of the other numbers
    only pair_faults (a clipped 5' end moves TLEN) may fail too."""
    import control
    import run
    _, config, mix, limits = run.resolve(bench_kept, cell)
    paired = mix["layout"] == "pe"
    b = readgen.make_batch(GENOME, mix, 17, 0, 0)
    per = b["per"]
    keep = np.flatnonzero(np.repeat(b["indel"], per))
    names = [readgen.name_str(0, k // per) for k in keep]
    s = dict(reads=[b["reads"][k] for k in keep], rev=b["rev"][keep],
             lo=b["lo"][keep], hi=b["hi"][keep],
             span=b["span"][keep // per],
             end_indel=b["end_indel"][keep // per], name=names,
             mate=[k % per for k in keep], group=np.full(len(keep), -1),
             frag=keep // per)
    recs = ref.ungapped_records(GENOME, s["reads"], s["rev"], s["lo"],
                                s["hi"], s["name"], config["scoring"], paired)
    recs = {k: [control._dup(x) for x in v] for k, v in recs.items()}
    got = ref.compare(s, recs, GENOME, config["scoring"], paired)
    assert got["suboptimal_reads"] > limits["suboptimal_reads"]
    assert all(got[k] <= limits[k] for k in limits
               if k not in ("suboptimal_reads", "pair_faults"))


def _fwd_moved(recs, name, cigar, shift):
    """The pair `name` with its forward record given `cigar` at POS +
    `shift`, and both TLENs as bwa would write them for that."""
    lines = [ref.parse_line(x) for x in recs[name]]
    fwd = next(r for r in lines if not r["flag"] & ref.F_REV)
    rev = next(r for r in lines if r["flag"] & ref.F_REV)
    fwd["pos"] += shift
    fwd["cigar"] = cigar
    a, b = ref.end5(fwd), ref.end5(rev)
    nm = ref.score_record(fwd, GENOME, SC)["nm"]
    out = []
    for x in recs[name]:
        f = x.split("\t")
        if int(f[1]) & ref.F_REV:
            f[7], f[8] = str(fwd["pos"]), str(-(b - a + 1))
        else:
            f[3], f[5], f[8] = str(fwd["pos"]), cigar, str(b - a + 1)
            f[11] = f"NM:i:{nm}"
        out.append("\t".join(f))
    return dict(recs, **{name: out})


def test_clipped_5_end_passes_misplaced_pair_fails():
    s = _clean(paired=True)
    recs = _records(s, True)
    k = next(i for i, nm in enumerate(s["name"])
             if not s["end_indel"][i] and s["span"][i] > 0
             and all(x.split("\t")[5] == "151M" for x in recs[nm]))
    name = s["name"][k]
    got = ref.compare(s, _fwd_moved(recs, name, "4S147M", 4), GENOME, SC,
                      True)
    assert got["pair_faults"] == 0 and got["record_faults"] == 0
    got = ref.compare(s, _fwd_moved(recs, name, "151M", -5), GENOME, SC,
                      True)
    assert got["pair_faults"] == 1
