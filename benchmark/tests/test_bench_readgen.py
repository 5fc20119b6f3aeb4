"""The read generator: repeatable for a seed, different across seeds,
and the reads it writes are the reads it describes."""

import numpy as np

import readgen

MIX_SE = dict(layout="se", read_len=151, batch_reads=512, sub_rate=0.01,
              mut_rate=0.001, indel_frac=0.15, indel_ext=0.3, dup_frac=0.0)
MIX_PE = dict(MIX_SE, layout="pe", frag_mean=400, frag_sd=40,
              dup_frac=0.02)
GENOME = np.random.default_rng(7).integers(0, 4, 200_000).astype(np.uint8)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_same_seed_same_batch():
    for mix in (MIX_SE, MIX_PE):
        a = readgen.make_batch(GENOME, mix, 2**31 + 11, 0, 3)
        b = readgen.make_batch(GENOME, mix, 2**31 + 11, 0, 3)
        assert _same(a, b)
        assert readgen.fastq_bytes(a, 0, 0) == readgen.fastq_bytes(b, 0, 0)


def test_seeds_streams_batches_differ():
    a = readgen.make_batch(GENOME, MIX_PE, 5, 0, 0)
    for other in ((6, 0, 0), (5, 1, 0), (5, 0, 1)):
        b = readgen.make_batch(GENOME, MIX_PE, *other)
        assert not np.array_equal(a["reads"], b["reads"])


def test_negative_and_large_seeds():
    for seed in (-1, 2**40 + 3):
        assert readgen.make_batch(GENOME, MIX_SE, seed, 0, 0)["reads"].shape \
            == (512, 151)


def test_reads_come_from_their_windows():
    b = readgen.make_batch(GENOME, dict(MIX_SE, sub_rate=0.0,
                                        mut_rate=0.0), 9, 0, 0)
    comp = np.array([3, 2, 1, 0], np.uint8)
    for k in range(0, 512, 37):
        r = b["reads"][k]
        fwd = comp[r[::-1]] if b["rev"][k] else r
        lo = b["lo"][k] + readgen.MARGIN
        assert np.array_equal(fwd, GENOME[lo:lo + 151])
    assert not b["indel"].any()


def test_error_and_mutation_rates():
    b = readgen.make_batch(GENOME, dict(MIX_SE, batch_reads=4096), 1, 0, 0)
    assert 0.01 < b["indel"].mean() < 0.05   # 151 x 0.001 x 0.15 = 2.3%
    clean = readgen.make_batch(GENOME, dict(MIX_SE, batch_reads=4096,
                                            mut_rate=0.0, sub_rate=0.0),
                               1, 0, 0)
    assert np.array_equal(clean["lo"], b["lo"])


def test_pairs_are_fr_and_duplicates_exact_from_any_earlier_batch():
    gen = readgen.Batches(GENOME, dict(MIX_PE, batch_reads=1024), 3, 0)
    bts = [gen.batch(b) for b in range(4)]
    n = 512
    assert np.array_equal(bts[0]["rev"][0::2], ~bts[0]["rev"][1::2])
    earlier = 0
    for b, bt in enumerate(bts):
        dst = np.flatnonzero(bt["dup_of"] >= 0)
        assert 3 < len(dst) < 25                  # 2% of 512 fragments
        for d in dst:
            s = int(bt["dup_of"][d])
            assert s < b * n + d
            sb, sj = divmod(s, n)
            earlier += sb < b
            src = bts[sb]
            for k in ("reads", "rev", "lo", "hi"):
                assert np.array_equal(bt[k][2 * d:2 * d + 2],
                                      src[k][2 * sj:2 * sj + 2])
            assert bt["span"][d] == src["span"][sj]
    assert earlier > 10                 # most sources lie in earlier batches
    again = readgen.Batches(GENOME, dict(MIX_PE, batch_reads=1024), 3, 0)
    assert all(_same(a, again.batch(b)) for b, a in enumerate(bts))


def test_span_is_the_fragment_on_the_genome():
    """With indels only and no errors, a pair's outer bases are the
    genome's at the fragment's start and at start + span - 1 (but where
    a deletion takes the fragment's first base: rare)."""
    mix = dict(MIX_PE, batch_reads=4096, sub_rate=0.0, mut_rate=0.01,
               indel_frac=1.0, dup_frac=0.0)
    b = readgen.make_batch(GENOME, mix, 8, 0, 0)
    comp = np.array([3, 2, 1, 0], np.uint8)
    fwd = np.where(b["rev"][0::2][:, None], b["reads"][1::2],
                   b["reads"][0::2])
    bwd = np.where(b["rev"][0::2][:, None], b["reads"][0::2],
                   b["reads"][1::2])
    start = b["lo"][0::2] + readgen.MARGIN
    flen = b["hi"][0::2] - b["lo"][0::2] - readgen.PAD - 2 * readgen.MARGIN
    ok = b["span"] > 0
    assert b["indel"].mean() > 0.9 and ok.mean() > 0.9
    assert (b["span"][~b["indel"]] == flen[~b["indel"]]).all()
    assert (b["span"][b["indel"]] != flen[b["indel"]]).mean() > 0.5
    first = fwd[ok, 0] == GENOME[start[ok]]
    last = comp[bwd[ok, 0]] == GENOME[start[ok] + b["span"][ok] - 1]
    assert (~first).mean() < 0.01 and (~last).mean() < 0.01


def test_places_group_fragments_from_one_place():
    lo = np.array([5, 9, 5, 5, 9, 70])
    hi = np.array([600, 700, 600, 601, 700, 800])
    assert readgen.places(lo, hi).tolist()[5] == -1
    g = readgen.places(lo, hi)
    assert g[0] == g[2] >= 0 and g[1] == g[4] >= 0 and g[0] != g[1]
    assert g[3] == -1


def test_fastq_records():
    b = readgen.make_batch(GENOME, MIX_PE, 4, 0, 2)
    text = readgen.fastq_bytes(b, 0, 1).decode().split("\n")
    assert text[0] == "@" + readgen.name_str(0, 2 * 256)
    assert text[1] == "".join("ACGT"[x] for x in b["reads"][1])
    assert text[2] == "+" and text[3] == "I" * 151
    assert len(text) == 4 * 256 + 1 and text[-1] == ""
