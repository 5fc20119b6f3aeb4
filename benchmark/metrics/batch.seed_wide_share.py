"""batch.seed_wide_share: the share of the window's batches that the
int64 (wide) seed machine seeded, the path of a genome of 2^31 BWT rows
and more: the batch aligner's counters `seed_wide` over `seed_batches`.
Nothing where the program has no such counter or seeded no batch."""


def read(rec: dict):
    n = rec["stats"].get("seed_batches", 0)
    if not n or "seed_wide" not in rec["stats"]:
        return None
    return rec["stats"]["seed_wide"] / n
