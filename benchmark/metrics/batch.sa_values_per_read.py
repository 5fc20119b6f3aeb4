"""batch.sa_values_per_read: SA values a read that the seed program's
fused walk (or its dense-SA gather) resolved on the card, so that the
batch's SA stage needs no probe for them: the batch aligner's counters
`sa_values` over `reads`. Nothing where the program has no such counter
or seeded no read."""


def read(rec: dict):
    n = rec["stats"].get("reads", 0)
    if not n or "sa_values" not in rec["stats"]:
        return None
    return rec["stats"]["sa_values"] / n
