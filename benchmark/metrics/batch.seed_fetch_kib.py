"""batch.seed_fetch_kib: KiB a batch that the seed collect copies from
the card (the packed bundle of the narrow machine; the meta, head or
dense refetch of the wide one; the SA values the seed program resolved;
a redo's results): the batch aligner's counter `seed_fetch_bytes` over
`seed_batches`. Nothing where the program has no such counter or seeded
no batch."""


def read(rec: dict):
    n = rec["stats"].get("seed_batches", 0)
    if not n or "seed_fetch_bytes" not in rec["stats"]:
        return None
    return rec["stats"]["seed_fetch_bytes"] / 1024.0 / n
