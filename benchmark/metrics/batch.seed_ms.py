"""batch.seed_ms: milliseconds of the seed stage a batch, as the batch
aligner counts them (`stats["seed_s"] / stats["seed_batches"]`, each
batch's dispatch counted once), over the window."""


def read(rec: dict):
    n = rec["stats"].get("seed_batches", 0)
    return 1e3 * rec["stats"]["seed_s"] / n if n else None
