"""batch.seed_wait_ms: milliseconds a batch the host spent in the device
reads of the seed stage: the seed collect's (`seed.fetch`) and the SA
lookups' (`sa.fetch`, absent where the seed program resolved every SA
value) program spans, over `stats["seed_batches"]`."""


def read(rec: dict):
    n = rec["stats"].get("seed_batches", 0)
    tr = rec["tracer"]
    if not n or "seed.fetch" not in tr:
        return None
    return 1e3 * (tr["seed.fetch"] + tr.get("sa.fetch", 0.0)) / n
