"""batch.seed_dispatch_ms: milliseconds a batch the host took to enqueue
the seed program (the program's `seed.dispatch` span, over
`stats["seed_batches"]`), wherever the enqueue ran."""


def read(rec: dict):
    n = rec["stats"].get("seed_batches", 0)
    if not n or "seed.dispatch" not in rec["tracer"]:
        return None
    return 1e3 * rec["tracer"]["seed.dispatch"] / n
