"""tail.matesw_per_pair: ksw_align2 calls of the native PE tail's mate
rescue a pair: the program's counters `tail_matesw` over `tail_pairs`.
Single-end cells have no pairs, so nothing to read."""


def read(rec: dict):
    pairs = rec["stats"].get("tail_pairs", 0)
    if not pairs or "tail_matesw" not in rec["stats"]:
        return None
    return rec["stats"]["tail_matesw"] / pairs
