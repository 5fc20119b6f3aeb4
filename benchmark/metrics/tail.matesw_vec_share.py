"""tail.matesw_vec_share: the share of the native PE tail's mate-rescue
ksw_align2 calls that ran the striped pass: the program's counters
`tail_matesw_vec` over `tail_matesw`. Nothing where the program has no
such counter or the tail made no call (single-end cells)."""


def read(rec: dict):
    calls = rec["stats"].get("tail_matesw", 0)
    if not calls or "tail_matesw_vec" not in rec["stats"]:
        return None
    return rec["stats"]["tail_matesw_vec"] / calls
