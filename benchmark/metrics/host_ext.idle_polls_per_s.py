"""host_ext.idle_polls_per_s: the harvester threads' steals that found
no read to run (each followed by a 1 ms wait) a second of the window:
the program's counter `harvest_idle_polls`."""


def read(rec: dict):
    w = rec["window_s"]
    if w <= 0 or "harvest_idle_polls" not in rec["stats"]:
        return None
    return rec["stats"]["harvest_idle_polls"] / w
