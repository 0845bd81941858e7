"""``fetch_s_per_GB.reduce``: the port's ``fetch_time`` (its phase timer
around the fetch of every segment, with the overlapped merge's staging
inside it) summed over the window's tasks, over the GB they emitted."""

from portbench import arith


def read(run, record):
    tasks = record.get("tasks")
    if not tasks:
        return None
    return arith.per_gb(sum(t["fetch_s"] for t in tasks),
                        sum(t["bytes"] for t in tasks))
