"""``merge_s_per_GB.reduce``: the port's ``merge_time`` (its phase timer
around the merge after the fetch: draining the stagers and finishing
the forest on the card) summed over the window's tasks, over the GB they
emitted."""

from portbench import arith


def read(run, record):
    tasks = record.get("tasks")
    if not tasks:
        return None
    return arith.per_gb(sum(t["merge_s"] for t in tasks),
                        sum(t["bytes"] for t in tasks))
