"""``emit_s_per_GB.reduce``: each task's wall less its ``fetch_time`` and
``merge_time``, summed over the window's tasks, over the GB they emitted.
Derived: the port has no span around the emit yet."""

from portbench import arith


def read(run, record):
    tasks = record.get("tasks")
    if not tasks:
        return None
    return arith.per_gb(
        sum(t["wall_s"] - t["fetch_s"] - t["merge_s"] for t in tasks),
        sum(t["bytes"] for t in tasks))
