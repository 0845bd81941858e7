"""``recover_s_per_GB.dead``: the port's ``coding_recover`` timer (one
partition's reconstruction, from a Segment's reconstruction rung to the
decoded partition reaching it: its shard streams over the live
suppliers and the decode) summed over the window's tasks, over the GB
they emitted. The rebuilt partitions' rungs overlap one another and the
rest of the fetch, so the sum is their time, not the task's. None where
the tasks' records carry no such timer (a program without it)."""

from portbench import arith

TIMER = "coding_recover_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
