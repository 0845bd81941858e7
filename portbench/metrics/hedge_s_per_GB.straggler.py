"""``hedge_s_per_GB.straggler``: the port's ``fetch_hedge`` timer (one
speculated chunk's race, from its primary attempt's issue to the
completion that settles it: the straggler threshold's wait and the
winner's fetch) summed over the window's tasks, over the GB they
emitted. A task's races overlap one another and the rest of the fetch,
so the sum is their time, not the task's. None where the tasks' records
carry no such timer (a program without it)."""

from portbench import arith

TIMER = "fetch_hedge_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
