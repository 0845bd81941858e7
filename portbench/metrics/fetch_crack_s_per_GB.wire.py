"""``fetch_crack_s_per_GB.wire``: the port's ``fetch_crack`` timer (a
Segment's carry concat, ``crack_partial`` and carry slice of each chunk,
inside the dispatcher thread's ``net_deliver`` on the wire) summed over
the window's tasks, over the GB they emitted. None where the tasks'
records carry no such timer (a program without it)."""

from portbench import arith

TIMER = "fetch_crack_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
