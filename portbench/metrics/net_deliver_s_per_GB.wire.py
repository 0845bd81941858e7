"""``net_deliver_s_per_GB.wire``: the port's ``net_deliver`` timer (the
socket client's dispatcher thread running each fetch's completion upcall,
a Segment's ``on_complete``) summed over the window's tasks, over the GB
they emitted. None where the tasks' records carry no such timer (a
program without it)."""

from portbench import arith

TIMER = "net_deliver_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
