"""``fetch_handoff_s_per_GB.wire``: the port's ``fetch_handoff`` timer (a
finished Segment's ``on_done`` upcall, the overlapped merger's ``feed``
with its waits on the in-flight budget and the bounded queue: the time
the fetch completions wait on the merge's staging, inside
``net_deliver`` on the wire) summed over the window's tasks, over the GB
they emitted. None where the tasks' records carry no such timer (a
program without it)."""

from portbench import arith

TIMER = "fetch_handoff_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
