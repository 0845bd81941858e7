"""``net_recv_s_per_GB.wire``: the port's ``net_recv_time`` counter (the
``recv_into`` calls of the socket client's loop thread, summed inside
each ``net_read``) summed over the window's tasks, over the GB they
emitted. None where the tasks' records carry no such counter (a program
without it)."""

from portbench import arith

TIMER = "net_recv_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
