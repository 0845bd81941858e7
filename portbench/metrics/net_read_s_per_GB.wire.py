"""``net_read_s_per_GB.wire``: the port's ``net_read`` timer (the socket
client's loop thread reading ready supplier connections: ``recv_into``,
header decode and frame completion up to the dispatcher hand-off) summed
over the window's tasks, over the GB they emitted. None where the tasks'
records carry no such timer (a program without it)."""

from portbench import arith

TIMER = "net_read_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
