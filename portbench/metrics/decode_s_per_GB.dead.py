"""``decode_s_per_GB.dead``: the port's ``coding_decode`` timer (one
stripe's GF(2^8) Reed-Solomon decode on the host, ``coding.rs.decode``,
inside the ``coding_recover`` rung) summed over the window's tasks, over
the GB they emitted. None where the tasks' records carry no such timer
(a program without it)."""

from portbench import arith

TIMER = "coding_decode_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
