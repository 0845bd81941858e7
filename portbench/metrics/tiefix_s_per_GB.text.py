"""``tiefix_s_per_GB.text``: the port's ``emit_tiefix`` timer (the emit's
re-sort of each block of equal-prefix keys past the carried width, by
their whole content) summed over the window's tasks, over the GB they
emitted. None where the tasks' records carry no such timer (a program
without the tie-fix)."""

from portbench import arith

TIMER = "emit_tiefix_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(TIMER in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"][TIMER] for t in tasks),
                        sum(t["bytes"] for t in tasks))
