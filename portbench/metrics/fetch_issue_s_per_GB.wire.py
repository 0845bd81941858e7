"""``fetch_issue_s_per_GB.wire``: the port's ``fetch_issue`` timer (the
next chunk's request, issued by a completion's fetch loop, inside
``net_deliver`` on the wire) summed over the window's tasks, over the GB
they emitted. It fires for a segment's second chunk on, so a task whose
segments each fit one chunk has none: it reads 0 where the records carry
``fetch_crack`` (which every chunk fires), and None where they carry
neither (a program without the fetch completion's timers)."""

from portbench import arith

TIMER = "fetch_issue_time"
SPLIT = "fetch_crack_time"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(SPLIT in t.get("timers", ()) for t in tasks):
        return None
    return arith.per_gb(sum(t["timers"].get(TIMER, 0.0) for t in tasks),
                        sum(t["bytes"] for t in tasks))
