"""``hedged_bytes_pct.straggler``: the share of the window's fetched bytes
that a source which won a speculation race served, from the winning
chunk to the end of its segment (the port's ``fetch.hedged.bytes`` over
``fetch.bytes``, summed over the window's tasks), in percent. With one
node of four slow and every segment of it switched to its replica at its
first chunk, about a quarter. None where the tasks' records carry no
such counters (a program without ``fetch.hedged.bytes``), or no byte was
fetched."""

HEDGED, FETCHED = "fetch.hedged.bytes", "fetch.bytes"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all({HEDGED, FETCHED} <= set(t.get("counters", ()))
                            for t in tasks):
        return None
    fetched = sum(t["counters"][FETCHED] for t in tasks)
    if not fetched:
        return None
    return 100.0 * sum(t["counters"][HEDGED] for t in tasks) / fetched
