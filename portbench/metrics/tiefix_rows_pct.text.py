"""``tiefix_rows_pct.text``: the records of the window's tasks that the
port's tie-fix re-sorted on the host (``merge.tiefix_rows``), over the
records they merged (``merge.records``), in percent: the share of the
order the card's merge left to the host. None where the tasks' records
carry no such counter (a program without the tie-fix)."""

COUNTERS = ("merge.tiefix_rows", "merge.records")


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(k in t.get("counters", ())
                            for t in tasks for k in COUNTERS):
        return None
    merged = sum(t["counters"]["merge.records"] for t in tasks)
    if merged <= 0:
        return None
    return 100.0 * sum(t["counters"]["merge.tiefix_rows"]
                       for t in tasks) / merged
