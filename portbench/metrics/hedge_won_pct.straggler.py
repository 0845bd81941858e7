"""``hedge_won_pct.straggler``: the share of the window's speculated
chunks whose duplicate, sent to the map's other copy, answered first
(``fetch.speculation.won`` over ``fetch.speculated``, summed over the
window's tasks), in percent. A race lost is a duplicate the primary beat:
a healthy node's chunk hedged to the slow copy, or a race decided by
the reducer's own queue. None where the tasks' records carry no such
counters, or no chunk was speculated."""

WON, SPECULATED = "fetch.speculation.won", "fetch.speculated"


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all({WON, SPECULATED} <= set(t.get("counters", ()))
                            for t in tasks):
        return None
    speculated = sum(t["counters"][SPECULATED] for t in tasks)
    if not speculated:
        return None
    return 100.0 * sum(t["counters"][WON] for t in tasks) / speculated
