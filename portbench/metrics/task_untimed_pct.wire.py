"""``task_untimed_pct.wire``: the share of the window's task walls that
no timer of the task's thread explains, in %: 100 x (the walls' sum less
the sum of the thread's outermost timers) over the walls' sum. The
outermost timers are the port's ``fetch``, ``merge_collect``, ``merge``,
``emit_phase``, ``task_setup``, ``task_teardown`` and ``client_stop``:
they do not nest in one another. None where the tasks' records lack any
of them (a program without them)."""

TIMERS = ("fetch_time", "merge_collect_time", "merge_time",
          "emit_phase_time", "task_setup_time", "task_teardown_time",
          "client_stop_time")


def read(run, record):
    tasks = record.get("tasks")
    if not tasks or not all(k in t.get("timers", ()) for t in tasks
                            for k in TIMERS):
        return None
    wall = sum(t["wall_s"] for t in tasks)
    timed = sum(t["timers"][k] for t in tasks for k in TIMERS)
    return 100.0 * (wall - timed) / wall
