"""The Text reduce driver: reduce tasks of a Hadoop ``sort`` of
``randomtextwriter`` output back to back, each one
``uda_tpu_torch.merger.merge_manager.MergeManager.run`` over the same map
outputs on the card, its stream handed to a consumer that copies each
block out as a reducer does.

The configuration gives the job: ``maps`` map outputs of
``records_per_map`` random-text records each, of which this task's
partition (``reduce_partition`` of ``reducers`` under Hadoop's
``HashPartitioner``) is kept, ``key_class`` and the task's ``conf``
(``portbench/gen_text.py`` makes them). They are written once in set-up,
under the run's temporary directory, by the benchmark's own writer.

Each task fetches through a ``LocalFetchClient`` from a ``DataEngine`` in
this process. The traffic's ``warm_tasks``, ``sample_tasks`` and
``sample_from``, the window, the consumer and the sampling are the reduce
driver's (``measure`` runs its loop). Each task's record also gets
``timers``, the task's change in every ``*_time`` counter of the port's
metrics hub, and ``counters``, its change in ``COUNTERS`` where the port
keeps them.
"""

from __future__ import annotations

import tempfile
import time
from types import SimpleNamespace

import numpy as np

from portbench import gen, gen_text, ifile
from portbench.drivers import reduce as local
from portbench.reference import reduce_text as reference

JOB = local.JOB
# the records merged, and the oversize-key tie-fix's blocks and records
COUNTERS = ("merge.records", "merge.tiefix_groups", "merge.tiefix_rows")


def setup(run):
    state = SimpleNamespace(tmp=None, engine=None, captured={},
                            timer_log=[])
    try:
        _setup(run, state)
    except BaseException:
        local.close(state)
        raise
    return state


def _setup(run, state) -> None:
    from uda_tpu_torch.merger import LocalFetchClient, MergeManager
    from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.metrics import metrics

    c, t = run.config, run.traffic
    dev = run.device
    state.tmp = tempfile.mkdtemp(prefix="portbench-text-")
    start = time.perf_counter()
    state.parts = gen_text.text_partitions(run.seed, c)
    mids = ifile.write_tree(state.tmp, JOB, state.parts)
    run.log(f"{len(state.parts)} map outputs, "
            f"{sum(p.size for p in state.parts)} B, made and written in "
            f"{time.perf_counter() - start:.3f} s")
    conf = Config(dict(c["conf"]))
    state.engine = DataEngine(DirIndexResolver(state.tmp), conf)

    def task(consumer, entries) -> None:
        before = metrics.snapshot()
        cl = LocalFetchClient(state.engine)
        try:
            MergeManager(cl, c["key_class"], conf, device=dev).run(
                JOB, entries, 0, consumer)
        finally:
            cl.stop()
            now = metrics.snapshot()
            state.timer_log.append((
                {k: v - before.get(k, 0.0) for k, v in now.items()
                 if k.endswith("_time") and "{" not in k},
                {k: now[k] - before.get(k, 0.0) for k in COUNTERS
                 if k in now}))

    state.task, state.entries = task, mids
    state.call = lambda consumer: task(consumer, mids)
    stream_len = sum(p.size for p in state.parts) + len(ifile.EOF_MARKER)
    rng = np.random.default_rng(gen.seed64(run.seed))
    state.sample = set(int(i) for i in rng.choice(
        int(t["sample_from"]), int(t["sample_tasks"]), replace=False))
    # the consumers' buffers, touched now so that no page is first
    # written inside the window
    state.bufs = {i: np.ones(stream_len, np.uint8)
                  for i in sorted(state.sample) + [-1]}
    walls = []
    for _ in range(int(t["warm_tasks"])):
        start = time.perf_counter()
        state.call(local.Sink(state.bufs[-1], 0.0))
        local._sync(dev)
        walls.append(round(time.perf_counter() - start, 3))
    run.log(f"warm task walls {walls}")


def measure(state, run) -> dict:
    """The reduce driver's window; each task's record gets its timers and
    counters where every task of the window ran through ``state.task``."""
    state.timer_log.clear()
    rec = local.measure(state, run)
    if len(state.timer_log) == len(rec["tasks"]):
        for task, (timers, counters) in zip(rec["tasks"], state.timer_log):
            task["timers"] = timers
            task["counters"] = counters
        sums = {k: sum(t["counters"].get(k, 0.0) for t in rec["tasks"])
                for k in COUNTERS}
        sums["emit_tiefix_time"] = sum(
            t["timers"].get("emit_tiefix_time", 0.0) for t in rec["tasks"])
        run.log(f"the window's tasks, summed: {sums}")
    return rec


def check(state, run, record) -> dict:
    """Every kept stream against the reference's stable merge of the
    partitions the benchmark made."""
    want = reference.merged_records(state.parts)
    # a window that reached no sampled task has nothing judged
    bad = 0 if state.captured else len(want)
    for got in state.captured.values():
        bad += reference.records_out_of_place(want, got)
    run.log(f"judged the streams of tasks {sorted(state.captured)}")
    return {"records_out_of_place": (bad, 0)}


close = local.close
