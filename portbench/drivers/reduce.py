"""The reduce driver: TeraSort reduce tasks back to back, each one
``uda_tpu_torch.merger.merge_manager.MergeManager.run`` over the same map
outputs on the card, its stream handed to a consumer that copies each
block out as a reducer does.

The configuration gives the job: ``maps`` map outputs of
``records_per_segment`` framed records for this task's partition
(``reduce_partition`` of ``reducers`` under a total-order partitioner),
``key_class`` and the task's ``conf``. They are written once in set-up,
under the run's temporary directory, by the benchmark's own writer.

Each task fetches through a ``LocalFetchClient`` from a ``DataEngine`` in
this process. Traffic parameters: ``warm_tasks`` run in set-up;
``sample_tasks`` of the window's first ``sample_from`` tasks, drawn from
the seed, keep their whole stream to be judged after the window.

``consumed_bytes`` counts the bytes the consumer received before the
deadline. The task running at the deadline finishes after it, and its
later bytes are not counted.
"""

from __future__ import annotations

import resource
import shutil
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from portbench import gen, ifile, trace
from portbench.reference import reduce as reference

JOB = "portbench"
COUNTER_PREFIXES = ("fetch.", "io.", "stage.")


class Sink:
    """A reducer's consumer: copies each block into ``buf`` (past its end,
    into a list) and counts the bytes that arrive before ``deadline``."""

    def __init__(self, buf: np.ndarray, deadline: float):
        self.buf = buf
        self.deadline = deadline
        self.pos = 0
        self.counted = 0
        self.extra: list = []

    def __call__(self, block) -> None:
        data = np.frombuffer(block, np.uint8)
        end = self.pos + data.size
        if end <= self.buf.size:
            self.buf[self.pos:end] = data
        else:
            self.extra.append(data.tobytes())
        self.pos = end
        if time.perf_counter() < self.deadline:
            self.counted += data.size

    def stream(self) -> bytes:
        if not self.extra:
            return self.buf[:self.pos]
        return self.buf.tobytes() + b"".join(self.extra)


def setup(run):
    state = SimpleNamespace(tmp=None, engine=None, captured={})
    try:
        _setup(run, state)
    except BaseException:
        close(state)
        raise
    return state


def _setup(run, state) -> None:
    from uda_tpu_torch.merger import LocalFetchClient, MergeManager
    from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
    from uda_tpu_torch.utils.config import Config

    c, t = run.config, run.traffic
    dev = run.device
    state.tmp = tempfile.mkdtemp(prefix="portbench-")
    state.parts = gen.tera_partitions(
        run.seed, int(c["maps"]), int(c["records_per_segment"]),
        int(c["reducers"]), int(c["reduce_partition"]))
    mids = ifile.write_tree(state.tmp, JOB, state.parts)
    conf = Config(dict(c["conf"]))
    state.engine = DataEngine(DirIndexResolver(state.tmp), conf)

    def task(consumer, entries) -> None:
        cl = LocalFetchClient(state.engine)
        try:
            MergeManager(cl, c["key_class"], conf, device=dev).run(
                JOB, entries, 0, consumer)
        finally:
            cl.stop()

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
        state.call(Sink(state.bufs[-1], 0.0))
        _sync(dev)
        walls.append(round(time.perf_counter() - start, 3))
    run.log(f"warm task walls {walls}")


def host_clocks() -> dict:
    """The process's CPU seconds, all threads and the kernel's share: what
    a slow run's lines are read by."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime}


def _delta(now: dict, then: dict) -> dict:
    return {k: round(now[k] - then[k], 3) for k in now if k in then}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(state, run) -> dict:
    from uda_tpu_torch import native
    from uda_tpu_torch.ops import _build
    from uda_tpu_torch.utils.errors import FallbackSignal
    from uda_tpu_torch.utils.metrics import metrics

    dev = run.device
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    native.reset_calls()
    tasks = []
    consumed = 0
    tr = trace.Trace().start() if run.trace else None
    clocks0 = host_clocks()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while time.perf_counter() < deadline:
        i = len(tasks)
        sink = Sink(state.bufs[i if i in state.sample else -1], deadline)
        fetch0 = metrics.get("fetch_time")
        merge0 = metrics.get("merge_time")
        clocks = host_clocks()
        start = time.perf_counter()
        error = None
        try:
            state.call(sink)
        except FallbackSignal as e:
            error = e
            traceback.print_exc()
        _sync(dev)
        tasks.append({"wall_s": time.perf_counter() - start,
                      "fetch_s": metrics.get("fetch_time") - fetch0,
                      "merge_s": metrics.get("merge_time") - merge0,
                      "bytes": sink.pos, "error": error,
                      "host": _delta(host_clocks(), clocks)})
        consumed += sink.counted
        if i in state.sample:
            state.captured[i] = sink.stream()
        if tr is not None:
            tr.tick()
    past_s = time.perf_counter() - deadline
    window_clocks = _delta(host_clocks(), clocks0)
    if tr is not None:
        tr.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = {k: _build.launches[k] for k in
                ("merge_pass", "merge_partition")}
    run.log(f"window {run.seconds:.3f} s: {len(tasks)} tasks (the last "
            f"ends {past_s:.3f} s past it), "
            f"{consumed} B consumed in it; task walls "
            f"{[round(t['wall_s'], 3) for t in tasks]}; K1 launches "
            f"{launches}; native calls {dict(native.calls)}")
    counters = {k: v for k, v in metrics.snapshot().items()
                if k.startswith(COUNTER_PREFIXES) and "{" not in k}
    run.log(f"the port's counters since the run started: {counters}")
    run.log(f"host over the window and its last task: {window_clocks}; "
            f"task CPU s {[t['host']['cpu_s'] for t in tasks]}")
    # the kept streams are on the host: the harness holds nothing on the
    # card, so the whole peak is the task's
    rec = {"window_s": run.seconds, "attempted": len(tasks),
           "failed": sum(t["error"] is not None for t in tasks),
           "consumed_bytes": consumed, "tasks": tasks, "peak_bytes": peak,
           "held_bytes": 0, "launches": launches}
    if tr is not None:
        rec["trace"] = trace.summarize(tr)
    return rec


def check(state, run, record) -> dict:
    """Every kept stream against the reference's stable merge of the
    partitions the benchmark made."""
    want = reference.merged_records(state.parts)
    # a window that reached no sampled task has nothing judged
    bad = 0 if state.captured else want.shape[0]
    for got in state.captured.values():
        bad += reference.records_out_of_place(want, got)
    run.log(f"judged the streams of tasks {sorted(state.captured)}")
    return {"records_out_of_place": (bad, 0)}


def close(state) -> None:
    if state.engine is not None:
        state.engine.stop()
        state.engine = None
    if state.tmp is not None:
        shutil.rmtree(state.tmp, ignore_errors=True)
        state.tmp = None
