"""The reduce task thread's timers: ``task_setup`` (run()'s entry to the
fetch phase), ``merge_collect`` (the fetched segments collected for the
finish) and ``task_teardown`` (the emit's return to run()'s return), with
the phase timers ``fetch``, ``merge`` and ``emit_phase``: on a local task
of each overlapped finish they fire once and together explain the task's
wall, and the critical-path analyzer keeps them out of its counter
rows where ``metrics.PORT_TIMERS`` says so."""

import time

import numpy as np
import pytest

from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.mofserver.writer import MOFWriter
from uda_tpu_torch.utils import critpath
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import PORT_TIMERS, metrics

JOB = "tasktimers"
MAPS = 4
RECORDS = 20_000
# the task thread's outermost timers: none nests in another
OUTERMOST = ("fetch", "merge_collect", "merge", "emit_phase", "task_setup",
             "task_teardown", "client_stop")
TASK_TIMERS = ("task_setup", "merge_collect", "task_teardown")
# the overlapped finishes of run(): in memory, and over the run files
FINISHES = {"emit_stream": {},
            "streaming": {"uda.tpu.online.streaming": True}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``MAPS`` map outputs of one partition each: sorted records of a
    10-byte key and a 30-byte value."""
    root = str(tmp_path_factory.mktemp("maps"))
    rng = np.random.default_rng(30)
    w = MOFWriter(root, JOB)
    for m in range(MAPS):
        keys, vals = rng.bytes(10 * RECORDS), rng.bytes(30 * RECORDS)
        w.write(f"map_{m:03d}", [sorted(
            (keys[10 * i:10 * i + 10], vals[30 * i:30 * i + 30])
            for i in range(RECORDS))])
    return root


@pytest.mark.parametrize("spans", [False, True], ids=["counters", "spans"])
@pytest.mark.parametrize("finish", sorted(FINISHES))
def test_task_thread_timers_explain_the_wall(tree, finish, spans):
    if spans:
        metrics.enable_stats()
    cfg = Config(dict({"mapred.rdma.buf.size": 64}, **FINISHES[finish]))
    engine = DataEngine(DirIndexResolver(tree), cfg)
    out = bytearray()
    try:
        mm = MergeManager(LocalFetchClient(engine), "uda.tpu.RawBytes",
                          cfg, device="cpu")
        start = time.perf_counter()
        n = mm.run(JOB, [f"map_{m:03d}" for m in range(MAPS)], 0,
                   out.extend)
        wall = time.perf_counter() - start
    finally:
        engine.stop()
    assert n == len(out) > MAPS * RECORDS * 40
    timed = sum(metrics.get(t + "_time") for t in OUTERMOST)
    assert 0.8 * wall <= timed <= wall, (timed, wall)
    assert all(metrics.get(t + "_time") > 0 for t in TASK_TIMERS)
    if spans:
        names = [s["name"] for s in metrics.spans]
        assert all(names.count(t) == 1 for t in TASK_TIMERS), names
        assert names.count("fetch_handoff") == MAPS
    else:
        assert metrics.spans == []


def test_critpath_counter_rows_follow_the_registry():
    """Each port timer marked ``busy`` joins its bucket's row of the
    counter fallback, the others (nested, or holding other timers) stay
    out; the set-up and teardown's bucket, ``other``, has no row."""
    counters = {f"{name}_time": 1.0 for name in PORT_TIMERS}
    got = critpath.buckets_from_counters(counters)["buckets"]
    for bucket, total in got.items():
        want = sum(1 for t in PORT_TIMERS.values()
                   if t.busy and t.bucket == bucket)
        assert total == want, bucket
    assert "other" not in got
    assert not PORT_TIMERS["net_recv"].busy
    assert not any(PORT_TIMERS[t].busy
                   for t in ("fetch_crack", "fetch_issue", "fetch_handoff",
                             "emit_phase", "coding_decode"))
    assert all(PORT_TIMERS[t].busy for t in TASK_TIMERS + ("client_stop",))
    assert critpath.PORT_SPAN_BUCKETS == {
        name: t.bucket for name, t in PORT_TIMERS.items()}
