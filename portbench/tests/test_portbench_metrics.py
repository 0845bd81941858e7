"""The metric arithmetic and the readers, on numbers worked out by hand."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import arith, harness, trace

ROOT = harness.PACKAGE_DIR.parent


def _read(name: str, record: dict, device="cuda", setup_s=1.5):
    run = SimpleNamespace(device=torch.device(device), setup_s=setup_s)
    return harness.load_module(ROOT, "metrics", name).read(run, record)


def test_sort_least_time_counts_each_record_twice():
    assert arith.SORT_BYTES_PER_RECORD == 208
    assert arith.sort_least_s(10 ** 8) == pytest.approx(208e8 / 3.35e12)
    assert arith.bound_s(3.35e12) == 1.0


@pytest.mark.parametrize("intervals,busy,spans", [
    ([], 0.0, []),
    ([(0, 2), (1, 3)], 3.0, [[0, 3]]),
    ([(5, 6), (0, 1), (0.5, 0.8)], 2.0, [[0, 1], [5, 6]]),
    ([(0, 4), (1, 2), (3, 5), (7, 8)], 6.0, [[0, 5], [7, 8]]),
])
def test_union_of_device_intervals(intervals, busy, spans):
    assert arith.merged(intervals) == spans
    assert sum(b - a for a, b in spans) == pytest.approx(busy)


def test_idle_and_per_gb():
    assert arith.idle_pct(0.25, 1.0) == 75.0
    assert arith.per_gb(3.0, 1.5e9) == 2.0
    assert arith.per_gb(3.0, 0) is None


SORT_REC = {"window_s": 10.0, "sorted_records": 10 ** 9, "peak_bytes": 4e10,
            "held_bytes": 1.5e10,
            "trace": {"busy_s": 9.0, "kernel_s": 2 * 208e8 / 3.35e12,
                      "window_s": 10.0, "device_events": 5,
                      "sorted_records": 10 ** 8}}
REDUCE_REC = {"window_s": 20.0, "consumed_bytes": 2e9, "peak_bytes": 1e9,
              "held_bytes": 0,
              "tasks": [{"wall_s": 3.0, "fetch_s": 1.0, "merge_s": 0.5,
                         "bytes": 0.5e9},
                        {"wall_s": 5.0, "fetch_s": 2.0, "merge_s": 0.5,
                         "bytes": 1.5e9}],
              "trace": {"busy_s": 0.2, "kernel_s": 0.2, "window_s": 25.0,
                        "device_events": 9}}


@pytest.mark.parametrize("name,record,want", [
    ("sort_GBps", SORT_REC, 10.0),
    ("task_MBps.reduce", REDUCE_REC, 100.0),
    ("peak_device_GB", SORT_REC, 25.0),
    ("peak_device_GB", REDUCE_REC, 1.0),
    ("setup_s", SORT_REC, 1.5),
    ("sort_kernels_roofline", SORT_REC, 50.0),
    ("device_idle_pct.sort", SORT_REC, 10.0),
    ("device_idle_pct.reduce", REDUCE_REC, 99.2),
    ("fetch_s_per_GB.reduce", REDUCE_REC, 1.5),
    ("merge_s_per_GB.reduce", REDUCE_REC, 0.5),
    ("emit_s_per_GB.reduce", REDUCE_REC, 2.0),
])
def test_readers(name, record, want):
    assert _read(name, record) == pytest.approx(want)


@pytest.mark.parametrize("name,record", [
    ("sort_GBps", REDUCE_REC), ("task_MBps.reduce", SORT_REC),
    ("sort_kernels_roofline", REDUCE_REC),
    ("sort_kernels_roofline", {**SORT_REC, "trace": None}),
    ("device_idle_pct.sort", {**SORT_REC, "trace": {**SORT_REC["trace"],
                                                   "device_events": 0}}),
    ("fetch_s_per_GB.reduce", SORT_REC),
    ("emit_s_per_GB.reduce", {**REDUCE_REC, "tasks": []}),
])
def test_readers_find_nothing_to_read(name, record):
    assert _read(name, record) is None


def test_no_device_number_on_the_cpu():
    assert _read("peak_device_GB", SORT_REC, device="cpu") is None


def test_every_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_module(ROOT, "metrics", m["name"]).read)


def test_trace_summary_of_a_host_only_profile():
    tr = trace.Trace().start()
    with torch.profiler.record_function("outer"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    tr.stop()
    s = trace.summarize(tr)
    assert s["device_events"] == 0 and s["busy_s"] == 0.0
    assert s["device_ops"] == [] and s["idle_gaps"] == []
    assert s["window_s"] == tr.window_s > 0


def test_the_trace_stops_after_its_seconds():
    tr = trace.Trace(seconds=0.05).start()
    tr.tick()
    assert tr.active
    time.sleep(0.06)
    tr.tick()
    assert not tr.active and tr.window_s >= 0.05
    tr.stop()


def test_host_label_is_the_innermost_operation():
    host = [(0, 100, "task"), (10, 20, "a"), (30, 60, "b"), (40, 50, "c"),
            (42, 44, "d")]
    assert trace._host_labels(host, [15, 43, 45, 55, 70, 150]) == [
        "a", "d", "c", "b", "task", trace.NO_HOST_OP]


def test_program_spans_are_recorded_and_given_back():
    from uda_tpu_torch.utils.metrics import metrics

    tr = trace.Trace().start()
    with metrics.timer("portbench_test_phase"):
        pass
    tr.stop()
    assert [sp[2] for sp in tr.spans] == ["portbench_test_phase"]
    assert tr.spans[0][0] <= tr.spans[0][1]
    assert not metrics.record_spans


def test_program_spans_land_inside_their_profiled_range():
    from uda_tpu_torch.utils.metrics import metrics

    tr = trace.Trace().start()
    for _ in range(3):
        with torch.profiler.record_function("outer"):
            time.sleep(0.05)
            with metrics.timer("inner"):
                time.sleep(0.05)
            time.sleep(0.05)
    tr.stop()
    spans = tr.spans
    _, host = trace.events(tr.prof)
    at = trace.profiler_clock(tr, host)
    outer = [h for h in host if h[2] == "outer"]
    assert len(outer) == len(spans) == 3
    for (start, end, _), (a, b, _) in zip(outer, spans):
        assert start + 45e6 < at(a) < at(b) < end - 45e6
