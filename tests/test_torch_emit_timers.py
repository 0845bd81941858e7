"""The emit's timers: ``emit_phase`` around every delivery loop of the
port's ``FramedEmitter`` and the stage timers inside it (``emit_readback``,
``emit_gather``, ``emit_frame``, ``emit_deliver``), on each emission path
of ``MergeManager.run``; the critical-path analyzer's reading of them
(``critpath.PORT_SPAN_BUCKETS``); and the spans ``device_trace`` writes
into its Chrome trace on the profiler's clock."""

import glob
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu.utils import critpath as jcritpath
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.mofserver.writer import MOFWriter
from uda_tpu_torch.utils import critpath
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import (TRACE_ANCHOR, TRACE_ANCHOR_END,
                                         device_trace, metrics)

JOB = "emittimers"
MAPS = 4
RECORDS = 40_000
STAGES = ("emit_readback", "emit_gather", "emit_frame", "emit_deliver")
TIMERS = ("emit_phase",) + STAGES

# each emission path of run(): its Config and the stages it has
PATHS = {
    # approach 1, overlap on: OverlappedMerger.emit_stream's slab loop
    "emit_stream": ({}, set(STAGES)),
    # streaming finish: the interleave over the run files (already framed)
    "streaming": ({"uda.tpu.online.streaming": True},
                  {"emit_readback", "emit_gather", "emit_deliver"}),
    # overlap off: merge_segments, then emit_batch's chunked framing
    "emit_batch": ({"uda.tpu.merge.overlap": False},
                   {"emit_frame", "emit_deliver"}),
}


def _tree(root: str) -> None:
    """``MAPS`` map outputs of one partition each, written by the port's
    MOFWriter: 40,000 sorted records of a 10-byte key and a 30-byte value
    (a 6.7 MB stream in 1 MiB blocks, the deployment's: the stages' work
    far outweighs the timers' own cost and the loop between them)."""
    rng = np.random.default_rng(7)
    w = MOFWriter(root, JOB)
    for m in range(MAPS):
        keys, vals = rng.bytes(10 * RECORDS), rng.bytes(30 * RECORDS)
        w.write(f"map_{m:03d}", [sorted(
            (keys[10 * i:10 * i + 10], vals[30 * i:30 * i + 30])
            for i in range(RECORDS))])


def _run(root: str, conf: dict) -> bytes:
    cfg = Config(dict({"mapred.rdma.buf.size": 1024}, **conf))
    engine = DataEngine(DirIndexResolver(root), cfg)
    out = bytearray()
    try:
        n = MergeManager(LocalFetchClient(engine), "uda.tpu.RawBytes", cfg,
                         device="cpu").run(
            JOB, [f"map_{m:03d}" for m in range(MAPS)], 0, out.extend)
    finally:
        engine.stop()
    assert n == len(out)
    return bytes(out)


def _check_partition() -> None:
    """The stages and the consumer's calls add up to the phase, less the
    loop's and the timers' own cost: within 5% (or 2 ms)."""
    phase = metrics.get("emit_phase_time")
    parts = sum(metrics.get(t + "_time") for t in STAGES + ("emit",))
    assert parts <= phase
    assert phase - parts <= max(0.05 * phase, 0.002), (phase, parts)


def _ancestors(span: dict, by_id: dict) -> list:
    names = []
    while span.get("parent") in by_id:
        span = by_id[span["parent"]]
        names.append(span["name"])
    return names


@pytest.mark.parametrize("path", sorted(PATHS))
def test_emit_timers_partition_the_phase(tmp_path, path):
    conf, stages = PATHS[path]
    _tree(str(tmp_path))
    # stats off: no span, the counters advance all the same
    quiet = _run(str(tmp_path), conf)
    assert metrics.spans == []
    assert all(metrics.get(t + "_time") > 0
               for t in ("emit_phase",) + tuple(stages))
    _check_partition()
    metrics.reset()
    metrics.enable_stats()
    loud = _run(str(tmp_path), conf)
    assert loud == quiet and len(loud) > 6 << 20  # several blocks
    spans = list(metrics.spans)
    by_id = {s["id"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert stages | {"emit_phase", "emit"} <= names
    assert not (set(STAGES) - stages) & names
    for s in spans:
        if s["name"] in STAGES or s["name"] == "emit":
            # no stage holds the consumer's call, nor another stage
            assert by_id[s["parent"]]["name"] == "emit_phase", s
        if s["name"] == "emit_phase":
            assert "reduce_task" in _ancestors(s, by_id)
    _check_partition()


def test_critpath_charges_the_emit_timers_to_serve():
    m = metrics
    m.enable_stats()
    with m.span("reduce_task"):
        with m.timer("fetch"):
            time.sleep(0.002)
        with m.timer("emit_phase"):
            for stage in STAGES:
                with m.timer(stage):
                    time.sleep(0.002)
            with m.timer("emit"):
                time.sleep(0.002)
    block = critpath.analyze(m.spans)
    root = next(s for s in m.spans if s["name"] == "reduce_task")
    emit = next(s for s in m.spans if s["name"] == "emit_phase")
    assert block["buckets"]["serve"]["critical_s"] == \
        pytest.approx(emit["dur"], abs=1e-6)
    assert block["buckets"]["other"]["busy_s"] == 0.0
    # what is left idle is the root's own time between its children
    assert block["idle_s"] < root["dur"] - emit["dur"]
    # the reference's analyzer has no such spans: it charges them "other"
    ref = jcritpath.analyze(m.spans)
    assert ref["buckets"]["other"]["critical_s"] == pytest.approx(
        block["buckets"]["serve"]["critical_s"]
        - ref["buckets"]["serve"]["critical_s"], abs=3e-6)
    # the port's own timers: the emit's, the socket client's, the fetch
    # completion's, the speculation race's, the reconstruction's and the
    # reduce task thread's
    assert set(critpath.PORT_SPAN_BUCKETS) == \
        set(TIMERS) | {"emit_tiefix", "net_read", "net_recv", "net_deliver",
                       "fetch_crack", "fetch_issue", "fetch_handoff",
                       "fetch_hedge", "coding_recover", "coding_decode",
                       "task_setup", "merge_collect", "task_teardown",
                       "client_stop"}
    assert not set(critpath.PORT_SPAN_BUCKETS) & set(critpath.SPAN_BUCKETS)
    assert set(critpath.PORT_SPAN_BUCKETS.values()) \
        <= set(critpath.BUCKET_PRIORITY)


def test_buckets_from_counters_adds_the_emit_stages_to_serve():
    counters = {"emit_time": 0.5, "supplier_read_time": 0.25,
                "emit_phase_time": 9.0, "emit_readback_time": 1.0,
                "emit_gather_time": 2.0, "emit_frame_time": 0.75,
                "emit_deliver_time": 0.125}
    got = critpath.buckets_from_counters(counters)
    assert got["buckets"]["serve"] == 4.625
    ref = jcritpath.buckets_from_counters(counters)
    assert ref["buckets"]["serve"] == 0.75
    assert {k: v for k, v in got["buckets"].items() if k != "serve"} == \
        {k: v for k, v in ref["buckets"].items() if k != "serve"}


def test_device_trace_puts_spans_on_the_profilers_clock(tmp_path):
    metrics.enable_stats()
    with device_trace(str(tmp_path)):
        with metrics.span("reduce_task"):
            with metrics.timer("emit_gather"):
                time.sleep(0.003)
                torch.ones(1 << 12).cumsum(0)
                time.sleep(0.003)
    files = glob.glob(str(tmp_path / "uda_trace_*.json"))
    assert len(files) == 1
    events = json.loads(Path(files[0]).read_text())["traceEvents"]
    marks = {e["name"]: e for e in events
             if e.get("name") in (TRACE_ANCHOR, TRACE_ANCHOR_END)}
    lo, hi = marks[TRACE_ANCHOR]["ts"], marks[TRACE_ANCHOR_END]["ts"]
    spans = {e["name"]: e for e in events if e.get("cat") == "uda_span"}
    assert set(spans) == {"reduce_task", "emit_gather"}
    for e in spans.values():
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e
    gather = spans["emit_gather"]
    assert gather["args"]["parent_id"] == spans["reduce_task"]["args"][
        "span_id"]
    # the op the span encloses lands inside it, 3 ms from either end
    op = next(e for e in events if e.get("name") == "aten::cumsum")
    assert gather["ts"] + 1000 < op["ts"]
    assert op["ts"] + op["dur"] < gather["ts"] + gather["dur"] - 1000
    # a lane of its own: no other event shares the spans' process
    lane = {e["pid"] for e in spans.values()}
    assert len(lane) == 1
    assert all(e.get("cat") == "uda_span" or e.get("ph") == "M"
               for e in events if e.get("pid") in lane)


def test_device_trace_without_spans_writes_the_profilers_trace(tmp_path):
    with device_trace(str(tmp_path)):
        torch.ones(8).cumsum(0)
    (f,) = glob.glob(str(tmp_path / "uda_trace_*.json"))
    events = json.loads(Path(f).read_text())["traceEvents"]
    assert not [e for e in events if e.get("cat") == "uda_span"]
    assert {TRACE_ANCHOR, TRACE_ANCHOR_END} <= {e.get("name")
                                                for e in events}
