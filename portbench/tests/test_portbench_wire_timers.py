"""The readers of the wire cell's splits: the fetch completions' crack,
hand-off and next request, the client loop's recv, and the share of a
task that no timer of the task thread explains. Each on numbers worked
out by hand, silent on records without its timer (a program without
the splits), and non-zero on a real run of the wire driver at a test
size whose segments take several chunks."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import make_root, run_cell

ROOT = harness.PACKAGE_DIR.parent
CELL = "reduce-tera-wire-4sup"
CONFIG = "terasort-reduce-4node"
READERS = ("fetch_crack_s_per_GB.wire", "fetch_handoff_s_per_GB.wire",
           "fetch_issue_s_per_GB.wire", "net_recv_s_per_GB.wire",
           "task_untimed_pct.wire")


def _read(name: str, record: dict):
    run = SimpleNamespace(device=torch.device("cuda"), setup_s=1.5)
    return harness.load_module(ROOT, "metrics", name).read(run, record)


TASKS = [{"wall_s": 3.0, "fetch_s": 1.0, "merge_s": 0.5, "bytes": 0.5e9},
         {"wall_s": 5.0, "fetch_s": 2.0, "merge_s": 0.5, "bytes": 1.5e9}]
REDUCE_REC = {"window_s": 20.0, "consumed_bytes": 2e9, "peak_bytes": 1e9,
              "held_bytes": 0, "tasks": TASKS,
              "trace": {"busy_s": 0.2, "kernel_s": 0.2, "window_s": 25.0,
                        "device_events": 9}}
SORT_REC = {"window_s": 10.0, "sorted_records": 10 ** 9, "peak_bytes": 4e10,
            "held_bytes": 1.5e10}
# each task's change in the port's timers; the task thread's outermost
# timers leave 0.375 of the 8 s of walls untimed
WIRE_REC = {**REDUCE_REC, "tasks": [
    {**TASKS[0], "timers": {
        "fetch_crack_time": 0.25, "fetch_handoff_time": 0.5,
        "fetch_issue_time": 0.125, "net_recv_time": 0.75,
        "fetch_time": 1.0, "merge_collect_time": 0.0625,
        "merge_time": 0.5, "emit_phase_time": 1.0,
        "task_setup_time": 0.0625, "task_teardown_time": 0.0625,
        "client_stop_time": 0.0625}},
    {**TASKS[1], "timers": {
        "fetch_crack_time": 0.75, "fetch_handoff_time": 1.5,
        "fetch_issue_time": 0.375, "net_recv_time": 1.25,
        "fetch_time": 2.0, "merge_collect_time": 0.125,
        "merge_time": 0.5, "emit_phase_time": 2.0,
        "task_setup_time": 0.125, "task_teardown_time": 0.0625,
        "client_stop_time": 0.0625}}]}
# a program without the splits: the timers it has, none of these
PARENT_WIRE_REC = {**REDUCE_REC, "tasks": [
    {**t, "timers": {"fetch_time": t["fetch_s"], "merge_time": t["merge_s"],
                     "emit_phase_time": 1.0, "net_read_time": 0.5,
                     "net_deliver_time": 0.5}}
    for t in TASKS]}
# segments of one chunk each: no next request
ONE_CHUNK_REC = {**WIRE_REC, "tasks": [
    {**t, "timers": {k: v for k, v in t["timers"].items()
                     if k != "fetch_issue_time"}}
    for t in WIRE_REC["tasks"]]}


@pytest.mark.parametrize("name,record,want", [
    ("fetch_crack_s_per_GB.wire", WIRE_REC, 0.5),
    ("fetch_handoff_s_per_GB.wire", WIRE_REC, 1.0),
    ("fetch_issue_s_per_GB.wire", WIRE_REC, 0.25),
    ("net_recv_s_per_GB.wire", WIRE_REC, 1.0),
    ("task_untimed_pct.wire", WIRE_REC, 4.6875),
    ("fetch_issue_s_per_GB.wire", ONE_CHUNK_REC, 0.0),
])
def test_split_readers(name, record, want):
    assert _read(name, record) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("record", [
    PARENT_WIRE_REC, REDUCE_REC, SORT_REC, {**REDUCE_REC, "tasks": []}],
    ids=["parent_timers", "no_timers", "sort", "no_tasks"])
def test_split_readers_find_nothing_to_read(name, record):
    assert _read(name, record) is None


@pytest.fixture
def root(tmp_path):
    """4 nodes of 2 maps each, 600 records a segment, in 16 KiB chunks
    (several a segment, so a completion issues the next request)."""
    conf = {"mapred.rdma.buf.size": 16,
            "uda.tpu.net.zerocopy.mode": "sendfile"}
    return make_root(tmp_path, configs={CONFIG: {
        "maps": 8, "maps_per_node": 2, "conf": conf}})


def test_a_sound_run_reads_the_splits(root):
    rc, line = run_cell(root, CELL, seed=(1 << 33) + 11, seconds=1.0,
                        trace=1)
    assert rc == 0 and line["correct"] is True, line
    for name in READERS[:4]:
        assert line["metrics"][name]["value"] > 0, name
    assert 0 < line["metrics"]["task_untimed_pct.wire"]["value"] < 100
