"""The dead-supplier reduce cell (``reduce-tera-dead-supplier``) on the CPU,
with real supplier processes at a test size: 4 nodes of 2 maps, coded
rs:2:3, node 2's supplier killed. A sound run is correct against
``reference/reduce_dead.py`` and every task rebuilds node 2's 2
partitions with no fallback; a run whose reducer has reconstruction
turned off is not correct, in time; the control is not correct; the
readers of the recovery's timers read nothing from a program without
them.

Importing this file gives the configuration its test size in
``conftest.TINY_CONFIG`` (as ``portbench/conftest.py`` does the 4-node
one), so every test of the benchmark that makes a root through
``make_root`` in the same test run runs the cell at that size."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests.conftest import REPO, TINY_CONFIG, make_root, run_cell
from portbench.tests.test_portbench_imports import SOURCES

CELL = "reduce-tera-dead-supplier"
CONFIG = "terasort-reduce-4node-coded"
READERS = ("recover_s_per_GB.dead", "decode_s_per_GB.dead")
CHECKS = ("records_out_of_place", "tasks_rebuilt_otherwise",
          "recover_failures", "fallbacks")

# 4 nodes of 2 maps of 600 records: node 2 holds maps 4 and 5
TINY_CONFIG.setdefault(CONFIG, {"maps": 8, "maps_per_node": 2,
                                "records_per_segment": 600,
                                "reducers": 1 << 16})


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


def _reaped(state) -> bool:
    procs = state.suppliers_seen
    return len(procs) == 4 and all(p.returncode is not None for p in procs)


def _keep_procs(states: list):
    """A ``system`` hook that keeps the run's driver state and, in it,
    every supplier process it started, live or dead."""
    def hook(state, run):
        state.suppliers_seen = state.suppliers + state.dead
        states.append(state)
    return hook


def test_a_sound_run_is_correct_and_rebuilds_the_dead_nodes_maps(root):
    states: list = []
    rc, line = run_cell(root, CELL, seed=(1 << 33) + 5, seconds=1.0,
                        trace=1, system=_keep_procs(states))
    assert rc == 0 and line["correct"] is True, line
    assert line["failed"] == 0 and line["attempted"] >= 3
    assert set(line["checks"]) == set(CHECKS)
    assert all(v["value"] == 0 for v in line["checks"].values())
    for name in READERS:
        assert line["metrics"][name]["value"] > 0
    assert line["metrics"]["task_MBps.dead"]["value"] > 0
    state = states[0]
    # every task, the warm ones too, rebuilt node 2's two maps from 2
    # shard streams each
    assert state.rebuilt == 2 and len(state.counter_log) >= 3
    for c in state.counter_log:
        assert c["coding.reconstructed.partitions"] == 2
        assert c["coding.shard.fetches"] == 4
        assert c["coding.recover.failures"] == c["fallback.signals"] == 0
        assert c["coding.reconstructed.bytes"] == 2 * (600 * 104 + 2)
    assert _reaped(state)
    assert [p.returncode for p in state.dead] == [-9]
    assert all(p.returncode == 0 for p in state.suppliers_seen
               if p not in state.dead)


def test_without_reconstruction_the_check_fails_in_time(root):
    """The map outputs coded as before, the reducer's scheme emptied: the
    dead node's maps fail every task, which falls back."""
    conf = json.loads((REPO / "portbench/configs" / f"{CONFIG}.json")
                      .read_text())["conf"]
    root = make_root(root, configs={CONFIG: {
        "conf": dict(conf, **{"uda.tpu.coding.scheme": ""})}})
    states: list = []
    start = time.perf_counter()
    rc, line = run_cell(root, CELL, seconds=0.5, system=_keep_procs(states))
    assert time.perf_counter() - start < 120
    assert rc == 0 and line["correct"] is False
    assert line["failed"] == line["attempted"] >= 1
    checks = line["checks"]
    assert checks["tasks_rebuilt_otherwise"]["value"] == line["attempted"]
    assert checks["fallbacks"]["value"] == line["attempted"]
    assert _reaped(states[0])


def test_the_control_is_not_correct(root, capsys):
    from portbench import control

    rc = control.main(["--workload", CELL, "--seeds", "5,6",
                       "--seconds", "0.2"], root=root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 2
    for x in lines:
        checks = x["control"]["checks"]
        assert checks["records_out_of_place"]["value"] > 0
        # not correct by the stream, not by every limit
        assert checks["fallbacks"]["value"] == 0


def test_the_recovery_readers_are_silent_without_the_timers():
    run = SimpleNamespace()
    task = {"wall_s": 3.0, "fetch_s": 1.0, "merge_s": 0.5, "bytes": 5e8}
    timed = {"coding_recover_time": 0.25, "coding_decode_time": 0.125,
             "fetch_time": 1.0}
    for name, want in zip(READERS, (0.5, 0.25)):
        read = harness.load_module(REPO, "metrics", name).read
        assert read(run, {"tasks": [dict(task, timers=timed)] * 2}) == want
        # the parent's program: the wire's timers without the recovery's
        assert read(run, {"tasks": [dict(task, timers={
            "fetch_time": 1.0, "net_read_time": 0.5})]}) is None
        assert read(run, {"tasks": [task]}) is None
        assert read(run, {"tasks": []}) is None
        assert read(run, {"sorted_records": 10}) is None
    rate = harness.load_module(REPO, "metrics", "task_MBps.dead").read
    assert rate(run, {"consumed_bytes": 5e8, "window_s": 5.0}) == 100.0
    assert rate(run, {"sorted_records": 10}) is None


def test_the_import_scan_covers_the_driver_and_its_reference():
    package = REPO / "portbench"
    assert package / "drivers" / "reduce_dead.py" in SOURCES
    assert package / "reference" / "reduce_dead.py" in SOURCES
