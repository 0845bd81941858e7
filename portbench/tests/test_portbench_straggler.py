"""The straggler reduce cell (``reduce-tera-straggler``) on the CPU, with
real supplier processes at a test size: 4 nodes of 2 maps, every map
output on its node and the next, node 1's supplier holding each chunk read
300 ms. A sound run is correct against ``reference/reduce_straggler.py``
and every task wins node 1's two races on node 2; the control and a
planted fault are not correct; with speculation off every task is
unhedged; the readers of the hedge's timer and counters read nothing from
a program without them.

Importing this file gives the configuration its test size in
``conftest.TINY_CONFIG`` (as ``portbench/conftest.py`` does the 4-node
one), so every test of the benchmark that makes a root through
``make_root`` in the same test run runs the cell at that size."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.reference import reduce_straggler as reference
from portbench.tests.conftest import REPO, TINY_CONFIG, make_root, run_cell
from portbench.tests.test_portbench_imports import SOURCES, imported_tops

CELL = "reduce-tera-straggler"
CONFIG = "terasort-reduce-4node-straggler"
READERS = ("task_MBps.straggler", "hedge_s_per_GB.straggler",
           "hedge_won_pct.straggler", "hedged_bytes_pct.straggler")
CHECKS = ("records_out_of_place", "tasks_unhedged", "fallbacks")
PART = 600 * 104 + 2        # one framed partition, its EOF marker included

# 4 nodes of 2 maps of 600 records: node 1 holds maps 2 and 3, and the
# replicas of maps 0 and 1
TINY_CONFIG.setdefault(CONFIG, {"maps": 8, "maps_per_node": 2,
                                "records_per_segment": 600,
                                "reducers": 1 << 16})


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


def _keep(states: list):
    """A ``system`` hook that keeps the run's driver state and its
    supplier processes."""
    def hook(state, run):
        state.suppliers_seen = list(state.suppliers)
        states.append(state)
    return hook


def test_a_sound_run_is_correct_and_hedges_the_slow_nodes_maps(root):
    states: list = []
    rc, line = run_cell(root, CELL, seed=(1 << 33) + 7, seconds=1.0,
                        trace=1, system=_keep(states))
    assert rc == 0 and line["correct"] is True, line
    assert line["failed"] == 0 and line["attempted"] >= 3
    assert set(line["checks"]) == set(CHECKS)
    assert all(v["value"] == 0 for v in line["checks"].values())
    assert set(READERS) <= set(line["metrics"])
    assert line["metrics"]["hedge_s_per_GB.straggler"]["value"] > 0
    assert 0 < line["metrics"]["hedge_won_pct.straggler"]["value"] <= 100
    state = states[0]
    # every entry names its primary, then the next node's copy
    nodes = list(dict.fromkeys(hs[0] for hs, _ in state.entries))
    assert len(nodes) == 4
    for m, (hs, _) in enumerate(state.entries):
        assert hs == [nodes[m // 2], nodes[(m // 2 + 1) % 4]]
    # every task, the warm ones too, won node 1's two races and took the
    # rest of those segments from node 2
    assert len(state.counter_log) >= 7
    for c in state.counter_log:
        assert c["fetch.speculation.won"] == 2
        assert c["fetch.hedged.bytes"] == 2 * PART
        assert c["fetch.bytes"] == 8 * PART
        assert c["fallback.signals"] == 0
    assert line["metrics"]["hedged_bytes_pct.straggler"]["value"] == 25.0
    procs = state.suppliers_seen
    assert len(procs) == 4 and all(p.returncode == 0 for p in procs)


def test_the_kept_streams_match_the_reference(root):
    states: list = []
    rc, line = run_cell(root, CELL, seed=(1 << 32) + 3, seconds=0.5,
                        system=_keep(states))
    assert rc == 0 and line["correct"] is True
    state = states[0]
    want = reference.merged_records(state.parts)
    assert sorted(state.captured) and all(
        reference.records_out_of_place(want, got) == 0
        for got in state.captured.values())
    # a whole stream: every record in place, the EOF marker after them
    (got, *_) = state.captured.values()
    assert bytes(got) == want.tobytes() + reference.EOF_MARKER


def test_a_planted_fault_fails_the_stream_check(root):
    """The control in the program's place, through ``harness.main``'s
    ``system`` hook: the key's first 4 bytes alone order the stream."""
    rc, line = run_cell(root, CELL, seconds=0.3, system=reference.control)
    assert rc == 0 and line["correct"] is False
    checks = line["checks"]
    assert checks["records_out_of_place"]["value"] > 0
    assert checks["fallbacks"]["value"] == 0


def test_the_control_is_not_correct(root, capsys):
    from portbench import control

    rc = control.main(["--workload", CELL, "--seeds", "5,6",
                       "--seconds", "0.2"], root=root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 2
    for x in lines:
        assert x["control"]["checks"]["records_out_of_place"]["value"] > 0


def test_without_speculation_every_task_is_unhedged(root):
    conf = json.loads((REPO / "portbench/configs" / f"{CONFIG}.json")
                      .read_text())["conf"]
    root = make_root(root, configs={CONFIG: {
        "conf": dict(conf, **{"uda.tpu.fetch.speculate.pn": 0})}})
    rc, line = run_cell(root, CELL, seconds=0.5)
    assert rc == 0 and line["correct"] is False
    checks = line["checks"]
    assert checks["tasks_unhedged"]["value"] == line["attempted"] >= 1
    # slow, not wrong: the streams are in place and nothing fell back
    assert checks["records_out_of_place"]["value"] == 0
    assert checks["fallbacks"]["value"] == 0


def test_the_readers_are_silent_without_the_timer_and_counters():
    run = SimpleNamespace()
    task = {"wall_s": 3.0, "fetch_s": 1.0, "merge_s": 0.5, "bytes": 5e8}
    counted = {"fetch.speculated": 20.0, "fetch.speculation.won": 16.0,
               "fetch.hedged.bytes": 1.25e8, "fetch.bytes": 5e8}
    full = dict(task, timers={"fetch_hedge_time": 1.0},
                counters=counted)
    want = {"hedge_s_per_GB.straggler": 2.0,
            "hedge_won_pct.straggler": 80.0,
            "hedged_bytes_pct.straggler": 25.0}
    # the parent's program: counters without fetch.hedged.bytes, timers
    # without fetch_hedge
    parent = dict(task, timers={"fetch_time": 1.0},
                  counters={k: v for k, v in counted.items()
                            if k != "fetch.hedged.bytes"})
    for name, value in want.items():
        read = harness.load_module(REPO, "metrics", name).read
        assert read(run, {"tasks": [full] * 2}) == pytest.approx(value)
        assert read(run, {"tasks": [task]}) is None
        assert read(run, {"tasks": []}) is None
        assert read(run, {"sorted_records": 10}) is None
        if name != "hedge_won_pct.straggler":
            assert read(run, {"tasks": [parent]}) is None
    won = harness.load_module(REPO, "metrics", "hedge_won_pct.straggler")
    assert won.read(run, {"tasks": [dict(task, counters=dict(
        counted, **{"fetch.speculated": 0.0}))]}) is None
    rate = harness.load_module(REPO, "metrics", "task_MBps.straggler").read
    assert rate(run, {"consumed_bytes": 5e8, "window_s": 5.0}) == 100.0
    assert rate(run, {"sorted_records": 10}) is None


def test_the_reference_imports_neither_the_port_nor_jax():
    package = REPO / "portbench"
    path = package / "reference" / "reduce_straggler.py"
    assert imported_tops(path) <= {"__future__", "numpy"}
    assert path in SOURCES
    assert package / "drivers" / "reduce_straggler.py" in SOURCES
