"""The wire reduce driver (``drivers/reduce_wire.py``) on the CPU, with real
supplier processes (``portbench/supplier.py``) at a test size: a sound
run is correct and reads the wire's timers, a key byte changed in one
node's map output after the reference's partitions were made is out of
place, a supplier killed inside the window ends the run not correct and
in time, and no supplier outlives a run. The readers of the wire's
timers read nothing from a program without them."""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import pytest

from portbench import harness, ifile
from portbench.tests.conftest import REPO, make_root, run_cell
from portbench.tests.test_portbench_imports import SOURCES

CELL = "reduce-tera-wire-4sup"
CONFIG = "terasort-reduce-4node"
READERS = ("net_read_s_per_GB.wire", "net_deliver_s_per_GB.wire")


@pytest.fixture
def root(tmp_path):
    """4 nodes of 2 maps each, 600 records a segment."""
    return make_root(tmp_path, configs={CONFIG: {"maps": 8,
                                                 "maps_per_node": 2}})


def _suppliers_of(procs: list, then=None):
    """A ``system`` hook that keeps the run's supplier processes in
    ``procs``, then runs ``then(state, run)``."""
    def hook(state, run):
        procs.extend(state.suppliers)
        if then is not None:
            then(state, run)
    return hook


def _all_reaped(procs: list) -> bool:
    return len(procs) == 4 and all(p.returncode is not None for p in procs)


def test_a_sound_run_is_correct_and_reads_the_wire_timers(root):
    procs: list = []
    rc, line = run_cell(root, CELL, seed=(1 << 33) + 7, seconds=1.0,
                        trace=1, system=_suppliers_of(procs))
    assert rc == 0 and line["correct"] is True, line
    assert line["failed"] == 0 and line["attempted"] >= 3
    for name in READERS:
        assert line["metrics"][name]["value"] > 0
    assert line["metrics"]["task_MBps.reduce"]["value"] > 0
    # asked to stop, every supplier exited by itself
    assert _all_reaped(procs) and all(p.returncode == 0 for p in procs)


def test_a_changed_key_byte_on_one_node_is_out_of_place(root):
    def plant(state, run):
        # map 2, on node 1: record 5's fourth key byte (3 framing bytes
        # lead each record)
        path = os.path.join(state.tmp, "node1", "portbench",
                            ifile.map_id("portbench", 2), "file.out")
        at = 5 * state.parts[2].shape[1] + 3 + 3
        with open(path, "r+b") as f:
            f.seek(at)
            byte = f.read(1)[0]
            f.seek(at)
            f.write(bytes([byte ^ 0x80]))

    procs: list = []
    rc, line = run_cell(root, CELL, seconds=0.5,
                        system=_suppliers_of(procs, plant))
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["records_out_of_place"]["value"] > 0
    assert _all_reaped(procs)


def test_a_killed_supplier_fails_the_run_in_time(root):
    def kill_on_second_task(state, run):
        program, calls = state.call, []

        def call(consumer):
            calls.append(1)
            if len(calls) == 2:
                state.suppliers[2].kill()
                state.suppliers[2].wait(timeout=30)
            program(consumer)

        state.call = call

    procs: list = []
    start = time.perf_counter()
    rc, line = run_cell(root, CELL, seconds=1.5,
                        system=_suppliers_of(procs, kill_on_second_task))
    assert time.perf_counter() - start < 120
    assert rc == 0 and line["correct"] is False
    assert line["failed"] >= 1
    assert _all_reaped(procs)
    assert procs[2].returncode != 0


def test_the_wire_timers_are_silent_without_the_timers():
    run = SimpleNamespace()
    task = {"wall_s": 3.0, "fetch_s": 1.0, "merge_s": 0.5, "bytes": 5e8}
    timed = {"net_read_time": 0.25, "net_deliver_time": 0.125,
             "fetch_time": 1.0}
    for name, want in zip(READERS, (0.5, 0.25)):
        read = harness.load_module(REPO, "metrics", name).read
        assert read(run, {"tasks": [dict(task, timers=timed)] * 2}) == want
        # the parent's program: timers without the wire's, or none
        assert read(run, {"tasks": [dict(task, timers={
            "fetch_time": 1.0})]}) is None
        assert read(run, {"tasks": [task]}) is None
        assert read(run, {"tasks": []}) is None
        assert read(run, {"sorted_records": 10}) is None


def test_the_import_scan_covers_the_supplier_and_its_reference():
    package = REPO / "portbench"
    assert package / "supplier.py" in SOURCES
    assert package / "drivers" / "reduce_wire.py" in SOURCES
    assert package / "reference" / "reduce_wire.py" in SOURCES
