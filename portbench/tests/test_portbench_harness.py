"""Whole runs of the harness on the CPU at tiny sizes: every cell comes out
correct, a cell defined only in data files runs, the control and every
planted fault come out not correct, and a run without a card or without
the port prints no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import (BENCH, REPO, add_cell, make_root,
                                      run_cell)

CELLS = [w["name"] for w in BENCH["workloads"]]
SORT_CELLS = [c for c in CELLS if c.startswith("sort-")]
REDUCE_CELLS = [c for c in CELLS if c.startswith("reduce-")]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_correct(tiny_root, cell, trace):
    rc, line = run_cell(tiny_root, cell, seed=(1 << 31) + 9, trace=trace)
    assert rc == 0 and line["correct"] is True, line
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in line["checks"].values())
    want = {m["name"] for m in harness.reported(BENCH, cell, bool(trace))}
    # no device number on the CPU: the readers of the card find nothing
    device_only = {"peak_device_GB", "sort_kernels_roofline",
                   "device_idle_pct.sort", "device_idle_pct.reduce"}
    assert set(line["metrics"]) == want - device_only
    assert line["device"]["platform"] == "cpu"
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_defined_only_in_data_files(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "portbench/configs/terasort-reduce.json")
                      .read_text())
    conf.update(maps=3, records_per_segment=70, reducers=8)
    (root / "portbench/configs/tera-narrow.json").write_text(json.dumps(conf))
    (root / "portbench/traffic/local-3maps.json").write_text(json.dumps(
        {"driver": "reduce", "warm_tasks": 0,
         "sample_tasks": 1, "sample_from": 1}))
    (root / "portbench/metrics").mkdir()
    (root / "portbench/metrics/tasks_in_window.py").write_text(
        "def read(run, record):\n    return len(record['tasks'])\n")
    bench["configs"].append({"name": "tera-narrow", "source": "a test",
                             "file": "portbench/configs/tera-narrow.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "reduce-new", "config": "tera-narrow",
                               "traffic": "local-3maps", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "tasks_in_window", "unit": "tasks",
                               "better": "higher", "source": "host_clock",
                               "layer": "reduce entry",
                               "moves": "peak_device_GB",
                               "workloads": ["reduce-new"]})
    for m in bench["per_layer"]:
        if m["name"] == "task_MBps.reduce":
            m["workloads"].append("reduce-new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = run_cell(root, "reduce-new", trace=0)
    assert rc == 0 and line["correct"] and "setup_s" in line["metrics"]
    rc, line = run_cell(root, "reduce-new", trace=1)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["tasks_in_window"]["value"] == line["attempted"]
    assert line["metrics"]["task_MBps.reduce"]["value"] > 0


def _sort_fault(kind: str):
    def plant(state, run):
        program = state.call

        def call(words):
            if kind == "unchanged":
                return words
            if kind == "half":
                n = words.shape[0] // 2
                w = words.view(torch.int32)
                return torch.cat([program(words[:n]).view(torch.int32),
                                  w[n:]]).view(torch.uint32)
            out = program(words).view(torch.int32).clone()
            out[out.shape[0] // 2, 7] ^= 1
            return out.view(torch.uint32)

        state.call = call
    return plant


def _reduce_fault(kind: str):
    def plant(state, run):
        program = state.call
        if kind == "unchanged":
            import numpy as np
            stream = np.concatenate(state.parts).tobytes() + b"\xff\xff"
            state.call = lambda consumer: consumer(memoryview(stream))
        elif kind == "half":
            half = state.entries[:len(state.entries) // 2]
            state.call = lambda consumer: state.task(consumer, half)
        else:
            def call(consumer):
                first = [True]

                def altered(block):
                    if first[0]:
                        first[0] = False
                        block = bytearray(block)
                        block[len(block) // 2] ^= 0x5A
                    consumer(memoryview(bytes(block)))

                program(altered)
            state.call = call
    return plant


FAULTS = ("unchanged", "half", "altered")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    plant = (_sort_fault if cell in SORT_CELLS else _reduce_fault)(fault)
    rc, line = run_cell(tiny_root, cell, system=plant)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell, capsys):
    from portbench import control

    # 2^18 records: the 32-bit key heads of uniform keys tie a few times
    root = make_root(tmp_path, traffic={
        "closed-1e8": {"call_rows": [1 << 18]}})
    rc = control.main(["--workload", cell, "--seeds", "5,6,7",
                       "--seconds", "0.2"], root=root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 3
    for x in lines:
        assert x["control"]["checks"]["records_out_of_place"]["value"] > 0


def test_no_card_no_result():
    # the card, where there is one, is hidden from the run
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_give_no_result(copy_package):
    alone = make_root(copy_package())
    code = ("import sys; from portbench import harness; sys.exit(harness."
            f"main(['--workload', {CELLS[0]!r}, '--seed', '1', '--seconds', "
            "'0.2'], device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=alone,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "uda_tpu_torch" in proc.stderr


def test_a_loaded_jax_refuses_the_result(tiny_root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = run_cell(tiny_root, SORT_CELLS[0])
    assert rc != 0 and line is None
    assert "jax" in capsys.readouterr().err


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "uda_tpu_torch_x",
                        types.ModuleType("uda_tpu_torch_x"))
    assert "uda_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "uda_tpu.ops",
                        types.ModuleType("uda_tpu.ops"))
    assert harness.forbidden_loaded() == ["uda_tpu"]


def test_an_unknown_workload_is_refused(tiny_root):
    assert run_cell(tiny_root, "no-such-cell") == (2, None)


def test_every_seed_keeps_outputs_of_the_same_sizes(tiny_root):
    """A mix of two call sizes, defined only in a data file: every seed
    keeps as many outputs of each size."""
    (tiny_root / "portbench/traffic/two-sizes.json").write_text(json.dumps(
        {"driver": "sort", "call_rows": [3001, 2000], "inputs": 4,
         "warm_calls": 1, "sample_calls": 2, "sample_from": 4}))
    add_cell(tiny_root, {"name": "sort-two-sizes", "config": "terasort-sort",
                         "traffic": "two-sizes", "chips": 1, "why": "a test"},
             like="sort-tera-1e8")
    sizes = []

    def look(state, run):
        sizes.append(sorted(int(state.inputs[i % len(state.inputs)]
                                .shape[0]) for i in state.sample))

    for seed in (1, 2, 3, 4):
        rc, line = run_cell(tiny_root, "sort-two-sizes", seed=seed,
                            system=look)
        assert rc == 0 and line["correct"] is True
    assert sizes[0] == [2000, 3001]
    assert all(s == sizes[0] for s in sizes)
