"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and lengths, every file and reader it names, and every cell's
configuration and traffic found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((REPO / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(harness.find_file(
            REPO, "traffic", w["traffic"] + ".json").read_text())
        assert harness.find_file(REPO, "drivers", traffic["driver"] + ".py")
        assert harness.find_file(REPO, "reference", traffic["driver"] + ".py")
    assert len({w["name"] for w in BENCH["workloads"]}) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    keys = ({"name", "unit", "better", "bound", "source"} if group ==
            "end_to_end" else {"name", "unit", "better", "source", "layer",
                               "moves"})
    for m in BENCH[group]:
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.load_module(REPO, "metrics", m["name"]).read)
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e and _line(m["layer"])
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.reported(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.reported(BENCH, w["name"], True)


def test_a_roofline_share_is_named_for_it_in_percent():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
