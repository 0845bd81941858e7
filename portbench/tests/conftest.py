"""Shared set-up of the benchmark's own tests: a benchmark root that
holds the repository's ``BENCHMARK.json`` with every configuration and
traffic mix cut to a size a CPU test run holds."""

from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())

# sizes a test run holds; reducers 2^16 leave 16 bits of the first 4 key
# bytes free, so the control's 4-byte order ties often enough to show
TINY_CONFIG = {"terasort-reduce": {"maps": 4, "records_per_segment": 600,
                                   "reducers": 1 << 16}}
TINY_TRAFFIC = {"closed-1e8": {"call_rows": [4096]}}


def make_root(base: Path, configs=None, traffic=None) -> Path:
    """A benchmark root under ``base``: ``BENCHMARK.json`` and the data
    files, each configuration and mix updated by ``configs`` /
    ``traffic`` ({name: {key: value}}) over the tiny sizes."""
    bench = json.loads(json.dumps(BENCH))
    for sub in ("configs", "traffic"):
        (base / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        data.update(TINY_CONFIG.get(c["name"], {}))
        data.update((configs or {}).get(c["name"], {}))
        (base / c["file"]).write_text(json.dumps(data))
    for name in {w["traffic"] for w in bench["workloads"]}:
        rel = Path("portbench/traffic") / f"{name}.json"
        data = json.loads((REPO / rel).read_text())
        data.update(TINY_TRAFFIC.get(name, {}))
        data.update((traffic or {}).get(name, {}))
        (base / rel).write_text(json.dumps(data))
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def add_cell(root: Path, cell: dict, like: str) -> None:
    """Add ``cell`` to ``root``'s ``BENCHMARK.json``, reporting every
    metric that the cell ``like`` reports."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell["name"])
    path.write_text(json.dumps(bench))


def run_cell(root: Path, cell: str, seed: int = 11, seconds: float = 0.3,
             trace: int = 0, system=None, device="cpu") -> tuple:
    """One run of ``cell`` through the harness on ``device``: (exit code,
    the result line or None)."""
    from portbench import harness

    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      device=device, system=system, out=out)
    lines = out.getvalue().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def copy_package(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``portbench/`` alone."""
    def make() -> Path:
        dst = tmp_path / "alone"
        shutil.copytree(REPO / "portbench", dst / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
        return dst
    return make
