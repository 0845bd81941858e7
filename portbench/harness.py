"""The harness core: one run of one cell of ``BENCHMARK.json``.

It reads the cell, finds its configuration, traffic mix and driver by
name, lets the driver make the inputs and warm up (set-up), measure for
``--seconds`` and judge the timed path's outputs against the plain
reference, then reads every metric the cell reports through that
metric's own reader and prints the result line. Nothing here knows a
cell: a new cell, mix, driver or metric is a new file and an entry in
``BENCHMARK.json``.

Driver modules (``drivers/<kind>.py``) define ``setup(run)`` -> state,
``measure(state, run)`` -> record, ``check(state, run, record)`` ->
``{name: (value, limit)}`` and ``close(state)``. Metric readers
(``metrics/<name>.py``) define ``read(run, record)`` -> a number, or None
where the record holds nothing to read.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "uda_tpu")


class Run:
    """What one run knows: the cell's entries and files, its arguments,
    the device and the clock that set-up started on."""

    def __init__(self, root: Path, bench: dict, cell: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 t0: float):
        self.root = root
        self.bench = bench
        self.cell = cell
        self.config = json.loads((root / config_entry(bench, cell)["file"])
                                 .read_text())
        self.traffic = json.loads(find_file(root, "traffic",
                                            cell["traffic"] + ".json")
                                  .read_text())
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t0 = t0
        self.setup_s = None

    def log(self, msg: str) -> None:
        print(f"[portbench {self.cell['name']}] {msg}", file=sys.stderr,
              flush=True)


def config_entry(bench: dict, cell: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return c
    raise KeyError(f"configuration {cell['config']!r} is not in "
                   f"BENCHMARK.json")


def find_file(root: Path, sub: str, name: str) -> Path:
    """``<root>/portbench/<sub>/<name>``, else the package's own."""
    for base in (root / "portbench", PACKAGE_DIR):
        path = base / sub / name
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {sub}/{name} under {root} or "
                            f"{PACKAGE_DIR}")


def load_module(root: Path, sub: str, name: str):
    """The module in ``<sub>/<name>.py``, found by ``find_file``."""
    path = find_file(root, sub, name + ".py")
    tag = "".join(ch if ch.isalnum() else "_" for ch in f"{sub}_{name}")
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reported(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; a metric with a
    ``workloads`` key only in the cells it lists."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_loaded() -> list:
    """Modules of JAX or the JAX package in this process, compared by
    whole top-level name."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def device_of(run_device, chips: int) -> tuple:
    """The device the run drives and the result's ``device`` entry; None
    where the cell's card is missing (the run then fails)."""
    if run_device is not None:
        dev = torch.device(run_device)
        if dev.type == "cpu":
            return dev, {"platform": "cpu", "kind": "cpu", "count": 1}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None, None
    return torch.device("cuda", 0), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": chips}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description="One run of one cell of "
                                             "BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root=None, device=None, t0=None, system=None,
         out=None) -> int:
    """Run one cell and print its result line to ``out`` (stdout). Returns
    the exit code. ``device`` other than None skips the look for a card
    (tests drive a run on the CPU so); ``system(state, run)``, when
    given, replaces the call the window drives (the control, a planted
    fault)."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = Path(root) if root is not None else PACKAGE_DIR.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    dev, device_entry = device_of(device, int(cell["chips"]))
    if dev is None:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s): "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = Run(root, bench, cell, args.seed, args.seconds, bool(args.trace),
              dev, t0)
    driver = load_module(root, "drivers", run.traffic["driver"])
    state = None
    try:
        state = driver.setup(run)
        if system is not None:
            system(state, run)
        run.setup_s = time.perf_counter() - t0
        run.log(f"set-up {run.setup_s:.3f} s")
        record = driver.measure(state, run)
        checks = driver.check(state, run, record)
    finally:
        if state is not None:
            driver.close(state)
    metrics = {}
    for m in reported(bench, cell["name"], run.trace):
        value = load_module(root, "metrics", m["name"]).read(run, record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 4
    failed = int(record["failed"])
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    device_entry["memory_peak_bytes"] = int(record["peak_bytes"])
    line = {"correct": correct, "attempted": int(record["attempted"]),
            "failed": failed, "metrics": metrics, "device": device_entry}
    if run.trace and "trace" in record:
        tr = record["trace"]
        device_entry.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out or sys.stdout, flush=True)
    return 0
