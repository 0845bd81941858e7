"""The port stands alone: it and chip_smoke.py import with jax and uda_tpu
blocked, import neither in their source, and never fall back to the CPU
on their own; the kernel build raises on a failed nvcc."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu_torch import device as tdevice
from uda_tpu_torch.models import terasort as tts
from uda_tpu_torch.ops import (_build, lane_gather, pallas_fold,
                                pallas_merge, pallas_sort)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "uda_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT_FILES)


def test_imports_with_jax_and_uda_tpu_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['uda_tpu'] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'uda_tpu') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.argv))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert {"chip_smoke", "uda_tpu_torch.ops.pallas_sort",
            "uda_tpu_torch.merger.overlap", "uda_tpu_torch.merger.streaming",
            "uda_tpu_torch.utils.budget", "uda_tpu_torch.merger.hybrid",
            "uda_tpu_torch.merger.checkpoint",
            "uda_tpu_torch.utils.failpoints",
            "uda_tpu_torch.utils.watchdog", "uda_tpu_torch.coding",
            "uda_tpu_torch.coding.gf256", "uda_tpu_torch.coding.rs",
            "uda_tpu_torch.coding.recovery", "uda_tpu_torch.coding.scrub",
            "uda_tpu_torch.utils.tuncache", "uda_tpu_torch.net",
            "uda_tpu_torch.net.wire", "uda_tpu_torch.net.evloop",
            "uda_tpu_torch.net.server", "uda_tpu_torch.net.client",
            "uda_tpu_torch.compress",
            "uda_tpu_torch.compress.lzo", "uda_tpu_torch.net.push",
            "uda_tpu_torch.mofserver.store", "uda_tpu_torch.tenant",
            "uda_tpu_torch.tenant.registry",
            "uda_tpu_torch.tenant.sched", "uda_tpu_torch.parallel",
            "uda_tpu_torch.parallel.mesh", "uda_tpu_torch.parallel.multihost",
            "uda_tpu_torch.parallel.planner",
            "uda_tpu_torch.parallel.exchange",
            "uda_tpu_torch.parallel.bytes_exchange",
            "uda_tpu_torch.parallel.distributed",
            "uda_tpu_torch.coding.gfjax", "uda_tpu_torch.utils.locks",
            "uda_tpu_torch.utils.resledger", "uda_tpu_torch.utils.metrics",
            "uda_tpu_torch.utils.flightrec",
            "uda_tpu_torch.utils.profiler", "uda_tpu_torch.utils.critpath",
            "uda_tpu_torch.utils.stats", "uda_tpu_torch.utils.timeseries",
            "uda_tpu_torch.utils.anomaly",
            "uda_tpu_torch.utils.openmetrics",
            "uda_tpu_torch.tenant.sli", "uda_tpu_torch.analysis",
            "uda_tpu_torch.analysis.core", "uda_tpu_torch.analysis.cfg",
            "uda_tpu_torch.analysis.threads", "uda_tpu_torch.analysis.flow",
            "uda_tpu_torch.analysis.race", "uda_tpu_torch.analysis.rules",
            "uda_tpu_torch.analysis.__main__",
            "uda_tpu_torch.utils.compile_cache",
            "uda_tpu_torch.graft_entry",
            "uda_tpu_torch.multichip_scale",
            "uda_tpu_torch.native", "uda_tpu_torch.tools.tune_probe",
            "uda_tpu_torch.tools.udatop", "uda_tpu_torch.tools.udafleet",
            "uda_tpu_torch.tools.critpath",
            "uda_tpu_torch.tools.net_smoke"} <= set(MODULES)


def test_native_library_builds_at_first_use_not_at_import(tmp_path):
    """Importing every module builds nothing; the first native call
    builds the host runtime into the build cache."""
    cache = tmp_path / "cache"
    code = ("import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import os, sys\n"
            "cache = sys.argv[1]\n"
            "assert not os.path.exists(cache) or not os.listdir(cache)\n"
            "from uda_tpu_torch.utils import ifile\n"
            "ifile.crack(b'\\x01\\x01kv' * 3000 + b'\\xff\\xff')\n"
            "from uda_tpu_torch import native\n"
            "assert native.calls['crack'] == 1\n"
            "print(sorted(os.listdir(cache)))\n")
    env = dict(os.environ, UDA_TPU_COMPILE_CACHE=str(cache))
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code, str(cache)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().startswith("['native-")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_imports_no_jax_or_uda_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "uda_tpu"), (path, name)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.zeros((10, 26), np.uint32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.single_chip_sort(w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.bench_step(0, 100, 1, "keys8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.generator(0)
    assert tdevice.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tdevice.resolve_device("meta")


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout


@pytest.mark.parametrize("call", [
    lambda x: pallas_sort.tile_sort(x, 128, 3, 7),
    lambda x: pallas_sort.merge_pass(x, 128, 128, 3, 7),
    lambda x: pallas_fold.tile_sort_folded(x[:4], 256, 3),
    lambda x: pallas_fold.merge_pass_folded(x[:4], 256, 256, 3),
    lambda x: pallas_fold.merge_pass4_folded(x[:4], 256, 256, 3),
    lambda x: pallas_fold.merge_partition4(x[:4], 256, 512, 3),
    lambda x: pallas_sort.merge_partition(x, 128, 256, 3, 7),
    lambda x: lane_gather.take_lanes(
        x, torch.empty(512, dtype=torch.int32, device="meta")),
    lambda x: lane_gather.take_rows(
        x, torch.empty(8, dtype=torch.int32, device="meta")),
    lambda x: pallas_merge.merge_sorted_pair(x.T[:300], x.T[300:], 8),
    lambda x: pallas_fold.tile_sort_folded_rows(x.T, 3, 512, 256),
    lambda x: pallas_fold.merge_pass8_folded(x[:4], 256, 256, 3),
    lambda x: pallas_fold.merge_partition8(x[:4], 256, 512, 3),
])
def test_wrappers_take_no_plain_path_off_the_cpu(call):
    """A wrapper runs its plain version only for a CPU tensor; any other
    device gets the kernel or an error."""
    x = torch.empty((8, 512), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        call(x)


def _fake_nvcc(tmp_path: Path, ok: bool) -> str:
    script = tmp_path / ("nvcc_ok" if ok else "nvcc_fail")
    body = ('out=""; while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; '
            'shift; done; echo built > "$out"') if ok else \
        'echo "error: no sm_90a here" >&2; exit 2'
    script.write_text(f"#!/bin/sh\n{body}\n")
    script.chmod(0o755)
    return str(script)


def test_build_all_builds_each_source_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, True))
    _build.build_all()
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert [b.split("-")[0] for b in built] == ["liblane_gather",
                                                "liblanes_fold",
                                                "liblanes_sort"]
    assert all(b.endswith(".so") for b in built)
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, False))
    _build.build_all()   # up to date: nvcc is not run again


def test_build_all_raises_on_nvcc_failure(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, False))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build_all()
    assert not list((tmp_path / "build").iterdir())


def test_launch_counter_counts_only_kernel_launches():
    _build.reset_launches()
    x = torch.from_numpy(np.arange(1024, dtype=np.uint32).reshape(4, 256))
    pallas_sort.sort_lanes(x, 1, tb_row=3, tile=128)
    pallas_fold.sort_lanes_folded4(x, 1, tile=256)
    lane_gather.take_lanes(x, torch.arange(255, -1, -1, dtype=torch.int32))
    lane_gather.take_rows(x, torch.arange(3, -1, -1, dtype=torch.int32))
    assert sum(_build.launches.values()) == 0   # plain versions on the CPU
