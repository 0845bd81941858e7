"""What the benchmark imports: nothing of JAX or of the JAX package
(``uda_tpu``, compared as a whole top-level name), and a reference that
imports nothing of the port."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from portbench.tests.conftest import REPO, make_root

PACKAGE = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "uda_tpu"}
SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if "tests" not in p.parts)


def imported_tops(path) -> set:
    """Top-level names of every module a file imports (absolute imports;
    a relative one names its own package)."""
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            tops.add("portbench" if node.level else
                     node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"):
            raise AssertionError(f"{path}: __import__ hides an import")
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert imported_tops(path) <= {"__future__", "numpy", "torch"}


def test_the_scan_sees_every_kind_of_import(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import jax.numpy\nfrom uda_tpu.ops import sort\n"
                   "from . import gen\nimport uda_tpu_torch\n")
    assert imported_tops(src) == {"jax", "uda_tpu", "portbench",
                                  "uda_tpu_torch"}


HOOK = textwrap.dedent("""
    import sys

    FORBIDDEN = {"jax", "jaxlib", "flax", "uda_tpu"}


    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"refused import of {name}")
            return None


    sys.meta_path.insert(0, Refuse())
""")


def test_whole_runs_under_an_import_hook_that_refuses_jax(tmp_path):
    """Every cell, through a child process whose interpreter (by
    ``sitecustomize``) refuses ``jax`` and ``uda_tpu``."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(HOOK)
    root = make_root(tmp_path / "root")
    cells = [w["name"] for w in json.loads(
        (root / "BENCHMARK.json").read_text())["workloads"]]
    code = textwrap.dedent(f"""
        import io, json, sys
        try:
            import jax
        except ImportError:
            pass
        else:
            sys.exit("the hook is not active")
        from portbench import harness
        for cell in {cells!r}:
            out = io.StringIO()
            rc = harness.main(["--workload", cell, "--seed", "3",
                               "--seconds", "0.2", "--trace", "1"],
                              root={str(root)!r}, device="cpu", out=out)
            line = json.loads(out.getvalue())
            assert rc == 0 and line["correct"], (cell, line)
        print("ok", sorted(m.split(".")[0] for m in sys.modules
                           if m.split(".")[0] in ("jax", "uda_tpu")))
    """)
    env = dict(os.environ, PYTHONPATH=f"{hook}{os.pathsep}{REPO}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok []"
