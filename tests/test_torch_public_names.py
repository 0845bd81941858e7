"""The reference's public names that the port was still missing, each held
to the reference on the same inputs: the bulk VInt codec, ``write_records``,
the chaos schedules and ``FailpointRegistry.quiesced``, ``Config.as_dict``,
the metrics hub's span toggles, the logger's private file, ``PenaltyBox.
boxed``, ``RunStore.dir`` and ``emit_framed_records``. An AST diff keeps
the two packages' public names in step, ``native/`` included: what the
port lacks is the list below (a JAX backend's selection) and nothing
else."""

import ast
import io
import os
from pathlib import Path

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.merger import emitter as jemitter
from uda_tpu.merger import merge_manager as jmm
from uda_tpu.merger import streaming as jstreaming
from uda_tpu.utils import config as jconfig
from uda_tpu.utils import failpoints as jfp
from uda_tpu.utils import ifile as jifile
from uda_tpu.utils import logging as jlogging
from uda_tpu.utils import metrics as jmetrics
from uda_tpu.utils import vint as jvint
from uda_tpu_torch.merger import emitter as temitter
from uda_tpu_torch.merger import merge_manager as tmm
from uda_tpu_torch.merger import streaming as tstreaming
from uda_tpu_torch.utils import config as tconfig
from uda_tpu_torch.utils import failpoints as tfp
from uda_tpu_torch.utils import ifile as tifile
from uda_tpu_torch.utils import logging as tlogging
from uda_tpu_torch.utils import metrics as tmetrics
from uda_tpu_torch.utils import vint as tvint
from uda_tpu_torch.utils.errors import StorageError

ROOT = Path(__file__).resolve().parent.parent

# reference names with no counterpart: they select a JAX backend
# (device.py decides the device)
NO_COUNTERPART = {
    "uda_tpu/utils/compile_cache.py": {"apply_platform_env"},
}


def _public_names(path: Path) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name[0] == "_":
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and not m.name.startswith("_"))
    return out


def _reference_modules():
    return sorted((ROOT / "uda_tpu").rglob("*.py"))


@pytest.mark.parametrize("path", _reference_modules(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_has_every_public_name(path):
    rel = str(path.relative_to(ROOT))
    port = ROOT / rel.replace("uda_tpu/", "uda_tpu_torch/", 1)
    assert port.exists(), f"{rel} has no counterpart module"
    missing = _public_names(path) - _public_names(port)
    assert missing == NO_COUNTERPART.get(rel, set())


# reference functions whose positional parameters the port translates on
# purpose (the check below fails on any other difference, and on an entry
# here that no longer differs)
_INTERPRET = ("interpret=: interpret-mode Pallas is JAX-only; the port runs "
              "a kernel's plain version on a CPU tensor instead")
SIGNATURE_TRANSLATIONS = {
    "uda_tpu/models/terasort.py::teragen":
        "key: a JAX PRNG key becomes a torch.Generator",
    "uda_tpu/models/terasort.py::teragen_lanes":
        "key: a JAX PRNG key becomes a torch.Generator",
    "uda_tpu/models/terasort.py::single_chip_sort": _INTERPRET,
    "uda_tpu/models/terasort.py::sort_lanes_keys8": _INTERPRET,
    "uda_tpu/models/terasort.py::bench_step": _INTERPRET,
    "uda_tpu/ops/merge.py::merge_row_pair": _INTERPRET,
    "uda_tpu/ops/merge.py::merge_batches_two_phase": _INTERPRET,
    "uda_tpu/ops/pallas_fold.py::sort_lanes_folded4": _INTERPRET,
    "uda_tpu/ops/pallas_fold.py::sort_lanes_folded": _INTERPRET,
    "uda_tpu/ops/pallas_merge.py::merge_sorted_pair": _INTERPRET,
    "uda_tpu/ops/pallas_sort.py::keys8_sort_perm": _INTERPRET,
    "uda_tpu/ops/pallas_sort.py::sort_lanes": _INTERPRET,
    "uda_tpu/parallel/exchange.py::window_round_body":
        "w, d, q: a shard_map body's arrays become the mesh and a source",
    "uda_tpu/parallel/exchange.py::hierarchical_round_body":
        "w, d, q: a shard_map body's arrays become the mesh and a source",
    "uda_tpu/parallel/exchange.py::coded_round_body":
        "w, d, q: a shard_map body's arrays become the mesh and a source",
    "uda_tpu/parallel/exchange.py::run_round_body":
        "w, d, q: a shard_map body's arrays become the mesh and a source",
    "uda_tpu/parallel/multihost.py::allgather":
        "arr: the port's mesh is a list of slots, not a jax.Array",
}


def _signatures(path: Path) -> dict:
    """Public functions, and public classes' ``__init__`` and public
    methods, by name -> their positional parameter names."""
    def positional(fn) -> list:
        return [a.arg for a in fn.args.posonlyargs + fn.args.args]

    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, funcs) and node.name[0] != "_":
            out[node.name] = positional(node)
        elif isinstance(node, ast.ClassDef) and node.name[0] != "_":
            for m in node.body:
                if isinstance(m, funcs) and (m.name[0] != "_"
                                             or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = positional(m)
    return out


@pytest.mark.parametrize("path", _reference_modules(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_positional_parameters_are_a_prefix(path):
    """A call written for the reference means the same on the port: every
    public function's and method's positional parameters in the reference
    are, by name, a prefix of the port's (the port may add parameters
    after them), but for the listed translations."""
    rel = str(path.relative_to(ROOT))
    port = _signatures(ROOT / rel.replace("uda_tpu/", "uda_tpu_torch/", 1))
    differ = {}
    for name, params in _signatures(path).items():
        if name in port and port[name][:len(params)] != params:
            differ[f"{rel}::{name}"] = (params, port[name])
    allowed = {k for k in SIGNATURE_TRANSLATIONS
               if k.startswith(rel + "::")}
    assert {k: v for k, v in differ.items() if k not in allowed} == {}
    assert allowed <= set(differ), "a listed translation no longer differs"


# -- utils/vint ---------------------------------------------------------------

def _vlong_values(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, 127, 128, -112, -113, -128, 255, 256, 2**31 - 1,
             -2**31, 2**63 - 1, -2**63]
    mags = rng.integers(-2**62, 2**62, 200, dtype=np.int64)
    small = rng.integers(-300, 300, 200, dtype=np.int64)
    return np.concatenate([np.asarray(edges, np.int64), mags, small])


@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_vlong_codec_matches_reference(seed):
    vals = _vlong_values(seed)
    enc = tvint.encode_vlong_array(vals)
    assert enc == jvint.encode_vlong_array(vals)
    buf = np.frombuffer(enc, np.uint8)
    for count in (-1, 0, 7, len(vals)):
        got = tvint.decode_vlong_stream(buf, count)
        want = jvint.decode_vlong_stream(buf, count)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert got[0].dtype == got[1].dtype == np.int64
    assert np.array_equal(tvint.decode_vlong_stream(buf)[0], vals)
    for mod in (tvint, jvint):
        with pytest.raises(IndexError):
            mod.decode_vlong_stream(buf[:5], len(vals))


# -- utils/ifile --------------------------------------------------------------

def test_write_records_matches_reference():
    rng = np.random.default_rng(3)
    recs = [(rng.bytes(int(rng.integers(0, 40))),
             rng.bytes(int(rng.integers(0, 300)))) for _ in range(50)]
    want = jifile.write_records(recs)
    assert tifile.write_records(recs) == want
    assert tifile.write_records([]) == jifile.write_records([])
    out = io.BytesIO()
    assert tifile.write_records(recs, out) == b""
    assert out.getvalue() == want


# -- utils/failpoints ---------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_chaos_specs_match_reference_and_arm(seed):
    for name in ("chaos_spec", "net_chaos_spec"):
        spec = getattr(tfp, name)(seed)
        assert spec == getattr(jfp, name)(seed)
        with tfp.failpoints.scoped(spec):
            armed = tfp.failpoints.active()
        assert sorted(armed) == sorted(p.split("=")[0]
                                       for p in spec.split(","))


def _quiesced_trace(mod):
    reg = mod.FailpointRegistry()
    reg.arm("data_engine.pread", "error:every:2")
    fired = []

    def hit():
        try:
            reg.evaluate("data_engine.pread", b"x", "")
            fired.append(0)
        except Exception as e:  # noqa: BLE001 - the injected error
            fired.append(type(e).__name__)

    hit()
    with reg.quiesced():
        assert reg.active() == {}
        for _ in range(3):
            hit()
    hit()
    hit()
    return fired, reg.active(), dict(reg.hits)


def test_quiesced_matches_reference():
    got, want = _quiesced_trace(tfp), _quiesced_trace(jfp)
    assert got[0] == want[0] == [0, 0, 0, 0, "StorageError", 0]
    assert got[1:] == want[1:]


# -- utils/config, utils/metrics, utils/logging -------------------------------

def test_config_as_dict_matches_reference():
    over = {"mapred.rdma.buf.size": 64, "uda.tpu.stats.enable": True}
    got, want = tconfig.Config(over).as_dict(), jconfig.Config(over).as_dict()
    assert got == want
    assert got["mapred.rdma.buf.size"] == 64
    assert tconfig.Config().as_dict() == jconfig.Config().as_dict()


def test_metrics_span_toggles_match_reference():
    seen = []
    for mod in (tmetrics, jmetrics):
        m = mod.Metrics(stats=False)
        row = [m.stats_enabled, m.record_spans]
        m.record_spans = True
        row += [m.stats_enabled, m.record_spans]
        with m.span("reduce_task"):
            pass
        m.disable_spans()
        with m.span("reduce_task"):
            pass
        row += [m.record_spans, len(m.spans)]
        m.enable_stats()
        row += [m.stats_enabled, m.record_spans]
        seen.append(row)
    assert seen[0] == seen[1] == [False, False, False, True, False, 1,
                                  True, True]


def test_logger_private_file_matches_reference(tmp_path, capsys):
    lines = {}
    for name, mod in (("port", tlogging), ("ref", jlogging)):
        lg = mod.Logger(f"{name}.log")
        path = tmp_path / name / "uda.log"
        lg.open_file(str(path))
        lg.info("to the file")
        lg.log(mod.LogLevel.WARN, "also to the file")
        lg.debug("below the level")
        lg.close()
        lg.error("back on stderr")
        body = path.read_text().splitlines()
        lines[name] = [ln.split(" ", 2)[2].split(": ", 1)[1].split(" (")[0]
                       for ln in body]
        assert [ln.split()[2] for ln in body] == ["INFO", "WARN"]
    assert lines["port"] == lines["ref"] == ["to the file",
                                             "also to the file"]
    assert capsys.readouterr().err.count("back on stderr") == 2
    tlogging.log(tlogging.LogLevel.NONE, "never printed")


# -- merger/ ------------------------------------------------------------------

def test_penalty_box_boxed_matches_reference():
    got = []
    for mod in (tmm, jmm):
        box = mod.PenaltyBox(threshold=2, penalty_s=60.0)
        trace = [list(box.boxed)]
        for key in ("a", "b", "a", "c", "c", "c"):
            box.punish(key)
            trace.append(sorted(box.boxed))
        box.forgive("a")
        trace.append(sorted(box.boxed))
        got.append(trace)
    assert got[0] == got[1]
    assert got[0][-2] == ["a", "c"] and got[0][-1] == ["c"]


def test_run_store_dir_matches_reference(tmp_path):
    dirs = [str(tmp_path / "d0"), str(tmp_path / "d1")]
    for d in dirs:
        os.makedirs(d)
    port = tstreaming.RunStore(dirs, tag="t")
    ref = jstreaming.RunStore(dirs, tag="t")
    try:
        assert port.dir == port.dirs[0]
        assert os.path.dirname(port.dir) == os.path.dirname(ref.dir)
        fixed = tstreaming.RunStore(fixed_dir=str(tmp_path / "fixed"))
        assert fixed.dir == str(tmp_path / "fixed")
    finally:
        port.cleanup()
        ref.cleanup()


def test_emit_framed_records_matches_reference():
    rng = np.random.default_rng(5)
    recs = [(rng.bytes(10), rng.bytes(int(rng.integers(0, 900))))
            for _ in range(60)]
    outs = []
    for mod in (temitter, jemitter):
        blocks = []
        n = mod.emit_framed_records(recs, 4096,
                                    lambda mv: blocks.append(bytes(mv)))
        outs.append((n, blocks))
    assert outs[0] == outs[1]
    assert b"".join(outs[0][1]) == tifile.write_records(recs)
    with pytest.raises(StorageError):
        tifile.crack(b"".join(outs[0][1])[:-1])
