"""The port's operator entry points (``uda_tpu_torch/tools``: tune_probe,
udatop, udafleet, critpath, net_smoke) against the reference's scripts
(``scripts/``) on the same inputs: the tune probe writes the same keys,
candidate sets and record shapes as ``scripts/tune_probe.py`` (no lanes
engine on the CPU), each package routes by the other's cache; the
consoles render the same statuses and sections against either package's
server; the critpath CLI prints the same block and exit codes; the net
smoke's tree is the reference's and its spans stitch."""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.net import ShuffleServer as JShuffleServer
from uda_tpu.ops import sort as jsort
from uda_tpu.utils import critpath as jcritpath
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils import tuncache as jtuncache
from uda_tpu.utils.config import Config as JConfig
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.net import ShuffleServer
from uda_tpu_torch.ops import sort as tsort
from uda_tpu_torch.tools import (critpath, net_smoke, tune_probe, udafleet,
                                 udatop)
from uda_tpu_torch.utils import critpath as port_critpath
from uda_tpu_torch.utils import errors as terrors
from uda_tpu_torch.utils import tuncache
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import metrics

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300
OBS_CONF = {"uda.tpu.stats.enable": True, "uda.tpu.ts.interval.s": 0.1}


def _script(name: str):
    """A reference script loaded as a module (its ``main`` reads
    ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("UDA_TPU_TUNE_CACHE", "UDA_TPU_SORT_PATH")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _cmd(pkg: str, tool: str) -> list:
    if pkg == "ref":
        return [sys.executable, str(ROOT / "scripts" / f"{tool}.py")]
    return [sys.executable, "-m", f"uda_tpu_torch.tools.{tool}"]


def _run(argv: list, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(argv, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=TIMEOUT, **kw)


# -- tune_probe ---------------------------------------------------------------

@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    """Both probes at --quick into two caches, run at once: the reference
    on JAX's CPU backend, the port with --device cpu."""
    d = tmp_path_factory.mktemp("tune")
    paths = {"ref": str(d / "ref.json"), "port": str(d / "port.json")}
    argv = {"ref": _cmd("ref", "tune_probe") + ["--quick"],
            "port": _cmd("port", "tune_probe") + ["--quick", "--device",
                                                  "cpu"]}
    procs = {p: subprocess.Popen(argv[p] + ["--cache", paths[p]], cwd=ROOT,
                                 env=_env(), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for p in paths}
    out = {}
    for p, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, (p, stderr)
        out[p] = stdout
    entries = {p: json.loads(Path(paths[p]).read_text())["entries"]
               for p in paths}
    return {"paths": paths, "argv": argv, "stdout": out,
            "entries": entries}


def test_tune_probe_writes_the_references_keys(probed):
    ref, port = probed["entries"]["ref"], probed["entries"]["port"]
    assert sorted(port) == sorted(ref)
    assert sorted(port) == ["io.read|" + sys.platform,
                            "sort.engine|cpu|rows15|lanes0",
                            "sort.engine|cpu|rows15|lanes1"]


def test_tune_probe_records_have_the_references_shape(probed):
    ref, port = probed["entries"]["ref"], probed["entries"]["port"]
    for key in ref:
        assert set(port[key]) == set(ref[key]), key
        assert port[key]["probe"] == ref[key]["probe"] == "tune_probe"
        assert isinstance(port[key]["metric"], float)
        assert set(port[key]["winner"]) == set(ref[key]["winner"]), key
    io_key = "io.read|" + sys.platform
    assert set(port[io_key]["winner"]) <= {"batch", "gap_kb", "batch_max",
                                           "backend"}
    assert port[io_key]["winner"]["backend"] in ("io_uring", "preadv",
                                                 "pread")


@pytest.mark.parametrize("lanes", [0, 1])
def test_tune_probe_times_the_references_candidates(probed, lanes):
    """No lanes engine on the CPU, in either package: each key times the
    four engines that compute a permutation, and crowns one of them."""
    key = f"sort.engine|cpu|rows15|lanes{lanes}"
    ref = probed["entries"]["ref"][key]["winner"]
    port = probed["entries"]["port"][key]["winner"]
    assert set(port["times_s"]) == set(ref["times_s"]) == set(
        tune_probe.BASE_ENGINES)
    assert all(isinstance(t, float) for t in port["times_s"].values())
    assert port["engine"] == min(port["times_s"], key=port["times_s"].get)


def test_tune_probe_prints_the_references_lines(probed):
    def shape(text):
        return [re.sub(r"-> .*", "-> W", line)
                for line in text.splitlines()]

    ref, port = probed["stdout"]["ref"], probed["stdout"]["port"]
    assert shape(port.replace(probed["paths"]["port"], "P")) == \
        shape(ref.replace(probed["paths"]["ref"], "P"))
    assert port.splitlines()[-1].startswith("tune_probe: 3 probe(s) run")


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tune_probe_list_and_warm_rerun(probed, pkg):
    """--list prints one line an entry in the same shape; a second run
    over the warm cache probes nothing."""
    path = probed["paths"][pkg]
    listed = _run(probed["argv"][pkg] + ["--cache", path, "--list"])
    assert listed.returncode == 0, listed.stderr
    lines = listed.stdout.splitlines()
    assert [ln.split(": ", 1)[0] for ln in lines] == sorted(
        probed["entries"][pkg])
    assert all(re.fullmatch(r"\S+: \{.*\} \(metric [0-9.]+\)", ln)
               for ln in lines), lines
    again = _run(probed["argv"][pkg] + ["--cache", path])
    assert again.returncode == 0, again.stderr
    assert again.stdout.splitlines()[-1] == \
        f"tune_probe: 0 probe(s) run, cache at {path}"
    assert all(": fresh" in ln for ln in again.stdout.splitlines()[:-1])


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tune_probe_exits_2_without_a_cache_path(pkg):
    res = _run(_cmd(pkg, "tune_probe") + ["--quick"])
    assert res.returncode == 2
    assert res.stderr.strip() == \
        "tune_probe: no cache path (--cache or UDA_TPU_TUNE_CACHE)"
    assert res.stdout == ""


@pytest.mark.parametrize("reader", ["ref", "port"])
@pytest.mark.parametrize("lanes_ok", [False, True])
def test_each_package_routes_by_the_others_cache(probed, monkeypatch,
                                                 reader, lanes_ok):
    writer = "port" if reader == "ref" else "ref"
    path = probed["paths"][writer]
    want = probed["entries"][writer][
        f"sort.engine|cpu|rows15|lanes{int(lanes_ok)}"]["winner"]["engine"]
    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "")
    monkeypatch.setattr(jsort, "DEPLOYED_SORT_PATH", "")
    if reader == "port":
        monkeypatch.setattr(tuncache, "tune_cache",
                            tuncache.TuneCache(path))
        got = tsort.route_engine(1 << 14, "auto", lanes_ok=lanes_ok,
                                 device="cpu")
    else:
        monkeypatch.setattr(jtuncache, "tune_cache",
                            jtuncache.TuneCache(path))
        got = jsort.route_engine(1 << 14, "auto", lanes_ok=lanes_ok)
    assert got == want


def test_lanes_engines_join_only_on_the_card():
    """The reference's rule with "TPU" read as the card: a lanes-capable
    key on the card times all eight engines, the CPU only four."""
    ref_lanes = tuple(jsort.LANES_ENGINES)
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert tune_probe.sort_candidates(cpu, True) == list(
        tune_probe.BASE_ENGINES)
    assert tune_probe.sort_candidates(cpu, False) == list(
        tune_probe.BASE_ENGINES)
    assert tune_probe.sort_candidates(card, False) == list(
        tune_probe.BASE_ENGINES)
    assert tune_probe.sort_candidates(card, True) == list(
        tune_probe.BASE_ENGINES) + list(ref_lanes)
    assert set(tune_probe.sort_candidates(card, True)) == set(
        tsort.ALL_SORT_PATHS)


@pytest.mark.parametrize("age,reprobe_age,force", [
    (None, 0.0, False), (5.0, 0.0, False), (5.0, 10.0, False),
    (50.0, 10.0, False), (5.0, 0.0, True), (float("inf"), 10.0, False)])
def test_freshness_rule_is_the_references(age, reprobe_age, force):
    class Cache:
        def age_s(self, domain, key):
            return age

    ref = _script("tune_probe")
    assert tune_probe._fresh(Cache(), "d", "k", reprobe_age, force) == \
        ref._fresh(Cache(), "d", "k", reprobe_age, force)


def test_a_failing_engine_is_recorded_and_cannot_win(tmp_path,
                                                     monkeypatch):
    """An engine that raises, or whose sort breaks order, is recorded as
    ``error: <type>`` and is never crowned; an interrupt is not caught."""
    from uda_tpu_torch.models import terasort

    real = terasort.bench_step

    def bench_step(seed, n, k, path="lanes", **kw):
        if path == "carry":
            raise RuntimeError("unsupported shape")
        viol, ck_in, ck_out = real(seed, n, k, path=path, **kw)
        if path == "gather":
            viol = viol + 1
        return viol, ck_in, ck_out

    monkeypatch.setattr(terasort, "bench_step", bench_step)
    cache = tuncache.TuneCache(str(tmp_path / "t.json"))
    out = tune_probe.probe_sort_engine(cache, True, 0.0, False, 13,
                                       torch.device("cpu"))
    assert [s for _, s, _ in out] == ["probed", "probed"]
    for key, _, engine in out:
        winner = cache.lookup("sort.engine", key)["winner"]
        assert winner["times_s"]["carry"] == "error: RuntimeError"
        assert winner["times_s"]["gather"] == "error: AssertionError"
        assert engine == winner["engine"] in ("gather2", "carrychunk")

    def interrupted(*a, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(terasort, "bench_step", interrupted)
    with pytest.raises(KeyboardInterrupt):
        tune_probe.probe_sort_engine(cache, True, 0.0, True, 13,
                                     torch.device("cpu"))


def test_tune_probe_needs_the_card_unless_asked_for_the_cpu(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "t.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_probe.main(["--cache", path, "--quick",
                         "--domain", "sort.engine"])
    assert not os.path.exists(path)


def test_tune_probe_counts_each_runs_probes(tmp_path, capsys):
    """In one process the last line counts the probes of that run alone
    (the reference's run is a process of its own), and the counter is
    labelled by domain."""
    path = str(tmp_path / "t.json")
    metrics.add("tune.probes", 5, domain="sort.engine")
    assert tune_probe.main(["--cache", path, "--quick", "--domain",
                            "io.read"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"tune_probe: 1 probe(s) run, cache at {path}"
    assert metrics.get("tune.probes", domain="io.read") == 1
    assert tune_probe.main(["--cache", path, "--quick", "--domain",
                            "io.read"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"tune_probe: {sys.platform}: fresh",
        f"tune_probe: 0 probe(s) run, cache at {path}"]


# -- udatop / udafleet --------------------------------------------------------

def _serve(pkg: str, root: str, conf: dict):
    net_smoke.write_tree(root, "job", num_maps=2, num_reducers=1,
                         records_per_map=30, seed=7)
    if pkg == "ref":
        engine = JDataEngine(JDirIndexResolver(root), JConfig(conf))
        server = JShuffleServer(engine, JConfig(conf), host="127.0.0.1",
                                port=0)
    else:
        engine = DataEngine(DirIndexResolver(root), Config(conf))
        server = ShuffleServer(engine, Config(conf), host="127.0.0.1",
                               port=0)
    server.start()
    return engine, server


@pytest.fixture(params=["ref", "port"])
def live(request, tmp_path):
    """A live server of either package with the stats plane armed (the
    rollup ring at 100 ms), and a port nobody listens on."""
    engine, server = _serve(request.param, str(tmp_path), OBS_CONF)
    dead = server.port + 1 if server.port < 65000 else server.port - 1
    yield request.param, server.port, dead
    server.stop()
    engine.stop()


@pytest.fixture
def port_supplier(tmp_path):
    engine, server = _serve("port", str(tmp_path), OBS_CONF)
    yield server
    server.stop()
    engine.stop()


def test_udatop_once_renders_live_supplier(port_supplier):
    """tests/test_observability.py's console check on a port server."""
    spec = f"127.0.0.1:{port_supplier.port}"
    out = _run(_cmd("port", "udatop") + [spec, "--once", "--json"])
    assert out.returncode == 0, out.stderr
    snap = json.loads(out.stdout.strip().splitlines()[-1])
    assert snap[spec]["counters"] is not None


def test_udafleet_once_merges_live_daemon(port_supplier):
    """tests/test_timeseries.py's fleet check on a port daemon: the live
    one ``ok``, a dead endpoint ``down``, the fleet sections present."""
    port = port_supplier.port
    dead = port + 1 if port < 65000 else port - 1
    out = _run(_cmd("port", "udafleet") + [
        f"127.0.0.1:{port}", f"127.0.0.1:{dead}", "--once", "--json",
        "--window", "30", "--timeout", "5"])
    assert out.returncode == 0, out.stderr
    fleet = json.loads(out.stdout.strip().splitlines()[-1])
    assert fleet["daemons"][f"127.0.0.1:{port}"] == "ok"
    assert fleet["daemons"][f"127.0.0.1:{dead}"] == "down"
    assert "throughput" in fleet and "tenants" in fleet
    assert isinstance(fleet["anomalies"], list)


def _console(mod, argv: list, monkeypatch) -> tuple:
    """(exit code, stdout) of a console's main, port (argv) or reference
    (sys.argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if mod.__name__.startswith("uda_tpu_torch"):
            rc = mod.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
            rc = mod.main()
    return rc, buf.getvalue()


def _shape(doc, depth: int = 2):
    """A JSON document's keys down to ``depth``, values dropped."""
    if isinstance(doc, dict) and depth:
        return {k: _shape(v, depth - 1) for k, v in doc.items()}
    return type(doc).__name__


@pytest.mark.parametrize("window", [None, 30])
def test_udatop_json_matches_reference_on_either_server(live, monkeypatch,
                                                        window):
    _, port, dead = live
    argv = [f"127.0.0.1:{port}", f"127.0.0.1:{dead}", "--once", "--json"]
    if window:
        argv += ["--window", str(window)]
    docs = {}
    for name, mod in (("ref", _script("udatop")), ("port", udatop)):
        rc, out = _console(mod, argv, monkeypatch)
        assert rc == 0
        docs[name] = json.loads(out.strip().splitlines()[-1])
    assert docs["port"][f"127.0.0.1:{dead}"] == {"status": "down"}
    assert _shape(docs["port"]) == _shape(docs["ref"])
    assert ("timeseries" in docs["port"][f"127.0.0.1:{port}"]) == \
        bool(window)


def test_udatop_table_matches_reference_on_either_server(live,
                                                         monkeypatch):
    _, port, dead = live
    argv = [f"127.0.0.1:{port}", f"127.0.0.1:{dead}", "--once",
            "--window", "30"]
    tables = {}
    for name, mod in (("ref", _script("udatop")), ("port", udatop)):
        rc, out = _console(mod, argv, monkeypatch)
        assert rc == 0
        tables[name] = out.splitlines()[1:]  # line 0 is the clock
    assert tables["port"][0] == tables["ref"][0] == udatop._HEADER
    assert tables["port"][2] == tables["ref"][2] == \
        f"{f'127.0.0.1:{dead}':<22} down"
    assert tables["port"][1].split()[0] == f"127.0.0.1:{port}"
    assert len(tables["port"]) == len(tables["ref"])


def test_udafleet_matches_reference_on_either_server(live, monkeypatch):
    _, port, dead = live
    argv = [f"127.0.0.1:{port}", f"127.0.0.1:{dead}", "--once", "--json",
            "--window", "30"]
    docs = {}
    for name, mod in (("ref", _script("udafleet")), ("port", udafleet)):
        rc, out = _console(mod, argv, monkeypatch)
        assert rc == 0
        docs[name] = json.loads(out.strip().splitlines()[-1])
    assert docs["port"]["daemons"] == docs["ref"]["daemons"] == {
        f"127.0.0.1:{port}": "ok", f"127.0.0.1:{dead}": "down"}
    assert _shape(docs["port"]) == _shape(docs["ref"])
    rc, text = _console(udafleet, argv[:-3] + ["--window", "30"],
                        monkeypatch)
    assert rc == 0 and "1/2 daemons up" in text
    assert f"127.0.0.1:{dead}" in text and "down" in text


@pytest.mark.parametrize("console", ["udatop", "udafleet"])
@pytest.mark.parametrize("raised,status", [
    ("TransportError", "down"), ("ProtocolError", "unsupported"),
    ("UdaError", "unsupported")])
def test_statuses_branch_on_the_exception_type(monkeypatch, console,
                                               raised, status):
    """UDA005: down against unsupported by the error's type, never its
    message, in both packages."""
    got = {}
    for name, mod, errs in (("ref", _script(console), jerrors),
                            ("port", {"udatop": udatop,
                                      "udafleet": udafleet}[console],
                                      terrors)):
        def refuse(*a, errs=errs, **kw):
            raise getattr(errs, raised)("down unsupported")

        monkeypatch.setattr(mod, "fetch_remote_stats", refuse)
        got[name] = mod.poll({"h:1": ("h", 1)}, 1.0, 30)
    assert got["port"] == got["ref"] == {"h:1": status}


def _fleet_snaps() -> dict:
    roll = {"dt": 2.0, "counters": {"fetch.bytes": 4e6,
                                    "supplier.bytes": 1e6}}
    tenants = {
        "t1": {"sched_bytes": 3000, "window_share": 0.75, "entitled": 0.5,
               "starve_streak_s": 0,
               "slo": {"fetch_p99": {"attainment": 0.9, "burn": 2.5},
                       "fetch_bw": {"attainment": 0.99, "burn": None}}},
        "t2": {"sched_bytes": 1000, "window_share": 0.25,
               "entitled": 0.5, "starve_streak_s": 4.0,
               "slo": {"fetch_p99": {"attainment": 0.5, "burn": 7.0}}}}
    return {
        "a:1": {"timeseries": {"rollups": [roll, roll]},
                "sli": {"tenants": tenants},
                "anomalies": {"active": [{"kind": "p99", "key": "h0"}]},
                "counters": {"net.bytes.out{role=server}": 5e6},
                "gauges": {"net.server.connections": 3},
                "percentiles": {"supplier.read.latency_ms": {"p95": 1.5}},
                "resledger": {"outstanding": 2, "leak_reports": 0},
                "providers": {"net.server": {"generation": 7},
                              "time_accounting": {"buckets": {
                                  "merge": {"critical_s": 1.0,
                                            "share": 0.6},
                                  "fetch": {"critical_s": 0.5,
                                            "share": 0.3}}}}},
        "b:2": {"timeseries": {"rollups": [roll]},
                "sli": {"tenants": {"t1": tenants["t1"]}}},
        "c:3": {"counters": {}},
        "d:4": "down", "e:5": "unsupported"}


def test_fleet_merge_and_render_match_reference(capsys):
    ref = _script("udafleet")
    snaps = _fleet_snaps()
    mine, theirs = udafleet.merge(snaps), ref.merge(snaps)
    mine.pop("ts"), theirs.pop("ts")
    assert mine == theirs
    assert mine["daemons"] == {"a:1": "ok", "b:2": "ok", "c:3": "plain",
                               "d:4": "down", "e:5": "unsupported"}
    fleet = udafleet.merge(snaps)
    udafleet.render(fleet)
    port_text = capsys.readouterr().out.splitlines()
    ref.render(fleet)
    ref_text = capsys.readouterr().out.splitlines()
    assert port_text[1:] == ref_text[1:]
    assert port_text[0].split(" ", 1)[1] == ref_text[0].split(" ", 1)[1]


def test_udatop_rows_match_reference():
    ref = _script("udatop")
    snaps = _fleet_snaps()
    prev = {"counters": {"net.bytes.out{role=server}": 1e6}}
    for spec, snap in snaps.items():
        assert udatop.row(spec, snap, prev, 2.0) == \
            ref.row(spec, snap, prev, 2.0)
        if isinstance(snap, dict):
            assert udatop.tenant_rows(snap) == ref.tenant_rows(snap)
    rows = udatop.tenant_rows(snaps["a:1"])
    assert any("STARVED 4s" in r for r in rows)
    assert rows[-1] == "  ! anomalies: p99(h0)"


# -- critpath -----------------------------------------------------------------

@pytest.fixture
def port_spans(tmp_path):
    """The span JSONL of a port reduce task with stats on (the 6-map tree,
    2 reducers), written by the port's metrics.export_spans_jsonl."""
    root = str(tmp_path / "tree")
    net_smoke.write_tree(root, "job", num_maps=6, num_reducers=2,
                         records_per_map=300, seed=41)
    metrics.enable_stats()
    engine = DataEngine(DirIndexResolver(root), Config())
    try:
        MergeManager(LocalFetchClient(engine), "uda.tpu.RawBytes",
                     Config({"uda.tpu.stats.enable": True}),
                     device="cpu").run(
            "job", net_smoke.map_ids("job", 6), 1, lambda b: None)
    finally:
        engine.stop()
    path = tmp_path / "spans.jsonl"
    assert metrics.export_spans_jsonl(str(path)) > 6
    return path


# the reference's critpath script with the port's own bucket table added
# (the port's export carries the emit's timers, which only the port maps)
_REF_CRITPATH_PORT_TABLE = (
    "import runpy, sys; from uda_tpu.utils import critpath as c; "
    "from uda_tpu_torch.utils.critpath import PORT_SPAN_BUCKETS as p; "
    "c.SPAN_BUCKETS.update(p); sys.argv = sys.argv[1:]; "
    "runpy.run_path(sys.argv[0], run_name='__main__')")


@pytest.mark.parametrize("args", [["--json"], [], ["--root", "nope"],
                                  ["--json", "--root", "fetch"]])
def test_critpath_cli_matches_reference(port_spans, monkeypatch, args):
    """The port's CLI against the reference script, on a port export, the
    reference given the port's table for the spans only the port has."""
    argv = [str(port_spans)] + args
    for name, bucket in port_critpath.PORT_SPAN_BUCKETS.items():
        monkeypatch.setitem(jcritpath.SPAN_BUCKETS, name, bucket)
    rc_ref, ref = _console(_script("critpath"), argv, monkeypatch)
    rc_port, port = _console(critpath, argv, monkeypatch)
    assert rc_port == rc_ref == 0
    assert port == ref
    if "--json" in args and "--root" not in args:
        block = json.loads(port)
        assert block["root"] == "reduce_task"
        assert block["buckets"]["serve"]["critical_s"] > 0


def test_critpath_cli_runs_as_a_module(port_spans):
    """``python -m`` against ``scripts/critpath.py --json``, as processes
    (the reference's with the port's table, as above)."""
    ref = [sys.executable, "-c", _REF_CRITPATH_PORT_TABLE,
           str(ROOT / "scripts" / "critpath.py")]
    out = {pkg: _run((ref if pkg == "ref" else _cmd(pkg, "critpath"))
                     + [str(port_spans), "--json"])
           for pkg in ("ref", "port")}
    assert out["port"].returncode == out["ref"].returncode == 0
    assert json.loads(out["port"].stdout) == json.loads(out["ref"].stdout)


@pytest.mark.parametrize("case,rc", [("empty", 3), ("missing", 2),
                                     ("bad", None)])
def test_critpath_exit_codes_are_the_references(tmp_path, monkeypatch,
                                                capsys, case, rc):
    path = tmp_path / "spans.jsonl"
    if case == "empty":
        path.write_text("")
    elif case == "bad":
        path.write_text('{"name": "x"}\nnot json\n')
    got = {}
    for name, mod in (("ref", _script("critpath")), ("port", critpath)):
        if case == "bad":
            with pytest.raises(SystemExit) as e:
                _console(mod, [str(path)], monkeypatch)
            got[name] = str(e.value)
        else:
            got[name] = _console(mod, [str(path)], monkeypatch)
            got[name] += (capsys.readouterr().err.replace(
                "ref_script_", ""),)
    if case == "bad":
        assert got["port"] == got["ref"]
        assert got["port"].startswith(f"critpath: {path}:2: bad span")
    else:
        assert got["port"] == got["ref"]
        assert got["port"][0] == rc


# -- net_smoke ----------------------------------------------------------------

def test_net_smoke_tree_is_the_reference_helpers_tree(tmp_path):
    from helpers import make_mof_tree

    make_mof_tree(str(tmp_path / "ref"), net_smoke.JOB, net_smoke.NUM_MAPS,
                  net_smoke.NUM_REDUCERS, records_per_map=200, seed=42)
    net_smoke.write_tree(str(tmp_path / "port"))
    for mid in net_smoke.map_ids(net_smoke.JOB, net_smoke.NUM_MAPS):
        for name in ("file.out", "file.out.index"):
            rel = Path(net_smoke.JOB) / mid / name
            assert (tmp_path / "port" / rel).read_bytes() == \
                (tmp_path / "ref" / rel).read_bytes(), rel


def test_net_smoke_on_the_cpu_stitches(tmp_path, capsys):
    spans = tmp_path / "spans.jsonl"
    assert net_smoke.main(["--spans", str(spans), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("NET SMOKE: ") and str(spans) in out[-2]
    assert out[-1].startswith(
        "NET SMOKE OK: 2 concurrent reduce clients, ")
    assert out[-1].endswith(" B served, byte-identical to the local path")
    res = _run([sys.executable, str(ROOT / "scripts" / "trace_merge.py"),
                str(spans), "--out", str(tmp_path / "trace.json")])
    assert res.returncode == 0, res.stderr
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"reduce_task", "net.serve", "net.fetch"} <= names


def test_net_smoke_streams_are_the_references(tmp_path):
    """The smoke's reduces on the port give the reference's merged bytes
    on its tree, reducer by reducer."""
    root = str(tmp_path)
    net_smoke.write_tree(root)
    mids = net_smoke.map_ids(net_smoke.JOB, net_smoke.NUM_MAPS)
    engine = DataEngine(DirIndexResolver(root), Config())
    jengine = JDataEngine(JDirIndexResolver(root), JConfig())
    try:
        for r in range(net_smoke.NUM_REDUCERS):
            port, ref = bytearray(), bytearray()
            MergeManager(LocalFetchClient(engine), net_smoke.KEY_TYPE,
                         Config(), device="cpu").run(net_smoke.JOB, mids, r,
                                                     port.extend)
            JMergeManager(JLocalFetchClient(jengine), net_smoke.KEY_TYPE,
                          JConfig()).run(net_smoke.JOB, mids, r, ref.extend)
            assert bytes(port) == bytes(ref) and port
    finally:
        engine.stop()
        jengine.stop()


def test_net_smoke_fails_on_a_differing_reduce(monkeypatch, capsys):
    def wrong(port, reduce_id, out, device):
        out[reduce_id] = b"not the stream"

    monkeypatch.setattr(net_smoke, "run_reduce", wrong)
    assert net_smoke.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == \
        ("NET SMOKE FAIL: reducer 0 output differs from the "
         "LocalFetchClient path")


def test_net_smoke_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net_smoke.main([])
