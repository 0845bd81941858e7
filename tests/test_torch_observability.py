"""The port's observability plane against the JAX package's: the registries
(metric names, span names, paired gauges, critpath's buckets) are the
reference's, every literal metric and span name the port passes is
registered, the span tree exports the reference's shapes, ``critpath``
partitions a span list exported by the reference exactly as the reference
does, and the StatsReporter, the OpenMetrics text, the flight recorder's
dumps and the introspection snapshot match. The slice as a whole:
``MergeManager.run`` on a 6-map tree with stats, spans, the flight
recorder, the ledger and lockdep armed gives the same bytes and the same
span and counter structure in both packages, in process and over the
wire, and the reference's wire decodes the port server's armed MSG_STATS
reply with the reference server's sections."""

import ast
import contextlib
import glob
import json
import os
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import make_mof_tree, map_ids
from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu import net as jnet
from uda_tpu.merger import HostRoutingClient as JHostRoutingClient
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.utils import critpath as jcritpath
from uda_tpu.utils import flightrec as jflightrec_mod
from uda_tpu.utils import locks as jlocks
from uda_tpu.utils import metrics as jmetrics_mod
from uda_tpu.utils import openmetrics as jopenmetrics
from uda_tpu.utils import profiler as jprofiler_mod
from uda_tpu.utils import resledger as jled
from uda_tpu.utils import stats as jstats
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import net as tnet
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                   MergeManager)
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.utils import critpath
from uda_tpu_torch.utils import flightrec as tflightrec_mod
from uda_tpu_torch.utils import locks as tlocks
from uda_tpu_torch.utils import metrics as tmetrics_mod
from uda_tpu_torch.utils import openmetrics
from uda_tpu_torch.utils import profiler as tprofiler_mod
from uda_tpu_torch.utils import resledger as tled
from uda_tpu_torch.utils import stats as tstats
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import device_trace, metrics

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "uda_tpu_torch").rglob("*.py"))
HUB_NAMES = ("metrics", "m", "global_metrics", "self.metrics")

# -- the registries -----------------------------------------------------------

REGISTRIES = {
    "METRICS_REGISTRY": (jmetrics_mod, tmetrics_mod, True),
    "SPAN_REGISTRY": (jmetrics_mod, tmetrics_mod, True),
    "REGISTRY_PREFIXES": (jmetrics_mod, tmetrics_mod, False),
    "NAME_RE": (jmetrics_mod, tmetrics_mod, False),
    "PARITY_ALIASES": (jmetrics_mod, tmetrics_mod, False),
    "PAIRED_GAUGES": (jled, tled, False),
    "SPAN_BUCKETS": (jcritpath, critpath, False),
    "BUCKET_PRIORITY": (jcritpath, critpath, False),
    "TRIO_MAP": (jcritpath, critpath, False),
}


@pytest.mark.parametrize("name", sorted(REGISTRIES))
def test_registry_matches_reference(name):
    ref_mod, port_mod, keys_only = REGISTRIES[name]
    ref, port = getattr(ref_mod, name), getattr(port_mod, name)
    if keys_only:
        # the metrics registry holds the port's own names besides
        own = set(tmetrics_mod.PORT_METRICS) \
            if name == "METRICS_REGISTRY" else set()
        assert not own & set(ref)
        assert set(port) == set(ref) | own
        # the kinds of the metrics registry are the reference's too
        if name == "METRICS_REGISTRY":
            assert {k: v[0] for k, v in port.items() if k not in own} \
                == {k: v[0] for k, v in ref.items()}
    else:
        assert port == ref


def _receiver(node) -> str:
    f = node.func.value
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f"{f.value.id}.{f.attr}"
    return ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_metric_and_span_names_are_registered(path):
    """The port's counterpart of ``scripts/check_metrics_names.py`` (which
    stays the reference's): every literal name passed to
    ``metrics.add``/``gauge``/``gauge_add``/``observe`` is in
    METRICS_REGISTRY and the dotted namespace, or starts with a
    REGISTRY_PREFIXES prefix (f-strings); every literal span name is in
    SPAN_REGISTRY."""
    bad = []
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("add", "gauge", "gauge_add",
                                       "observe", "span", "start_span")
                and _receiver(node) in HUB_NAMES and node.args):
            continue
        arg = node.args[0]
        kind = node.func.attr
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            if kind in ("span", "start_span"):
                ok = name in tmetrics_mod.SPAN_REGISTRY
            else:
                ok = (name in tmetrics_mod.METRICS_REGISTRY
                      and re.fullmatch(tmetrics_mod.NAME_RE, name))
        elif isinstance(arg, ast.JoinedStr):
            head = arg.values[0]
            ok = (kind not in ("span", "start_span")
                  and isinstance(head, ast.Constant)
                  and head.value.startswith(
                      tmetrics_mod.REGISTRY_PREFIXES))
            name = ast.unparse(arg)
        else:
            continue  # a name computed elsewhere, as the reference allows
        if not ok:
            bad.append((node.lineno, kind, name))
    assert not bad


# -- spans and their exports --------------------------------------------------

def _span_program(m):
    """The same span tree on hub ``m``: a root, nested timer and literal
    spans, a worker thread adopting the root, a remote parent, an
    explicit-parent child ended from another thread and an error end."""
    with m.span("reduce_task", job="j", reduce=0) as root:
        with m.timer("fetch"):
            seg = m.start_span("fetch.segment", map="m0")
            with m.use_span(seg):
                with m.span("net.fetch", offset=0):
                    pass
            seg.end(error="StorageError")

        def worker():
            with m.use_span(root), m.span("merge.wait"):
                with m.timer("overlap_device_merge"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        remote = m.remote_parent(root.trace_id, root.span_id)
        with m.span("net.serve", parent=remote, map="m0"):
            with m.span("engine.pread"):
                pass
        late = m.start_span("merge.device_put", parent=root, rows=4)
        threading.Thread(target=late.end).start()
        time.sleep(0.01)
    assert m.current_span() is None


def _structure(spans):
    by_id = {s["id"]: s for s in spans}
    edges = sorted((by_id[s["parent"]]["name"] if s["parent"] in by_id
                    else "", s["name"]) for s in spans)
    traces = {s["trace"] for s in spans}
    return edges, len(traces), sorted(
        (s["name"], sorted(s.get("attrs", {}))) for s in spans)


def test_span_tree_matches_reference(tmp_path):
    out = []
    for mod in (jmetrics_mod, tmetrics_mod):
        m = mod.Metrics(stats=True)
        _span_program(m)
        assert all(set(s) >= {"name", "ts", "dur", "tid", "trace", "id",
                              "parent"} for s in m.spans)
        path = tmp_path / f"{mod.__name__}.json"
        m.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        jl = tmp_path / f"{mod.__name__}.jsonl"
        n = m.export_spans_jsonl(str(jl))
        recs = [json.loads(x) for x in jl.read_text().splitlines()]
        out.append((_structure(m.spans),
                    sorted({k for e in events for k in e}),
                    sorted({k for e in events for k in e["args"]}),
                    n, sorted({k for r in recs for k in r})))
    assert out[0] == out[1]


def test_spans_off_cost_nothing():
    m = tmetrics_mod.Metrics(stats=False)
    s = m.start_span("reduce_task")
    assert s.span_id is None and m.current_span() is None
    with m.span("reduce_task"), m.timer("fetch"):
        pass
    s.end()
    assert m.spans == [] and m.get("fetch_time") > 0
    m.enable_spans()
    with m.span("reduce_task"):
        pass
    assert [s["name"] for s in m.spans] == ["reduce_task"]
    m.reset()
    assert m.start_span("reduce_task").span_id is None


def _synthetic_spans(seed: int) -> list:
    """A seeded span list in the export shape: one root, children of
    random bucket names nested under it and under each other, some
    outside the root's trace, some spilling past its window."""
    rng = np.random.default_rng(seed)
    names = sorted(critpath.SPAN_BUCKETS) + ["emit_other", "mystery"]
    spans = [{"name": "reduce_task", "ts": 10.0, "dur": 5.0, "id": 1,
              "parent": None, "trace": 1, "tid": 1}]
    for i in range(2, 60):
        parent = spans[int(rng.integers(len(spans)))]
        lo = parent["ts"] + rng.random() * parent["dur"]
        dur = rng.random() * parent["dur"] * (1.4 if i % 7 == 0 else 0.6)
        spans.append({"name": names[int(rng.integers(len(names)))],
                      "ts": float(lo), "dur": float(dur), "id": i,
                      "parent": parent["id"],
                      "trace": 1 if i % 11 else 2, "tid": 1})
    spans.append({"kind": "profile", "span": "reduce_task"})
    return spans


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-9
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(6))
def test_critpath_partition_matches_reference(seed):
    spans = _synthetic_spans(seed)
    ref = jcritpath.analyze(spans)
    port = critpath.analyze(spans)
    _close(port, ref)
    total = sum(b["critical_s"] for b in port["buckets"].values())
    assert abs(total + port["idle_s"] - port["wall_s"]) <= 1e-5
    # rootless (a serve-only process) and empty
    _close(critpath.analyze(spans[1:]), jcritpath.analyze(spans[1:]))
    assert critpath.analyze([]) is None


def test_critpath_on_a_reference_export(tmp_path):
    """critpath.analyze over the span JSONL a reference reduce task wrote
    (the 6-map tree, stats on) gives the reference's partition to 1e-9."""
    make_mof_tree(str(tmp_path), "job", 6, 2, 300, seed=41)
    jmetrics.enable_stats()
    engine = JDataEngine(JDirIndexResolver(str(tmp_path)), JConfig())
    try:
        JMergeManager(JLocalFetchClient(engine), "uda.tpu.RawBytes",
                      JConfig({"uda.tpu.stats.enable": True})).run(
            "job", map_ids("job", 6), 1, lambda b: None)
    finally:
        engine.stop()
    path = tmp_path / "spans.jsonl"
    assert jmetrics.export_spans_jsonl(str(path)) > 6
    spans = [json.loads(x) for x in path.read_text().splitlines()]
    ref = jcritpath.analyze(spans)
    port = critpath.analyze(spans)
    _close(port, ref)
    assert port["root"] == "reduce_task"
    counters = {"fetch_time": 1.5, "overlap_stage_time": 0.25,
                "merge_time": 2.0, "emit_time": 0.5, "wait_mem_time": 0.1}
    assert critpath.buckets_from_counters(counters) == \
        jcritpath.buckets_from_counters(counters)


# -- reporter, exposition, flight recorder, snapshot -----------------------

def _fill(m, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(30):
        sup = f"h{int(rng.integers(3))}"
        m.add("fetch.bytes", float(rng.integers(1, 1 << 16)), supplier=sup)
        m.add("emit.bytes", float(rng.integers(1, 1 << 16)))
        m.add("merge.records", float(rng.integers(1, 100)))
        m.observe("fetch.latency_ms", float(rng.gamma(2.0, 4.0)),
                  supplier=sup)
        m.observe("fetch.chunk.bytes", float(rng.integers(1, 1 << 20)))
    m.add("fetch.retries", 2.0, supplier="h1")
    m.add("fetch_time", 1.25)
    m.gauge("tenant.jobs.active", 3.0)
    m.gauge_add("fetch.on_air", float(rng.integers(0, 4)))
    m.gauge("profile.hz", 0.0)


@pytest.mark.parametrize("seed", range(4))
def test_openmetrics_text_matches_reference(seed):
    texts = []
    for mod, om in ((jmetrics_mod, jopenmetrics),
                    (tmetrics_mod, openmetrics)):
        m = mod.Metrics(stats=True)
        _fill(m, seed)
        texts.append(om.render_openmetrics(m))
    assert texts[0] == texts[1]


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", range(3))
def test_reporter_records_match_reference(seed, tmp_path):
    recs = []
    for mod, smod in ((jmetrics_mod, jstats), (tmetrics_mod, tstats)):
        m = mod.Metrics(stats=True)
        clock = _Clock()
        out = tmp_path / f"{smod.__name__}.jsonl"
        rep = smod.StatsReporter(m, interval_s=1.0, out=str(out),
                                 clock=clock)
        _fill(m, seed)
        clock.t += 2.0
        one = rep.report_once()
        _fill(m, seed + 50)
        with m.span("reduce_task"):
            with m.timer("fetch"):
                pass
        clock.t += 0.5
        rep.stop(final=True)
        fin = rep.latest()
        lines = [json.loads(x) for x in out.read_text().splitlines()]
        recs.append(([sorted(one), one["counters"], one["rates"],
                      one["percentiles"], one["histograms"], one["gauges"],
                      one["uptime_s"], one["interval_s"]],
                     [sorted(fin), fin["rates"], fin["resledger"],
                      sorted(fin["time_accounting"]),
                      {k: v for k, v in fin["counters"].items()
                       if not k.endswith("_time")}],
                     len(lines)))
    assert recs[0] == recs[1]
    assert recs[1][2] == 2


def test_flightrec_dump_schema_matches_reference(tmp_path):
    docs = []
    for mod, hub in ((jflightrec_mod, jmetrics), (tflightrec_mod, metrics)):
        d = tmp_path / mod.__name__
        rec = mod.FlightRecorder(capacity=16, enabled=True, dump_dir=str(d))
        for i in range(20):  # overflows the ring: the newest 16 stay
            rec.record("segment.start", map=f"m{i}", supplier="h0")
        rec.record("failpoint", site="segment.fetch", action="error",
                   key="m3@h0")
        hub.add("fetch.bytes", 10.0)
        path = rec.dump("fallback", extra={"job": "j", "reduce": 1})
        assert re.fullmatch(rf"flightrec_{os.getpid()}_1_fallback\.json",
                            os.path.basename(path))
        doc = json.loads(Path(path).read_text())
        docs.append((sorted(doc), doc["cause"], doc["extra"],
                     [{k: v for k, v in e.items() if k != "ts"}
                      for e in doc["events"]], doc["counters"],
                     len(rec.reports)))
        off = mod.FlightRecorder(enabled=False)
        off.record("x")
        assert off.dump("y") is None and off.events() == []
    assert docs[0] == docs[1]
    assert len(docs[1][3]) == 16


def test_introspection_blocks_match_reference():
    out = []
    for mod, smod in ((jmetrics_mod, jstats), (tmetrics_mod, tstats)):
        m = mod.Metrics(stats=True)
        _fill(m, 7)
        smod.register_stats_provider("test.ok", lambda: {"a": 1})
        smod.register_stats_provider("test.bad", lambda: 1 / 0)
        try:
            snap = smod.introspection_snapshot(m)
        finally:
            smod.unregister_stats_provider("test.ok")
            smod.unregister_stats_provider("test.bad")
        out.append((sorted(snap), snap["percentiles"], snap["resledger"],
                    snap["providers"]["test.ok"],
                    snap["providers"]["test.bad"],
                    smod.percentiles_block(m),
                    smod.telemetry_block(m)["counters"]))
    assert out[0] == out[1]


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("UDA_TPU_XPROF", raising=False)
    with device_trace():  # unarmed: a no-op
        pass
    assert not list(tmp_path.iterdir())
    with device_trace(str(tmp_path)):
        x = torch.arange(1 << 12, dtype=torch.float32)
        (x * 2).sum()
    monkeypatch.setenv("UDA_TPU_XPROF", str(tmp_path / "env"))
    with device_trace():
        torch.ones(8).cumsum(0)
    for d in (tmp_path, tmp_path / "env"):
        files = glob.glob(str(d / "uda_trace_*.json"))
        assert len(files) == 1
        doc = json.loads(Path(files[0]).read_text())
        assert any(e.get("name", "").startswith("aten::")
                   for e in doc["traceEvents"])


def test_profiler_attributes_samples_to_spans():
    """A private profiler at 400 Hz charges a busy thread's samples to its
    span (self) and to the span's ancestors (total); its views have the
    reference's keys."""
    prof = tprofiler_mod.SamplingProfiler()
    assert not prof.armed and prof.hz == 0.0
    metrics.enable_spans()
    done = threading.Event()

    def busy():
        with metrics.span("reduce_task"), metrics.span("merge.wait"):
            x = np.arange(4096)
            while not done.is_set():
                (x * x).sum()

    t = threading.Thread(target=busy)
    prof.start(400.0)
    try:
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                prof.span_summary().get("merge.wait", {}).get("self",
                                                              0) < 5:
            time.sleep(0.02)
    finally:
        done.set()
        t.join()
        prof.stop()
    summ = prof.span_summary()
    assert summ["merge.wait"]["self"] >= 5
    assert summ["reduce_task"]["total"] >= summ["merge.wait"]["self"]
    ref = jprofiler_mod.SamplingProfiler()
    assert sorted(prof.summary()) == sorted(ref.summary())
    assert sorted(prof.recent_summary()) == sorted(ref.recent_summary())
    assert {r["span"] for r in prof.export_records()} >= {"merge.wait"}
    assert "merge.wait;" in prof.folded()
    assert metrics.get("profile.samples", span="merge.wait") >= 5
    assert tprofiler_mod.profile_hz_from_env() == \
        jprofiler_mod.profile_hz_from_env()


# -- the slice as a whole -----------------------------------------------------

@contextlib.contextmanager
def _armed_books(monkeypatch):
    """Both packages' process-wide ledger and lockdep armed."""
    for mod in (jled, tled):
        monkeypatch.setattr(mod.resledger, "enabled", True)
    for mod in (jlocks, tlocks):
        monkeypatch.setattr(mod.lockdep, "enabled", True)
    yield


# counters of the two planes the port leaves out for good (ROADMAP): the
# batched read plane's io_uring rung (the port's ladder lands on preadv:
# the rung's label differs) and the native row merge, whose pool-leased
# merge outputs count stage.buffer.reuses on the host engine
_NATIVE_ONLY = {"stage.buffer.reuses"}


def _norm_key(key: str, peers) -> str:
    for p in peers:
        key = key.replace(p, "<peer>")
    return re.sub(r"^io\.backend\{backend=\w+\}$",
                  "io.backend{backend=<rung>}", key)


def _fold_port_timers(spans: list, keys: set) -> tuple:
    """The port's spans and counter keys without its port-only timers
    (``critpath.PORT_SPAN_BUCKETS``: the emit's phase and stages): their
    spans are taken out, each child re-parented to the nearest ancestor
    the reference also has, and their ``<timer>_time`` keys dropped."""
    own = set(critpath.PORT_SPAN_BUCKETS)
    by_id = {s["id"]: s for s in spans}

    def parent(s):
        pid = s["parent"]
        while pid in by_id and by_id[pid]["name"] in own:
            pid = by_id[pid]["parent"]
        return pid

    return ([dict(s, parent=parent(s)) for s in spans
             if s["name"] not in own],
            {k for k in keys if k[:-len("_time")] not in own
             or not k.endswith("_time")})


def _run_task(side, root, transport, conf):
    """One reduce task over the 6-map tree through ``side``'s package:
    in process, or through its own ShuffleServer on 127.0.0.1. Returns
    the stream, the spans, the counter keys and the peers' names."""
    if side == "port":
        Eng, Res, Cfg, MM, Local, Router, net, hub = (
            DataEngine, DirIndexResolver, Config, MergeManager,
            LocalFetchClient, HostRoutingClient, tnet, metrics)
        extra = {"device": "cpu"}
    else:
        Eng, Res, Cfg, MM, Local, Router, net, hub = (
            JDataEngine, JDirIndexResolver, JConfig, JMergeManager,
            JLocalFetchClient, JHostRoutingClient, jnet, jmetrics)
        extra = {}
    hub.reset()
    hub.enable_stats()
    engine = Eng(Res(root), Cfg(conf))
    server = client = None
    peers = []
    mids = map_ids("job", 6)
    try:
        if transport == "wire":
            server = net.ShuffleServer(engine, Cfg(conf), host="127.0.0.1",
                                       port=0).start()
            peer = f"127.0.0.1:{server.port}"
            peers = [peer]
            client = Router(config=Cfg(conf))
            entries = [(peer, m) for m in mids]
        else:
            client = Local(engine)
            entries = mids
        out = bytearray()
        mm = MM(client, "uda.tpu.RawBytes", Cfg(conf), **extra)
        n = mm.run("job", entries, 1, out.extend)
        assert n == len(out)
    finally:
        if transport == "wire" and client is not None:
            client.stop()
        if server is not None:
            server.stop()
        engine.stop()
    spans = list(hub.spans)
    return bytes(out), spans, {_norm_key(k, peers) for k in hub.snapshot()
                               if k not in _NATIVE_ONLY}


@pytest.mark.parametrize("transport", ["local", "wire"])
def test_slice_matches_reference_armed(tmp_path, monkeypatch, transport):
    make_mof_tree(str(tmp_path), "job", 6, 2, 400, seed=43)
    # two events that only timing decides are forced alike in both
    # packages: the zero-copy rung (zerocopy.mode=auto times sendfile
    # against mmap once per process, so each package's first server in a
    # process may pick a different rung, net.sendfile.bytes against
    # net.mmap.bytes) is pinned, and the anomaly detectors armed with a
    # server stay in their warm-up (a p99 spike under load fires
    # anomaly.p99 in whichever package happened to see it)
    conf = {"uda.tpu.stats.enable": True, "mapred.rdma.buf.size": 4,
            "uda.tpu.flightrec.dir": str(tmp_path / "fr"),
            "uda.tpu.net.zerocopy.mode": "sendfile",
            "uda.tpu.anomaly.warmup": 1 << 30}
    with _armed_books(monkeypatch):
        ref = _run_task("ref", str(tmp_path), transport, conf)
        port = _run_task("port", str(tmp_path), transport, conf)
        port_leaks = tled.resledger.drain("test.slice")
        assert not tlocks.lockdep.cycles
    assert port[0] == ref[0] and port[0]
    # the port's emit timers nest under emit_phase, inside reduce_task
    assert {"emit_phase", "emit_gather", "emit_frame", "emit_deliver"} \
        <= {s["name"] for s in port[1]}
    port_spans, port_keys = _fold_port_timers(port[1], port[2])
    ref_struct, port_struct = _structure(ref[1]), _structure(port_spans)
    assert set(port_struct[0]) == set(ref_struct[0])  # (parent, child)
    assert {n for n, _ in port_struct[2]} == {n for n, _ in ref_struct[2]}
    assert port_keys == ref[2]
    assert port_leaks == []
    assert tled.resledger.leak_reports == []
    assert critpath.analyze(port[1])["root"] == "reduce_task"


def test_armed_stats_reply_decodes_in_the_reference(tmp_path):
    """Both packages' servers with the stats plane armed (the ring at
    50 ms, detectors, SLI book): the reference's wire decodes the port
    server's windowed MSG_STATS reply with the reference server's
    sections, keys for keys; the port's client reads the reference's."""
    make_mof_tree(str(tmp_path), "job", 2, 1, 50, seed=44)
    conf = {"uda.tpu.stats.enable": True, "uda.tpu.ts.interval.s": 0.05}
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
    jengine = JDataEngine(JDirIndexResolver(str(tmp_path)), JConfig(conf))
    server = tnet.ShuffleServer(engine, Config(conf), host="127.0.0.1",
                                port=0).start()
    jserver = jnet.ShuffleServer(jengine, JConfig(conf), host="127.0.0.1",
                                 port=0).start()
    try:
        from uda_tpu.utils.timeseries import timeseries as jtimeseries
        from uda_tpu_torch.utils.timeseries import timeseries
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                len(timeseries.window()) < 2
                or len(jtimeseries.window()) < 2):
            time.sleep(0.02)
        port_snap = jnet.fetch_remote_stats("127.0.0.1", server.port,
                                            window_s=5)
        ref_snap = jnet.fetch_remote_stats("127.0.0.1", jserver.port,
                                           window_s=5)
        cross = tnet.fetch_remote_stats("127.0.0.1", jserver.port,
                                        window_s=5)
    finally:
        server.stop()
        jserver.stop()
        engine.stop()
        jengine.stop()
    for key in ("timeseries", "sli", "anomalies"):
        assert key in port_snap and key in ref_snap and key in cross
        assert sorted(port_snap[key]) == sorted(ref_snap[key])
    assert sorted(port_snap) == sorted(ref_snap)
    assert port_snap["timeseries"]["running"] is True
    assert port_snap["timeseries"]["samples"] >= 2
    assert sorted(port_snap["timeseries"]["rollups"][-1]) == \
        sorted(ref_snap["timeseries"]["rollups"][-1])
    assert port_snap["anomalies"]["armed"] is True
    assert port_snap["sli"]["armed"] is True
    assert sorted(port_snap["providers"]) == sorted(ref_snap["providers"])
    assert sorted(port_snap["resledger"]) == sorted(ref_snap["resledger"])
