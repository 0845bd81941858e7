"""The socket client's timers: ``net_read`` around the client loop
thread's read of a ready supplier connection and ``net_deliver`` around
the dispatcher thread's completion upcall (``uda_tpu_torch/net/
client.py``), on a reduce task that fetches 16 TeraSort map outputs from
4 ``EvLoopShuffleServer``s on 127.0.0.1, one connection each, against the
same task fetched in process and a plain NumPy stable merge; their spans
in the task's trace and the critical-path analyzer's reading of them
(``critpath.PORT_SPAN_BUCKETS``); and the registry of the port's own
timer names (``metrics.PORT_TIMERS``)."""

import ast
from pathlib import Path

import numpy as np
import pytest

from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                  MergeManager)
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.mofserver.writer import MOFWriter
from uda_tpu_torch.net.server import EvLoopShuffleServer
from uda_tpu_torch.utils import critpath
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import PORT_TIMERS, metrics

ROOT = Path(__file__).resolve().parent.parent
JOB = "nettimers"
NODES = 4
MAPS_PER_NODE = 4
RECORDS = 3000
NET_TIMERS = ("net_read", "net_deliver")
# 8 KiB chunks: a few dozen frames a map, so reads and upcalls repeat
CONF = {"mapred.rdma.buf.size": 8,
        "uda.tpu.net.zerocopy.mode": "sendfile"}


def _map_records(rng, n: int) -> list:
    """``n`` TeraSort records (10 B key, 90 B value) sorted by key, keys
    drawn from 4096 values so that equal keys meet across maps."""
    heads = rng.integers(0, 4096, n)
    keys = [int(h).to_bytes(2, "big") + bytes(8) for h in heads]
    vals = [rng.bytes(90) for _ in range(n)]
    order = sorted(range(n), key=lambda i: keys[i])
    return [(keys[i], vals[i]) for i in order]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One directory of map outputs a node, map ``m`` on node
    ``m // MAPS_PER_NODE``; the records of every map in map order."""
    base = tmp_path_factory.mktemp("nodes")
    rng = np.random.default_rng(22)
    dirs, maps = [], []
    for k in range(NODES):
        d = str(base / f"node{k}")
        w = MOFWriter(d, JOB)
        for m in range(k * MAPS_PER_NODE, (k + 1) * MAPS_PER_NODE):
            recs = _map_records(rng, RECORDS)
            w.write(f"map_{m:03d}", [recs])
            maps.append(recs)
        dirs.append(d)
    return dirs, maps


def _numpy_merge(maps: list) -> bytes:
    """The plain stable merge: every record in map order, stably sorted
    by its key's bytes, framed (vint 10, vint 90, key, value), then the
    EOF marker."""
    rec = np.frombuffer(b"".join(k + v for m in maps for k, v in m),
                        np.uint8).reshape(-1, 100)
    order = np.lexsort(rec[:, :10].T[::-1])
    head = np.tile(np.array([10, 90], np.uint8), (rec.shape[0], 1))
    return np.hstack([head, rec[order]]).tobytes() + b"\xff\xff"


def _entries(hosts) -> list:
    return [([hosts[m // MAPS_PER_NODE]], f"map_{m:03d}")
            for m in range(NODES * MAPS_PER_NODE)]


def _run(client, entries) -> bytes:
    out = bytearray()
    try:
        n = MergeManager(client, "uda.tpu.RawBytes", Config(CONF),
                         device="cpu").run(JOB, entries, 0, out.extend)
    finally:
        client.stop()
    assert n == len(out)
    return bytes(out)


@pytest.fixture
def engines(tree):
    dirs, _ = tree
    engines = [DataEngine(DirIndexResolver(d), Config(CONF)) for d in dirs]
    yield engines
    for e in engines:
        e.stop()


@pytest.fixture
def suppliers(engines):
    """4 servers on 127.0.0.1 over the nodes' engines: their addresses."""
    servers = [EvLoopShuffleServer(e, Config(CONF), host="127.0.0.1",
                                   port=0).start() for e in engines]
    yield [f"127.0.0.1:{s.port}" for s in servers]
    for s in servers:
        s.stop()


def _over_the_wire(suppliers) -> bytes:
    return _run(HostRoutingClient(config=Config(CONF)), _entries(suppliers))


def test_socket_path_matches_local_path_and_numpy(tree, engines,
                                                  suppliers):
    wire = _over_the_wire(suppliers)
    assert metrics.get("net.connects") == NODES
    assert all(metrics.get(t + "_time") > 0 for t in NET_TIMERS)
    metrics.reset()
    local = _run(HostRoutingClient(
        connect=lambda host: LocalFetchClient(engines[int(host[4:])])),
        _entries([f"node{k}" for k in range(NODES)]))
    assert all(metrics.get(t + "_time") == 0 for t in NET_TIMERS)
    assert metrics.get("net.connects") == 0
    assert wire == local == _numpy_merge(tree[1])
    assert len(wire) > 4 << 20


def _ancestors(span: dict, by_id: dict) -> list:
    names = []
    while span.get("parent") in by_id:
        span = by_id[span["parent"]]
        names.append(span["name"])
    return names


def test_net_timer_spans_sit_under_the_reduce_task(suppliers):
    metrics.enable_stats()
    _over_the_wire(suppliers)
    spans = list(metrics.spans)
    by_id = {s["id"]: s for s in spans}
    (root,) = [s for s in spans if s["name"] == "reduce_task"]
    net = [s for s in spans if s["name"] in NET_TIMERS]
    assert {s["name"] for s in net} == set(NET_TIMERS)
    for s in net:
        assert s["trace"] == root["trace"], s
        assert "reduce_task" in _ancestors(s, by_id), s
    # each counter holds its spans' time, less the span's own bookkeeping
    # around the timed block
    for t in NET_TIMERS:
        spanned = sum(s["dur"] for s in net if s["name"] == t)
        assert 0.8 * spanned <= metrics.get(t + "_time") <= spanned
    # the analyzer charges them to fetch
    block = critpath.analyze([root] + net)
    busy = {b: v["busy_s"] for b, v in block["buckets"].items()}
    lo, hi = root["ts"], root["ts"] + root["dur"]
    inside = sum(min(s["ts"] + s["dur"], hi) - max(s["ts"], lo)
                 for s in net if s["ts"] < hi and s["ts"] + s["dur"] > lo)
    assert busy["fetch"] == pytest.approx(inside, abs=1e-5) and inside > 0
    assert sum(v for b, v in busy.items() if b != "fetch") == 0
    assert critpath.analyze(spans)["buckets"]["fetch"]["critical_s"] > 0


def test_fetch_and_read_splits_fire_where_the_work_happens(suppliers):
    """The fetch completions' splits (``fetch_crack`` a chunk,
    ``fetch_issue`` a chunk but each segment's last, ``fetch_handoff`` a
    segment) nest in ``net_deliver``; ``net_recv`` (a counter, no span)
    in ``net_read``; the task thread's ``task_setup``, ``merge_collect``
    and ``task_teardown`` fire once a task, ``client_stop`` once for the
    routing client and once for each of its connections."""
    metrics.enable_stats()
    _over_the_wire(suppliers)
    segments = NODES * MAPS_PER_NODE
    chunks = metrics.get("fetch.chunks")
    assert chunks > 2 * segments
    count = {}
    for s in metrics.spans:
        count[s["name"]] = count.get(s["name"], 0) + 1
    assert count["fetch_crack"] == chunks
    assert count["fetch_issue"] == chunks - segments
    assert count["fetch_handoff"] == segments
    assert count["task_setup"] == count["merge_collect"] == 1
    assert count["task_teardown"] == 1
    assert count["client_stop"] == 1 + NODES
    assert "net_recv" not in count
    split = sum(metrics.get(t + "_time")
                for t in ("fetch_crack", "fetch_issue", "fetch_handoff"))
    assert 0 < split <= metrics.get("net_deliver_time")
    assert 0 < metrics.get("net_recv_time") <= metrics.get("net_read_time")
    # the splits' spans sit under their net_deliver's
    by_id = {s["id"]: s for s in metrics.spans}
    for s in metrics.spans:
        if s["name"] in ("fetch_crack", "fetch_issue", "fetch_handoff"):
            assert by_id[s["parent"]]["name"] == "net_deliver", s


def test_buckets_from_counters_adds_the_net_timers_to_fetch():
    got = critpath.buckets_from_counters(
        {"fetch_time": 2.0, "net_read_time": 0.5,
         "net_deliver_time": 0.25})
    assert got["buckets"]["fetch"] == 2.75


def _timer_names(package: str) -> set:
    """Every literal name passed to ``metrics.timer``,
    ``metrics.start_timer`` or ``metrics.add_time`` in a package."""
    names = set()
    for path in (ROOT / package).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("timer", "start_timer",
                                           "add_time")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                names.add(node.args[0].value)
    return names


# port-only timers of ops/merge.py's two-phase merge (overlap off), older
# than the registry; critpath leaves them in "other"
UNREGISTERED = {"merge.rows", "merge.fold", "merge.gather"}


def test_every_port_only_timer_is_registered_and_bucketed():
    port, ref = _timer_names("uda_tpu_torch"), _timer_names("uda_tpu")
    assert set(NET_TIMERS) <= port
    assert port - ref == set(PORT_TIMERS) | UNREGISTERED
    assert not set(PORT_TIMERS) & ref
    assert set(critpath.PORT_SPAN_BUCKETS) == set(PORT_TIMERS)
    assert {critpath.PORT_SPAN_BUCKETS[t] for t in NET_TIMERS} == {"fetch"}


def test_start_timer_stops_once_from_another_thread():
    """``metrics.start_timer``: the counter and the span are kept once,
    by the first ``stop``, whichever thread calls it."""
    import threading

    from uda_tpu_torch.utils.metrics import Metrics

    for spans in (False, True):
        m = Metrics(stats=spans)
        with m.span("reduce_task") as root:
            timer = m.start_timer("coding_recover")
        assert m.current_span() is None
        stoppers = [threading.Thread(target=timer.stop, kwargs={"n": i})
                    for i in range(4)]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in stoppers)
        timer.stop()
        took = m.get("coding_recover_time")
        assert took > 0
        named = [s for s in m.spans if s["name"] == "coding_recover"]
        if spans:
            assert len(named) == 1 and named[0]["parent"] == root.span_id
            assert named[0]["dur"] == pytest.approx(took, rel=0.2)
        else:
            assert named == []
