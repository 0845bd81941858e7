"""The port's timing of speculated chunks (``merger/segment.Segment``): the
``fetch_hedge`` timer, one race from its primary attempt's issue to the
completion that settles it, and the ``fetch.hedged.bytes`` counter, the
bytes a source that won a race serves from the winning chunk to the end
of its segment. Each race is driven by threading.Events, never by sleeps,
as in ``test_torch_speculation.py``: a held completion is released by the
event that has to have happened first.

The threshold a chunk must outlive to be raced is pN of the chunk
latencies observed, stats on or off: a speculating segment has the hub
keep that histogram (``SpeculationPolicy.keep_latencies``).

Also the supplier's side of a straggler: a read still queued in the
engine when its peer hangs up is dropped unread (``net/server`` hands the
engine the connection's ``is_open``), so a slow supplier's backlog of
answers no one waits for does not outlive the reduce task."""

import ast
import threading
import time
from pathlib import Path

import pytest

from helpers import make_mof_tree, map_ids
from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu_torch import merger, mofserver
from uda_tpu_torch.net.client import RemoteFetchClient
from uda_tpu_torch.net.server import EvLoopShuffleServer
from uda_tpu_torch.mofserver.data_engine import ShuffleRequest
from uda_tpu_torch.utils import critpath
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import MergeError
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import (METRICS_REGISTRY, PORT_METRICS,
                                         PORT_TIMERS, metrics)
from uda_tpu_torch.utils.retry import RetryPolicy, SpeculationPolicy

JOB = "job_hedge"
CHUNK = 4096
HEDGE, HEDGED = "fetch_hedge_time", "fetch.hedged.bytes"


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    yield
    metrics.reset()


class Held(merger.LocalFetchClient):
    """A LocalFetchClient whose fetches from the ``hold_from``-th on are
    delivered by a thread of their own once ``gate`` is set. ``issued`` is
    set at every issue; ``issues`` keeps each issue's clock reading."""

    def __init__(self, engine, gate=None, hold_from=0):
        super().__init__(engine)
        self.gate = gate
        self.hold_from = hold_from
        self.issued = threading.Event()
        self.issues: list = []
        self.calls = 0
        self.delivered = 0
        self._cv = threading.Condition()

    def start_fetch(self, req, on_complete):
        with self._cv:
            held = self.gate is not None and self.calls >= self.hold_from
            self.calls += 1
            self.issues.append(time.perf_counter())
        self.issued.set()

        def deliver(res):
            try:
                on_complete(res)
            finally:
                with self._cv:
                    self.delivered += 1
                    self._cv.notify_all()

        if not held:
            super().start_fetch(req, deliver)
            return

        def later(res):
            def run():
                assert self.gate.wait(10.0), "gate never opened"
                deliver(res)
            threading.Thread(target=run, daemon=True).start()

        super().start_fetch(req, later)

    def join(self):
        """Wait until every issued fetch has been delivered."""
        with self._cv:
            assert self._cv.wait_for(
                lambda: self.delivered == self.calls, timeout=10.0)


@pytest.fixture
def tree(tmp_path):
    """One map of 300 records of 40 B, about three 4 KiB chunks, and a
    DataEngine over it."""
    expected = make_mof_tree(str(tmp_path), JOB, 1, 1, 300, seed=32)
    eng = mofserver.DataEngine(mofserver.DirIndexResolver(str(tmp_path)),
                               Config())
    mid = map_ids(JOB, 1)[0]
    part = eng.resolver.resolve(JOB, mid, 0).part_length
    assert part > 2 * CHUNK
    yield eng, mid, sorted(expected[0]), part
    eng.stop()


# the straggler threshold: far above an unheld in-process chunk's latency
# on a loaded host, so that only the held chunk is raced
FLOOR_MS = 250


def _segment(router, mid, hosts, floor_ms=FLOOR_MS, pn=95):
    return merger.Segment(
        router, JOB, mid, 0, CHUNK, host=hosts[0], hosts=hosts,
        ledger=merger.RecoveryLedger(merger.PenaltyBox()),
        speculation=SpeculationPolicy(pn=pn, floor_ms=floor_ms),
        policy=RetryPolicy(retries=1))


def _hedges() -> list:
    return [s for s in metrics.spans if s["name"] == "fetch_hedge"]


def _won(tree):
    """The slow source serves the first chunk, then holds the second: the
    duplicate on the fast source wins, the segment stays there."""
    eng, mid, want, part = tree
    release = threading.Event()
    slow, fast = Held(eng, gate=release, hold_from=1), Held(eng)
    router = merger.HostRoutingClient({"slow": slow, "fast": fast}.get)
    seg = _segment(router, mid, ["slow", "fast"])
    seg.start()
    seg.wait(10.0)
    return seg, slow, fast, release, want, part


def test_a_won_race_is_timed_from_the_primarys_issue(tree):
    metrics.enable_spans()
    seg, slow, fast, release, want, part = _won(tree)
    try:
        assert sorted(seg.record_batch().iter_records()) == want
        assert seg.host == "fast"
        assert metrics.get("fetch.speculation.won") == 1
        (span,) = _hedges()
        # the race began when the slow source took the second chunk: the
        # span starts at the segment's issue, just before the client saw it
        assert 0 <= slow.issues[1] - span["ts"] < 0.05
        assert span["attrs"] == {"won": True}
        # the counter and the span each read the clock at the stop
        assert span["dur"] == pytest.approx(metrics.get(HEDGE), abs=1e-3)
        # the duplicate went out one floor after the issue at the earliest
        assert metrics.get(HEDGE) >= FLOOR_MS / 1e3
        assert fast.issues[0] - slow.issues[1] >= FLOOR_MS / 1e3
        # the bytes after the switch: every chunk but the first
        assert metrics.get("fetch.bytes") == part
        assert metrics.get(HEDGED) == part - CHUNK
        assert metrics.get(HEDGED, supplier="fast") == part - CHUNK
    finally:
        release.set()
        slow.join()


def test_the_losers_late_completion_changes_nothing(tree):
    metrics.enable_spans()
    seg, slow, fast, release, want, part = _won(tree)
    before = {k: metrics.get(k) for k in (HEDGE, HEDGED, "fetch.bytes",
                                          "fetch.chunks")}
    records = sorted(seg.record_batch().iter_records())
    release.set()                # the slow source answers only now
    slow.join()
    assert metrics.get("fetch.stale_completions") == 1
    assert {k: metrics.get(k) for k in before} == before
    assert sorted(seg.record_batch().iter_records()) == records == want
    assert seg.num_records == len(want)
    assert len(_hedges()) == 1
    assert metrics.get_gauge("fetch.on_air") == 0


def test_a_late_loser_never_reaches_a_released_segment(tree):
    seg, slow, fast, release, want, part = _won(tree)
    seg.release()                # streaming spooled the segment's bytes
    release.set()
    slow.join()
    assert metrics.get("fetch.stale_completions") == 1
    assert seg.batches == [] and seg.num_records == len(want)
    with pytest.raises(MergeError, match="released"):
        seg.record_batch()
    assert metrics.get(HEDGED) == part - CHUNK


def test_a_lost_race_is_timed_and_hedges_no_bytes(tree):
    """The primary holds its first chunk until the duplicate is issued,
    then answers first; the duplicate answers after the segment is
    done."""
    eng, mid, want, part = tree
    release_alt = threading.Event()
    alt = Held(eng, gate=release_alt)
    primary = Held(eng, gate=alt.issued)
    router = merger.HostRoutingClient({"primary": primary, "alt": alt}.get)
    seg = _segment(router, mid, ["primary", "alt"])
    try:
        seg.start()
        seg.wait(10.0)
        assert sorted(seg.record_batch().iter_records()) == want
        assert seg.host == "primary"
        assert metrics.get("fetch.speculation.lost") == 1
        assert metrics.get(HEDGE) >= FLOOR_MS / 1e3
        assert metrics.get(HEDGED) == 0
        assert metrics.get("fetch.bytes") == part
    finally:
        release_alt.set()
        alt.join()
        primary.join()
    assert metrics.get("fetch.stale_completions") == 1
    assert metrics.get(HEDGED) == 0


@pytest.mark.parametrize("policy", [{"floor_ms": 60_000}, {"pn": 0}],
                         ids=["under the threshold", "speculation off"])
def test_a_chunk_never_speculated_adds_neither(tree, policy):
    eng, mid, want, part = tree
    metrics.enable_spans()
    router = merger.HostRoutingClient(
        {"a": Held(eng), "b": Held(eng)}.get)
    seg = _segment(router, mid, ["a", "b"], **policy)
    seg.start()
    seg.wait(10.0)
    assert sorted(seg.record_batch().iter_records()) == want
    assert metrics.get("fetch.speculated") == 0
    assert metrics.get(HEDGE) == 0 and metrics.get(HEDGED) == 0
    assert HEDGE not in metrics.snapshot() and not _hedges()


def test_both_names_are_registered_as_the_ports_own():
    assert "fetch_hedge" in PORT_TIMERS
    assert critpath.PORT_SPAN_BUCKETS["fetch_hedge"] == "fetch"
    assert not PORT_TIMERS["fetch_hedge"].busy   # a wall, waits included
    assert HEDGED in METRICS_REGISTRY and HEDGED in PORT_METRICS
    assert METRICS_REGISTRY[HEDGED][0] == "counter"
    # the segment starts the timer by its literal name
    source = (Path(merger.__file__).parent / "segment.py").read_text()
    names = {node.args[0].value for node in ast.walk(ast.parse(source))
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", "") == "start_timer"}
    assert "fetch_hedge" in names


def test_start_timer_backdates_its_counter_and_span():
    metrics.enable_spans()
    t0 = time.perf_counter() - 0.5
    metrics.start_timer("fetch_hedge", t0=t0).stop()
    assert metrics.get(HEDGE) >= 0.5
    (span,) = _hedges()
    assert span["ts"] == t0 and span["dur"] >= 0.5


# -- the threshold: pN of the latencies observed, stats on or off -------------

def test_the_threshold_reads_latencies_observed_with_stats_off(tree):
    """A speculating segment has the hub keep the latency histogram its
    threshold reads: with stats off, pN of the chunks seen, not the floor
    alone."""
    eng, mid, want, part = tree
    assert not metrics.stats_enabled
    router = merger.HostRoutingClient({"a": Held(eng), "b": Held(eng)}.get)
    seg = _segment(router, mid, ["a", "b"], floor_ms=1)
    seg.start()
    seg.wait(10.0)
    assert metrics.histogram("fetch.latency_ms")["count"] == \
        metrics.get("fetch.chunks") >= 3
    # a supplier now answers in 400 ms: p95 follows, the floor does not
    for _ in range(100):
        metrics.observe("fetch.latency_ms", 400.0)
    assert 256 <= seg.speculation.threshold_ms() <= 400
    # the per-supplier series stay a stats-on record
    assert metrics.histogram("fetch.latency_ms", supplier="a")["count"] == 0


def test_without_speculation_the_latency_histogram_stays_off(tree):
    eng, mid, want, part = tree
    seg = _segment(merger.HostRoutingClient({"a": Held(eng)}.get), mid,
                   ["a"], pn=0)
    seg.start()
    seg.wait(10.0)
    metrics.observe("fetch.latency_ms", 400.0)
    assert metrics.percentile("fetch.latency_ms", 95) is None
    assert seg.speculation.threshold_ms() == FLOOR_MS
    # and a reset forgets a kept histogram
    SpeculationPolicy(pn=95).keep_latencies()
    metrics.reset()
    metrics.observe("fetch.latency_ms", 400.0)
    assert metrics.percentile("fetch.latency_ms", 95) is None


# -- the supplier: a gone peer's queued reads are dropped, not read ----------

@pytest.mark.parametrize("batch", ["on", "off"])
def test_a_hung_up_peers_queued_reads_are_dropped(tree, batch):
    """Eight chunk requests reach a supplier whose every read is held
    300 ms (one reader thread), and the reduce side hangs up. The read
    under way may finish; the seven still queued are dropped unread."""
    eng, mid, _, part = tree
    engine = mofserver.DataEngine(eng.resolver,
                                  Config({"uda.tpu.read.batch": batch}))
    n = 8
    hits = failpoints.hits["data_engine.pread"]
    with failpoints.scoped("data_engine.pread=delay:300"):
        server = EvLoopShuffleServer(engine, Config(), host="127.0.0.1",
                                     port=0).start()
        client = RemoteFetchClient("127.0.0.1", server.port, Config())
        try:
            for i in range(n):
                client.start_fetch(
                    ShuffleRequest(JOB, mid, 0, (i * 1024) % part, 1024),
                    lambda res: None)
            deadline = time.monotonic() + 10.0
            while metrics.get("net.requests") < n:
                assert time.monotonic() < deadline, "requests not received"
                time.sleep(0.005)
        finally:
            client.stop()
        try:
            deadline = time.monotonic() + 10.0
            while metrics.get_gauge("supplier.reads.on_air") > 0:
                assert time.monotonic() < deadline, "backlog never drained"
                time.sleep(0.01)
            # without the drop, each of the eight reads pays its 300 ms
            assert failpoints.hits["data_engine.pread"] - hits <= 1
            assert metrics.get("supplier.reads.dropped") >= n - 1
        finally:
            server.stop()
            engine.stop()
