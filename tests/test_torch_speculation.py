"""The port's speculative dual-source fetch, mid-partition resume and
per-host routing (uda_tpu_torch.merger.segment) against the JAX package's
on the same inputs. Each race is driven by threading.Events, never by
sleeps: a held completion is released by the event that the scenario
needs to have happened first, so the winner is decided by construction.
The same scenario runs through both packages and must end the same way:
the same records, the same source, the same counters."""

import threading
import types

import numpy as np
import pytest

from helpers import make_mof_tree, map_ids
from uda_tpu import merger as jmerger
from uda_tpu import mofserver as jmofserver
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils import retry as jretry
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import IFileWriter as JIFileWriter
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import merger, mofserver
from uda_tpu_torch.utils import errors, retry
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics

JOB = "job_spec"
RAW = "uda.tpu.RawBytes"

PORT = types.SimpleNamespace(
    name="port", m=merger, mof=mofserver, err=errors, retry=retry,
    Config=Config, metrics=metrics, failpoints=failpoints,
    manager=lambda client, conf: merger.MergeManager(
        client, RAW, Config(conf), device="cpu"))
REF = types.SimpleNamespace(
    name="ref", m=jmerger, mof=jmofserver, err=jerrors, retry=jretry,
    Config=JConfig, metrics=jmetrics, failpoints=jfailpoints,
    manager=lambda client, conf: jmerger.MergeManager(
        client, RAW, JConfig(conf)))
SIDES = [PORT, REF]


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    yield
    metrics.reset()


def _client_cls(pkg):
    """A LocalFetchClient of ``pkg`` whose completions are held: each
    fetch (or its failure, when ``fail`` is set) is delivered by a thread
    that first waits for ``gate``. ``issued`` is set at every issue."""

    class Gated(pkg.m.LocalFetchClient):
        def __init__(self, engine, gate=None, fail=False, issued=None,
                     on_fail=None):
            super().__init__(engine)
            self.gate = gate
            self.fail = fail
            self.issued = issued or threading.Event()
            self.on_fail = on_fail
            self.calls = 0
            self.delivered = 0
            self._cv = threading.Condition()

        def _later(self, deliver):
            def run():
                if self.gate is not None:
                    assert self.gate.wait(10.0), "gate never opened"
                try:
                    deliver()
                finally:
                    with self._cv:
                        self.delivered += 1
                        self._cv.notify_all()
            threading.Thread(target=run, daemon=True).start()

        def start_fetch(self, req, on_complete):
            with self._cv:
                self.calls += 1
            self.issued.set()
            if self.fail:
                def fail():
                    on_complete(pkg.err.TransportError(
                        f"down ({req.host})"))
                    if self.on_fail is not None:
                        self.on_fail.set()
                self._later(fail)
                return
            super().start_fetch(
                req, lambda res: self._later(lambda: on_complete(res)))

        def join(self):
            """Wait until every issued fetch has been delivered."""
            with self._cv:
                assert self._cv.wait_for(
                    lambda: self.delivered == self.calls, timeout=10.0)

    return Gated


def _tree(tmp_path, n=150, seed=8):
    expected = make_mof_tree(str(tmp_path), JOB, 1, 1, n, seed=seed)
    return sorted(expected[0]), map_ids(JOB, 1)[0]


def _segment(pkg, router, mid, hosts, floor_ms=5, retries=1, pn=95):
    return pkg.m.Segment(
        router, JOB, mid, 0, 1 << 20, host=hosts[0], hosts=hosts,
        ledger=pkg.m.RecoveryLedger(pkg.m.PenaltyBox()),
        speculation=pkg.retry.SpeculationPolicy(pn=pn, floor_ms=floor_ms),
        policy=pkg.retry.RetryPolicy(retries=retries))


def _won(pkg, tmp_path):
    want, mid = _tree(tmp_path)
    eng = pkg.mof.DataEngine(pkg.mof.DirIndexResolver(str(tmp_path)),
                             pkg.Config())
    release = threading.Event()
    Gated = _client_cls(pkg)
    slow, fast = Gated(eng, gate=release), Gated(eng)
    router = pkg.m.HostRoutingClient({"slow": slow, "fast": fast}.get)
    seg = _segment(pkg, router, mid, ["slow", "fast"])
    try:
        seg.start()
        seg.wait(10.0)
        got = sorted(seg.record_batch().iter_records())
        out = {"host": seg.host, "records": got == want,
               "speculated": pkg.metrics.get("fetch.speculated") >= 1,
               "won": pkg.metrics.get("fetch.speculation.won") >= 1,
               "lost": pkg.metrics.get("fetch.speculation.lost")}
        release.set()            # the slow primary answers only now
        slow.join()
        out["stale"] = pkg.metrics.get("fetch.stale_completions") >= 1
        out["n"] = seg.num_records == len(want)
        out["on_air"] = pkg.metrics.get_gauge("fetch.on_air")
    finally:
        release.set()
        eng.stop()
    return out


def test_speculation_won_switches_to_the_faster_source(tmp_path):
    """A fetch held on the slow replica gets a duplicate on the ranked
    alternate; the duplicate wins, the segment stays on the faster
    source, and the slow completion, released after, is dropped as
    stale."""
    got = _won(PORT, tmp_path / "port")
    assert got == _won(REF, tmp_path / "ref")
    assert got == {"host": "fast", "records": True, "speculated": True,
                   "won": True, "lost": 0, "stale": True, "n": True,
                   "on_air": 0}


def _lost(pkg, tmp_path):
    want, mid = _tree(tmp_path, 120, 9)
    eng = pkg.mof.DataEngine(pkg.mof.DirIndexResolver(str(tmp_path)),
                             pkg.Config())
    spec_issued, release_alt = threading.Event(), threading.Event()
    Gated = _client_cls(pkg)
    alt = Gated(eng, gate=release_alt, issued=spec_issued)
    primary = Gated(eng, gate=spec_issued)   # answers once raced
    router = pkg.m.HostRoutingClient({"primary": primary, "alt": alt}.get)
    seg = _segment(pkg, router, mid, ["primary", "alt"])
    try:
        seg.start()
        seg.wait(10.0)
        out = {"host": seg.host,
               "records": sorted(seg.record_batch().iter_records()) == want,
               "speculated": pkg.metrics.get("fetch.speculated") >= 1,
               "won": pkg.metrics.get("fetch.speculation.won"),
               "lost": pkg.metrics.get("fetch.speculation.lost") >= 1}
        release_alt.set()        # the loser's completion lands late
        alt.join()
        primary.join()
        out["stale"] = pkg.metrics.get("fetch.stale_completions") >= 1
        out["n"] = seg.num_records == len(want)   # no double ingest
        out["on_air"] = pkg.metrics.get_gauge("fetch.on_air")
    finally:
        release_alt.set()
        eng.stop()
    return out


def test_speculation_lost_late_completion_discarded(tmp_path):
    got = _lost(PORT, tmp_path / "port")
    assert got == _lost(REF, tmp_path / "ref")
    assert got == {"host": "primary", "records": True, "speculated": True,
                   "won": 0, "lost": True, "stale": True, "n": True,
                   "on_air": 0}


def _both_fail(pkg, tmp_path, order):
    _, mid = _tree(tmp_path, 30, 10)
    eng = pkg.mof.DataEngine(pkg.mof.DirIndexResolver(str(tmp_path)),
                             pkg.Config())
    spec_issued, a_failed, b_failed = (threading.Event() for _ in range(3))
    Gated = _client_cls(pkg)
    if order == "duplicate_first":
        # the duplicate fails first, the primary after it
        b = Gated(eng, fail=True, issued=spec_issued, on_fail=b_failed)
        a = Gated(eng, fail=True, gate=b_failed, on_fail=a_failed)
    else:
        # the primary fails first (the duplicate is promoted), then the
        # duplicate: the second failure is the sole live attempt's
        a = Gated(eng, fail=True, gate=spec_issued, on_fail=a_failed)
        b = Gated(eng, fail=True, gate=a_failed, issued=spec_issued,
                  on_fail=b_failed)
    router = pkg.m.HostRoutingClient({"a": a, "b": b}.get)
    seg = _segment(pkg, router, mid, ["a", "b"])
    try:
        seg.start()
        with pytest.raises(pkg.err.TransportError):
            seg.wait(10.0)   # a stranded attempt group would hang here
        for c in (a, b):
            c.join()
        return {"retries": pkg.metrics.get("fetch.retries") >= 1,
                "speculated": pkg.metrics.get("fetch.speculated") >= 1,
                "on_air": pkg.metrics.get_gauge("fetch.on_air"),
                "done": seg._done.is_set()}
    finally:
        for ev in (spec_issued, a_failed, b_failed):
            ev.set()
        eng.stop()


@pytest.mark.parametrize("order", ["duplicate_first", "primary_first"])
def test_both_racing_attempts_failing_still_retries(tmp_path, order):
    got = _both_fail(PORT, tmp_path / "port", order)
    assert got == _both_fail(REF, tmp_path / "ref", order)
    assert got == {"retries": True, "speculated": True, "on_air": 0,
                   "done": True}


def test_a_transport_that_refuses_duplicates_is_never_raced(tmp_path):
    want, mid = _tree(tmp_path, 100, 19)
    eng = mofserver.DataEngine(mofserver.DirIndexResolver(str(tmp_path)),
                               Config())
    release = threading.Event()

    class NoDuplicates(_client_cls(PORT)):
        def speculate_ok(self):
            return False

    client = NoDuplicates(eng, gate=release)
    seg = _segment(PORT, client, mid, [""], floor_ms=1)
    try:
        seg.start()
        assert client.issued.wait(10.0)
        threading.Timer(0.05, release.set).start()
        seg.wait(10.0)
    finally:
        release.set()
        eng.stop()
    assert sorted(seg.record_batch().iter_records()) == want
    assert metrics.get("fetch.speculated") == 0
    assert metrics.get("fetch.penalties") == 0


def test_speculation_policy_threshold_reads_the_histogram():
    """Stats off: the floor alone; stats on: the pN of fetch.latency_ms
    by the reference's bucket estimate, equal to the reference's."""
    pol = retry.SpeculationPolicy(pn=95, floor_ms=40.0)
    jpol = jretry.SpeculationPolicy(pn=95, floor_ms=40.0)
    samples = [10.0] * 90 + [400.0] * 10
    metrics.disable_stats()
    for v in samples:
        metrics.observe("fetch.latency_ms", v)
    assert pol.threshold_ms() == 40.0    # stats off: nothing recorded
    metrics.enable_stats()
    jmetrics.enable_stats()
    for v in samples:
        metrics.observe("fetch.latency_ms", v, supplier="h0")
        jmetrics.observe("fetch.latency_ms", v, supplier="h0")
    assert pol.threshold_ms() == jpol.threshold_ms() > 40.0
    for p in (0, 50, 95, 99, 100):
        assert metrics.percentile("fetch.latency_ms", p) == \
            jmetrics.percentile("fetch.latency_ms", p)
        assert metrics.percentile("fetch.latency_ms", p, supplier="h0") \
            == jmetrics.percentile("fetch.latency_ms", p, supplier="h0")
    assert metrics.percentile("nothing.here", 50) is None
    assert not retry.SpeculationPolicy(pn=0).enabled
    metrics.reset()
    assert metrics.percentile("fetch.latency_ms", 95) is None


@pytest.mark.parametrize("conf", [
    {}, {"uda.tpu.fetch.speculate.pn": 95},
    {"uda.tpu.fetch.speculate.pn": 250,
     "uda.tpu.fetch.speculate.floor.ms": -3}])
def test_speculation_policy_from_config_matches_reference(conf):
    got = retry.SpeculationPolicy.from_config(Config(conf))
    want = jretry.SpeculationPolicy.from_config(JConfig(conf))
    assert (got.pn, got.floor_ms, got.enabled) == \
        (want.pn, want.floor_ms, want.enabled)


# -- replicas and speculation through MergeManager.run ------------------------

def _replica_run(pkg, root, mids, conf):
    """Every map listed on the replicas ["slow", "fast"] (two engines over
    one root); the slow replica holds every answer until the run is
    over -> (bytes, stream, counters)."""
    engines = [pkg.mof.DataEngine(pkg.mof.DirIndexResolver(root),
                                  pkg.Config(conf)) for _ in range(2)]
    release = threading.Event()
    Gated = _client_cls(pkg)
    clients = {"slow": Gated(engines[0], gate=release),
               "fast": Gated(engines[1])}
    mm = pkg.manager(pkg.m.HostRoutingClient(clients.get), conf)
    out = bytearray()
    try:
        n = mm.run(JOB, [(["slow", "fast"], m) for m in mids], 0,
                   out.extend)
    finally:
        release.set()
        clients["slow"].join()
        for e in engines:
            e.stop()
    return n, bytes(out), {k: pkg.metrics.get(k) for k in (
        "fetch.speculated", "fetch.speculation.won", "fallback.signals")}


@pytest.mark.parametrize("mode", [{}, {"uda.tpu.merge.overlap": False}])
def test_replicated_maps_speculate_to_the_reference_stream(tmp_path, mode):
    make_mof_tree(str(tmp_path), JOB, 3, 1, 120, seed=4)
    mids = map_ids(JOB, 3)
    conf = dict(mode, **{"uda.tpu.fetch.speculate.pn": 95,
                         "uda.tpu.fetch.speculate.floor.ms": 5})
    got = _replica_run(PORT, str(tmp_path), mids, conf)
    want = _replica_run(REF, str(tmp_path), mids, conf)
    assert got == want
    assert got[2] == {"fetch.speculated": 3, "fetch.speculation.won": 3,
                      "fallback.signals": 0}


def test_replica_entries_without_speculation_match_reference(tmp_path):
    make_mof_tree(str(tmp_path), JOB, 3, 1, 60, seed=5)
    mids = map_ids(JOB, 3)
    outs = []
    for pkg in SIDES:
        eng = pkg.mof.DataEngine(pkg.mof.DirIndexResolver(str(tmp_path)),
                                 pkg.Config())
        local = pkg.m.LocalFetchClient(eng)
        mm = pkg.manager(pkg.m.HostRoutingClient(lambda h: local), {})
        out = bytearray()
        try:
            mm.run(JOB, [(["a", "b"], mids[0]), ("a", mids[1]),
                         ([], mids[2])], 0, out.extend)
        finally:
            eng.stop()
        outs.append(bytes(out))
    assert outs[0] == outs[1] and len(outs[0]) > 2


# -- mid-partition resume ------------------------------------------------------

def _ifile_blob(records) -> bytes:
    import io

    buf = io.BytesIO()
    w = JIFileWriter(buf)
    for k, v in records:
        w.append(k, v)
    w.close()
    return buf.getvalue()


def _records(num: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return sorted((rng.bytes(10), rng.bytes(24)) for _ in range(num))


def _swapping(pkg, resume: bool):
    """Serves 64-byte chunks of map attempt A, faults once mid-stream,
    then serves attempt B (another map attempt's output)."""
    recs_a, recs_b = _records(12, 21), _records(30, 22)
    part_a, part_b = _ifile_blob(recs_a), _ifile_blob(recs_b)

    class Swapping(pkg.m.LocalFetchClient):
        def __init__(self):
            self.phase = 0
            self.offsets = []

        def start_fetch(self, req, on_complete):
            self.offsets.append(req.offset)
            blob = part_a if self.phase == 0 else part_b
            if self.phase == 0 and req.offset >= 64:
                self.phase = 1
                on_complete(pkg.err.TransportError("supplier bounced"))
                return
            chunk = blob[req.offset:req.offset + 64]
            on_complete(pkg.mof.FetchResult(
                chunk, len(blob), len(blob), req.offset, "/x",
                last=req.offset + len(chunk) >= len(blob)))

    client = Swapping()
    seg = pkg.m.Segment(client, JOB, "m0", 0, 64,
                        policy=pkg.retry.RetryPolicy(retries=3),
                        resume=resume)
    seg.start()
    seg.wait(10.0)
    return {"records": sorted(seg.record_batch().iter_records()) == recs_b,
            "resumed": pkg.metrics.get("fetch.resumed"),
            "invalidated": pkg.metrics.get("fetch.resume.invalidated"),
            "offsets": client.offsets}


@pytest.mark.parametrize("resume", [True, False])
def test_resume_identity_check_restarts_a_changed_partition(resume):
    """A resumed fetch whose first chunk reports another partition
    identity (raw_length) never splices two attempts' bytes: the check
    restarts the fetch from zero, and the segment ends with the new
    attempt's records only; without resume the retry starts from zero."""
    got = _swapping(PORT, resume)
    assert got == _swapping(REF, resume)
    assert got["records"]
    assert (got["resumed"], got["invalidated"]) == \
        ((1, 1) if resume else (0, 0))
    assert got["offsets"][:3] == [0, 64, 64 if resume else 0]


def _counting_engine(pkg, root, conf):
    """A DataEngine of ``pkg`` that counts reads per (map, offset)."""

    class Counting(pkg.mof.DataEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.reads: dict = {}
            self._mu = threading.Lock()

        def submit(self, req):
            with self._mu:
                key = (req.map_id, req.offset)
                self.reads[key] = self.reads.get(key, 0) + 1
            return super().submit(req)

    return Counting(pkg.mof.DirIndexResolver(root), pkg.Config(conf))


def _resumed_run(pkg, root, mids, conf, fault, reads=None):
    eng = _counting_engine(pkg, root, conf)
    if reads is not None:
        reads.append(eng.reads)
    mm = pkg.manager(pkg.m.LocalFetchClient(eng), conf)
    out = bytearray()
    try:
        with pkg.failpoints.scoped(fault):
            n = mm.run(JOB, mids, 0, out.extend)
    finally:
        eng.stop()
    return n, bytes(out), eng.reads, {k: pkg.metrics.get(k) for k in (
        "fetch.resumed", "failpoint.data_engine.pread", "fetch.retries")}


@pytest.mark.parametrize("mode", [{}, {"uda.tpu.merge.overlap": False}])
def test_a_mid_partition_fault_resumes_from_its_offset(tmp_path, mode):
    """One transport fault mid-partition in each map, through the
    failpoint registry (one fetch in flight, so every N-th read of the
    task is one map's N-th or later chunk): each map resumes at the
    faulted offset, no map's offset 0 is read twice, and the stream is
    the reference's under the same schedule."""
    make_mof_tree(str(tmp_path), JOB, 3, 1, 150, seed=14)
    mids = map_ids(JOB, 3)
    conf = dict(mode, **{"uda.tpu.fetch.resume": True,
                         "mapred.rdma.buf.size": 1,
                         "mapred.rdma.wqe.per.conn": 1})
    chunks = -(-_partition_bytes(str(tmp_path), mids[0]) // 1024)
    fault = f"data_engine.pread=error:transport:every:{chunks}"
    got = _resumed_run(PORT, str(tmp_path), mids, conf, fault)
    want = _resumed_run(REF, str(tmp_path), mids, conf, fault)
    assert got[:2] == want[:2]
    assert got[3] == want[3]
    assert got[3]["fetch.resumed"] == len(mids)
    assert got[3]["failpoint.data_engine.pread"] == len(mids)
    assert all(got[2][(m, 0)] == 1 for m in mids)
    assert metrics.get("fetch.resumed.bytes") > 0
    assert max(got[2].values()) == 2   # the faulted offsets, read again


def test_without_resume_the_same_schedule_refetches_from_zero(tmp_path):
    """The same schedule with resume off: every retry refetches from
    offset 0 and meets the fault at the same chunk again, so the task
    falls back in both packages, having read offset 0 once per attempt
    (the livelock that resume exists to break)."""
    make_mof_tree(str(tmp_path), JOB, 1, 1, 150, seed=15)
    mids = map_ids(JOB, 1)
    conf = {"mapred.rdma.buf.size": 1, "uda.tpu.merge.overlap": False,
            "uda.tpu.fetch.retries": 2}
    chunks = -(-_partition_bytes(str(tmp_path), mids[0]) // 1024)
    fault = f"data_engine.pread=error:transport:every:{chunks}"
    reads = []
    for pkg in SIDES:
        with pytest.raises(pkg.err.FallbackSignal):
            _resumed_run(pkg, str(tmp_path), mids, conf, fault,
                         reads=reads)
    assert reads[0] == reads[1]
    assert reads[0][(mids[0], 0)] == 3
    assert metrics.get("fetch.resumed") == 0


def _partition_bytes(root: str, mid: str) -> int:
    rec = mofserver.DirIndexResolver(root).resolve(JOB, mid, 0)
    return rec.part_length


# -- the per-host router -------------------------------------------------------

def test_host_routing_client_connects_lazily_once_per_host(tmp_path):
    """Maps on two hosts (separate roots and engines): one connect per
    host, not per fetch; the stream equals the reference's through its
    router; an unknown host completes the fetch with the connect
    error."""
    roots = {h: tmp_path / h for h in ("hostA", "hostB")}
    for i, (h, root) in enumerate(sorted(roots.items())):
        root.mkdir()
        make_mof_tree(str(root), JOB, 2, 1, 25, seed=100 + i)
    maps = ([("hostA", m) for m in map_ids(JOB, 2)]
            + [("hostB", m) for m in map_ids(JOB, 2)])
    outs, connects = [], []
    for pkg in SIDES:
        engines = {h: pkg.mof.DataEngine(pkg.mof.DirIndexResolver(str(r)),
                                         pkg.Config())
                   for h, r in roots.items()}
        seen = []

        def connect(host, pkg=pkg, engines=engines, seen=seen):
            seen.append(host)
            return pkg.m.LocalFetchClient(engines[host])

        router = pkg.m.HostRoutingClient(connect)
        out = bytearray()
        try:
            pkg.manager(router, {}).run(JOB, maps, 0, out.extend)
            errs = []
            router.start_fetch(pkg.mof.ShuffleRequest(JOB, "m", 0, 0, 10,
                                                      host="nope"),
                               errs.append)
            assert errs and isinstance(errs[0], KeyError)
        finally:
            for e in engines.values():
                e.stop()
        outs.append(bytes(out))
        connects.append(sorted(seen))
    assert outs[0] == outs[1]
    # one connect per host over the whole task, and one for the unknown
    assert connects[0] == connects[1] == ["hostA", "hostB", "nope"]


def test_host_routing_client_without_connect_is_refused():
    """The refusal is lifted (``net`` is ported): without ``connect`` the
    router dials ``host[:port]`` over sockets as the reference's does; a
    supplier nobody listens for fails the fetch with TransportError."""
    from uda_tpu_torch.net import RemoteFetchClient

    for router, jrouter in ((merger.HostRoutingClient(),
                             jmerger.HostRoutingClient()),
                            (merger.HostRoutingClient(config=Config()),
                             jmerger.HostRoutingClient(config=JConfig()))):
        got = router._connect("127.0.0.1:1")
        want = jrouter._connect("127.0.0.1:1")
        assert isinstance(got, RemoteFetchClient)
        assert (got.host, got.port) == (want.host, want.port)
        box, done = [], threading.Event()
        router.start_fetch(
            mofserver.ShuffleRequest(JOB, "m", 0, 0, 64, host="127.0.0.1:1"),
            lambda res: (box.append(res), done.set()))
        assert done.wait(30)
        assert isinstance(box[0], errors.TransportError)
        router.stop()
        jrouter.stop()


def test_a_losing_concurrent_connect_is_torn_down():
    both_in = threading.Barrier(2, timeout=10.0)
    made = []

    class Transport(merger.InputClient):
        def __init__(self):
            self.stopped = False
            self.fetched = []

        def start_fetch(self, req, on_complete):
            self.fetched.append(req.map_id)
            on_complete(req.map_id)

        def stop(self):
            self.stopped = True

    def connect(host):
        t = Transport()
        made.append(t)
        both_in.wait()        # both threads are inside connect at once
        return t

    router = merger.HostRoutingClient(connect)
    results = []

    def fetch(i):
        router.start_fetch(mofserver.ShuffleRequest(JOB, f"m{i}", 0, 0, 1,
                                                    host="h"),
                           results.append)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    assert sorted(results) == ["m0", "m1"]
    assert len(made) == 2 and sum(t.stopped for t in made) == 1
    winner = next(t for t in made if not t.stopped)
    assert sorted(winner.fetched) == ["m0", "m1"]
    router.stop()
    assert winner.stopped
    errs = []
    router.start_fetch(mofserver.ShuffleRequest(JOB, "m", 0, 0, 1, host="h"),
                       errs.append)
    assert isinstance(errs[0], errors.MergeError)


def test_host_routing_estimate_fans_out_per_host(tmp_path):
    roots = {h: tmp_path / h for h in ("a", "b")}
    for i, root in enumerate(roots.values()):
        root.mkdir()
        make_mof_tree(str(root), JOB, 2, 1, 30, seed=40 + i)
    engines = {h: mofserver.DataEngine(mofserver.DirIndexResolver(str(r)),
                                       Config())
               for h, r in roots.items()}
    jengines = {h: jmofserver.DataEngine(jmofserver.DirIndexResolver(str(r)),
                                         JConfig())
                for h, r in roots.items()}
    try:
        router = merger.HostRoutingClient(
            lambda h: merger.LocalFetchClient(engines[h]))
        jrouter = jmerger.HostRoutingClient(
            lambda h: jmerger.LocalFetchClient(jengines[h]))
        entries = [("a", m) for m in map_ids(JOB, 2)] + \
            [(["b", "a"], m) for m in map_ids(JOB, 2)]
        got = router.estimate_partition_bytes(JOB, entries, 0)
        assert got == jrouter.estimate_partition_bytes(JOB, entries, 0) > 0
        assert router.estimate_partition_bytes(
            JOB, [("a", "missing")], 0) is None
    finally:
        for e in list(engines.values()) + list(jengines.values()):
            e.stop()
