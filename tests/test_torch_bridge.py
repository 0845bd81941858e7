"""The port's bridge (uda_tpu_torch.bridge: command protocol, role
dispatch, up-calls, fallback) against the JAX package's
``uda_tpu.bridge.UdaBridge``: the same commands on the same MOF tree drive
both packages, and each must give the same merged stream and the same
up-call sequence (every ``fetch_over_message``, every ``data_from_uda``
block's bytes, every ``failure_in_uda``'s class). These mirror the tests
of ``tests/test_bridge.py`` one for one, plus the INIT budget check, the
short-option argv and the conf pull channel decision by decision, the
``bridge.upcall`` failpoint and the stats reporter. The port runs on the
CPU (``device="cpu"``)."""

import functools
import io
import json
import threading
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

from helpers import make_mof_tree, map_ids
from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import bridge as jbridge
from uda_tpu.compress import get_codec as jget_codec
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.mofserver import ShuffleRequest as JShuffleRequest
from uda_tpu.mofserver.writer import MOFWriter as JMOFWriter
from uda_tpu.utils import budget as jbudget
from uda_tpu.utils import comparators as jcmp
from uda_tpu.utils import config as jconfig
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import IFileReader
from uda_tpu.utils.logging import get_logger as jget_logger
from uda_tpu_torch import bridge as tbridge
from uda_tpu_torch.compress import DecompressingClient
from uda_tpu_torch.mofserver import DirIndexResolver, ShuffleRequest
from uda_tpu_torch.utils import budget as tbudget
from uda_tpu_torch.utils import config as tconfig
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.stats import telemetry_block

RAW = "uda.tpu.RawBytes"

PORT = types.SimpleNamespace(
    name="port", bridge=tbridge, Resolver=DirIndexResolver,
    Req=ShuffleRequest, err=errors, logger=get_logger,
    new=lambda: tbridge.UdaBridge(device="cpu"))
REF = types.SimpleNamespace(
    name="ref", bridge=jbridge, Resolver=JDirIndexResolver,
    Req=JShuffleRequest, err=jerrors, logger=jget_logger,
    new=jbridge.UdaBridge)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    with failpoints.scoped(""), jfailpoints.scoped(""):
        yield
    metrics.reset()
    get_logger().set_sink(None)
    jget_logger().set_sink(None)


class Harness:
    """Embedder double: collects up-calls like UdaPluginRT would, in one
    ordered event list."""

    def __init__(self, side, root):
        self.blocks = []
        self.events = []
        self.fetch_over = threading.Event()
        self.failures = []
        self.conf = {}
        self.logs = []
        self._resolver = side.Resolver(root)
        self._lock = threading.Lock()

    def data_from_uda(self, data, length):
        with self._lock:
            self.blocks.append(bytes(data[:length]))
            self.events.append(("data", length))

    def fetch_over_message(self):
        with self._lock:
            self.events.append(("fetch_over",))
        self.fetch_over.set()

    def get_path_uda(self, job_id, map_id, reduce_id):
        return self._resolver.resolve(job_id, map_id, reduce_id)

    def get_conf_data(self, name, default):
        return self.conf.get(name, "")

    def log_to(self, level, message):
        self.logs.append((level, message))

    def failure_in_uda(self, error):
        with self._lock:
            self.failures.append(error)
            self.events.append(("failure", type(error).__name__))
        self.fetch_over.set()

    @property
    def stream(self) -> bytes:
        return b"".join(self.blocks)


def _reduce(side, root, job, reduce_id, num_maps, argv=("-w", "8", "-s",
                                                        "64"),
            init=None, fetches=None, conf=None):
    """One reduce task through ``side``'s bridge: start, INIT (short form
    unless ``init`` is given), one FETCH per map, FINAL, the wait for
    fetch_over and reduce_exit. Returns (harness, bridge)."""
    h = Harness(side, root)
    h.conf.update(conf or {})
    b = side.new()
    b.start(True, list(argv), h)
    b.do_command(side.bridge.form_cmd(side.bridge.Cmd.INIT, init or [
        job, str(reduce_id), str(num_maps), RAW]))
    for mid in fetches or map_ids(job, num_maps):
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.FETCH,
                                          ["localhost", job, mid,
                                           str(reduce_id)]))
    b.do_command(side.bridge.form_cmd(side.bridge.Cmd.FINAL, []))
    assert h.fetch_over.wait(timeout=30)
    try:
        b.reduce_exit()
    except Exception as e:  # noqa: BLE001 - developer mode re-raises here
        h.exit_error = e
    return h, b


def _same_task(ref, port):
    """The port's task gave the reference's stream and up-calls."""
    (hr, br), (hp, bp) = ref, port
    assert hp.stream == hr.stream
    assert hp.events == hr.events
    assert bp.failed == br.failed
    assert [str(e) for e in hp.failures] == [str(e) for e in hr.failures]


def _sorted_records(records):
    kt = jcmp.get_key_type(RAW)
    return sorted(records, key=functools.cmp_to_key(
        lambda a, b: kt.compare(a[0], b[0])))


# -- the protocol --------------------------------------------------------------

def test_protocol_round_trip():
    for side in SIDES:
        cmd = side.bridge.form_cmd(side.bridge.Cmd.FETCH,
                                   ["host1", "job_1", "attempt_x", "3"])
        assert cmd == "4:4:host1:job_1:attempt_x:3"
        header, params = side.bridge.parse_cmd(cmd)
        assert header == side.bridge.Cmd.FETCH
        assert params == ["host1", "job_1", "attempt_x", "3"]
        assert side.bridge.parse_cmd("0:2")[0] == side.bridge.Cmd.FINAL
    assert {c.name: int(c) for c in tbridge.Cmd} == \
        {c.name: int(c) for c in jbridge.Cmd}


@settings(max_examples=60, deadline=None)
@given(header=hs.sampled_from(list(jbridge.Cmd)),
       params=hs.lists(hs.text(hs.characters(codec="utf-8"), max_size=12),
                       max_size=12))
def test_protocol_strings_match_the_reference(header, params):
    """form_cmd gives the reference's string (or its error), and parse_cmd
    reads any string as the reference does."""
    theader = tbridge.Cmd(int(header))
    try:
        want = jbridge.form_cmd(header, params)
    except jerrors.ProtocolError as e:
        with pytest.raises(errors.ProtocolError) as got:
            tbridge.form_cmd(theader, params)
        assert str(got.value) == str(e)
        return
    got = tbridge.form_cmd(theader, params)
    assert got == want
    th, tp = tbridge.parse_cmd(got)
    assert (int(th), tp) == (int(header), params)
    # a mangled count: both refuse it alike
    bad = str(len(params) + 1) + got[got.index(":"):]
    with pytest.raises(errors.ProtocolError) as gerr:
        tbridge.parse_cmd(bad)
    with pytest.raises(jerrors.ProtocolError) as werr:
        jbridge.parse_cmd(bad)
    assert str(gerr.value) == str(werr.value)


@pytest.mark.parametrize("cmd", ["nonsense", "2:4:only_one", "0:99", "x:2",
                                 "", ":", "1:2"])
def test_protocol_errors(cmd):
    with pytest.raises(errors.ProtocolError) as got:
        tbridge.parse_cmd(cmd)
    with pytest.raises(jerrors.ProtocolError) as want:
        jbridge.parse_cmd(cmd)
    assert str(got.value) == str(want.value)
    with pytest.raises(errors.ProtocolError):
        tbridge.form_cmd(tbridge.Cmd.INIT, ["has:colon"])


# -- the reduce role -------------------------------------------------------------

def test_reduce_role_end_to_end_via_upcall_resolution(tmp_path):
    expected = make_mof_tree(str(tmp_path), "jobB1", 4, 2, 40, seed=13)
    for r in (0, 1):
        ref, port = (_reduce(side, str(tmp_path), "jobB1", r, 4)
                     for side in SIDES)
        _same_task(ref, port)
        assert not port[0].failures
        got = list(IFileReader(io.BytesIO(port[0].stream)))
        assert [k for k, _ in got] == [
            k for k, _ in _sorted_records(expected[r])]
        # the reference cadence: 4 maps < PROGRESS_INTERVAL -> one
        # fetch_over_message, when the fetch ends
        assert port[0].events.count(("fetch_over",)) == 1


def test_reduce_role_with_local_dirs_param(tmp_path):
    expected = make_mof_tree(str(tmp_path), "jobB2", 4, 2, 40, seed=13)
    for r in (0, 1):
        ref, port = (_reduce(side, str(tmp_path), "jobB2", r, 4, init=[
            "jobB2", str(r), "4", RAW, str(tmp_path)]) for side in SIDES)
        _same_task(ref, port)
        assert len(list(IFileReader(io.BytesIO(port[0].stream)))) == \
            len(expected[r])


def test_progress_cadence_over_twenty_maps(tmp_path):
    """fetch_over_message once per 20 fetched segments and once at the
    end (MergeManager.cc:124-130), as the reference calls it."""
    make_mof_tree(str(tmp_path), "jobP", 41, 1, 3, seed=3)
    ref, port = (_reduce(side, str(tmp_path), "jobP", 0, 41)
                 for side in SIDES)
    _same_task(ref, port)
    assert port[0].events.count(("fetch_over",)) == 41 // 20 + 1


def test_supplier_role_serves_and_exits(tmp_path):
    make_mof_tree(str(tmp_path), "jobB3", 2, 1, 10, seed=14)
    got = []
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        b = side.new()
        b.start(False, ["-w", "8"], h)
        res = b.data_engine().fetch(side.Req(
            "jobB3", map_ids("jobB3", 2)[0], 0, 0, 1 << 20))
        assert res.is_last and len(res.data) > 0
        got.append(bytes(res.data))
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.JOB_OVER,
                                          ["jobB3"]))
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.EXIT, []))
        assert not h.failures and not b.failed
    assert got[0] == got[1]


def test_supplier_role_resolves_through_get_path_uda(tmp_path):
    """The supplier's engine resolves every (job, map, reduce) once
    through the up-call, caches it, and forgets the job at JOB_OVER."""
    make_mof_tree(str(tmp_path), "jobSP", 2, 2, 10, seed=15)
    calls = []
    h = Harness(PORT, str(tmp_path))
    resolve = h.get_path_uda
    h.get_path_uda = lambda *a: (calls.append(a), resolve(*a))[1]
    b = PORT.new()
    b.start(False, [], h)
    engine = b.data_engine()
    for r in (0, 1, 0):
        engine.fetch(ShuffleRequest("jobSP", map_ids("jobSP", 2)[1], r, 0,
                                    1 << 20))
    assert calls == [("jobSP", map_ids("jobSP", 2)[1], 0),
                     ("jobSP", map_ids("jobSP", 2)[1], 1)]
    b.do_command(tbridge.form_cmd(tbridge.Cmd.JOB_OVER, ["jobSP"]))
    engine.fetch(ShuffleRequest("jobSP", map_ids("jobSP", 2)[1], 0, 0, 64))
    assert len(calls) == 3
    b.do_command(tbridge.form_cmd(tbridge.Cmd.EXIT, []))
    with pytest.raises(errors.UdaError):
        b.data_engine()


def test_failure_triggers_fallback_upcall(tmp_path):
    out = []
    for side in SIDES:
        h, b = _reduce(side, str(tmp_path), "jobNope", 0, 1,
                       fetches=["attempt_missing"], argv=())
        assert h.failures and b.failed
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.FINAL, []))
        out.append((h, b))
    _same_task(*out)


def test_developer_mode_reraises(tmp_path):
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        h.conf["mapred.rdma.developer.mode"] = "true"
        b = side.new()
        b.start(True, [], h)
        with pytest.raises(side.err.ProtocolError):
            b.do_command("garbage-not-a-command")
        assert not h.failures


def test_unexpected_role_command_fails_softly(tmp_path):
    got = []
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        b = side.new()
        b.start(True, [], h)
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.NEW_MAP, []))
        assert b.failed and h.failures
        got.append([str(e) for e in h.failures])
    assert got[0] == got[1]


def test_get_stats_round_trip(tmp_path):
    """GET_STATS answers in both roles with the reference's keys; after a
    reduce task the fetch and emit counters are the task's bytes."""
    make_mof_tree(str(tmp_path), "jobGS", 3, 1, 20, seed=16)
    keys = []
    for side in SIDES:
        h, b = _reduce(side, str(tmp_path), "jobGS", 0, 3, argv=("-w", "4"))
        assert not h.failures
        stats = json.loads(b.do_command(side.bridge.form_cmd(
            side.bridge.Cmd.GET_STATS, [])))
        assert stats["counters"]["fetch.bytes"] > 0
        assert stats["counters"]["emit.bytes"] == len(h.stream)
        for alias in ("total_wait_mem_time", "total_fetch_time",
                      "total_merge_time"):
            assert alias in stats["counters"]
        keys.append(sorted(stats))
        assert b.do_command(side.bridge.form_cmd(side.bridge.Cmd.EXIT,
                                                 [])) is None
        sup = side.new()
        sup.start(False, [], Harness(side, str(tmp_path)))
        stats = json.loads(sup.do_command(side.bridge.form_cmd(
            side.bridge.Cmd.GET_STATS, [])))
        assert "counters" in stats and "gauges" in stats
        sup.do_command(side.bridge.form_cmd(side.bridge.Cmd.EXIT, []))
    assert keys[0] == keys[1] == ["counters", "gauges", "histograms"]


def test_telemetry_block_summaries():
    metrics.enable_stats()
    for v in (0.5, 3.0, 3.0, 900.0):
        metrics.observe("fetch.latency_ms", v)
    metrics.add("fetch_time", 2.5)
    block = telemetry_block()
    assert block["counters"]["total_fetch_time"] == 2.5
    assert block["counters"]["total_merge_time"] == 0.0
    h = block["histograms"]["fetch.latency_ms"]
    assert h["count"] == 4 and h["min"] == 0.5 and h["max"] == 900.0
    assert sum(c for _, c in h["buckets"]) == 4


def test_stats_reporter_runs(tmp_path, monkeypatch):
    """A bridge started with ``uda.tpu.stats.enable=true`` (a NetMerger)
    and one under ``UDA_TPU_STATS=1`` (a MOFSupplier) run the
    StatsReporter in both packages: JSON lines land in the configured
    file, GET_STATS answers with the reporter's latest record (the same
    keys in both packages), and the reduce task's final record carries
    the reference's trio."""
    from uda_tpu.utils.timeseries import (
        disarm_observability_plane as jdisarm)
    from uda_tpu_torch.utils.timeseries import disarm_observability_plane

    make_mof_tree(str(tmp_path), "jobSR", 3, 1, 20, seed=17)
    keys, final_keys = [], []
    try:
        for side in SIDES:
            out = tmp_path / f"{side.name}.jsonl"
            h, b = _reduce(side, str(tmp_path), "jobSR", 0, 3,
                           argv=("-w", "4"),
                           conf={"uda.tpu.stats.enable": "true",
                                 "uda.tpu.stats.interval.ms": "50",
                                 "uda.tpu.stats.jsonl": str(out)})
            assert not h.failures
            stats = json.loads(b.do_command(side.bridge.form_cmd(
                side.bridge.Cmd.GET_STATS, [])))
            # reduce_exit emitted the final record: it is the latest
            assert stats["final"] is True
            assert stats["counters"]["emit.bytes"] == len(h.stream)
            for alias in ("total_wait_mem_time", "total_fetch_time",
                          "total_merge_time"):
                assert alias in stats["counters"]
            assert "fetch.latency_ms" in stats["percentiles"]
            final_keys.append(sorted(stats))
            b.do_command(side.bridge.form_cmd(side.bridge.Cmd.EXIT, []))
            lines = [json.loads(x) for x in out.read_text().splitlines()]
            assert lines and lines[-1]["final"] is True
            with monkeypatch.context() as mp:
                mp.setenv("UDA_TPU_STATS", "1")
                sup = side.new()
                sup.start(False, [], Harness(side, str(tmp_path)))
                stats = json.loads(sup.do_command(side.bridge.form_cmd(
                    side.bridge.Cmd.GET_STATS, [])))
                assert "rates" in stats and "final" not in stats
                keys.append(sorted(stats))
                sup.do_command(side.bridge.form_cmd(side.bridge.Cmd.EXIT,
                                                    []))
    finally:
        disarm_observability_plane()
        jdisarm()
    assert keys[0] == keys[1]
    assert final_keys[0] == final_keys[1]


def test_log_upcall_sink(tmp_path):
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        b = side.new()
        b.start(True, ["-t", "6"], h)
        side.logger().info("hello bridge")
        assert any("hello bridge" in m for _, m in h.logs)
        b.set_log_level(0)
        side.logger().error("silenced")
        assert not any("silenced" in m for _, m in h.logs)


def test_bridge_malformed_param_falls_back():
    got = []
    for side in SIDES:
        failures = []

        class H:
            def failure_in_uda(self, e):
                failures.append(e)

            def get_conf_data(self, n, d):
                return ""

        b = side.new()
        b.start(True, [], H())
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.INIT, [
            "job", "not_an_int", "4", RAW]))
        assert failures and b.failed
        got.append((type(failures[0]).__name__, str(failures[0])))
    assert got[0] == got[1]


def test_developer_mode_merge_thread_failure_surfaces(tmp_path):
    out = []
    for side in SIDES:
        h, b = _reduce(side, str(tmp_path), "jobDevM", 0, 1,
                       fetches=["attempt_missing"], argv=(),
                       conf={"mapred.rdma.developer.mode": "true"})
        assert h.failures
        assert isinstance(h.exit_error, Exception)  # re-raised at exit
        b.reduce_exit()  # consumed: the bridge is clean again
        out.append((h, b))
    _same_task(*out)


def test_reinit_stops_previous_engine(tmp_path):
    make_mof_tree(str(tmp_path), "jobRe", 1, 1, 5)
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        b = side.new()
        b.start(True, [], h)
        init = side.bridge.form_cmd(side.bridge.Cmd.INIT, [
            "jobRe", "0", "1", RAW])
        b.do_command(init)
        first = b._owned_engine
        assert first is not None
        b.do_command(init)
        assert not h.failures
        assert b._owned_engine is not None and b._owned_engine is not first
        with pytest.raises(side.err.StorageError):
            first.fetch(side.Req("jobRe", "x", 0, 0, 10))
        b.reduce_exit()


def _ref_init_params(job, reduce_id, num_maps, key_class=RAW, lpq=0,
                     buf=64 * 1024, min_buf=4096, codec="0", comp_block=0,
                     shuffle_mem=1 << 30, dirs=()):
    """The reference's 10-param INIT layout + num_dirs + dirs
    (reducer.cc:56-133)."""
    return ([str(num_maps), job, str(reduce_id), str(lpq), str(buf),
             str(min_buf), key_class, codec, str(comp_block),
             str(shuffle_mem), str(len(dirs))] + list(dirs))


def test_init_reference_layout_end_to_end(tmp_path):
    expected = make_mof_tree(str(tmp_path), "jobI10", 3, 1, 25, seed=31)
    ref, port = (_reduce(side, str(tmp_path), "jobI10", 0, 3,
                         argv=("-w", "8"), init=_ref_init_params(
                             "jobI10", 0, 3, dirs=[str(tmp_path)]))
                 for side in SIDES)
    _same_task(ref, port)
    assert list(IFileReader(io.BytesIO(port[0].stream))) == \
        _sorted_records(expected[0])


@pytest.mark.parametrize("params,want_buf_kb,fails", [
    # 8 maps -> 13 pairs; 1 MiB buffers over 13 * 2 * 12288 B shrink
    (dict(num_maps=8, buf=1 << 20, min_buf=4096,
          shuffle_mem=13 * 2 * 12288), 12, None),
    # the shrunken buffer under the minimum: "Not enough memory"
    (dict(num_maps=8, buf=1 << 20, min_buf=64 * 1024, shuffle_mem=1 << 20),
     None, "Not enough memory"),
    # 2048 B aligns to 0: "RDMA Buffer is too small"
    (dict(num_maps=1, buf=2048, min_buf=1024), None, "too small"),
    # a fit needs no shrink: page-aligned as given
    (dict(num_maps=2, buf=40960 + 100, min_buf=4096), 40, None),
])
def test_init_reference_layout_buffer_sizing(params, want_buf_kb, fails):
    """The reference INIT's buffer decisions (shrink, not enough memory,
    too small after alignment) alike in both packages."""
    got = []
    for side in SIDES:
        failures = []

        class FB:
            def failure_in_uda(self, e):
                failures.append(e)

        b = side.new()
        b.start(True, [], FB())
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.INIT,
                                          _ref_init_params("jobBuf", 0,
                                                           **params)))
        if fails:
            assert b.failed and fails in str(failures[0])
        else:
            assert not b.failed
            assert b.cfg.get("mapred.rdma.buf.size") == want_buf_kb
            b.reduce_exit()
        got.append([str(e) for e in failures])
    assert got[0] == got[1]


def test_fetch_attempt_dedupe_and_obsolescence(tmp_path):
    job = "jobDup"
    make_mof_tree(str(tmp_path), job, 2, 1, 10, seed=33)
    a0, a1 = map_ids(job, 2)
    a1_retry = a1[:-1] + "1"
    out = []
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        b = side.new()
        b.start(True, [], h)
        cmd = functools.partial(side.bridge.form_cmd, side.bridge.Cmd.FETCH)
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.INIT, [
            job, "0", "2", RAW, str(tmp_path)]))
        b.do_command(cmd(["h", job, a0, "0"]))
        b.do_command(cmd(["h", job, a0, "0"]))  # duplicate: dropped
        assert b._pending_maps == [("h", a0)]
        # speculative re-execution: attempt _1 obsoletes attempt _0
        b.do_command(cmd(["h", job, a1, "0"]))
        b.do_command(cmd(["h", job, a1_retry, "0"]))
        assert b._pending_maps == [("h", a0), ("h", a1_retry)]
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.FINAL, []))
        assert h.fetch_over.wait(timeout=30)
        b.reduce_exit()
        # the retried attempt has no map output: that failure is expected
        first = [str(e) for e in h.failures]
        h.failures.clear()
        b._failed = False
        b.do_command(cmd(["h", job, a0[:-1] + "9", "0"]))
        assert h.failures and "after the merge" in str(h.failures[0])
        out.append((first, [str(e) for e in h.failures]))
        b.reduce_exit()
    assert out[0] == out[1]


def test_init_reference_layout_compressed_job(tmp_path):
    """Codec class and block size in INIT params 7/8 switch the client to
    the decompressing path, its compressed sub-buffer sized by
    mapred.rdma.compression.buffer.ratio (calculateMemPool,
    reducer.cc:453-496)."""
    job = "jobIC"
    writer = JMOFWriter(str(tmp_path), job, codec=jget_codec("zlib"))
    rng = np.random.default_rng(41)
    expected = []
    for m in range(2):
        recs = sorted((rng.bytes(10), rng.bytes(40)) for _ in range(60))
        expected += recs
        writer.write(f"attempt_{job}_m_{m:06d}_0", [recs])
    init = _ref_init_params(job, 0, 2, codec="zlib", comp_block=4096,
                            dirs=[str(tmp_path)])
    b = PORT.new()
    b.start(True, [], Harness(PORT, str(tmp_path)))
    b.do_command(tbridge.form_cmd(tbridge.Cmd.INIT, init))
    client = b._mm.client
    assert isinstance(client, DecompressingClient)
    buf_bytes = b.cfg.get("mapred.rdma.buf.size") * 1024
    ratio = float(b.cfg.get("mapred.rdma.compression.buffer.ratio"))
    assert client.comp_chunk_size == int(buf_bytes * ratio)
    b.reduce_exit()
    ref, port = (_reduce(side, str(tmp_path), job, 0, 2, argv=(),
                         init=init, fetches=writer.map_ids)
                 for side in SIDES)
    _same_task(ref, port)
    assert list(IFileReader(io.BytesIO(port[0].stream))) == \
        _sorted_records(expected)


def test_short_form_init_with_many_dirs_not_misrouted(tmp_path):
    job = "jobDirs"
    make_mof_tree(str(tmp_path), job, 1, 1, 5, seed=51)
    dirs = [str(tmp_path)] + [str(tmp_path / f"d{i}") for i in range(6)]
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        b = side.new()
        b.start(True, [], h)
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.INIT, [
            job, "0", "1", RAW] + dirs))
        assert not b.failed and not h.failures
        b.reduce_exit()


def test_reinit_does_not_leak_compression_config(tmp_path):
    """A codec INIT for job A then a plain INIT for job B on the same
    bridge: B's config is fresh, its fetches are not decompressed."""
    job_a, job_b = "jobLeakA", "jobLeakB"
    JMOFWriter(str(tmp_path), job_a, codec=jget_codec("zlib")).write(
        f"attempt_{job_a}_m_000000_0", [[(b"k" * 10, b"v" * 10)]])
    expected = make_mof_tree(str(tmp_path), job_b, 2, 1, 20, seed=61)
    out = []
    for side in SIDES:
        h = Harness(side, str(tmp_path))
        b = side.new()
        b.start(True, [], h)
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.INIT,
                                          _ref_init_params(
                                              job_a, 0, 1, codec="zlib",
                                              dirs=[str(tmp_path)])))
        assert b.cfg.get("mapred.compress.map.output")
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.INIT,
                                          _ref_init_params(
                                              job_b, 0, 2, codec="0",
                                              dirs=[str(tmp_path)])))
        assert not b.cfg.get("mapred.compress.map.output")
        for mid in map_ids(job_b, 2):
            b.do_command(side.bridge.form_cmd(side.bridge.Cmd.FETCH, [
                "h", job_b, mid, "0"]))
        b.do_command(side.bridge.form_cmd(side.bridge.Cmd.FINAL, []))
        assert h.fetch_over.wait(timeout=30)
        b.reduce_exit()
        assert not h.failures, h.failures
        out.append((h, b))
    _same_task(*out)
    assert list(IFileReader(io.BytesIO(out[1][0].stream))) == \
        _sorted_records(expected[0])


# -- the bridge.upcall failpoint ---------------------------------------------------

@pytest.mark.parametrize("spec", ["error:once", "error:every:2",
                                  "error:match:data_from_uda"])
def test_bridge_upcall_failpoint_falls_back_alike(tmp_path, spec):
    """``bridge.upcall`` armed in each package's registry fails a
    data_from_uda block on the merge thread: the same blocks reach the
    embedder before the failure_in_uda, in both packages."""
    make_mof_tree(str(tmp_path), "jobFP", 3, 1, 40, seed=71)
    out = []
    for side, reg in ((REF, jfailpoints), (PORT, failpoints)):
        with reg.scoped(f"bridge.upcall={spec}"):
            out.append(_reduce(side, str(tmp_path), "jobFP", 0, 3,
                               argv=("-s", "1")))
    _same_task(*out)
    h, b = out[1]
    assert b.failed and h.events[-1] == ("failure", "UdaError")


# -- INIT admission, argv and the conf pull channel ----------------------------

INIT_BUDGETS = [
    # (host budget MB, buf KB, window, arena slots, enforce)
    (64, 64, 8, 4, "reroute"),          # fits
    (1, 128, 8, 2, "reroute"),          # shrinks the window
    (1, 128, 8, 2, "reject"),           # over budget, rejected
    (1, 512, 4, 4, "reroute"),          # no window fits: hard failure
    (2, 256, 16, 1, "reroute"),
    (3, 100, 64, 8, "reject"),
]


@pytest.mark.parametrize("host_mb,buf_kb,window,slots,enforce", INIT_BUDGETS)
def test_validate_init_matches_reference(host_mb, buf_kb, window, slots,
                                         enforce):
    """MemoryBudget.validate_init decides as the reference's, decision by
    decision: the admission record, the shrunken window and the error."""
    conf = {"uda.tpu.host.budget.mb": host_mb,
            "mapred.rdma.buf.size": buf_kb,
            "mapred.rdma.wqe.per.conn": window,
            "uda.tpu.arena.slots": slots, "uda.tpu.budget.enforce": enforce}
    outcomes = []
    for mod, cfg_mod, kw, err in (
            (tbudget, tconfig, {"device": "cpu"}, errors.UdaError),
            (jbudget, jconfig, {}, jerrors.UdaError)):
        cfg = cfg_mod.Config(conf)
        budget = mod.MemoryBudget.from_config(cfg, **kw)
        try:
            adm = budget.validate_init(cfg)
            outcomes.append(("ok", adm.decision, adm.reason,
                             adm.estimate_bytes, adm.host_budget_bytes,
                             adm.cause, adm.rerouted,
                             cfg.get("mapred.rdma.wqe.per.conn")))
        except err as e:
            outcomes.append(("raised", str(e),
                             cfg.get("mapred.rdma.wqe.per.conn")))
    assert outcomes[0] == outcomes[1]


def test_init_budget_shrinks_the_bridge_window(tmp_path):
    """Over the host budget (enforce=reroute) the bridge's INIT shrinks
    the window its MergeManager reads; enforce=reject falls back."""
    make_mof_tree(str(tmp_path), "jobW", 2, 1, 10, seed=5)
    conf = {"uda.tpu.host.budget.mb": "1", "mapred.rdma.buf.size": "128",
            "uda.tpu.arena.slots": "2"}
    windows = []
    for side in SIDES:
        h, b = _reduce(side, str(tmp_path), "jobW", 0, 2, argv=("-w", "8"),
                       conf=conf)
        assert not h.failures
        windows.append(b.cfg.get("mapred.rdma.wqe.per.conn"))
    assert windows[0] == windows[1] == (1024 * 1024 - 4 * 128 * 1024) \
        // (128 * 1024)
    h = Harness(PORT, str(tmp_path))
    h.conf.update(conf, **{"uda.tpu.budget.enforce": "reject"})
    b = PORT.new()
    b.start(True, ["-w", "8"], h)
    b.do_command(tbridge.form_cmd(tbridge.Cmd.INIT, ["jobW", "0", "2", RAW]))
    assert b.failed and "over budget" in str(h.failures[0])


@pytest.mark.parametrize("argv", [
    [], ["-w", "256", "-r", "9011", "-a", "1", "-m", "0", "-t", "4",
         "-s", "1024"],
    ["-g", "/tmp/x"], ["-w"], ["w", "1"], ["-q", "1"], ["-w", "notanint"],
    ["-ww", "1"]])
def test_from_argv_matches_reference(argv):
    outcomes = []
    for mod, err in ((tconfig, errors.ConfigError),
                     (jconfig, jerrors.ConfigError)):
        try:
            cfg = mod.Config.from_argv(list(argv))
            outcomes.append(sorted((k, v) for k, v in cfg._values.items()))
        except err as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_conf_source_precedence_matches_reference():
    """explicit > pulled > default; a pull is coerced and cached; an empty
    pull falls through to the default."""
    pulled = {"mapred.rdma.buf.size": "32", "uda.log.level": "",
              "custom.key": "v"}
    for mod in (tconfig, jconfig):
        asked = []

        def source(name, default, asked=asked):
            asked.append((name, default))
            return pulled.get(name, "")

        cfg = mod.Config({"mapred.rdma.wqe.per.conn": 3},
                         conf_source=source)
        assert cfg.get("mapred.rdma.wqe.per.conn") == 3
        assert cfg.get("mapred.rdma.buf.size") == 32
        assert cfg.get("mapred.rdma.buf.size") == 32
        assert cfg.get("custom.key") == "v"
        assert cfg.get("uda.log.level") == mod.FLAGS["uda.log.level"].default
        assert cfg.is_set("mapred.rdma.buf.size")
        assert not cfg.is_set("uda.log.level")
        assert asked.count(("mapred.rdma.buf.size", str(
            mod.FLAGS["mapred.rdma.buf.size"].default))) == 1
    assert tconfig._SHORT.keys() == jconfig._SHORT.keys()
    for opt, flag in tconfig._SHORT.items():
        assert flag.key == jconfig._SHORT[opt].key
