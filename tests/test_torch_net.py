"""The port's network shuffle (uda_tpu_torch.net: wire, evloop, server,
client, and HostRoutingClient's socket default) against the JAX package's
``uda_tpu.net``: every frame type encoded byte for byte alike from the same
seeded fields and decoded alike; a reference server serving a port client
and a port server serving a reference client with byte-identical fetches,
typed ERR frames arriving as their classes, SIZE probes agreeing, equal
HELLO banners, and each package reading the other's handoff record;
``MergeManager.run`` over the wire in every mode equal to the reference's
run on the same files; the zero-copy and byte serve paths, credit parking,
drain-on-stop, warm and cold restarts with resume, the net failpoints,
and the planes the port refuses. Races are driven by threading.Events,
never by sleeps. Only loopback sockets are used."""

import io
import json
import random
import socket
import threading
import types

import numpy as np
import pytest

from helpers import make_mof_tree, map_ids
from test_torch_merge_manager import TEXT, text_tree
from uda_tpu import merger as jmerger
from uda_tpu import mofserver as jmofserver
from uda_tpu import net as jnet
from uda_tpu.net import wire as jwire
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import IFileReader
from uda_tpu.utils.ifile import crack as jcrack
from uda_tpu_torch import merger, mofserver
from uda_tpu_torch import net as tnet
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                  MergeManager, Segment)
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                     FetchResult, ShuffleRequest)
from uda_tpu_torch.net import RemoteFetchClient, ShuffleServer, wire
from uda_tpu_torch.net import server as server_mod
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import StorageError, TransportError
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.retry import RetryPolicy

JOB = "jobNet"
RAW = "uda.tpu.RawBytes"

PORT = types.SimpleNamespace(
    name="port", wire=wire, net=tnet, Server=ShuffleServer,
    Client=RemoteFetchClient, Engine=DataEngine, Resolver=DirIndexResolver,
    Config=Config, Req=ShuffleRequest, Result=FetchResult, err=errors,
    m=merger, failpoints=failpoints)
REF = types.SimpleNamespace(
    name="ref", wire=jwire, net=jnet, Server=jnet.ShuffleServer,
    Client=jnet.RemoteFetchClient, Engine=jmofserver.DataEngine,
    Resolver=jmofserver.DirIndexResolver, Config=JConfig,
    Req=jmofserver.ShuffleRequest, Result=jmofserver.FetchResult,
    err=jerrors, m=jmerger, failpoints=jfailpoints)
SIDES = {"port": PORT, "ref": REF}
# (server side, client side): each package serves the other's client
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    with failpoints.scoped(""), jfailpoints.scoped(""):
        yield
    metrics.reset()


def _fetch_sync(client, req, timeout=10.0):
    """One fetch through the async InputClient API, synchronously."""
    box, done = [], threading.Event()
    client.start_fetch(req, lambda res: (box.append(res), done.set()))
    assert done.wait(timeout), "fetch never completed"
    return box[0]


def _serve(side, root, conf=None, **kw):
    engine = side.Engine(side.Resolver(root), side.Config(conf or {}))
    server = side.Server(engine, side.Config(conf or {}),
                         host="127.0.0.1", port=kw.pop("port", 0),
                         **kw).start()
    return engine, server


def _read_frame(sock):
    """One frame off a plain blocking socket -> (type, req id, payload)."""
    sock.settimeout(10)
    return jwire.recv_frame(sock)


# -- frames: byte identity ---------------------------------------------------

ERROR_CLASSES = ["UdaError", "ConfigError", "ProtocolError",
                 "TransportError", "MergeError", "StorageError",
                 "StoreError", "CompressionError", "TenantError"]


def _frame(side, kind: str, seed: int) -> bytes:
    """One frame of ``kind`` encoded by ``side``'s wire module from fields
    drawn from ``seed``."""
    rng = random.Random(f"{kind}/{seed}")
    w = side.wire

    def text(n=12):
        return "".join(rng.choice("abcxyz_019é") for _ in range(
            rng.randint(0, n)))

    rid = rng.getrandbits(64)
    req = side.Req(text(), text(30), rng.getrandbits(32),
                   rng.getrandbits(63), rng.getrandbits(32))
    data = rng.randbytes(rng.randint(0, 3000))
    trace = (rng.getrandbits(64), rng.getrandbits(64))
    if kind == "req":
        return w.encode_request(rid, req)
    if kind == "req_trace":
        return w.encode_request(rid, req, trace=trace)
    if kind.startswith("data"):
        crc = rng.getrandbits(32) if kind == "data_crc" else None
        if kind == "data_empty":
            data = b""
        return w.encode_result(rid, side.Result(
            data, rng.getrandbits(63), rng.getrandbits(63),
            rng.getrandbits(63), "/" + text(40), last=rng.random() < 0.5,
            crc=crc))
    if kind == "result_head":
        return w.encode_result_head(
            rid, raw_length=rng.getrandbits(40),
            part_length=rng.getrandbits(40), offset=rng.getrandbits(40),
            last=True, path=text(), crc=rng.getrandbits(32),
            data_len=rng.getrandbits(20))
    if kind.startswith("err_"):
        cls = kind[4:]
        if cls == "foreign":
            exc = ValueError(text(50))
        elif cls == "long":
            exc = side.err.StorageError("é" * 40000)
        else:
            exc = getattr(side.err, cls)(text(50))
        return w.encode_error(rid, exc)
    if kind == "size_req":
        return w.encode_size_request(rid, text(), [text(20) for _ in range(
            rng.randint(0, 6))], rng.getrandbits(32))
    if kind == "size_req_trace":
        return w.encode_size_request(rid, text(), [text(20)], 3,
                                     trace=trace)
    if kind == "size":
        return w.encode_size(rid, rng.getrandbits(62))
    if kind == "size_unknown":
        return w.encode_size(rid, None)
    if kind == "hello":
        return w.encode_hello(rng.getrandbits(32), rng.random() < 0.5)
    if kind == "hello_caps":
        return w.encode_hello(rng.getrandbits(32), True,
                              caps=rng.getrandbits(8))
    if kind == "stats":
        return w.encode_stats_request(rid)
    if kind == "stats_tail":
        return w.encode_stats_request(rid, window_s=rng.randint(0, 999),
                                      sections=rng.getrandbits(3))
    if kind == "stats_reply":
        return w.encode_stats_reply(rid, {"a": [1, 2.5, text()],
                                          "b": {"c": None, "d": True}})
    if kind in ("job", "job_retire"):
        return w.encode_job(rid, text(), text(), rng.getrandbits(32),
                            weight=rng.randint(0, 70000), token=text(64),
                            retire=kind == "job_retire")
    if kind == "job_ok":
        return w.encode_job_ok(rid, rng.getrandbits(32))
    if kind == "push":
        return w.encode_push(rid, job_id=text(), map_id=text(),
                             reduce_id=rng.getrandbits(32),
                             offset=rng.getrandbits(60),
                             raw_length=rng.getrandbits(60),
                             last=rng.random() < 0.5, data=data)
    if kind == "push_sub":
        return w.encode_push_sub(rid, job_id=text(),
                                 reduce_id=rng.getrandbits(32),
                                 window=rng.getrandbits(32),
                                 chunk_size=rng.getrandbits(32))
    if kind == "push_ack":
        return w.encode_push_ack(rid)
    if kind == "push_nack":
        return w.encode_push_nack(rid, rng.getrandbits(8))
    raise ValueError(kind)


FRAME_KINDS = (["req", "req_trace", "data", "data_crc", "data_empty",
                "result_head", "size_req", "size_req_trace", "size",
                "size_unknown", "hello", "hello_caps", "stats",
                "stats_tail", "stats_reply", "job", "job_retire", "job_ok",
                "push", "push_sub", "push_ack", "push_nack",
                "err_foreign", "err_long"]
               + [f"err_{c}" for c in ERROR_CLASSES])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_every_frame_is_byte_identical(kind, seed):
    assert _frame(PORT, kind, seed) == _frame(REF, kind, seed)


def test_every_message_type_is_covered():
    assert wire.WIRE_CODECS == jwire.WIRE_CODECS
    assert (wire.HEADER.format, wire.MAGIC, wire.WIRE_VERSION,
            wire.MAX_FRAME) == (jwire.HEADER.format, jwire.MAGIC,
                                jwire.WIRE_VERSION, jwire.MAX_FRAME)
    for name in jwire.__all__:
        if name.startswith(("MSG_", "CAP_", "STATS_SEC_")):
            assert getattr(wire, name) == getattr(jwire, name), name
    covered = {wire.decode_header(_frame(PORT, k, 0)[:wire.HEADER.size])[0]
               for k in FRAME_KINDS}
    assert covered == set(wire.WIRE_CODECS)


def _decoded(side, frame: bytes):
    """A frame decoded by ``side``'s wire module, as plain values."""
    w = side.wire
    msg_type, req_id, length = w.decode_header(frame[:w.HEADER.size])
    payload = frame[w.HEADER.size:]
    assert len(payload) == length
    if msg_type == w.MSG_REQ:
        req, trace = w.decode_request_ex(payload)
        body = (req.job_id, req.map_id, req.reduce_id, req.offset,
                req.chunk_size, trace)
    elif msg_type == w.MSG_DATA:
        if length == 0 or len(payload) < length:
            return None
        res = w.decode_result_take(bytearray(payload))
        body = (bytes(res.data), res.raw_length, res.part_length,
                res.offset, res.path, res.last, res.crc)
    elif msg_type == w.MSG_ERR:
        err = w.decode_error(payload)
        body = (type(err).__name__, str(err), err.remote_kind)
    elif msg_type == w.MSG_SIZE_REQ:
        body = w.decode_size_request_ex(payload)
    elif msg_type == w.MSG_SIZE:
        body = w.decode_size(payload)
    elif msg_type == w.MSG_HELLO:
        body = (w.decode_hello(payload), w.decode_hello_ex(payload))
    elif msg_type == w.MSG_STATS:
        body = w.decode_stats_request(payload)
    elif msg_type == w.MSG_STATS_REPLY:
        body = w.decode_stats_reply(payload)
    elif msg_type == w.MSG_JOB:
        body = w.decode_job(payload)
    elif msg_type == w.MSG_JOB_OK:
        body = w.decode_job_ok(payload)
    elif msg_type == w.MSG_PUSH:
        got = w.decode_push_take(bytearray(payload))
        body = got[:-1] + (bytes(got[-1]),)
    elif msg_type == w.MSG_PUSH_SUB:
        body = w.decode_push_sub(payload)
    elif msg_type == w.MSG_PUSH_NACK:
        body = w.decode_push_nack(payload)
    else:
        body = bytes(payload)
    return msg_type, req_id, body


@pytest.mark.parametrize("kind", [k for k in FRAME_KINDS
                                  if k != "result_head"])
def test_each_package_decodes_the_others_frames(kind):
    for frame in (_frame(PORT, kind, 3), _frame(REF, kind, 3)):
        assert _decoded(PORT, frame) == _decoded(REF, frame)


def _strict_cases(side):
    w = side.wire
    good = w.encode_request(1, side.Req("j", "m", 0, 0, 64))
    hdr = good[:w.HEADER.size]
    return [
        (w.decode_header, b"XX" + hdr[2:]),
        (w.decode_header, hdr[:2] + bytes([w.WIRE_VERSION + 1]) + hdr[3:]),
        (w.decode_header, hdr[:3] + bytes([99]) + hdr[4:]),
        (w.decode_header, hdr[:12] + (1 << 31).to_bytes(4, "big")),
        (w.decode_header, hdr[:7]),
        (w.decode_request, good[w.HEADER.size:-3]),
        (w.decode_request, good[w.HEADER.size:] + b"zz"),
        (w.decode_request, good[w.HEADER.size:] + b"z" * 15),
        (w.decode_result, b"\x00" * 4),
        (w.decode_result, bytes(25) + b"\x00"),
        (w.decode_hello, b"\x00" * 4),
        (w.decode_size, b"\x00" * 9),
        (w.decode_job_ok, b"\x00"),
        (w.decode_stats_request, b"\x00" * 3),
        (w.decode_stats_reply, b"{not json"),
        (w.decode_push_nack, b""),
        (w.decode_push_sub, b"\x00" * 11),
        (w.decode_error, b"\x00\x05ab"),
        (w.decode_job, b"\x00" * 7 + b"\x00\x02a"),
    ]


@pytest.mark.parametrize("case", range(19))
def test_decode_strictness_matches_reference(case):
    fn, data = _strict_cases(PORT)[case]
    jfn, jdata = _strict_cases(REF)[case]
    assert data == jdata
    with pytest.raises(TransportError) as got:
        fn(data)
    with pytest.raises(jerrors.TransportError) as want:
        jfn(jdata)
    assert str(got.value) == str(want.value)


def test_error_frames_keep_their_class_across_packages():
    for name in ERROR_CLASSES:
        frame = jwire.encode_error(5, getattr(jerrors, name)("boom"))
        err = wire.decode_error(frame[wire.HEADER.size:])
        assert type(err) is getattr(errors, name)
        assert err.remote_kind == name and str(err) == "remote: boom"
    err = wire.decode_error(
        wire.encode_error(4, ValueError("alien"))[wire.HEADER.size:])
    assert isinstance(err, TransportError) and err.remote_kind == \
        "ValueError"


def test_recv_frame_eof_and_mid_frame_cut():
    frame = wire.encode_request(1, ShuffleRequest("j", "m", 0, 0, 64))
    a, b = socket.socketpair()
    try:
        a.sendall(frame + frame)
        a.shutdown(socket.SHUT_WR)
        assert wire.recv_frame(b)[0] == wire.MSG_REQ
        assert wire.recv_frame(b)[:2] == (wire.MSG_REQ, 1)
        assert wire.recv_frame(b) is None  # clean EOF between frames
    finally:
        wire.close_hard(a)
        wire.close_hard(b)
    a, b = socket.socketpair()
    try:
        a.sendall(frame[:-5])
        a.shutdown(socket.SHUT_WR)
        with pytest.raises(TransportError, match="mid-frame"):
            wire.recv_frame(b)
    finally:
        wire.close_hard(a)
        wire.close_hard(b)


def test_tune_socket_sizes_buffers_only_when_asked():
    a, b = socket.socketpair()
    try:
        before = a.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF)
        wire.tune_socket(a, 0)
        assert a.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF) == before
        wire.tune_socket(b, 64)
        assert b.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF) \
            >= 64 * 1024
    finally:
        wire.close_hard(a)
        wire.close_hard(b)


# -- interop: each package serves the other's client -------------------------

@pytest.fixture
def tree(tmp_path):
    expected = make_mof_tree(str(tmp_path), JOB, num_maps=4,
                             num_reducers=2, records_per_map=60, seed=7)
    return str(tmp_path), expected


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_fetches_across_packages_are_byte_identical(tree, pair):
    root, _ = tree
    srv_side, cli_side = SIDES[pair[0]], SIDES[pair[1]]
    engine, server = _serve(srv_side, root)
    client = cli_side.Client("127.0.0.1", server.port, cli_side.Config())
    local = DataEngine(DirIndexResolver(root), Config())
    try:
        for mid in map_ids(JOB, 4):
            for r in range(2):
                offset, last = 0, False
                while not last:  # 700-byte chunks: several a partition
                    res = _fetch_sync(client, cli_side.Req(
                        JOB, mid, r, offset, 700))
                    assert isinstance(res, cli_side.Result), res
                    want = local.submit(ShuffleRequest(
                        JOB, mid, r, offset, 700)).result(timeout=10)
                    assert bytes(res.data) == bytes(want.data)
                    assert (res.raw_length, res.part_length, res.offset,
                            res.last, res.path) == (
                        want.raw_length, want.part_length, want.offset,
                        want.last, want.path)
                    offset += len(res.data)
                    last = res.last
        # a typed ERR frame arrives as its class, and the connection
        # survives it
        err = _fetch_sync(client, cli_side.Req(JOB, "no_such_map", 0, 0,
                                               64))
        assert isinstance(err, cli_side.err.StorageError)
        assert err.remote_kind == "StorageError"
        assert isinstance(_fetch_sync(client, cli_side.Req(
            JOB, map_ids(JOB, 1)[0], 0, 0, 1 << 20)), cli_side.Result)
        # the SIZE probe agrees with the in-process estimate
        mids = map_ids(JOB, 4)
        want = LocalFetchClient(local).estimate_partition_bytes(JOB, mids,
                                                                1)
        assert client.estimate_partition_bytes(JOB, mids, 1) == want > 0
        assert client.estimate_partition_bytes(
            JOB, mids + ["no_such_map"], 1) is None
        assert client.generation() == server.generation
        assert client.resume_ok()
    finally:
        client.stop()
        server.stop()
        engine.stop()
        local.stop()


def _banner(port: int) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        msg_type, req_id, payload = _read_frame(s)
        assert msg_type == wire.MSG_HELLO and req_id == 0
        return wire.encode_frame(msg_type, req_id, payload)


def test_hello_banners_are_equal(tmp_path):
    """With the same handoff record both servers advertise the same
    generation, warm, with the same capability bits; a drain
    announcement adds CAP_DRAINING in both."""
    banners = {}
    for side in (PORT, REF):
        path = str(tmp_path / f"{side.name}.handoff")
        with open(path, "w") as f:
            json.dump({"generation": 4242, "watermarks": {}}, f)
        engine, server = _serve(side, str(tmp_path),
                                {"uda.tpu.net.handoff.path": path})
        try:
            first = _banner(server.port)
            assert server.announce_drain() == []
            banners[side.name] = (first, _banner(server.port))
        finally:
            server.stop(drain=False)
            engine.stop()
    assert banners["port"] == banners["ref"]
    gen, warm, caps = wire.decode_hello_ex(
        banners["port"][0][wire.HEADER.size:])
    assert (gen, warm) == (4243, True)
    assert caps == wire.CAP_TRACE | wire.CAP_OBS | wire.CAP_ELASTIC
    assert wire.decode_hello_ex(banners["port"][1][wire.HEADER.size:])[2] \
        == caps | wire.CAP_DRAINING


@pytest.mark.parametrize("first,then", [("port", "ref"), ("ref", "port")])
def test_each_package_reads_the_others_handoff_record(tmp_path, first,
                                                      then):
    a, b = SIDES[first], SIDES[then]
    conf = {"uda.tpu.net.handoff.path": str(tmp_path / "handoff.json")}
    engine, server = _serve(a, str(tmp_path), conf)
    gen = server.generation
    assert not server.warm_restart
    server.stop(drain=True)  # a graceful stop persists the record
    engine.stop()
    engine, server = _serve(b, str(tmp_path), conf)
    try:
        assert server.warm_restart
        assert server.generation == (gen + 1) & 0x7FFFFFFF
        assert not (tmp_path / "handoff.json").exists()  # consumed
    finally:
        server.stop(drain=False)
        engine.stop()


def _raw_exchange(port: int, frame: bytes) -> bytes:
    """Send one frame after the banner; return the reply frame's bytes."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        assert _read_frame(s)[0] == wire.MSG_HELLO
        s.sendall(frame)
        msg_type, req_id, payload = _read_frame(s)
        return wire.encode_frame(msg_type, req_id, payload)


@pytest.mark.parametrize("kind", ["job", "push_sub", "push_ack",
                                  "unknown"])
def test_planes_the_port_lacks_answer_as_the_reference_does(tmp_path,
                                                            kind):
    """MSG_JOB draws the "runs no tenant plane" typed ERR, MSG_PUSH_SUB
    and other frames a push-less server does not take the typed refusal
    of an unknown type: the same reply bytes from both servers, and the
    connection keeps serving."""
    if kind == "unknown":
        frame = wire.encode_frame(20, 77, b"\x01\x02")
    else:
        frame = _frame(PORT, kind, 5)
    replies = {}
    for side in (PORT, REF):
        engine, server = _serve(side, str(tmp_path))
        try:
            replies[side.name] = _raw_exchange(server.port, frame)
        finally:
            server.stop(drain=False)
            engine.stop()
    assert replies["port"] == replies["ref"]
    assert wire.decode_header(replies["port"][:wire.HEADER.size])[0] \
        == wire.MSG_ERR
    err = wire.decode_error(replies["port"][wire.HEADER.size:])
    assert isinstance(err, errors.ProtocolError)


def test_stats_polls_across_packages(tmp_path):
    """MSG_STATS: the port's snapshot carries its server block; a CAP_OBS
    poll gets the sections of a disarmed telemetry plane, equal to the
    reference's never-armed ones; each package polls the other."""
    from uda_tpu.tenant.sli import SliBook
    from uda_tpu.utils.anomaly import AnomalyEngine
    from uda_tpu.utils.timeseries import TimeSeries

    engine, server = _serve(PORT, str(tmp_path))
    jengine, jserver = _serve(REF, str(tmp_path))
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    try:
        snap = client.fetch_stats(timeout=10)
        block = snap["providers"]["net.server"]
        assert block["generation"] == server.generation
        assert block["port"] == server.port
        assert len(block["connections"]) == 1
        assert "counters" in snap and "gauges" in snap
        assert set(snap) >= {"ts", "pid", "histograms"}
        full = client.fetch_stats(timeout=10, window_s=30)
        assert full["timeseries"] == TimeSeries().wire_block(seconds=30)
        assert full["sli"] == SliBook().snapshot()
        assert full["anomalies"] == AnomalyEngine().snapshot()
        assert metrics.get("net.stats.requests") == 2
        # one-shot polls, both directions
        theirs = tnet.fetch_remote_stats("127.0.0.1", jserver.port,
                                         window_s=10)
        assert theirs["providers"]["net.server"]["generation"] == \
            jserver.generation
        mine = jnet.fetch_remote_stats("127.0.0.1", server.port)
        assert mine["providers"]["net.server"]["generation"] == \
            server.generation
    finally:
        client.stop()
        server.stop()
        jserver.stop()
        engine.stop()
        jengine.stop()


# -- the full reduce over the wire -------------------------------------------

MODES = {"default": {},
         "pipeline_off": {"uda.tpu.stage.pipeline": False},
         "streaming": {"uda.tpu.online.streaming": True},
         "overlap_off": {"uda.tpu.merge.overlap": False},
         "hybrid": {"mapred.netmerger.merge.approach": 2,
                    "mapred.netmerger.hybrid.lpq.size": 2}}


def _reference_local(root, mids, conf, java_class=TEXT, reduce_id=1,
                     job="job"):
    out = bytearray()
    engine = jmofserver.DataEngine(jmofserver.DirIndexResolver(root),
                                   JConfig(conf))
    try:
        mm = jmerger.MergeManager(jmerger.LocalFetchClient(engine),
                                  java_class, JConfig(conf))
        n = mm.run(job, mids, reduce_id, out.extend)
    finally:
        engine.stop()
    return n, bytes(out)


def _port_over_wire(root, mids, conf, server_side=PORT, java_class=TEXT,
                    reduce_id=1, wrap=None):
    """The port's run() through HostRoutingClient's socket default,
    against a server of ``server_side`` on loopback."""
    engine, server = _serve(server_side, root, conf)
    router = HostRoutingClient(config=Config(conf))
    client = wrap(router) if wrap else router
    out = bytearray()
    try:
        mm = MergeManager(client, java_class, Config(conf), device="cpu")
        entries = [(f"127.0.0.1:{server.port}", m) for m in mids]
        n = mm.run("job", entries, reduce_id, out.extend)
    finally:
        client.stop()
        server.stop()
        engine.stop()
    return n, bytes(out)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_over_the_wire_matches_the_reference(tmp_path, mode):
    mids = text_tree(str(tmp_path), "job", 4, 120, seed=31)
    conf = dict(MODES[mode], **{"mapred.rdma.buf.size": 1})
    with jfailpoints.scoped(""):
        want = _reference_local(str(tmp_path), mids, conf)
    got = _port_over_wire(str(tmp_path), mids, conf)
    assert got == want and got[0] > 4096
    assert metrics.get("net.serve.fd") > 0
    assert metrics.get("net.connects") == 1


@pytest.mark.parametrize("server_conf", [
    {}, {"uda.tpu.net.zerocopy": False}, {"uda.tpu.fetch.crc": True},
    {"uda.tpu.net.zerocopy.mode": "mmap"},
    {"uda.tpu.read.batch": "off", "uda.tpu.net.zerocopy": False}],
    ids=["zerocopy", "bytes_batched", "crc", "mmap", "bytes_single"])
def test_every_serve_plane_gives_the_same_stream(tmp_path, server_conf):
    mids = text_tree(str(tmp_path), "job", 3, 100, seed=5)
    conf = dict(server_conf, **{"mapred.rdma.buf.size": 1})
    with jfailpoints.scoped(""):
        want = _reference_local(str(tmp_path), mids, conf)
    assert _port_over_wire(str(tmp_path), mids, conf) == want
    zero_copy = server_conf.get("uda.tpu.net.zerocopy", True) \
        and not server_conf.get("uda.tpu.fetch.crc")
    assert (metrics.get("net.serve.fd") > 0) == zero_copy
    assert (metrics.get("net.serve.copy") > 0) == (not zero_copy)
    assert (metrics.get("io.batch.requests") > 0) == (
        not zero_copy and server_conf.get("uda.tpu.read.batch") != "off")


def test_port_run_over_a_reference_server(tmp_path):
    mids = text_tree(str(tmp_path), "job", 4, 80, seed=8)
    conf = {"mapred.rdma.buf.size": 1}
    with jfailpoints.scoped(""):
        want = _reference_local(str(tmp_path), mids, conf)
        got = _port_over_wire(str(tmp_path), mids, conf, server_side=REF)
    assert got == want


def test_concurrent_reduce_clients_match_local_path(tree):
    root, expected = tree
    engine, server = _serve(PORT, root)
    out = {}

    def reduce(r):
        router = HostRoutingClient(config=Config())
        blocks = bytearray()
        try:
            MergeManager(router, RAW, Config(), device="cpu").run(
                JOB, [(f"127.0.0.1:{server.port}", m)
                      for m in map_ids(JOB, 4)], r, blocks.extend)
            out[r] = bytes(blocks)
        finally:
            router.stop()

    threads = [threading.Thread(target=reduce, args=(r,)) for r in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        server.stop()
        engine.stop()
    assert sorted(out) == [0, 1]
    for r in (0, 1):
        with jfailpoints.scoped(""):
            want = _reference_local(root, map_ids(JOB, 4), {},
                                    java_class=RAW, reduce_id=r, job=JOB)
        assert out[r] == want[1]
        got = list(IFileReader(io.BytesIO(out[r])))
        assert sorted(got) == sorted(expected[r])
    assert metrics.get("net.accepts") == 2


# -- HostRoutingClient's socket default --------------------------------------

def test_default_factory_address_parsing():
    connect = HostRoutingClient._socket_factory(Config())
    jconnect = jmerger.HostRoutingClient._socket_factory(JConfig())
    for host in ("sup1:1234", "sup2", "[::1]:4567", "fe80::1%eth0"):
        got, want = connect(host), jconnect(host)
        assert (got.host, got.port) == (want.host, want.port)
        assert isinstance(got, RemoteFetchClient)
    for bad in ("sup1:9o12", "[::1", "[::1]x", ""):
        with pytest.raises(TransportError) as got:
            connect(bad)
        with pytest.raises(jerrors.TransportError) as want:
            jconnect(bad)
        assert str(got.value) == str(want.value)


def test_default_factory_rejects_empty_host():
    router = HostRoutingClient(config=Config())
    try:
        err = _fetch_sync(router, ShuffleRequest(JOB, "m", 0, 0, 64,
                                                 host=""))
        assert isinstance(err, TransportError) and "empty host" in str(err)
        assert router.estimate_partition_bytes(JOB, ["m"], 0) is None
    finally:
        router.stop()


def test_host_routing_estimate_over_the_wire(tree):
    root, _ = tree
    engine, server = _serve(PORT, root)
    host = f"127.0.0.1:{server.port}"
    router = HostRoutingClient(config=Config())
    try:
        entries = [(host, m) for m in map_ids(JOB, 4)]
        want = LocalFetchClient(engine).estimate_partition_bytes(
            JOB, map_ids(JOB, 4), 0)
        assert router.estimate_partition_bytes(JOB, entries, 0) == want
        assert router.estimate_partition_bytes(
            JOB, entries + [("127.0.0.1:1", "m")], 0) is None
        assert router.generation(host) == server.generation
    finally:
        router.stop()
        server.stop()
        engine.stop()


@pytest.mark.parametrize("side", ["port", "ref"])
def test_unreachable_supplier_fails_fetch_with_transport_error(side):
    s = SIDES[side]
    client = s.Client("127.0.0.1", 1, s.Config(
        {"uda.tpu.net.connect.timeout.s": 2.0}))
    try:
        err = _fetch_sync(client, s.Req("j", "m", 0, 0, 64))
        assert isinstance(err, s.err.TransportError)
        assert "connect to supplier 127.0.0.1:1 failed" in str(err)
    finally:
        client.stop()


# -- the server's planes ------------------------------------------------------

def test_zero_copy_fd_serve_path(tmp_path, monkeypatch):
    """On the fd-cache hit path every chunk byte leaves through
    os.sendfile; the serve path's only allocations are frame heads."""
    expected = make_mof_tree(str(tmp_path), JOB, num_maps=2,
                             num_reducers=1, records_per_map=2000, seed=13,
                             val_bytes=500)
    engine, server = _serve(PORT, str(tmp_path),
                            {"uda.tpu.net.zerocopy.mode": "sendfile"})
    sent = {"bytes": 0}
    real_sendfile = server_mod.os.sendfile

    def traced_sendfile(out_fd, in_fd, offset, count):
        n = real_sendfile(out_fd, in_fd, offset, count)
        sent["bytes"] += n
        return n

    heads = []
    real_head = server_mod.wire.encode_result_head

    def traced_head(req_id, **kw):
        out = real_head(req_id, **kw)
        heads.append(len(out))
        return out

    monkeypatch.setattr(server_mod.os, "sendfile", traced_sendfile)
    monkeypatch.setattr(server_mod.wire, "encode_result_head", traced_head)
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    payload, got = 0, []
    try:
        for mid in map_ids(JOB, 2):
            parts, offset, last = [], 0, False
            while not last:
                res = _fetch_sync(client, ShuffleRequest(
                    JOB, mid, 0, offset, 256 * 1024))
                assert isinstance(res, FetchResult), res
                parts.append(bytes(res.data))
                payload += len(res.data)
                offset += len(res.data)
                last = res.is_last
            got += list(jcrack(b"".join(parts)).iter_records())
    finally:
        client.stop()
        server.stop()
        engine.stop()
    assert payload > 1 << 20
    assert sent["bytes"] == payload == metrics.get("net.sendfile.bytes")
    assert metrics.get("net.serve.fd") == len(heads) > 0
    assert metrics.get("net.serve.copy") == 0
    assert max(heads) < 256
    assert sorted(got) == sorted(expected[0])
    assert engine._admitted_bytes == 0


def test_zero_copy_mmap_mode(tmp_path):
    expected = make_mof_tree(str(tmp_path), JOB, num_maps=2,
                             num_reducers=1, records_per_map=400, seed=19,
                             val_bytes=200)
    engine, server = _serve(PORT, str(tmp_path),
                            {"uda.tpu.net.zerocopy.mode": "mmap"})
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    payload, got = 0, []
    try:
        for mid in map_ids(JOB, 2):
            parts, offset, last = [], 0, False
            while not last:
                res = _fetch_sync(client, ShuffleRequest(
                    JOB, mid, 0, offset, 64 * 1024))
                parts.append(bytes(res.data))
                payload += len(res.data)
                offset += len(res.data)
                last = res.is_last
            got += list(jcrack(b"".join(parts)).iter_records())
    finally:
        client.stop()
        server.stop()
        engine.stop()
    assert sorted(got) == sorted(expected[0])
    assert metrics.get("net.mmap.bytes") == payload > 0
    assert metrics.get("net.sendfile.bytes") == 0
    assert metrics.get("net.serve.copy") == 0
    assert server.zc_mode == "mmap"


def test_zero_copy_disabled_under_crc_and_failpoints(tmp_path):
    expected = make_mof_tree(str(tmp_path), JOB, num_maps=2,
                             num_reducers=1, records_per_map=50, seed=17)
    for conf, spec in (({"uda.tpu.fetch.crc": True}, ""),
                       ({}, "data_engine.pread=delay:0")):
        engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
        server = ShuffleServer(engine, Config(), host="127.0.0.1",
                               port=0).start()
        client = RemoteFetchClient("127.0.0.1", server.port, Config())
        try:
            with failpoints.scoped(spec):
                assert engine.slice_eligible() == (not conf and not spec)
                got = []
                for mid in map_ids(JOB, 2):
                    res = _fetch_sync(client, ShuffleRequest(
                        JOB, mid, 0, 0, 1 << 20))
                    assert isinstance(res, FetchResult)
                    assert (res.crc is not None) == bool(conf)
                    got += list(jcrack(bytes(res.data)).iter_records())
            assert sorted(got) == sorted(expected[0])
        finally:
            client.stop()
            server.stop()
            engine.stop()
    assert metrics.get("net.serve.fd") == 0
    assert metrics.get("net.serve.copy") == 4
    assert metrics.get("net.sendfile.bytes") == 0


def test_try_plan_needs_a_cached_index_and_holds_its_charge(tree):
    root, _ = tree
    engine = DataEngine(DirIndexResolver(root), Config())
    mid = map_ids(JOB, 1)[0]
    req = ShuffleRequest(JOB, mid, 0, 0, 512)
    try:
        assert engine.try_plan(req) is None  # cold index: no IO inline
        planned = engine.submit_serve(req).result(timeout=10)
        assert isinstance(planned, mofserver.FdSlice)
        planned.release()
        plan = engine.try_plan(req)          # now a cache hit
        assert isinstance(plan, mofserver.FdSlice)
        assert engine._admitted_bytes == 512
        with open(plan.path, "rb") as f:
            f.seek(plan.file_offset)
            assert bytes(plan.view()) == f.read(plan.length)
        plan.release()
        plan.release()  # idempotent
        assert engine._admitted_bytes == 0
        with pytest.raises(StorageError, match="outside partition"):
            engine.try_plan(ShuffleRequest(JOB, mid, 0, 1 << 30, 64))
        assert engine._admitted_bytes == 0
        assert isinstance(engine.fetch(req), FetchResult)
    finally:
        engine.stop()


def test_credit_cap_parks_and_drains_a_burst_iteratively(tree):
    """800 pipelined fetches against a credit cap of 8: parked requests
    drain iteratively, none lost, every credit back."""
    root, _ = tree
    engine, server = _serve(PORT, root, {"mapred.rdma.wqe.per.conn": 8})
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    n = 800
    results, done = [], threading.Event()
    lock = threading.Lock()

    def on_complete(res):
        with lock:
            results.append(res)
            if len(results) == n:
                done.set()

    try:
        for i in range(n):
            client.start_fetch(ShuffleRequest(
                JOB, map_ids(JOB, 4)[i % 4], i % 2, 0, 1 << 20),
                on_complete)
        assert done.wait(60.0), f"only {len(results)}/{n} completed"
        assert all(isinstance(r, FetchResult) for r in results)
    finally:
        client.stop()
        server.stop()
        engine.stop()
    assert metrics.get_gauge("net.server.inflight") == 0
    assert metrics.get("net.requests") == n


class _HeldEngine(DataEngine):
    """A DataEngine whose pool-side serves wait for ``gate``; ``entered``
    is set when one arrives."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gate = threading.Event()
        self.entered = threading.Event()

    def _serve_plan(self, req, admitted):
        self.entered.set()
        assert self.gate.wait(30)
        return super()._serve_plan(req, admitted)


def test_drain_on_stop_completes_inflight(tree):
    """A response the engine is still producing flushes before the
    connection closes (drain-on-stop)."""
    root, _ = tree
    engine = _HeldEngine(DirIndexResolver(root), Config())
    server = ShuffleServer(engine, Config(), host="127.0.0.1",
                           port=0).start()
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    box, done = [], threading.Event()
    try:
        client.start_fetch(
            ShuffleRequest(JOB, map_ids(JOB, 1)[0], 0, 0, 1 << 20),
            lambda res: (box.append(res), done.set()))
        assert engine.entered.wait(10)
        stopper = threading.Thread(target=server.stop)
        stopper.start()
        assert server._stopping.wait(10)
        engine.gate.set()
        stopper.join(timeout=20)
        assert done.wait(10)
        assert isinstance(box[0], FetchResult), f"drain lost: {box[0]}"
    finally:
        engine.gate.set()
        client.stop()
        engine.stop()


def test_killed_supplier_fails_fetches_and_a_restart_serves(tree):
    """stop(drain=False) with a serve in flight: the client sees
    TransportError; a server restarted on the same port serves again."""
    root, _ = tree
    engine = _HeldEngine(DirIndexResolver(root), Config())
    server = ShuffleServer(engine, Config(), host="127.0.0.1",
                           port=0).start()
    port = server.port
    client = RemoteFetchClient("127.0.0.1", port, Config())
    req = ShuffleRequest(JOB, map_ids(JOB, 1)[0], 0, 0, 1 << 20)
    try:
        box, done = [], threading.Event()
        client.start_fetch(req, lambda r: (box.append(r), done.set()))
        assert engine.entered.wait(10)
        server.stop(drain=False)
        assert done.wait(10)
        assert isinstance(box[0], TransportError)
        engine.gate.set()
        server = ShuffleServer(engine, Config(), host="127.0.0.1",
                               port=port).start()
        assert isinstance(_fetch_sync(client, req), FetchResult)
        assert metrics.get("net.disconnects", role="client") == 1
        assert not client.resume_ok()  # the restart was cold
    finally:
        engine.gate.set()
        client.stop()
        server.stop()
        engine.stop()


def test_announce_drain_is_seen_by_both_clients(tree):
    root, _ = tree
    engine, server = _serve(PORT, root)
    try:
        server.announce_drain()
        server.announce_drain()  # idempotent
        assert metrics.get("elastic.drains") == 1
        for side in (PORT, REF):
            client = side.Client("127.0.0.1", server.port, side.Config())
            try:
                assert isinstance(_fetch_sync(client, side.Req(
                    JOB, map_ids(JOB, 1)[0], 0, 0, 64)), side.Result)
                assert client.peer_draining()
                assert client.peer_caps() & wire.CAP_DRAINING
            finally:
                client.stop()
    finally:
        server.stop()
        engine.stop()


def test_socket_tuning_knobs(tree):
    root, _ = tree
    cfg = {"uda.tpu.net.sockbuf.kb": 128}
    engine, server = _serve(PORT, root, cfg)
    client = RemoteFetchClient("127.0.0.1", server.port, Config(cfg))
    try:
        assert isinstance(_fetch_sync(client, ShuffleRequest(
            JOB, map_ids(JOB, 1)[0], 0, 0, 1 << 20)), FetchResult)
        sock = client._conn.sock
        assert sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
        assert sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF) \
            >= 128 * 1024
        assert sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF) \
            >= 128 * 1024
    finally:
        client.stop()
        server.stop()
        engine.stop()


# -- the net failpoints and recovery -----------------------------------------

def _reduce_over_wire(port, cfg, mids, reduce_id=0):
    router = HostRoutingClient(config=Config(cfg))
    out = bytearray()
    try:
        MergeManager(router, RAW, Config(cfg), device="cpu").run(
            JOB, [(f"127.0.0.1:{port}", m) for m in mids], reduce_id,
            out.extend)
    finally:
        router.stop()
    return bytes(out)


@pytest.mark.faults
@pytest.mark.parametrize("spec", ["net.frame=truncate:16:every:9",
                                  "net.frame=error:every:7",
                                  "net.connect=error:once",
                                  "net.accept=error:once"])
def test_net_faults_recover_through_segment_retries(tmp_path, spec):
    """A torn or failed frame, a failed dial or a dropped accept tears a
    connection down; every in-flight fetch fails with TransportError and
    the Segment retries reconnect and finish with the local stream."""
    make_mof_tree(str(tmp_path), JOB, num_maps=5, num_reducers=1,
                  records_per_map=60, seed=5)
    engine, server = _serve(PORT, str(tmp_path))
    cfg = {"mapred.rdma.buf.size": 4, "uda.tpu.fetch.retries": 10,
           "mapred.rdma.fetch.retry.backoff.ms": 10}
    try:
        with failpoints.scoped(spec):
            got = _reduce_over_wire(server.port, cfg, map_ids(JOB, 5))
            assert metrics.get(f"failpoint.{spec.split('=')[0]}") >= 1
    finally:
        server.stop()
        engine.stop()
    with jfailpoints.scoped(""):
        want = _reference_local(str(tmp_path), map_ids(JOB, 5), cfg,
                                java_class=RAW, reduce_id=0, job=JOB)
    assert got == want[1]
    assert metrics.get("fetch.retries") >= 1
    assert metrics.get("fallback.signals") == 0


def _netted(tmp_path, handoff=True, port=0):
    cfg = {"uda.tpu.net.handoff.path":
           str(tmp_path / "handoff.json") if handoff else ""}
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(cfg))
    server = ShuffleServer(engine, Config(cfg), host="127.0.0.1",
                           port=port).start()
    return engine, server, cfg


class _Pausing:
    """An InputClient in front of ``inner`` that holds the first fetch at
    or past ``at`` (``reached`` is set) and, once ``release`` is set,
    fails it with TransportError: a fetch in flight when its supplier
    went down. Every other fetch goes straight through."""

    def __init__(self, inner, at: int):
        self.inner, self.at = inner, at
        self.reached, self.release = threading.Event(), threading.Event()
        self.held = False

    def start_fetch(self, req, on_complete):
        if req.offset >= self.at and not self.held:
            self.held = True

            def fail_later():
                assert self.release.wait(30)
                on_complete(TransportError("supplier went down mid-fetch"))

            threading.Thread(target=fail_later, daemon=True).start()
            self.reached.set()
            return
        self.inner.start_fetch(req, on_complete)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _bounce(seg, client, router, host, server, start_next):
    """Drive ``seg`` through a supplier bounce between two chunks: stop
    the server while a fetch is held, bring the next one up with
    ``start_next()``, let the client see its banner (a size probe; the
    first may ride the dead connection), then fail the held fetch."""
    seg.start()
    assert client.reached.wait(10)
    server.stop(drain=True)
    restarted = start_next()
    for _ in range(3):
        if router.estimate_partition_bytes(
                JOB, [(host, seg.map_id)], 0) is not None:
            break
    assert router.generation(host) == restarted.generation
    client.release.set()
    seg.wait(20.0)
    return restarted


def _bounced_segment(tmp_path, handoff: bool):
    expected = make_mof_tree(str(tmp_path), JOB, 1, 1, 2500, seed=12)
    engine, server, cfg = _netted(tmp_path, handoff=handoff)
    port, gen1 = server.port, server.generation
    host = f"127.0.0.1:{port}"
    router = HostRoutingClient(config=Config())
    seen = []
    real = router.start_fetch

    def recording(req, on_complete):
        seen.append(req.offset)
        real(req, on_complete)

    router.start_fetch = recording
    client = _Pausing(router, 3 * 8192)
    seg = Segment(client, JOB, map_ids(JOB, 1)[0], 0, 8192, host=host,
                  policy=RetryPolicy(retries=8, backoff_ms=10),
                  resume=True)
    srv2 = None
    try:
        assert router.resume_ok(host)
        srv2 = _bounce(seg, client, router, host, server,
                       lambda: ShuffleServer(engine, Config(cfg),
                                             host="127.0.0.1",
                                             port=port).start())
        resumable = router.resume_ok(host)
    finally:
        if srv2 is not None:
            srv2.stop()
        router.stop()
        engine.stop()
    assert sorted(seg.record_batch().iter_records()) == sorted(expected[0])
    return gen1, srv2, resumable, seen


@pytest.mark.faults
def test_warm_restart_resumes_from_the_offset_ledger(tmp_path):
    """stop(drain=True) persists the handoff; the restart advertises
    generation+1 warm and the segment resumes mid-partition without
    refetching served bytes and without a FallbackSignal."""
    gen1, srv2, resumable, seen = _bounced_segment(tmp_path, True)
    assert srv2.warm_restart and resumable
    assert srv2.generation == (gen1 + 1) & 0x7FFFFFFF
    assert metrics.get("fetch.resumed") == 1
    assert metrics.get("fetch.resumed.bytes") == 3 * 8192
    assert seen.count(0) == 1  # nothing served was fetched again
    assert metrics.get("net.handoff.persisted") == 2  # both stops
    assert metrics.get("net.handoff.loaded") == 1
    assert metrics.get("net.generation.changes") == 1


@pytest.mark.faults
def test_cold_restart_restarts_the_partition_from_zero(tmp_path):
    """Without a handoff record the restart is cold: the client revokes
    resume, and the retrying segment restarts from offset 0."""
    gen1, srv2, resumable, seen = _bounced_segment(tmp_path, False)
    assert not srv2.warm_restart and not resumable
    assert srv2.generation != gen1
    assert metrics.get("fetch.resumed") == 0
    assert seen.count(0) == 2  # the partition restarted from zero
    assert metrics.get("net.generation.changes") == 1


@pytest.mark.faults
def test_remote_pread_error_resumes_mid_partition(tmp_path):
    """A typed remote StorageError (remote_kind stamped) on a healthy
    stream keeps the offset ledger: under an every:3 pread fault, fewer
    than the partition's chunk count, only resume can finish."""
    expected = make_mof_tree(str(tmp_path), JOB, 1, 1, 2500, seed=21)
    engine, server, _ = _netted(tmp_path)
    router = HostRoutingClient(config=Config())
    seg = Segment(router, JOB, map_ids(JOB, 1)[0], 0, 8192,
                  host=f"127.0.0.1:{server.port}",
                  policy=RetryPolicy(retries=8, backoff_ms=5),
                  resume=True)
    try:
        with failpoints.scoped("data_engine.pread=error:every:3"):
            seg.start()
            seg.wait(20.0)
    finally:
        server.stop()
        router.stop()
        engine.stop()
    assert seg.num_records == len(expected[0])
    assert metrics.get("fetch.resumed") >= 1
    assert metrics.get("fetch.resumed.bytes") > 0


@pytest.mark.faults
def test_net_handoff_failpoint_degrades_to_cold(tmp_path):
    make_mof_tree(str(tmp_path), JOB, 1, 1, 10, seed=14)
    engine, server, cfg = _netted(tmp_path)
    port = server.port
    with failpoints.scoped("net.handoff=error:match:save"):
        server.stop(drain=True)  # the save is injected away; stop is clean
    srv2 = ShuffleServer(engine, Config(cfg), host="127.0.0.1",
                         port=port).start()
    try:
        assert not srv2.warm_restart
        assert metrics.get("errors.swallowed") == 1
        assert metrics.get("net.handoff.persisted") == 0
    finally:
        srv2.stop()
        engine.stop()


def test_handoff_record_survives_a_failed_start(tmp_path):
    engine, server, cfg = _netted(tmp_path)
    port = server.port
    server.stop(drain=True)  # persists the record
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        with pytest.raises(OSError):
            ShuffleServer(engine, Config(cfg), host="127.0.0.1",
                          port=blocker.getsockname()[1]).start()
        srv2 = ShuffleServer(engine, Config(cfg), host="127.0.0.1",
                             port=port).start()
        try:
            assert srv2.warm_restart  # the record was still there
        finally:
            srv2.stop()
    finally:
        blocker.close()
        engine.stop()


# -- the supplier planes, once refused ----------------------------------------

def _plane_case(kind, engine, root):
    """Drive one supplier-plane entry point the port used to refuse with
    ConfigError; returns what the case checks."""
    from uda_tpu_torch.mofserver import StoreManager
    from uda_tpu_torch.net.push import PushScheduler, PushStaging
    from uda_tpu_torch.tenant import TenantRegistry

    if kind == "tenant_enable":
        srv = ShuffleServer(engine, Config({"uda.tpu.tenant.enable": True}))
        return srv.tenancy and isinstance(srv.registry, TenantRegistry)
    if kind == "registry":
        reg = TenantRegistry()
        srv = ShuffleServer(engine, Config(), registry=reg)
        return srv.tenancy and srv.registry is reg
    if kind == "push_enable":
        srv = ShuffleServer(engine, Config({"uda.tpu.push.enable": True}))
        return isinstance(srv.push, PushScheduler)
    if kind == "drain_store":
        resolver = DirIndexResolver(root)
        mgr = StoreManager(resolver, f"{root}/blob")
        srv = ShuffleServer(engine, Config())
        moved = srv.announce_drain(store=mgr)
        return moved == [] and srv._draining
    if kind == "tenant_id":
        client = RemoteFetchClient("127.0.0.1", 1,
                                   Config({"uda.tpu.tenant.id": "t"}))
        return client._tenant == "t"
    if kind == "bind_tenant":
        client = RemoteFetchClient("127.0.0.1", 1)
        client.bind_tenant("t", epoch=3, weight=2)
        return (client._tenant, client._tenant_epoch,
                client._tenant_weight) == ("t", 3, 2)
    conf = {"uda.tpu.tenant.enable": True, "uda.tpu.push.enable": True}
    srv = ShuffleServer(engine, Config(conf), host="127.0.0.1",
                        port=0).start()
    client = RemoteFetchClient("127.0.0.1", srv.port,
                               Config({"uda.tpu.tenant.id": "t"}))
    try:
        if kind == "bind_job":
            return client.bind_job("j") == 1
        if kind == "retire_job":
            client.bind_job("j")
            return client.retire_job("j") == 1
        staging = PushStaging("j", 0, cfg=Config())
        client.push_register("j", 0, staging)
        # a round trip behind the SUB on the same connection: the server
        # handled the SUB inline before it answers
        assert client.fetch_stats() is not None
        if kind == "push_register":
            return metrics.get("push.subs") == 1
        client.push_unregister("j", 0)
        return client._push_staging == {}
    finally:
        client.stop()
        srv.stop()


@pytest.mark.parametrize("kind", [
    "tenant_enable", "registry", "push_enable", "drain_store", "tenant_id",
    "bind_tenant", "bind_job", "retire_job", "push_register",
    "push_unregister"])
def test_planes_the_port_lacks_raise_config_error(tmp_path, kind):
    """The supplier planes the port refused with ConfigError until the
    push, store and tenant modules came: each entry point now runs."""
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    try:
        assert _plane_case(kind, engine, str(tmp_path))
    finally:
        engine.stop()


def test_the_client_loop_is_one_per_process_and_each_package_has_its_own():
    from uda_tpu.net import evloop as jevloop
    from uda_tpu_torch.net import evloop

    loop = evloop.shared_client_loop()
    assert evloop.shared_client_loop() is loop and loop.alive()
    assert jevloop.shared_client_loop() is not loop
    stats = loop.stats()
    assert stats["alive"] and stats["registered"] >= 1
    assert getattr(server_mod._EvConn._on_event, "__uda_loop_callback__")


@pytest.mark.faults
@pytest.mark.parametrize("seed", [7, 10])
def test_reconstruction_through_a_killed_socket_supplier(tmp_path, seed):
    """rs:4:6 over six port ShuffleServers, a seeded supplier killed with
    no restart: run() over the wire rebuilds its partition from shards on
    the survivors and emits the reference's healthy stream, with no
    FallbackSignal."""
    from uda_tpu_torch.coding import parse_scheme
    from uda_tpu_torch.mofserver import write_striped_map_output

    num = 6
    roots = [str(tmp_path / f"r{i}") for i in range(num)]
    served = [_serve(PORT, r) for r in roots]
    hosts = [f"127.0.0.1:{s.port}" for _, s in served]
    order = sorted(range(num), key=lambda i: hosts[i])  # canonical order
    scheme = parse_scheme("rs:4:6")
    rng = np.random.default_rng(seed)
    maps = []
    for m in range(num):
        recs = sorted((rng.bytes(10), rng.bytes(30)) for _ in range(100))
        write_striped_map_output([roots[i] for i in order], m, JOB,
                                 f"m_{m:04d}", [recs], scheme)
        maps.append((hosts[order[m]], f"m_{m:04d}"))
    victim = order[seed % num]
    cfg = {"uda.tpu.coding.scheme": "rs:4:6", "uda.tpu.fetch.retries": 1,
           "mapred.rdma.fetch.retry.backoff.ms": 10,
           "uda.tpu.net.connect.timeout.s": 2.0, "mapred.rdma.buf.size": 16}
    router = HostRoutingClient(config=Config(cfg))
    out = bytearray()
    try:
        served[victim][1].stop(drain=False)  # killed, never restarted
        MergeManager(router, RAW, Config(cfg), device="cpu").run(
            JOB, maps, 0, out.extend)
    finally:
        router.stop()
        for engine, server in served:
            server.stop()
            engine.stop()
    with jfailpoints.scoped(""):
        want = _reference_local([roots[i] for i in order],
                                [m for _, m in maps], {}, java_class=RAW,
                                reduce_id=0, job=JOB)
    assert bytes(out) == want[1]
    assert metrics.get("coding.reconstructed.partitions") == 1
    assert metrics.get("fallback.signals") == 0
