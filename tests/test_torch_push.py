"""The port's push plane (uda_tpu_torch.net.push and its seams in the
server, the client, HostRoutingClient, MergeManager and MOFWriter) against
the JAX package's ``uda_tpu.net.push``: the same offers give the same
staging verdicts and ``take()`` dicts; a port server pushes to a reference
client and a reference server to a port client (CAP_PUSH both ways), each
pushed reduce adopting staged prefixes and emitting the stream a pure pull
of the same tree emits; peers without a push plane stay pull; the
``push.admit`` and ``net.push`` faults end in pull with the same stream.

Every race is decided by an event: a run starts only once the staging has
accepted the bytes the scenario expects (a wrapper on ``offer`` sets the
event), never after a sleep. Only loopback sockets are used."""

import io
import os
import threading
import types

import numpy as np
import pytest

from uda_tpu import merger as jmerger
from uda_tpu import mofserver as jmofserver
from uda_tpu import net as jnet
from uda_tpu.compress import DecompressingClient as JDecompressingClient
from uda_tpu.compress import get_codec as jget_codec
from uda_tpu.mofserver.writer import MOFWriter as JMOFWriter
from uda_tpu.net import push as jpush
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import IFileWriter
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import merger, mofserver, net
from uda_tpu_torch.compress import DecompressingClient, get_codec
from uda_tpu_torch.mofserver import read_index_file
from uda_tpu_torch.mofserver.writer import MOFWriter
from uda_tpu_torch.net import push
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics

JOB = "jobPush"
KT = "uda.tpu.RawBytes"
RECS = 300                   # 42 framed bytes a record: 12602 B a map
PUSH_CONF = {"uda.tpu.push.enable": True, "mapred.rdma.buf.size": 4,
             "uda.tpu.fetch.retries": 10}

PORT = types.SimpleNamespace(
    name="port", Engine=mofserver.DataEngine,
    Resolver=mofserver.DirIndexResolver, Server=net.ShuffleServer,
    Client=net.RemoteFetchClient, Router=merger.HostRoutingClient,
    Local=merger.LocalFetchClient, MM=merger.MergeManager, Writer=MOFWriter,
    Config=Config, Staging=push.PushStaging, metrics=metrics,
    failpoints=failpoints, mm_kw={"device": "cpu"})
REF = types.SimpleNamespace(
    name="ref", Engine=jmofserver.DataEngine,
    Resolver=jmofserver.DirIndexResolver, Server=jnet.ShuffleServer,
    Client=jnet.RemoteFetchClient, Router=jmerger.HostRoutingClient,
    Local=jmerger.LocalFetchClient, MM=jmerger.MergeManager,
    Writer=JMOFWriter, Config=JConfig, Staging=jpush.PushStaging,
    metrics=jmetrics, failpoints=jfailpoints, mm_kw={})
SIDES = {"port": PORT, "ref": REF}
# (server side, client side): each package serves the other's client
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    with failpoints.scoped(""), jfailpoints.scoped(""):
        yield
    metrics.reset()


def _blob(n_records=120, seed=3) -> bytes:
    """One partition's IFile-framed on-disk bytes."""
    rng = np.random.default_rng(seed)
    out = io.BytesIO()
    w = IFileWriter(out)
    for k, v in sorted((rng.bytes(10), rng.bytes(30))
                       for _ in range(n_records)):
        w.append(k, v)
    w.close()
    return out.getvalue()


def _write_maps(side, root, on_commit=None, num_maps=4, seed=11) -> list:
    """The map phase: ``num_maps`` one-partition map outputs of RECS
    fixed-width records through ``side``'s MOFWriter (each commit
    announced to ``on_commit``)."""
    rng = np.random.default_rng(seed)
    w = side.Writer(root, JOB, on_commit=on_commit)
    for m in range(num_maps):
        recs = sorted((rng.bytes(10), rng.bytes(30)) for _ in range(RECS))
        w.write(f"attempt_{JOB}_m_{m:06d}_0", [recs])
    return list(w.map_ids)


def _part_len(root, mid) -> int:
    d = os.path.join(root, JOB, mid)
    return read_index_file(os.path.join(d, "file.out.index"),
                           os.path.join(d, "file.out"))[0].part_length


def _pull_oracle(root, mids) -> bytes:
    """The reference's pure pull of the same tree."""
    engine = jmofserver.DataEngine(jmofserver.DirIndexResolver(root),
                                   JConfig())
    out = bytearray()
    try:
        jmerger.MergeManager(jmerger.LocalFetchClient(engine), KT,
                             JConfig()).run(JOB, mids, 0, out.extend)
    finally:
        engine.stop()
    return bytes(out)


def _gate(staging, ready):
    """An event set once ``ready(staging)`` holds after an offer (the
    dispatcher thread runs offers; the test waits on the event)."""
    ev = threading.Event()
    orig = staging.offer

    def offer(*args, **kw):
        verdict = orig(*args, **kw)
        if ready(staging):
            ev.set()
        return verdict

    staging.offer = offer
    return ev


def _push_run(srv, cli, root, *, srv_spec="", cli_spec="", missing=0,
              arm=True, server_conf=None, client_conf=None):
    """One push-armed reduce over the wire: the client side arms push
    before the map phase, the server side's writer commits 4 maps, the
    run starts once the staging holds every pushed byte but ``missing``
    maps' worth. Returns (stream, map ids, staging)."""
    sconf = dict(PUSH_CONF, **(server_conf or {}))
    cconf = dict(PUSH_CONF, **(client_conf or {}))
    engine = srv.Engine(srv.Resolver(root), srv.Config(sconf))
    server = srv.Server(engine, srv.Config(sconf), host="127.0.0.1",
                        port=0).start()
    router = cli.Router(config=cli.Config(cconf))
    mm = cli.MM(router, KT, cli.Config(cconf), **cli.mm_kw)
    addr = f"127.0.0.1:{server.port}"
    out = bytearray()
    want = []
    staging = None
    try:
        with srv.failpoints.scoped(srv_spec), \
                cli.failpoints.scoped(cli_spec):
            if arm:
                staging = mm.arm_push(JOB, 0, hosts={addr})
            gate = None
            if staging is not None:
                gate = _gate(staging, lambda st: bool(want) and
                             st.staged_bytes() == want[0])
            mids = _write_maps(srv, root, server.notify_commit)
            want.append(sum(_part_len(root, m) for m in mids)
                        - missing * _part_len(root, mids[0]))
            if gate is not None:
                if staging.staged_bytes() == want[0]:
                    gate.set()
                assert gate.wait(30), (staging.staged_bytes(), want)
            mm.run(JOB, [(addr, m) for m in mids], 0, out.extend)
    finally:
        router.stop()
        server.stop()
        engine.stop()
    return bytes(out), mids, staging


# -- reduce-side staging (the admission ladder) -------------------------------

def _offer_chunks(st, map_id, blob, chunk, start=0):
    return [st.offer(map_id, off, len(blob),
                     off + len(blob[off:off + chunk]) >= len(blob),
                     blob[off:off + chunk])
            for off in range(start, len(blob), chunk)]


def _scenario(side, kind, spill_dir):
    """One staging scenario on ``side``'s PushStaging: the verdicts,
    staged bytes and take() results it produces, in call order."""
    blob = _blob(200 if kind != "gap" else 40, seed=len(kind))
    conf = {"uda.tpu.spill.dirs": spill_dir}
    if kind == "budget":
        conf.update({"uda.tpu.push.eager.mb": 0.001,
                     "uda.tpu.push.spill": False})
    elif kind == "spill":
        conf.update({"uda.tpu.push.eager.mb": 0.001,
                     "uda.tpu.push.staged.mb": 8.0})
    elif kind == "staged_cap":
        conf.update({"uda.tpu.push.eager.mb": 0.001,
                     "uda.tpu.push.staged.mb": 0.004})
    st = side.Staging(JOB, 2, cfg=side.Config(conf))
    log = []
    try:
        if kind == "trim":
            log.append(_offer_chunks(st, "m0", blob, 1000))
            log += [st.staged_bytes(), st.take("m0"), st.take("m0")]
        elif kind == "gap":
            log.append(st.offer("m1", 0, len(blob), False, blob[:500]))
            log.append(st.offer("m1", 900, len(blob), False,
                                blob[900:1000]))
            log += [st.staged_bytes(), st.take("never_pushed"),
                    st.offer("never_pushed", 0, 100, False, blob[:100]),
                    st.take("m1"),
                    st.offer("m1", 500, len(blob), False, blob[500:600])]
        elif kind in ("budget", "spill", "staged_cap"):
            log.append(_offer_chunks(st, "m2", blob, 1024))
            log += [st.staged_bytes(), st.take("m2")]
        elif kind == "one_chunk":
            log.append(_offer_chunks(st, "m3", blob, len(blob)))
            log += [st.take("m3")]
        elif kind == "closed":
            log.append(_offer_chunks(st, "m4", blob, 4096))
            st.close()
            log += [st.offer("m5", 0, 10, False, blob[:10]),
                    st.staged_bytes(), st.take("m4")]
        elif kind == "admit_fault":
            with side.failpoints.scoped("push.admit=error:match:m6"):
                log.append(_offer_chunks(st, "m6", blob, 2000))
                log.append(_offer_chunks(st, "m7", blob, 2000))
            log += [st.take("m6"), st.take("m7")]
    finally:
        st.close()
    return log


STAGING_KINDS = ["trim", "gap", "budget", "spill", "staged_cap",
                 "one_chunk", "closed", "admit_fault"]


@pytest.mark.parametrize("kind", STAGING_KINDS)
def test_staging_verdicts_and_takes_match_the_reference(tmp_path, kind):
    got = _scenario(PORT, kind, str(tmp_path))
    want = _scenario(REF, kind, str(tmp_path))
    assert got == want
    assert metrics.snapshot() == {
        k: v for k, v in jmetrics.snapshot().items()
        if k.startswith("push.")} or kind == "admit_fault"
    assert metrics.get_gauge("push.staged.bytes") == 0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".stage")]


def test_staging_take_withholds_the_last_chunk():
    blob = _blob()
    usable = (len(blob) - 1) // 1000 * 1000
    st = push.PushStaging(JOB, 0, cfg=Config())
    assert _offer_chunks(st, "m0", blob, 1000) == [0] * (usable // 1000 + 1)
    kw = st.take("m0")
    assert kw["next_offset"] == usable and kw["data"] == blob[:usable]
    assert kw["raw_length"] == len(blob)
    assert metrics.get_gauge("push.staged.bytes") == 0
    st.close()


def test_nack_codes_and_names_match_the_reference():
    assert push.NACK_REASONS == jpush.NACK_REASONS
    for code in list(push.NACK_REASONS) + [0, 9]:
        assert push.nack_reason_name(code) == jpush.nack_reason_name(code)


# -- end to end: supplier pushes, the merge adopts ----------------------------

@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_pushed_reduce_adopts_and_matches_the_pull_stream(tmp_path, pair):
    """CAP_PUSH both ways: commits stream over as MSG_PUSH while the map
    phase runs, every map's staged prefix is adopted, and the stream
    equals the reference's pure pull of the same tree."""
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    got, mids, staging = _push_run(srv, cli, str(tmp_path))
    assert got == _pull_oracle(str(tmp_path), mids) and len(got) > 0
    chunk = PUSH_CONF["mapred.rdma.buf.size"] << 10
    length = _part_len(str(tmp_path), mids[0])
    assert cli.metrics.get("push.adopted") == len(mids)
    assert cli.metrics.get("push.adopted.bytes") == \
        len(mids) * ((length - 1) // chunk * chunk)
    assert srv.metrics.get("push.commits") == len(mids)
    assert srv.metrics.get("push.chunks") == \
        len(mids) * -(-length // chunk)
    assert srv.metrics.get_gauge("push.on_air") == 0
    assert cli.metrics.get_gauge("push.staged.bytes") == 0


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_a_late_subscription_catches_up(tmp_path, pair):
    """A SUB that arrives after every map committed still gets each one
    pushed (the catch-up path)."""
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    conf = srv.Config(PUSH_CONF)
    engine = srv.Engine(srv.Resolver(str(tmp_path)), conf)
    server = srv.Server(engine, conf, host="127.0.0.1", port=0).start()
    mids = _write_maps(srv, str(tmp_path), server.notify_commit, 3)
    total = sum(_part_len(str(tmp_path), m) for m in mids)
    client = cli.Client("127.0.0.1", server.port, cli.Config(PUSH_CONF))
    staging = cli.Staging(JOB, 0, cfg=cli.Config(PUSH_CONF))
    gate = _gate(staging, lambda st: st.staged_bytes() == total)
    try:
        client.push_register(JOB, 0, staging)
        assert gate.wait(30)
    finally:
        client.stop()
        staging.close()
        server.stop()
        engine.stop()
    assert srv.metrics.get("push.subs") == 1
    assert srv.metrics.get_gauge("push.on_air") == 0


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_a_push_server_with_a_pushless_client_stays_pull(tmp_path, pair):
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    got, mids, _ = _push_run(srv, cli, str(tmp_path), arm=False,
                             client_conf={"uda.tpu.push.enable": False})
    assert got == _pull_oracle(str(tmp_path), mids)
    assert srv.metrics.get("push.subs") == 0
    assert srv.metrics.get("push.chunks") == 0


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_a_push_client_with_a_pushless_server_stays_pull(tmp_path, pair):
    """The client arms staging but the banner carries no CAP_PUSH: no
    MSG_PUSH_SUB is ever sent, nothing is staged, the stream is the
    pull's."""
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    got, mids, staging = _push_run(
        srv, cli, str(tmp_path), missing=4,
        server_conf={"uda.tpu.push.enable": False})
    assert staging is not None
    assert got == _pull_oracle(str(tmp_path), mids)
    assert srv.metrics.get("push.subs") == 0
    assert srv.metrics.get("net.errors") == 0
    assert cli.metrics.get("push.adopted") == 0


@pytest.mark.parametrize("side", ["port", "ref"])
def test_the_push_admit_fault_ends_in_pull(tmp_path, side):
    """An injected admission failure NACKs every push of map 1 on the
    reduce side: the supplier marks it pull-only and the stream is the
    pull's. ``side`` is the client's package (where the site fires); the
    server is the other package's."""
    cli = SIDES[side]
    srv = REF if side == "port" else PORT
    mid1 = f"attempt_{JOB}_m_{1:06d}_0"
    got, mids, _ = _push_run(srv, cli, str(tmp_path), missing=1,
                             cli_spec=f"push.admit=error:match:{mid1}")
    assert got == _pull_oracle(str(tmp_path), mids)
    assert cli.metrics.get("push.refused", reason="budget") >= 1
    assert cli.metrics.get("push.adopted") == 3
    assert srv.metrics.get("push.nacks", reason="budget") >= 1
    assert srv.metrics.get_gauge("push.on_air") == 0


@pytest.mark.parametrize("side", ["port", "ref"])
def test_the_net_push_fault_ends_in_pull(tmp_path, side):
    """The first MSG_PUSH frame fails on the supplier (``side`` is the
    server's package): that map goes pull-only, the other three are
    pushed whole and adopted, and the stream is the pull's."""
    srv = SIDES[side]
    cli = REF if side == "port" else PORT
    got, mids, _ = _push_run(srv, cli, str(tmp_path), missing=1,
                             srv_spec="net.push=error:once")
    assert got == _pull_oracle(str(tmp_path), mids)
    assert srv.metrics.get("push.errors") == 1
    assert cli.metrics.get("push.adopted") == 3
    assert srv.metrics.get_gauge("push.on_air") == 0


def test_a_supplier_stop_settles_the_window_and_a_restart_serves(tmp_path):
    """Stop the supplier while pushes are in flight: its window settles,
    the staged prefixes survive, and a restarted supplier serves the
    rest; the stream is the pull's."""
    cfg = Config(PUSH_CONF)
    root = str(tmp_path)
    engine = mofserver.DataEngine(mofserver.DirIndexResolver(root), cfg)
    server = net.ShuffleServer(engine, cfg, host="127.0.0.1",
                               port=0).start()
    port = server.port
    router = merger.HostRoutingClient(config=cfg)
    mm = merger.MergeManager(router, KT, cfg, device="cpu")
    addr = f"127.0.0.1:{port}"
    out = bytearray()
    try:
        mm.arm_push(JOB, 0, hosts={addr})
        mids = _write_maps(PORT, root, server.notify_commit)
        server.stop()
        assert metrics.get_gauge("push.on_air") == 0
        server = net.ShuffleServer(engine, cfg, host="127.0.0.1",
                                   port=port).start()
        mm.run(JOB, [(addr, m) for m in mids], 0, out.extend)
    finally:
        router.stop()
        server.stop()
        engine.stop()
    assert bytes(out) == _pull_oracle(root, mids)
    assert metrics.get_gauge("push.staged.bytes") == 0


def test_a_fresh_banner_subscribes_again(tmp_path):
    """The registration outlives the connection: after a supplier bounce
    the next dial sends MSG_PUSH_SUB again."""
    cfg = Config(PUSH_CONF)
    root = str(tmp_path)
    mids = _write_maps(PORT, root)
    engine = mofserver.DataEngine(mofserver.DirIndexResolver(root), cfg)
    server = net.ShuffleServer(engine, cfg, host="127.0.0.1",
                               port=0).start()
    port = server.port
    client = net.RemoteFetchClient("127.0.0.1", port, cfg)
    staging = push.PushStaging(JOB, 0, cfg=cfg)
    try:
        client.push_register(JOB, 0, staging)
        assert client.fetch_stats() is not None  # the SUB is handled
        assert metrics.get("push.subs") == 1
        server.stop(drain=False)
        server = net.ShuffleServer(engine, cfg, host="127.0.0.1",
                                   port=port).start()
        # the first fetch may still ride the dead connection and fail;
        # the one after it dials fresh, and its SUB precedes the REQ on
        # the wire (the server handles it inline before answering)
        for _ in range(3):
            box, done = [], threading.Event()
            client.start_fetch(
                mofserver.ShuffleRequest(JOB, mids[0], 0, 0, 1 << 20),
                lambda r, box=box, done=done: (box.append(r), done.set()))
            assert done.wait(10)
            if not isinstance(box[0], Exception):
                break
        assert not isinstance(box[0], Exception)
        assert metrics.get("push.subs") == 2
    finally:
        client.stop()
        staging.close()
        server.stop()
        engine.stop()


# -- the seams ---------------------------------------------------------------

@pytest.mark.parametrize("transport", ["flag_off", "local", "decompressing"])
def test_arm_push_stays_pull_where_the_reference_does(tmp_path, transport):
    """arm_push returns None with the flag off, on a transport without a
    push plane and on DecompressingClient, in both packages."""
    results = []
    for side in (PORT, REF):
        conf = side.Config({} if transport == "flag_off" else PUSH_CONF)
        engine = side.Engine(side.Resolver(str(tmp_path)), conf)
        client = side.Router(config=conf) if transport == "flag_off" \
            else side.Local(engine)
        if transport == "decompressing":
            codec = (get_codec if side is PORT else jget_codec)("zlib")
            client = (DecompressingClient if side is PORT
                      else JDecompressingClient)(client, codec)
        try:
            mm = side.MM(client, KT, conf, **side.mm_kw)
            results.append(mm.arm_push(JOB, 0))
        finally:
            client.stop()
            engine.stop()
    assert results == [None, None]


class _Transport:
    """A transport with a push plane that records its registrations."""

    def __init__(self, log, host):
        self.log = log
        self.host = host

    def push_register(self, job_id, reduce_id, staging, hosts=None):
        self.log.append(("reg", self.host, job_id, reduce_id))

    def push_unregister(self, job_id, reduce_id):
        self.log.append(("unreg", self.host, job_id, reduce_id))

    def stop(self):
        self.log.append(("stop", self.host))


@pytest.mark.parametrize("side", ["port", "ref"])
def test_host_routing_applies_registrations_to_every_transport(side):
    """A registration reaches every cached transport, the hosts dialled
    eagerly, the members, and transports built after it; the same calls
    in the same order in both packages."""
    logs = {}
    for s in (PORT, REF):
        log = logs[s.name] = []
        router = s.Router(connect=lambda h, log=log: _Transport(log, h))
        router._client_for("a")
        router.notify_join("m")
        router.push_register(JOB, 3, object(), hosts=["b"])
        router._client_for("c")
        router.push_unregister(JOB, 3)
        router.stop()
    assert logs["port"] == logs["ref"]
    assert ("reg", "c", JOB, 3) in logs[side]


def test_writer_on_commit_fires_after_the_map_is_on_disk(tmp_path):
    seen = []

    def on_commit(job, mid):
        seen.append((job, mid, os.path.exists(os.path.join(
            str(tmp_path), job, mid, "file.out.index"))))

    mids = _write_maps(PORT, str(tmp_path), on_commit, num_maps=2)
    assert seen == [(JOB, m, True) for m in mids]
