"""The port's multi-tenant service plane (uda_tpu_torch.tenant and its
seams: MSG_JOB on the server and the client, the CreditScheduler in place
of the per-connection credit, the engine's per-tenant admission) against
the JAX package's ``uda_tpu.tenant``:

- ``TenantRegistry`` and ``CreditScheduler`` give the same grants,
  weights and errors for the same call sequence (a hypothesis sequence
  test drives the WDRR on a shared fake clock);
- MSG_JOB both ways: a port server registers, fences and retires a
  reference client's jobs and a reference server a port client's;
- two tenants reduce at once through one port server, each stream equal
  to the reference's run of its job; strict mode, authentication, the
  tenant-keyed watermarks and a fenced epoch through ``MergeManager``.

Races are decided by events and joins, never by sleeps. Only loopback
sockets are used."""

import contextlib
import threading
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

from helpers import make_mof_tree, map_ids
from uda_tpu import merger as jmerger
from uda_tpu import mofserver as jmofserver
from uda_tpu import net as jnet
from uda_tpu import tenant as jtenant
from uda_tpu.tenant import registry as jregistry
from uda_tpu.tenant import sched as jsched
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import crack
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import merger, tenant
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                     FetchResult, ShuffleRequest)
from uda_tpu_torch.net import RemoteFetchClient, ShuffleServer, wire
from uda_tpu_torch.tenant import DEFAULT_TENANT, TenantRegistry
from uda_tpu_torch.tenant import registry as tregistry
from uda_tpu_torch.tenant import sched as tsched
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (FallbackSignal, StorageError,
                                        TenantError)
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics

PORT = types.SimpleNamespace(
    name="port", Engine=DataEngine, Resolver=DirIndexResolver,
    Server=ShuffleServer, Client=RemoteFetchClient, Config=Config,
    Req=ShuffleRequest, Result=FetchResult, tenant=tenant, err=errors,
    metrics=metrics, failpoints=failpoints)
REF = types.SimpleNamespace(
    name="ref", Engine=jmofserver.DataEngine,
    Resolver=jmofserver.DirIndexResolver, Server=jnet.ShuffleServer,
    Client=jnet.RemoteFetchClient, Config=JConfig,
    Req=jmofserver.ShuffleRequest, Result=jmofserver.FetchResult,
    tenant=jtenant, err=jerrors, metrics=jmetrics, failpoints=jfailpoints)
SIDES = {"port": PORT, "ref": REF}
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]

JOB_A = "jobTenA"
JOB_B = "jobTenB"
TEN_CFG = {"uda.tpu.tenant.enable": True}


@contextlib.contextmanager
def _clock(now):
    """Both packages' registry and scheduler read ``now[0]`` as their
    monotonic clock (their modules' own ``time`` name is swapped, so no
    other thread's clock moves)."""
    fake = types.SimpleNamespace(monotonic=lambda: now[0])
    mods = (tregistry, tsched, jregistry, jsched)
    saved = [m.time for m in mods]
    for m in mods:
        m.time = fake
    try:
        yield
    finally:
        for m, t in zip(mods, saved):
            m.time = t


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    with failpoints.scoped(""), jfailpoints.scoped(""):
        yield
    metrics.reset()


def _outcome(fn, *args, **kw):
    """A call's result, or its error as (class name, message)."""
    try:
        out = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))
    if hasattr(out, "tenant_id"):  # a TenantRecord
        return ("rec", out.tenant_id, out.job_id, out.epoch, out.weight,
                out.state)
    return out


# -- the registry ------------------------------------------------------------

def _lifecycle(side):
    reg = side.tenant.TenantRegistry()
    retired = []
    reg.on_retire(lambda t, j: retired.append((t, j)))
    return [_outcome(reg.register, "acme", "job_1", epoch=1, weight=3),
            reg.weight_of("acme"),
            _outcome(reg.register, "acme", "job_1", epoch=1, weight=3),
            _outcome(reg.validate, "acme", "job_1", epoch=1),
            _outcome(reg.retire, "acme", "job_1", epoch=1),
            _outcome(reg.validate, "acme", "job_1", epoch=1),
            _outcome(reg.register, "acme", "job_1", epoch=1),
            _outcome(reg.register, "acme", "job_1", epoch=2),
            _outcome(reg.register, "acme", "job_1", epoch=0),
            retired, reg.active_tenants()]


def _fencing(side):
    reg = side.tenant.TenantRegistry()
    return [_outcome(reg.register, "t", "j", epoch=3),
            _outcome(reg.register, "t", "j", epoch=2),
            _outcome(reg.register, "t", "j", epoch=4),
            _outcome(reg.validate, "t", "j", epoch=3),
            _outcome(reg.validate, "t", "j", epoch=4),
            _outcome(reg.retire, "t", "j", epoch=3),
            _outcome(reg.validate, "t", "j", epoch=4),
            side.metrics.get("tenant.epoch.fenced")]


def _auth(side):
    reg = side.tenant.TenantRegistry(secret="s3cret")
    tok = side.tenant.sign_job("s3cret", "t", "j", 1)
    return [tok, side.tenant.sign_job("", "t", "j", 1),
            _outcome(reg.validate, "t", "nope"),
            _outcome(reg.register, "t", "j", epoch=1, token="bogus"),
            _outcome(reg.register, "t", "j", epoch=1, token=tok),
            _outcome(reg.register, "t", "j", epoch=2, token=tok),
            _outcome(reg.retire, "t", "j", 1, token="bad")]


def _shares(side):
    reg = side.tenant.TenantRegistry()
    out = [_outcome(reg.register, "a", "ja", epoch=1, weight=2),
           reg.share_bytes("a", 900)]
    reg.register("b", "jb", epoch=1, weight=1)
    out += [reg.share_bytes("a", 900), reg.share_bytes("b", 900),
            reg.share_bytes("zz", 900)]
    reg.register("b", "jb2", epoch=1, weight=5)
    out += [reg.weight_of("b"), reg.share_bytes("a", 900)]
    reg.retire("b", "jb2", 1)
    out += [reg.weight_of("b"), reg.share_bytes("b", 900)]
    snap = reg.snapshot()
    out.append([(j["tenant"], j["job"], j["epoch"], j["weight"], j["state"])
                for j in snap["jobs"]])
    return out


def _ttl(side):
    now = [100.0]
    with _clock(now):
        reg = side.tenant.TenantRegistry(ttl_s=5.0)
        out = [_outcome(reg.register, "t", "j", epoch=1)]
        now[0] += 3.0
        out.append(_outcome(reg.validate, "t", "j"))
        now[0] += 4.0
        out.append(_outcome(reg.validate, "t", "j"))
        now[0] += 6.0
        out += [_outcome(reg.validate, "t", "j"), reg.weight_of("t")]
    return out


@pytest.mark.parametrize("walk", [_lifecycle, _fencing, _auth, _shares],
                         ids=["lifecycle", "fencing", "auth", "shares"])
def test_registry_walks_match_the_reference(walk):
    got = walk(PORT)
    assert got == walk(REF)
    assert any(isinstance(o, tuple) and o[0] == "TenantError" for o in got) \
        or walk is _shares


def test_registry_ttl_matches_the_reference():
    got = _ttl(PORT)
    assert got == _ttl(REF)
    assert got[-2][0] == "TenantError" and "unknown job" in got[-2][1]


def test_the_registry_failpoints_fire_typed(tmp_path):
    reg = TenantRegistry()
    with failpoints.scoped("tenant.register=error:once"):
        with pytest.raises(TenantError, match="tenant.register"):
            reg.register("t", "j", epoch=1)
        assert reg.register("t", "j", epoch=1).active
    with failpoints.scoped("tenant.validate=error:match:t"):
        with pytest.raises(TenantError, match="tenant.validate"):
            reg.validate("t", "j")
    assert metrics.get("failpoint.tenant.validate") == 1


def test_current_tenant_is_process_local():
    assert tenant.current_tenant() == ""
    tenant.set_current_tenant("acme")
    try:
        assert tenant.current_tenant() == "acme"
        assert jtenant.current_tenant() == ""  # each package its own
    finally:
        tenant.set_current_tenant("")


# -- the weighted-fair scheduler ---------------------------------------------

class _Conn:
    """Stand-in for the parked item's connection slot."""


def _drain(sched, live, on_grant=None, stop=None, limit=100_000):
    """Settle the oldest live item and sweep, until nothing is live (or
    ``stop()``); returns the granted entries in grant order."""
    served = []
    while live and limit:
        limit -= 1
        t, _i = live.pop(0)[:2]
        sched.release(t)
        for _conn, entry in sched.grant_parked():
            served.append(entry)
            live.append(entry)
        if stop is not None and stop():
            break
    return served


def _wdrr_counts(side):
    weights = {"a": 2, "b": 1, "c": 1}
    sched = side.tenant.CreditScheduler(4, weight_of=weights.get)
    conn = _Conn()
    live = []
    for i, t in enumerate(t for _ in range(40) for t in ("a", "b", "c")):
        if sched.admit(t, (conn, (t, i))):
            live.append((t, i))
    served = _drain(sched, live)
    return served, sched.free, sched.backlog(), dict(sched.granted_cost), \
        {t: tq.deficit for t, tq in sched._tenants.items()}


def test_wdrr_weight_proportionality_matches_the_reference():
    got = _wdrr_counts(PORT)
    assert got == _wdrr_counts(REF)
    served, free, backlog = got[:3]
    assert len(served) == 116 and free == 4 and backlog == 0
    window = served[:len(served) // 2]
    wc = {t: sum(1 for e in window if e[0] == t) for t in "abc"}
    assert wc["a"] > 1.5 * wc["b"]


def _wdrr_bytes(side, oversized):
    weights = {"a": 2, "b": 1, "c": 1}
    sizes = ({t: 4 << 20 for t in weights} if oversized
             else {"a": 64 << 10, "b": 256 << 10, "c": 16 << 10})
    sched = side.tenant.CreditScheduler(4, weight_of=weights.get,
                                        quantum=float(64 << 10))
    conn = _Conn()
    live = []
    for i in range(240):
        t = ("a", "b", "c")[i % 3]
        if sched.admit(t, (conn, (t, i)), cost=sizes[t]):
            live.append((t, i))
    served = _drain(sched, live, stop=lambda: any(
        sched.backlog(t) == 0 for t in weights))
    got = {t: sum(sizes[t] for e in served if e[0] == t) for t in weights}
    return served, got


@pytest.mark.parametrize("oversized", [False, True],
                         ids=["mixed_chunks", "oversized_heads"])
def test_wdrr_byte_shares_match_the_reference(oversized):
    served, got = _wdrr_bytes(PORT, oversized)
    assert (served, got) == _wdrr_bytes(REF, oversized)
    share = got["a"] / sum(got.values())
    assert share >= 0.4, got


def _small_cases(side):
    sc = side.tenant.CreditScheduler
    conn, c2 = _Conn(), _Conn()
    out = []
    # FIFO within a tenant and the inline grant
    s = sc(1)
    out += [s.admit("t", (conn, ("t", 0))), s.admit("t", (conn, ("t", 1))),
            s.admit("t", (conn, ("t", 2)))]
    s.release("t")
    out.append([e for _, e in s.grant_parked()])
    # an oversized head accumulates and is force-served, booking debt
    s = sc(1, quantum=float(1 << 10))
    out += [s.admit("big", (conn, ("big", 0)), cost=1 << 10),
            s.admit("big", (conn, ("big", 1)), cost=1 << 20)]
    s.release("big")
    out.append([e for _, e in s.grant_parked()])
    debt = s._tenants["big"].deficit
    s.release("big")
    out += [debt, s.admit("big", (conn, ("big", 2)), cost=1 << 20),
            s._tenants["big"].deficit, dict(s.granted_cost)]
    # drop_conn removes only that connection's parked items
    s = sc(1)
    s.admit("t", (conn, ("t", 0)))
    s.admit("t", (conn, ("t", 1)))
    s.admit("t", (c2, ("t", 2)))
    out.append(s.drop_conn(conn))
    s.release("t")
    out.append([e for _, e in s.grant_parked()])
    out.append(s.stats())
    return out


def test_wdrr_small_cases_match_the_reference():
    got = _small_cases(PORT)
    assert got == _small_cases(REF)
    assert got[3] == [("t", 1)] and got[6] == [("big", 1)]


def _penalty(side):
    now = [10.0]
    with _clock(now):
        s = side.tenant.CreditScheduler(1, penalty_threshold=2,
                                        penalty_ms=60_000)
        conn = _Conn()
        s.admit("bad", (conn, ("bad", 0)))
        s.admit("bad", (conn, ("bad", 1)))
        s.admit("good", (conn, ("good", 0)))
        s.note_fault("bad")
        s.note_fault("bad")
        out = [s.boxed("bad"), s.boxed("good")]
        s.release("bad")
        out.append([e for _, e in s.grant_parked()])
        s.release("good")
        out.append([e for _, e in s.grant_parked()])
        now[0] += 61.0
        out.append(s.boxed("bad"))
    return out


def test_the_penalty_box_matches_the_reference():
    got = _penalty(PORT)
    assert got == _penalty(REF)
    assert got == [True, False, [("good", 0)], [("bad", 1)], False]
    assert metrics.get("tenant.penalties", tenant="bad") == 1


_OPS = hs.lists(hs.one_of(
    hs.tuples(hs.just("admit"), hs.sampled_from("abc"),
              hs.sampled_from([1, 3, 64, 700, 5000]), hs.integers(0, 1)),
    hs.tuples(hs.just("release"), hs.integers(0, 7)),
    hs.tuples(hs.just("sweep")),
    hs.tuples(hs.just("fault"), hs.sampled_from("abc")),
    hs.tuples(hs.just("drop"), hs.integers(0, 1)),
    hs.tuples(hs.just("tick"), hs.sampled_from([0.1, 2.0]))),
    max_size=60)


def _replay(side, ops, total, quantum, weights, now):
    """One op sequence on ``side``'s scheduler; every observable after
    every op, on the shared fake clock ``now``."""
    s = side.tenant.CreditScheduler(total, weight_of=weights.get,
                                    quantum=quantum, penalty_threshold=2,
                                    penalty_ms=1000)
    conns = [_Conn(), _Conn()]
    live, trace, n = [], [], 0
    for op in ops:
        if op[0] == "admit":
            n += 1
            entry = (op[1], n)
            ok = s.admit(op[1], (conns[op[3]], entry), cost=op[2])
            if ok:
                live.append(entry)
            trace.append(ok)
        elif op[0] == "release" and live:
            t = live.pop(op[1] % len(live))[0]
            s.release(t)
        elif op[0] == "sweep":
            got = [e for _, e in s.grant_parked()]
            live += got
            trace.append(got)
        elif op[0] == "fault":
            s.note_fault(op[1])
        elif op[0] == "drop":
            trace.append(s.drop_conn(conns[op[1]]))
        elif op[0] == "tick":
            now[0] += op[1]
        trace.append((s.free, s.backlog(), s.grants,
                      sorted(s.granted_cost.items()),
                      sorted((t, round(q.deficit, 6), q.faults)
                             for t, q in s._tenants.items())))
    return trace


@settings(max_examples=60, deadline=None, derandomize=True)
@given(ops=_OPS, total=hs.integers(1, 4),
       quantum=hs.sampled_from([1.0, 64.0, 1024.0]),
       wa=hs.integers(1, 4))
def test_wdrr_sequences_match_the_reference(ops, total, quantum, wa):
    weights = {"a": wa, "b": 1, "c": 2}
    now = [1000.0]
    with _clock(now):
        got = _replay(PORT, ops, total, quantum, weights, now)
        now[0] = 1000.0
        want = _replay(REF, ops, total, quantum, weights, now)
    assert got == want


# -- the wire ----------------------------------------------------------------

def _tenant_cfg(side, tenant_id, **extra):
    return side.Config(dict({"uda.tpu.tenant.id": tenant_id}, **extra))


def _fetch_sync(client, req, timeout=10.0):
    box, done = [], threading.Event()
    client.start_fetch(req, lambda res: (box.append(res), done.set()))
    assert done.wait(timeout), "fetch never completed"
    return box[0]


def _fetch_job(side, client, job, num_maps, reduce_id=0):
    got = []
    for mid in map_ids(job, num_maps):
        res = _fetch_sync(client, side.Req(job, mid, reduce_id, 0, 1 << 20))
        assert isinstance(res, side.Result), res
        got += list(crack(res.data).iter_records())
    return sorted(got)


@pytest.fixture
def two_jobs(tmp_path):
    expected_a = make_mof_tree(str(tmp_path), JOB_A, num_maps=3,
                               num_reducers=1, records_per_map=40, seed=3)
    expected_b = make_mof_tree(str(tmp_path), JOB_B, num_maps=3,
                               num_reducers=1, records_per_map=40, seed=4)
    return str(tmp_path), sorted(expected_a[0]), sorted(expected_b[0])


def _serve(side, root, conf=None):
    engine = side.Engine(side.Resolver(root), side.Config())
    server = side.Server(engine, side.Config(dict(TEN_CFG, **(conf or {}))),
                         host="127.0.0.1", port=0).start()
    return engine, server


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_msg_job_binds_fences_and_retires_across_packages(two_jobs, pair):
    """MSG_JOB both ways: bind, fetch, a successor epoch fences the
    predecessor's next fetch with a typed TenantError, a stale
    re-registration is refused, retirement ends the job."""
    root, want_a, _ = two_jobs
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    engine, server = _serve(srv, root)
    old = cli.Client("127.0.0.1", server.port,
                     _tenant_cfg(cli, "a", **{"uda.tpu.tenant.epoch": 1}))
    new = cli.Client("127.0.0.1", server.port,
                     _tenant_cfg(cli, "a", **{"uda.tpu.tenant.epoch": 2}))
    try:
        assert old.bind_job(JOB_A) == 1
        assert old.peer_caps() & wire.CAP_TENANT
        assert _fetch_job(cli, old, JOB_A, 3) == want_a
        assert new.bind_job(JOB_A) == 2
        err = _fetch_sync(old, cli.Req(JOB_A, map_ids(JOB_A, 1)[0], 0, 0,
                                       1 << 20))
        assert isinstance(err, cli.err.TenantError)
        assert "stale epoch" in str(err)
        assert _fetch_job(cli, new, JOB_A, 3) == want_a
        with pytest.raises(cli.err.TenantError, match="stale epoch"):
            old.bind_job(JOB_A)
        assert new.retire_job(JOB_A) == 2
        err = _fetch_sync(new, cli.Req(JOB_A, map_ids(JOB_A, 1)[0], 0, 0,
                                       1 << 20))
        assert isinstance(err, cli.err.TenantError) and "retired" in str(err)
    finally:
        old.stop()
        new.stop()
        server.stop()
        engine.stop()
    assert srv.metrics.get("tenant.epoch.fenced") == 1


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_a_first_fetch_binds_the_job_before_its_request(two_jobs, pair):
    """No explicit bind_job: the client's first fetch of a job sends
    MSG_JOB ahead of its REQ, and the server schedules it under the
    bound tenant."""
    root, want_a, want_b = two_jobs
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    engine, server = _serve(srv, root)
    client = cli.Client("127.0.0.1", server.port, _tenant_cfg(cli, "solo"))
    try:
        assert _fetch_job(cli, client, JOB_A, 3) == want_a
        assert _fetch_job(cli, client, JOB_B, 3) == want_b
    finally:
        client.stop()
        server.stop()
        engine.stop()
    assert srv.metrics.get("tenant.sched.grants", tenant="solo") == 6
    assert srv.metrics.get("tenant.registered", tenant="solo") == 2


def test_an_unbound_client_rides_the_default_tenant(two_jobs):
    root, want_a, _ = two_jobs
    engine, server = _serve(PORT, root)
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    try:
        assert _fetch_job(PORT, client, JOB_A, 3) == want_a
    finally:
        client.stop()
        server.stop()
        engine.stop()
    assert metrics.get("tenant.sched.grants", tenant=DEFAULT_TENANT) == 3


@pytest.mark.parametrize("side", ["port", "ref"])
def test_strict_mode_refuses_unregistered_jobs(two_jobs, side):
    """A port server in strict mode refuses ``side``'s unbound client
    with the typed error and serves its bound one."""
    root, want_a, _ = two_jobs
    cli = SIDES[side]
    engine, server = _serve(PORT, root, {"uda.tpu.tenant.strict": True})
    unbound = cli.Client("127.0.0.1", server.port, cli.Config())
    bound = cli.Client("127.0.0.1", server.port, _tenant_cfg(cli, "a"))
    try:
        err = _fetch_sync(unbound, cli.Req(JOB_A, map_ids(JOB_A, 1)[0], 0,
                                           0, 1 << 20))
        assert isinstance(err, cli.err.TenantError)
        assert "registration" in str(err)
        assert _fetch_job(cli, bound, JOB_A, 3) == want_a
    finally:
        unbound.stop()
        bound.stop()
        server.stop()
        engine.stop()


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_msg_job_authentication_across_packages(two_jobs, pair):
    root, want_a, _ = two_jobs
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    engine, server = _serve(srv, root, {"uda.tpu.tenant.secret": "hunter2"})
    bad = cli.Client("127.0.0.1", server.port, _tenant_cfg(cli, "a"))
    good = cli.Client("127.0.0.1", server.port, _tenant_cfg(
        cli, "a", **{"uda.tpu.tenant.secret": "hunter2"}))
    try:
        with pytest.raises(cli.err.TenantError, match="authentication"):
            bad.bind_job(JOB_A)
        err = _fetch_sync(bad, cli.Req(JOB_A, map_ids(JOB_A, 1)[0], 0, 0,
                                       1 << 20))
        assert isinstance(err, cli.err.TenantError) and "refused" in str(err)
        assert good.bind_job(JOB_A) == 1
        assert _fetch_job(cli, good, JOB_A, 3) == want_a
    finally:
        bad.stop()
        good.stop()
        server.stop()
        engine.stop()


def test_the_tenant_register_failpoint_answers_a_typed_err(two_jobs):
    root, _, _ = two_jobs
    engine, server = _serve(PORT, root)
    client = RemoteFetchClient("127.0.0.1", server.port,
                               _tenant_cfg(PORT, "a"))
    try:
        with failpoints.scoped("tenant.register=error:once"):
            with pytest.raises(TenantError, match="tenant.register"):
                client.bind_job(JOB_A)
            assert client.bind_job(JOB_A) == 1
    finally:
        client.stop()
        server.stop()
        engine.stop()


def _reference_local(root, job, reduce_id=0) -> bytes:
    engine = jmofserver.DataEngine(jmofserver.DirIndexResolver(root),
                                   JConfig())
    out = bytearray()
    try:
        jmerger.MergeManager(jmerger.LocalFetchClient(engine),
                             "uda.tpu.RawBytes", JConfig()).run(
            job, map_ids(job, 3), reduce_id, out.extend)
    finally:
        engine.stop()
    return bytes(out)


def test_two_tenants_reduce_at_once_with_byte_parity(two_jobs):
    """Tenant t1 (weight 1) and t3 (weight 3) run their reduce tasks at
    once through one port server with 4 shared credits, each bound by
    MSG_JOB from its own Config: each stream equals the reference's run
    of its job, and the credit pool settles back to full."""
    root, _, _ = two_jobs
    engine, server = _serve(PORT, root, {"uda.tpu.tenant.wqe.total": 4})
    addr = f"127.0.0.1:{server.port}"
    out, errs = {}, []

    def task(tenant_id, weight, job):
        cfg = Config({"uda.tpu.tenant.id": tenant_id,
                      "uda.tpu.tenant.weight": weight,
                      "mapred.rdma.buf.size": 1})
        router = merger.HostRoutingClient(config=cfg)
        blocks = bytearray()
        try:
            merger.MergeManager(router, "uda.tpu.RawBytes", cfg,
                                device="cpu").run(
                job, [(addr, m) for m in map_ids(job, 3)], 0,
                blocks.extend)
            out[tenant_id] = bytes(blocks)
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append((tenant_id, e))
        finally:
            router.stop()

    threads = [threading.Thread(target=task, args=("t1", 1, JOB_A)),
               threading.Thread(target=task, args=("t3", 3, JOB_B))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errs, errs
        assert out["t1"] == _reference_local(root, JOB_A)
        assert out["t3"] == _reference_local(root, JOB_B)
        assert server.registry.weight_of("t3") == 3
        granted = server._sched.granted_cost
        assert granted["t1"] > 0 and granted["t3"] > 0
        done = threading.Event()
        server._loop.call_soon(done.set)  # settles queued before it ran
        assert done.wait(10)
        assert server._sched.free == server._sched.total
    finally:
        server.stop()
        engine.stop()
    assert metrics.get_gauge("tenant.read.bytes.on_air") == 0


def test_per_tenant_admission_isolation(tmp_path):
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    reg = TenantRegistry()
    reg.register("hog", "jh", epoch=1)
    reg.register("calm", "jc", epoch=1)
    engine.set_tenant_registry(reg)
    try:
        share = reg.share_bytes("hog", engine.read_budget_bytes)
        engine._admit_bytes(share, "hog")
        with pytest.raises(StorageError, match="read share"):
            engine._admit_bytes(1 << 20, "hog")
        assert metrics.get("tenant.admission.rejections", tenant="hog") == 1
        engine._admit_bytes(1 << 20, "calm")
        engine._unadmit(1 << 20, "calm")
        assert engine.drain_tenant("hog") == share
        engine._unadmit(share, "hog")
        reg.retire("hog", "jh", 1)  # the retire hook finds it quiescent
        assert engine.drain_tenant("hog") == 0
    finally:
        engine.stop()
    assert metrics.get_gauge("tenant.read.bytes.on_air") == 0


def test_watermarks_are_keyed_by_tenant(tmp_path):
    expected = make_mof_tree(str(tmp_path), JOB_A, num_maps=1,
                             num_reducers=1, records_per_map=20, seed=5)
    engine, server = _serve(PORT, str(tmp_path), {
        "uda.tpu.net.handoff.path": str(tmp_path / "handoff.json")})
    ca = RemoteFetchClient("127.0.0.1", server.port, _tenant_cfg(PORT, "a"))
    cb = RemoteFetchClient("127.0.0.1", server.port, _tenant_cfg(PORT, "b"))
    try:
        ca.bind_job(JOB_A)
        cb.bind_job(JOB_A)
        assert _fetch_job(PORT, ca, JOB_A, 1) == sorted(expected[0])
        assert _fetch_job(PORT, cb, JOB_A, 1) == sorted(expected[0])
        mid = map_ids(JOB_A, 1)[0]
        assert {f"a|{JOB_A}|{mid}|0", f"b|{JOB_A}|{mid}|0"} <= \
            set(server._marks)
    finally:
        ca.stop()
        cb.stop()
        server.stop()
        engine.stop()


def test_tenancy_off_stamps_nothing(tmp_path):
    make_mof_tree(str(tmp_path), JOB_A, num_maps=1, num_reducers=1,
                  records_per_map=10, seed=1)
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    server = ShuffleServer(engine, Config({
        "uda.tpu.net.handoff.path": str(tmp_path / "handoff.json")}),
        host="127.0.0.1", port=0).start()
    client = RemoteFetchClient("127.0.0.1", server.port,
                               _tenant_cfg(PORT, "a"))
    try:
        assert _fetch_job(PORT, client, JOB_A, 1)
        assert not client.peer_caps() & wire.CAP_TENANT
        mid = map_ids(JOB_A, 1)[0]
        assert f"|{JOB_A}|{mid}|0" in server._marks
        assert server.registry is None and server._sched is None
        assert metrics.get("tenant.sched.grants") == 0
    finally:
        client.stop()
        server.stop()
        engine.stop()


def test_introspection_carries_the_tenancy_block(two_jobs):
    root, _, _ = two_jobs
    engine, server = _serve(PORT, root)
    client = RemoteFetchClient("127.0.0.1", server.port,
                               _tenant_cfg(PORT, "a"))
    try:
        client.bind_job(JOB_A)
        snap = client.fetch_stats()["providers"]["net.server"]
        assert snap["tenancy"]["scheduler"]["total"] == server._sched.total
        assert [(j["tenant"], j["job"]) for j in
                snap["tenancy"]["registry"]["jobs"]] == [("a", JOB_A)]
        assert [c["tenant"] for c in snap["connections"]] == ["a"]
    finally:
        client.stop()
        server.stop()
        engine.stop()


@pytest.mark.parametrize("side", ["port", "ref"])
def test_a_fenced_epoch_is_terminal_through_merge_manager(two_jobs, side):
    """A port MergeManager whose client binds a fenced epoch ends in
    FallbackSignal(TenantError) at once, without retries, against
    ``side``'s server."""
    root, _, _ = two_jobs
    engine, server = _serve(SIDES[side], root)
    fencer = RemoteFetchClient("127.0.0.1", server.port, _tenant_cfg(
        PORT, "a", **{"uda.tpu.tenant.epoch": 2}))
    cfg = _tenant_cfg(PORT, "a", **{
        "uda.tpu.tenant.epoch": 1, "uda.tpu.fetch.retries": 5,
        "mapred.rdma.fetch.retry.backoff.ms": 500})
    router = merger.HostRoutingClient(config=cfg)
    mm = merger.MergeManager(router, "uda.tpu.RawBytes", cfg, device="cpu")
    try:
        fencer.bind_job(JOB_A)
        with pytest.raises(FallbackSignal) as ei:
            mm.run(JOB_A, [(f"127.0.0.1:{server.port}", m)
                           for m in map_ids(JOB_A, 3)], 0, lambda b: None)
        assert isinstance(ei.value.cause, TenantError)
        assert metrics.get("fetch.retries") == 0
    finally:
        router.stop()
        mm.stop()
        fencer.stop()
        server.stop()
        engine.stop()


def test_an_abusive_tenant_degrades_only_itself(two_jobs):
    """tenant.validate errors on every request of tenant 'abuser' while
    tenant 'victim' fetches through the same server: the victim's bytes
    are whole, the abuser's requests all fail typed and it is boxed."""
    root, _, want_b = two_jobs
    engine, server = _serve(PORT, root)
    abuser = RemoteFetchClient("127.0.0.1", server.port,
                               _tenant_cfg(PORT, "abuser"))
    victim = RemoteFetchClient("127.0.0.1", server.port,
                               _tenant_cfg(PORT, "victim"))
    out, errs = {}, []
    try:
        with failpoints.scoped("tenant.validate=error:match:abuser"):
            abuser.bind_job(JOB_A)
            victim.bind_job(JOB_B)
            tv = threading.Thread(target=lambda: out.update(
                b=_fetch_job(PORT, victim, JOB_B, 3)))
            ta = threading.Thread(target=lambda: errs.extend(
                _fetch_sync(abuser, ShuffleRequest(JOB_A, mid, 0, 0,
                                                   1 << 20))
                for mid in map_ids(JOB_A, 3)))
            tv.start()
            ta.start()
            tv.join(30)
            ta.join(30)
        assert out["b"] == want_b
        assert len(errs) == 3
        assert all(isinstance(e, TenantError) for e in errs)
        assert metrics.get("tenant.rejected") == 0
        assert metrics.get("failpoint.tenant.validate") >= 3
    finally:
        abuser.stop()
        victim.stop()
        server.stop()
        engine.stop()
