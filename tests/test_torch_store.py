"""The port's elastic disaggregated MOF store (uda_tpu_torch.mofserver.
store and its seams: DataEngine.attach_store, MOFWriter(store=),
ShuffleServer.announce_drain(store=), the resolver's invalidate, and the
membership calls of HostRoutingClient, Segment and MergeManager) against
the JAX package's ``uda_tpu.mofserver.store``:

- a blob-tier migration writes ``file.out`` and the rewritten v2 ``UDIX``
  index byte for byte as the reference's migration of the same tree does,
  for plain, compressed and striped trees;
- the spill ladder keeps retention at the watermark and migrates the same
  partitions, oldest first, with the same CRCs;
- ``store.get`` keyed ``blob:`` fails over to the twin byte-identically;
  a partition with no twin surfaces a typed StoreError;
- ``validate_spilled`` and a checkpoint resume through
  ``_revalidate_spilled`` catch a damaged spilled object;
- a migrated partition resolves to its blob copy after ``invalidate``;
- a store-spilled tree reduces over the wire, across packages both ways,
  to the reference's stream.

Races are decided by events, never by sleeps; time-based penalties run on
a patched clock. Only loopback sockets are used."""

import os
import shutil
import threading
import types

import numpy as np
import pytest

from helpers import make_mof_tree, map_ids
from uda_tpu import merger as jmerger
from uda_tpu import mofserver as jmofserver
from uda_tpu import net as jnet
from uda_tpu.coding import parse_scheme as jparse_scheme
from uda_tpu.compress import DecompressingClient as JDecompressingClient
from uda_tpu.compress import get_codec as jget_codec
from uda_tpu.mofserver import store as jstore
from uda_tpu.mofserver.writer import MOFWriter as JMOFWriter
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import crack
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import merger, net
from uda_tpu_torch.compress import DecompressingClient, get_codec
from uda_tpu_torch.merger.merge_manager import PenaltyBox
from uda_tpu_torch.merger.recovery import RecoveryLedger
from uda_tpu_torch.mofserver import (BackendHealth, BlobStore, DataEngine,
                                     DirIndexResolver, LocalFdStore,
                                     MOFWriter, ShuffleRequest,
                                     StoreManager, store)
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (FallbackSignal, StorageError,
                                        StoreError)
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics

KT = "uda.tpu.RawBytes"

PORT = types.SimpleNamespace(
    name="port", Engine=DataEngine, Resolver=DirIndexResolver,
    Server=net.ShuffleServer, Router=merger.HostRoutingClient,
    Local=merger.LocalFetchClient, MM=merger.MergeManager,
    Writer=MOFWriter, Config=Config, Manager=StoreManager,
    Health=BackendHealth, Blob=BlobStore, Local_=LocalFdStore,
    store=store, metrics=metrics, failpoints=failpoints, err=errors,
    Req=ShuffleRequest, mm_kw={"device": "cpu"})
REF = types.SimpleNamespace(
    name="ref", Engine=jmofserver.DataEngine,
    Resolver=jmofserver.DirIndexResolver, Server=jnet.ShuffleServer,
    Router=jmerger.HostRoutingClient, Local=jmerger.LocalFetchClient,
    MM=jmerger.MergeManager, Writer=JMOFWriter, Config=JConfig,
    Manager=jstore.StoreManager, Health=jstore.BackendHealth,
    Blob=jstore.BlobStore, Local_=jstore.LocalFdStore, store=jstore,
    metrics=jmetrics, failpoints=jfailpoints, err=jerrors,
    Req=jmofserver.ShuffleRequest, mm_kw={})
SIDES = {"port": PORT, "ref": REF}
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    with failpoints.scoped(""), jfailpoints.scoped(""):
        yield
    metrics.reset()


def _fetch_records(engine, side, job, mids, reduce_id=0):
    got = []
    for mid in mids:
        offset, chunks = 0, []
        while True:
            res = engine.fetch(side.Req(job, mid, reduce_id, offset,
                                        1 << 20))
            chunks.append(res.data)
            offset += len(res.data)
            if res.is_last:
                break
        got += list(crack(b"".join(chunks)).iter_records())
    return sorted(got)


def _manager(tmp_path, job, num_maps=3, num_reducers=2, side=PORT, **kw):
    local = os.path.join(str(tmp_path), side.name, "local")
    blob = os.path.join(str(tmp_path), side.name, "blob")
    expected = make_mof_tree(local, job, num_maps, num_reducers, 40,
                             seed=11)
    resolver = side.Resolver(local)
    engine = side.Engine(resolver)
    mgr = side.Manager(resolver, blob, **kw)
    engine.attach_store(mgr)
    return expected, engine, mgr


def _reference_local(root, job, mids, reduce_id=0, conf=None) -> bytes:
    engine = jmofserver.DataEngine(jmofserver.DirIndexResolver(root),
                                   JConfig(conf or {}))
    out = bytearray()
    try:
        jmerger.MergeManager(jmerger.LocalFetchClient(engine), KT,
                             JConfig(conf or {})).run(job, mids, reduce_id,
                                                      out.extend)
    finally:
        engine.stop()
    return bytes(out)


# -- backends ----------------------------------------------------------------

def _local_reads(side, tmp_path):
    p = str(tmp_path / "obj")
    with open(p, "wb") as f:
        f.write(bytes(range(256)) * 64)
    st = side.Local_()
    out = [st.read(p, 100, 1000),
           st.read_ranges(p, [(0, 16), (4096, 256), (16000, 64)])]
    for path, off, n in ((p, 16384 - 10, 100), (str(tmp_path / "no"), 0, 9)):
        try:
            st.read(path, off, n)
        except side.err.StoreError as e:
            out.append((e.cause, e.backend))
    st.close()
    return out


def test_local_store_reads_and_errors_match_the_reference(tmp_path):
    got = _local_reads(PORT, tmp_path)
    assert got == _local_reads(REF, tmp_path)
    assert got[2:] == [("short_read", "local"), ("missing", "local")]


def test_blob_put_and_vectored_reads_match_the_reference(tmp_path):
    src = str(tmp_path / "src")
    payload = np.random.default_rng(3).bytes(3 << 20)
    with open(src, "wb") as f:
        f.write(payload)
    ranges = [(0, 100), (100, 50), (8192, 1024), (1 << 20, 4096)]
    results = {}
    for side in (PORT, REF):
        blob = side.Blob(str(tmp_path / side.name))
        dst = os.path.join(blob.root, "j", "m", "file.out")
        results[side.name] = (blob.put_file(src, dst, key="j/m"),
                              blob.object_crc(dst),
                              blob.read_ranges(dst, ranges))
        blob.close()
    assert results["port"] == results["ref"]
    assert results["port"][2] == [payload[o:o + n] for o, n in ranges]
    assert metrics.get("store.blob.reads") > 0


def test_spill_watermark_resolution_matches_the_reference():
    class Budget:
        host_budget_bytes = 1000

    for conf, budget in (({"uda.tpu.store.spill.watermark.mb": 8}, None),
                         ({}, None),
                         ({"uda.tpu.store.spill.frac": 0.5}, Budget())):
        assert store.spill_watermark_bytes(Config(conf), budget) == \
            jstore.spill_watermark_bytes(JConfig(conf), budget)
    assert store.spill_watermark_bytes(
        Config({"uda.tpu.store.spill.frac": 0.5})) > 0


def test_from_config_needs_a_blob_root(tmp_path):
    resolver = DirIndexResolver(str(tmp_path))
    assert StoreManager.from_config(resolver, Config()) is None
    mgr = StoreManager.from_config(
        resolver, Config({"uda.tpu.store.blob.root": str(tmp_path / "b"),
                          "uda.tpu.store.spill.watermark.mb": 4,
                          "uda.tpu.store.health.threshold": 3}))
    assert mgr.watermark_bytes == 4 << 20 and mgr.health.threshold == 3
    assert str(tmp_path / "b") in resolver.roots
    mgr.close()


# -- migration: the blob files against the reference's ----------------------

def _tree(root, kind, job):
    """The same seeded tree in either package's writer (the writers emit
    the same bytes): plain, zlib-compressed, or coded rs:2:3."""
    rng = np.random.default_rng(29)
    kw = {}
    if kind == "compressed":
        kw["codec"] = jget_codec("zlib")
    elif kind == "striped":
        kw["scheme"] = jparse_scheme("rs:2:3")
    w = JMOFWriter(root, job, **kw)
    for m in range(3):
        parts = [sorted((rng.bytes(8), rng.bytes(int(rng.integers(0, 90))))
                        for _ in range(60)) for _ in range(2)]
        w.write(f"attempt_{job}_m_{m:06d}_0", parts)
    return list(w.map_ids)


@pytest.mark.parametrize("kind", ["plain", "compressed", "striped"])
def test_migrated_files_are_byte_identical_to_the_reference(tmp_path, kind):
    job = "jobMig"
    roots = {}
    for side in (PORT, REF):
        roots[side.name] = os.path.join(str(tmp_path), side.name)
        mids = _tree(os.path.join(roots[side.name], "local"), kind, job)
    entries = {}
    for side in (PORT, REF):
        local = os.path.join(roots[side.name], "local")
        mgr = side.Manager(side.Resolver(local),
                           os.path.join(roots[side.name], "blob"))
        entries[side.name] = [mgr.migrate(job, m, reason="spill",
                                          shadow=(i == 0))
                              for i, m in enumerate(mids)]
        mgr.close()
    for got, want in zip(entries["port"], entries["ref"]):
        for name in ("file.out", "file.out.index"):
            with open(os.path.join(os.path.dirname(got["dst"]), name),
                      "rb") as f, \
                    open(os.path.join(os.path.dirname(want["dst"]), name),
                         "rb") as g:
                assert f.read() == g.read()
        assert {k: v for k, v in got.items() if k not in ("src", "dst")} \
            == {k: v for k, v in want.items() if k not in ("src", "dst")}
        # shadow keeps the local file.out, a cut-over removes the index
        assert os.path.exists(got["src"]) == got["shadow"]
        assert not os.path.exists(got["src"] + ".index")


def test_migration_keeps_bytes_and_zero_copy_for_local_partitions(tmp_path):
    job = "jobP"
    expected, engine, mgr = _manager(tmp_path, job)
    mids = map_ids(job, 3)
    try:
        base = {r: _fetch_records(engine, PORT, job, mids, r)
                for r in range(2)}
        assert base == {r: sorted(expected[r]) for r in range(2)}
        req = ShuffleRequest(job, mids[2], 0, 0, 1 << 20)
        plan = engine.try_plan(req)
        assert plan is not None
        plan.release()
        mgr.migrate(job, mids[0], reason="spill", shadow=True)
        mgr.migrate(job, mids[1], reason="spill", shadow=False)
        for r in range(2):
            assert _fetch_records(engine, PORT, job, mids, r) == base[r]
        # a store-managed partition plans no zero-copy slice; the
        # untouched local one still does
        assert engine.try_plan(
            ShuffleRequest(job, mids[0], 0, 0, 1 << 20)) is None
        plan = engine.try_plan(req)
        assert plan is not None
        plan.release()
        assert not os.path.exists(mgr.migrations()[1]["src"])
        assert metrics.get("store.migrated.bytes") > 0
    finally:
        mgr.close()
        engine.stop()


def test_a_migrated_partition_resolves_to_its_blob_copy(tmp_path):
    """invalidate after the cut-over: the cached partition table of the
    unlinked local file is dropped, the next resolve finds the blob."""
    job = "jobInv"
    _, engine, mgr = _manager(tmp_path, job, num_maps=1, num_reducers=1)
    mid = map_ids(job, 1)[0]
    try:
        before = engine.resolver.resolve(job, mid, 0)
        assert engine.resolver.resolve_cached(job, mid, 0) is not None
        mgr.migrate(job, mid, reason="spill", shadow=False)
        assert engine.resolver.resolve_cached(job, mid, 0) is None
        after = engine.resolver.resolve(job, mid, 0)
        assert after.path.startswith(mgr.blob_root + os.sep)
        assert (after.start_offset, after.part_length) == \
            (before.start_offset, before.part_length)
        engine.resolver.invalidate("other_job")  # touches nothing else
        assert engine.resolver.resolve_cached(job, mid, 0) == after
    finally:
        mgr.close()
        engine.stop()


def test_a_compressed_job_merges_alike_after_migration(tmp_path):
    job = "jobC"
    local = os.path.join(str(tmp_path), "local")
    blob = os.path.join(str(tmp_path), "blob")
    rng = np.random.default_rng(29)
    writer = MOFWriter(local, job, codec=get_codec("zlib"))
    for m in range(4):
        recs = sorted((rng.bytes(8), rng.bytes(64)) for _ in range(80))
        writer.write(f"attempt_{job}_m_{m:06d}_0", [recs])
    want = bytearray()
    engine = jmofserver.DataEngine(jmofserver.DirIndexResolver(local))
    jmerger.MergeManager(JDecompressingClient(
        jmerger.LocalFetchClient(engine), jget_codec("zlib")), KT,
        JConfig()).run(job, writer.map_ids, 0, want.extend)
    engine.stop()
    resolver = DirIndexResolver(local)
    mgr = StoreManager(resolver, blob)
    for mid in writer.map_ids:
        mgr.migrate(job, mid, reason="spill", shadow=False)
    engine = DataEngine(resolver)
    engine.attach_store(mgr)
    got = bytearray()
    try:
        merger.MergeManager(DecompressingClient(
            merger.LocalFetchClient(engine), get_codec("zlib")), KT,
            Config(), device="cpu").run(job, writer.map_ids, 0,
                                        got.extend)
    finally:
        mgr.close()
        engine.stop()
    assert bytes(got) == bytes(want) and got
    assert metrics.get("store.read.bytes", backend="blob") > 0


# -- the spill ladder --------------------------------------------------------

def _spill_run(side, root):
    job = "jobL"
    local = os.path.join(root, side.name, "local")
    resolver = side.Resolver(local)
    mgr = side.Manager(resolver, os.path.join(root, side.name, "blob"),
                       watermark_bytes=16 << 10)
    writer = side.Writer(local, job, store=mgr)
    rng = np.random.default_rng(7)
    peak = 0
    for m in range(12):
        recs = sorted((rng.bytes(8), rng.bytes(512)) for _ in range(16))
        writer.write(f"attempt_{job}_m_{m:06d}_0", [recs])
        peak = max(peak, mgr.retained_bytes())
    engine = side.Engine(resolver)
    engine.attach_store(mgr)
    try:
        records = _fetch_records(engine, side, job, writer.map_ids)
    finally:
        engine.stop()
    moved = [(e["map"], e["bytes"], e["crc"], e["reason"])
             for e in mgr.migrations()]
    out = (moved, mgr.retained_bytes(), peak, records)
    mgr.close()
    return out, mgr.watermark_bytes


def test_the_spill_ladder_matches_the_reference(tmp_path):
    (moved, retained, peak, records), mark = _spill_run(PORT, str(tmp_path))
    assert (moved, retained, peak, records) == \
        _spill_run(REF, str(tmp_path))[0]
    assert moved and retained <= mark
    assert [m for m, *_ in moved] == sorted(m for m, *_ in moved)
    assert metrics.get("store.spilled.bytes") == sum(b for _, b, *_ in moved)
    assert metrics.get_gauge("store.local.retained.bytes") == retained


def test_a_failed_spill_keeps_the_partition_servable(tmp_path):
    job = "jobFS"
    expected, engine, mgr = _manager(tmp_path, job, num_maps=1,
                                     num_reducers=1)
    mid = map_ids(job, 1)[0]
    try:
        with failpoints.scoped("store.put=error"):
            with pytest.raises(StorageError):
                mgr.migrate(job, mid, reason="spill")
        with failpoints.scoped("store.migrate=error"):
            with pytest.raises(StoreError):
                mgr.migrate(job, mid, reason="spill")
        assert metrics.get_gauge("store.migrate.bytes.on_air") == 0
        assert _fetch_records(engine, PORT, job, [mid]) == \
            sorted(expected[0])
        assert mgr.migrations() == []
    finally:
        mgr.close()
        engine.stop()


# -- degraded-backend failover ----------------------------------------------

@pytest.mark.parametrize("side", ["port", "ref"])
def test_a_killed_blob_tier_fails_over_byte_identically(tmp_path, side):
    s = SIDES[side]
    job = "jobFO"
    _, engine, mgr = _manager(tmp_path, job, side=s)
    mids = map_ids(job, 3)
    try:
        base = {r: _fetch_records(engine, s, job, mids, r)
                for r in range(2)}
        for mid in mids:
            mgr.migrate(job, mid, reason="spill", shadow=True)
        with s.failpoints.scoped("store.get=error::match:blob"):
            got = {r: _fetch_records(engine, s, job, mids, r)
                   for r in range(2)}
        assert got == base
        assert s.metrics.get("store.failover") > 0
        assert s.metrics.get("store.errors", backend="blob") > 0
    finally:
        mgr.close()
        engine.stop()


def test_the_batch_plane_fails_over_per_request(tmp_path):
    job = "jobFB"
    expected, engine, mgr = _manager(tmp_path, job, num_reducers=1)
    mids = map_ids(job, 3)
    try:
        for mid in mids:
            mgr.migrate(job, mid, reason="spill", shadow=True)
        with failpoints.scoped("store.get=error::match:blob"):
            futs = engine.submit_batch(
                [ShuffleRequest(job, m, 0, 0, 1 << 20) for m in mids])
            datas = [f.result() for f in futs]
        got = sorted(sum((list(crack(d.data).iter_records())
                          for d in datas), []))
        assert got == sorted(expected[0])
        assert metrics.get("store.failover") > 0
    finally:
        mgr.close()
        engine.stop()


@pytest.mark.parametrize("side", ["port", "ref"])
def test_no_twin_surfaces_a_typed_store_error(tmp_path, side):
    s = SIDES[side]
    job = "jobNT"
    _, engine, mgr = _manager(tmp_path, job, num_maps=1, num_reducers=1,
                              side=s)
    mid = map_ids(job, 1)[0]
    try:
        mgr.migrate(job, mid, reason="spill", shadow=False)
        with s.failpoints.scoped("store.get=error::match:blob"):
            with pytest.raises(s.err.StoreError) as ei:
                engine.fetch(s.Req(job, mid, 0, 0, 1 << 20))
        assert (ei.value.cause, ei.value.backend) == ("get", "blob")
    finally:
        mgr.close()
        engine.stop()


def test_a_boxed_tier_is_rerouted_proactively(tmp_path):
    job = "jobRR"
    _, engine, mgr = _manager(tmp_path, job, num_maps=1, num_reducers=1,
                              health=BackendHealth(threshold=2,
                                                   penalty_s=30.0))
    mid = map_ids(job, 1)[0]
    try:
        mgr.migrate(job, mid, reason="spill", shadow=True)
        with failpoints.scoped("store.get=error::match:blob"):
            engine.fetch(ShuffleRequest(job, mid, 0, 0, 1 << 20))
            engine.fetch(ShuffleRequest(job, mid, 0, 0, 1 << 20))
        assert mgr.health.boxed("blob")
        r0 = metrics.get("store.rerouted")
        engine.fetch(ShuffleRequest(job, mid, 0, 0, 1 << 20))
        assert metrics.get("store.rerouted") > r0
    finally:
        mgr.close()
        engine.stop()


def _health_walk(side, monkeypatch):
    now = [50.0]
    monkeypatch.setattr(side.store.time, "monotonic", lambda: now[0])
    h = side.Health(threshold=2, penalty_s=0.05)
    out = [h.punish("blob"), h.punish("blob"), h.boxed("blob")]
    now[0] += 0.08
    out += [h.boxed("blob"), h.punish("blob"), h.snapshot()]
    h.forgive("blob")
    h.forgive("blob")
    out += [h.boxed("blob"), h.faults("blob")]
    return out


def test_backend_health_boxes_and_paroles_like_the_reference(monkeypatch):
    got = _health_walk(PORT, monkeypatch)
    assert got == _health_walk(REF, monkeypatch)
    assert got[:5] == [False, True, True, False, True]
    assert got[-2:] == [False, 0]


def test_store_faults_feed_the_recovery_ledger(tmp_path):
    ledger = RecoveryLedger(PenaltyBox())
    job = "jobRL"
    _, engine, mgr = _manager(tmp_path, job, num_maps=1, num_reducers=1,
                              recovery=ledger)
    mid = map_ids(job, 1)[0]
    try:
        mgr.migrate(job, mid, reason="spill", shadow=True)
        with failpoints.scoped("store.get=error::match:blob"):
            engine.fetch(ShuffleRequest(job, mid, 0, 0, 1 << 20))
        events = ledger.snapshot()["events"]
        assert [e["kind"] for e in events] == ["store"]
        assert events[0]["supplier"] == "blob"
    finally:
        mgr.close()
        engine.stop()


# -- resume revalidation -----------------------------------------------------

def test_validate_spilled_detects_damage(tmp_path):
    job = "jobVS"
    _, engine, mgr = _manager(tmp_path, job, num_maps=2, num_reducers=1)
    try:
        for mid in map_ids(job, 2):
            mgr.migrate(job, mid, reason="spill", shadow=False)
        assert mgr.validate_spilled(job) == 2
        assert mgr.validate_spilled("other") == 0
        dst = mgr.migrations()[0]["dst"]
        with open(dst, "r+b") as f:
            f.write(b"\xff\xff\xff\xff")
        with pytest.raises(StoreError) as ei:
            mgr.validate_spilled(job)
        assert (ei.value.cause, ei.value.backend) == ("crc", "blob")
        os.unlink(dst)
        with pytest.raises(StoreError) as ei:
            mgr.validate_spilled(job)
        assert ei.value.cause == "missing"
    finally:
        mgr.close()
        engine.stop()


def test_a_checkpoint_resume_revalidates_spilled_partitions(tmp_path):
    """Attempt 1 checkpoints and dies; three partitions spill while the
    task is down; attempt 2 revalidates them before trusting the manifest
    and emits the reference's stream; a damaged spilled object then makes
    the next resume fail typed."""
    job = "jobCK"
    local = os.path.join(str(tmp_path), "mof")
    blob = os.path.join(str(tmp_path), "blob")
    make_mof_tree(local, job, 6, 1, 100, seed=5)
    ckdir = os.path.join(str(tmp_path), "ck")
    mids = map_ids(job, 6)
    conf = {"uda.tpu.online.streaming": True, "uda.tpu.ckpt.dir": ckdir,
            "uda.tpu.ckpt.interval.s": 0.0}
    want = _reference_local(local, job, mids)

    def run(mgr, fault=""):
        cfg = Config(dict(conf, **({"uda.tpu.fetch.retries": 0}
                                   if fault else {})))
        engine = DataEngine(DirIndexResolver(local), cfg)
        if mgr is not None:
            engine.attach_store(mgr)
            engine.resolver.roots = list(mgr.resolver.roots)
        mm = merger.MergeManager(merger.LocalFetchClient(engine), KT, cfg,
                                 device="cpu")
        out = bytearray()
        try:
            with failpoints.scoped(fault):
                mm.run(job, mids, 0, out.extend)
            return bytes(out), None
        except FallbackSignal as e:
            return bytes(out), e
        finally:
            engine.stop()

    _, err1 = run(None, "segment.fetch=error:match:m_000005")
    assert isinstance(err1, FallbackSignal)
    spill = StoreManager(DirIndexResolver(local), blob)
    for mid in mids[:3]:
        spill.migrate(job, mid, reason="spill", shadow=False)
    out, err2 = run(spill)
    assert err2 is None and out == want
    assert metrics.get("store.revalidated") == 3
    _, err3 = run(spill, "segment.fetch=error:match:m_000004")
    assert isinstance(err3, FallbackSignal)
    with open(spill.migrations()[0]["dst"], "r+b") as f:
        f.write(b"\x00" * 8)
    _, err4 = run(spill)
    assert isinstance(err4, FallbackSignal)
    assert isinstance(err4.cause, StoreError) and err4.cause.cause == "crc"
    spill.close()


# -- the drain and the wire --------------------------------------------------

@pytest.mark.parametrize("side", ["port", "ref"])
def test_announce_drain_migrates_and_the_partitions_stay_fetchable(
        tmp_path, side):
    s = SIDES[side]
    job = "jobDR"
    local = os.path.join(str(tmp_path), "local")
    resolver = s.Resolver(local)
    mgr = s.Manager(resolver, os.path.join(str(tmp_path), "blob"))
    writer = s.Writer(local, job, store=mgr)
    rng = np.random.default_rng(13)
    expected = []
    for m in range(3):
        recs = sorted((rng.bytes(8), rng.bytes(32)) for _ in range(50))
        writer.write(f"attempt_{job}_m_{m:06d}_0", [recs])
        expected += recs
    engine = s.Engine(resolver)
    engine.attach_store(mgr)
    server = s.Server(engine, s.Config(), host="127.0.0.1", port=0).start()
    try:
        moved = server.announce_drain(store=mgr, job_id=job)
        assert [e["reason"] for e in moved] == ["drain"] * 3
        assert server.announce_drain(store=mgr) == []
        assert mgr.retained_bytes() == 0
        assert all(not os.path.exists(e["src"]) and
                   os.path.exists(e["dst"]) for e in moved)
        assert _fetch_records(engine, s, job, writer.map_ids) == \
            sorted(expected)
        assert s.metrics.get("store.drained.partitions") == 3
        assert s.metrics.get("elastic.drains") == 1
    finally:
        server.stop()
        mgr.close()
        engine.stop()


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_a_store_spilled_reduce_over_the_wire_matches_the_reference(
        tmp_path, pair):
    """The served tree was written through MOFWriter(store=) with a
    watermark of a tenth of one map, so most maps spilled as they were
    written; the server's engine routes them through the store (copy
    path) and the remote reduce emits the reference's stream."""
    srv, cli = SIDES[pair[0]], SIDES[pair[1]]
    job = "jobW"
    local = os.path.join(str(tmp_path), "local")
    want_root = os.path.join(str(tmp_path), "plain")
    mids = text_maps(want_root, job)
    resolver = srv.Resolver(local)
    mgr = srv.Manager(resolver, os.path.join(str(tmp_path), "blob"),
                      watermark_bytes=1 << 10)
    mids = text_maps(local, job, writer=srv.Writer, store=mgr)
    want = _reference_local(want_root, job, mids, 1,
                            {"mapred.rdma.buf.size": 1})
    conf = {"mapred.rdma.buf.size": 1}
    engine = srv.Engine(resolver, srv.Config(conf))
    engine.attach_store(mgr)
    server = srv.Server(engine, srv.Config(conf), host="127.0.0.1",
                        port=0).start()
    router = cli.Router(config=cli.Config(conf))
    out = bytearray()
    try:
        cli.MM(router, KT, cli.Config(conf), **cli.mm_kw).run(
            job, [(f"127.0.0.1:{server.port}", m) for m in mids], 1,
            out.extend)
    finally:
        router.stop()
        server.stop()
        mgr.close()
        engine.stop()
    assert bytes(out) == want and out
    assert len(mgr.migrations()) >= len(mids) - 1
    assert srv.metrics.get("store.read.bytes", backend="blob") > 0
    assert srv.metrics.get("net.serve.copy") > 0


def text_maps(root, job, writer=JMOFWriter, store=None, maps=4):
    """Four two-partition maps of random keys and values of 0 to 300
    bytes through ``writer`` (with ``store`` as its spill seam)."""
    rng = np.random.default_rng(41)
    w = writer(root, job, store=store) if store is not None \
        else writer(root, job)
    for m in range(maps):
        w.write(f"attempt_{job}_m_{m:06d}_0",
                [sorted((rng.bytes(10), rng.bytes(int(rng.integers(0, 300))))
                        for _ in range(80)) for _ in range(2)])
    return list(w.map_ids)


# -- membership --------------------------------------------------------------

class _Stub:
    def __init__(self, host, log):
        self.host = host
        self.log = log

    def start_fetch(self, req, cb):
        cb(StorageError("stub"))

    def resume_ok(self, host=""):
        return True

    def generation(self, host=""):
        return None

    def peer_draining(self, host=""):
        return self.host == "D"

    def stop(self):
        self.log.append(("stop", self.host))


def _membership(side):
    log = []
    router = side.Router(connect=lambda h: (log.append(("dial", h)),
                                            _Stub(h, log))[1])
    router._client_for("A")
    router._client_for("D")
    router.notify_join("B")
    router.notify_join("B")
    out = [router.members(), router.is_draining("D")]
    router.refresh("A")
    router._client_for("A")
    router.notify_drain("B")
    out += [router.members(), router.is_draining("B"),
            router.is_draining("A"), side.metrics.get("elastic.joins")]
    router.stop()
    return out, log


def test_host_routing_membership_matches_the_reference():
    got = _membership(PORT)
    assert got == _membership(REF)
    assert got[0] == [["B"], True, [], True, False, 1]


def test_segment_add_host_widens_candidates():
    seg = merger.Segment(None, "j", "m1", 0, 1 << 20, host="A", hosts=["A"])
    assert seg.add_host("B")
    assert not seg.add_host("B")
    assert not seg.add_host("")
    assert seg.hosts == ["A", "B"]
    seg._done.set()
    assert not seg.add_host("C")


def test_a_mid_job_join_rescues_a_failing_fetch(tmp_path):
    """The primary lacks one map's output; the supplier holding it joins
    once the first fetch of that map has failed, and the retry ladder's
    re-rank elects the joiner."""
    job = "jobJN"
    root_a = os.path.join(str(tmp_path), "A")
    root_b = os.path.join(str(tmp_path), "B")
    expected = make_mof_tree(root_a, job, 3, 1, 30, seed=17)
    missing = map_ids(job, 3)[2]
    os.makedirs(os.path.join(root_b, job))
    shutil.move(os.path.join(root_a, job, missing),
                os.path.join(root_b, job, missing))
    engines = {"A": DataEngine(DirIndexResolver(root_a)),
               "B": DataEngine(DirIndexResolver(root_b))}
    failed = threading.Event()

    class Watched(merger.LocalFetchClient):
        def start_fetch(self, req, on_complete):
            def done(res):
                on_complete(res)
                if isinstance(res, Exception) and req.map_id == missing:
                    failed.set()
            super().start_fetch(req, done)

    router = merger.HostRoutingClient(
        connect=lambda host: Watched(engines[host]))
    cfg = Config({"uda.tpu.fetch.retries": 30,
                  "mapred.rdma.fetch.retry.backoff.ms": 40.0,
                  "mapred.rdma.fetch.retry.backoff.max.ms": 80.0})
    mm = merger.MergeManager(router, KT, cfg, device="cpu")
    joined = []
    joiner = threading.Thread(
        target=lambda: failed.wait(30) and joined.append(
            mm.notify_join("B")), daemon=True)
    joiner.start()
    try:
        segs = mm.fetch_all(job, [("A", m) for m in map_ids(job, 3)], 0)
        got = sorted(sum((list(b.iter_records())
                          for s in segs for b in s.batches), []))
        assert got == sorted(expected[0])
        rescued = [s for s in segs if s.map_id == missing][0]
        assert rescued.host == "B" and "B" in rescued.hosts
        joiner.join(10)
        # the segments still in flight at the join: at least the
        # failing one
        assert len(joined) == 1 and 1 <= joined[0] <= 3
        assert [e["kind"] for e in mm.ledger.events("join")] == ["join"]
    finally:
        mm.stop()
        for e in engines.values():
            e.stop()


def test_writer_add_supplier_root_joins_placement():
    w = MOFWriter("/nonexistent", "j", supplier_roots=["/r/a", "/r/b"])
    w.add_supplier_root("/r/c", domain="rack2")
    w.add_supplier_root("/r/c")
    assert w.supplier_roots == ["/r/a", "/r/b", "/r/c"]
    assert w.domains["/r/c"] == "rack2"
    w.add_supplier_root("/r/d", supplier_index=1)
    assert w.supplier_index == 1


def test_merge_manager_notify_drain_records_the_ledger(tmp_path):
    engine = DataEngine(DirIndexResolver(str(tmp_path)))
    router = merger.HostRoutingClient(
        connect=lambda host: merger.LocalFetchClient(engine))
    mm = merger.MergeManager(router, KT, Config(), device="cpu")
    try:
        mm.notify_drain("hostX")
        assert router.is_draining("hostX")
        assert [e["kind"] for e in mm.ledger.events()] == ["drain"]
    finally:
        mm.stop()
        engine.stop()
