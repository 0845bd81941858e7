"""The port's resource ledger (``uda_tpu_torch.utils.resledger``) against
the JAX package's ``uda_tpu.utils.resledger``: the same seeded
acquire/settle/drain sequences leave the same outstanding books and give
the same leak reports, paired gauges open and settle obligations through
the metrics hub, and every re-armed site of the port (pool leases, fd
pins, store handles, admission charges, scoped failpoints) settles on its
success path and is reported when it leaks."""

import numpy as np
import pytest

from helpers import make_mof_tree, map_ids
from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu.utils import metrics as jmetrics_mod
from uda_tpu.utils import resledger as jled
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.mofserver import ShuffleRequest
from uda_tpu_torch.mofserver.store import LocalFdStore
from uda_tpu_torch.ops.merge import RowBufferPool
from uda_tpu_torch.utils import metrics as tmetrics_mod
from uda_tpu_torch.utils import resledger as tled
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics

PAIRS = ("pool.lease", "engine.fd", "tenant.admit", "store.fd",
         "ctx.failpoints.scoped", "gauge.fetch.on_air")


def _sequence(seed: int, n: int = 60) -> list:
    """A seeded op list: unit acquires/settles, amount acquires/settles
    (some settling before their acquire: the deficit path) and drains,
    over a few pairs, owners and keys."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        pair = PAIRS[int(rng.integers(len(PAIRS)))]
        owner = int(rng.integers(2))
        key = f"k{int(rng.integers(3))}"
        r = rng.random()
        if r < 0.40:
            amt = None if pair in PAIRS[:2] else float(rng.integers(1, 9))
            ops.append(("acquire", pair, key, amt, owner))
        elif r < 0.80:
            amt = None if pair in PAIRS[:2] else float(rng.integers(1, 9))
            ops.append(("settle", pair, key, amt, owner))
        elif r < 0.90:
            ops.append(("drain", pair, None, None, owner))
        else:
            ops.append(("drain_all", None, None, None, None))
    return ops


def _run(mod, ops):
    led = mod.ResourceLedger(enabled=True)
    drains = []
    for op, pair, key, amt, owner in ops:
        if op == "acquire":
            led.acquire(pair, key=key, amount=1 if amt is None else amt,
                        owner=owner, detail=f"d-{pair}")
        elif op == "settle":
            led.settle(pair, key=key, amount=amt, owner=owner)
        elif op == "drain":
            reps = led.drain(f"point.{pair}", pairs=(pair,), owner=owner)
            drains.append([{k: v for k, v in r.items() if k != "stack"}
                           for r in reps])
        else:
            reps = led.drain("point.all")
            drains.append([{k: v for k, v in r.items() if k != "stack"}
                           for r in reps])
    books = [{k: v for k, v in r.items() if k != "stack"}
             for r in led.outstanding()]
    return books, drains, dict(led._deficits)


@pytest.mark.parametrize("seed", range(8))
def test_same_sequence_same_books(seed):
    ops = _sequence(seed)
    ref = _run(jled, ops)
    port = _run(tled, ops)
    assert port == ref


def test_paired_gauge_inventory_matches_reference():
    assert tled.PAIRED_GAUGES == jled.PAIRED_GAUGES


@pytest.mark.parametrize("seed", range(4))
def test_paired_gauges_flow_through_the_ledger(seed):
    """A private hub over a private ledger: paired-gauge deltas open and
    settle obligations (oldest first); labelled and unpaired gauges stay
    out of the books; the outstanding set matches the reference's."""
    rng = np.random.default_rng(100 + seed)
    names = list(jled.PAIRED_GAUGES)[:4] + ["net.server.inflight"]
    deltas = [(names[int(rng.integers(len(names)))],
               float(rng.integers(-3, 6))) for _ in range(40)]
    out = []
    for mmod, lmod in ((jmetrics_mod, jled), (tmetrics_mod, tled)):
        led = lmod.ResourceLedger(enabled=True)
        hub = mmod.Metrics(stats=False, ledger=led)
        for name, d in deltas:
            hub.gauge_add(name, d)
            hub.gauge_add(name, d, tenant="t1")  # labelled: not ledgered
        out.append(([(r["pair"], r["key"], r["amount"])
                     for r in led.outstanding()], dict(led._deficits),
                    hub.gauges_snapshot()))
    assert out[0] == out[1]


def test_off_is_one_check(monkeypatch):
    monkeypatch.delenv("UDA_TPU_RESLEDGER", raising=False)
    for mod in (jled, tled):
        led = mod.ResourceLedger()
        assert not led.enabled
        led.acquire("pool.lease", key=1)
        assert led.outstanding() == [] and led.drain("x") == []
        monkeypatch.setenv("UDA_TPU_RESLEDGER", "yes")
        assert mod.ResourceLedger().enabled
        monkeypatch.delenv("UDA_TPU_RESLEDGER")


def test_global_leak_counts_dumps_and_appends(tmp_path, monkeypatch):
    """A leak on the process-wide books counts resledger.leaks, dumps the
    flight recorder (cause resledger_leak) and appends JSON lines."""
    import json

    from uda_tpu_torch.utils.flightrec import flightrec

    out = tmp_path / "leaks.jsonl"
    monkeypatch.setenv("UDA_TPU_RESLEDGER_JSON", str(out))
    monkeypatch.setattr(tled.resledger, "enabled", True)
    tled.resledger.acquire("pool.lease", key=7, owner="o", amount=64)
    reps = tled.resledger.drain("test.point")
    assert [(r["pair"], r["key"], r["amount"]) for r in reps] == [
        ("pool.lease", "7", 64.0)]
    assert metrics.get("resledger.leaks") == 1
    assert flightrec.reports[-1]["cause"] == "resledger_leak"
    assert flightrec.reports[-1]["extra"]["pairs"] == ["pool.lease"]
    assert json.loads(out.read_text())["point"] == "test.point"


@pytest.fixture
def armed(monkeypatch):
    """The port's process-wide ledger armed for one test."""
    monkeypatch.setattr(tled.resledger, "enabled", True)
    yield tled.resledger
    tled.resledger.reset()


def test_pool_leases_settle_and_leak(armed):
    pool = RowBufferPool(device="cpu")
    a = pool.lease(8, 4)
    b = pool.lease(16, 4)
    assert {(r["pair"], r["amount"]) for r in armed.outstanding(
        owner=id(pool))} == {("pool.lease", 128.0), ("pool.lease", 256.0)}
    pool.release(a)
    pool.release(b)
    c = pool.lease(4, 4)  # served from the free list, a fresh obligation
    assert len(armed.outstanding(owner=id(pool))) == 1
    pool.release(c[1:3])  # a view walks back to the leased buffer
    assert armed.drain("pool.done", owner=id(pool)) == []
    pool.lease(2, 2)
    leaked = armed.drain("pool.done", pairs=("pool.lease",),
                         owner=id(pool))
    assert len(leaked) == 1 and leaked[0]["amount"] == 16.0


def test_engine_fd_pins_and_admission(tmp_path, armed):
    """A served chunk settles its fd pin and its admission; an FdSlice
    whose release() never runs is reported at the engine's stop, under
    its path; a tenant's charge is ledgered while in flight."""
    make_mof_tree(str(tmp_path), "jobL", 2, 1, 50, seed=3)
    eng = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    mid = map_ids("jobL", 2)
    res = eng.fetch(ShuffleRequest("jobL", mid[0], 0, 0, 1 << 20))
    assert res.data
    sl = eng.try_plan(ShuffleRequest("jobL", mid[1], 0, 0, 1 << 20,
                                     tenant="t9")) \
        or eng.submit_serve(ShuffleRequest("jobL", mid[1], 0, 0, 1 << 20,
                                           tenant="t9")).result(10)
    pairs = sorted(r["pair"] for r in armed.outstanding())
    assert pairs == ["engine.fd", "gauge.read.bytes",
                     "gauge.tenant.read.bytes", "tenant.admit"]
    sl.release()
    assert armed.outstanding(pairs=("engine.fd", "tenant.admit")) == []
    leak = eng.submit_serve(ShuffleRequest("jobL", mid[1], 0, 0,
                                           1 << 20)).result(10)
    eng.stop()
    reps = armed.leak_reports
    assert [r["pair"] for r in reps] == ["engine.fd"]
    assert reps[0]["key"] == repr(leak.path)
    leak._released = True  # the engine is gone; nothing left to settle
    eng._unadmit(leak._admitted, "")


def test_store_handles(tmp_path, armed):
    p = tmp_path / "obj"
    p.write_bytes(b"x" * 100)
    st = LocalFdStore()
    assert st.read(str(p), 10, 20) == b"x" * 20
    assert st.close() is None and armed.leak_reports == []
    fd = st.acquire_fd(str(p))
    st.close()
    assert [r["pair"] for r in armed.leak_reports] == ["store.fd"]
    import os
    os.close(fd)


def test_scoped_failpoints_are_obligations(armed):
    with failpoints.scoped("segment.fetch=delay:1"):
        open_ = armed.outstanding(pairs=("ctx.failpoints.scoped",))
        assert [r["key"] for r in open_] == ["segment.fetch=delay:1"]
    assert armed.outstanding(pairs=("ctx.failpoints.scoped",)) == []
