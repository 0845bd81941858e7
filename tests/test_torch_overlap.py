"""The port's overlapped merger (uda_tpu_torch.merger.overlap) against the
JAX package's (uda_tpu.merger.overlap) on the same RecordBatches: fed in a
seeded shuffled order from one or three threads, ``finish`` must give the
same records and ``emit_stream`` the same framed bytes. The reference runs
its CPU engine, "host"; the port runs "host" and "pallas", which on a CPU
tensor is K1's plain version. Tolerance 0: the composite key (words, len,
segment, row) is a total order, so neither engine nor feeding order
decides anything. Also the budget, abort and error paths: no staging
thread left alive, no in-flight byte charged, no buffer lease held."""

import io
import random
import threading
import time

import numpy as np
import pytest
import torch

from uda_tpu.merger.emitter import FramedEmitter as JFramedEmitter
from uda_tpu.merger.overlap import OverlappedMerger as JOverlappedMerger
from uda_tpu.ops import merge as jmerge
from uda_tpu.utils import comparators as jcmp
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.budget import stage_inflight_cap as j_inflight_cap
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.ifile import crack, write_records
from uda_tpu_torch.merger import overlap as toverlap
from uda_tpu_torch.merger import streaming as tstream
from uda_tpu_torch.merger.emitter import FramedEmitter, frame_batch
from uda_tpu_torch.merger.overlap import OverlappedMerger
from uda_tpu_torch.ops import merge as tmerge
from uda_tpu_torch.utils import comparators as tcmp
from uda_tpu_torch.utils.budget import (STAGE_INFLIGHT_FLOOR_MB,
                                        stage_inflight_cap)
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import MergeError
from uda_tpu_torch.utils.ifile import RecordBatch
from uda_tpu_torch.utils.metrics import metrics

KT = "uda.tpu.RawBytes"
BLOCK = 1 << 12


def _recs(seed, n, dup_every=5, key_bytes=6):
    rng = np.random.default_rng(seed)
    return [(rng.bytes(key_bytes) if i % dup_every else b"dupkey",
             rng.bytes(20)) for i in range(n)]


def _pair(recs_list):
    """The same segments as reference and port RecordBatches."""
    ref = [crack(write_records(r)) for r in recs_list]
    port = [RecordBatch(b.data.copy(), b.key_off.copy(), b.key_len.copy(),
                        b.val_off.copy(), b.val_len.copy()) for b in ref]
    return ref, port


def _segments(seed=0, k=7):
    return _pair([_recs(seed + s, 40 + 11 * s) for s in range(k)])


def _feed(om, batches, seed, feeders):
    """Feed every batch in a seeded shuffled order, from ``feeders``
    threads at once."""
    order = list(range(len(batches)))
    random.Random(seed).shuffle(order)
    parts = [order[i::feeders] for i in range(feeders)]
    threads = [threading.Thread(target=lambda p=p: [om.feed(i, batches[i])
                                                    for i in p])
               for p in parts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def _reference(batches, seed=1, feeders=1, **kw):
    """(finish records, emit_stream bytes) of the reference, host engine."""
    kt = jcmp.get_key_type(KT)
    om = JOverlappedMerger(kt, 16, engine="host", **kw)
    _feed(om, batches, seed, feeders)
    rec = list(om.finish(batches).iter_records())
    om = JOverlappedMerger(kt, 16, engine="host", **kw)
    _feed(om, batches, seed, feeders)
    out = io.BytesIO()
    n = om.emit_stream(batches, JFramedEmitter(BLOCK),
                       lambda b: out.write(bytes(b)))
    assert n == len(out.getvalue())
    return rec, out.getvalue()


def _port(batches, seed=1, feeders=1, **kw):
    """(finish records, emit_stream bytes, finished merger) of the port."""
    kt = tcmp.get_key_type(KT)
    om = OverlappedMerger(kt, 16, device="cpu", **kw)
    _feed(om, batches, seed, feeders)
    got = om.finish(batches)
    rec = list(got.iter_records())
    assert frame_batch(got) == write_records(rec)
    om = OverlappedMerger(kt, 16, device="cpu", **kw)
    _feed(om, batches, seed, feeders)
    out = io.BytesIO()
    n = om.emit_stream(batches, FramedEmitter(BLOCK),
                       lambda b: out.write(bytes(b)))
    assert n == len(out.getvalue())
    return rec, out.getvalue(), om


def _assert_idle(om):
    """Nothing of the merger is left: threads stopped, no in-flight bytes
    charged, no buffer lease held."""
    for t in om._threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert om.stats["inflight_bytes"] == 0
    assert metrics.get_gauge("stage.inflight.bytes") == 0
    if om._buf_pool is not None:
        assert om._buf_pool.leased == 0


@pytest.mark.parametrize("feeders", [1, 3])
@pytest.mark.parametrize("engine", ["host", "pallas"])
@pytest.mark.parametrize("pipeline,stagers", [(False, 1), (False, 3),
                                              (True, 1), (True, 3)])
def test_finish_and_emit_match_reference(pipeline, stagers, engine,
                                         feeders):
    ref, port = _segments(seed=len(engine) + stagers)
    kw = dict(pipeline=pipeline, stagers=stagers, inflight_bytes=8 << 20)
    want = _reference(ref, seed=stagers, feeders=feeders, **kw)
    rec, framed, om = _port(port, seed=stagers, feeders=feeders,
                            engine=engine, **kw)
    assert rec == want[0] and framed == want[1]
    assert len(rec) == sum(b.num_records for b in port)
    assert om.stats["device_merges"] == len(port) - 1
    assert om.stats["staged_runs"] == len(port)
    assert om.engine == engine and om.stats["pipeline"] == pipeline
    _assert_idle(om)


@pytest.mark.parametrize("engine", ["host", "pallas"])
@pytest.mark.parametrize("layout", ["empty_first", "all_empty", "none",
                                    "one", "empties_between"])
def test_empty_segments_match_reference(layout, engine):
    empty = []
    recs = {"empty_first": [empty, _recs(9, 17)],
            "all_empty": [empty, empty, empty],
            "none": [],
            "one": [_recs(10, 23)],
            "empties_between": [_recs(11, 5), empty, _recs(12, 600), empty,
                                _recs(13, 1)]}[layout]
    ref, port = _pair(recs)
    for pipeline in (False, True):
        want = _reference(ref, pipeline=pipeline)
        rec, framed, om = _port(port, engine=engine, pipeline=pipeline)
        assert (rec, framed) == want
        _assert_idle(om)


@pytest.mark.parametrize("engine", ["host", "pallas"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_keys_past_the_width_resort_like_the_reference(pipeline, engine):
    """Keys wider than the carried width with shared prefixes across
    segments: the forest is abandoned for the global re-sort, in both."""
    pre = b"Q" * 17
    ref, port = _pair([[(pre + b"z", b"v0"), (b"a", b"v1")],
                       [(pre + b"b", b"v2"), (b"c", b"v3")],
                       _recs(5, 30)])
    want = _reference(ref, pipeline=pipeline)
    rec, framed, om = _port(port, engine=engine, pipeline=pipeline)
    assert (rec, framed) == want
    assert om.stats["overflow"]
    _assert_idle(om)


def test_backpressure_bounds_inflight_and_returns_to_zero(monkeypatch):
    """An in-flight cap of about two segments under a slow consumer:
    feed() blocks (stage.backpressure_events), the charged bytes never
    pass the cap and the gauge ends at 0; the output is unchanged."""
    ref, port = _pair([_recs(s, 150) for s in range(8)])
    one = OverlappedMerger._source_bytes(port[0])
    cap = int(2.5 * one)
    real_insert = OverlappedMerger._insert

    def slow_insert(self, run):
        time.sleep(0.05)
        real_insert(self, run)

    monkeypatch.setattr(OverlappedMerger, "_insert", slow_insert)
    om = OverlappedMerger(tcmp.get_key_type(KT), 16, engine="pallas",
                          pipeline=True, stagers=2, inflight_bytes=cap,
                          device="cpu")
    peak = {"v": 0}
    done = threading.Event()

    def watch():
        while not done.is_set():
            peak["v"] = max(peak["v"], om._inflight)
            time.sleep(0.002)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    before = metrics.get("stage.backpressure_events")
    for i, b in enumerate(port):
        om.feed(i, b)
    got = list(om.finish(port).iter_records())
    done.set()
    watcher.join(timeout=5)
    assert 0 < peak["v"] <= cap
    assert metrics.get("stage.backpressure_events") > before
    assert got == _reference(ref, pipeline=True)[0]
    _assert_idle(om)


@pytest.mark.parametrize("pipeline", [False, True])
def test_abort_with_items_queued_releases_everything(pipeline):
    """A wedged consumer holds the budget; a feeder blocks on it. abort()
    wakes the feeder, stops every stage thread and releases every charge
    and lease."""
    _, port = _pair([_recs(s, 120) for s in range(5)])
    one = OverlappedMerger._source_bytes(port[0])
    before = set(threading.enumerate())
    om = OverlappedMerger(tcmp.get_key_type(KT), 16, engine="pallas",
                          pipeline=pipeline, stagers=1,
                          inflight_bytes=int(1.5 * one), device="cpu")
    hold = threading.Event()
    orig = OverlappedMerger._consume_run

    def wedge(self, staged):
        while not hold.is_set() and not self._aborted:
            time.sleep(0.01)
        orig(self, staged)

    om._consume_run = wedge.__get__(om)
    fed = threading.Event()

    def feeder():
        for i, b in enumerate(port):
            om.feed(i, b)
        fed.set()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    time.sleep(0.3)
    assert not fed.is_set()  # blocked on the in-flight budget
    assert om.stats["inflight_bytes"] > 0
    om.abort()
    hold.set()
    t.join(timeout=10)
    assert not t.is_alive()
    _assert_idle(om)
    left = [th.name for th in threading.enumerate()
            if th not in before and th.is_alive()
            and th.name.startswith(("uda-stage", "uda-overlap"))]
    assert not left


def test_feed_racing_abort_releases_its_charge():
    """_charge() sees the abort flag unset, abort() then completes before
    the item lands in the queue: the post-put re-drain releases it."""
    _, port = _pair([_recs(50, 10)])
    om = OverlappedMerger(tcmp.get_key_type(KT), 16, pipeline=True,
                          inflight_bytes=1 << 20, device="cpu")
    orig_charge = om._charge

    def charge_then_abort(source):
        c = orig_charge(source)
        om.abort()
        return c

    om._charge = charge_then_abort
    om.feed(0, port[0])
    _assert_idle(om)


@pytest.mark.parametrize("engine", ["host", "pallas"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_a_staging_error_surfaces_from_finish(monkeypatch, pipeline,
                                              engine):
    _, port = _segments(seed=3, k=5)
    real = toverlap.packing.pack_keys
    calls = []

    def failing(batch, kt, width):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("injected packing fault")
        return real(batch, kt, width)

    monkeypatch.setattr(toverlap.packing, "pack_keys", failing)
    om = OverlappedMerger(tcmp.get_key_type(KT), 16, engine=engine,
                          pipeline=pipeline, inflight_bytes=1 << 20,
                          device="cpu")
    for i, b in enumerate(port):
        om.feed(i, b)
    with pytest.raises(ValueError, match="injected packing fault"):
        om.finish(port)
    _assert_idle(om)


@pytest.mark.parametrize("pipeline", [False, True])
def test_a_failed_device_merge_is_a_merge_error(monkeypatch, pipeline):
    """A K1 failure (here a RuntimeError from the pair merge, as a refused
    launch raises) surfaces from finish as MergeError, never as another
    engine's result."""
    _, port = _segments(seed=4, k=4)

    def refused(*args):
        raise RuntimeError("uda_merge_pass failed: CUDA error 700")

    monkeypatch.setattr(toverlap.merge_ops, "merge_row_pair", refused)
    om = OverlappedMerger(tcmp.get_key_type(KT), 16, engine="pallas",
                          pipeline=pipeline, device="cpu")
    for i, b in enumerate(port):
        om.feed(i, b)
    with pytest.raises(MergeError, match="CUDA error 700"):
        om.emit_stream(port, FramedEmitter(BLOCK), lambda b: None)
    _assert_idle(om)


@pytest.mark.parametrize("where", ["refused_shape", "lease", "readback",
                                   "readback_streaming"])
def test_every_device_failure_is_a_merge_error(monkeypatch, tmp_path,
                                               where):
    """Not only a RuntimeError: K1 refusing its operands (a ValueError, as
    merge_pass does past 31 row words), a pinned lease that cannot be
    allocated and a failed readback of the merged rows all surface as
    MergeError, with nothing left charged or leased."""
    _, port = _segments(seed=7, k=4)
    if where == "refused_shape":
        def refused(*args, **kwargs):
            raise ValueError("merge_pass takes 1 to 31 key words, got 32")

        monkeypatch.setattr(tmerge, "merge_sorted_pair", refused)
    elif where == "lease":
        def no_memory(self, need):
            raise RuntimeError("CUDA error: out of memory")

        monkeypatch.setattr(tmerge.RowBufferPool, "_alloc", no_memory)
    else:
        def lost(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(toverlap.stream_mod, "iter_row_slabs", lost)
    store = (tstream.RunStore(str(tmp_path))
             if where == "readback_streaming" else None)
    om = OverlappedMerger(tcmp.get_key_type(KT), 16, engine="pallas",
                          pipeline=True, inflight_bytes=1 << 20,
                          run_store=store, device="cpu")
    for i, b in enumerate(port):
        om.feed(i, b)
    with pytest.raises(MergeError, match="device merge on cpu failed"):
        if store is None:
            om.emit_stream(port, FramedEmitter(BLOCK), lambda b: None)
        else:
            om.finish_streaming(FramedEmitter(BLOCK), lambda b: None)
    _assert_idle(om)
    assert not list(tmp_path.iterdir())  # the run store cleaned up


@pytest.mark.parametrize("fed", [0, 2])
def test_lost_records_guard_raises_in_both(fed):
    """finish() handed segments that were never fed: the lost-records
    guard raises MergeError, in the port as in the reference."""
    ref, port = _segments(seed=6, k=3)
    jom = JOverlappedMerger(jcmp.get_key_type(KT), 16, engine="host")
    tom = OverlappedMerger(tcmp.get_key_type(KT), 16, engine="pallas",
                           device="cpu")
    for i in range(fed):
        jom.feed(i, ref[i])
        tom.feed(i, port[i])
    with pytest.raises(jerrors.MergeError) as want:
        jom.finish(ref)
    with pytest.raises(MergeError) as got:
        tom.finish(port)
    assert str(got.value) == str(want.value)


def test_merger_device_rule(monkeypatch):
    kt = tcmp.get_key_type(KT)
    om = OverlappedMerger(kt, 16, device="cpu")
    assert om.engine == "host" and om._buf_pool is None
    om.abort()
    with pytest.raises(MergeError, match="device_runs=False"):
        OverlappedMerger(kt, 16, device_runs=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OverlappedMerger(kt, 16)


def test_row_buffer_pool_reuses_and_bounds():
    pool = tmerge.RowBufferPool("cpu")
    assert not pool.pinned
    before = metrics.get("stage.buffer.reuses")
    a = pool.lease(100, 7)
    assert a.shape == (100, 7) and a.dtype == np.uint32
    pool.release(a)
    b = pool.lease(50, 7)  # a smaller lease fits the released buffer
    assert b.shape == (50, 7) and pool.leased == 1
    assert metrics.get("stage.buffer.reuses") == before + 1
    pool.release(b)
    pool.release(None)
    assert pool.leased == 0
    leases = [pool.lease(8, 7) for _ in range(pool.MAX_FREE + 4)]
    for lease in leases:
        pool.release(lease)
    assert pool.leased == 0
    assert len(pool._free) == pool.MAX_FREE == jmerge.RowBufferPool.MAX_FREE


@pytest.mark.parametrize("conf,window,chunk", [
    ({"uda.tpu.stage.inflight.mb": 64}, 4, 1 << 20),
    ({}, 4, 1 << 20), ({}, 512, 1 << 20), ({}, 16, 1 << 10),
    ({}, 0, 0)])
def test_stage_inflight_cap_matches_reference(conf, window, chunk):
    got = stage_inflight_cap(Config(conf), window, chunk)
    assert got == j_inflight_cap(JConfig(conf), window, chunk)
    assert got >= min(STAGE_INFLIGHT_FLOOR_MB << 20,
                      conf.get("uda.tpu.stage.inflight.mb", 1 << 20) << 20)


def test_overflow_order_and_bytewise_rule_match_reference():
    for name in ("org.apache.hadoop.io.Text", "uda.tpu.RawBytes",
                 "org.apache.hadoop.io.BytesWritable"):
        assert tcmp.uses_default_bytewise(tcmp.get_key_type(name)) == \
            jcmp.uses_default_bytewise(jcmp.get_key_type(name))
    kt = tcmp.get_key_type(KT)

    class CmpOnly(type(kt)):
        def compare(self, a, b):  # forces the cmp_to_key path
            return super().compare(a, b)

    slow_kt = CmpOnly(kt.name, kt.content)
    assert not tcmp.uses_default_bytewise(slow_kt)
    rng = np.random.default_rng(17)
    recs = [(bytes([i % 3]) * (17 + int(rng.integers(0, 12))), rng.bytes(8))
            for i in range(120)]
    ref, port = _pair([recs])
    want = JOverlappedMerger(jcmp.get_key_type(KT), 16, engine="host")
    fast = OverlappedMerger(kt, 16, device="cpu")
    slow = OverlappedMerger(slow_kt, 16, device="cpu")
    expect = want._overflow_order(ref[0], 120)
    assert np.array_equal(fast._overflow_order(port[0], 120), expect)
    assert np.array_equal(slow._overflow_order(port[0], 120), expect)
    for om in (want, fast, slow):
        om.abort()
