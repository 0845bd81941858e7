"""The port's batched host-I/O plane (uda_tpu_torch.mofserver.data_engine:
``plan_coalesced``, ``submit_batch``, the backend ladder and its tune-cache
consult) and the network server's batch feeding, against the JAX
package's on the same files: the same coalesced runs, the same bytes as
the single-pread path and as the reference's batch plane, per-request
error isolation (bad offset, admission, injected ``data_engine.preadv``
faults), and a burst over the wire byte-identical with batching on and
off. The ladder lands on the rung the reference's does on the same host:
the native reader's io_uring where the kernel grants it, else preadv."""

import hashlib
import os
import sys
import threading
import zlib

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.mofserver import data_engine as jde
from uda_tpu.mofserver.index import IndexRecord as JIndexRecord
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils import ifile as jifile
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu_torch.mofserver import data_engine as de
from uda_tpu_torch.mofserver.data_engine import (DataEngine, ShuffleRequest,
                                                 plan_coalesced)
from uda_tpu_torch.mofserver.index import IndexRecord
from uda_tpu_torch.utils import ifile as tifile
from uda_tpu_torch.utils import tuncache
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import ConfigError, StorageError
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics

JOB = "jobIoBatch"
MAP = "attempt_jobIoBatch_m_000000_0"


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    with failpoints.scoped(""):
        yield
    metrics.reset()


class SyntheticResolver:
    """Every (job, map, reduce) resolves to one pre-written file."""

    def __init__(self, path: str, nbytes: int, record=IndexRecord):
        self._rec = record(start_offset=0, raw_length=nbytes,
                           part_length=nbytes, path=path)

    def resolve(self, job_id, map_id, reduce_id):
        return self._rec

    def resolve_cached(self, job_id, map_id, reduce_id):
        return self._rec


def _write(tmp, name, nbytes, seed=7):
    path = os.path.join(tmp, name)
    with open(path, "wb") as f:
        f.write(np.random.default_rng(seed).bytes(nbytes))
    return path


def _blob(path):
    with open(path, "rb") as f:
        return f.read()


def _admitted(engine) -> int:
    return engine._admitted_bytes


# -- the coalescing planner ---------------------------------------------------

PLANS = {
    "adjacent_gap30": ([("a", 0, 100), ("b", 100, 50), ("c", 180, 20)],
                       30, 1 << 20),
    "adjacent_gap29": ([("a", 0, 100), ("b", 100, 50), ("c", 180, 20)],
                       29, 1 << 20),
    "zero_gap": ([("a", 0, 10), ("b", 10, 10), ("c", 21, 10)], 0, 1 << 20),
    "overlap": ([("a", 0, 100), ("dup", 0, 100), ("b", 50, 100)],
                1 << 20, 1 << 20),
    "max_run": ([(f"x{i}", i * 100, 100) for i in range(10)], 0, 300),
    "iov_max": ([(f"x{i}", i * 10, 10) for i in range(1200)], 0, 1 << 30),
    "unsorted": ([("b", 500, 10), ("a", 0, 10), ("c", 505, 10)], 0,
                 1 << 20),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_coalesced_matches_reference(case):
    items, gap, max_run = PLANS[case]
    got = plan_coalesced(items, gap, max_run)
    assert got == jde.plan_coalesced(items, gap, max_run)
    flat = [i for run in got for i in run]
    assert sorted(flat) == sorted(items)
    for run in got:
        assert len(run) <= 511
        end = -1
        for _, off, length in run:
            assert off >= end
            end = off + length


def test_plan_coalesced_shapes():
    items = PLANS["adjacent_gap30"][0]
    assert [[i[0] for i in r] for r in plan_coalesced(items, 30, 1 << 20)] \
        == [["a", "b", "c"]]
    assert [[i[0] for i in r] for r in plan_coalesced(items, 29, 1 << 20)] \
        == [["a", "b"], ["c"]]
    assert [len(r) for r in plan_coalesced(*PLANS["max_run"])] == \
        [3, 3, 3, 1]
    assert len(plan_coalesced(*PLANS["overlap"])) == 3
    assert plan_coalesced([], 0, 1) == []


@pytest.mark.parametrize("seed", range(4))
def test_plan_coalesced_random_ranges_match_reference(seed):
    rng = np.random.default_rng(seed)
    items = [(f"r{i}", int(rng.integers(0, 1 << 16)),
              int(rng.integers(1, 4096))) for i in range(300)]
    gap = int(rng.integers(0, 8192))
    assert plan_coalesced(items, gap, 64 << 10) == \
        jde.plan_coalesced(items, gap, 64 << 10)


# -- submit_batch -------------------------------------------------------------

def test_submit_batch_byte_identity_vs_file(tmp_path):
    data_len = 1 << 20
    path = _write(str(tmp_path), "f.mof", data_len)
    blob = _blob(path)
    engine = DataEngine(SyntheticResolver(path, data_len),
                        Config({"uda.tpu.read.backend": "preadv"}))
    try:
        # adjacent, gapped, duplicate and tail-clamped ranges in one batch
        offs = [0, 65536, 131072, 131072, 400000, 400100, data_len - 100]
        reqs = [ShuffleRequest(JOB, MAP, 0, off, 65536) for off in offs]
        for req, fut in zip(reqs, engine.submit_batch(reqs)):
            res = fut.result(timeout=10)
            assert bytes(res.data) == blob[req.offset:req.offset + 65536]
            assert res.last == (req.offset + len(res.data) >= data_len)
            assert res.raw_length == data_len
        assert metrics.get("io.batch.requests") == len(reqs)
        assert metrics.get("io.batch.submits") == 1
        # the adjacent trio coalesced: fewer reads than requests
        assert metrics.get("io.batch.reads") < len(reqs)
    finally:
        engine.stop()
    assert _admitted(engine) == 0


@pytest.mark.parametrize("backend", ["preadv", "pread"])
def test_submit_batch_matches_single_submit_and_reference(tmp_path,
                                                          backend):
    """Batch results equal the single-pread path's and the reference's
    batch plane's over the same requests."""
    data_len = 512 * 1024
    path = _write(str(tmp_path), "f.mof", data_len, seed=11)
    conf = {"uda.tpu.read.backend": backend}
    engine = DataEngine(SyntheticResolver(path, data_len), Config(conf))
    jengine = jde.DataEngine(
        SyntheticResolver(path, data_len, JIndexRecord), JConfig(conf))
    offs = [0, 1000, 64 * 1024, 300000, 500000]
    try:
        reqs = [ShuffleRequest(JOB, MAP, 0, off, 32768) for off in offs]
        jreqs = [jde.ShuffleRequest(JOB, MAP, 0, off, 32768)
                 for off in offs]
        single = [engine.submit(r).result(timeout=10) for r in reqs]
        batched = [f.result(timeout=10) for f in engine.submit_batch(reqs)]
        with jfailpoints.scoped(""):
            ref = [f.result(timeout=10)
                   for f in jengine.submit_batch(jreqs)]
        for s, b, r in zip(single, batched, ref):
            assert bytes(s.data) == bytes(b.data) == bytes(r.data)
            assert (s.raw_length, s.part_length, s.offset, s.last) == \
                (b.raw_length, b.part_length, b.offset, b.last) == \
                (r.raw_length, r.part_length, r.offset, r.last)
        assert engine.io_backend == backend
    finally:
        engine.stop()
        jengine.stop()


def test_submit_batch_bad_offset_fails_only_that_request(tmp_path):
    data_len = 256 * 1024
    path = _write(str(tmp_path), "f.mof", data_len)
    engine = DataEngine(SyntheticResolver(path, data_len), Config())
    try:
        reqs = [ShuffleRequest(JOB, MAP, 0, 0, 4096),
                ShuffleRequest(JOB, MAP, 0, data_len + 5, 4096),
                ShuffleRequest(JOB, MAP, 0, 8192, 4096)]
        futs = engine.submit_batch(reqs)
        assert futs[0].result(timeout=10).data
        with pytest.raises(StorageError):
            futs[1].result(timeout=10)
        assert futs[2].result(timeout=10).data
    finally:
        engine.stop()


def test_submit_batch_admission_rejection_is_per_request(tmp_path):
    data_len = 4 << 20
    path = _write(str(tmp_path), "f.mof", data_len)
    engine = DataEngine(SyntheticResolver(path, data_len),
                        Config({"uda.tpu.supplier.read.budget.mb": 1}))
    try:
        # a 1 MB budget: the first request (idle engine) admits, the
        # others cannot fit beside it and fail only their own futures
        futs = engine.submit_batch([ShuffleRequest(JOB, MAP, 0, i << 20,
                                                   1 << 20)
                                    for i in range(3)])
        assert len(futs[0].result(timeout=10).data) == 1 << 20
        for f in futs[1:]:
            with pytest.raises(StorageError):
                f.result(timeout=10)
        assert metrics.get("supplier.admission.rejections") == 2
    finally:
        engine.stop()
    assert _admitted(engine) == 0


def test_submit_batch_never_raises_when_stopped(tmp_path):
    path = _write(str(tmp_path), "f.mof", 1024)
    engine = DataEngine(SyntheticResolver(path, 1024), Config())
    engine.stop()
    futs = engine.submit_batch([ShuffleRequest(JOB, MAP, 0, 0, 512)])
    with pytest.raises(StorageError, match="stopped"):
        futs[0].result(timeout=5)


def test_submit_batch_crc_stamped_from_disk_bytes(tmp_path):
    data_len = 128 * 1024
    path = _write(str(tmp_path), "f.mof", data_len)
    blob = _blob(path)
    engine = DataEngine(SyntheticResolver(path, data_len),
                        Config({"uda.tpu.fetch.crc": True}))
    try:
        res = engine.submit_batch(
            [ShuffleRequest(JOB, MAP, 0, 4096, 8192)])[0].result(timeout=10)
        assert res.crc == zlib.crc32(blob[4096:4096 + 8192]) & 0xFFFFFFFF
    finally:
        engine.stop()


def _reference_rung(path, conf) -> str:
    """The rung the reference's ladder lands on on this host."""
    engine = jde.DataEngine(SyntheticResolver(path, 1024, JIndexRecord),
                            JConfig(conf))
    engine.stop()
    return engine.io_backend


def test_backend_ladder_and_io_backend_recorded(tmp_path):
    """The port's ladder lands where the reference's does on this host:
    with the native reader, "auto" and "io_uring" take the ring where
    the kernel grants it (else preadv); with uda.tpu.use.native off both
    land on preadv. Explicit rungs walk down, typos fail loudly in both
    packages."""
    path = _write(str(tmp_path), "f.mof", 1024)
    landed = []
    try:
        for use_native in (True, False):
            for want in ("auto", "io_uring", "preadv", "pread"):
                conf = {"uda.tpu.read.backend": want,
                        "uda.tpu.use.native": use_native}
                engine = DataEngine(SyntheticResolver(path, 1024),
                                    Config(conf))
                engine.stop()
                assert engine.io_backend == _reference_rung(path, conf)
                landed.append(engine.io_backend)
                if not use_native:
                    assert engine.io_backend == ("pread" if want == "pread"
                                                 else "preadv")
    finally:
        tifile.set_native_enabled(True)
        jifile.set_native_enabled(True)
    for rung in set(landed):
        assert metrics.get("io.backend", backend=rung) == landed.count(rung)
    for bad in ({"uda.tpu.read.backend": "io_urng"},
                {"uda.tpu.read.batch": "sometimes"}):
        with pytest.raises(ConfigError) as got:
            DataEngine(SyntheticResolver(path, 1024), Config(bad))
        with pytest.raises(Exception) as want:
            jde.DataEngine(SyntheticResolver(path, 1024, JIndexRecord),
                           JConfig(bad))
        assert str(got.value) == str(want.value)


# -- the tune cache's io.read consult ----------------------------------------

@pytest.fixture()
def cache_at(tmp_path, monkeypatch):
    path = str(tmp_path / "tune.json")
    cache = tuncache.TuneCache(path)
    monkeypatch.setattr(tuncache, "tune_cache", cache)
    monkeypatch.delenv("UDA_TPU_TUNE_CACHE", raising=False)
    return cache


def _engine_with_cache(tmp_path, cache_path, overrides=None):
    path = _write(str(tmp_path), "f.mof", 4096)
    cfg = {"uda.tpu.tune.cache.path": cache_path}
    cfg.update(overrides or {})
    return DataEngine(SyntheticResolver(path, 4096), Config(cfg))


def test_io_plane_consults_cache_winner(tmp_path, cache_at):
    cache_at.record("io.read", sys.platform,
                    {"batch": "off", "gap_kb": 256, "batch_max": 32,
                     "backend": "pread"})
    engine = _engine_with_cache(tmp_path, cache_at.path)
    engine.stop()
    assert engine.batch_enabled is False
    assert engine.coalesce_gap_bytes == 256 << 10
    assert engine.batch_max == 32
    assert engine.max_run_bytes == 32 * (64 << 10)
    assert engine.io_backend == "pread"


def test_io_plane_explicit_config_beats_cache(tmp_path, cache_at):
    cache_at.record("io.read", sys.platform,
                    {"batch": "off", "gap_kb": 256, "batch_max": 8})
    engine = _engine_with_cache(
        tmp_path, cache_at.path,
        {"uda.tpu.read.batch": "on", "uda.tpu.read.coalesce.gap.kb": 8,
         "uda.tpu.read.batch.max": 100})
    engine.stop()
    assert engine.batch_enabled is True
    assert engine.coalesce_gap_bytes == 8 << 10
    assert engine.batch_max == 100


def test_io_plane_invalid_winner_values_ignored(tmp_path, cache_at):
    cache_at.record("io.read", sys.platform,
                    {"batch": "maybe", "gap_kb": "lots", "batch_max": -3,
                     "backend": "carrier-pigeon"})
    engine = _engine_with_cache(tmp_path, cache_at.path)
    engine.stop()
    assert engine.batch_enabled is True           # the default, auto
    assert engine.coalesce_gap_bytes == 64 << 10  # the flag defaults
    assert engine.batch_max == 256
    # the top of the ladder this host grants, as in the reference
    assert engine.io_backend == _reference_rung(engine.resolver._rec.path, {})


def test_config_path_installs_process_default(tmp_path, cache_at,
                                              monkeypatch):
    """An explicit ``uda.tpu.tune.cache.path`` installs that cache as the
    process default (what route_engine consults), unless the env channel
    is set, which always wins."""
    other = str(tmp_path / "other_tune.json")
    _engine_with_cache(tmp_path, other).stop()
    assert tuncache.tune_cache.path == other
    monkeypatch.setenv("UDA_TPU_TUNE_CACHE", cache_at.path)
    before = tuncache.tune_cache
    _engine_with_cache(tmp_path, str(tmp_path / "third.json")).stop()
    assert tuncache.tune_cache is before


def test_a_reference_written_io_winner_configures_the_port(tmp_path,
                                                            monkeypatch):
    """The tune cache's schema is shared: an ``io.read`` winner the
    reference recorded configures the port's plane the same way."""
    from uda_tpu.utils import tuncache as jtuncache

    # an explicit cache path installs itself as each package's process
    # default: restore both after the test
    monkeypatch.setattr(jtuncache, "tune_cache", jtuncache.tune_cache)
    monkeypatch.setattr(tuncache, "tune_cache", tuncache.tune_cache)
    monkeypatch.delenv("UDA_TPU_TUNE_CACHE", raising=False)
    path = str(tmp_path / "shared.json")
    jtuncache.TuneCache(path).record(
        "io.read", sys.platform, {"batch": "on", "gap_kb": 16,
                                  "batch_max": 64, "backend": "preadv"})
    mof = _write(str(tmp_path), "f.mof", 4096)
    conf = {"uda.tpu.tune.cache.path": path}
    mine = DataEngine(SyntheticResolver(mof, 4096), Config(conf))
    theirs = jde.DataEngine(SyntheticResolver(mof, 4096, JIndexRecord),
                            JConfig(conf))
    mine.stop()
    theirs.stop()
    for attr in ("batch_enabled", "coalesce_gap_bytes", "batch_max",
                 "max_run_bytes", "io_backend"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr


# -- the wire serve path ------------------------------------------------------

def _wire_burst(path, data_len, batch, n=64, chunk=16 * 1024,
                server_cfg=None):
    from uda_tpu_torch.net import RemoteFetchClient, ShuffleServer

    engine = DataEngine(SyntheticResolver(path, data_len),
                        Config({"uda.tpu.read.batch": batch}))
    server = ShuffleServer(
        engine, Config(server_cfg or {"uda.tpu.net.zerocopy": False}),
        host="127.0.0.1", port=0).start()
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    results = [None] * n
    done = threading.Event()
    lock = threading.Lock()
    count = [0]

    def mk(i):
        def cb(res):
            results[i] = res
            with lock:
                count[0] += 1
                if count[0] == n:
                    done.set()
        return cb

    try:
        for i in range(n):
            client.start_fetch(ShuffleRequest(
                JOB, MAP, 0, (i * chunk) % data_len, chunk), mk(i))
        assert done.wait(30.0), f"burst stalled {count[0]}/{n}"
    finally:
        client.stop()
        server.stop()
        engine.stop()
    assert _admitted(engine) == 0
    return results


def test_wire_burst_batched_is_byte_identical(tmp_path):
    data_len = 2 << 20
    path = _write(str(tmp_path), "f.mof", data_len, seed=3)
    blob = _blob(path)

    def digest(results):
        h = hashlib.sha256()
        for r in results:
            assert not isinstance(r, Exception), r
            h.update(bytes(r.data))
        return h.hexdigest()

    got_on = _wire_burst(path, data_len, "on")
    assert metrics.get("io.batch.requests") > 0
    assert metrics.get("net.serve.copy") == 64
    metrics.reset()
    got_off = _wire_burst(path, data_len, "off")
    assert metrics.get("io.batch.requests") == 0  # one pread a chunk
    assert digest(got_off) == digest(got_on)
    for i, r in enumerate(got_on):
        off = (i * 16384) % data_len
        assert bytes(r.data) == blob[off:off + 16384]


def test_wire_zero_copy_requests_stay_unbatched(tmp_path):
    """Slice-eligible requests keep the zero-copy plane: batching never
    trades a splice for a heap copy."""
    data_len = 1 << 20
    path = _write(str(tmp_path), "f.mof", data_len)
    results = _wire_burst(path, data_len, "on", n=16,
                          server_cfg={"uda.tpu.net.zerocopy": True})
    assert all(not isinstance(r, Exception) for r in results)
    assert metrics.get("io.batch.requests") == 0
    assert metrics.get("net.serve.fd") == 16
    assert metrics.get("net.serve.copy") == 0


def test_wire_crc_requests_ride_the_batch_plane(tmp_path):
    """CRC stamping takes chunks off the zero-copy plane even with it
    on: they go through submit_batch, each stamped from disk."""
    data_len = 1 << 20
    path = _write(str(tmp_path), "f.mof", data_len, seed=9)
    blob = _blob(path)
    from uda_tpu_torch.net import RemoteFetchClient, ShuffleServer

    engine = DataEngine(SyntheticResolver(path, data_len),
                        Config({"uda.tpu.fetch.crc": True}))
    server = ShuffleServer(engine, Config(), host="127.0.0.1",
                           port=0).start()
    client = RemoteFetchClient("127.0.0.1", server.port, Config())
    try:
        for off in (0, 65536, data_len - 4096):
            box, done = [], threading.Event()
            client.start_fetch(ShuffleRequest(JOB, MAP, 0, off, 65536),
                               lambda r: (box.append(r), done.set()))
            assert done.wait(10)
            want = blob[off:off + 65536]
            assert bytes(box[0].data) == want
            assert box[0].crc == zlib.crc32(want) & 0xFFFFFFFF
    finally:
        client.stop()
        server.stop()
        engine.stop()
    assert metrics.get("io.batch.requests") == 3
    assert metrics.get("net.serve.fd") == 0


# -- failure injection --------------------------------------------------------

@pytest.mark.faults
def test_iobatch_partial_failure_only_targets_request(tmp_path):
    """An injected data_engine.preadv fault (keyed <fd>@<file offset>)
    fails exactly the targeted request of a coalesced batch (the preadv
    rung); its batch-mates complete byte-correct and every charge
    settles."""
    data_len = 1 << 20
    path = _write(str(tmp_path), "f.mof", data_len, seed=5)
    blob = _blob(path)
    engine = DataEngine(SyntheticResolver(path, data_len),
                        Config({"uda.tpu.read.backend": "preadv"}))
    try:
        offs = [0, 16384, 32768, 49152]  # one coalesced vectored read
        with failpoints.scoped("data_engine.preadv=error:match:@32768"):
            futs = engine.submit_batch(
                [ShuffleRequest(JOB, MAP, 0, off, 16384) for off in offs])
            for off, fut in zip(offs, futs):
                if off == 32768:
                    with pytest.raises(StorageError):
                        fut.result(timeout=10)
                else:
                    assert bytes(fut.result(timeout=10).data) == \
                        blob[off:off + 16384]
        assert metrics.get("failpoint.data_engine.preadv") == 1
        assert metrics.get("io.coalesce.runs") == 1
    finally:
        engine.stop()
    assert _admitted(engine) == 0


@pytest.mark.faults
def test_iobatch_truncate_damages_one_request(tmp_path):
    """A truncated chunk looks like wire damage on one request (the CRC
    was stamped before the damage); its batch-mate is untouched."""
    data_len = 256 * 1024
    path = _write(str(tmp_path), "f.mof", data_len)
    blob = _blob(path)
    engine = DataEngine(SyntheticResolver(path, data_len),
                        Config({"uda.tpu.fetch.crc": True}))
    try:
        with failpoints.scoped(
                "data_engine.preadv=truncate:100:match:@8192"):
            futs = engine.submit_batch(
                [ShuffleRequest(JOB, MAP, 0, 0, 8192),
                 ShuffleRequest(JOB, MAP, 0, 8192, 8192)])
            ok = futs[0].result(timeout=10)
            assert bytes(ok.data) == blob[:8192]
            assert ok.crc == zlib.crc32(blob[:8192]) & 0xFFFFFFFF
            hurt = futs[1].result(timeout=10)
            assert len(hurt.data) == 8192 - 100
            assert hurt.crc == zlib.crc32(blob[8192:16384]) & 0xFFFFFFFF
            assert zlib.crc32(bytes(hurt.data)) & 0xFFFFFFFF != hurt.crc
    finally:
        engine.stop()


@pytest.mark.faults
def test_iobatch_wire_pread_injection_still_fires(tmp_path):
    """The data_engine.pread site fires per request on the batch plane
    too (same <map>/<reduce> key), so every pread schedule keeps testing
    the wire serve path."""
    data_len = 512 * 1024
    path = _write(str(tmp_path), "f.mof", data_len)
    with failpoints.scoped("data_engine.pread=error:every:3"):
        results = _wire_burst(path, data_len, "on", n=12)
    errors = [r for r in results if isinstance(r, Exception)]
    assert len(errors) == 4 and all(isinstance(e, StorageError)
                                    for e in errors)
    assert all(getattr(e, "remote_kind", "") == "StorageError"
               for e in errors)
    assert metrics.get("io.batch.requests") == 12


@pytest.mark.faults
def test_iobatch_preadv_delay_keeps_books_balanced(tmp_path):
    data_len = 256 * 1024
    path = _write(str(tmp_path), "f.mof", data_len)
    engine = DataEngine(SyntheticResolver(path, data_len), Config())
    try:
        with failpoints.scoped(
                "data_engine.preadv=delay:5:prob:0.5:seed:7"):
            for fut in engine.submit_batch(
                    [ShuffleRequest(JOB, MAP, 0, i * 8192, 8192)
                     for i in range(16)]):
                fut.result(timeout=30)
    finally:
        engine.stop()
    assert _admitted(engine) == 0


def test_preadv_continues_after_a_short_read(tmp_path, monkeypatch):
    """_preadv_full re-issues past the filled prefix when the kernel
    returns short, in both packages alike."""
    path = _write(str(tmp_path), "f.mof", 10000)
    blob = _blob(path)
    real = os.preadv
    calls = []

    def short(fd, bufs, off):
        calls.append(off)
        total = sum(len(b) for b in bufs)
        if total > 3000:  # hand back at most 3000 bytes a call
            views, left = [], 3000
            for b in bufs:
                mv = memoryview(b)[:left]
                views.append(mv)
                left -= len(mv)
                if not left:
                    break
            return real(fd, views, off)
        return real(fd, bufs, off)

    monkeypatch.setattr(os, "preadv", short)
    fd = os.open(path, os.O_RDONLY)
    try:
        bufs = [bytearray(2500), bytearray(4000), bytearray(3000)]
        got, syscalls = de._preadv_full(fd, bufs, 100)
        jbufs = [bytearray(2500), bytearray(4000), bytearray(3000)]
        assert jde._preadv_full(fd, jbufs, 100) == (got, syscalls)
    finally:
        os.close(fd)
    assert got == 9500 and syscalls == 4
    assert b"".join(bufs) == blob[100:9600] == b"".join(jbufs)
