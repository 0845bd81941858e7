"""The port's reduce task (uda_tpu_torch.merger.MergeManager.run) against
the JAX package's on the same MOF tree and the same Config: the emitted
IFile byte streams and the returned byte counts must be identical, under
the default Config (the overlapped merger, pipelined staging), with the
pipeline off, in streaming mode and with ``uda.tpu.merge.overlap=false``
across ``uda.tpu.merge.two_phase``; at 1 KB fetch chunks (records split
across chunks), three key types, keys past the width, empty partitions,
fetch faults and retries. A Config asking for push, the one mode the port
does not have, raises; the survivable fetch (coded stripes, speculation,
mid-partition resume), the other approaches, checkpoints, failpoints and
the watchdog have test files of their own."""

import os

import numpy as np
import pytest
import torch

from helpers import make_mof_tree, map_ids
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.mofserver import writer as jwriter
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.ifile import crack as jcrack
from uda_tpu.utils.vint import encode_vlong
from uda_tpu_torch.merger import LocalFetchClient, MergeManager, Segment
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                     ShuffleRequest)
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config

TEXT = "org.apache.hadoop.io.Text"
BYTES = "org.apache.hadoop.io.BytesWritable"
LONG = "org.apache.hadoop.io.LongWritable"
BASE = {"uda.tpu.merge.overlap": False, "mapred.rdma.buf.size": 1}


def text_tree(root: str, job: str, maps: int, n: int, seed: int,
              max_len: int = 14) -> list:
    """A MOF tree of Text keys (VInt length + content, duplicates, values
    long enough to split across 1 KB chunks), written by the reference's
    MOFWriter, two reduce partitions per map."""
    rng = np.random.default_rng(seed)
    w = jwriter.MOFWriter(root, job)
    for m in range(maps):
        parts = []
        for _ in range(2):
            recs = []
            for _ in range(n):
                c = bytes(rng.integers(0, 3, int(rng.integers(0, max_len + 1)),
                                       dtype=np.uint8))
                recs.append((encode_vlong(len(c)) + c,
                             rng.bytes(int(rng.integers(0, 300)))))
            parts.append(sorted(recs, key=lambda kv: kv[0][1:]))
        w.write(f"map_{m:03d}", parts)
    return [f"map_{m:03d}" for m in range(maps)]


def mof_tree(root: str, java_class: str, seed: int) -> list:
    if java_class == TEXT:
        return text_tree(root, "job", 4, 120, seed)
    if java_class == BYTES:   # 4-byte length field, then the content
        make_mof_tree(root, "job", 4, 2, 200, seed=seed, key_bytes=12,
                      val_bytes=70, sort_key=lambda kv: kv[0][4:])
    else:                     # LongWritable: 8 bytes, memcmp order
        make_mof_tree(root, "job", 4, 2, 200, seed=seed, key_bytes=8,
                      val_bytes=70)
    return map_ids("job", 4)


def partition_records(root: str, mids: list, reduce_id: int) -> int:
    """The records of one reduce partition across the map outputs."""
    resolver = JDirIndexResolver(root)
    total = 0
    for mid in mids:
        rec = resolver.resolve("job", mid, reduce_id)
        with open(rec.path, "rb") as f:
            f.seek(rec.start_offset)
            total += jcrack(f.read(rec.part_length)).num_records
    return total


def port_run(root, mids, java_class, conf, client_of=LocalFetchClient,
             reduce_id=1):
    out = bytearray()
    engine = DataEngine(DirIndexResolver(root), Config(conf))
    try:
        mm = MergeManager(client_of(engine), java_class, Config(conf),
                          device="cpu")
        n = mm.run("job", mids, reduce_id, out.extend)
    finally:
        engine.stop()
    return n, bytes(out)


def reference_run(root, mids, java_class, conf,
                  client_of=JLocalFetchClient, reduce_id=1):
    out = bytearray()
    engine = JDataEngine(JDirIndexResolver(root), JConfig(conf))
    try:
        mm = JMergeManager(client_of(engine), java_class, JConfig(conf))
        n = mm.run("job", mids, reduce_id, out.extend)
    finally:
        engine.stop()
    return n, bytes(out)


@pytest.mark.parametrize("two_phase", ["on", "off", "auto"])
@pytest.mark.parametrize("java_class", [TEXT, BYTES, LONG])
def test_run_matches_reference(tmp_path, java_class, two_phase):
    mids = mof_tree(str(tmp_path), java_class, seed=len(java_class))
    conf = dict(BASE, **{"uda.tpu.merge.two_phase": two_phase})
    got = port_run(str(tmp_path), mids, java_class, conf)
    want = reference_run(str(tmp_path), mids, java_class, conf)
    assert got[0] == want[0] == len(got[1]) > 1024
    assert got[1] == want[1]
    assert jcrack(got[1]).num_records == partition_records(
        str(tmp_path), mids, 1)


def test_run_with_keys_past_the_width_matches_reference(tmp_path):
    """Text keys wider than uda.tpu.key.width: the two-phase merge falls
    back to the whole re-sort, in the port as in the reference."""
    mids = text_tree(str(tmp_path), "job", 3, 150, seed=7, max_len=40)
    conf = dict(BASE, **{"uda.tpu.merge.two_phase": "on"})
    assert port_run(str(tmp_path), mids, TEXT, conf) == \
        reference_run(str(tmp_path), mids, TEXT, conf)


def test_run_default_chunks_and_host_entries(tmp_path):
    """1 MB chunks (one fetch per partition) and ("host", map) entries
    give the same stream as the reference."""
    mids = text_tree(str(tmp_path), "job", 3, 80, seed=9)
    conf = {"uda.tpu.merge.overlap": False}
    entries = [("", m) for m in mids]
    assert port_run(str(tmp_path), entries, TEXT, conf, reduce_id=0) == \
        reference_run(str(tmp_path), entries, TEXT, conf, reduce_id=0)


def _flaky(base_cls, error_cls):
    class Flaky(base_cls):
        """A LocalFetchClient whose first ``fails`` fetches complete with
        a transport error."""

        def __init__(self, engine, fails):
            super().__init__(engine)
            self.fails = fails
            self.calls = 0

        def start_fetch(self, req, on_complete):
            self.calls += 1
            if self.fails > 0:
                self.fails -= 1
                on_complete(error_cls(f"injected fault on {req.map_id}"))
                return
            super().start_fetch(req, on_complete)
    return Flaky


def _faulty_run(root, mids, fails, port: bool):
    conf = dict(BASE, **{"uda.tpu.fetch.retries": 3})
    made = []

    def client_of(engine):
        made.append(flaky(engine, fails))
        return made[-1]

    if port:
        flaky = _flaky(LocalFetchClient, errors.TransportError)
        return port_run(root, mids, TEXT, conf, client_of), made[0].calls
    flaky = _flaky(JLocalFetchClient, jerrors.TransportError)
    return reference_run(root, mids, TEXT, conf, client_of), made[0].calls


def test_failed_fetches_are_retried_to_the_same_stream(tmp_path):
    mids = text_tree(str(tmp_path), "job", 3, 100, seed=11)
    clean = port_run(str(tmp_path), mids, TEXT, BASE)
    got, calls = _faulty_run(str(tmp_path), mids, 2, port=True)
    want, jcalls = _faulty_run(str(tmp_path), mids, 2, port=False)
    assert got == want == clean
    assert calls == jcalls


def test_a_fetch_that_always_fails_ends_in_fallback_in_both(tmp_path):
    mids = text_tree(str(tmp_path), "job", 2, 30, seed=13)
    with pytest.raises(errors.FallbackSignal) as got:
        _faulty_run(str(tmp_path), mids, 10**6, port=True)
    with pytest.raises(jerrors.FallbackSignal) as want:
        _faulty_run(str(tmp_path), mids, 10**6, port=False)
    assert type(got.value.cause).__name__ == \
        type(want.value.cause).__name__ == "TransportError"


@pytest.mark.parametrize("key,value", [
    ("uda.tpu.push.enable", True),
    ("uda.tpu.coding.scheme", "rs:2:3"),
    ("uda.tpu.fetch.resume", True),
    ("uda.tpu.fetch.speculate.pn", 95),
])
def test_unported_modes_raise_config_error(tmp_path, key, value):
    """Keys the port once refused now run to the reference's stream: the
    three survivable-fetch keys, and push (over the in-process
    LocalFetchClient, which has no push plane, both packages' arm_push
    leaves the task pull only)."""
    mids = text_tree(str(tmp_path), "job", 1, 5, seed=15)
    conf = dict(BASE, **{key: value})
    assert port_run(str(tmp_path), mids, TEXT, conf) == \
        reference_run(str(tmp_path), mids, TEXT, conf)


# -- the overlapped merger (the default) and streaming mode ------------------

CHUNK_1K = {"mapred.rdma.buf.size": 1}
MODES = {
    "default": {},
    "pipeline_off": {"uda.tpu.stage.pipeline": False},
    "streaming": {"uda.tpu.online.streaming": True},
}


def _mode_conf(tmp_path, mode: str, side: str, extra=None) -> dict:
    """The Config of one mode at 1 KB chunks; streaming spills under
    ``tmp_path/<side>``."""
    conf = dict(CHUNK_1K, **MODES[mode], **(extra or {}))
    if mode == "streaming":
        conf["uda.tpu.spill.dirs"] = str(tmp_path / f"spill_{side}")
    return conf


def _spill_left(tmp_path, side: str) -> list:
    root = tmp_path / f"spill_{side}"
    return os.listdir(root) if root.exists() else []


def _k1_engine(monkeypatch):
    """Route the port's overlapped merger through K1 (its plain version
    on the CPU) instead of the CPU's "auto" choice, the host engine."""
    from uda_tpu_torch.merger import merge_manager, overlap

    def pallas_merger(*args, **kwargs):
        return overlap.OverlappedMerger(*args, engine="pallas", **kwargs)

    monkeypatch.setattr(merge_manager, "OverlappedMerger", pallas_merger)


@pytest.mark.parametrize("engine", ["auto", "pallas"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("java_class", [TEXT, BYTES, LONG])
def test_overlapped_run_matches_reference(tmp_path, monkeypatch, java_class,
                                          mode, engine):
    """MergeManager.run under the default Config, with the pipeline off and
    in streaming mode, at 1 KB chunks: the same bytes and count as the
    reference; the run store is cleaned up."""
    if engine == "pallas":
        _k1_engine(monkeypatch)
    mids = mof_tree(str(tmp_path), java_class, seed=len(java_class) + 1)
    got = port_run(str(tmp_path), mids, java_class,
                   _mode_conf(tmp_path, mode, "port"))
    want = reference_run(str(tmp_path), mids, java_class,
                         _mode_conf(tmp_path, mode, "ref"))
    assert got[0] == want[0] == len(got[1]) > 1024
    assert got[1] == want[1]
    assert jcrack(got[1]).num_records == partition_records(
        str(tmp_path), mids, 1)
    assert not _spill_left(tmp_path, "port")


def _reference_drains_first(monkeypatch):
    """The reference's finish_streaming reads its overflow flag before it
    drains the stage threads (uda_tpu/merger/overlap.py:996-998): when no
    segment has been staged yet, it then merges a forest without the
    oversize segments and raises "fed 0 of N records". Drain first, so it
    takes the path the port always takes (the port reads the flag after
    the drain)."""
    from uda_tpu.merger.overlap import OverlappedMerger as JOM

    finish = JOM.finish_streaming

    def drained_first(self, *args, **kwargs):
        self._drain()
        self._drain = lambda: None
        return finish(self, *args, **kwargs)

    monkeypatch.setattr(JOM, "finish_streaming", drained_first)


@pytest.mark.parametrize("mode", ["default", "pipeline_off", "streaming"])
def test_overlapped_run_with_keys_past_the_width(tmp_path, monkeypatch,
                                                 mode):
    """Keys wider than uda.tpu.key.width: the overlap falls back to the
    global re-sort, streaming to the k-way merge over its run files, in
    the port as in the reference."""
    _reference_drains_first(monkeypatch)
    mids = text_tree(str(tmp_path), "job", 3, 150, seed=7, max_len=40)
    got = port_run(str(tmp_path), mids, TEXT,
                   _mode_conf(tmp_path, mode, "port"))
    assert got == reference_run(str(tmp_path), mids, TEXT,
                                _mode_conf(tmp_path, mode, "ref"))
    assert not _spill_left(tmp_path, "port")


def _faulty_mode_run(tmp_path, mids, fails, mode, port: bool):
    conf = _mode_conf(tmp_path, mode, "port" if port else "ref",
                      {"uda.tpu.fetch.retries": 3})
    made = []

    def client_of(engine):
        made.append(flaky(engine, fails))
        return made[-1]

    if port:
        flaky = _flaky(LocalFetchClient, errors.TransportError)
        return port_run(str(tmp_path), mids, TEXT, conf, client_of)
    flaky = _flaky(JLocalFetchClient, jerrors.TransportError)
    return reference_run(str(tmp_path), mids, TEXT, conf, client_of)


@pytest.mark.parametrize("mode", ["default", "streaming"])
def test_overlapped_run_retries_faults_to_the_same_stream(tmp_path, mode):
    mids = text_tree(str(tmp_path), "job", 3, 100, seed=11)
    got = _faulty_mode_run(tmp_path, mids, 2, mode, port=True)
    assert got == _faulty_mode_run(tmp_path, mids, 2, mode, port=False)
    assert got == port_run(str(tmp_path), mids, TEXT,
                           _mode_conf(tmp_path, mode, "port"))


@pytest.mark.parametrize("mode", ["default", "streaming"])
def test_overlapped_run_that_always_fails_ends_in_fallback(tmp_path,
                                                           monkeypatch,
                                                           mode):
    """A fetch that always fails: FallbackSignal in both, and the port's
    merger aborted with nothing left running, charged or spooled."""
    from uda_tpu_torch.merger import merge_manager, overlap
    from uda_tpu_torch.utils.metrics import metrics

    made = []

    def recorded(*args, **kwargs):
        made.append(overlap.OverlappedMerger(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(merge_manager, "OverlappedMerger", recorded)
    mids = text_tree(str(tmp_path), "job", 3, 30, seed=13)
    with pytest.raises(errors.FallbackSignal) as got:
        _faulty_mode_run(tmp_path, mids, 10**6, mode, port=True)
    with pytest.raises(jerrors.FallbackSignal) as want:
        _faulty_mode_run(tmp_path, mids, 10**6, mode, port=False)
    assert type(got.value.cause).__name__ == \
        type(want.value.cause).__name__ == "TransportError"
    om = made[0]
    assert om._aborted
    for t in om._threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert om.stats["inflight_bytes"] == 0
    assert metrics.get_gauge("stage.inflight.bytes") == 0
    assert not _spill_left(tmp_path, "port")


def test_a_failed_k1_merge_ends_in_fallback(tmp_path, monkeypatch):
    """K1 refused mid-run (a RuntimeError, as a failed launch raises):
    run() ends in FallbackSignal carrying a MergeError, not in the host
    engine's or the CPU's result."""
    from uda_tpu_torch.merger import overlap

    _k1_engine(monkeypatch)

    def refused(*args):
        raise RuntimeError("uda_merge_pass failed: CUDA error 700")

    monkeypatch.setattr(overlap.merge_ops, "merge_row_pair", refused)
    mids = text_tree(str(tmp_path), "job", 3, 40, seed=29)
    with pytest.raises(errors.FallbackSignal) as got:
        port_run(str(tmp_path), mids, TEXT, CHUNK_1K)
    assert isinstance(got.value.cause, errors.MergeError)
    assert "CUDA error 700" in str(got.value.cause)


@pytest.mark.parametrize("where,mode", [("refused_shape", "default"),
                                        ("refused_shape", "pipeline_off"),
                                        ("readback", "default"),
                                        ("readback", "streaming")])
def test_any_k1_failure_ends_in_fallback(tmp_path, monkeypatch, where,
                                         mode):
    """Not only a RuntimeError: K1 refusing its operands (a ValueError, as
    merge_pass does past 31 row words) and a failed readback of the merged
    rows during emission both end in FallbackSignal carrying a
    MergeError, with the run store cleaned up."""
    from uda_tpu_torch.merger import overlap
    from uda_tpu_torch.ops import merge as tmerge

    _k1_engine(monkeypatch)
    if where == "refused_shape":
        def refused(*args, **kwargs):
            raise ValueError("merge_pass takes 1 to 31 key words, got 32")

        monkeypatch.setattr(tmerge, "merge_sorted_pair", refused)
    else:
        def lost(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(overlap.stream_mod, "iter_row_slabs", lost)
    mids = text_tree(str(tmp_path), "job", 3, 40, seed=37)
    with pytest.raises(errors.FallbackSignal) as got:
        port_run(str(tmp_path), mids, TEXT, _mode_conf(tmp_path, mode,
                                                       "port"))
    assert isinstance(got.value.cause, errors.MergeError)
    assert not _spill_left(tmp_path, "port")


@pytest.mark.parametrize("conf,on_k1", [
    ({}, True),
    ({"uda.tpu.online.streaming": True}, True),
    ({"uda.tpu.merge.overlap": False}, True),
    ({"uda.tpu.merge.overlap": False, "uda.tpu.merge.two_phase": "off"},
     False),
])
def test_key_widths_k1_cannot_carry_are_refused_on_the_card(
        tmp_path, monkeypatch, conf, on_k1):
    """K1's rows hold at most 31 words (28 key words + 3): on the card a
    wider ``uda.tpu.key.width`` is refused with ConfigError at
    construction wherever K1 would merge, and left to the whole re-sort
    where it would not. On the CPU the host engine takes any width."""
    engine = DataEngine(DirIndexResolver(str(tmp_path)))
    try:
        MergeManager(LocalFetchClient(engine), TEXT,
                     Config(dict(conf, **{"uda.tpu.key.width": 128})),
                     device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        MergeManager(LocalFetchClient(engine), TEXT,
                     Config(dict(conf, **{"uda.tpu.key.width": 112})))
        wide = Config(dict(conf, **{"uda.tpu.key.width": 116}))
        if on_k1:
            with pytest.raises(errors.ConfigError,
                               match=r"key\.width=116 .* at most 31"):
                MergeManager(LocalFetchClient(engine), TEXT, wide)
        else:
            MergeManager(LocalFetchClient(engine), TEXT, wide)
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", ["default", "pipeline_off", "streaming"])
def test_overlapped_run_with_empty_partitions(tmp_path, mode):
    """Maps whose partition is empty, a reducer with one non-empty map and
    a reducer whose every partition is empty."""
    rng = np.random.default_rng(31)
    w = jwriter.MOFWriter(str(tmp_path), "job")
    recs = sorted(((encode_vlong(3) + rng.bytes(3), rng.bytes(20))
                   for _ in range(50)), key=lambda kv: kv[0][1:])
    w.write("m0", [[], recs, []])
    w.write("m1", [[], [], []])
    w.write("m2", [recs[:7], recs[7:], []])
    for reduce_id in (0, 1, 2):
        got = port_run(str(tmp_path), ["m0", "m1", "m2"], TEXT,
                       _mode_conf(tmp_path, mode, "port"),
                       reduce_id=reduce_id)
        assert got == reference_run(str(tmp_path), ["m0", "m1", "m2"], TEXT,
                                    _mode_conf(tmp_path, mode, "ref"),
                                    reduce_id=reduce_id)
    assert not _spill_left(tmp_path, "port")


def test_manager_needs_a_card_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = DataEngine(DirIndexResolver(str(tmp_path)))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MergeManager(LocalFetchClient(engine), TEXT, Config(BASE))
    finally:
        engine.stop()


def test_segment_carries_records_across_chunks(tmp_path):
    """A segment at 1 KB chunks carries split records across chunks and
    counts every record; a chunk read from the engine reports the
    partition's lengths from the index."""
    mids = text_tree(str(tmp_path), "job", 2, 60, seed=17)
    engine = DataEngine(DirIndexResolver(str(tmp_path)))
    try:
        client = LocalFetchClient(engine)
        seg = Segment(client, "job", mids[0], 0, 1024)
        seg.start()
        seg.wait(timeout=30)
        batch = seg.record_batch()
        want = jcrack(open(os.path.join(tmp_path, "job", mids[0],
                                        "file.out"), "rb").read())
        assert batch.num_records == seg.num_records == 60
        assert [batch.key(i) for i in range(60)] == \
            [want.key(i) for i in range(60)]
        res = engine.submit(ShuffleRequest("job", mids[0], 0, 0,
                                           1 << 20)).result(timeout=30)
        assert res.is_last and res.raw_length == res.part_length == \
            seg.raw_length == len(res.data)
    finally:
        engine.stop()


def test_a_fetch_that_never_completes_times_out_and_retries(tmp_path):
    """The first fetch is swallowed by the transport: the attempt timeout
    fails it, the segment refetches, and the stream is the clean one; a
    completion that arrives after its attempt timed out is dropped."""
    mids = text_tree(str(tmp_path), "job", 2, 60, seed=19)
    late = []

    class Silent(LocalFetchClient):
        def start_fetch(self, req, on_complete):
            if not late:
                late.append((req, on_complete))
                return
            super().start_fetch(req, on_complete)

    conf = dict(BASE, **{"mapred.rdma.fetch.attempt.timeout.ms": 100,
                         "mapred.rdma.fetch.retry.backoff.ms": 10})
    got = port_run(str(tmp_path), mids, TEXT, conf, Silent)
    assert got == port_run(str(tmp_path), mids, TEXT, BASE)
    req, on_complete = late[0]
    on_complete(errors.TransportError("late"))  # stale: ignored


@pytest.mark.parametrize("ops", [
    "pp f pp ff p", "p p p f f f f", "pppp ffff pp"])
def test_penalty_box_matches_reference(ops):
    """Punish (p), forgive (f) and the box state after each step, against
    the reference's PenaltyBox (threshold 2, a long penalty)."""
    from uda_tpu.merger import PenaltyBox as JPenaltyBox
    from uda_tpu_torch.merger import PenaltyBox

    mine, ref = PenaltyBox(2, 60.0), JPenaltyBox(2, 60.0)
    for op in ops.replace(" ", ""):
        if op == "p":
            assert mine.punish("h") == ref.punish("h")
        else:
            mine.forgive("h")
            ref.forgive("h")
        assert mine.faults("h") == ref.faults("h")
        assert mine.penalized("h") == ref.penalized("h")


def test_empty_partitions_match_reference(tmp_path):
    """Maps whose partition for this reducer is empty (an IFile of just
    the EOF marker), and a reducer with a single non-empty map: the port
    emits what the reference emits, with and without the two-phase
    merge."""
    rng = np.random.default_rng(23)
    w = jwriter.MOFWriter(str(tmp_path), "job")
    recs = sorted(((encode_vlong(3) + rng.bytes(3), rng.bytes(20))
                   for _ in range(50)), key=lambda kv: kv[0][1:])
    w.write("m0", [[], recs])
    w.write("m1", [[], []])
    w.write("m2", [recs[:7], recs[7:]])
    for two_phase in ("on", "off"):
        conf = dict(BASE, **{"uda.tpu.merge.two_phase": two_phase})
        for reduce_id in (0, 1):
            got = port_run(str(tmp_path), ["m0", "m1", "m2"], TEXT, conf,
                           reduce_id=reduce_id)
            assert got == reference_run(str(tmp_path), ["m0", "m1", "m2"],
                                        TEXT, conf, reduce_id=reduce_id)
