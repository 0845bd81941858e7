"""The port's reduce task (uda_tpu_torch.merger.MergeManager.run with
``uda.tpu.merge.overlap=false``) against the JAX package's on the same MOF
tree and the same Config: the emitted IFile byte streams and the returned
byte counts must be identical, across ``uda.tpu.merge.two_phase``, 1 KB
fetch chunks (records split across chunks), three key types, fetch faults
and retries. Configs asking for a mode the port does not have raise."""

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
    ("uda.tpu.merge.overlap", True),
    ("uda.tpu.online.streaming", True),
    ("mapred.netmerger.merge.approach", 0),
    ("mapred.netmerger.merge.approach", 2),
    ("uda.tpu.ckpt.dir", "/nonexistent/ckpt"),
    ("uda.tpu.push.enable", True),
    ("uda.tpu.coding.scheme", "rs:2:3"),
    ("uda.tpu.failpoints", "segment.fetch=error"),
    ("uda.tpu.watchdog.stall.s", 5.0),
])
def test_unported_modes_raise_config_error(tmp_path, key, value):
    mids = text_tree(str(tmp_path), "job", 1, 5, seed=15)
    conf = dict(BASE, **{key: value})
    with pytest.raises(errors.ConfigError, match=key.replace(".", r"\.")):
        port_run(str(tmp_path), mids, TEXT, conf)


def test_default_config_refuses_the_overlapped_merge(tmp_path):
    engine = DataEngine(DirIndexResolver(str(tmp_path)))
    try:
        mm = MergeManager(LocalFetchClient(engine), TEXT, device="cpu")
        with pytest.raises(errors.ConfigError, match="overlap"):
            mm.run("job", [], 0, lambda b: None)
    finally:
        engine.stop()


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
