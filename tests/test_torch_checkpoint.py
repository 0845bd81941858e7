"""The port's crash-consistent checkpoint/resume (uda_tpu_torch.merger.
checkpoint, ``uda.tpu.ckpt.dir``) against the JAX package's: run files,
CRCs and manifests byte-identical to the reference's for the same input;
each package loads the other's manifest; a torn manifest (the
``ckpt.save`` truncate) falls back to the previous one, a ``ckpt.load``
fault starts fresh, a manifest of a later epoch is refused, a changed
supplier generation drops the offset ledger but keeps the runs; and a
task whose first attempt died resumes byte-identical to an uninterrupted
run, refetching no checkpointed map, from the port's own checkpoint and
from the reference's."""

import glob
import os
import threading

import numpy as np
import pytest

from helpers import make_mof_tree, map_ids
from test_torch_merge_manager import LONG, TEXT, text_tree
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.merger import checkpoint as jckpt
from uda_tpu.merger.streaming import RunStore as JRunStore
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import crack as jcrack
from uda_tpu.utils.ifile import write_records
from uda_tpu_torch.merger import LocalFetchClient, MergeManager, Segment
from uda_tpu_torch.merger import checkpoint as tckpt
from uda_tpu_torch.merger.emitter import frame_batch
from uda_tpu_torch.merger.segment import InputClient
from uda_tpu_torch.merger.streaming import RunStore
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                     ShuffleRequest)
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.ifile import EOF_MARKER, crack, crack_partial
from uda_tpu_torch.utils.metrics import metrics

RAW = "uda.tpu.RawBytes"


def _recs(n, seed=0, key_bytes=10, val_bytes=24):
    rng = np.random.default_rng(seed)
    return [(rng.bytes(key_bytes), rng.bytes(val_bytes)) for _ in range(n)]


def _counter(name: str) -> float:
    return float(metrics.snapshot().get(name, 0))


# -- run files ----------------------------------------------------------------

@pytest.mark.parametrize("order", ["identity", "reversed"])
def test_run_files_and_crcs_equal_the_reference(tmp_path, order):
    """The same segment spooled by both stores: the same run file,
    sidecar and CRC; cleanup of a fixed directory keeps them; adopt and
    discard keep the books."""
    recs = sorted(_recs(40, seed=1))
    data = write_records(recs)
    n = len(recs)
    perm = (np.arange(n, dtype=np.int64) if order == "identity"
            else np.arange(n - 1, -1, -1, dtype=np.int64))
    got = RunStore(tag="t", fixed_dir=str(tmp_path / "port"))
    want = JRunStore(tag="t", fixed_dir=str(tmp_path / "ref"))
    got.write_run(3, crack(data), perm)
    want.write_run(3, jcrack(data), perm)
    assert got.manifest() == want.manifest()
    for a, b in zip(got._paths(3), want._paths(3)):
        assert open(a, "rb").read() == open(b, "rb").read()
    got.cleanup()
    assert all(os.path.exists(p) for p in got._paths(3))
    n_, nbytes, crc = got.manifest()[3]
    again = RunStore(tag="t", fixed_dir=str(tmp_path / "port"))
    again.adopt(3, n_, nbytes, crc)
    with pytest.raises(errors.MergeError):
        again.adopt(3, n_, nbytes, crc)
    assert again.manifest() == {3: (n_, nbytes, crc)}
    again.discard(4)                     # nothing there: no error
    RunStore(tag="t", fixed_dir=str(tmp_path / "port")).discard(3)
    assert not any(os.path.exists(p) for p in got._paths(3))


def test_read_run_validates_as_the_reference(tmp_path):
    store = JRunStore(tag="t", fixed_dir=str(tmp_path))
    recs = sorted(_recs(25, seed=2))
    store.write_run(0, jcrack(write_records(recs)),
                    np.arange(25, dtype=np.int64))
    n, nbytes, crc = store.manifest()[0]
    rec = {"records": n, "bytes": nbytes, "crc": crc,
           "length": nbytes + tckpt.RUN_EOF_LEN}
    run_path, off_path = store._paths(0)
    batch = tckpt.read_run(run_path, off_path, rec)
    assert list(batch.iter_records()) == recs
    for bad in (dict(rec, crc=crc ^ 1), dict(rec, length=rec["length"] + 1),
                dict(rec, records=n + 1)):
        with pytest.raises(errors.StorageError) as got:
            tckpt.read_run(run_path, off_path, bad)
        with pytest.raises(jerrors.StorageError) as want:
            jckpt.read_run(run_path, off_path, bad)
        assert str(got.value) == str(want.value)


# -- the segment's offset ledger ------------------------------------------------

class _Null(InputClient):
    def start_fetch(self, req, on_complete):
        raise AssertionError("no fetch expected")


def test_segment_ledger_round_trip_and_mismatch():
    recs = _recs(30, seed=3)
    framed = write_records(recs)[:-len(EOF_MARKER)]
    carry = write_records(_recs(1, seed=4))[:3]  # a torn record head
    data = framed + carry
    seg = Segment(_Null(), "j", "m_0", 0, 1 << 16)
    seg.ckpt_preload(data=data, carry_len=len(carry), next_offset=len(data),
                     raw_length=4096, num_records=30)
    ex = seg.ckpt_export()
    assert ex == {"next_offset": len(data), "raw_length": 4096,
                  "num_records": 30, "carry_len": len(carry), "data": data}
    assert Segment(_Null(), "j", "m_0", 0, 1).ckpt_export() is None
    with pytest.raises(errors.StorageError):   # record count drifted
        Segment(_Null(), "j", "m_0", 0, 1).ckpt_preload(
            data=framed, carry_len=0, next_offset=len(framed),
            raw_length=None, num_records=31)
    with pytest.raises(errors.StorageError):   # carry past the payload
        Segment(_Null(), "j", "m_0", 0, 1).ckpt_preload(
            data=b"xy", carry_len=5, next_offset=2, raw_length=None,
            num_records=0)


@pytest.mark.parametrize("raw_shift", [0, 1])
def test_a_preloaded_segment_resumes_at_its_offset(tmp_path, raw_shift):
    """The first fetch is issued at next_offset, only the tail moves, the
    records equal a whole fetch; a ledger whose partition changed
    identity (raw_length) restarts from zero and still ends equal."""
    make_mof_tree(str(tmp_path), "jobL", 1, 1, 400, seed=7)
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    offsets = []

    class Watch(LocalFetchClient):
        def start_fetch(self, req, on_complete):
            offsets.append(req.offset)
            super().start_fetch(req, on_complete)

    try:
        mid = map_ids("jobL", 1)[0]
        res = engine.submit(ShuffleRequest("jobL", mid, 0, 0, 2048)).result()
        first = bytes(res.data)
        assert not res.is_last
        batch, consumed, _ = crack_partial(first, expect_eof=False)
        seg = Segment(Watch(engine), "jobL", mid, 0, 2048)
        seg.ckpt_preload(
            data=frame_batch(batch, write_eof=False) + first[consumed:],
            carry_len=len(first) - consumed, next_offset=len(first),
            raw_length=res.raw_length + raw_shift,
            num_records=batch.num_records)
        b0 = _counter("fetch.resumed.bytes")
        seg.start()
        seg.wait()
        full = Segment(LocalFetchClient(engine), "jobL", mid, 0, 1 << 20)
        full.start()
        full.wait()
        assert list(seg.record_batch().iter_records()) == \
            list(full.record_batch().iter_records())
        assert offsets[0] == len(first)
        assert _counter("fetch.resumed.bytes") == b0 + len(first)
        assert (0 in offsets) == bool(raw_shift)
    finally:
        engine.stop()


# -- manifests ----------------------------------------------------------------

def _collect(runs=None, ledgers=None, parts=None, maps=("m_0",)):
    def collect():
        return ({"maps": list(maps), "runs": dict(runs or {}),
                 "ledgers": {k: dict(v) for k, v in (ledgers or {}).items()},
                 "journal": [{"kind": "fault", "supplier": "h",
                              "map_id": "m_0", "error": "TransportError"}],
                 "penalty": {"faults": {"h": 1}, "streaks": {}},
                 "forest": {}},
                dict(parts or {}))
    return collect


def test_manifests_equal_the_reference_and_cross_load(tmp_path):
    """The same snapshot written by both: the same manifest and part files
    byte for byte; each package loads (and consumes) the other's."""
    args = dict(runs={"0": {"map": "m_0", "records": 1}},
                ledgers={"1": {"map": "m_1"}}, parts={1: b"ledger" * 9})
    got = tckpt.TaskCheckpoint(str(tmp_path / "port"), "jobM", 0,
                               interval_s=0.0)
    want = jckpt.TaskCheckpoint(str(tmp_path / "ref"), "jobM", 0,
                                interval_s=0.0)
    for _ in range(2):
        got.save(_collect(**args))
        want.save(_collect(**args))
    for sub in ("manifest-00000002.uckp", "parts/p00000002-s00001.part"):
        assert open(os.path.join(got.task_dir, sub), "rb").read() == \
            open(os.path.join(want.task_dir, sub), "rb").read()
    man = tckpt.TaskCheckpoint(str(tmp_path / "ref"), "jobM", 0).load()
    jman = jckpt.TaskCheckpoint(str(tmp_path / "port"), "jobM", 0).load()
    assert man == jman and man["seq"] == 2
    assert tckpt.TaskCheckpoint(str(tmp_path / "ref"), "jobM",
                                0).part_bytes(man["ledgers"]["1"]) \
        == b"ledger" * 9
    # consumed on load: a second claimant finds the older generation
    assert tckpt.TaskCheckpoint(str(tmp_path / "ref"), "jobM",
                                0).load()["seq"] == 1


def test_torn_manifest_through_the_save_failpoint(tmp_path):
    ck = tckpt.TaskCheckpoint(str(tmp_path), "jobF", 2, interval_s=0.0)
    ck.save(_collect(runs={"0": {"gen": 1}}))
    with failpoints.scoped("ckpt.save=truncate"):
        ck.save(_collect(runs={"0": {"gen": 2}}))
    t0 = _counter("ckpt.invalidated")
    man = tckpt.TaskCheckpoint(str(tmp_path), "jobF", 2).load()
    assert man is not None and man["runs"]["0"]["gen"] == 1
    assert _counter("ckpt.invalidated") == t0 + 1


def test_save_errors_are_absorbed_and_load_errors_start_fresh(tmp_path):
    ck = tckpt.TaskCheckpoint(str(tmp_path), "jobE", 3, interval_s=0.0)
    e0 = _counter("ckpt.save.errors")
    with failpoints.scoped("ckpt.save=error"):
        assert ck.maybe_save(_collect(), force=True) is False
    assert _counter("ckpt.save.errors") == e0 + 1
    assert ck.maybe_save(_collect(), force=True) is True
    with failpoints.scoped("ckpt.load=error"):
        assert tckpt.TaskCheckpoint(str(tmp_path), "jobE", 3).load() is None
    assert tckpt.TaskCheckpoint(str(tmp_path), "jobE", 3).load() is not None


def test_interval_rate_limits_saves(tmp_path):
    ck = tckpt.TaskCheckpoint(str(tmp_path), "jobI", 0, interval_s=3600)
    assert ck.maybe_save(_collect(), force=True) is True
    assert ck.maybe_save(_collect()) is False
    assert ck.maybe_save(_collect(), force=True) is True


def test_epoch_fence_and_prune(tmp_path):
    ck2 = jckpt.TaskCheckpoint(str(tmp_path), "jobZ", 5, interval_s=0.0,
                               epoch=2)
    ck2.save(_collect())
    assert tckpt.TaskCheckpoint(str(tmp_path), "jobZ", 5,
                                epoch=1).load() is None
    assert tckpt.TaskCheckpoint(str(tmp_path), "jobZ", 5,
                                epoch=2).load() is not None
    ck = tckpt.TaskCheckpoint(str(tmp_path), "jobP", 6, interval_s=0.0,
                              keep=2)
    for g in range(5):
        ck.save(_collect(ledgers={"0": {"map": "m_0"}},
                         parts={0: b"x%d" % g}))
    assert len(glob.glob(os.path.join(ck.task_dir, "manifest-*"))) == 2
    assert sorted(os.listdir(ck.parts_dir)) == \
        ["p00000004-s00000.part", "p00000005-s00000.part"]


def test_generation_mismatch_drops_the_ledger_keeps_the_runs(tmp_path):
    make_mof_tree(str(tmp_path / "mof"), "jobD", 2, 1, 60, seed=9)
    engine = DataEngine(DirIndexResolver(str(tmp_path / "mof")), Config())
    try:
        class GenClient(LocalFetchClient):
            def generation(self, host=""):
                return 7  # the supplier restarted since the manifest

        mm = MergeManager(GenClient(engine), RAW, Config(), device="cpu")
        mids = map_ids("jobD", 2)
        ck = tckpt.TaskCheckpoint(str(tmp_path), "jobD", 0, interval_s=0.0)
        store = RunStore(tag="jobD.r0", fixed_dir=ck.runs_dir)
        recs = sorted(_recs(20, seed=10))
        store.write_run(0, crack(write_records(recs)),
                        np.arange(20, dtype=np.int64))
        n, nbytes, crc = store.manifest()[0]
        part = write_records(_recs(5, seed=11))[:-len(EOF_MARKER)]
        ck.save(_collect(
            runs={"0": {"map": mids[0], "records": n, "bytes": nbytes,
                        "length": nbytes + len(EOF_MARKER), "crc": crc}},
            ledgers={"1": {"map": mids[1], "host": "", "generation": 3,
                           "next_offset": len(part), "carry_len": 0,
                           "raw_length": None, "num_records": 5}},
            parts={1: part}, maps=mids))
        man = tckpt.TaskCheckpoint(str(tmp_path), "jobD", 0).load()

        class Forest:
            adopted = []

            def adopt_run(self, i, batch):
                self.adopted.append((i, batch.num_records))

        g0 = _counter("ckpt.invalidated")
        adopted, preload, nrec = mm._resume_from_manifest(
            man, mids, RunStore(tag="jobD.r0", fixed_dir=ck.runs_dir),
            Forest(), ck)
        assert (adopted, preload, nrec) == ({0}, {}, 20)
        assert Forest.adopted == [(0, 20)]
        assert _counter("ckpt.invalidated") == g0 + 1
        # the journal and penalty box came back
        assert mm.ledger.events("fault")
        assert mm.penalty_box.faults("h") == 1
    finally:
        engine.stop()


# -- resume end to end -----------------------------------------------------------

class _Counting:
    """Counts start_fetch per map; one map's fetch fails after ``delay``
    seconds (so the other maps are fetched and spooled first)."""

    def __init__(self, engine, bad=None, error=None, delay=0.3):
        super().__init__(engine)
        self.fetches: dict = {}
        self.bad, self.error, self.delay = bad, error, delay

    def start_fetch(self, req, on_complete):
        self.fetches[req.map_id] = self.fetches.get(req.map_id, 0) + 1
        if req.map_id == self.bad:
            threading.Timer(self.delay, on_complete,
                            args=(self.error(f"{req.map_id} lost"),)).start()
            return
        super().start_fetch(req, on_complete)


class _PortCounting(_Counting, LocalFetchClient):
    pass


class _RefCounting(_Counting, JLocalFetchClient):
    pass


def _ckpt_run(root, ckdir, mids, java_class, port=True, bad=None,
              extra=None, fault=""):
    """One attempt of a streaming task with a checkpoint under ``ckdir``:
    (stream or None, the client, the FallbackSignal or None)."""
    conf = dict({"uda.tpu.online.streaming": True,
                 "uda.tpu.ckpt.dir": ckdir, "uda.tpu.ckpt.interval.s": 0.0,
                 "uda.tpu.fetch.retries": 0, "mapred.rdma.buf.size": 1},
                **(extra or {}))
    out = bytearray()
    if port:
        engine = DataEngine(DirIndexResolver(root), Config(conf))
        client = _PortCounting(engine, bad, errors.TransportError)
        mm = MergeManager(client, java_class, Config(conf), device="cpu")
        sig, reg = errors.FallbackSignal, failpoints
    else:
        engine = JDataEngine(JDirIndexResolver(root), JConfig(conf))
        client = _RefCounting(engine, bad, jerrors.TransportError)
        mm = JMergeManager(client, java_class, JConfig(conf))
        sig, reg = jerrors.FallbackSignal, jfailpoints
    try:
        with reg.scoped(fault):
            mm.run("job", mids, 0, out.extend)
        return bytes(out), client, None
    except sig as e:
        return None, client, e
    finally:
        engine.stop()


def _manifest_maps(ckdir) -> list:
    """Maps whose runs the newest manifest on disk records (read without
    consuming it)."""
    paths = sorted(glob.glob(os.path.join(ckdir, "*", "manifest-*.uckp")))
    assert paths, "no manifest survived the failed attempt"
    man = tckpt.TaskCheckpoint._read_manifest(paths[-1])
    assert man is not None
    return [rec["map"] for rec in man.get("runs", {}).values()]


def _tree(root, java_class) -> list:
    if java_class == TEXT:
        return text_tree(root, "job", 6, 60, seed=19)
    make_mof_tree(root, "job", 6, 1, 120, seed=5, key_bytes=8,
                  val_bytes=40)
    return map_ids("job", 6)


@pytest.mark.parametrize("first,java_class", [
    ("port", TEXT), ("port", LONG), ("ref", TEXT), ("ref", LONG)])
def test_resume_is_byte_identical_and_refetches_nothing(tmp_path, first,
                                                        java_class):
    """Attempt 1 (the port's, or the reference's: the cross-package
    resume) dies on a lost map; the port's attempt 2 resumes from that
    checkpoint: byte-identical to an uninterrupted run of either package,
    no checkpointed map fetched again, the checkpoint gone after the
    success."""
    root = str(tmp_path / "mof")
    mids = _tree(root, java_class)
    clean, _, err = _ckpt_run(root, str(tmp_path / "ck0"), mids,
                              java_class)
    assert err is None
    ref_clean, _, err = _ckpt_run(root, str(tmp_path / "ckr"), mids,
                                  java_class, port=False)
    assert err is None and ref_clean == clean
    ckdir = str(tmp_path / "ck")
    _, _, err1 = _ckpt_run(root, ckdir, mids, java_class,
                           port=first == "port", bad=mids[-1])
    assert err1 is not None
    assert type(err1.cause).__name__ == "TransportError"
    checkpointed = _manifest_maps(ckdir)
    assert checkpointed and mids[-1] not in checkpointed
    r0, a0 = _counter("ckpt.resumed"), _counter("ckpt.runs.adopted")
    out, client, err2 = _ckpt_run(root, ckdir, mids, java_class)
    assert err2 is None
    assert out == clean
    assert _counter("ckpt.resumed") == r0 + 1
    assert _counter("ckpt.runs.adopted") >= a0 + len(checkpointed)
    for mid in checkpointed:
        assert client.fetches.get(mid, 0) == 0, f"{mid} was fetched again"
    assert not os.path.exists(os.path.join(ckdir, "job.r0"))


def test_resume_through_k1_matches(tmp_path, monkeypatch):
    """Adopted runs join the overlapped merger's K1 forest (its plain
    version on the CPU) before any feed: still byte-identical."""
    from uda_tpu_torch.merger import merge_manager, overlap

    def pallas_merger(*args, **kwargs):
        return overlap.OverlappedMerger(*args, engine="pallas", **kwargs)

    monkeypatch.setattr(merge_manager, "OverlappedMerger", pallas_merger)
    root = str(tmp_path / "mof")
    mids = _tree(root, TEXT)
    clean, _, _ = _ckpt_run(root, str(tmp_path / "ck0"), mids, TEXT,
                            port=False)
    ckdir = str(tmp_path / "ck")
    _ckpt_run(root, ckdir, mids, TEXT, bad=mids[-1])
    assert _manifest_maps(ckdir)
    out, _, err = _ckpt_run(root, ckdir, mids, TEXT)
    assert err is None and out == clean


def test_a_torn_newest_manifest_resumes_from_the_one_before(tmp_path):
    """Attempt 1 saves with every second manifest torn (the ckpt.save
    truncate); attempt 2 skips a torn newest manifest, never fails on it,
    and still ends byte-identical."""
    root = str(tmp_path / "mof")
    mids = _tree(root, LONG)
    clean, _, _ = _ckpt_run(root, str(tmp_path / "ck0"), mids, LONG)
    ckdir = str(tmp_path / "ck")
    _, _, err1 = _ckpt_run(root, ckdir, mids, LONG, bad=mids[-1],
                           fault="ckpt.save=truncate:every:2")
    assert err1 is not None
    out, _, err2 = _ckpt_run(root, ckdir, mids, LONG)
    assert err2 is None and out == clean


@pytest.mark.parametrize("fault", ["ckpt.save=error", "ckpt.load=error"])
def test_checkpoint_faults_never_fail_the_task(tmp_path, fault):
    root = str(tmp_path / "mof")
    mids = _tree(root, LONG)
    clean, _, _ = _ckpt_run(root, str(tmp_path / "ck0"), mids, LONG)
    ckdir = str(tmp_path / "ck")
    if fault.startswith("ckpt.load"):
        _ckpt_run(root, ckdir, mids, LONG, bad=mids[-1])
    out, _, err = _ckpt_run(root, ckdir, mids, LONG, fault=fault)
    assert err is None and out == clean


def test_a_banked_ledger_resumes_mid_partition(tmp_path):
    """A manifest holding only a mid-partition offset ledger (map 0's
    first chunk): the resumed fetch starts at next_offset and the output
    is still byte-identical."""
    root = str(tmp_path / "mof")
    make_mof_tree(root, "job", 6, 1, 400, seed=8, key_bytes=8)
    mids = map_ids("job", 6)
    extra = {"mapred.rdma.buf.size": 2}
    clean, _, _ = _ckpt_run(root, str(tmp_path / "ck0"), mids, LONG,
                            extra=extra)
    engine = DataEngine(DirIndexResolver(root), Config())
    try:
        res = engine.submit(ShuffleRequest("job", mids[0], 0, 0,
                                           2048)).result()
    finally:
        engine.stop()
    first = bytes(res.data)
    batch, consumed, _ = crack_partial(first, expect_eof=False)
    ckdir = str(tmp_path / "ck")
    jckpt.TaskCheckpoint(ckdir, "job", 0, interval_s=0.0).save(lambda: (
        {"maps": list(mids), "runs": {},
         "ledgers": {"0": {"map": mids[0], "host": "", "generation": None,
                           "next_offset": len(first),
                           "carry_len": len(first) - consumed,
                           "raw_length": res.raw_length,
                           "num_records": batch.num_records}},
         "journal": [], "penalty": {}, "forest": {}},
        {0: frame_batch(batch, write_eof=False) + first[consumed:]}))
    b0 = _counter("fetch.resumed.bytes")
    out, client, err = _ckpt_run(root, ckdir, mids, LONG, extra=extra)
    assert err is None and out == clean
    assert _counter("fetch.resumed.bytes") >= b0 + len(first)
