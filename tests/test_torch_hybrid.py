"""The port's hybrid LPQ/RPQ merge (``mapred.netmerger.merge.approach=2``,
uda_tpu_torch.merger.hybrid) against the JAX package's on the same MOF
tree and the same Config: the emitted IFile bytes and byte counts are
identical for the three key types, at 1 KB and 1 MB fetch chunks, with
LPQs of any size, with keys past the width, and through K1 (its plain
version on the CPU) in every LPQ; a failing LPQ ends in FallbackSignal
with the same error class in both packages and leaves no spill file; a
failing K1 in an LPQ is a MergeError."""

import os

import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from test_torch_merge_manager import (BYTES, LONG, TEXT, mof_tree,
                                      partition_records, port_run,
                                      reference_run, text_tree, _flaky)
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger.hybrid import num_lpqs_for as jnum_lpqs_for
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.ifile import crack as jcrack
from uda_tpu_torch.merger import LocalFetchClient
from uda_tpu_torch.merger.hybrid import num_lpqs_for
from uda_tpu_torch.ops import merge as tmerge
from uda_tpu_torch.utils import errors

HYBRID = {"mapred.netmerger.merge.approach": 2}


def _conf(tmp_path, side: str, **extra) -> dict:
    """Hybrid at 1 KB chunks, spilling under ``tmp_path/<side>``."""
    return dict(HYBRID, **{"mapred.rdma.buf.size": 1,
                           "uda.tpu.spill.dirs": str(tmp_path / side)},
                **extra)


def _spills(tmp_path, side: str) -> list:
    root = tmp_path / side
    return os.listdir(root) if root.exists() else []


@pytest.mark.parametrize("maps,lpq_size", [(1, 0), (4, 0), (9, 0), (10, 0),
                                           (64, 0), (16, 4), (7, 3),
                                           (5, 10)])
def test_num_lpqs_matches_reference(maps, lpq_size):
    assert num_lpqs_for(maps, lpq_size) == jnum_lpqs_for(maps, lpq_size)


@pytest.mark.parametrize("lpq_size", [0, 1, 3])
@pytest.mark.parametrize("java_class", [TEXT, BYTES, LONG])
def test_hybrid_matches_reference(tmp_path, java_class, lpq_size):
    """LPQs of sqrt(maps), of one map and of three, for the three key
    types: the same bytes as the reference, every record of the partition,
    and no spill file left on either side."""
    mids = mof_tree(str(tmp_path / "mof"), java_class, seed=len(java_class))
    extra = {"mapred.netmerger.hybrid.lpq.size": lpq_size}
    got = port_run(str(tmp_path / "mof"), mids, java_class,
                   _conf(tmp_path, "port", **extra))
    want = reference_run(str(tmp_path / "mof"), mids, java_class,
                         _conf(tmp_path, "ref", **extra))
    assert got[0] == want[0] == len(got[1]) > 1024
    assert got[1] == want[1]
    assert jcrack(got[1]).num_records == partition_records(
        str(tmp_path / "mof"), mids, 1)
    assert not _spills(tmp_path, "port")


def test_hybrid_at_default_chunks_with_host_entries(tmp_path):
    mids = text_tree(str(tmp_path / "mof"), "job", 5, 80, seed=3)
    entries = [("", m) for m in mids]
    conf = dict(HYBRID, **{"mapred.rdma.num.parallel.lpqs": 1})
    assert port_run(str(tmp_path / "mof"), entries, TEXT, conf,
                    reduce_id=0) == \
        reference_run(str(tmp_path / "mof"), entries, TEXT, conf,
                      reduce_id=0)


def test_hybrid_with_keys_past_the_width(tmp_path):
    """Text keys wider than uda.tpu.key.width: each LPQ's two-phase merge
    falls back to the whole re-sort, in the port as in the reference."""
    mids = text_tree(str(tmp_path / "mof"), "job", 5, 120, seed=7,
                     max_len=40)
    extra = {"uda.tpu.merge.two_phase": "on"}
    assert port_run(str(tmp_path / "mof"), mids, TEXT,
                    _conf(tmp_path, "port", **extra)) == \
        reference_run(str(tmp_path / "mof"), mids, TEXT,
                      _conf(tmp_path, "ref", **extra))


@pytest.mark.parametrize("java_class", [TEXT, LONG])
def test_hybrid_lpqs_through_k1_match_reference(tmp_path, monkeypatch,
                                                java_class):
    """Every LPQ merged by the two-phase merge tree on K1 (its plain
    version on the CPU), three LPQs at a time on pool threads: the same
    bytes as the reference's."""
    calls = []
    real = tmerge.merge_row_pair

    def counted(*args, **kwargs):
        calls.append(args[4] if len(args) > 4 else kwargs.get("engine"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tmerge, "resolve_run_engine",
                        lambda engine, device=None: "pallas")
    monkeypatch.setattr(tmerge, "merge_row_pair", counted)
    mids = mof_tree(str(tmp_path / "mof"), java_class, seed=5)
    extra = {"uda.tpu.merge.two_phase": "on",
             "mapred.netmerger.hybrid.lpq.size": 2}
    got = port_run(str(tmp_path / "mof"), mids, java_class,
                   _conf(tmp_path, "port", **extra))
    assert got == reference_run(str(tmp_path / "mof"), mids, java_class,
                                _conf(tmp_path, "ref", **extra))
    # 4 maps in 2 LPQs of 2: one K1 pair merge each
    assert calls == ["pallas", "pallas"]


def test_failing_lpq_ends_in_fallback_and_removes_spills(tmp_path):
    """A map whose fetch always fails: the LPQ that holds it fails, the
    task ends in FallbackSignal carrying the same error class in both
    packages, and the spill files of the LPQs that finished are gone."""
    mids = text_tree(str(tmp_path / "mof"), "job", 6, 40, seed=13)
    conf = {"uda.tpu.fetch.retries": 1,
            "mapred.netmerger.hybrid.lpq.size": 2}
    causes = []
    for side, client, err_cls, run, fallback in (
            ("port", LocalFetchClient, errors.TransportError, port_run,
             errors.FallbackSignal),
            ("ref", JLocalFetchClient, jerrors.TransportError,
             reference_run, jerrors.FallbackSignal)):
        flaky = _flaky(client, err_cls)

        class OneBadMap(flaky):
            def start_fetch(self, req, on_complete):
                if req.map_id == mids[-1]:
                    on_complete(err_cls(f"injected fault on {req.map_id}"))
                    return
                super().start_fetch(req, on_complete)

        with pytest.raises(fallback) as got:
            run(str(tmp_path / "mof"), mids, TEXT,
                _conf(tmp_path, side, **conf),
                client_of=lambda engine: OneBadMap(engine, 0))
        causes.append(type(got.value.cause).__name__)
        assert not _spills(tmp_path, side)
    assert causes == ["TransportError", "TransportError"]


def test_failing_k1_in_an_lpq_is_a_merge_error(tmp_path, monkeypatch):
    """K1 refusing its operands inside an LPQ's merge tree ends the task
    in FallbackSignal carrying a MergeError: no LPQ turns to a host merge.
    """
    def refused(*args, **kwargs):
        raise RuntimeError("uda_tpu_torch: uda_merge_pass failed: CUDA "
                           "error 700 (an illegal memory access)")

    monkeypatch.setattr(tmerge, "resolve_run_engine",
                        lambda engine, device=None: "pallas")
    monkeypatch.setattr(tmerge, "merge_sorted_pair", refused)
    mids = text_tree(str(tmp_path / "mof"), "job", 4, 40, seed=17)
    with pytest.raises(errors.FallbackSignal) as got:
        port_run(str(tmp_path / "mof"), mids, TEXT,
                 _conf(tmp_path, "port",
                       **{"uda.tpu.merge.two_phase": "on"}))
    assert isinstance(got.value.cause, errors.MergeError)
    assert "CUDA error 700" in str(got.value.cause)
    assert not _spills(tmp_path, "port")


def test_launch_counts_survive_concurrent_launchers():
    """The LPQs launch K1 from several threads at once: the launch counter
    loses no count, even with a thread switch after every few bytecodes."""
    import sys
    import threading

    from uda_tpu_torch.ops import _build

    _build.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count("merge_pass") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.launches["merge_pass"] == 8 * 2000
    _build.reset_launches()
