"""The port's job layer (uda_tpu_torch.models: the pipeline and the seven
workloads) against the JAX package's ``uda_tpu.models``: the same seeded
inputs and the same Config run through both packages, each in its own
tree, and each job must give equal outputs, byte-identical merged block
streams for every reducer (``MergeManager.run``'s blocks, captured) and
byte-identical map output files (``file.out``, ``file.out.index`` and
the coded layout's shards). The port runs on the CPU, its merge through
the CPU's "auto" engine (the host merge) and through K1's plain version.
Stable merges with ties to the first run have one correct output, so the
bar is byte identity."""

import collections
import os
import re

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import compress as jcompress
from uda_tpu import models as jmodels
from uda_tpu.compress import lzo as jlzo
from uda_tpu.models import pipeline as jpipeline
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import compress as tcompress
from uda_tpu_torch import models as tmodels
from uda_tpu_torch.compress import lzo as tlzo
from uda_tpu_torch.models import pipeline as tpipeline
from uda_tpu_torch.ops import _build
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import metrics

TEXT = (b"the quick brown fox jumps over the lazy dog\n"
        b"the dog barks and the fox runs away over the hill\n"
        b"pack my box with five dozen liquor jugs\n") * 7
GREP = rb"[a-z]*o[a-z]*"


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    _build.reset_launches()
    yield
    metrics.reset()


def _sort_records(seed: int = 4, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    records = [(rng.bytes(int(rng.integers(1, 16))),
                rng.bytes(int(rng.integers(0, 32)))) for _ in range(n)]
    records[n // 40] = records[3 * n // 4]  # a duplicate (key, value)
    return records


# name -> (models -> workload call); the reference tests' sizes
# (tests/test_workloads.py:17-107)
WORKLOADS = {
    "wordcount": lambda m, **kw: m.wordcount.run_wordcount(
        TEXT, num_maps=3, num_reducers=2, **kw),
    "wordcount_single": lambda m, **kw: m.wordcount.run_wordcount(
        b"a b a", num_maps=1, num_reducers=1, **kw),
    "secondary_sort": lambda m, **kw: m.secondary_sort.run_secondary_sort(
        num_groups=10, per_group=30, num_maps=3, num_reducers=2, **kw),
    "inverted_index": lambda m, **kw: m.inverted_index.run_inverted_index(
        num_docs=20, words_per_doc=60, num_maps=4, num_reducers=4, seed=1,
        **kw),
    "grep": lambda m, **kw: m.grep.run_grep(TEXT, GREP, num_maps=2, **kw),
    "sort": lambda m, **kw: m.sort_job.run_sort(
        _sort_records(), num_maps=3, num_reducers=3, **kw),
    "pi": lambda m, **kw: m.pi.run_pi(num_maps=3, points_per_map=3000,
                                      **kw),
}


def _capture(monkeypatch, pipeline_mod) -> list:
    """Record every (job, reducer, merged stream) ``MergeManager.run``
    emits inside ``pipeline_mod``'s jobs."""
    streams = []
    base = pipeline_mod.MergeManager

    class Recording(base):
        def run(self, job_id, map_ids, reduce_id, consumer, *a, **kw):
            buf = bytearray()

            def tee(block):
                buf.extend(block)
                consumer(block)

            try:
                return super().run(job_id, map_ids, reduce_id, tee, *a, **kw)
            finally:
                streams.append((job_id, reduce_id, bytes(buf)))

    monkeypatch.setattr(pipeline_mod, "MergeManager", Recording)
    return streams


def _k1_engine(monkeypatch) -> list:
    """Route the port's merges through K1 (its plain version on the CPU)
    instead of the CPU's "auto" choice, the host merge: the overlapped
    merger's engine, and the two-phase merge tree with K1 as its run engine
    in ``merge_segments`` (the hybrid merge's LPQs). Returns a list that gains one entry per pair merge
    through K1's wrapper."""
    from uda_tpu_torch.merger import merge_manager, overlap
    from uda_tpu_torch.ops import merge as tmerge
    from uda_tpu_torch.ops import pallas_sort

    calls = []
    merge_pass = pallas_sort.merge_pass

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return merge_pass(*args, **kwargs)

    monkeypatch.setattr(pallas_sort, "merge_pass", counted)

    def pallas_merger(*args, **kwargs):
        kwargs["engine"] = "pallas"
        return overlap.OverlappedMerger(*args, **kwargs)

    monkeypatch.setattr(merge_manager, "OverlappedMerger", pallas_merger)
    resolve = tmerge.resolve_run_engine
    monkeypatch.setattr(tmerge, "resolve_run_engine",
                        lambda engine, device=None: resolve("pallas", device))
    mode = tmerge.resolve_merge_mode
    monkeypatch.setattr(tmerge, "resolve_merge_mode",
                        lambda m, n, device=None: mode("on", n, device))
    return calls


def _tree(root) -> dict:
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _both(tmp_path, monkeypatch, fn, conf=None, engine="auto", spill=False):
    """Run ``fn(models, config=, work_dir=[, device=])`` through the
    reference and the port, each in its own tree (and spill directory);
    returns ((reference result, streams, tree), (port ...)). With
    ``engine="k1"`` the port's merges must go through K1's wrapper."""
    k1 = _k1_engine(monkeypatch) if engine == "k1" else None
    out = []
    for name, models, pipe, cfg_cls, extra in (
            ("ref", jmodels, jpipeline, JConfig, {}),
            ("port", tmodels, tpipeline, Config, {"device": "cpu"})):
        c = dict(conf or {})
        if spill:
            c["uda.tpu.spill.dirs"] = str(tmp_path / f"spill_{name}")
        streams = _capture(monkeypatch, pipe)
        work = tmp_path / name
        res = fn(models, config=cfg_cls(c), work_dir=str(work), **extra)
        out.append((res, streams, _tree(work)))
    if k1 is not None:
        assert k1, "no merge went through K1"
    return out


def _assert_same(ref, port):
    (want, want_streams, want_tree), (got, got_streams, got_tree) = ref, port
    assert got == want
    assert got_streams == want_streams
    assert any(s for _, _, s in got_streams)
    assert sorted(got_tree) == sorted(want_tree)
    for path in want_tree:
        assert got_tree[path] == want_tree[path], path


@pytest.mark.parametrize("engine", ["auto", "k1"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_workload_matches_reference(tmp_path, monkeypatch, workload, engine):
    """Each workload's outputs, merged streams and map output files equal
    the reference's, with the port merging by the host engine and by K1
    (a job of one map has no pair to merge)."""
    if workload == "wordcount_single" and engine == "k1":
        engine = "auto"
    ref, port = _both(tmp_path, monkeypatch, WORKLOADS[workload],
                      engine=engine)
    _assert_same(ref, port)


def test_wordcount_matches_direct_count(tmp_path):
    got = tmodels.wordcount.run_wordcount(TEXT, num_maps=3, num_reducers=2,
                                          work_dir=str(tmp_path),
                                          device="cpu")
    want = collections.Counter(
        m.group(0).lower() for m in re.finditer(rb"[A-Za-z0-9]+", TEXT))
    assert got == dict(want)
    assert metrics.get("map_phase_time") > 0
    assert metrics.get("reduce_phase_time") > 0


@pytest.mark.parametrize("engine", ["auto", "k1"])
def test_hybrid_mode_job_matches_reference(tmp_path, monkeypatch, engine):
    """The hybrid merge (approach 2, LPQs on the K1 merge tree, the RPQ on
    the host over spill files) inside a WordCount of 5 maps
    (tests/test_workloads.py:107)."""
    ref, port = _both(
        tmp_path, monkeypatch,
        lambda m, **kw: m.wordcount.run_wordcount(TEXT, num_maps=5,
                                                  num_reducers=2, **kw),
        conf={"mapred.netmerger.merge.approach": 2}, engine=engine,
        spill=True)
    _assert_same(ref, port)
    want = collections.Counter(
        m.group(0).lower() for m in re.finditer(rb"[A-Za-z0-9]+", TEXT))
    assert port[0] == dict(want)


def _pin_lzo(monkeypatch):
    """Both packages' LZO codec on the pure-Python pair, the rung both
    have (the reference's C++ rung is not ported)."""
    for pkg, lz in ((jcompress, jlzo), (tcompress, tlzo)):
        get = pkg.get_codec

        def pinned(name, pkg=pkg, lz=lz, get=get):
            if "lzo" in name.lower():
                return pkg.Codec("lzo", lz.lzo1x_compress_py,
                                 lambda d, n, lz=lz:
                                 lz.lzo1x_decompress_py(d, n))
            return get(name)

        monkeypatch.setattr(pkg, "get_codec", pinned)


@pytest.mark.parametrize("codec", ["zlib", "com.hadoop.compression.lzo."
                                           "LzoCodec"])
def test_compressed_job_matches_reference(tmp_path, monkeypatch, codec):
    """A compressed map output (MOFWriter(codec=)) fetched through
    DecompressingClient: zlib, and LZO with the pure-Python rung pinned
    in both packages."""
    _pin_lzo(monkeypatch)
    ref, port = _both(tmp_path, monkeypatch, WORKLOADS["sort"],
                      conf={"mapred.compress.map.output": True,
                            "mapred.map.output.compression.codec": codec})
    _assert_same(ref, port)


def test_coded_sort_job_matches_reference(tmp_path, monkeypatch):
    """A coded sort job under rs:2:3 over three supplier roots
    (tests/test_coding.py:1080-1100): the striped fan-out writes the same
    parity sections, v2 indexes and shards in both packages, and the
    reduce side merges the same bytes."""
    records = _sort_records(31, 64)
    out = []
    for name, models, pipe, cfg_cls, extra in (
            ("ref", jmodels, jpipeline, JConfig, {}),
            ("port", tmodels, tpipeline, Config, {"device": "cpu"})):
        roots = [str(tmp_path / name / "w")] + [
            str(tmp_path / name / f"p{i}") for i in (1, 2)]
        streams = _capture(monkeypatch, pipe)
        res = models.sort_job.run_sort(
            records, num_maps=3, num_reducers=2,
            config=cfg_cls({"uda.tpu.coding.scheme": "rs:2:3"}),
            work_dir=roots[0], supplier_roots=roots, **extra)
        out.append((res, streams, _tree(tmp_path / name)))
    _assert_same(*out)
    assert any("~s" in path for path in out[1][2])  # shards were written
    got = [r for recs in out[1][0].values() for r in recs]
    assert sorted(got) == sorted(records)


def test_dfsio_matches_reference(tmp_path):
    """DFSIO runs no merge: the same files, bytes and chunk counts."""
    got = tmodels.dfsio.run_dfsio(num_files=2, bytes_per_file=1 << 17,
                                  chunk_size=1 << 13,
                                  work_dir=str(tmp_path / "port"))
    want = jmodels.dfsio.run_dfsio(num_files=2, bytes_per_file=1 << 17,
                                   chunk_size=1 << 13,
                                   work_dir=str(tmp_path / "ref"))
    keys = ("bytes", "files", "chunks")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["chunks"] >= got["files"] * 2
    assert got["write_mb_s"] > 0 and got["read_mb_s"] > 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


def test_supplier_roots_must_include_work_dir(tmp_path):
    for job_cls, err in ((tpipeline.MapReduceJob, errors.ConfigError),
                         (jpipeline.MapReduceJob, jerrors.ConfigError)):
        with pytest.raises(err, match="supplier_roots must include"):
            job_cls("j", lambda s: [], lambda k, v: [],
                    supplier_roots=[str(tmp_path / "a"),
                                    str(tmp_path / "b")],
                    **({"device": "cpu"}
                       if job_cls is tpipeline.MapReduceJob else {}))


def test_mesh_runs_and_equals_the_reference(tmp_path):
    """``mesh=`` runs the shuffle across the slot mesh: WordCount and the
    job's outputs equal the reference's on its 4-device mesh and the same
    job without ``mesh=``."""
    from uda_tpu.parallel import make_mesh as jmake_mesh
    from uda_tpu_torch.parallel import make_mesh

    mesh, jmesh = make_mesh(4, device="cpu"), jmake_mesh(4)
    got = tmodels.wordcount.run_wordcount(
        TEXT, work_dir=str(tmp_path / "p"), mesh=mesh, device="cpu")
    want = jmodels.wordcount.run_wordcount(
        TEXT, work_dir=str(tmp_path / "r"), mesh=jmesh)
    assert got == want
    assert got == tmodels.wordcount.run_wordcount(
        TEXT, work_dir=str(tmp_path / "l"), device="cpu")
    records = _sort_records(5, 120)
    splits = [records[i::3] for i in range(3)]
    outs = [pkg.MapReduceJob("j", mod._mapper, mod._reducer,
                             key_type="org.apache.hadoop.io.BytesWritable",
                             num_reducers=2, work_dir=str(tmp_path / sub),
                             **kw).run(splits, mesh=m)
            for pkg, mod, sub, m, kw in (
                (tpipeline, tmodels.sort_job, "jp", mesh, {"device": "cpu"}),
                (jpipeline, jmodels.sort_job, "jr", jmesh, {}))]
    assert outs[0] == outs[1]


def test_entry_points_need_a_device_or_cpu(tmp_path, monkeypatch):
    """``device=None`` means the card: without one a job raises before it
    maps anything, never falling back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.pi.run_pi(work_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_grouped_reduce_contract():
    records = [(b"a", b"1"), (b"a", b"2"), (b"b", b"3")]
    for mod in (tpipeline, jpipeline):
        out = list(mod.grouped_reduce(iter(records),
                                      lambda k, vs: [(k, b"".join(vs))]))
        assert out == [(b"a", b"12"), (b"b", b"3")]
        assert list(mod.grouped_reduce(iter([]), lambda k, vs: [])) == []


def test_partitioners_and_keys_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        k = rng.bytes(int(rng.integers(0, 40)))
        assert tpipeline.hash_partitioner(k, 7) == \
            jpipeline.hash_partitioner(k, 7)
        assert tmodels.wordcount.text_key(k) == jmodels.wordcount.text_key(k)
        assert tmodels.wordcount.parse_text_key(
            tmodels.wordcount.text_key(k)) == k
        assert tmodels.sort_job.bytes_key(k) == jmodels.sort_job.bytes_key(k)
    for i in (0, 1, 7, 1000, 123457):
        assert tmodels.pi.halton(i, 3) == jmodels.pi.halton(i, 3)
    assert tmodels.inverted_index.zipf_corpus(5, 20, seed=2) == \
        jmodels.inverted_index.zipf_corpus(5, 20, seed=2)


def test_job_phase_timers_match_reference(tmp_path, monkeypatch):
    """Both packages time the same phases of a job."""
    jmetrics.reset()
    _both(tmp_path, monkeypatch, WORKLOADS["wordcount"])
    for name in ("map_phase_time", "reduce_phase_time"):
        assert metrics.get(name) > 0 and jmetrics.get(name) > 0
