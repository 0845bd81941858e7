"""The port's bytes exchange (uda_tpu_torch.parallel.bytes_exchange) and
the job path across the slot mesh against the JAX package's, byte for
byte: ``exchange_blobs`` (empty blobs, blobs longer than a row, uneven
sources, several rounds, a single exchange axis of a 2-axis mesh),
``ExchangeFetchClient``, and ``MapReduceJob.run(mesh=)`` (plain and
compressed, the Sort job's whole merged streams) and
``run_wordcount(mesh=)`` against ``uda_tpu.models`` on its mesh and
against the same job without ``mesh=``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import parallel as J
from uda_tpu.models import pipeline as jpipeline
from uda_tpu.models import sort_job as jsort
from uda_tpu.models import wordcount as jwc
from uda_tpu.utils.config import Config as JConfig
from uda_tpu_torch import parallel as T
from uda_tpu_torch.models import pipeline as tpipeline
from uda_tpu_torch.models import sort_job as tsort
from uda_tpu_torch.models import wordcount as twc
from uda_tpu_torch.mofserver import ShuffleRequest
from uda_tpu_torch.parallel.bytes_exchange import exchange_group_size
from uda_tpu_torch.parallel.mesh import Mesh as TMesh
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    yield
    metrics.reset()


def random_blobs(p: int, seed: int, max_blobs: int = 6,
                 max_len: int = 1500) -> list:
    rng = np.random.default_rng(seed)
    return [[(int(rng.integers(0, p)), rng.bytes(int(rng.integers(0,
                                                                 max_len))))
             for _ in range(int(rng.integers(0, max_blobs)))]
            for _ in range(p)]


def meshes(p: int):
    return J.make_mesh(p), T.make_mesh(p, device="cpu")


@pytest.mark.parametrize("p,seed,capacity,row", [
    (8, 9, None, 128), (8, 10, None, 256), (4, 17, 2, 64), (8, 3, 1, 256),
    (2, 5, None, 4)])
def test_exchange_blobs_matches(p, seed, capacity, row):
    blobs = random_blobs(p, seed)
    blobs[1].append((p - 1, b""))                # an empty blob
    blobs[0] = []                                # a source with nothing
    blobs[-1].append((0, bytes(range(256)) * 9))  # longer than a row
    jm, tm = meshes(p)
    got = T.exchange_blobs(blobs, tm, "shuffle", capacity=capacity,
                           row_payload_bytes=row)
    want = J.exchange_blobs(blobs, jm, "shuffle", capacity=capacity,
                            row_payload_bytes=row)
    assert got == want
    for d in range(p):
        for s in range(p):
            assert got[d][s] == [b for dst, b in blobs[s] if dst == d]


def test_exchange_blobs_one_axis_of_a_2_axis_mesh():
    """The group is the named axis (4 slots), not the mesh (8); a dest
    past it is refused, as in the reference."""
    jm = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
               ("dcn", "shuffle"))
    tm = TMesh(["cpu"] * 8, ("dcn", "shuffle"), (2, 4))
    assert exchange_group_size(tm, "shuffle") == 4
    assert exchange_group_size(tm, ("dcn", "shuffle")) == 8
    blobs = random_blobs(4, 23, max_blobs=4)
    assert T.exchange_blobs(blobs, tm, "shuffle", row_payload_bytes=64) == \
        J.exchange_blobs(blobs, jm, "shuffle", row_payload_bytes=64)
    for bad, match in (([[(7, b"x")]] + [[]] * 3, "outside"),
                       ([[]] * 3, "sources"),
                       (blobs, "multiple of 4")):
        with pytest.raises(ValueError, match=match):
            T.exchange_blobs(bad, tm, "shuffle", row_payload_bytes=6)


def test_fetch_client_serves_chunks_and_refuses_unknown_maps():
    data = bytes(range(200))
    client = T.ExchangeFetchClient({"m0": data}, raw_lengths={"m0": 999})
    got = []
    for off in (0, 64, 128, 192):
        client.start_fetch(ShuffleRequest("j", "m0", 0, off, 64),
                           got.append)
    assert b"".join(r.data for r in got) == data
    assert [r.last for r in got] == [False, False, False, True]
    assert {r.raw_length for r in got} == {999}
    assert {r.part_length for r in got} == {200}
    assert got[0].path == "mesh://m0"
    miss = []
    client.start_fetch(ShuffleRequest("j", "missing", 0, 0, 64), miss.append)
    assert isinstance(miss[0], errors.MergeError)


CONFS = {"plain": {}, "zlib": {"mapred.compress.map.output": True,
                               "mapred.map.output.compression.codec":
                               "zlib"}}


@pytest.mark.parametrize("tag", sorted(CONFS))
def test_job_across_the_mesh_matches(tag, tmp_path):
    """WordCount's job on 4 slots equals the reference's job on its 4
    devices and the port's job without mesh=, plain and compressed (the
    raw lengths ride beside the compressed partitions)."""
    text = b"alpha beta gamma alpha beta alpha delta " * 40
    splits = [text[: len(text) // 2], text[len(text) // 2:], b"alpha", b"",
              b"beta"]
    jm, tm = meshes(4)

    def job(pkg, cfg, sub, **kw):
        return pkg.MapReduceJob(
            f"wc_mesh_{tag}", (twc if pkg is tpipeline else jwc)._mapper,
            (twc if pkg is tpipeline else jwc)._reducer,
            key_type="org.apache.hadoop.io.Text", num_reducers=3,
            config=cfg(CONFS[tag]), work_dir=str(tmp_path / sub), **kw)

    got = job(tpipeline, Config, "port", device="cpu").run(splits, mesh=tm)
    want = job(jpipeline, JConfig, "ref").run(splits, mesh=jm)
    local = job(tpipeline, Config, "local", device="cpu").run(splits)
    assert got == want == local
    assert metrics.get("mesh_shuffle_time") > 0


def test_sort_job_merged_streams_across_8_slots(tmp_path):
    """The Sort job's reducers emit their merged streams whole: across 8
    slots they equal the reference's across its 8 devices and the same
    job without mesh=."""
    rng = np.random.default_rng(4)
    records = [(rng.bytes(10), rng.bytes(90)) for _ in range(600)]
    splits = [records[i::5] for i in range(5)]
    jm, tm = meshes(8)

    def job(mod, pkg, sub, **kw):
        return pkg.MapReduceJob("sort_mesh", mod._mapper, mod._reducer,
                                key_type="org.apache.hadoop.io.BytesWritable",
                                num_reducers=3, work_dir=str(tmp_path / sub),
                                **kw)

    got = job(tsort, tpipeline, "port", device="cpu").run(splits, mesh=tm)
    want = job(jsort, jpipeline, "ref").run(splits, mesh=jm)
    local = job(tsort, tpipeline, "local", device="cpu").run(splits)
    assert got == want == local
    assert sum(len(v) for v in got.values()) == len(records)


def test_run_wordcount_across_the_mesh(tmp_path):
    text = b"a b a c a b " * 30 + b"zz"
    jm, tm = meshes(8)
    got = twc.run_wordcount(text, num_maps=3, num_reducers=2,
                            work_dir=str(tmp_path / "p"), mesh=tm,
                            device="cpu")
    want = jwc.run_wordcount(text, num_maps=3, num_reducers=2,
                             work_dir=str(tmp_path / "r"), mesh=jm)
    assert got == want == {b"a": 90, b"b": 60, b"c": 30, b"zz": 1}


def test_a_mesh_without_the_axis_is_refused_as_the_reference(tmp_path):
    jm, tm = meshes(4)
    for pkg, mesh, kw in ((tpipeline, tm, {"device": "cpu"}),
                          (jpipeline, jm, {})):
        job = pkg.MapReduceJob("j", jwc._mapper, jwc._reducer,
                               key_type="org.apache.hadoop.io.Text",
                               work_dir=str(tmp_path / str(id(mesh))), **kw)
        with pytest.raises(ValueError, match=r"not \['dcn'\]"):
            job.run([b"a b"], mesh=mesh, axis="dcn")


def test_deliveries_stay_on_the_slots():
    """The rows cross on the slots' devices; a slot never lands elsewhere."""
    _, tm = meshes(8)
    words = np.arange(8 * 4 * 3, dtype=np.uint32).reshape(32, 3)
    rounds, layout = T.shuffle_exchange(words, (np.arange(32) % 8).astype(
        np.int32), tm, "shuffle", 4)
    assert all(w.device == torch.device("cpu") for w in layout.words)
    assert [w.device for w in rounds[0][0]] == tm.devices
