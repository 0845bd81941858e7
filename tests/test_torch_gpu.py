"""The port's CUDA kernels on the card: each held byte for byte against its
plain PyTorch version on the same input, every engine against numpy's
stable sort, and the wrappers' launch counts and input checks.

Every test here is marked ``gpu`` and skips where there is no card. The
file imports neither jax nor uda_tpu, so it also runs where only the port
is installed; on the card run it without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import io

import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_CASES, EQUAL_RUN_CASES, SLIM_EDGE_CASES,
                        equal_runs)
from port_helpers import (GATHER_NS, GATHER_ROWS, PERM_KINDS,  # noqa: F401
                          cuda_device, gather_index, oracle, records, words)
from uda_tpu_torch import interop
from uda_tpu_torch.models import terasort as tts
from uda_tpu_torch.ops import _build, lane_gather, pallas_fold, pallas_sort
from uda_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.gpu


def _on_card(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return interop.words_from_numpy(x, dev)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return np.array_equal(interop.words_to_numpy(a),
                          interop.words_to_numpy(b))


@pytest.mark.parametrize("rows,nk,tb,tile", [(8, 3, 7, 1024),
                                             (32, 3, 31, 256),
                                             (8, 7, 7, 2048),
                                             (32, 30, 31, 128)])
def test_k2_k1_match_plain(cuda_device, rows, nk, tb, tile):
    """K2 and every K1 pass against their plain versions."""
    x_np = words(rows + nk, rows, 1 << 15, nk)
    y = _k2_k1_cascade(_on_card(x_np, cuda_device), nk, tb, tile)
    np.testing.assert_array_equal(interop.words_to_numpy(y),
                                  oracle(x_np, nk, tb))


def _k2_k1_cascade(x, nk, tb, tile):
    """K2 and every K1 pass against their plain versions; the result."""
    y = pallas_sort.tile_sort(x, tile, nk, tb)
    assert _same(y, pallas_sort.tile_sort_plain(x, tile, nk, tb))
    run = tile
    while run < x.shape[1]:
        z = pallas_sort.merge_pass(y, run, tile, nk, tb)
        assert _same(z, pallas_sort.merge_pass_plain(y, run, tile, nk, tb))
        y, run = z, 2 * run
    return y


@pytest.mark.parametrize("rows,nk,tb,n,tile,kind",
                         EDGE_CASES + [(32, 3, 31, 1 << 13, 4096, "mixed")])
def test_k2_k1_edges_match_plain(cuda_device, rows, nk, tb, n, tile, kind):
    """The redesigned K2 and K1 at the edges of their block widths, key
    counts and key values, and at tiles wider than one K2 block takes,
    against their plain versions and numpy."""
    x_np = words(n + nk, rows, n, nk, kind)
    y = _k2_k1_cascade(_on_card(x_np, cuda_device), nk, tb, tile)
    np.testing.assert_array_equal(interop.words_to_numpy(y),
                                  oracle(x_np, nk, tb))


@pytest.mark.parametrize("rows,nk,tb,tile,folded", [
    (8, 3, 7, 128, False), (32, 30, 31, 128, False), (4, 1, 3, 1024, False),
    (4, 1, 3, 256, True), (4, 2, 3, 256, True), (4, 3, 3, 256, True)])
def test_merge_partition_matches_merge_splits(cuda_device, rows, nk, tb,
                                              tile, folded):
    """The partition kernel against the plain version's merge_splits, at
    K1's width (or K4's, ``folded``), on every pass of a cascade."""
    fold = pallas_fold if folded else None
    x = _on_card(words(rows, rows, 1 << 13, nk), cuda_device)
    y = (fold.tile_sort_folded(x, tile, nk) if fold
         else pallas_sort.tile_sort(x, tile, nk, tb))
    run = tile
    while run < x.shape[1]:
        width = (fold.merge_pass_folded_width(nk, x.shape[1], run) if fold
                 else pallas_sort.merge_pass_width(rows, nk, x.shape[1], run))
        assert width <= 2 * run and x.shape[1] % width == 0
        got = pallas_sort.merge_partition(y, run, width, nk, tb)
        keys = [tsort._as_i64(y[r]) for r in [*range(nk), tb]]
        want = pallas_sort.merge_splits(keys, y.shape[1], run, width)[1]
        assert torch.equal(got.to(torch.int64), want)
        y = (fold.merge_pass_folded(y, run, tile, nk) if fold
             else pallas_sort.merge_pass(y, run, tile, nk, tb))
        run *= 2


def _take_lanes_cases():
    """The probe's three shapes, K5's record and tile edges with every kind
    of index, a merge permutation and repeats past one tile, and both sides
    of the small-shape rule (lane_gather.SMALL_BYTES)."""
    cases = [(32, 2048, "random"), (8, 2048, "random"), (8, 512, "random")]
    cases += [(rows, n, kind) for rows in GATHER_ROWS for n in GATHER_NS
              for kind in PERM_KINDS]
    cases += [(8, 1 << 16, "merge"), (26, 1 << 16, "repeated")]
    edge = lane_gather.SMALL_BYTES // 32
    cases += [(8, edge, "random"), (8, edge + 4, "random"),
              (8, edge + 1, "merge")]
    return cases


@pytest.mark.parametrize("rows,n,kind", _take_lanes_cases())
def test_take_lanes_matches_plain(cuda_device, rows, n, kind):
    """K5 against the plain version and the probe's own oracle
    ``x[:, perm]``, through the wrapper's design and through each design
    launched on its own."""
    rng = np.random.default_rng(rows + n)
    x_np = rng.integers(0, 2**32, size=(rows, n), dtype=np.uint32)
    x_np[:, ::7] = np.uint32(0xFFFFFFFF)
    perm_np = gather_index(kind, n, rows + n)
    x = _on_card(x_np, cuda_device)
    perm = torch.from_numpy(perm_np).to(cuda_device)
    got = lane_gather.take_lanes(x, perm)
    assert _same(got, lane_gather.take_lanes_plain(x, perm))
    np.testing.assert_array_equal(interop.words_to_numpy(got),
                                  x_np[:, perm_np])
    for how in ("direct", "records"):
        out = torch.full_like(x, 0x5A5A5A5A)
        lane_gather._launch(x, perm, out, how)
        assert _same(out, got), how


@pytest.mark.parametrize("nk,n,tile,kind",
                         [(3, 1 << 15, 1024, "mixed"), (1, 1 << 15, 256, "mixed"),
                          (2, 1 << 15, 4096, "mixed")] + SLIM_EDGE_CASES)
def test_k3_k4_match_plain(cuda_device, nk, n, tile, kind):
    """K3 and every K4 pass against their plain versions and numpy, also
    at the edges of their design (tile 256, n == tile, 1-3 key words,
    all-equal, all-0xFFFFFFFF and high keys, tiles past one K3 block)."""
    x_np = words(n + nk, 4, n, nk, kind)
    x = _on_card(x_np, cuda_device)
    y = pallas_fold.tile_sort_folded(x, tile, nk)
    assert _same(y, pallas_fold.tile_sort_folded_plain(x, tile, nk))
    run = tile
    while run < n:
        z = pallas_fold.merge_pass_folded(y, run, tile, nk)
        assert _same(z, pallas_fold.merge_pass_folded_plain(y, run, tile,
                                                             nk))
        y, run = z, 2 * run
    np.testing.assert_array_equal(interop.words_to_numpy(y),
                                  oracle(x_np, nk, 3))


def test_every_engine(cuda_device):
    w = records(21, 200_000)
    want = w[np.lexsort([w[:, 2], w[:, 1], w[:, 0]])]
    for path in tsort.ALL_SORT_PATHS + ("auto",):
        got = tts.single_chip_sort(w, path=path)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(interop.words_to_numpy(got), want)
    viol, ck_in, ck_out = tts.bench_step(0, 1 << 18, 2, "keys8")
    assert int(viol) == 0 and int(ck_in) == int(ck_out)


def test_launch_counts(cuda_device):
    x = _on_card(words(1, 8, 1 << 14, 3), cuda_device)
    _build.reset_launches()
    pallas_sort.sort_lanes(x, 3, tb_row=7, tile=1024)
    pallas_fold.sort_lanes_folded(x, 3, tile=1024)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"tile_sort": 1, "merge_pass": 4,
                                     "merge_partition": 8,
                                     "tile_sort_folded": 1,
                                     "merge_pass_folded": 4}


def test_take_lanes_counts_one_launch_a_call(cuda_device):
    """K5 counts one launch per call in either design (the records
    design's two passes are one launch of K5), none for an empty x."""
    small = _on_card(words(4, 8, 512, 3), cuda_device)
    large = _on_card(words(5, 8, lane_gather.SMALL_BYTES // 16, 3),
                     cuda_device)
    empty = torch.empty((8, 0), dtype=torch.uint32, device=cuda_device)
    _build.reset_launches()
    for x in (small, large, empty):
        lane_gather.take_lanes(x, torch.arange(x.shape[1], dtype=torch.int32,
                                               device=cuda_device))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"take_lanes": 2}


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = _on_card(words(2, 8, 1 << 14, 3), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        pallas_sort.tile_sort(x[:, ::2], 1024, 3, 7)
    with pytest.raises(ValueError, match="power of two"):
        pallas_sort.tile_sort(x, 384, 3, 7)
    with pytest.raises(ValueError, match="4 rows"):
        pallas_fold.tile_sort_folded(x, 1024, 3)
    x4 = _on_card(words(3, 4, 1 << 12, 3), cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        pallas_fold.tile_sort_folded(x4, 768, 3)
    with pytest.raises(ValueError, match="1 to 3 key words"):
        pallas_fold.tile_sort_folded(x4, 1024, 4)
    with pytest.raises(ValueError, match="1 to 3 key words"):
        pallas_fold.merge_pass_folded(x4, 1024, 1024, 0)
    with pytest.raises(ValueError, match="4 rows"):
        pallas_fold.merge_pass_folded(x, 1024, 1024, 3)
    wide = _on_card(words(2, 40, 1 << 10, 32), cuda_device)
    with pytest.raises(ValueError, match="1 to 31 key words"):
        pallas_sort.tile_sort(wide, 1024, 32, 39)
    with pytest.raises(ValueError, match="1 to 31 key words"):
        pallas_sort.merge_pass(wide, 512, 512, 32, 39)
    with pytest.raises(IndexError, match=r"\[0, 8\)"):
        lane_gather.take_lanes(x[:, :8].contiguous(),
                               torch.tensor([0, 1, 2, 8, 4, 5, 6, 7],
                                            dtype=torch.int32,
                                            device=cuda_device))
    with pytest.raises(IndexError, match=r"\[0, 8\)"):
        lane_gather.take_lanes(x[:, :8].contiguous(),
                               torch.tensor([0, 1, 2, -1, 4, 5, 6, 7],
                                            dtype=torch.int32,
                                            device=cuda_device))
    tall = torch.zeros((lane_gather.MAX_ROWS + 1, 4), dtype=torch.uint32,
                       device=cuda_device)
    with pytest.raises(ValueError, match="at most 65535 rows"):
        lane_gather.take_lanes(tall, torch.arange(4, dtype=torch.int32,
                                                  device=cuda_device))


@pytest.mark.parametrize("nk,tile", [(2, 16384), (7, 16384), (30, 4096)])
def test_k2_takes_a_tile_wider_than_a_block(cuda_device, nk, tile):
    """A tile past one K2 block (its registers and shared memory) sorts as
    sub-tiles merged by K1: one K2 launch and a K1 pass per doubling, equal
    to the plain version at the tile."""
    x = _on_card(words(nk, 32, 1 << 15, nk), cuda_device)
    _build.reset_launches()
    y = pallas_sort.tile_sort(x, tile, nk, 31)
    torch.cuda.synchronize()
    assert _build.launches["tile_sort"] == 1
    assert _build.launches["merge_pass"] >= 1
    assert _same(y, pallas_sort.tile_sort_plain(x, tile, nk, 31))



@pytest.mark.parametrize("nk,n,run_len", EQUAL_RUN_CASES)
def test_k4_sends_ties_to_the_first_run(cuda_device, nk, n, run_len):
    """Runs whose records have equal (key words, tie-break) twins in the
    other run: K4 keeps every record and puts each A record before its B
    twin, as its plain version does."""
    x = _on_card(equal_runs(n + nk, n, run_len, nk), cuda_device)
    got = pallas_fold.merge_pass_folded(x, run_len, run_len, nk)
    assert _same(got, pallas_fold.merge_pass_folded_plain(x, run_len,
                                                          run_len, nk))


@pytest.mark.parametrize("nk,tile,k4_launches", [(1, 16384, 1),
                                                 (2, 8192, 1),
                                                 (3, 8192, 1),
                                                 (3, 16384, 2)])
def test_k3_takes_a_tile_wider_than_a_block(cuda_device, nk, tile,
                                            k4_launches):
    """Tiles at and past one K3 block (8192 at 2-3 key words, 16384 at
    1): one K3 launch, wider tiles' sub-tiles merged by K4, then the
    cascade's own pass; equal to the plain cascade."""
    x_np = words(tile + nk, 4, 2 * tile, nk)
    x = _on_card(x_np, cuda_device)
    _build.reset_launches()
    y = pallas_fold.sort_lanes_folded4(x, nk, tile=tile)
    torch.cuda.synchronize()
    assert _build.launches["tile_sort_folded"] == 1
    assert _build.launches["merge_pass_folded"] == k4_launches
    want = pallas_fold.sort_lanes_folded4(torch.from_numpy(x_np), nk,
                                          tile=tile)
    np.testing.assert_array_equal(interop.words_to_numpy(y), want.numpy())



def _sorted_runs(seed, n, cap, w, equal=False):
    """Two sorted uint32[cap, w] runs of n real rows (small alphabet, so
    equal rows within and across runs) and all-0xFFFFFFFF pad rows up to
    ``cap``, as the merge tree's runs are; ``equal`` makes B a copy of
    A."""
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(2):
        r = rng.integers(0, 3, size=(n, w), dtype=np.uint32)
        r[rng.random(n) < 0.1] = np.uint32(0x80000000)
        r = r[np.lexsort(r.T[::-1])]
        runs.append(np.concatenate([r, np.full((cap - n, w), 0xFFFFFFFF,
                                               np.uint32)]))
    if equal:
        runs[1] = runs[0].copy()
    return runs


@pytest.mark.parametrize("run_len,w,equal", [
    (512, 7, False), (1536, 7, False), (2560, 7, False), (1 << 14, 7, False),
    (1536, 1, False), (2560, 31, False), (1 << 13, 31, False),
    (512, 1, True), (1536, 7, True), (2560, 31, True)])
def test_pair_merge_matches_plain(cuda_device, run_len, w, equal):
    """K1 as the merge tree's pair merge: [W + 1, 2L] at L = 512 x {1, 3,
    5, 2^k}, 2, 8 and 32 rows, pad rows in both runs, and B a copy of A
    (every record has an equal twin): the packed pass against the plain
    version, and merge_sorted_pair against numpy's stable sort."""
    from uda_tpu_torch.ops import pallas_merge

    a, b = _sorted_runs(run_len + w, run_len - 37, run_len, w, equal)
    ta, tb = _on_card(a, cuda_device), _on_card(b, cuda_device)
    L = pallas_merge.pair_run_len(run_len, run_len, 512)
    assert L == run_len
    x = pallas_merge.pack_pair(ta, tb, L)
    assert tuple(x.shape) == (w + 1, 2 * L)
    _build.reset_launches()
    got = pallas_sort.merge_pass(x, L, 512, w, w)
    torch.cuda.synchronize()
    assert _build.launches["merge_pass"] == 1
    assert _same(got, pallas_sort.merge_pass_plain(x.cpu(), L, 512, w, w))
    merged = pallas_merge.merge_sorted_pair(ta, tb, num_keys=w)
    cat = np.concatenate([a, b])
    np.testing.assert_array_equal(interop.words_to_numpy(merged),
                                  cat[np.lexsort(cat.T[::-1])])


def _text_mofs(root, maps: int = 5, n: int = 300):
    """A MOF tree of sorted Text records (duplicate keys), one partition a
    map; returns the map ids."""
    from uda_tpu_torch.mofserver import MOFWriter

    rng = np.random.default_rng(5)
    writer = MOFWriter(str(root), "job")
    for m in range(maps):
        recs = []
        for _ in range(n + 37 * m):
            c = bytes(rng.integers(0, 3, int(rng.integers(0, 12)),
                                   dtype=np.uint8))
            recs.append((bytes([len(c)]) + c, rng.bytes(40)))
        writer.write(f"m{m}", [sorted(recs, key=lambda kv: kv[0][1:])])
    return writer.map_ids


def _reduce_on(dev: str, root, mids, conf: dict) -> tuple:
    """(stream, launch counts) of one MergeManager.run on ``dev``."""
    from uda_tpu_torch.merger import LocalFetchClient, MergeManager
    from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
    from uda_tpu_torch.utils.config import Config

    engine = DataEngine(DirIndexResolver(str(root)), Config(conf))
    out = bytearray()
    try:
        _build.reset_launches()
        mm = MergeManager(LocalFetchClient(engine),
                          "org.apache.hadoop.io.Text", Config(conf),
                          device=dev)
        assert mm.run("job", mids, 0, out.extend) == len(out)
        torch.cuda.synchronize()
        return bytes(out), dict(_build.launches)
    finally:
        engine.stop()


def test_merge_manager_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """A small reduce task on the card (two-phase through K1, one launch
    pair per pair merge) emits the bytes the same call emits with
    device="cpu" (the re-sort), at 1 KB chunks."""
    from uda_tpu_torch.utils.metrics import metrics

    mids = _text_mofs(tmp_path)
    conf = {"uda.tpu.merge.overlap": False, "mapred.rdma.buf.size": 1}
    streams = {}
    for dev in ("cuda", "cpu"):
        metrics.reset()
        streams[dev] = _reduce_on(dev, tmp_path, mids, conf) + (
            metrics.get("merge.fold.device_ms"),)
    assert streams["cuda"][0] == streams["cpu"][0]
    assert streams["cuda"][1]["merge_pass"] == 4
    assert streams["cuda"][1]["merge_partition"] == 4
    assert not streams["cpu"][1].get("merge_pass")
    assert streams["cuda"][2] > 0 and streams["cpu"][2] == 0


@pytest.mark.parametrize("mode", [{}, {"uda.tpu.stage.pipeline": False},
                                  {"uda.tpu.online.streaming": True}],
                         ids=["default", "pipeline_off", "streaming"])
def test_overlapped_reduce_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                       mode):
    """The default reduce path (the overlapped merger) on the card, with
    the pipeline off and in streaming mode, emits the bytes of the same
    call on the CPU; K1 launches once per forest merge (4 for 5 maps)."""
    mids = _text_mofs(tmp_path)
    conf = dict(mode, **{"mapred.rdma.buf.size": 1,
                         "uda.tpu.spill.dirs": str(tmp_path / "spill")})
    on_card, launches = _reduce_on("cuda", tmp_path, mids, conf)
    on_cpu, cpu_launches = _reduce_on("cpu", tmp_path, mids, conf)
    assert on_card == on_cpu
    assert launches["merge_pass"] == launches["merge_partition"] == 4
    assert not cpu_launches.get("merge_pass")


@pytest.mark.parametrize("pipeline", [False, True])
def test_overlap_merger_on_the_card_matches_the_cpu(cuda_device, pipeline):
    """The overlapped merger on the card (K1, runs copied from pinned
    leases on the copy stream, merged on the merge stream) emits what the
    same merger emits on the CPU with the host engine; K1 launches once
    per forest merge; every lease is pinned, goes back and is reused;
    nothing stays charged."""
    from uda_tpu_torch.merger.emitter import FramedEmitter
    from uda_tpu_torch.merger.overlap import OverlappedMerger
    from uda_tpu_torch.utils.comparators import get_key_type
    from uda_tpu_torch.utils.ifile import IFileWriter, crack
    from uda_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(7)
    batches = []
    for s in range(12):
        recs = [(rng.bytes(int(rng.integers(0, 12))), rng.bytes(30))
                for _ in range(int(rng.integers(1, 5000)))]
        if s % 3:
            recs.sort()  # the others need run_row_order's lexsort
        buf = io.BytesIO()
        with IFileWriter(buf) as w:
            for k, v in recs:
                w.append(k, v)
        batches.append(crack(buf.getvalue()))
    kt = get_key_type("uda.tpu.RawBytes")
    order = list(np.random.default_rng(8).permutation(len(batches)))
    streams = {}
    for dev, engine in (("cpu", "host"), ("cuda", "auto")):
        metrics.reset()
        metrics.enable_stats()   # the put_ms histogram read below
        _build.reset_launches()
        om = OverlappedMerger(kt, 16, engine=engine, pipeline=pipeline,
                              stagers=3, inflight_bytes=1 << 20, device=dev)
        for i in order:
            om.feed(int(i), batches[i])
        out = bytearray()
        om.emit_stream(batches, FramedEmitter(1 << 14), out.extend)
        torch.cuda.synchronize()
        streams[dev] = (bytes(out), dict(_build.launches), om)
    assert streams["cuda"][0] == streams["cpu"][0]
    om = streams["cuda"][2]
    assert om.engine == "pallas" and om.stats["device_merges"] == 11
    assert streams["cuda"][1]["merge_pass"] == 11
    assert streams["cuda"][1]["merge_partition"] == 11
    pool = om._buf_pool
    assert pool.pinned and pool.leased == 0
    assert metrics.get("stage.buffer.reuses") > 0
    assert metrics.histogram("merge.pipeline.put_ms")["count"] == 12
    assert metrics.get_gauge("stage.inflight.bytes") == 0
    lease = pool.lease(512, 7)
    assert torch.from_numpy(lease.view(np.int32)).is_pinned()
    pool.release(lease)


@pytest.mark.parametrize("lpq_size", [2, 3])
def test_hybrid_reduce_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                   lpq_size):
    """Approach 2 on the card: every LPQ merged by K1's merge tree on its
    pool thread (one launch pair per pair merge: 5 maps in LPQs of 2, 2
    and 1 make 2; in LPQs of 3 and 2, 3), the RPQ on the host; the bytes of the same call
    on the CPU, and no spill file left."""
    import os

    mids = _text_mofs(tmp_path)
    conf = {"mapred.netmerger.merge.approach": 2,
            "mapred.netmerger.hybrid.lpq.size": lpq_size,
            "mapred.rdma.buf.size": 1,
            "uda.tpu.spill.dirs": str(tmp_path / "spill")}
    on_card, launches = _reduce_on("cuda", tmp_path, mids, conf)
    on_cpu, _ = _reduce_on("cpu", tmp_path, mids, conf)
    assert on_card == on_cpu
    pairs = {2: 2, 3: 3}[lpq_size]
    assert launches["merge_pass"] == launches["merge_partition"] == pairs
    assert not os.listdir(tmp_path / "spill")


@pytest.mark.parametrize("keys,route,k1", [
    ({"uda.tpu.hbm.budget.mb": 64 * 1024,
      "uda.tpu.host.budget.mb": 64 * 1024}, "hybrid", 2),
    ({"uda.tpu.hbm.budget.mb": 64 * 1024,
      "uda.tpu.host.budget.mb": 64 * 1024,
      "uda.tpu.auto.approach.threshold.mb": 0}, "streaming", 4)])
def test_auto_reduce_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                 keys, route, k1):
    """Approach 0 on the card, each route forced by the budget keys: the
    bytes of the same call on the CPU, K1 on the route's path."""
    mids = _text_mofs(tmp_path)
    conf = dict(keys, **{"mapred.netmerger.merge.approach": 0,
                         "mapred.netmerger.hybrid.lpq.size": 2,
                         "mapred.rdma.buf.size": 1,
                         "uda.tpu.spill.dirs": str(tmp_path / "spill")})
    on_card, launches = _reduce_on("cuda", tmp_path, mids, conf)
    on_cpu, _ = _reduce_on("cpu", tmp_path, mids, conf)
    assert on_card == on_cpu
    assert launches["merge_pass"] == k1


def test_resumed_reduce_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """A streaming task with a checkpoint dies on a lost map; the retry on
    the card adopts the runs the checkpoint's manifest holds into K1's
    forest (launches K1), fetches none of them again, and emits the bytes
    of an uninterrupted run on the CPU. The map is lost only once the
    manifest holds a run, and the adopted maps are read from the newest
    manifest: a run spooled while the first attempt was being torn down
    may miss its snapshot (saves skip rather than queue), and is fetched
    again by design."""
    import threading
    import time

    from uda_tpu_torch.merger import LocalFetchClient, MergeManager
    from uda_tpu_torch.merger.checkpoint import TaskCheckpoint
    from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.errors import FallbackSignal, TransportError

    mids = _text_mofs(tmp_path, maps=6)
    conf = {"uda.tpu.online.streaming": True,
            "uda.tpu.ckpt.dir": str(tmp_path / "ck"),
            "uda.tpu.ckpt.interval.s": 0.0, "uda.tpu.fetch.retries": 0,
            "mapred.rdma.buf.size": 1}
    fetched = []
    ck = TaskCheckpoint(str(tmp_path / "ck"), "job", 0)

    def saved() -> set:
        """The maps whose runs the newest manifest holds."""
        newest = ck._manifests()[:1]
        man = TaskCheckpoint._read_manifest(newest[0][1]) if newest else None
        return {r["map"] for r in ((man or {}).get("runs") or {}).values()}

    class Client(LocalFetchClient):
        bad = None

        def start_fetch(self, req, on_complete):
            fetched.append(req.map_id)
            if req.map_id == self.bad:
                def lose():
                    deadline = time.monotonic() + 60.0
                    while not saved() and time.monotonic() < deadline:
                        time.sleep(0.01)
                    on_complete(TransportError("lost"))
                threading.Thread(target=lose, daemon=True).start()
                return
            super().start_fetch(req, on_complete)

    def attempt(bad):
        engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
        client = Client(engine)
        client.bad = bad
        out = bytearray()
        try:
            _build.reset_launches()
            MergeManager(client, "org.apache.hadoop.io.Text", Config(conf),
                         device="cuda").run("job", mids, 0, out.extend)
            torch.cuda.synchronize()
            return bytes(out), dict(_build.launches)
        finally:
            engine.stop()

    with pytest.raises(FallbackSignal):
        attempt(mids[-1])
    runs = sorted((tmp_path / "ck" / "job.r0" / "runs").glob("*.ifile"))
    adopted = saved()
    assert runs and adopted and mids[-1] not in adopted
    fetched.clear()
    out, launches = attempt(None)
    want, _ = _reduce_on("cpu", tmp_path, mids,
                         {"uda.tpu.online.streaming": True,
                          "uda.tpu.spill.dirs": str(tmp_path / "spill")})
    assert out == want
    assert launches["merge_pass"] == 5
    assert not adopted & set(fetched)
    assert mids[-1] in fetched
    assert not (tmp_path / "ck" / "job.r0").exists()


def test_dead_supplier_reduce_on_the_card_matches_the_cpu(cuda_device,
                                                          tmp_path):
    """rs:2:4 over four suppliers, h2 dead from the start, 4 maps x 256
    KiB of TeraSort records: on the card the partition on h2 is rebuilt
    from two shards on the survivors, K1 merges the forest (3 launch
    pairs), and the stream is the bytes of the same task on the CPU."""
    from chip_smoke import (CODED_DEAD, CODED_HOSTS, DeadClient, SEED,
                            tera_partitions, write_striped_tree)
    from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                      MergeManager)
    from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.metrics import metrics

    parts = tera_partitions(SEED + 3, 4, 256 << 10)
    roots = [str(tmp_path / h) for h in CODED_HOSTS]
    entries = write_striped_tree(roots, parts)
    conf = {"uda.tpu.coding.scheme": "rs:2:4", "uda.tpu.fetch.retries": 1}
    streams = {}
    for dev in ("cuda", "cpu"):
        engines = [DataEngine(DirIndexResolver(r), Config(conf))
                   for r in roots]
        clients = {h: (DeadClient if h == CODED_DEAD else LocalFetchClient)(e)
                   for h, e in zip(CODED_HOSTS, engines)}
        out = bytearray()
        metrics.reset()
        _build.reset_launches()
        try:
            MergeManager(HostRoutingClient(clients.__getitem__),
                         "org.apache.hadoop.io.Text", Config(conf),
                         device=dev).run("terasort", entries, 0, out.extend)
            torch.cuda.synchronize()
        finally:
            for e in engines:
                e.stop()
        streams[dev] = (bytes(out), dict(_build.launches),
                        metrics.get("coding.reconstructed.partitions"),
                        metrics.get("fallback.signals"))
    assert streams["cuda"][0] == streams["cpu"][0]
    assert len(streams["cuda"][0]) == sum(p.nbytes for p in parts) + 2
    assert streams["cuda"][1]["merge_pass"] == 3
    assert streams["cuda"][1]["merge_partition"] == 3
    assert streams["cuda"][2] == streams["cpu"][2] == 1
    assert streams["cuda"][3] == streams["cpu"][3] == 0


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_networked_reduce_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                      codec):
    """5 maps of Text records served by a port ShuffleServer on loopback
    and fetched by HostRoutingClient's socket default (through
    DecompressingClient for a zlib tree): on the card K1 merges the
    forest (4 launch pairs) and the stream is the bytes of the same task
    on the CPU, over the same wire."""
    from uda_tpu_torch.compress import DecompressingClient, get_codec
    from uda_tpu_torch.merger import HostRoutingClient, MergeManager
    from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                         MOFWriter)
    from uda_tpu_torch.net import ShuffleServer
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(41)
    writer = MOFWriter(str(tmp_path), "job",
                       codec=get_codec(codec) if codec else None)
    for m in range(5):
        recs = []
        for _ in range(300):
            c = bytes(rng.integers(0, 4, int(rng.integers(0, 12)),
                                   dtype=np.uint8))
            recs.append((bytes([len(c)]) + c, rng.bytes(40)))
        writer.write(f"m{m}", [sorted(recs, key=lambda kv: kv[0][1:])])
    conf = {"mapred.rdma.buf.size": 1, "uda.tpu.net.fetch": True}
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
    server = ShuffleServer(engine, Config(conf), host="127.0.0.1",
                           port=0).start()
    entries = [(f"127.0.0.1:{server.port}", m) for m in writer.map_ids]
    streams = {}
    try:
        for dev in ("cuda", "cpu"):
            router = HostRoutingClient(config=Config(conf))
            client = (DecompressingClient(router, get_codec(codec))
                      if codec else router)
            out = bytearray()
            metrics.reset()
            _build.reset_launches()
            try:
                MergeManager(client, "org.apache.hadoop.io.Text",
                             Config(conf), device=dev).run(
                    "job", entries, 0, out.extend)
                torch.cuda.synchronize()
            finally:
                client.stop()
            streams[dev] = (bytes(out), dict(_build.launches),
                            metrics.get("net.serve.fd"))
    finally:
        server.stop()
        engine.stop()
    assert streams["cuda"][0] == streams["cpu"][0]
    assert streams["cuda"][1]["merge_pass"] == 4
    assert streams["cuda"][1]["merge_partition"] == 4
    assert not streams["cpu"][1].get("merge_pass")
    assert streams["cuda"][2] > 0 and streams["cpu"][2] > 0


def _fixed_maps(writer, maps=5, n=300, seed=43):
    """``maps`` one-partition map outputs of fixed-width raw records."""
    rng = np.random.default_rng(seed)
    for m in range(maps):
        writer.write(f"m{m}", [sorted((rng.bytes(10), rng.bytes(30))
                                      for _ in range(n))])
    return list(writer.map_ids)


def test_pushed_reduce_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """5 maps pushed by a port ShuffleServer with uda.tpu.push.enable to a
    task that armed push before the commits: on the card K1 merges the
    forest (4 launch pairs), every map's pushed prefix is adopted, and
    the stream is the bytes of the same task on the CPU."""
    import threading

    from uda_tpu_torch.merger import HostRoutingClient, MergeManager
    from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                         MOFWriter, read_index_file)
    from uda_tpu_torch.net import ShuffleServer
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.metrics import metrics

    root = str(tmp_path)
    mids = _fixed_maps(MOFWriter(root, "job"))
    total = sum(read_index_file(f"{root}/job/{m}/file.out.index",
                                "")[0].part_length for m in mids)
    conf = Config({"uda.tpu.push.enable": True, "mapred.rdma.buf.size": 4})
    engine = DataEngine(DirIndexResolver(root), conf)
    streams = {}
    try:
        for dev in ("cuda", "cpu"):
            server = ShuffleServer(engine, conf, host="127.0.0.1",
                                   port=0).start()
            addr = f"127.0.0.1:{server.port}"
            router = HostRoutingClient(config=conf)
            mm = MergeManager(router, "uda.tpu.RawBytes", conf, device=dev)
            out = bytearray()
            metrics.reset()
            try:
                staging = mm.arm_push("job", 0, hosts={addr})
                full = threading.Event()
                offer = staging.offer

                def gated(*args, offer=offer, staging=staging, full=full):
                    verdict = offer(*args)
                    if staging.staged_bytes() == total:
                        full.set()
                    return verdict

                staging.offer = gated
                for m in mids:
                    server.notify_commit("job", m)
                assert full.wait(30)
                _build.reset_launches()
                mm.run("job", [(addr, m) for m in mids], 0, out.extend)
                torch.cuda.synchronize()
            finally:
                router.stop()
                server.stop()
            streams[dev] = (bytes(out), dict(_build.launches),
                            metrics.get("push.adopted"))
    finally:
        engine.stop()
    assert streams["cuda"][0] == streams["cpu"][0]
    assert streams["cuda"][1]["merge_pass"] == 4
    assert streams["cuda"][1]["merge_partition"] == 4
    assert streams["cuda"][2] == streams["cpu"][2] == 5


def test_store_spilled_reduce_on_the_card_matches_the_cpu(cuda_device,
                                                          tmp_path):
    """5 maps written through MOFWriter(store=) with a 1 KB watermark
    (each map spills to the blob tier as the next one lands), served by a
    port ShuffleServer whose engine routes them through the store: the
    card's stream (4 K1 launch pairs) is the CPU's."""
    from uda_tpu_torch.merger import HostRoutingClient, MergeManager
    from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                         MOFWriter, StoreManager)
    from uda_tpu_torch.net import ShuffleServer
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.metrics import metrics

    resolver = DirIndexResolver(str(tmp_path / "local"))
    mgr = StoreManager(resolver, str(tmp_path / "blob"),
                       watermark_bytes=1 << 10)
    mids = _fixed_maps(MOFWriter(str(tmp_path / "local"), "job",
                                 store=mgr))
    assert len(mgr.migrations()) == 5
    conf = Config({"mapred.rdma.buf.size": 4})
    engine = DataEngine(resolver, conf)
    engine.attach_store(mgr)
    server = ShuffleServer(engine, conf, host="127.0.0.1", port=0).start()
    entries = [(f"127.0.0.1:{server.port}", m) for m in mids]
    streams = {}
    try:
        for dev in ("cuda", "cpu"):
            router = HostRoutingClient(config=conf)
            out = bytearray()
            metrics.reset()
            _build.reset_launches()
            try:
                MergeManager(router, "uda.tpu.RawBytes", conf,
                             device=dev).run("job", entries, 0, out.extend)
                torch.cuda.synchronize()
            finally:
                router.stop()
            streams[dev] = (bytes(out), dict(_build.launches),
                            metrics.get("store.read.bytes"))
    finally:
        server.stop()
        mgr.close()
        engine.stop()
    assert streams["cuda"][0] == streams["cpu"][0]
    assert streams["cuda"][1]["merge_pass"] == 4
    assert streams["cuda"][2] > 0 and streams["cpu"][2] > 0
