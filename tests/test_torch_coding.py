"""The port's k-of-n coded map outputs (uda_tpu_torch.coding, the v2 index,
the coded writer, stripe reconstruction and the scrub) against the JAX
package's on the same inputs, made from a seed with numpy: GF(2^8)
products and inverses, Reed-Solomon parity and every decode, v2 index and
coded-tree files byte for byte, shard synthesis, and ``MergeManager.run``
with ``uda.tpu.coding.scheme`` ending in the reference's stream where a
supplier is dead, where only the primary holds the stripe, where a stale
shard answers first, and where the ``coding.decode`` failpoint fires.
Bytes are the bar: no tolerance."""

import itertools
import os
import threading

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import coding as jcoding
from uda_tpu.coding import gf256 as jgf256
from uda_tpu.coding import rs as jrs
from uda_tpu.coding import scrub as jscrub
from uda_tpu.merger import HostRoutingClient as JHostRoutingClient
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.mofserver import index as jindex
from uda_tpu.mofserver import writer as jwriter
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import coding
from uda_tpu_torch.coding import gf256, rs, scrub
from uda_tpu_torch.coding.recovery import StripeContext
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                  MergeManager, PenaltyBox, RecoveryLedger,
                                  Segment)
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                     FetchResult, ShuffleRequest, index,
                                     writer)
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.retry import RetryPolicy

JOB = "job_coding"
SCHEMES = [(2, 3), (2, 4), (4, 6)]
RAW = "uda.tpu.RawBytes"


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    yield
    metrics.reset()


def _blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def _records(num: int, seed: int, val: int = 24) -> list:
    rng = np.random.default_rng(seed)
    return sorted((rng.bytes(10), rng.bytes(val)) for _ in range(num))


def _tree_files(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# -- GF(2^8) and Reed-Solomon ------------------------------------------------

def test_gf256_tables_equal_reference():
    assert np.array_equal(gf256.EXP, jgf256.EXP)
    assert np.array_equal(gf256.LOG, jgf256.LOG)
    assert np.array_equal(gf256.MUL, jgf256.MUL)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("r,c,width", [(1, 1, 1), (3, 5, 17), (4, 4, 256),
                                       (7, 2, 1001)])
def test_matmul_matches_reference(seed, r, c, width):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (r, c), dtype=np.uint8)
    x = rng.integers(0, 256, (c, width), dtype=np.uint8)
    got = gf256.matmul(a, x)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jgf256.matmul(a, x))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_inv_matrix_matches_reference(seed, k):
    """A random invertible matrix (a Cauchy minor with rows scaled and
    shuffled by the seed) inverts to the reference's bytes, and the
    product with its inverse is the identity."""
    rng = np.random.default_rng(seed)
    a = rs.parity_matrix(k, 2 * k)
    scale = rng.integers(1, 256, k)
    a = np.stack([gf256.mul_vec(int(s), row) for s, row in zip(scale, a)])
    a = a[rng.permutation(k)]
    inv = gf256.inv_matrix(a)
    assert np.array_equal(inv, jgf256.inv_matrix(a))
    assert np.array_equal(gf256.matmul(a, inv), np.eye(k, dtype=np.uint8))


def test_singular_matrix_raises_in_both():
    z = np.zeros((2, 2), dtype=np.uint8)
    with pytest.raises(np.linalg.LinAlgError):
        gf256.inv_matrix(z)
    with pytest.raises(np.linalg.LinAlgError):
        jgf256.inv_matrix(z)


def _lengths(k: int) -> tuple:
    return (0, 1, k - 1, 1001)


@pytest.mark.parametrize("k,n", SCHEMES)
def test_encode_parity_matches_reference(k, n):
    assert np.array_equal(rs.parity_matrix(k, n), jrs.parity_matrix(k, n))
    for size in _lengths(k):
        blob = _blob(size + 7 * k, size)
        assert rs.split_data(blob, k) == jrs.split_data(blob, k)
        assert rs.encode_parity(blob, k, n) == jrs.encode_parity(blob, k, n)
        assert rs.chunk_len(size, k) == jrs.chunk_len(size, k)


@pytest.mark.parametrize("k,n", SCHEMES)
def test_decode_every_erasure_pattern(k, n):
    """Any k of the n chunks decode to the blob, in the port and the
    reference alike, over every k-subset of the stripe."""
    for size in _lengths(k):
        blob = _blob(size + 11 * n, size)
        chunks = dict(enumerate(rs.split_data(blob, k)))
        chunks.update({k + j: p for j, p in
                       enumerate(rs.encode_parity(blob, k, n))})
        for subset in itertools.combinations(range(n), k):
            have = {i: chunks[i] for i in subset}
            got = rs.decode(have, k, n, size)
            assert got == blob, (k, n, size, subset)
            assert got == jrs.decode(have, k, n, size)


def test_decode_failure_modes_raise_storage_error():
    blob = bytes(range(256)) * 3
    data = dict(enumerate(rs.split_data(blob, 4)))
    with pytest.raises(errors.StorageError, match="unrecoverable"):
        rs.decode({0: data[0]}, 4, 6, len(blob))
    with pytest.raises(errors.StorageError):
        rs.decode({0: data[0], 9: b"x"}, 4, 6, len(blob))
    with pytest.raises(errors.StorageError, match="geometry"):
        rs.encode_parity(blob, 5, 4)


# -- schemes, shard ids, placement -------------------------------------------

@pytest.mark.parametrize("spec", ["", "rs:4:6", "rs:1:1", "rs:0:4", "rs:5:4",
                                  "xor:2:3", "rs:4", "rs:a:b"])
def test_parse_scheme_matches_reference(spec):
    try:
        want = jcoding.parse_scheme(spec)
    except jerrors.ConfigError:
        with pytest.raises(errors.ConfigError):
            coding.parse_scheme(spec)
        return
    got = coding.parse_scheme(spec)
    assert (None if got is None else (got.k, got.n, got.parity, str(got))) \
        == (None if want is None else (want.k, want.n, want.parity,
                                       str(want)))


@pytest.mark.parametrize("spec", ["", "a=r0, b=r0 ,c=r1", "a", "a=", "=r0",
                                  "a=r0,b"])
def test_parse_domains_matches_reference(spec):
    try:
        want = jcoding.parse_domains(spec)
    except jerrors.ConfigError:
        with pytest.raises(errors.ConfigError):
            coding.parse_domains(spec)
        return
    assert coding.parse_domains(spec) == want


def test_shard_ids_and_placement_match_reference():
    for mid, i in (("m_01", 3), ("attempt_x_m_000001_0", 0)):
        sid = coding.shard_map_id(mid, i)
        assert sid == jcoding.shard_map_id(mid, i)
        assert coding.parse_shard_id(sid) == (mid, i)
    assert coding.parse_shard_id("m_01") is None
    hosts = [f"h{i}" for i in range(6)]
    doms = {"h0": "A", "h1": "A", "h2": "B", "h3": "B", "h4": "C"}
    for count in range(1, 7):
        for p in range(count):
            labels = coding.domain_labels(hosts[:count], doms)
            assert coding.stripe_order(count, p, labels) == \
                jcoding.stripe_order(count, p, labels)
            for chunk in range(8):
                for d in (None, doms):
                    assert coding.stripe_host(hosts[:count], hosts[p],
                                              chunk, domains=d) == \
                        jcoding.stripe_host(hosts[:count], hosts[p], chunk,
                                            domains=d)
    assert coding.stripe_host([], "x", 2) == "x"
    with pytest.raises(errors.ConfigError):
        coding.stripe_order(4, 0, ["r0"])


# -- the v2 index -------------------------------------------------------------

def _index_cases():
    triples = [(0, 100, 100), (100, 57, 57), (157, 0, 0)]
    locs = [[(200, 25), (225, 25)], [(250, 15), (265, 15)], [(0, 0), (0, 0)]]
    return triples, locs


def test_v2_index_files_are_the_same_bytes(tmp_path):
    triples, locs = _index_cases()
    mine, ref = str(tmp_path / "port.index"), str(tmp_path / "ref.index")
    index.write_index_file(mine, triples, stripe=(4, 6, locs))
    jindex.write_index_file(ref, triples, stripe=(4, 6, locs))
    with open(mine, "rb") as a, open(ref, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data.startswith(index.INDEX_MAGIC)


def test_each_package_reads_the_others_v2_index(tmp_path):
    triples, locs = _index_cases()
    mine, ref = str(tmp_path / "port.index"), str(tmp_path / "ref.index")
    index.write_index_file(mine, triples, stripe=(4, 6, locs))
    jindex.write_index_file(ref, triples, stripe=(4, 6, locs))
    got = index.read_index_file(ref, "/mof")
    want = jindex.read_index_file(mine, "/mof")
    assert [(r.start_offset, r.raw_length, r.part_length, r.path,
             r.stripe.k, r.stripe.n, r.stripe.parity) for r in got] == \
        [(r.start_offset, r.raw_length, r.part_length, r.path,
          r.stripe.k, r.stripe.n, r.stripe.parity) for r in want]
    assert got[1].stripe.parity == ((250, 15), (265, 15))


def test_v1_index_still_reads(tmp_path):
    triples, _ = _index_cases()
    path = str(tmp_path / "v1.index")
    jindex.write_index_file(path, triples)
    recs = index.read_index_file(path, "/mof")
    assert [(r.start_offset, r.raw_length, r.part_length) for r in recs] \
        == triples
    assert all(r.stripe is None for r in recs)


@pytest.mark.parametrize("damage", ["truncate", "version", "geometry"])
def test_damaged_v2_index_raises_storage_error(tmp_path, damage):
    triples, locs = _index_cases()
    path = str(tmp_path / "v2.index")
    index.write_index_file(path, triples, stripe=(4, 6, locs))
    data = bytearray(open(path, "rb").read())
    if damage == "truncate":
        data = data[:-5]
    elif damage == "version":
        data[4:6] = (3).to_bytes(2, "big")
    else:
        data[6:8] = (7).to_bytes(2, "big")   # k > n
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(errors.StorageError):
        index.read_index_file(path, "/mof")


# -- the coded writer ---------------------------------------------------------

def _partitions(seed: int, nparts: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [_records(int(rng.integers(0, 60)), seed + r)
            for r in range(nparts)]


@pytest.mark.parametrize("spec", ["rs:4:6", "rs:2:3", "rs:3:3"])
def test_mofwriter_with_scheme_writes_the_reference_tree(tmp_path, spec):
    parts = _partitions(3)
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    w = writer.MOFWriter(mine, JOB, scheme=coding.parse_scheme(spec))
    jw = jwriter.MOFWriter(ref, JOB, scheme=jcoding.parse_scheme(spec))
    for m in range(2):
        w.write(f"m{m}", parts)
        jw.write(f"m{m}", parts)
    got = _tree_files(mine)
    assert got == _tree_files(ref) and len(got) == 4


@pytest.mark.parametrize("domains", [None, "racks"])
@pytest.mark.parametrize("spec", ["rs:2:4", "rs:4:6"])
def test_striped_writer_writes_the_reference_tree(tmp_path, spec, domains):
    parts = _partitions(5)
    trees = {}
    for side, wmod, cmod in (("port", writer, coding),
                             ("ref", jwriter, jcoding)):
        roots = [str(tmp_path / side / f"r{i}") for i in range(4)]
        doms = ({r: f"rack{i % 2}" for i, r in enumerate(roots)}
                if domains else None)
        wr = wmod.MOFWriter(roots[0], JOB, scheme=cmod.parse_scheme(spec),
                            supplier_roots=roots, supplier_index=0,
                            domains=doms)
        for m in range(4):
            wr.supplier_index = m % 4
            wr.write(f"m_{m:04d}", parts)
        trees[side] = _tree_files(str(tmp_path / side))
    assert trees["port"] == trees["ref"]
    assert any("~s" in p for p in trees["port"])   # peer shards exist


def test_resolver_synthesizes_the_reference_shard_records(tmp_path):
    scheme = coding.parse_scheme("rs:3:5")
    writer.write_map_output(str(tmp_path / JOB / "m0"), _partitions(7, 4),
                            scheme=scheme)
    mine = DirIndexResolver(str(tmp_path))
    ref = JDirIndexResolver(str(tmp_path))
    for chunk in range(5):
        sid = coding.shard_map_id("m0", chunk)
        for r in range(4):
            a, b = mine.resolve(JOB, sid, r), ref.resolve(JOB, sid, r)
            assert (a.start_offset, a.raw_length, a.part_length, a.path) \
                == (b.start_offset, b.raw_length, b.part_length, b.path)
    with pytest.raises(errors.StorageError, match="out of range"):
        mine.resolve(JOB, coding.shard_map_id("m0", 5), 0)


def test_served_shards_equal_the_codec(tmp_path):
    """The primary serves each chunk as the codec's bytes, with the full
    partition's length as the decode-trim total."""
    scheme = coding.parse_scheme("rs:3:5")
    writer.write_map_output(str(tmp_path / JOB / "m0"), [_records(60, 3)],
                            scheme=scheme)
    eng = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    try:
        full = eng.submit(ShuffleRequest(JOB, "m0", 0, 0, 1 << 20)
                          ).result().data
        data = rs.split_data(bytes(full), 3)
        parity = rs.encode_parity(bytes(full), 3, 5)
        for i in range(5):
            got = eng.submit(ShuffleRequest(
                JOB, coding.shard_map_id("m0", i), 0, 0, 1 << 20)).result()
            assert bytes(got.data) == (data[i] if i < 3 else parity[i - 3])
            assert got.raw_length == len(full)
    finally:
        eng.stop()


def test_codec_is_refused_naming_compress(tmp_path):
    """``compress`` is ported, so the codec refusal is gone: a codec
    writes compressed map outputs, plain and striped, file for file the
    reference's with the same codec (compressed before coding)."""
    from uda_tpu.compress import get_codec as jget_codec
    from uda_tpu_torch.compress import get_codec

    parts = [_records(60, 3), _records(40, 4)]
    scheme = coding.parse_scheme("rs:2:3")
    jscheme = jcoding.parse_scheme("rs:2:3")
    for side, mod, codec, sch in (
            ("p", writer, get_codec("zlib"), scheme),
            ("r", jwriter, jget_codec("zlib"), jscheme)):
        mod.MOFWriter(str(tmp_path / side / "a"), JOB, codec=codec) \
            .write("m0", parts)
        mod.write_map_output(str(tmp_path / side / "b" / "m0"), parts,
                             codec=codec, scheme=sch)
        roots = [str(tmp_path / side / f"h{i}") for i in range(3)]
        mod.write_striped_map_output(roots, 1, JOB, "m0", parts, sch,
                                     codec=codec)
    got, want = (_tree_files(str(tmp_path / side)) for side in "pr")
    assert got == want and len(got) == 2 + 2 + 2 * 3
    idx = jindex.read_index_file(
        str(tmp_path / "p" / "a" / JOB / "m0" / "file.out.index"),
        str(tmp_path / "p" / "a" / JOB / "m0" / "file.out"))
    assert all(r.raw_length != r.part_length for r in idx)


# -- MergeManager.run through a coded tree ------------------------------------

class _DeadClient(LocalFetchClient):
    """A supplier that answers every fetch with a transport fault, late,
    as a dead host's dial failure does."""

    def start_fetch(self, req, on_complete):
        t = threading.Timer(0.002, on_complete, args=(
            errors.TransportError(f"supplier down ({req.map_id})"),))
        t.daemon = True
        t.start()


class _JDeadClient(JLocalFetchClient):
    def start_fetch(self, req, on_complete):
        t = threading.Timer(0.002, on_complete, args=(
            jerrors.TransportError(f"supplier down ({req.map_id})"),))
        t.daemon = True
        t.start()


HOSTS = ["h0", "h1", "h2", "h3"]


def _striped_tree(tmp_path, spec: str, num_maps: int, nrec: int = 90):
    """``num_maps`` maps striped over the four roots by the port's
    writer, map m's primary on h(m % 4) -> (roots, entries)."""
    scheme = coding.parse_scheme(spec)
    roots = [str(tmp_path / f"root_{h}") for h in HOSTS]
    rng = np.random.default_rng(11)
    maps = []
    for m in range(num_maps):
        mid = f"m_{m:04d}"
        parts = [sorted((rng.bytes(10), rng.bytes(30)) for _ in range(nrec))
                 for _ in range(2)]
        writer.write_striped_map_output(roots, m % 4, JOB, mid, parts,
                                        scheme)
        maps.append((HOSTS[m % 4], mid))
    return roots, maps


def _coded_run(port: bool, roots, maps, conf: dict, dead=("h2",)):
    """One reduce (partition 1) over the striped tree with the hosts in
    ``dead`` failing every fetch -> (bytes emitted, stream, manager)."""
    if port:
        engines = {h: DataEngine(DirIndexResolver(r), Config(conf))
                   for h, r in zip(HOSTS, roots)}
        clients = {h: (_DeadClient if h in dead else LocalFetchClient)(e)
                   for h, e in engines.items()}
        mm = MergeManager(HostRoutingClient(lambda h: clients[h]), RAW,
                          Config(conf), device="cpu")
    else:
        engines = {h: JDataEngine(JDirIndexResolver(r), JConfig(conf))
                   for h, r in zip(HOSTS, roots)}
        clients = {h: (_JDeadClient if h in dead else JLocalFetchClient)(e)
                   for h, e in engines.items()}
        mm = JMergeManager(JHostRoutingClient(lambda h: clients[h]), RAW,
                           JConfig(conf))
    out = bytearray()
    try:
        n = mm.run(JOB, maps, 1, out.extend)
    finally:
        for e in engines.values():
            e.stop()
    return n, bytes(out), mm


MODES = {
    "default": {},
    "overlap_off": {"uda.tpu.merge.overlap": False},
    "streaming": {"uda.tpu.online.streaming": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dead_supplier_reconstructs_to_the_reference_stream(tmp_path, mode):
    """rs:2:4 over four suppliers, h2 dead from the start: its maps are
    rebuilt from any two shards on the survivors, the stream equals the
    reference's byte for byte, and nothing falls back."""
    roots, maps = _striped_tree(tmp_path, "rs:2:4", 8)
    conf = dict(MODES[mode], **{"uda.tpu.coding.scheme": "rs:2:4",
                                "uda.tpu.fetch.retries": 1,
                                "mapred.rdma.buf.size": 1})
    if mode == "streaming":
        conf["uda.tpu.spill.dirs"] = str(tmp_path / "spill")
    got = _coded_run(True, roots, maps, conf)
    want = _coded_run(False, roots, maps, conf)
    assert got[:2] == want[:2] and got[0] > 0
    assert metrics.get("coding.reconstructed.partitions") == 2
    assert metrics.get("coding.reconstructed.partitions") == \
        jmetrics.get("coding.reconstructed.partitions")
    assert metrics.get("coding.shard.fetches") >= 4
    assert metrics.get("fallback.signals") == 0
    kinds = {e["kind"] for e in got[2].ledger.events()}
    assert {"reconstructed", "fault", "shard_fetched"} <= kinds


def test_two_dead_suppliers_of_rs_2_4_still_reconstruct(tmp_path):
    roots, maps = _striped_tree(tmp_path, "rs:2:4", 4)
    conf = {"uda.tpu.coding.scheme": "rs:2:4", "uda.tpu.fetch.retries": 0}
    got = _coded_run(True, roots, maps, conf, dead=("h1", "h2"))
    want = _coded_run(False, roots, maps, conf, dead=("h1", "h2"))
    assert got[:2] == want[:2]
    assert metrics.get("fallback.signals") == 0


def test_three_dead_suppliers_fall_back_in_both(tmp_path):
    roots, maps = _striped_tree(tmp_path, "rs:2:4", 4)
    conf = {"uda.tpu.coding.scheme": "rs:2:4", "uda.tpu.fetch.retries": 0}
    dead = ("h0", "h1", "h2")
    with pytest.raises(errors.FallbackSignal) as got:
        _coded_run(True, roots, maps, conf, dead=dead)
    with pytest.raises(jerrors.FallbackSignal) as want:
        _coded_run(False, roots, maps, conf, dead=dead)
    assert type(got.value.cause).__name__ == \
        type(want.value.cause).__name__ == "StorageError"
    assert "unrecoverable" in str(got.value.cause)


def test_dead_supplier_without_coding_falls_back(tmp_path):
    roots, maps = _striped_tree(tmp_path, "rs:2:4", 4)
    with pytest.raises(errors.FallbackSignal):
        _coded_run(True, roots, maps, {"uda.tpu.fetch.retries": 0})
    assert metrics.get("coding.recover.attempts") == 0


# -- the reconstruction's timers ------------------------------------------------

RECOVERY_TIMERS = ("coding_recover", "coding_decode")


def _spans_named(name: str) -> list:
    return [s for s in metrics.spans if s["name"] == name]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recovery_timers_fire_once_a_rebuilt_partition(tmp_path, mode):
    """With spans on, each rebuilt partition has one ``coding_recover``
    span, a child of its segment's fetch span, holding one
    ``coding_decode`` span; the two counters hold their spans' time."""
    roots, maps = _striped_tree(tmp_path, "rs:2:4", 8)
    conf = dict(MODES[mode], **{"uda.tpu.coding.scheme": "rs:2:4",
                                "uda.tpu.fetch.retries": 1,
                                "mapred.rdma.buf.size": 1})
    if mode == "streaming":
        conf["uda.tpu.spill.dirs"] = str(tmp_path / "spill")
    metrics.enable_spans()
    _coded_run(True, roots, maps, conf)
    rebuilt = metrics.get("coding.reconstructed.partitions")
    by_id = {s["id"]: s for s in metrics.spans}
    recover, decode = (_spans_named(t) for t in RECOVERY_TIMERS)
    assert rebuilt == 2 and len(recover) == len(decode) == 2
    assert {by_id[s["parent"]]["name"] for s in recover} == {"fetch.segment"}
    assert {s["parent"] for s in decode} == {s["id"] for s in recover}
    assert not any("error" in s.get("attrs", {}) for s in recover)
    for t, spans in zip(RECOVERY_TIMERS, (recover, decode)):
        assert metrics.get(t + "_time") == pytest.approx(
            sum(s["dur"] for s in spans), rel=0.2)
    assert metrics.get("coding_recover_time") > \
        metrics.get("coding_decode_time") > 0


def test_recovery_timers_count_without_spans(tmp_path):
    """Spans off (the default): no span, but both counters advance."""
    roots, maps = _striped_tree(tmp_path, "rs:2:3", 4)
    conf = {"uda.tpu.coding.scheme": "rs:2:3", "uda.tpu.fetch.retries": 0}
    _coded_run(True, roots, maps, conf)
    assert metrics.get("coding.reconstructed.partitions") == 1
    assert metrics.spans == []
    assert all(metrics.get(t + "_time") > 0 for t in RECOVERY_TIMERS)


def test_an_unrecoverable_stripe_stops_the_recover_timer(tmp_path):
    """Three of four suppliers dead: every rung's timer stops, its span
    carrying the error, and nothing is decoded."""
    roots, maps = _striped_tree(tmp_path, "rs:2:4", 4)
    conf = {"uda.tpu.coding.scheme": "rs:2:4", "uda.tpu.fetch.retries": 0}
    metrics.enable_spans()
    with pytest.raises(errors.FallbackSignal):
        _coded_run(True, roots, maps, conf, dead=("h0", "h1", "h2"))
    recover = _spans_named("coding_recover")
    assert recover and len(recover) == metrics.get("coding.recover.attempts")
    assert {s["attrs"].get("error") for s in recover} == {"StorageError"}
    assert metrics.get("coding_recover_time") > 0
    assert metrics.get("coding_decode_time") == 0
    assert _spans_named("coding_decode") == []


@pytest.mark.parametrize("timer", RECOVERY_TIMERS)
def test_recovery_timers_are_port_timers_of_the_fetch(timer):
    from uda_tpu.utils.metrics import SPAN_REGISTRY as JSPAN_REGISTRY
    from uda_tpu_torch.utils import critpath
    from uda_tpu_torch.utils.metrics import PORT_TIMERS

    assert timer in PORT_TIMERS and timer not in JSPAN_REGISTRY
    assert critpath.PORT_SPAN_BUCKETS[timer] == "fetch"
    block = critpath.analyze([
        {"name": "reduce_task", "ts": 0.0, "dur": 1.0, "tid": 1, "trace": 1,
         "id": 1, "parent": None},
        {"name": timer, "ts": 0.25, "dur": 0.5, "tid": 2, "trace": 1,
         "id": 2, "parent": 1}])
    assert block["buckets"]["fetch"]["busy_s"] == pytest.approx(0.5)


class _FailPlain(LocalFetchClient):
    """Faults direct partition fetches; shard fetches pass."""

    def start_fetch(self, req, on_complete):
        if coding.parse_shard_id(req.map_id) is None:
            on_complete(errors.TransportError("primary path penalized"))
            return
        super().start_fetch(req, on_complete)


def _single_host_segment(tmp_path, spec, client_cls, retries=1, seed=6):
    scheme = coding.parse_scheme(spec)
    recs = _records(70, seed)
    writer.write_map_output(str(tmp_path / JOB / "m0"), [recs],
                            scheme=scheme)
    eng = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    seg = Segment(client_cls(eng), JOB, "m0", 0, 1 << 20,
                  policy=RetryPolicy(retries=retries),
                  stripe=StripeContext(scheme, [""]))
    return recs, eng, seg


def test_decode_under_penalty_on_a_single_host(tmp_path):
    """No peers at all: the plain fetch fails and every shard is
    synthesized from the primary's own parity section; the partition
    still reconstructs, to the bytes the reference's reduce emits."""
    recs, eng, seg = _single_host_segment(tmp_path, "rs:4:6", _FailPlain)
    try:
        seg.start()
        seg.wait(10.0)
        got = list(seg.record_batch().iter_records())
    finally:
        eng.stop()
    assert got == recs
    assert metrics.get("coding.reconstructed.partitions") == 1
    # the same single-host task through both managers: equal streams
    conf = {"uda.tpu.coding.scheme": "rs:4:6", "uda.tpu.fetch.retries": 1,
            "uda.tpu.merge.overlap": False}
    outs = []
    for port in (True, False):
        if port:
            e = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
            mm = MergeManager(_FailPlain(e), RAW, Config(conf), device="cpu")
        else:
            class JFailPlain(JLocalFetchClient):
                def start_fetch(self, req, on_complete):
                    if jcoding.parse_shard_id(req.map_id) is None:
                        on_complete(jerrors.TransportError("penalized"))
                        return
                    super().start_fetch(req, on_complete)
            e = JDataEngine(JDirIndexResolver(str(tmp_path)), JConfig(conf))
            mm = JMergeManager(JFailPlain(e), RAW, JConfig(conf))
        out = bytearray()
        try:
            mm.run(JOB, ["m0"], 0, out.extend)
        finally:
            e.stop()
        outs.append(bytes(out))
    assert outs[0] == outs[1]


class _StaleShard1(LocalFetchClient):
    """The plain fetch fails; shard 1 answers at once with a stale map
    attempt's bytes (another identity); the real shards answer only after
    it, released by an event (no sleep decides the order)."""

    def __init__(self, engine):
        super().__init__(engine)
        self.stale_sent = threading.Event()

    def start_fetch(self, req, on_complete):
        shard = coding.parse_shard_id(req.map_id)
        if shard is None:
            on_complete(errors.TransportError("primary down"))
            return
        if shard[1] == 1:
            on_complete(FetchResult(b"Z" * 9, 999, 9, 0, "/stale",
                                    last=True))
            self.stale_sent.set()
            return

        def late(res):
            def deliver():
                self.stale_sent.wait(10.0)
                on_complete(res)
            threading.Thread(target=deliver, daemon=True).start()

        super().start_fetch(req, late)


def test_a_stale_shard_cannot_poison_the_reconstruction(tmp_path):
    recs, eng, seg = _single_host_segment(tmp_path, "rs:2:4", _StaleShard1,
                                          retries=0, seed=33)
    try:
        seg.start()
        seg.wait(10.0)
        got = list(seg.record_batch().iter_records())
    finally:
        eng.stop()
    assert got == recs
    assert metrics.get("coding.reconstructed.partitions") == 1
    assert metrics.get("coding.shard.fetches") >= 3


@pytest.mark.parametrize("port", [True, False])
def test_coding_decode_failpoint_fails_the_segment(tmp_path, port):
    """The coding.decode site arms in the port's registry (no longer
    refused): an injected decode fault turns a would-have-recovered
    segment into the terminal StorageError, as the reference's does."""
    scheme = "rs:2:3"
    recs = _records(30, 7)
    writer.write_map_output(str(tmp_path / JOB / "m0"), [recs],
                            scheme=coding.parse_scheme(scheme))
    conf = {"uda.tpu.coding.scheme": scheme, "uda.tpu.fetch.retries": 0,
            "uda.tpu.merge.overlap": False}
    if port:
        eng = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
        mm = MergeManager(_FailPlain(eng), RAW, Config(conf), device="cpu")
        registry, fallback = failpoints, errors.FallbackSignal
    else:
        class JFailPlain(JLocalFetchClient):
            def start_fetch(self, req, on_complete):
                if jcoding.parse_shard_id(req.map_id) is None:
                    on_complete(jerrors.TransportError("down"))
                    return
                super().start_fetch(req, on_complete)
        eng = JDataEngine(JDirIndexResolver(str(tmp_path)), JConfig(conf))
        mm = JMergeManager(JFailPlain(eng), RAW, JConfig(conf))
        registry, fallback = jfailpoints, jerrors.FallbackSignal
    try:
        with registry.scoped("coding.decode=error"):
            with pytest.raises(fallback) as err:
                mm.run(JOB, ["m0"], 0, lambda b: None)
    finally:
        eng.stop()
    assert type(err.value.cause).__name__ == "StorageError"
    assert "coding.decode" in str(err.value.cause)
    got = (metrics if port else jmetrics).get("coding.recover.failures")
    assert got == 1


def test_reconstruction_ranks_survivors_by_penalty_box():
    """Candidates: non-primary first, then healthiest by the ledger, then
    data chunks before parity; the same order as the reference's."""
    from uda_tpu.coding.recovery import StripeContext as JStripeContext
    from uda_tpu.coding.recovery import _Reconstruction as JRec
    from uda_tpu.merger import PenaltyBox as JPenaltyBox
    from uda_tpu.merger import RecoveryLedger as JRecoveryLedger
    from uda_tpu_torch.coding.recovery import _Reconstruction

    scheme, jscheme = coding.CodingScheme(2, 4), jcoding.CodingScheme(2, 4)
    box, jbox = PenaltyBox(threshold=1, penalty_s=60), \
        JPenaltyBox(threshold=1, penalty_s=60)
    for b in (box, jbox):
        b.punish("h3")
    req = ShuffleRequest(JOB, "m0", 0, 0, 1 << 20, host="h1")
    got = _Reconstruction(None, req, StripeContext(
        scheme, HOSTS, ledger=RecoveryLedger(box)), None)._rank_candidates()
    want = JRec(None, req, JStripeContext(
        jscheme, HOSTS, ledger=JRecoveryLedger(jbox)), None
    )._rank_candidates()
    assert got == want
    assert got[-1] == (0, "h1")   # the failed primary comes last


# -- the scrub ------------------------------------------------------------------

def _coded_tree(tmp_path, wmod, cmod, nroots=3, spec="rs:2:3"):
    roots = [str(tmp_path / f"r{i}") for i in range(nroots)]
    parts = [[(b"key%03d" % i, bytes(range(i % 7)) * 5)] for i in range(4)]
    wmod.write_striped_map_output(roots, 0, "jobS", "m_000", parts,
                                  cmod.parse_scheme(spec))
    return roots


def _peer_shard_files(roots) -> list:
    out = []
    for root in roots[1:]:
        for dirpath, _dirs, files in os.walk(root):
            if "file.out" in files:
                out.append(os.path.join(dirpath, "file.out"))
    return sorted(out)


def _scrub_report(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if k != "rows"}


def test_scrub_clean_tree_counts_stripes_as_the_reference(tmp_path):
    roots = _coded_tree(tmp_path, writer, coding)
    rep = scrub.scrub_roots(roots)
    assert _scrub_report(rep) == _scrub_report(jscrub.scrub_roots(roots))
    assert rep["maps"] == 1 and rep["stripes"] == 4
    assert rep["parity_mismatches"] == 0 and rep["shard_faults"] == 0
    assert metrics.get("coding.scrub.stripes") == 4.0
    assert metrics.get("coding.scrub.repairs") == 0.0


def test_scrub_finds_a_lost_shard_then_repairs_it(tmp_path):
    roots = _coded_tree(tmp_path, writer, coding)
    victim = _peer_shard_files(roots)[-1]
    with open(victim, "rb") as f:
        original = f.read()
    os.remove(victim)
    rep = scrub.scrub_roots(roots)                 # dump-only default
    assert rep["shard_faults"] >= 1 and rep["repaired"] == 0
    assert _scrub_report(rep) == _scrub_report(jscrub.scrub_roots(roots))
    assert not os.path.exists(victim)
    assert metrics.get("coding.scrub.repairs") >= 1.0
    rep2 = scrub.scrub_roots(roots, repair=True)
    assert rep2["repaired"] >= 1
    with open(victim, "rb") as f:
        assert f.read() == original                # byte-exact rebuild
    assert scrub.scrub_roots(roots)["shard_faults"] == 0


def test_scrub_finds_a_corrupt_shard(tmp_path):
    roots = _coded_tree(tmp_path, writer, coding)
    victim = _peer_shard_files(roots)[-1]
    with open(victim, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    rep = scrub.scrub_roots(roots)
    assert rep["shard_faults"] >= 1
    assert _scrub_report(rep) == _scrub_report(jscrub.scrub_roots(roots))
    assert scrub.scrub_roots(roots, repair=True)["repaired"] >= 1
    assert scrub.scrub_roots(roots)["shard_faults"] == 0


def test_scrub_repairs_the_reference_tree_to_its_bytes(tmp_path):
    """The port scrubs and repairs a tree the reference wrote."""
    roots = _coded_tree(tmp_path, jwriter, jcoding, nroots=4, spec="rs:2:4")
    before = _tree_files(str(tmp_path))
    for p in _peer_shard_files(roots):
        os.remove(p)
    rep = scrub.scrub_roots(roots, repair=True)
    assert rep["repaired"] >= 2
    assert _tree_files(str(tmp_path)) == before


def test_scrub_min_age_skips_fresh_maps(tmp_path):
    roots = _coded_tree(tmp_path, writer, coding)
    rep = scrub.scrub_roots(roots, min_age_s=3600)
    assert rep["maps"] == 0 and rep["stripes"] == 0
    rep2 = scrub.scrub_roots(roots, min_age_s=0)
    assert rep2["maps"] == 1 and rep2["shard_faults"] == 0


def test_scrub_survives_a_damaged_primary(tmp_path):
    roots = [str(tmp_path / f"r{i}") for i in range(3)]
    scheme = coding.parse_scheme("rs:2:3")
    for mid in ("m_000", "m_001"):
        parts = [[(b"k", b"v" * 9)] for _ in range(2)]
        writer.write_striped_map_output(roots, 0, "jobP", mid, parts, scheme)
    os.remove(os.path.join(roots[0], "jobP", "m_000", "file.out"))
    rep = scrub.scrub_roots(roots)
    assert rep["primary_faults"] == 1
    assert rep["maps"] == 1 and rep["stripes"] == 2
    assert rep["shard_faults"] == 0
    assert _scrub_report(rep) == _scrub_report(jscrub.scrub_roots(roots))


def test_scrub_never_repairs_healthy_shards_from_a_corrupt_primary(
        tmp_path):
    roots = _coded_tree(tmp_path, writer, coding)
    primary = os.path.join(roots[0], "jobS", "m_000", "file.out")
    with open(primary, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    shards = {p: open(p, "rb").read() for p in _peer_shard_files(roots)}
    rep = scrub.scrub_roots(roots, repair=True)
    assert rep["parity_mismatches"] >= 1
    assert rep["repaired"] == 0 and rep["shard_faults"] == 0
    for p, want in shards.items():
        with open(p, "rb") as f:
            assert f.read() == want


def test_maybe_scrub_interval_and_single_flight(tmp_path):
    roots = _coded_tree(tmp_path, writer, coding)
    scrub.scrub_state_reset()
    cfg = Config({"uda.tpu.coding.scheme": "rs:2:3",
                  "uda.tpu.coding.scrub.s": 3600})
    assert scrub.maybe_scrub(cfg, roots) is True
    assert scrub.maybe_scrub(cfg, roots) is False   # within the interval
    done = threading.Event()

    def wait_idle():
        while scrub._SCRUB_ACTIVE:
            threading.Event().wait(0.01)
        done.set()

    threading.Thread(target=wait_idle, daemon=True).start()
    assert done.wait(10.0)
    scrub.scrub_state_reset()
    assert scrub.maybe_scrub(Config({"uda.tpu.coding.scheme": "rs:2:3"}),
                             roots) is False        # interval 0: off
    assert scrub.maybe_scrub(Config({"uda.tpu.coding.scrub.s": 10}),
                             roots) is False        # coding off
    scrub.scrub_state_reset()
