"""The port's compression path (uda_tpu_torch.compress: codecs, block
framing, LZO1X, ``DecompressingClient``; ``MOFWriter(codec=)``) against the
JAX package's ``uda_tpu.compress``: the same block streams and MOF files
from the same codec, the same errors, and ``MergeManager.run`` over
compressed map outputs (in process and over the wire) equal to the
reference's run on the same files. LZO's rungs write different streams
(the pure-Python compressor emits literal runs only, the reference's C++
codec and liblzo2 real matches), so file comparisons pin the pure-Python
pair in both packages; the port's decoder must read what the reference's
native compressor writes."""

import ctypes.util
import functools
import io
import threading

import numpy as np
import pytest

from helpers import map_ids
from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import compress as jcompress
from uda_tpu.compress import lzo as jlzo
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.mofserver import writer as jwriter
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.failpoints import failpoints as jfailpoints
from uda_tpu.utils.ifile import IFileReader
from uda_tpu_torch import coding, compress
from uda_tpu_torch.coding.recovery import StripeContext
from uda_tpu_torch.compress import DecompressingClient, lzo
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                  MergeManager, Segment)
from uda_tpu_torch.merger.merge_manager import PenaltyBox
from uda_tpu_torch.merger.recovery import RecoveryLedger
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver,
                                     FetchResult, ShuffleRequest, writer)
from uda_tpu_torch.utils import comparators, errors
from uda_tpu_torch.utils import ifile as tifile
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (CompressionError, FallbackSignal,
                                        StorageError, TransportError)
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.retry import RetryPolicy, SpeculationPolicy

RAW = "uda.tpu.RawBytes"
JOB = "jobC"


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    with failpoints.scoped(""), jfailpoints.scoped(""):
        yield
    metrics.reset()


def _pinned_lzo(mod):
    """The pure-Python LZO1X pair of ``mod`` (either package's lzo
    module), the rung both packages have."""
    return (mod.lzo1x_compress_py,
            lambda data, n: mod.lzo1x_decompress_py(data, n))


def _codec(pkg, name: str):
    """``pkg``'s codec ``name`` ("lzo" pinned to the pure-Python pair)."""
    if name == "lzo":
        lz = lzo if pkg is compress else jlzo
        return pkg.Codec("lzo", *_pinned_lzo(lz))
    return pkg.get_codec(name)


CODECS = ["zlib", "snappy", "lzo"]


def _records(num: int, seed: int, val: int = 60) -> list:
    rng = np.random.default_rng(seed)
    return sorted((rng.bytes(10), rng.bytes(val)) for _ in range(num))


# -- codecs and block framing ------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
def test_block_streams_are_byte_identical(name):
    data = (b"hello world " * 5000) + bytes(range(256)) * 100
    for block in (4096, 256 * 1024):
        blob = compress.compress_block_stream(data, _codec(compress, name),
                                              block_size=block)
        want = jcompress.compress_block_stream(
            data, _codec(jcompress, name), block_size=block)
        assert blob == want
        assert compress.decompress_block_stream(
            want, _codec(compress, name)) == data
    assert compress.decompress_block_stream(compress.compress_block_stream(
        b"", _codec(compress, name)), _codec(compress, name)) == b""


def test_the_registry_matches_the_reference():
    """Every Hadoop class name maps to the same codec in both packages;
    an unknown class raises the same CompressionError."""
    for cls in jcompress._REGISTRY:
        if "lzo" in cls.lower():
            assert compress.get_codec(cls).name == "lzo"
            continue
        assert compress.get_codec(cls).name == jcompress.get_codec(cls).name
    assert set(compress._REGISTRY) == set(jcompress._REGISTRY)
    with pytest.raises(CompressionError) as got:
        compress.get_codec("com.example.NoSuchCodec")
    with pytest.raises(jerrors.CompressionError) as want:
        jcompress.get_codec("com.example.NoSuchCodec")
    assert str(got.value) == str(want.value)


def test_snappy_absence_raises_compression_error_in_both(monkeypatch):
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(compress, "_snappy_lib", None)
    monkeypatch.setattr(jcompress, "_snappy_lib", None)
    for cls in ("snappy", "org.apache.hadoop.io.compress.SnappyCodec"):
        with pytest.raises(CompressionError, match="libsnappy"):
            compress.get_codec(cls)
        with pytest.raises(jerrors.CompressionError, match="libsnappy"):
            jcompress.get_codec(cls)


@pytest.mark.parametrize("case", ["truncated_header", "truncated_body",
                                  "zlib_length"])
def test_corrupt_streams_fail_as_in_the_reference(case):
    data = b"data" * 1000
    blob = compress.compress_block_stream(data, _codec(compress, "zlib"))
    outcomes = []
    for pkg, err in ((compress, CompressionError),
                     (jcompress, jerrors.CompressionError)):
        codec = _codec(pkg, "zlib")
        with pytest.raises(err) as got:
            if case == "truncated_header":
                pkg.decompress_block_stream(blob + b"\x00\x00", codec)
            elif case == "truncated_body":
                pkg.decompress_block_stream(blob[:-3], codec)
            else:
                codec.decompress(blob[8:], len(data) - 1)
        outcomes.append(str(got.value))
    assert outcomes[0] == outcomes[1]


# -- LZO1X ---------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 2, 3, 4, 17, 18, 238, 239, 240,
                                  493, 4096, 100_003])
def test_lzo_pure_python_matches_the_reference(size):
    data = np.random.default_rng(size).bytes(size)
    blob = lzo.lzo1x_compress_py(data)
    assert blob == jlzo.lzo1x_compress_py(data)
    assert lzo.lzo1x_decompress_py(blob, size) == data


@pytest.mark.parametrize("stream,n,want", [
    # an overlapping M2 match after a 1-literal run, one trailing literal
    (bytes([18]) + b"a" + bytes([193, 0]) + b"b\x11\x00\x00", 9,
     b"aaaaaaaab"),
    # an M3 match: "cdef" from distance 6 after "abcdefgh"
    (bytes([25]) + b"abcdefgh" + bytes([34, 20, 0]) + b"\x11\x00\x00", 12,
     b"abcdefghcdef"),
], ids=["m2", "m3"])
def test_lzo_decodes_match_tokens(stream, n, want):
    assert lzo.lzo1x_decompress_py(stream, n) == want


@pytest.mark.parametrize("stream,n", [
    (b"\x12a\x11\x00\x00", 5),                          # wrong length
    (bytes([25]) + b"abc", 8),                          # truncated
    (bytes([18]) + b"a" + bytes([193, 9]) + b"b\x11\x00\x00", 9),  # underrun
    (bytes([18]) + b"a\x11\x00\x00zz", 1),              # trailing bytes
], ids=["length", "truncated", "underrun", "trailing"])
def test_lzo_malformed_streams_raise_as_in_the_reference(stream, n):
    with pytest.raises(CompressionError) as got:
        lzo.lzo1x_decompress_py(stream, n)
    with pytest.raises(jerrors.CompressionError) as want:
        jlzo.lzo1x_decompress_py(stream, n)
    assert str(got.value) == str(want.value)


LZO_INPUTS = {
    "empty": b"", "one": b"a", "abc": b"abc" * 3,
    "random": np.random.default_rng(123).bytes(50_000),
    "repeat": b"repeat me " * 5000, "zeros": bytes(1000),
    "small_alphabet": bytes(np.random.default_rng(5).integers(
        0, 4, 20_000, dtype=np.uint8)),
}


@pytest.mark.parametrize("name", sorted(LZO_INPUTS))
def test_lzo_decoder_reads_the_reference_native_streams(name):
    """Streams with real lzo1x_1 matches, written by the reference's
    native rung (its C++ codec here, liblzo2 where installed), decode
    with the port's pure-Python decoder."""
    data = LZO_INPUTS[name]
    source = jlzo.native_lzo_source()
    if not source:
        pytest.skip("this host has no native LZO compressor")
    compress_native = (jlzo._builtin_compress if source == "builtin"
                       else jlzo._native_compress)
    blob = compress_native(data)
    assert lzo.lzo1x_decompress_py(blob, len(data)) == data
    if name == "repeat":
        assert len(blob) < len(data) // 10  # matches, not literals


def test_lzo_ladder_is_liblzo2_then_pure_python():
    """The port's ladder is the reference's: liblzo2 where it is found,
    else the builtin C++ codec, and pure Python only with
    uda.tpu.use.native off. Each rung round-trips; without liblzo2 the
    builtin rungs of both packages write the same bytes."""
    has_lib = ctypes.util.find_library("lzo2") is not None
    assert lzo.native_lzo_source() == jlzo.native_lzo_source() == \
        ("liblzo2" if has_lib else "builtin")
    assert lzo.native_lzo_available()
    data = b"block payload " * 1000
    codec = compress.get_codec("lzo")
    assert codec.decompress(codec.compress(data), len(data)) == data
    if not has_lib:
        assert codec.compress(data) == jcompress.get_codec("lzo").compress(
            data)
    tifile.set_native_enabled(False)
    try:
        assert lzo.native_lzo_source() == ("liblzo2" if has_lib else "")
        codec = compress.get_codec("lzo")
        assert codec.decompress(codec.compress(data), len(data)) == data
        if not has_lib:
            assert codec.compress(data) == lzo.lzo1x_compress_py(data)
    finally:
        tifile.set_native_enabled(True)


# -- MOFWriter(codec=) ---------------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
def test_compressed_map_outputs_are_the_references_files(tmp_path, name):
    parts = [_records(150, 1), [], _records(40, 2, val=3000)]
    files = {}
    for side, pkg, wmod in (("p", compress, writer), ("r", jcompress,
                                                     jwriter)):
        w = wmod.MOFWriter(str(tmp_path / side), JOB,
                           codec=_codec(pkg, name))
        w.write("m0", parts)
        w.write("m1", parts[::-1])
        out = {}
        for mid in ("m0", "m1"):
            for f in ("file.out", "file.out.index"):
                with open(tmp_path / side / JOB / mid / f, "rb") as fh:
                    out[(mid, f)] = fh.read()
        files[side] = out
    assert files["p"] == files["r"]


# -- DecompressingClient --------------------------------------------------------

def _compressed_tree(root, name="zlib", maps=3, pkg=compress, wmod=writer,
                     seed=21):
    w = wmod.MOFWriter(root, JOB, codec=_codec(pkg, name))
    expected = []
    for m in range(maps):
        recs = _records(150, seed + m)
        expected += recs
        w.write(f"attempt_{JOB}_m_{m:06d}_0", [recs])
    return w.map_ids, expected


def _port_run(client, mids, conf, chunk=777):
    mm = MergeManager(client, RAW, Config(conf), device="cpu")
    mm.chunk_size = chunk  # not aligned to block boundaries
    out = bytearray()
    n = mm.run(JOB, mids, 0, out.extend)
    return n, bytes(out)


def _reference_run(root, mids, name, conf, chunk=777):
    codec = _codec(jcompress, name)
    engine = JDataEngine(JDirIndexResolver(root), JConfig(conf))
    try:
        mm = JMergeManager(jcompress.DecompressingClient(
            JLocalFetchClient(engine), codec), RAW, JConfig(conf))
        mm.chunk_size = chunk
        out = bytearray()
        n = mm.run(JOB, mids, 0, out.extend)
    finally:
        engine.stop()
    return n, bytes(out)


MODE_CONF = {"default": {},
             "overlap_off": {"uda.tpu.merge.overlap": False},
             "streaming": {"uda.tpu.online.streaming": True}}


@pytest.mark.parametrize("mode", sorted(MODE_CONF))
@pytest.mark.parametrize("name", CODECS)
def test_compressed_merge_matches_the_reference(tmp_path, name, mode):
    conf = dict(MODE_CONF[mode], **{"mapred.rdma.buf.size": 1})
    mids, expected = _compressed_tree(str(tmp_path), name)
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
    try:
        got = _port_run(DecompressingClient(LocalFetchClient(engine),
                                            _codec(compress, name)),
                        mids, conf)
    finally:
        engine.stop()
    want = _reference_run(str(tmp_path), mids, name, conf)
    assert got == want
    kt = comparators.get_key_type(RAW)
    assert list(IFileReader(io.BytesIO(got[1]))) == sorted(
        expected, key=functools.cmp_to_key(
            lambda a, b: kt.compare(a[0], b[0])))
    assert metrics.get("decompress.bytes") > 0


@pytest.mark.parametrize("mode", sorted(MODE_CONF))
@pytest.mark.parametrize("name", ["zlib", "lzo"])
def test_compressed_merge_over_the_wire_matches_the_reference(tmp_path,
                                                              name, mode):
    """Compressed chunks ride the zero-copy plane on disk bytes and are
    decompressed reduce-side, in compressed-domain fetches of
    ``mapred.rdma.compression.buffer.ratio`` of the chunk."""
    from uda_tpu_torch.net import ShuffleServer

    mids, _ = _compressed_tree(str(tmp_path), name)
    conf = dict(MODE_CONF[mode], **{"mapred.rdma.buf.size": 4})
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
    server = ShuffleServer(engine, Config(), host="127.0.0.1",
                           port=0).start()
    router = HostRoutingClient(config=Config(conf))
    try:
        client = DecompressingClient(router, _codec(compress, name),
                                     comp_chunk_size=int(4096 * 0.2))
        got = _port_run(client, [(f"127.0.0.1:{server.port}", m)
                                 for m in mids], conf)
    finally:
        router.stop()
        server.stop()
        engine.stop()
    assert got == _reference_run(str(tmp_path), mids, name, conf)
    assert metrics.get("net.serve.fd") > len(mids)


def test_a_reference_server_feeds_the_ports_decompressing_client(tmp_path):
    from uda_tpu import net as jnet

    mids, _ = _compressed_tree(str(tmp_path), "zlib", pkg=jcompress,
                               wmod=jwriter)
    conf = {"mapred.rdma.buf.size": 2}
    engine = JDataEngine(JDirIndexResolver(str(tmp_path)), JConfig())
    server = jnet.ShuffleServer(engine, JConfig(), host="127.0.0.1",
                                port=0).start()
    router = HostRoutingClient(config=Config(conf))
    try:
        got = _port_run(DecompressingClient(router,
                                            _codec(compress, "zlib")),
                        [(f"127.0.0.1:{server.port}", m) for m in mids],
                        conf)
    finally:
        router.stop()
        server.stop()
        engine.stop()
    assert got == _reference_run(str(tmp_path), mids, "zlib", conf)


def test_decompressing_client_contract(tmp_path):
    """Estimate forwarding (the uncompressed domain), never resumable,
    never speculated, and a non-sequential fetch refused."""
    mids, _ = _compressed_tree(str(tmp_path))
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    inner = LocalFetchClient(engine)
    client = DecompressingClient(inner, _codec(compress, "zlib"))
    try:
        est = client.estimate_partition_bytes(JOB, mids, 0)
        assert est == inner.estimate_partition_bytes(JOB, mids, 0) > 0
        assert not client.resume_ok() and not client.speculate_ok()
        box, done = [], threading.Event()
        client.start_fetch(ShuffleRequest(JOB, mids[0], 0, 100, 1 << 20),
                           lambda r: (box.append(r), done.set()))
        assert done.wait(10)
        assert isinstance(box[0], CompressionError)
        assert "non-sequential" in str(box[0])
        # a whole stream fetched in one chunk
        box, done = [], threading.Event()
        client.start_fetch(ShuffleRequest(JOB, mids[0], 0, 0, 1 << 20),
                           lambda r: (box.append(r), done.set()))
        assert done.wait(10)
        res = box[0]
        assert isinstance(res, FetchResult) and res.last
        assert res.raw_length == len(res.data) == \
            inner.estimate_partition_bytes(JOB, mids[:1], 0)
    finally:
        engine.stop()


def test_a_compressed_chunk_crc_mismatch_is_a_storage_error(tmp_path):
    mids, _ = _compressed_tree(str(tmp_path))
    engine = DataEngine(DirIndexResolver(str(tmp_path)),
                        Config({"uda.tpu.fetch.crc": True}))

    class Damaging(LocalFetchClient):
        def start_fetch(self, req, on_complete):
            def damaged(res):
                if isinstance(res, FetchResult):
                    res.data = bytes(res.data[:-1]) + bytes(
                        [res.data[-1] ^ 1])
                on_complete(res)
            super().start_fetch(req, damaged)

    client = DecompressingClient(Damaging(engine), _codec(compress, "zlib"))
    try:
        box, done = [], threading.Event()
        client.start_fetch(ShuffleRequest(JOB, mids[0], 0, 0, 1 << 20),
                           lambda r: (box.append(r), done.set()))
        assert done.wait(10)
        assert isinstance(box[0], StorageError)
        assert "CRC mismatch" in str(box[0])
    finally:
        engine.stop()


@pytest.mark.faults
def test_decompress_block_failpoint_ends_both_packages_alike(tmp_path):
    """An injected decompress fault is the stream's terminal error: both
    packages' run() end in FallbackSignal with a CompressionError."""
    mids, _ = _compressed_tree(str(tmp_path))
    conf = {"mapred.rdma.buf.size": 1, "uda.tpu.fetch.retries": 0}
    spec = f"decompress.block=error:compression:match:{mids[1]}"
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(conf))
    try:
        with failpoints.scoped(spec), pytest.raises(FallbackSignal) as got:
            _port_run(DecompressingClient(LocalFetchClient(engine),
                                          _codec(compress, "zlib")),
                      mids, conf)
    finally:
        engine.stop()
    with jfailpoints.scoped(spec), pytest.raises(
            jerrors.FallbackSignal) as want:
        _reference_run(str(tmp_path), mids, "zlib", conf)
    assert type(got.value.cause).__name__ == \
        type(want.value.cause).__name__ == "CompressionError"
    assert metrics.get("failpoint.decompress.block") == 1


def test_reconstruction_slots_in_below_decompression(tmp_path):
    """The stripe codes the on-disk (compressed) bytes; a compressed
    partition rebuilt from its shards is decompressed on the way up, so
    the segment sees the uncompressed domain a fetch would give."""
    scheme = coding.parse_scheme("rs:3:5")
    codec = _codec(compress, "zlib")
    recs = [_records(80, 17, val=64)]
    writer.write_map_output(str(tmp_path / JOB / "m0"), recs, codec=codec,
                            scheme=scheme)
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())

    class FailPlain(LocalFetchClient):
        def start_fetch(self, req, on_complete):
            if coding.parse_shard_id(req.map_id) is None:
                on_complete(TransportError("primary path down"))
                return
            super().start_fetch(req, on_complete)

    client = DecompressingClient(FailPlain(engine), codec)
    seg = Segment(client, JOB, "m0", 0, 1 << 20,
                  policy=RetryPolicy(retries=1),
                  stripe=StripeContext(scheme, [""]))
    try:
        seg.start()
        seg.wait(10.0)
    finally:
        engine.stop()
    assert sorted(seg.record_batch().iter_records()) == recs[0]
    assert metrics.get("coding.reconstructed.partitions") == 1
    assert metrics.get("decompress.bytes") > 0


def test_speculation_is_gated_off_through_the_decompressing_client(
        tmp_path):
    """A duplicate fetch would steal the stream claim: the straggler
    detector is never armed through DecompressingClient, and nobody is
    punished for a slow supplier."""
    codec = _codec(compress, "zlib")
    recs = [_records(100, 19, val=48)]
    writer.write_map_output(str(tmp_path / JOB / "m0"), recs, codec=codec)
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    gate, issued = threading.Event(), threading.Event()

    class Held(LocalFetchClient):
        def start_fetch(self, req, on_complete):
            def held(res):
                threading.Thread(target=lambda: (gate.wait(10),
                                                 on_complete(res)),
                                 daemon=True).start()
            issued.set()
            super().start_fetch(req, held)

    client = DecompressingClient(Held(engine), codec)
    box = PenaltyBox(threshold=1, penalty_s=60.0)
    seg = Segment(client, JOB, "m0", 0, 1 << 20,
                  ledger=RecoveryLedger(box),
                  speculation=SpeculationPolicy(pn=95, floor_ms=1),
                  policy=RetryPolicy(retries=1))
    try:
        seg.start()
        assert issued.wait(10)
        assert seg._spec_timer is None  # a fetch in flight, no timer
        gate.set()
        seg.wait(10.0)
    finally:
        gate.set()
        engine.stop()
    assert sorted(seg.record_batch().iter_records()) == recs[0]
    assert metrics.get("fetch.speculated") == 0
    assert metrics.get("fetch.penalties") == 0


def test_a_coded_compressed_job_survives_a_dead_supplier(tmp_path):
    """A striped, compressed job (compressed before coding) with one
    supplier dead: run() rebuilds its partitions below the decompression
    and emits the reference's healthy stream."""
    roots = [str(tmp_path / f"h{i}") for i in range(4)]
    hosts = ["h0", "h1", "h2", "h3"]
    scheme = coding.parse_scheme("rs:2:4")
    codec = _codec(compress, "zlib")
    mids = []
    for m in range(4):
        mid = f"m_{m:04d}"
        writer.write_striped_map_output(roots, m % 4, JOB, mid,
                                        [_records(120, 40 + m)], scheme,
                                        codec=codec)
        mids.append(mid)
    engines = {h: DataEngine(DirIndexResolver(r), Config())
               for h, r in zip(hosts, roots)}

    class Dead(LocalFetchClient):
        def start_fetch(self, req, on_complete):
            on_complete(TransportError("h2 is down"))

    def connect(host):
        return Dead(engines[host]) if host == "h2" else \
            LocalFetchClient(engines[host])

    conf = {"uda.tpu.coding.scheme": "rs:2:4", "uda.tpu.fetch.retries": 1,
            "mapred.rdma.fetch.retry.backoff.ms": 1}
    router = HostRoutingClient(connect)
    try:
        got = _port_run(DecompressingClient(router, codec),
                        [(hosts[m % 4], mid) for m, mid in enumerate(mids)],
                        conf, chunk=1 << 20)
    finally:
        router.stop()
        for e in engines.values():
            e.stop()
    want_engine = JDataEngine(JDirIndexResolver(roots), JConfig())
    try:
        mm = JMergeManager(jcompress.DecompressingClient(
            JLocalFetchClient(want_engine), _codec(jcompress, "zlib")),
            RAW, JConfig())
        out = bytearray()
        mm.run(JOB, mids, 0, out.extend)
    finally:
        want_engine.stop()
    assert got[1] == bytes(out)
    assert metrics.get("coding.reconstructed.partitions") == 1
    assert metrics.get("fallback.signals") == 0


def test_map_ids_helper_is_the_writer_order(tmp_path):
    mids, _ = _compressed_tree(str(tmp_path), maps=2)
    assert mids == map_ids(JOB, 2)
    assert isinstance(errors.CompressionError("x"), errors.UdaError)
