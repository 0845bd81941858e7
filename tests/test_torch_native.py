"""The port's native host runtime (``uda_tpu_torch/native`` over
``uda_tpu_torch/csrc/{codec,reader,merge,lzo}.cc``) against the JAX
package's ``uda_tpu.native`` and against the port's pure-Python forms.

Every case of ``tests/test_native.py`` runs against the port. Then each
entry point is held three ways on the same seeded numpy inputs: the port's
native call, the reference's native call and the port's Python form
(crack, crack_partial, decode_vlongs, write_records / frame_batch /
iter_framed_chunks, the k-way merge for all 11 key types, the span gather,
the row merge and its split form, the read pool on both backends, the
LZO codec). The build itself: two processes at once both load the
library, the build writes nothing under ``uda_tpu/native/``, and with
``uda.tpu.use.native`` on a build that cannot happen raises."""

import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from helpers import make_mof_tree, map_ids
from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import native as jnative
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.ops import merge as jmerge
from uda_tpu.utils import comparators as jcomparators
from uda_tpu.utils import ifile as jifile
from uda_tpu.utils.config import Config as JConfig
from uda_tpu_torch import native
from uda_tpu_torch.compress import lzo
from uda_tpu_torch.merger import emitter
from uda_tpu_torch.merger import streaming as tstreaming
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.ops import _build_host
from uda_tpu_torch.ops import merge as tmerge
from uda_tpu_torch.utils import comparators, ifile, vint
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import StorageError

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(not jnative.build(),
                                reason="the reference's native library "
                                       "did not build")

# KeyType name -> Hadoop class, for the 11 key types of the k-way table
KWAY_CLASSES = {
    "raw": "uda.tpu.RawBytes",
    "boolean": "org.apache.hadoop.io.BooleanWritable",
    "byte": "org.apache.hadoop.io.ByteWritable",
    "short": "org.apache.hadoop.io.ShortWritable",
    "int": "org.apache.hadoop.io.IntWritable",
    "long": "org.apache.hadoop.io.LongWritable",
    "text": "org.apache.hadoop.io.Text",
    "bytes": "org.apache.hadoop.io.BytesWritable",
    "ibytes": "org.apache.hadoop.hbase.io.ImmutableBytesWritable",
    "int_numeric": "uda.tpu.IntNumeric",
    "long_numeric": "uda.tpu.LongNumeric",
}


@pytest.fixture(autouse=True)
def _switches():
    """Both packages' process-wide native switch on, the port's call
    counts at 0, before and after each test."""
    ifile.set_native_enabled(True)
    jifile.set_native_enabled(True)
    native.reset_calls()
    yield
    ifile.set_native_enabled(True)
    jifile.set_native_enabled(True)
    native.reset_calls()


def _records(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.bytes(int(rng.integers(0, 50))),
             rng.bytes(int(rng.integers(0, 300)))) for _ in range(n)]


def _eof_tail_records(seed: int, n: int = 300) -> list:
    """Records whose keys and values end in the EOF marker's bytes, are
    empty, or are wider than one-byte VInt lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = rng.bytes(int(rng.integers(0, 20)))
        v = rng.bytes(int(rng.integers(0, 400)))
        if i % 3 == 0:
            v += b"\xff\xff"
        if i % 5 == 0:
            k += b"\xff"
        if i % 7 == 0:
            k, v = b"", b""
        out.append((k, v))
    return out


def python_form(fn):
    """``fn()`` with the port's native switch off."""
    ifile.set_native_enabled(False)
    try:
        return fn()
    finally:
        ifile.set_native_enabled(True)


def _python_crack(buf: bytes) -> ifile.RecordBatch:
    """The port's pure-Python crack (the switch off)."""
    return python_form(lambda: ifile.crack(buf))


def _columns(batch) -> list:
    return [batch.key_off.tolist(), batch.key_len.tolist(),
            batch.val_off.tolist(), batch.val_len.tolist()]


# -- the reference's cases, against the port -----------------------------------

def test_crack_parity_with_python():
    recs = _records()
    buf = ifile.write_records(recs)
    py = _python_crack(buf)
    nat = native.crack_native(buf)
    assert nat.num_records == py.num_records
    assert _columns(nat) == _columns(py)
    assert list(nat.iter_records()) == recs


def test_crack_partial_parity():
    recs = _records(50, seed=1)
    buf = ifile.write_records(recs)
    ifile.set_native_enabled(False)
    try:
        want = [ifile.crack_partial(buf[:cut])
                for cut in [0, 1, 7, len(buf) // 2, len(buf) - 3, len(buf)]]
    finally:
        ifile.set_native_enabled(True)
    for (py_b, py_c, py_e), cut in zip(
            want, [0, 1, 7, len(buf) // 2, len(buf) - 3, len(buf)]):
        na_b, na_c, na_e = native.crack_partial_native(buf[:cut])
        assert (py_b.num_records, py_c, py_e) == \
            (na_b.num_records, na_c, na_e), cut
        assert list(py_b.iter_records()) == list(na_b.iter_records())


def test_crack_native_errors():
    with pytest.raises(StorageError):
        native.crack_native(b"\xfe\xfe")  # klen=-2: corrupt
    with pytest.raises(StorageError):
        native.crack_native(ifile.write_records([(b"k", b"v")])[:-2])


def test_write_records_parity():
    recs = _records(120, seed=5)
    buf = ifile.write_records(recs)
    batch = ifile.crack(buf)
    assert native.write_records_native(batch) == buf
    assert native.write_records_native(batch, write_eof=False) \
        == buf[:-len(ifile.EOF_MARKER)]


def test_decode_vlongs_parity():
    vals = [0, 1, -1, 127, -112, 128, -113, 2**40, -(2**40), 2**63 - 1,
            -(2**63)]
    buf = b"".join(vint.encode_vlong(v) for v in vals)
    got = native.decode_vlongs_native(buf)
    assert got.tolist() == vals
    with pytest.raises(IndexError):
        native.decode_vlongs_native(buf[:-1], count=len(vals))


def test_value_ending_in_eof_marker_bytes():
    recs = [(b"k1", b"data\xff\xff"), (b"k2", b"\xff\xff"), (b"k3", b"x")]
    buf = ifile.write_records(recs)
    nat = native.crack_native(buf)
    assert list(nat.iter_records()) == recs


def _blob_fd(tmp_path, data: bytes) -> int:
    path = str(tmp_path / "blob")
    with open(path, "wb") as f:
        f.write(data)
    return os.open(path, os.O_RDONLY)


def _drain(pool, n: int) -> dict:
    got = {}
    while len(got) < n:
        for tag, buf in pool.poll(min_events=1, timeout=5.0):
            got[tag] = buf
    return got


@pytest.mark.parametrize("backend", ["host", "pool"])
def test_read_pool(tmp_path, monkeypatch, backend):
    if backend == "pool":
        monkeypatch.setenv("UDA_TPU_READ_POOL", "pool")
    data = np.random.default_rng(0).bytes(1 << 20)
    fd = _blob_fd(tmp_path, data)
    try:
        with native.ReadPool(threads=3) as pool:
            if backend == "pool":
                assert pool.backend() == "pool"
            tags = {}
            for i in range(16):
                off = i * (1 << 16)
                tags[pool.submit(fd, off, 1 << 16)] = off
            got = _drain(pool, 16)
            for tag, off in tags.items():
                assert got[tag].tobytes() == data[off:off + (1 << 16)]
    finally:
        os.close(fd)


@pytest.mark.parametrize("backend", ["host", "pool"])
def test_read_pool_submit_batch(tmp_path, monkeypatch, backend):
    """N jobs in one native call, tags in job order, per-tag isolation
    (an EOF-shortened read hurts only its own tag), on the rung this host
    grants and on the worker pool forced; both packages read the same
    bytes."""
    if backend == "pool":
        monkeypatch.setenv("UDA_TPU_READ_POOL", "pool")
    data = np.random.default_rng(1).bytes(1 << 19)
    fd = _blob_fd(tmp_path, data)
    jobs = [(fd, 0, 4096), (fd, 4096, 4096),
            (fd, (1 << 19) - 100, 4096),  # EOF-clamped
            (fd, 1 << 18, 8192)]
    try:
        results = []
        for mod in (native, jnative):
            with mod.ReadPool(threads=2) as pool:
                assert pool.backend() in ("io_uring", "pool")
                tags = pool.submit_batch(jobs)
                assert len(tags) == len(jobs)
                got = _drain(pool, len(jobs))
                results.append([bytes(got[t]) for t in tags])
                assert pool.submit_batch([]) == []
        assert results[0] == results[1]
        assert results[0] == [data[:4096], data[4096:8192], data[-100:],
                              data[1 << 18:(1 << 18) + 8192]]
    finally:
        os.close(fd)


def test_read_pool_backend_on_this_host():
    """The rung the kernel grants is the reference's on the same host."""
    with native.ReadPool(threads=1) as pool, \
            jnative.ReadPool(threads=1) as jpool:
        assert pool.backend() in ("io_uring", "pool")
        assert pool.backend() == jpool.backend()


def test_use_native_flag_gates_codec(tmp_path):
    try:
        DataEngine(DirIndexResolver(str(tmp_path)),
                   Config({"uda.tpu.use.native": False})).stop()
        assert ifile._native_mod() is None
        assert not ifile.native_enabled()
    finally:
        ifile.set_native_enabled(True)
    assert ifile._native_mod() is native


def test_bridge_reduce_exit_stops_owned_engine(tmp_path):
    from uda_tpu_torch.bridge import Cmd, UdaBridge, form_cmd
    from uda_tpu_torch.mofserver import ShuffleRequest

    make_mof_tree(str(tmp_path), "jobN", 1, 1, 5)

    class H:
        def __init__(self):
            self.done = threading.Event()
            self._r = DirIndexResolver(str(tmp_path))

        def data_from_uda(self, d, n):
            pass

        def fetch_over_message(self):
            self.done.set()

        def get_path_uda(self, j, m, r):
            return self._r.resolve(j, m, r)

        def get_conf_data(self, n, d):
            return ""

        def failure_in_uda(self, e):
            self.done.set()

    h = H()
    b = UdaBridge(device="cpu")
    b.start(True, [], h)
    b.do_command(form_cmd(Cmd.INIT, ["jobN", "0", "1", "uda.tpu.RawBytes"]))
    b.do_command(form_cmd(Cmd.FETCH, ["h", "jobN", map_ids("jobN", 1)[0],
                                      "0"]))
    b.do_command(form_cmd(Cmd.FINAL, []))
    assert h.done.wait(30)
    engine = b._owned_engine
    assert engine is not None and engine._native is not None
    b.reduce_exit()
    assert b._owned_engine is None
    with pytest.raises(StorageError):
        engine.fetch(ShuffleRequest("jobN", "x", 0, 0, 10))


@pytest.mark.parametrize("backend", ["host", "pool"])
def test_read_pool_short_read_at_eof(tmp_path, monkeypatch, backend):
    if backend == "pool":
        monkeypatch.setenv("UDA_TPU_READ_POOL", "pool")
    fd = _blob_fd(tmp_path, b"hello")
    try:
        for mod in (native, jnative):
            with mod.ReadPool(threads=1) as pool:
                tag = pool.submit(fd, 0, 100)
                [(t, buf)] = pool.poll()
                assert t == tag and buf.tobytes() == b"hello"
    finally:
        os.close(fd)


# -- three-way parity: port native, reference native, port Python ---------------

@pytest.mark.parametrize("seed", range(4))
def test_crack_three_ways(seed):
    recs = _eof_tail_records(seed)
    buf = ifile.write_records(recs)
    assert buf == jifile.write_records(recs)
    nat = native.crack_native(buf)
    ref = jnative.crack_native(buf)
    py = _python_crack(buf)
    assert _columns(nat) == _columns(ref) == _columns(py)
    assert list(nat.iter_records()) == recs
    # the dispatch itself: a buffer past the threshold goes native
    native.reset_calls()
    assert _columns(ifile.crack(buf)) == _columns(py)
    assert native.calls["crack"] == (1 if len(buf) >= 4096 else 0)


@pytest.mark.parametrize("seed", range(3))
def test_crack_partial_three_ways(seed):
    recs = _eof_tail_records(seed + 10, 120)
    buf = ifile.write_records(recs)
    rng = np.random.default_rng(seed)
    cuts = sorted({0, 1, 2, len(buf) - 1, len(buf), len(buf) - 2,
                   *rng.integers(0, len(buf), 12).tolist()})
    for cut in cuts:
        piece = buf[:cut]
        nb, nc, ne = native.crack_partial_native(piece)
        rb, rc, re_ = jnative.crack_partial_native(piece)
        ifile.set_native_enabled(False)
        try:
            pb, pc, pe = ifile.crack_partial(piece)
        finally:
            ifile.set_native_enabled(True)
        assert (nc, ne) == (rc, re_) == (pc, pe), cut
        assert _columns(nb) == _columns(rb) == _columns(pb), cut


@pytest.mark.parametrize("bad", [b"\xfe\xfe", b"\x01\xfe\x00",
                                 b"\x05\x05ab"])
def test_corrupt_framing_raises_the_same_error_types(bad):
    """Corrupt framing: the same error type from the port's native and
    Python cracks as from the reference's native crack."""
    kinds = []
    for crack in (native.crack_native, jnative.crack_native, _python_crack):
        try:
            crack(bad)
            kinds.append(None)
        except Exception as e:  # noqa: BLE001 - the type is compared
            kinds.append(type(e).__name__)
    assert kinds[0] == kinds[1] == kinds[2] == "StorageError"


@pytest.mark.parametrize("seed", range(3))
def test_decode_vlongs_three_ways(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.integers(-2**62, 2**62, 300, dtype=np.int64),
                           rng.integers(-300, 300, 300, dtype=np.int64),
                           np.asarray([0, -1, 2**63 - 1, -2**63], np.int64)])
    buf = vint.encode_vlong_array(vals)
    got = native.decode_vlongs_native(buf)
    assert got.tolist() == jnative.decode_vlongs_native(buf).tolist()
    assert got.tolist() == vint.decode_vlong_stream(
        np.frombuffer(buf, np.uint8))[0].tolist() == vals.tolist()
    assert native.decode_vlongs_native(buf, 7).tolist() == \
        vals[:7].tolist()
    for mod in (native, jnative):
        with pytest.raises(IndexError):
            mod.decode_vlongs_native(buf[:-1], count=len(vals))


@pytest.mark.parametrize("seed", range(3))
def test_framing_three_ways(seed):
    """write_records, frame_batch and iter_framed_chunks over a permuted
    batch (records out of buffer order): the port's native, the
    reference's native and the port's Python framers agree."""
    recs = _eof_tail_records(seed + 20)
    batch = ifile.crack(ifile.write_records(recs))
    order = np.random.default_rng(seed).permutation(batch.num_records)
    sub = batch.take(order)
    jsub = jifile.RecordBatch(sub.data, sub.key_off, sub.key_len,
                              sub.val_off, sub.val_len)
    want = jifile.write_records([recs[i] for i in order])
    for eof in (True, False):
        tail = want if eof else want[:-2]
        assert native.write_records_native(sub, eof) == tail
        assert jnative.write_records_native(jsub, eof) == tail
        assert native.frame_batch(sub, eof) == tail
        assert emitter.frame_batch(sub, eof) == tail
    for chunk in (1, 7, 64, 1 << 16):
        assert b"".join(native.iter_framed_chunks(sub, chunk)) == want
        assert b"".join(jnative.iter_framed_chunks(jsub, chunk)) == want
        assert b"".join(python_form(
            lambda: list(native.iter_framed_chunks(sub, chunk)))) == want
    native.reset_calls()
    ifile.set_native_enabled(False)
    try:
        assert native.frame_batch(sub) == want
    finally:
        ifile.set_native_enabled(True)
    assert native.calls["write_records"] == 0


def _kway_keys(name: str, rng, n: int) -> list:
    """Serialized keys of KeyType ``name``, with duplicates."""
    keys = []
    for _ in range(n):
        r = int(rng.integers(0, 40))
        if name in ("boolean", "byte"):
            keys.append(bytes([r % 256]))
        elif name == "short":
            keys.append(int(rng.integers(0, 1 << 16)).to_bytes(2, "big"))
        elif name in ("int", "int_numeric"):
            keys.append(int(rng.integers(0, 1 << 32)).to_bytes(4, "big"))
        elif name in ("long", "long_numeric"):
            keys.append(int(rng.integers(0, 1 << 63)).to_bytes(8, "big")
                        if r % 2 else bytes([0xFF]) * 8)
        elif name == "text":
            body = rng.bytes(r % 12)
            keys.append(vint.encode_vlong(len(body)) + body)
        elif name in ("bytes", "ibytes"):
            body = rng.bytes(r % 12)
            keys.append(len(body).to_bytes(4, "big") + body)
        else:
            keys.append(rng.bytes(r % 12))
        if r < 6 and keys:  # duplicates across and within runs
            keys[-1] = keys[0]
    return keys


def _write_sorted_runs(tmp_path, name: str, kt, seed: int, runs: int,
                       big: int = 0) -> list:
    rng = np.random.default_rng(seed)
    paths = []
    for r in range(runs):
        n = int(rng.integers(0, 60)) if r else 0  # run 0 is empty
        recs = [(k, rng.bytes(int(rng.integers(0, 50))))
                for k in _kway_keys(name, rng, n)]
        if big and r == 1:
            recs.append((recs[0][0] if recs else b"", b"v" * big))
        key = lambda kv: kt.content(kv[0])  # noqa: E731
        recs.sort(key=key)
        path = str(tmp_path / f"{name}-run{r}")
        with open(path, "wb") as f:
            f.write(ifile.write_records(recs))
        paths.append(path)
    return paths


@pytest.mark.parametrize("name", sorted(KWAY_CLASSES))
def test_kway_merge_three_ways(tmp_path, name):
    """The loser tree over sorted spill files of every key type in the
    table (an empty run, duplicate keys across runs, a record larger than
    the output block): the port's and the reference's native merges and
    the port's heap merge give the same bytes."""
    kt = comparators.get_key_type(KWAY_CLASSES[name])
    jkt = jcomparators.get_key_type(KWAY_CLASSES[name])
    assert kt.name == name and native.kway_supported(kt)
    paths = _write_sorted_runs(tmp_path, name, kt, len(name), 5, big=5000)
    got = b"".join(native.kway_merge_paths(paths, kt, block_bytes=1024,
                                           buffer_size=512))
    ref = b"".join(jnative.kway_merge_paths(paths, jkt, block_bytes=1024,
                                            buffer_size=512))
    heap = ifile.write_records(tmerge.merge_record_streams(
        [ifile.iter_file_records(p) for p in paths], kt))
    assert got == ref == heap
    assert native.calls["kway_create"] == 1
    assert b"".join(native.kway_merge_paths([], kt)) == ifile.EOF_MARKER
    assert b"".join(native.kway_merge_paths([], kt, write_eof=False)) == b""


def test_kway_merge_corrupt_file_raises_like_the_reference(tmp_path):
    kt = comparators.get_key_type("uda.tpu.RawBytes")
    jkt = jcomparators.get_key_type("uda.tpu.RawBytes")
    path = str(tmp_path / "torn")
    with open(path, "wb") as f:
        f.write(ifile.write_records([(b"a", b"b")])[:-2])  # no EOF
    kinds = []
    for mod, k in ((native, kt), (jnative, jkt)):
        with pytest.raises(Exception) as ei:
            b"".join(mod.kway_merge_paths([path], k))
        kinds.append(type(ei.value).__name__)
    assert kinds == ["StorageError", "StorageError"]


@pytest.mark.parametrize("seed", range(3))
def test_gather_spans_three_ways(seed):
    rng = np.random.default_rng(seed)
    n = 500
    lens = rng.integers(0, 300, n)
    src = rng.integers(0, 256, int(lens.max()) * 20 + 3, dtype=np.uint8)
    src_off = rng.integers(0, src.size - int(lens.max()) + 1, n)
    dst_off = np.cumsum(lens) - lens
    outs = [np.zeros(int(lens.sum()), np.uint8) for _ in range(3)]
    assert native.gather_spans_native(src, src_off, lens, outs[0], dst_off)
    assert jnative.gather_spans_native(src, src_off, lens, outs[1], dst_off)
    tstreaming._gather_spans_numpy(src, src_off, lens, outs[2], dst_off)
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], outs[2])
    assert native.calls["gather_spans"] == 1


@pytest.mark.parametrize("case", ["src_past_end", "negative_len",
                                  "dst_past_end", "negative_dst"])
def test_gather_spans_out_of_bounds_raise_in_both(case):
    src = np.arange(100, dtype=np.uint8)
    dst = np.zeros(50, np.uint8)
    src_off = np.asarray([0, 10], np.int64)
    lens = np.asarray([5, 5], np.int64)
    dst_off = np.asarray([0, 5], np.int64)
    if case == "src_past_end":
        src_off = np.asarray([0, 98], np.int64)
    elif case == "negative_len":
        lens = np.asarray([5, -1], np.int64)
    elif case == "dst_past_end":
        dst_off = np.asarray([0, 48], np.int64)
    else:
        dst_off = np.asarray([-1, 5], np.int64)
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.gather_spans_native(src, src_off, lens, dst.copy(), dst_off)
    assert native.calls["gather_spans"] == 0


def _sorted_rows(rng, n: int, cols: int, hi: int) -> np.ndarray:
    rows = rng.integers(0, hi, (n, cols)).astype(np.uint32)
    order = np.lexsort(tuple(rows[:, c] for c in range(cols - 1, -1, -1)))
    return np.ascontiguousarray(rows[order])


@pytest.mark.parametrize("seed", range(3))
def test_merge_rows_three_ways(seed):
    """Runs full of equal rows (ties go to ``a``): the port's and the
    reference's native merges and the port's lexsort engine agree, into a
    fresh array and into a caller's."""
    rng = np.random.default_rng(seed)
    a = _sorted_rows(rng, 400, 3, 3)
    b = _sorted_rows(rng, 300, 3, 3)
    got = native.merge_rows_native(a, b)
    assert np.array_equal(got, jnative.merge_rows_native(a, b))
    assert np.array_equal(got, tmerge.merge_row_pair(a, b, len(a), len(b),
                                                     "host"))
    out = np.empty_like(got)
    assert native.merge_rows_native_into(a, b, out)
    assert np.array_equal(out, got)
    assert np.array_equal(native.merge_rows_native(a[:0], b), b)
    with pytest.raises(ValueError):
        native.merge_rows_native_into(a, b, out[1:])


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_merge_rows_split_into_matches_one_merge(parts):
    rng = np.random.default_rng(parts)
    a = _sorted_rows(rng, 3000, 3, 5)
    b = _sorted_rows(rng, 2500, 3, 5)
    want = native.merge_rows_native(a, b)
    assert np.array_equal(want, jnative.merge_rows_native(a, b))
    out = np.zeros_like(want)
    assert tmerge.merge_rows_split_into(a, b, out, parts)
    assert np.array_equal(out, want)
    jout = np.zeros_like(want)
    assert jmerge.merge_rows_split_into(a, b, jout, parts)
    assert np.array_equal(jout, want)
    assert native.calls["merge_rows"] == 1 + parts
    assert tmerge.resolve_native_rows_merge() is native.merge_rows_native
    ifile.set_native_enabled(False)
    try:
        assert tmerge.resolve_native_rows_merge() is None
    finally:
        ifile.set_native_enabled(True)


@pytest.mark.parametrize("name", ["repeat", "random", "empty", "short"])
def test_lzo_builtin_three_ways(name):
    """The builtin LZO1X-1 of both packages writes the same stream, which
    the port's pure-Python decoder and both native decoders read back."""
    rng = np.random.default_rng(3)
    data = {"repeat": b"the quick brown fox " * 5000,
            "random": rng.bytes(70000),
            "empty": b"",
            "short": b"abc"}[name]
    rc, blob = native.lzo1x_1_compress(data)
    assert rc == 0
    assert blob == lzo._builtin_compress(data)
    from uda_tpu.compress import lzo as jlzo
    assert blob == jlzo._builtin_compress(data)
    assert lzo.lzo1x_decompress_py(blob, len(data)) == data
    assert lzo._builtin_decompress(blob, len(data)) == data
    if name == "repeat":
        assert len(blob) < len(data) // 10


def test_use_native_switch_in_both_packages(tmp_path):
    """A DataEngine with uda.tpu.use.native set sets its own package's
    switch; with it off no native call is made and the bytes are the
    same."""
    recs = _records(400, seed=9)
    buf = ifile.write_records(recs)
    for mod, eng, res, cfg in ((ifile, DataEngine, DirIndexResolver, Config),
                               (jifile, JDataEngine, JDirIndexResolver,
                                JConfig)):
        eng(res(str(tmp_path)), cfg({"uda.tpu.use.native": False})).stop()
        assert not mod.native_enabled()
        eng(res(str(tmp_path)), cfg({"uda.tpu.use.native": True})).stop()
        assert mod.native_enabled()
    ifile.set_native_enabled(False)
    native.reset_calls()
    try:
        off = ifile.crack(buf)
        framed = native.frame_batch(off)
    finally:
        ifile.set_native_enabled(True)
    assert sum(native.calls.values()) == 0
    assert _columns(off) == _columns(ifile.crack(buf))
    assert framed == buf and native.calls["crack"] == 1


# -- the build ------------------------------------------------------------------

def _tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): (p.stat().st_mtime_ns,
                                       hashlib.sha256(p.read_bytes())
                                       .hexdigest())
            for p in sorted(root.rglob("*")) if p.is_file()}


_BUILD_CHILD = """
import sys
from uda_tpu_torch import native
from uda_tpu_torch.ops import _build_host
path, secs = _build_host.build_native()
batch = native.crack_native(bytes([1, 1]) + b"kv" + b"\\xff\\xff")
print(path, batch.num_records)
"""


def test_two_processes_build_at_once_and_both_load(tmp_path):
    """Two interpreters with an empty build cache build at the same
    moment: one compiles under the lock, both load a whole library. The
    reference's native directory is not touched."""
    ref_dir = ROOT / "uda_tpu" / "native"
    before = _tree_digest(ref_dir)
    env = dict(os.environ, UDA_TPU_COMPILE_CACHE=str(tmp_path / "cache"),
               PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(tmp_path))
             for _ in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs[0] == outs[1]
    assert outs[0][1] == "1"
    assert Path(outs[0][0]).is_file()
    assert str(tmp_path / "cache") in outs[0][0]
    leftovers = [p.name for p in (tmp_path / "cache").rglob("*.tmp")]
    assert leftovers == []
    assert _tree_digest(ref_dir) == before


def test_build_leaves_the_reference_native_directory_alone():
    ref_dir = ROOT / "uda_tpu" / "native"
    before = _tree_digest(ref_dir)
    path, _ = _build_host.build_native()
    assert Path(path).is_file()
    assert Path(ROOT / "uda_tpu_torch" / "csrc") in \
        [s.parent for s in _build_host.NATIVE_SOURCES]
    assert not str(path).startswith(str(ref_dir))
    assert _tree_digest(ref_dir) == before


_FAIL_CHILD = """
import sys
from uda_tpu_torch.utils import ifile
try:
    ifile.crack(b"\\x01\\x01kv" * 3000 + b"\\xff\\xff")
except RuntimeError as e:
    print("raised", "cannot" in str(e))
    sys.exit(0)
print("no error")
sys.exit(1)
"""

_OFF_CHILD = """
from uda_tpu_torch.utils import ifile
from uda_tpu_torch import native
ifile.set_native_enabled(False)
b = ifile.crack(b"\\x01\\x01kv" * 3000 + b"\\xff\\xff")
print(b.num_records, sum(native.calls.values()))
"""


def test_use_native_raises_when_the_build_fails(tmp_path):
    """With uda.tpu.use.native on, a library that cannot be built (its
    build directory lies under a file) raises; it never degrades. With
    the switch off the same process runs the Python forms."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    env = dict(os.environ, UDA_TPU_COMPILE_CACHE=str(blocker / "cache"),
               PYTHONPATH=str(ROOT))
    for child, want in ((_FAIL_CHILD, "raised True"), (_OFF_CHILD, "3000 0")):
        proc = subprocess.run([sys.executable, "-c", child], env=env,
                              capture_output=True, text=True, timeout=240,
                              cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == want


def test_build_is_a_no_op_the_second_time():
    path1, _ = _build_host.build_native()
    path2, secs = _build_host.build_native()
    assert path1 == path2 and secs < 1.0
    assert native.available() and native.build()


def test_heap_merge_is_the_reference_heap_merge(tmp_path):
    """The heap merge the loser tree is held to is itself the
    reference's."""
    kt = comparators.get_key_type("org.apache.hadoop.io.Text")
    jkt = jcomparators.get_key_type("org.apache.hadoop.io.Text")
    paths = _write_sorted_runs(tmp_path, "text", kt, 4, 4)
    got = list(tmerge.merge_record_streams(
        [ifile.iter_file_records(p) for p in paths], kt))
    want = list(jmerge.merge_record_streams(
        [jifile.iter_file_records(p) for p in paths], jkt))
    assert got == want
