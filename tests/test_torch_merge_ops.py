"""The reduce-side merge's host codecs and merge operations in the port
(uda_tpu_torch.utils, .ops.packing/.sort/.pallas_merge/.merge,
.mofserver.writer) against the JAX package on the same bytes and the same
numpy inputs. Tolerance 0 everywhere: codecs are byte formats, and stable
sorts and merges have exactly one correct output. On the CPU the port's
"pallas" engine runs K1's plain version; the reference runs its Pallas
kernel in interpret mode (a few calls, 1-3 s each)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_tpu.mofserver import writer as jwriter
from uda_tpu.ops import merge as jmerge
from uda_tpu.ops import packing as jpacking
from uda_tpu.ops import pallas_merge as jpm
from uda_tpu.ops import sort as jsort
from uda_tpu.utils import comparators as jcmp
from uda_tpu.utils import config as jconfig
from uda_tpu.utils import ifile as jifile
from uda_tpu.utils import vint as jvint
from uda_tpu.utils.errors import StorageError as JStorageError
from uda_tpu_torch.merger import emitter as temitter
from uda_tpu_torch.mofserver import writer as twriter
from uda_tpu_torch.ops import merge as tmerge
from uda_tpu_torch.ops import packing as tpacking
from uda_tpu_torch.ops import pallas_merge as tpm
from uda_tpu_torch.ops import sort as tsort
from uda_tpu_torch.utils import comparators as tcmp
from uda_tpu_torch.utils import config as tconfig
from uda_tpu_torch.utils import ifile as tifile
from uda_tpu_torch.utils import vint as tvint
from uda_tpu_torch.utils.errors import ConfigError, StorageError

TEXT = "org.apache.hadoop.io.Text"
VLONGS = [0, 1, -1, 127, -112, 128, -113, 255, 256, -129, 65535, -65536,
          2**31 - 1, -2**31, 2**40 + 5, 2**63 - 1, -2**63]


def t_words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).view(
        torch.uint32)


def n_words(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def text_key(content: bytes) -> bytes:
    return jvint.encode_vlong(len(content)) + content


def text_records(seed: int, n: int, max_len: int = 14, alphabet: int = 4):
    """(Text key, value) records with duplicate keys (a small alphabet),
    content lengths 0..max_len and values of 0..200 bytes (VInt lengths
    past 127 take two bytes)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        klen = int(rng.integers(0, max_len + 1))
        content = bytes(rng.integers(0, alphabet, klen, dtype=np.uint8))
        value = rng.bytes(int(rng.integers(0, 200)))
        out.append((text_key(content), value))
    return out


def sorted_text(records):
    kt = jcmp.get_key_type(TEXT)
    return sorted(records, key=lambda kv: kt.content(kv[0]))


def assert_batches_equal(got, want):
    """Two RecordBatches hold the same records in the same order."""
    assert got.num_records == want.num_records
    assert list(got.iter_records()) == list(want.iter_records())


# -- codecs -----------------------------------------------------------------

@pytest.mark.parametrize("value", VLONGS)
def test_vlong_matches_reference(value):
    enc = tvint.encode_vlong(value)
    assert enc == jvint.encode_vlong(value)
    assert tvint.vlong_size(value) == jvint.vlong_size(value) == len(enc)
    assert tvint.decode_vlong(enc + b"\x07", 0) == jvint.decode_vlong(
        enc + b"\x07", 0) == (value, len(enc))


def test_vlong_truncation_and_size_match_reference():
    with pytest.raises(IndexError):
        tvint.decode_vlong(jvint.encode_vlong(2**40)[:-1])
    for first in range(-128, 128):
        assert tvint.decode_vint_size(first) == jvint.decode_vint_size(first)


@pytest.mark.parametrize("max_len", [14, 200])
def test_ifile_write_read_crack_match_reference(max_len):
    """Writer, reader and crack on records whose key and value lengths
    take one- and two-byte VInts."""
    recs = text_records(1, 300, max_len=max_len)
    bufs = []
    for mod in (tifile, jifile):
        out = io.BytesIO()
        with mod.IFileWriter(out) as w:
            for k, v in recs:
                w.append(k, v)
        bufs.append(out.getvalue())
    assert bufs[0] == bufs[1]
    data = bufs[0]
    assert list(tifile.IFileReader(io.BytesIO(data))) == recs
    got = tifile.crack(data)
    want = jifile.crack(data)
    for col in ("key_off", "key_len", "val_off", "val_len"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    assert list(got.iter_records()) == recs


def test_crack_partial_carries_a_split_record_like_reference():
    """A stream cut at every offset of a few records: the complete prefix
    is cracked, the split record is left for the next chunk, and the two
    halves joined crack to the whole."""
    recs = [(text_key(b"k" * 3), b"v" * 150), (text_key(b""), b""),
            (text_key(b"x" * 130), b"w" * 9)]
    data = jifile.write_records(recs)
    for cut in range(len(data) + 1):
        got, used, eof = tifile.crack_partial(data[:cut])
        want, wused, weof = jifile.crack_partial(data[:cut])
        assert (used, eof) == (wused, weof)
        assert list(got.iter_records()) == list(want.iter_records())
        if eof:
            assert list(got.iter_records()) == recs
            continue
        rest, _, eof2 = tifile.crack_partial(data[used:cut] + data[cut:],
                                             expect_eof=True)
        assert eof2 and list(got.iter_records()) + list(
            rest.iter_records()) == recs


@pytest.mark.parametrize("bad", [b"\x05\x01abc", b"\x8f", b"\x03\x80xyz"])
def test_crack_refuses_what_reference_refuses(bad):
    with pytest.raises(JStorageError):
        jifile.crack(bad)
    with pytest.raises(StorageError):
        tifile.crack(bad)


def test_frame_batch_matches_reference_framer():
    """The port's pure-Python framer and the reference's (its C++ framer
    where built) give the same bytes, with and without the EOF marker."""
    from uda_tpu import native

    recs = text_records(2, 500)
    data = jifile.write_records(recs)
    batch, jbatch = tifile.crack(data), jifile.crack(data)
    order = np.random.default_rng(3).permutation(len(recs))
    for eof in (True, False):
        assert temitter.frame_batch(batch.take(order), eof) == \
            native.frame_batch(jbatch.take(order), write_eof=eof)
    assert b"".join(temitter.iter_framed_chunks(batch, 64)) == \
        b"".join(native.iter_framed_chunks(jbatch, 64))


# the key classes the reference registers (uda_tpu/utils/comparators.py:
# 145-169); other test files may register more into its live registry
REGISTERED = [
    "org.apache.hadoop.io.Text", "org.apache.hadoop.io.BooleanWritable",
    "org.apache.hadoop.io.ByteWritable", "org.apache.hadoop.io.ShortWritable",
    "org.apache.hadoop.io.IntWritable", "org.apache.hadoop.io.LongWritable",
    "org.apache.hadoop.io.BytesWritable",
    "org.apache.hadoop.hbase.io.ImmutableBytesWritable",
    "uda.tpu.IntNumeric", "uda.tpu.LongNumeric", "uda.tpu.RawBytes"]


@pytest.mark.parametrize("java_class", REGISTERED)
def test_every_registered_comparator_matches_reference(java_class):
    jkt = jcmp.get_key_type(java_class)
    tkt = tcmp.get_key_type(java_class)
    assert (tkt.name, tkt.fixed_width) == (jkt.name, jkt.fixed_width)
    rng = np.random.default_rng(len(java_class))
    width = jkt.fixed_width or 12
    if jkt.name == "text":
        keys = [k for k, _ in text_records(5, 40, max_len=20)]
    elif jkt.name in ("bytes", "ibytes"):
        keys = [len(c).to_bytes(4, "big") + c for c in
                (bytes(rng.integers(0, 3, int(rng.integers(0, 9)),
                                    dtype=np.uint8)) for _ in range(40))]
    else:
        keys = [bytes(rng.integers(0, 256, width, dtype=np.uint8))
                for _ in range(40)]
    for a in keys:
        assert tkt.content(a) == jkt.content(a)
        assert tkt.normalize(a, 8) == jkt.normalize(a, 8)
        for b in keys[:10]:
            assert tkt.compare(a, b) == jkt.compare(a, b)
    assert sorted(tcmp._REGISTRY) == sorted(REGISTERED)


def test_unknown_key_class_raises():
    with pytest.raises(tcmp.UdaError):
        tcmp.get_key_type("org.example.Nope")


def test_config_registry_matches_reference():
    assert list(tconfig.FLAGS) == list(jconfig.FLAGS)
    for key, flag in jconfig.FLAGS.items():
        mine = tconfig.FLAGS[key]
        assert (mine.default, mine.type, mine.short) == \
            (flag.default, flag.type, flag.short), key
    cfg = tconfig.Config({"uda.tpu.merge.overlap": "false",
                          "mapred.rdma.buf.size": "2"})
    assert cfg.get("uda.tpu.merge.overlap") is False
    assert cfg.get("mapred.rdma.buf.size") == 2
    with pytest.raises(ConfigError):
        tconfig.Config({"mapred.rdma.buf.size": "two"})


# -- the map-output writer ----------------------------------------------------

def test_mof_writer_matches_reference(tmp_path):
    parts = [sorted_text(text_records(s, 120)) for s in range(3)] + [[]]
    twriter.MOFWriter(str(tmp_path / "t"), "job").write("m0", parts)
    jwriter.MOFWriter(str(tmp_path / "j"), "job").write("m0", parts)
    for name in ("file.out", "file.out.index"):
        got = (tmp_path / "t" / "job" / "m0" / name).read_bytes()
        want = (tmp_path / "j" / "job" / "m0" / name).read_bytes()
        assert got == want and got


# -- packing and the packed-key sort -------------------------------------------

@pytest.mark.parametrize("java_class,width", [
    (TEXT, 16), (TEXT, 4), ("org.apache.hadoop.io.BytesWritable", 8),
    ("org.apache.hadoop.io.LongWritable", 8), ("uda.tpu.LongNumeric", 8),
    ("org.apache.hadoop.io.IntWritable", 4)])
def test_pack_keys_and_sort_permutation_match_reference(java_class, width):
    """Keys wider than the carried width collide on their prefixes: the
    overflow ranks order them, in the port as in the reference."""
    kt = jcmp.get_key_type(java_class)
    rng = np.random.default_rng(width)
    if kt.name == "text":
        keys = [k for k, _ in text_records(width, 400, max_len=24,
                                           alphabet=2)]
    elif kt.name == "bytes":
        keys = [len(c).to_bytes(4, "big") + c for c in
                (bytes(rng.integers(0, 2, int(rng.integers(0, 14)),
                                    dtype=np.uint8)) for _ in range(400))]
    else:
        keys = [bytes(rng.integers(0, 3, kt.fixed_width, dtype=np.uint8))
                for _ in range(400)]
    data = jifile.write_records((k, b"") for k in keys)
    jp = jpacking.pack_keys(jifile.crack(data), kt, width)
    tp = tpacking.pack_keys(tifile.crack(data), tcmp.get_key_type(java_class),
                            width)
    for col in ("key_words", "key_lens", "ranks"):
        np.testing.assert_array_equal(getattr(tp, col), getattr(jp, col))
    want = jsort.sort_permutation(jp)
    np.testing.assert_array_equal(tsort.sort_permutation(tp, "cpu"), want)
    perm, run_id = tsort.merge_runs([tp, tp], "cpu")
    jperm, jrun = jsort.merge_runs([jp, jp])
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(run_id, jrun)


def test_sort_records_fixed_and_payload_match_reference():
    recs = [(k, v[:20].ljust(20, b"\0")) for k, v in text_records(9, 300)]
    data = jifile.write_records(recs)
    jb, tb = jifile.crack(data), tifile.crack(data)
    kt = jcmp.get_key_type(TEXT)
    jp = jpacking.pack_keys(jb, kt, 16)
    tp = tpacking.pack_keys(tb, tcmp.get_key_type(TEXT), 16)
    pay = tpacking.pack_fixed_payload(tb, 20)
    np.testing.assert_array_equal(pay, jpacking.pack_fixed_payload(jb, 20))
    assert tpacking.unpack_fixed_payload(pay, None, 20) == \
        jpacking.unpack_fixed_payload(pay, None, 20)
    spay, perm = tsort.sort_records_fixed(tp, pay, device="cpu")
    jspay, jperm = jsort.sort_records_fixed(jp, pay)
    np.testing.assert_array_equal(n_words(spay), np.asarray(jspay))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


# -- K1 as a pair merge -----------------------------------------------------------

def composite_runs(seed: int, na: int, nb: int, w: int, cap: int = 0,
                   equal: bool = False):
    """Two sorted uint32[n, w] runs of a small alphabet (equal rows within
    and across runs); ``cap`` pads each to that capacity with
    all-0xFFFFFFFF rows, ``equal`` makes B a copy of A's first rows."""
    rng = np.random.default_rng(seed)
    runs = []
    for n in (na, nb):
        r = rng.integers(0, 3, size=(n, w), dtype=np.uint32)
        r[rng.random(n) < 0.1] = np.uint32(0x80000000)
        runs.append(r[np.lexsort(r.T[::-1])])
    if equal:
        runs[1] = runs[0][:nb].copy()
    if cap:
        runs = [np.concatenate([r, np.full((cap - len(r), w), 0xFFFFFFFF,
                                           np.uint32)]) for r in runs]
    return runs


@pytest.mark.parametrize("na,nb,w,cap,equal", [
    (300, 200, 7, 512, False),     # valid counts below capacity (pad rows)
    (700, 90, 2, 0, False),        # na != nb, L an odd multiple of the tile
    (200, 1000, 10, 0, False),     # W = 10, the longer run second
    (512, 512, 7, 0, True),        # equal composite keys across runs
])
def test_merge_sorted_pair_matches_reference(na, nb, w, cap, equal):
    a, b = composite_runs(na + nb + w, na, nb, w, cap, equal)
    want = np.asarray(jpm.merge_sorted_pair(jnp.asarray(a), jnp.asarray(b),
                                            num_keys=w, interpret=True))
    got = tpm.merge_sorted_pair(t_words(a), t_words(b), num_keys=w)
    np.testing.assert_array_equal(n_words(got), want)


@pytest.mark.parametrize("na,nb,w,tile", [(1500, 40, 3, 512),
                                          (2560, 2560, 7, 512),
                                          (100, 0, 4, 128), (5, 9, 31, 128)])
def test_merge_sorted_pair_matches_numpy(na, nb, w, tile):
    """Odd multiples of the tile, an empty run and 31 columns, against
    numpy's stable lexsort of the concatenation (ties to A)."""
    a, b = composite_runs(na * nb + w, na, nb, w)
    cat = np.concatenate([a, b])
    want = cat[np.lexsort(cat.T[::-1])]
    got = tpm.merge_sorted_pair(t_words(a), t_words(b), num_keys=w,
                                tile=tile)
    np.testing.assert_array_equal(n_words(got), want)


def test_merge_sorted_pair_sends_payload_ties_to_a():
    """With fewer key columns than columns, equal keys keep A's rows first
    and each run's own order, payload columns riding along."""
    a, b = composite_runs(4, 300, 400, 5)
    a[:, 2:] = 1
    b[:, 2:] = 2
    a = a[np.lexsort(a.T[1::-1])]
    b = b[np.lexsort(b.T[1::-1])]
    want = np.asarray(jpm.merge_sorted_pair(jnp.asarray(a), jnp.asarray(b),
                                            num_keys=2, interpret=True))
    got = tpm.merge_sorted_pair(t_words(a), t_words(b), num_keys=2)
    np.testing.assert_array_equal(n_words(got), want)


def test_merge_sorted_pair_refuses_what_reference_refuses():
    a = t_words(np.zeros((4, 32), np.uint32))
    with pytest.raises(ValueError, match="32-row"):
        tpm.merge_sorted_pair(a, a, num_keys=3)
    b = t_words(np.zeros((4, 3), np.uint32))
    with pytest.raises(ValueError, match="power of two"):
        tpm.merge_sorted_pair(b, b, num_keys=3, tile=384)


@pytest.mark.parametrize("tile", [128, 512])
def test_merge_splits_match_reference(tile):
    a, b = composite_runs(tile, 900, 1300, 4)
    want = np.asarray(jpm.merge_splits(jnp.asarray(a), jnp.asarray(b),
                                       tile=tile, num_keys=4))
    got = tpm.merge_splits(t_words(a), t_words(b), tile, 4)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the record merges ----------------------------------------------------------

def segment_batches(seed: int, k: int, n: int, max_len: int = 14):
    """k map-side-sorted segments of Text records (one unsorted, so the
    per-run lexsort runs too), as (port batches, reference batches)."""
    datas = []
    for s in range(k):
        recs = text_records(seed + s, n + 37 * s, max_len=max_len)
        datas.append(jifile.write_records(recs if s == 1
                                          else sorted_text(recs)))
    return ([tifile.crack(d) for d in datas],
            [jifile.crack(d) for d in datas])


@pytest.mark.parametrize("k", [3, 5])
def test_merge_batches_two_phase_matches_reference(k):
    tb, jb = segment_batches(k, k, 400)
    kt, jkt = tcmp.get_key_type(TEXT), jcmp.get_key_type(TEXT)
    want = jmerge.merge_batches(jb, jkt, 16)
    assert_batches_equal(jmerge.merge_batches_two_phase(jb, jkt, 16,
                                                        engine="host"), want)
    for engine in ("pallas", "host"):
        got = tmerge.merge_batches_two_phase(tb, kt, 16, engine=engine,
                                             device="cpu")
        assert_batches_equal(got, want)
    assert_batches_equal(tmerge.merge_batches(tb, kt, 16, device="cpu"),
                         want)
    assert_batches_equal(tmerge.merge_batches_host(tb, kt), want)
    assert list(tmerge.merge_iter_host(tb, kt)) == \
        list(jmerge.merge_iter_host(jb, jkt))


def test_merge_batches_two_phase_pallas_matches_reference_pallas():
    """The port's "pallas" engine (K1's plain version) against the
    reference's (its Pallas kernel in interpret mode) on 3 segments."""
    tb, jb = segment_batches(11, 3, 150)
    got = tmerge.merge_batches_two_phase(tb, tcmp.get_key_type(TEXT), 16,
                                         engine="pallas", device="cpu")
    want = jmerge.merge_batches_two_phase(jb, jcmp.get_key_type(TEXT), 16,
                                          engine="pallas", interpret=True)
    assert_batches_equal(got, want)


def test_merge_batches_two_phase_overflow_keys_fall_back():
    """Keys wider than the carried width take the whole re-sort, in the
    port as in the reference, with the same bytes."""
    tb, jb = segment_batches(21, 4, 200, max_len=40)
    got = tmerge.merge_batches_two_phase(tb, tcmp.get_key_type(TEXT), 16,
                                         engine="pallas", device="cpu")
    assert_batches_equal(got, jmerge.merge_batches(
        jb, jcmp.get_key_type(TEXT), 16))


def test_row_helpers_match_reference():
    tb, jb = segment_batches(31, 2, 300)
    tp = tpacking.pack_keys(tb[1], tcmp.get_key_type(TEXT), 16)
    jp = jpacking.pack_keys(jb[1], jcmp.get_key_type(TEXT), 16)
    order = tmerge.run_row_order(tp)
    np.testing.assert_array_equal(order, jmerge.run_row_order(jp))
    assert tmerge.run_row_order(tpacking.pack_keys(
        tb[0], tcmp.get_key_type(TEXT), 16)) is None
    rows, jrows = (np.empty((1024, 4 + tmerge.ROW_EXTRA_COLS), np.uint32)
                   for _ in range(2))
    tmerge.fill_run_rows(rows, tp, order, 3)
    jmerge.fill_run_rows(jrows, jp, order, 3)
    np.testing.assert_array_equal(rows, jrows)
    padded = tmerge.pad_rows_to(t_words(rows[:600]), 1024)
    np.testing.assert_array_equal(
        n_words(padded), np.asarray(jmerge.pad_rows_to(
            jnp.asarray(rows[:600]), 1024)))
    srt = rows[np.lexsort(rows.T[::-1])]
    for m in (0, 1, 333, 700, 1024):
        assert tmerge.merge_split_point(srt[:500], srt[500:], m) == \
            jmerge.merge_split_point(srt[:500], srt[500:], m)
    for n in (0, 1, 512, 513, 70000):
        assert tmerge.next_run_capacity(n) == jmerge.next_run_capacity(n)
    assert (tmerge.PAD_WORD, tmerge.MIN_RUN_CAPACITY,
            tmerge.ROW_EXTRA_COLS) == (jmerge.PAD_WORD,
                                       jmerge.MIN_RUN_CAPACITY,
                                       jmerge.ROW_EXTRA_COLS)


def test_merge_routing_matches_reference_on_the_cpu():
    for mode in ("auto", "on", "off"):
        for k in (1, 2, 5):
            assert tmerge.resolve_merge_mode(mode, k, "cpu") == \
                jmerge.resolve_merge_mode(mode, k)
    assert tmerge.resolve_run_engine("auto", "cpu") == \
        jmerge.resolve_run_engine("auto") == "host"
    for bad in (lambda: tmerge.resolve_merge_mode("maybe", 3, "cpu"),
                lambda: tmerge.resolve_run_engine("xla", "cpu")):
        with pytest.raises(tmerge.MergeError):
            bad()


def test_merge_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb, _ = segment_batches(41, 2, 50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmerge.merge_batches_two_phase(tb, tcmp.get_key_type(TEXT), 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmerge.merge_batches(tb, tcmp.get_key_type(TEXT), 16)


def test_merge_batches_two_phase_with_one_nonempty_run():
    """Empty segments around a single non-empty one: the fold has one run
    and nothing to merge, in the port as in the reference."""
    tb, jb = segment_batches(51, 1, 300)
    empty_t, empty_j = (mod.crack(jifile.EOF_MARKER)
                        for mod in (tifile, jifile))
    got = tmerge.merge_batches_two_phase([empty_t, tb[0], empty_t],
                                         tcmp.get_key_type(TEXT), 16,
                                         engine="pallas", device="cpu")
    assert_batches_equal(got, jmerge.merge_batches(
        [empty_j, jb[0], empty_j], jcmp.get_key_type(TEXT), 16))
