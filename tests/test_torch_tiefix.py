"""Keys past the carried width on the port's default reduce path: runs of
Text keys longer than ``uda.tpu.key.width`` (16 B) stay on the overlapped
merger's K1 forest, and the emit's tie-fix (``merger/streaming.
tiefix_slabs``) re-sorts each block of equal-prefix oversize keys by its
whole content. ``MergeManager.run``'s stream, with the host engine and
with K1's plain version, is held byte for byte to the JAX package's
``MergeManager.run`` (which re-sorts the whole shuffle) and to the plain
reference of the benchmark's Text cell (``portbench/reference/
reduce_text.py``, Python's stable sort), at the default slab and at a
slab of 3 records, so that blocks straddle slabs."""

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from portbench import gen_text, ifile
from portbench.reference import reduce_text as plain
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.ifile import write_records
from uda_tpu.utils.vint import encode_vlong
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.merger import merge_manager, overlap
from uda_tpu_torch.merger import streaming
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import metrics

TEXT = "org.apache.hadoop.io.Text"
JOB = "tiefix"
# 1 KB fetch chunks: records cross chunks
CONF = {"mapred.rdma.buf.size": 1}
PRE = b"0123456789abcdef"          # the carried width, 16 bytes


def _part(pairs) -> np.ndarray:
    """One map's partition, sorted as a map leaves it: (key content,
    value content) pairs as framed IFile records of Text keys and
    values."""
    body = write_records((encode_vlong(len(k)) + k, encode_vlong(len(v)) + v)
                         for k, v in sorted(pairs, key=lambda kv: kv[0]))
    body = body[:-2]                          # no EOF marker
    return np.frombuffer(body, np.uint8)


def _shared_prefixes():
    """Keys past the width whose first 16 bytes are equal across maps,
    values up to 300 bytes."""
    rng = np.random.default_rng(1)
    return [_part((PRE + bytes(rng.integers(97, 100, int(rng.integers(1, 6)),
                                            dtype=np.uint8)),
                   rng.bytes(int(rng.integers(0, 300))))
                  for _ in range(40)) for _ in range(4)]


def _prefix_keys():
    """Keys of exactly 16 bytes, their proper prefixes, and longer keys
    that go on past them in zeros (zero-padding ties) or in bytes."""
    keys = [PRE, PRE[:15], PRE[:1], PRE + b"\0", PRE + b"\0\0", PRE + b"a",
            PRE + b"a\0", PRE + b"a\0\0" + PRE, PRE + b"\x80",
            PRE[:15] + b"\0", PRE[:15] + b"\0\0"]
    return [_part((k, b"m%d-%d" % (m, i)) for i, k in enumerate(keys)
                  if (i + m) % 3) for m in range(3)]


def _equal_long_keys():
    """Whole-key ties past the width in several maps: map order, then row
    order."""
    keys = [PRE + b" the same long key", PRE + b" another one"]
    return [_part((keys[i % 2], b"m%d-r%d" % (m, i)) for i in range(7))
            for m in range(4)]


def _deep_ties():
    """Keys that share 40 to 60 bytes past the width: the tie-fix's later
    rounds."""
    rng = np.random.default_rng(3)
    base = PRE + bytes(rng.integers(97, 123, 44, dtype=np.uint8))
    return [_part((base[:int(rng.integers(40, 61))]
                   + bytes(rng.integers(97, 99, int(rng.integers(0, 4)),
                                        dtype=np.uint8)), b"%d" % i)
                  for i in range(30)) for _ in range(3)]


def _mixed():
    """Short and oversize keys in one run: cuts of three 24-byte stems and
    a tail of up to 3 bytes of an alphabet of 3, so short keys prefix
    long ones and blocks of long keys break on short ones."""
    rng = np.random.default_rng(5)
    stems = [bytes(rng.integers(0, 3, 24, dtype=np.uint8)) for _ in range(3)]
    return [_part((stems[int(rng.integers(0, 3))][:int(rng.integers(0, 25))]
                   + bytes(rng.integers(0, 3, int(rng.integers(0, 4)),
                                        dtype=np.uint8)),
                   rng.bytes(int(rng.integers(0, 40))))
                  for _ in range(120)) for _ in range(3)]


def _random_text():
    """The benchmark's generator at a tiny size."""
    conf = {"maps": 3, "records_per_map": 3000, "reducers": 32,
            "reduce_partition": 0,
            "randomtextwriter": {"minwordskey": 5, "maxwordskey": 10,
                                 "minwordsvalue": 10, "maxwordsvalue": 100},
            "dictionary": {"seed": 20260917, "words": 40, "min_letters": 2,
                           "max_letters": 18}}
    return gen_text.text_partitions((1 << 32) + 17, conf)


CASES = {"shared_prefixes": _shared_prefixes, "prefix_keys": _prefix_keys,
         "equal_long_keys": _equal_long_keys, "deep_ties": _deep_ties,
         "mixed": _mixed, "random_text": _random_text}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A case's map outputs, written once, with the JAX package's stream
    and the plain reference's: {case: (root, map ids, jax, plain)}."""
    made = {}

    def tree(case):
        if case not in made:
            root = str(tmp_path_factory.mktemp(case))
            parts = CASES[case]()
            mids = ifile.write_tree(root, JOB, parts)
            out = bytearray()
            engine = JDataEngine(JDirIndexResolver(root), JConfig(CONF))
            try:
                JMergeManager(JLocalFetchClient(engine), TEXT,
                              JConfig(CONF)).run(JOB, mids, 0, out.extend)
            finally:
                engine.stop()
            made[case] = (root, mids, bytes(out),
                          plain.stream_of(plain.merged_records(parts)))
        return made[case]
    return tree


@pytest.mark.parametrize("slab", [None, 3])
@pytest.mark.parametrize("engine", ["host", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_long_keys_stay_on_the_forest_and_match(trees, monkeypatch, case,
                                                engine, slab):
    root, mids, want_jax, want_plain = trees(case)
    assert want_jax == want_plain
    merged = []

    def merger(*args, **kwargs):
        merged.append(overlap.OverlappedMerger(*args, engine=engine,
                                               **kwargs))
        return merged[-1]

    monkeypatch.setattr(merge_manager, "OverlappedMerger", merger)
    if slab is not None:
        rows = streaming.iter_row_slabs
        monkeypatch.setattr(streaming, "iter_row_slabs",
                            lambda r, valid, _slab=None: rows(r, valid, slab))
    before = {k: metrics.get(k) for k in streaming.TIEFIX_COUNTERS}
    out = bytearray()
    engine_ = DataEngine(DirIndexResolver(root), Config(CONF))
    try:
        n = MergeManager(LocalFetchClient(engine_), TEXT, Config(CONF),
                         device="cpu").run(JOB, mids, 0, out.extend)
    finally:
        engine_.stop()
    assert n == len(out) and bytes(out) == want_plain
    (om,) = merged
    stats = om.stats
    assert not stats["overflow"] and om._oversize
    assert stats["device_merges"] == stats["staged_runs"] - 1
    groups, rows_ = (metrics.get(k) - before[k]
                     for k in streaming.TIEFIX_COUNTERS)
    assert 0 < groups and 2 * groups <= rows_


def test_finish_orders_long_keys_as_emit_stream_does(trees):
    """``OverlappedMerger.finish`` (the whole order at once) and
    ``emit_stream`` (slab by slab) through the tie-fix, on the random
    text's batches: the same records in the same order."""
    from uda_tpu_torch.merger.emitter import FramedEmitter, frame_batch
    from uda_tpu_torch.utils.comparators import get_key_type
    from uda_tpu_torch.utils.ifile import crack

    root, mids, _, want = trees("random_text")
    batches = []
    for mid in mids:
        with open(f"{root}/{JOB}/{mid}/file.out", "rb") as f:
            batches.append(crack(f.read()))
    kt = get_key_type(TEXT)
    streams = []
    for finish in ("finish", "emit_stream"):
        om = overlap.OverlappedMerger(kt, 16, device="cpu")
        for i, b in enumerate(batches):
            om.feed(i, b)
        if finish == "finish":
            streams.append(frame_batch(om.finish(batches)))
        else:
            out = bytearray()
            om.emit_stream(batches, FramedEmitter(1 << 12), out.extend)
            streams.append(bytes(out))
    assert streams[0] == streams[1] == want


def test_a_custom_compare_keeps_the_global_resort(tmp_path, monkeypatch):
    """A key type whose ``compare`` is overridden cannot be ordered by
    bytes: its oversize keys still turn the forest off for the global
    re-sort, to the same bytes."""
    from uda_tpu_torch.utils import comparators

    kt = comparators.get_key_type(TEXT)

    class CmpOnly(type(kt)):
        def compare(self, a, b):
            return super().compare(a, b)

    monkeypatch.setitem(comparators._REGISTRY, TEXT,
                        CmpOnly(kt.name, kt.content))
    parts = _shared_prefixes()
    mids = ifile.write_tree(str(tmp_path), JOB, parts)
    merged = []

    def merger(*args, **kwargs):
        merged.append(overlap.OverlappedMerger(*args, **kwargs))
        return merged[-1]

    monkeypatch.setattr(merge_manager, "OverlappedMerger", merger)
    out = bytearray()
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config(CONF))
    try:
        MergeManager(LocalFetchClient(engine), TEXT, Config(CONF),
                     device="cpu").run(JOB, mids, 0, out.extend)
    finally:
        engine.stop()
    assert bytes(out) == plain.stream_of(plain.merged_records(parts))
    assert merged[0].stats["overflow"] and not merged[0]._oversize
