"""The port's run spool and slab emission (uda_tpu_torch.merger.streaming)
against the JAX package's (uda_tpu.merger.streaming) on the same inputs:
run files and offset sidecars byte for byte, the permutation-driven
interleave of the runs, the slab gather and framing, the grouping of a
slab by segment, the framed lengths, the row slabs (numpy rows and
CPU-tensor rows) and the spill directories.
Tolerance 0: all of it is bytes and integers."""

import os

import numpy as np
import pytest
import torch

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.merger import streaming as jstream
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.errors import MergeError as JMergeError
from uda_tpu.utils.ifile import crack, write_records
from uda_tpu_torch.merger import streaming as tstream
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import MergeError
from uda_tpu_torch.utils.ifile import RecordBatch, crack_partial

KW = 4  # key words of the merged rows the tests build


def _recs(seed, n, big_values=False):
    rng = np.random.default_rng(seed)
    return [(rng.bytes(int(rng.integers(0, 9))),
             rng.bytes(int(rng.integers(100, 400) if big_values
                           else rng.integers(0, 30))))
            for _ in range(n)]


def _port_batch(b):
    return RecordBatch(b.data.copy(), b.key_off.copy(), b.key_len.copy(),
                       b.val_off.copy(), b.val_len.copy())


def _chunked_batch(recs, chunk):
    """A batch cracked chunk by chunk as a Segment builds it: the carried
    partial record appears in two chunk buffers, so the concatenation is
    not one contiguous framing."""
    data = write_records(recs)
    batches, carry = [], b""
    for off in range(0, len(data), chunk):
        buf = carry + data[off:off + chunk]
        last = off + chunk >= len(data)
        b, used, _ = crack_partial(buf, expect_eof=last)
        batches.append(b)
        carry = buf[used:]
    return RecordBatch.concat(batches)


def _sorted_order(batch, rng, kind):
    n = batch.num_records
    if kind == "identity":
        return np.arange(n, dtype=np.int64)
    if kind == "reversed":
        return np.arange(n - 1, -1, -1, dtype=np.int64)
    return rng.permutation(n).astype(np.int64)


@pytest.mark.parametrize("kind", ["identity", "reversed", "shuffled"])
@pytest.mark.parametrize("chunked", [False, True])
def test_write_run_files_match_reference(tmp_path, kind, chunked):
    recs = _recs(3, 200, big_values=True)
    ref = crack(write_records(recs))
    port = _chunked_batch(recs, 1024) if chunked else _port_batch(ref)
    order = _sorted_order(ref, np.random.default_rng(4), kind)
    jstore = jstream.RunStore([str(tmp_path / "ref")], tag="t")
    tstore = tstream.RunStore([str(tmp_path / "port")], tag="t")
    jstore.write_run(7, ref, order)
    tstore.write_run(7, port, order)
    for want, got in zip(jstore._paths(7), tstore._paths(7)):
        assert os.path.basename(got) == os.path.basename(want)
        with open(want, "rb") as f, open(got, "rb") as g:
            assert g.read() == f.read()
    assert tstore.counts == jstore.counts
    assert tstore.bytes == jstore.bytes
    assert tstore.total_records == jstore.total_records == 200
    assert tstore.run_path(7) == tstore._paths(7)[0]
    with pytest.raises(MergeError, match="staged twice"):
        tstore.write_run(7, port, order)
    tstore.cleanup()
    jstore.cleanup()
    assert not os.listdir(tmp_path / "port")


def _spooled(tmp_path, k=5, rotate=1):
    """The same k sorted runs spooled by both stores, and the merged rows
    (KW key words, length, segment, row) of their global stable merge."""
    rng = np.random.default_rng(11)
    dirs = [str(tmp_path / f"d{i}") for i in range(rotate)]
    jstore = jstream.RunStore([d + "r" for d in dirs], tag="t")
    tstore = tstream.RunStore([d + "p" for d in dirs], tag="t")
    rows = []
    for s in range(k):
        if s == 2:
            continue  # a segment with no run: it never appears in the rows
        ref = crack(write_records(_recs(20 + s, 50 + 13 * s)))
        n = ref.num_records
        keys = rng.integers(0, 5, (n, KW)).astype(np.uint32)
        order = np.lexsort(keys.T[::-1]).astype(np.int64)
        jstore.write_run(s, ref, order)
        tstore.write_run(s, _port_batch(ref), order)
        r = np.zeros((n, KW + 3), np.uint32)
        r[:, :KW] = keys[order]
        r[:, KW + 1] = s
        r[:, KW + 2] = order
        rows.append(r)
    rows = np.concatenate(rows)
    rows = rows[np.lexsort(rows.T[::-1])]
    return jstore, tstore, rows


@pytest.mark.parametrize("slab,rotate,max_open", [
    (1 << 16, 1, 256), (37, 2, 256), (64, 1, 2)])
def test_interleave_runs_matches_reference(tmp_path, monkeypatch, slab,
                                           rotate, max_open):
    """The permutation-driven interleave of the same runs by the same
    merged rows, at slab sizes that split the stream and with so few open
    cursors that runs are suspended and reopened."""
    monkeypatch.setattr(jstream, "MAX_OPEN_CURSORS", max_open)
    monkeypatch.setattr(tstream, "MAX_OPEN_CURSORS", max_open)
    jstore, tstore, rows = _spooled(tmp_path, rotate=rotate)
    want = b"".join(jstream.interleave_runs(
        jstream.iter_row_slabs(rows, rows.shape[0], slab), jstore, KW))
    got = b"".join(tstream.interleave_runs(
        tstream.iter_row_slabs(rows[:, KW + 1:KW + 3], rows.shape[0], slab),
        tstore, seg_col=0))
    assert got == want and got.endswith(b"\xff\xff")
    assert crack(got).num_records == rows.shape[0]
    jstore.cleanup()
    tstore.cleanup()


def test_interleave_runs_guards_lost_records(tmp_path):
    """Merged rows that leave part of a run unconsumed raise, in both."""
    jstore, tstore, rows = _spooled(tmp_path)
    short = rows[:-3]
    with pytest.raises(JMergeError, match="consumed"):
        b"".join(jstream.interleave_runs(iter([short]), jstore, KW))
    with pytest.raises(MergeError, match="consumed"):
        b"".join(tstream.interleave_runs(iter([short[:, KW + 1:KW + 3]]),
                                         tstore, seg_col=0))
    bad = rows[:, KW + 1:KW + 3].copy()
    bad[0, 0] = 2  # a segment that spooled no run
    with pytest.raises(MergeError, match="unstaged segment 2"):
        b"".join(tstream.interleave_runs(iter([bad]), tstore, seg_col=0))


@pytest.mark.parametrize("slab", [1 << 16, 37])
def test_interleave_runs_takes_the_references_arguments(tmp_path, slab):
    """``interleave_runs(slabs, store, num_key_words)`` called as the
    reference is called, on whole rows: the segment is read from column
    ``num_key_words + 1`` in both packages and the bytes are equal."""
    jstore, tstore, rows = _spooled(tmp_path, rotate=2)
    want = b"".join(jstream.interleave_runs(
        jstream.iter_row_slabs(rows, rows.shape[0], slab), jstore, KW))
    got = b"".join(tstream.interleave_runs(
        tstream.iter_row_slabs(rows, rows.shape[0], slab), tstore, KW))
    assert got == want and got.endswith(b"\xff\xff")
    with pytest.raises(TypeError, match="not both"):
        b"".join(tstream.interleave_runs(iter([rows]), tstore, KW,
                                         seg_col=KW + 1))
    jstore.cleanup()
    tstore.cleanup()


def _slab_column(case, rng):
    """(fan-in, segment column) of one slab: fan-ins 1, 3, 4 and 64, a
    segment absent from the slab, a slab of one segment, an empty slab,
    and the edges (every segment's first and last record, then a slab of
    one record)."""
    if case.startswith("fanin"):
        k = int(case[len("fanin"):])
        return k, rng.integers(0, k, 300 + 20 * k)
    return 4, {"absent": rng.choice([0, 1, 3], 300),
               "one_segment": np.full(120, 2),
               "empty": np.zeros(0, np.int64),
               "edges": np.repeat(np.arange(4), 2),
               "one_record": np.array([3])}[case]


@pytest.mark.parametrize("case", ["fanin1", "fanin3", "fanin4", "fanin64",
                                  "absent", "one_segment", "empty",
                                  "edges", "one_record"])
@pytest.mark.parametrize("split", ["none", "all", "one"])
def test_slab_batch_matches_reference(case, split):
    """The same records in the same order as the reference's slab, each
    value right after its key; from cracked segments and from segments
    whose values do not follow their keys (``split``: every segment, or
    only segment 1; the reference's own slabs, every key before every
    value). ``frame_slabs`` over the same rows cut into slabs of 7 frames
    them as the reference's IFile writer does, EOF marker last."""
    rng = np.random.default_rng(5)
    k, seg = _slab_column(case, rng)
    refs = [crack(write_records(_recs(s, 40 + s))) for s in range(k)]
    refs = [jstream.slab_batch([b], np.zeros(b.num_records, np.int64),
                               np.arange(b.num_records))
            if split == "all" or (split == "one" and s == 1) else b
            for s, b in enumerate(refs)]
    ports = [_port_batch(b) for b in refs]
    if case == "edges":
        row = np.array([(0, refs[s].num_records - 1)[i % 2]
                        for i, s in enumerate(seg)])
    else:
        row = np.array([int(rng.integers(0, refs[s].num_records))
                        for s in seg], np.int64)
    want = jstream.slab_batch(refs, seg, row)
    got = tstream.slab_batch(ports, seg, row)
    assert list(got.iter_records()) == list(want.iter_records())
    assert np.array_equal(got.key_len, want.key_len)
    assert np.array_equal(got.val_len, want.val_len)
    assert np.array_equal(got.val_off, got.key_off + got.key_len)
    assert got.data.size == want.data.size
    pairs = np.stack([seg, row], axis=1).astype(np.uint32)
    framed = b"".join(tstream.frame_slabs(
        tstream.iter_row_slabs(pairs, pairs.shape[0], 7), ports))
    assert framed == write_records(list(want.iter_records()))


@pytest.mark.parametrize("valid,slab", [(1000, 300), (1000, 1000),
                                        (999, 1 << 16), (0, 64)])
def test_iter_row_slabs_matches_reference(valid, slab):
    rows = np.random.default_rng(9).integers(
        0, 2**32, (1024, 7), dtype=np.uint64).astype(np.uint32)
    want = list(jstream.iter_row_slabs(rows, valid, slab))
    tensor = torch.from_numpy(rows.view(np.int32)).view(torch.uint32)
    for src in (rows, tensor):
        got = list(tstream.iter_row_slabs(src, valid, slab))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint32 and np.array_equal(g, w)
    cols = list(tstream.iter_row_slabs(tensor[:, 5:7], valid, slab))
    assert all(np.array_equal(g, w[:, 5:7]) for g, w in zip(cols, want))


def _group_ranks(seg):
    """The reference's ``_group_ranks`` read off the port's grouping: a
    record's rank in its segment is its place in the segment's
    positions."""
    groups = tstream._group_by_segment(seg)
    ranks = np.empty(seg.shape[0], np.int64)
    for _, at in groups:
        ranks[at] = np.arange(at.shape[0])
    return (np.array([s for s, _ in groups], np.int64), ranks,
            np.array([at.shape[0] for _, at in groups], np.int64))


@pytest.mark.parametrize("kind", ["random", "sorted", "reversed", "one",
                                  "single", "empty", "sparse"])
def test_group_by_segment_matches_reference_group_ranks(kind):
    """One stable argsort groups a slab: each segment's positions are
    its slab positions in slab order, the segments in increasing order,
    and the ranks, segments and counts read off them are the
    reference's ``_group_ranks``."""
    rng = np.random.default_rng(13)
    seg = {"random": rng.integers(0, 64, 5000),
           "sorted": np.sort(rng.integers(0, 64, 5000)),
           "reversed": np.sort(rng.integers(0, 9, 700))[::-1].copy(),
           "one": np.full(300, 5), "single": np.array([63]),
           "empty": np.zeros(0, np.int64),
           "sparse": rng.choice([0, 7, 1000, 70000], 900)}[kind]
    seg = seg.astype(np.int64)
    groups = tstream._group_by_segment(seg)
    assert [s for s, _ in groups] == np.unique(seg).tolist()
    for s, at in groups:
        assert np.array_equal(at, np.flatnonzero(seg == s))
    for g, w in zip(_group_ranks(seg), jstream._group_ranks(seg)):
        assert np.array_equal(g, w)


def test_framed_lengths_and_spans_match_reference():
    rng = np.random.default_rng(2)
    klen = np.concatenate([[0, 1, 127, 128, 255, 256, 65535, 65536,
                            2**24, 2**31 - 1], rng.integers(0, 5000, 200)])
    vlen = rng.permutation(klen)
    assert np.array_equal(tstream.framed_lengths(klen, vlen),
                          jstream.framed_lengths(klen, vlen))
    with pytest.raises(MergeError):
        tstream.framed_lengths(np.array([-1]), np.array([0]))
    seg = rng.integers(0, 6, 500)
    for g, w in zip(_group_ranks(seg), jstream._group_ranks(seg)):
        assert np.array_equal(g, w)
    recs = _recs(8, 30)
    assert np.array_equal(
        tstream.framed_lengths(*(np.array([len(r[i]) for r in recs])
                                 for i in (0, 1))).cumsum()[-1] + 2,
        len(write_records(recs)))


def _span_lengths(kind: str, rng, n: int) -> np.ndarray:
    edges = np.array([1, 2, 3, 4, 7, 8, 9, 63, 64, 65, 127, 128, 129,
                      1023, 1024, 1025])
    return {"fixed": np.full(n, 104), "few": rng.choice([11, 91, 0], n),
            "many": rng.integers(0, 400, n),
            "zeros": np.zeros(n, np.int64),
            "text_values": rng.integers(1, 1001, n),
            "class_edges": rng.choice(edges, n)}[kind]


@pytest.mark.parametrize("lengths", ["fixed", "few", "many", "zeros",
                                     "text_values", "class_edges"])
def test_gather_spans_matches_reference(lengths):
    """The span gather, the native one and the one by size class, against
    the reference's (its native memcpy loop or its per-byte index): spans
    of one length, of a few, of hundreds, of a thousand (Text values of 1
    to 1000 bytes), at the edges of the power-of-two classes, empty ones,
    repeated and overlapping sources."""
    rng = np.random.default_rng(len(lengths))
    n = 3000
    lens = _span_lengths(lengths, rng, n)
    src = rng.integers(0, 256, int(lens.max()) * 50 + 7, dtype=np.uint8)
    src_off = rng.integers(0, src.size - int(lens.max()) + 1, n)
    dst_off = np.cumsum(lens) - lens
    want = np.zeros(int(lens.sum()), np.uint8)
    jstream._gather_spans(src, src_off, lens, want, dst_off)
    for gather in (tstream._gather_spans, tstream._gather_spans_numpy):
        got = np.zeros_like(want)
        gather(src, src_off, lens, got, dst_off)
        assert np.array_equal(got, want)
        gather(src, src_off[:0], lens[:0], got, dst_off[:0])


@pytest.mark.parametrize("lengths", ["fixed", "text_values"])
def test_gather_spans_cost_does_not_follow_the_length_mix(monkeypatch,
                                                          lengths):
    """A thousand distinct lengths cost the numpy gather (the one taken
    with ``uda.tpu.use.native`` off) no more work than their ten
    power-of-two classes: one source and one target window view a class,
    each class moved in at most two gathers."""
    rng = np.random.default_rng(7)
    n = 20000
    lens = _span_lengths(lengths, rng, n)
    src = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    src_off = np.cumsum(lens) - lens
    views = []
    real = tstream.sliding_window_view

    def counted(*args, **kwargs):
        views.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tstream, "sliding_window_view", counted)
    got = np.zeros_like(src)
    perm = rng.permutation(n)
    dst_off = (np.cumsum(lens[perm]) - lens[perm])[np.argsort(perm)]
    tstream._gather_spans_numpy(src, src_off, lens, got, dst_off)
    want = np.zeros_like(src)
    jstream._gather_spans(src, src_off, lens, want, dst_off)
    assert np.array_equal(got, want)
    classes = len(np.unique(np.floor(np.log2(lens))))
    assert len(views) == 2 * classes  # a source and a target view a class
    if lengths == "text_values":
        assert classes == 10 and len(np.unique(lens)) > 900


@pytest.mark.parametrize("dirs", ["", "a", "a,b", ",a,,b,"])
def test_spill_dirs_match_reference(dirs):
    conf = {"uda.tpu.spill.dirs": dirs}
    assert tstream.spill_dirs(Config(conf)) == \
        jstream.spill_dirs(JConfig(conf))
