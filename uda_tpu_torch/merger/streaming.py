"""Streaming bounded-memory emission for the online merge.

The port's copy of ``uda_tpu/merger/streaming.py``, in a numpy form (the
reference hands the span gather and the framing to its C++ library when
built; the bytes are the same; the port gathers spans by size class,
see :func:`_gather_spans`). The reference's online merge never
materialized the shuffle on the host: records flowed RDMA chunk buffers ->
k-way heap -> 2 x 1 MB staging buffers -> consumer (reference
src/Merger/MergeManager.cc:155-182, src/Merger/StreamRW.cc:151-225), so
host memory stayed at O(fetch window). The device merge computes the
global order instead, which naively needs every segment's bytes resident
for the final gather; this module restores the reference's memory model
around it:

- **Sorted run spooling** (:class:`RunStore`): as each segment's fetch
  completes, its records are written to local disk *in per-segment
  sorted order* as an IFile-framed run plus an ``.off`` sidecar of
  cumulative framed-record end offsets; the fetched bytes are then
  released.
- **Permutation-driven interleave** (:func:`interleave_runs`): the merged
  device rows say, for every output position, which segment supplies the
  next record. Each run is sorted, so every run is read strictly
  sequentially: k buffered file cursors and one output slab, no
  comparisons.
- **Slab gather** (:func:`slab_batch`): the in-memory twin used when
  streaming is off: each output slab's bytes are gathered straight from
  the per-segment batches, never concatenating the whole shuffle.

With a checkpoint (``merger/checkpoint.py``) the store spools into the
checkpoint's fixed directory (``fixed_dir``: the files outlive the
process, cleanup leaves them), records each run's CRC as it writes it, and
lists its finished runs for the manifest (``manifest``); a resumed task
registers the runs it adopts (``adopt``) and unlinks the ones that fail
revalidation (``discard``).
"""

from __future__ import annotations

import os
import tempfile
import threading
import zlib
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from uda_tpu_torch.merger.emitter import frame_batch, iter_framed_chunks
from uda_tpu_torch.ops.sort import i32
from uda_tpu_torch.utils.errors import MergeError, StorageError
from uda_tpu_torch.utils.ifile import EOF_MARKER, RecordBatch
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["RunStore", "framed_lengths", "framed_records",
           "interleave_runs", "slab_batch",
           "iter_row_slabs", "spill_dirs", "SLAB_RECORDS",
           "MAX_OPEN_CURSORS"]

# records per emission slab: bounds transient host memory at emit to one
# slab's bytes (the streaming analogue of the reference's staging loop)
SLAB_RECORDS = 1 << 16


def _vlong_sizes(values: np.ndarray) -> np.ndarray:
    """Vectorized ``vint.vlong_size`` for non-negative lengths."""
    v = np.asarray(values, dtype=np.int64)
    if np.any(v < 0):
        raise MergeError("negative record length")
    # 1 byte for <=127; else 1 tag byte + minimal big-endian body
    nbits = np.zeros_like(v)
    nz = v > 0
    # number of bits via log2 on float64 is exact for lengths < 2^53
    nbits[nz] = np.floor(np.log2(v[nz])).astype(np.int64) + 1
    body = (nbits + 7) // 8
    return np.where(v <= 127, 1, body + 1)


def framed_lengths(key_len: np.ndarray, val_len: np.ndarray) -> np.ndarray:
    """Per-record IFile framed byte length: VInt(klen) VInt(vlen) key
    value (the ``write_kv_to_stream`` framing, StreamRW.cc:151-225)."""
    return (_vlong_sizes(key_len) + _vlong_sizes(val_len)
            + np.asarray(key_len, np.int64) + np.asarray(val_len, np.int64))


def _gather_spans(src: np.ndarray, src_off: np.ndarray, lens: np.ndarray,
                  dst: np.ndarray, dst_off: np.ndarray) -> None:
    """dst[dst_off_i : +len_i] = src[src_off_i : +len_i] per record (the
    reference's native memcpy loop), by power-of-two size class. The
    spans of class c (lengths in [2^c, 2^(c+1))) move as rows of the two
    buffers' sliding windows of the class's shortest length w: a span's
    first w bytes, then its last w, which together cover it since its
    length is under 2w (one move when the class holds one length). So a
    call makes at most two numpy gathers per class, whatever the mix of
    lengths, and moves at most twice the spans' bytes, where an int64
    index per byte (the reference's numpy fallback) builds 16 bytes of
    index for every byte it moves."""
    lens = np.asarray(lens, np.int64)
    live = lens > 0
    src_off = np.asarray(src_off, np.int64)[live]
    dst_off = np.asarray(dst_off, np.int64)[live]
    lens = lens[live]
    if lens.size == 0:
        return
    # the class: floor(log2(len)) + 1, exact for lengths under 2^53
    cls = np.frexp(lens.astype(np.float64))[1]
    order = np.argsort(cls, kind="stable")
    starts = np.flatnonzero(np.diff(cls[order], prepend=-1))
    ends = np.append(starts[1:], lens.size)
    for a, b in zip(starts.tolist(), ends.tolist()):
        idx = order[a:b]
        ln, so, do = lens[idx], src_off[idx], dst_off[idx]
        w = int(ln.min())
        src_w = sliding_window_view(src, w)
        dst_w = sliding_window_view(dst, w, writeable=True)
        dst_w[do] = src_w[so]
        tail = ln - w
        if tail.any():
            dst_w[do + tail] = src_w[so + tail]


def _group_ranks(seg: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For a slab's segment-index column, return (unique_segs,
    per-record rank within its segment group, per-seg counts): the
    sequential-cursor positions each record consumes."""
    unique, inverse, counts = np.unique(seg, return_inverse=True,
                                        return_counts=True)
    # rank of each occurrence within its group, preserving slab order
    order = np.argsort(inverse, kind="stable")
    ranks_sorted = np.arange(seg.shape[0], dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    ranks = np.empty(seg.shape[0], np.int64)
    ranks[order] = ranks_sorted
    return unique, ranks, counts


def framed_records(batch: RecordBatch) -> bytes:
    """The batch's records IFile-framed, without the EOF marker: a copy of
    its own bytes when they sit framed back to back in its buffer (every
    cracked chunk), else framed anew. The same bytes either way."""
    span = RunStore._contiguous_framed_span(
        batch, framed_lengths(batch.key_len, batch.val_len))
    if span is None:
        return frame_batch(batch, write_eof=False)
    return bytes(batch.data[span[0]:span[1]])


def spill_dirs(cfg) -> list[str]:
    """Parse ``uda.tpu.spill.dirs`` into a rotation list; empty = the
    system temporary directory."""
    dirs = [d for d in str(cfg.get("uda.tpu.spill.dirs")).split(",") if d]
    return dirs or [tempfile.gettempdir()]


class RunStore:
    """Per-segment sorted run files + offset sidecars in scratch dirs.

    One run per staged segment: ``run-SSSSS.ifile`` holds the segment's
    records in sorted order with the EOF marker (a complete, valid IFile
    stream, so the comparator-level k-way merge can consume runs directly
    on the overflow fallback), and ``run-SSSSS.off`` holds int64
    cumulative end offsets of each framed record (EOF excluded), letting
    the interleave slice records without parsing framing. Multiple base
    dirs rotate per segment. Thread-safe: a staging pool may spool
    different segments concurrently.
    """

    def __init__(self, base_dirs=None, tag: str = "online",
                 fixed_dir: Optional[str] = None):
        # fixed_dir (checkpointing): the runs live at a stable path that
        # outlives the process, where the manifest says; the checkpoint
        # owns the directory (cleanup() keeps the files)
        self.fixed = fixed_dir is not None
        if self.fixed:
            os.makedirs(fixed_dir, exist_ok=True)
            self.dirs = [fixed_dir]
        else:
            if isinstance(base_dirs, str):
                base_dirs = [base_dirs]
            roots = (list(base_dirs) if base_dirs
                     else [tempfile.gettempdir()])
            self.dirs = []
            for root in roots:
                os.makedirs(root, exist_ok=True)
                self.dirs.append(
                    tempfile.mkdtemp(prefix=f"uda.{tag}.runs.", dir=root))
        self.counts: dict[int, int] = {}   # seg index -> record count
        self.bytes: dict[int, int] = {}    # seg index -> framed bytes (no EOF)
        # seg index -> crc32 of the whole run file, EOF marker included
        # (the checkpoint manifest's torn-spool detector)
        self.crcs: dict[int, int] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _paths(self, seg_index: int) -> tuple[str, str]:
        stem = os.path.join(self.dirs[seg_index % len(self.dirs)],
                            f"run-{seg_index:05d}")
        return stem + ".ifile", stem + ".off"

    def run_path(self, seg_index: int) -> str:
        return self._paths(seg_index)[0]

    @property
    def total_records(self) -> int:
        return sum(self.counts.values())

    @staticmethod
    def _contiguous_framed_span(batch: RecordBatch, lens: np.ndarray):
        """When the batch's records sit back-to-back in its data buffer
        in their original framing, return the (start, end) byte span: the
        run file can then be written straight from the fetched bytes."""
        n = batch.num_records
        if n == 0:
            return None
        head = framed_lengths(batch.key_len, batch.val_len) \
            - batch.key_len - batch.val_len  # both VInt header bytes
        starts = batch.key_off - head
        ends = batch.val_off + batch.val_len
        if (int(starts[0]) >= 0 and np.all(starts[1:] == ends[:-1])
                and np.array_equal(lens, ends - starts)):
            return int(starts[0]), int(ends[-1])
        return None

    def write_run(self, seg_index: int, batch: RecordBatch,
                  order: np.ndarray) -> None:
        """Spool ``batch`` in ``order`` as this segment's sorted run,
        framed in bounded chunks. Identity order over a contiguously
        framed batch writes the fetched bytes verbatim."""
        with self._lock:
            if seg_index in self.counts:
                raise MergeError(f"segment {seg_index} staged twice")
            self.counts[seg_index] = -1  # reserve (pool-safe)
        sub = batch.take(order)
        run_path, off_path = self._paths(seg_index)
        lens = framed_lengths(sub.key_len, sub.val_len)
        ends = np.cumsum(lens)
        total = int(ends[-1]) if len(ends) else 0
        identity = (order.shape[0] > 0
                    and np.array_equal(order, np.arange(order.shape[0])))
        span = self._contiguous_framed_span(batch, lens) \
            if identity else None
        # the CRC accumulates while writing: one pass over bytes already
        # in cache
        crc = 0
        with metrics.timer("run_spool"):
            with open(run_path, "wb") as f:
                if span is not None:
                    piece = memoryview(batch.data[span[0]:span[1]])
                    f.write(piece)
                    crc = zlib.crc32(piece)
                    f.write(EOF_MARKER)
                    crc = zlib.crc32(EOF_MARKER, crc)
                else:
                    for piece in iter_framed_chunks(sub, write_eof=True):
                        f.write(piece)
                        crc = zlib.crc32(piece, crc)
                if self.fixed:
                    f.flush()
                    os.fsync(f.fileno())
            wrote = os.path.getsize(run_path)
            if wrote != total + len(EOF_MARKER):
                raise StorageError(
                    f"run {seg_index}: framed {wrote} bytes, offsets "
                    f"predict {total + len(EOF_MARKER)}")
            with open(off_path, "wb") as f:
                ends.astype("<i8").tofile(f)
                f.flush()
                if self.fixed:
                    # the sidecar is durable before a manifest can name
                    # this run
                    os.fsync(f.fileno())
        with self._lock:
            self.counts[seg_index] = sub.num_records
            self.bytes[seg_index] = total
            self.crcs[seg_index] = crc & 0xFFFFFFFF
        metrics.add("spool.bytes", total)

    def adopt(self, seg_index: int, records: int, nbytes: int,
              crc: int) -> None:
        """Register a run already on disk (a resumed task: written, and
        checked against the manifest, by an earlier attempt). Accounting
        only; no byte moves."""
        with self._lock:
            if seg_index in self.counts:
                raise MergeError(f"segment {seg_index} staged twice")
            self.counts[seg_index] = int(records)
            self.bytes[seg_index] = int(nbytes)
            self.crcs[seg_index] = int(crc) & 0xFFFFFFFF

    def discard(self, seg_index: int) -> None:
        """Unlink an unregistered run's files (an adoption that failed
        revalidation: the segment is fetched again and write_run rewrites
        the path)."""
        for p in self._paths(seg_index):
            try:
                os.unlink(p)
            except OSError:
                pass

    def manifest(self) -> dict[int, tuple[int, int, int]]:
        """The finished runs for the checkpoint writer: {seg_index:
        (records, framed_bytes, crc)}; runs still being spooled (count
        -1) are left for a later snapshot."""
        with self._lock:
            return {s: (n, self.bytes[s], self.crcs[s])
                    for s, n in self.counts.items() if n >= 0}

    def cleanup(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            segs = list(self.counts)
        if self.fixed:
            # the checkpoint's directory: the runs are the next attempt's
            # resume state; TaskCheckpoint.discard removes them once the
            # merge output is delivered
            return
        for seg in segs:
            for p in self._paths(seg):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        for d in self.dirs:
            try:
                os.rmdir(d)
            except OSError:
                pass


# open-cursor cap for the interleave: 2 fds per open cursor, kept well
# under common ulimits however many segments the shuffle has (evicted
# cursors reopen + seek; reads stay strictly sequential either way)
MAX_OPEN_CURSORS = 256


class _RunCursor:
    """Sequential reader over one run: hands out the byte span covering
    the next ``count`` records. Suspendable: ``suspend()`` closes both
    file handles and a later read transparently reopens at the consumed
    position, so an interleave over thousands of runs stays within the
    process fd limit."""

    __slots__ = ("run_path", "off_path", "run_f", "off_f",
                 "consumed_bytes", "consumed_records")

    def __init__(self, run_path: str, off_path: str):
        self.run_path = run_path
        self.off_path = off_path
        self.run_f = None
        self.off_f = None
        self.consumed_bytes = 0
        self.consumed_records = 0

    def _ensure_open(self) -> None:
        if self.run_f is None:
            self.run_f = open(self.run_path, "rb")
            self.off_f = open(self.off_path, "rb")
            self.run_f.seek(self.consumed_bytes)
            self.off_f.seek(self.consumed_records * 8)

    def next_span(self, count: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (span_bytes, record_lengths) for the next ``count``
        records."""
        self._ensure_open()
        ends = np.fromfile(self.off_f, dtype="<i8", count=count)
        if ends.shape[0] != count:
            raise StorageError("run offset sidecar truncated")
        lens = np.diff(ends, prepend=np.int64(self.consumed_bytes))
        span = np.fromfile(self.run_f, dtype=np.uint8,
                           count=int(ends[-1]) - self.consumed_bytes)
        if span.shape[0] != int(ends[-1]) - self.consumed_bytes:
            raise StorageError("run file truncated")
        self.consumed_bytes = int(ends[-1])
        self.consumed_records += count
        return span, lens

    def suspend(self) -> None:
        if self.run_f is not None:
            self.run_f.close()
            self.off_f.close()
            self.run_f = self.off_f = None

    def close(self) -> None:
        self.suspend()


def iter_row_slabs(rows, valid: int,
                   slab: int = SLAB_RECORDS) -> Iterator[np.ndarray]:
    """Yield the first ``valid`` merged rows in bounded host slabs of
    ``np.uint32``. ``rows`` is a numpy array or a uint32 tensor, possibly
    on the card (or a column slice of one): each slab is read back on its
    own, through the int32 view."""
    for start in range(0, valid, slab):
        stop = min(start + slab, valid)
        if isinstance(rows, torch.Tensor):
            yield i32(rows[start:stop]).cpu().numpy().view(np.uint32)
        else:
            yield np.asarray(rows[start:stop])


def interleave_runs(slabs: Iterator[np.ndarray], store: RunStore,
                    seg_col: int) -> Iterator[bytes]:
    """Permutation-driven k-way interleave of the sorted runs.

    ``slabs`` yields merged rows whose column ``seg_col`` is the segment
    index (the reference names the key width instead: its column is
    ``num_key_words + 1`` of the whole row). Each slab becomes one framed
    output piece; runs are read strictly sequentially. The concatenation
    of the yielded pieces is the complete merged IFile stream, EOF marker
    included.
    """
    cursors: dict[int, _RunCursor] = {}
    open_lru: dict[int, None] = {}  # insertion-ordered set of open segs

    def _touch(s: int) -> None:
        open_lru.pop(s, None)
        open_lru[s] = None
        while len(open_lru) > MAX_OPEN_CURSORS:
            victim = next(iter(open_lru))
            del open_lru[victim]
            cursors[victim].suspend()

    try:
        for rows in slabs:
            if rows.shape[0] == 0:
                continue
            seg = rows[:, seg_col].astype(np.int64)
            unique, ranks, counts = _group_ranks(seg)
            spans: dict[int, np.ndarray] = {}
            starts: dict[int, np.ndarray] = {}
            lens: dict[int, np.ndarray] = {}
            for s, c in zip(unique.tolist(), counts.tolist()):
                cur = cursors.get(s)
                if cur is None:
                    if s not in store.counts:
                        raise MergeError(
                            f"merged rows reference unstaged segment {s}")
                    cur = cursors[s] = _RunCursor(*store._paths(s))
                span, ln = cur.next_span(c)
                _touch(s)
                spans[s] = span
                lens[s] = ln
                starts[s] = np.cumsum(ln) - ln
            # per-record framed length and source offset in its span
            rec_len = np.empty(seg.shape[0], np.int64)
            src_off = np.empty(seg.shape[0], np.int64)
            for s in unique.tolist():
                m = seg == s
                rec_len[m] = lens[s][ranks[m]]
                src_off[m] = starts[s][ranks[m]]
            out = np.empty(int(rec_len.sum()), np.uint8)
            dst_end = np.cumsum(rec_len)
            dst_start = dst_end - rec_len
            for s in unique.tolist():
                m = seg == s
                _gather_spans(spans[s], src_off[m], rec_len[m],
                              out, dst_start[m])
            yield out.tobytes()
    finally:
        for cur in cursors.values():
            cur.close()
    # verify every run was fully consumed (lost-records guard)
    for s, n in store.counts.items():
        cur_records = cursors[s].consumed_records if s in cursors else 0
        if cur_records != n:
            raise MergeError(
                f"run {s}: merged rows consumed {cur_records} of {n} records")
    yield EOF_MARKER


def slab_batch(batches: Sequence[RecordBatch], seg: np.ndarray,
               row: np.ndarray) -> RecordBatch:
    """Gather one output slab's records from per-segment batches into a
    compact RecordBatch (its own small data buffer): the in-memory
    emission path's bounded gather, replacing whole-shuffle concat.

    Each value follows its key in the slab's buffer (the reference puts
    every key before every value; the records are the same), so the
    framer takes one slice a record, and where a segment's values follow
    their keys, as in every cracked segment, key and value move as one
    span."""
    m = seg.shape[0]
    groups = [(s, seg == s) for s in np.unique(seg).tolist()]
    k_len = np.empty(m, np.int64)
    v_len = np.empty(m, np.int64)
    for s, msk in groups:
        b = batches[s]
        r = row[msk]
        k_len[msk] = b.key_len[r]
        v_len[msk] = b.val_len[r]
    rec_len = k_len + v_len
    k_off = np.cumsum(rec_len) - rec_len
    v_off = k_off + k_len
    buf = np.empty(int(rec_len.sum()), np.uint8)
    for s, msk in groups:
        b = batches[s]
        r = row[msk]
        src_k = b.key_off[r]
        src_v = b.val_off[r]
        if np.array_equal(src_v, src_k + k_len[msk]):
            _gather_spans(b.data, src_k, rec_len[msk], buf, k_off[msk])
        else:
            _gather_spans(b.data, src_k, k_len[msk], buf, k_off[msk])
            _gather_spans(b.data, src_v, v_len[msk], buf, v_off[msk])
    return RecordBatch(buf, k_off, k_len, v_off, v_len)
