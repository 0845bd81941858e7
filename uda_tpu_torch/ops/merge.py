"""Record-level merge APIs + host fallback.

Counterpart of ``uda_tpu/ops/merge.py``. ``merge_batches`` is the
framework's equivalent of the reference's network-levitated merge core
(MergeManager's PQ over Segments, reference src/Merger/MergeManager.cc:
155-182 + MergeQueue.h:276-427): take k sorted segments, produce the
globally sorted record stream. The comparator work happens on the device
(``uda_tpu_torch.ops.sort``); the host packs columns and gathers bytes.

``merge_batches_host`` is the pure-host oracle the device paths are held
against.

``merge_batches_two_phase`` merges without re-sorting the concatenation:
each run is partially sorted on its own (usually just the monotonicity
check: Hadoop map outputs arrive comparator-sorted) and the runs then fold
through a pairwise merge tree on the device, so every record moves through
at most log2(k) merges. Its run merge engine ``"pallas"`` is K1
(``uda_tpu_torch/ops/pallas_merge.merge_sorted_pair``; the name is the
reference's, so callers pass the same strings), ``"host"`` a numpy merge.

Every entry point takes ``device`` (``None`` = the card, ``"cpu"`` on
request); the host-side parts stay numpy, as in the reference.
"""

from __future__ import annotations

import contextlib
import functools
import heapq
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.ops import packing, sort
from uda_tpu_torch.ops.pallas_merge import merge_sorted_pair
from uda_tpu_torch.ops.sort import fill_words, i32, u32
from uda_tpu_torch.utils.comparators import KeyType, uses_default_bytewise
from uda_tpu_torch.utils.errors import MergeError
from uda_tpu_torch.utils.ifile import RecordBatch
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["merge_batches", "merge_batches_host", "merge_iter_host",
           "merge_record_streams", "sorted_batch_order",
           "merge_batches_two_phase", "resolve_merge_mode",
           "resolve_run_engine", "lex_cols_sorted", "run_row_order",
           "fill_run_rows", "merge_row_pair", "merge_split_point",
           "next_run_capacity", "pad_rows_to", "RowBufferPool", "PAD_WORD",
           "MIN_RUN_CAPACITY", "ROW_EXTRA_COLS", "Run", "merge_run_pair",
           "carry_run", "merge_leftover_runs"]

# Padding word for device runs: all-0xFFFFFFFF rows sort strictly after
# every real row (a real row's length column is a content length < 2^31),
# so valid rows stay a prefix through any merge.
PAD_WORD = np.uint32(0xFFFFFFFF)

MIN_RUN_CAPACITY = 512  # smallest padded run (= default merge tile)

# composite-key columns appended after the key words:
# (content length, segment index, row index)
ROW_EXTRA_COLS = 3


def next_run_capacity(n: int) -> int:
    """Smallest power-of-two run capacity >= n (>= MIN_RUN_CAPACITY):
    bounds the set of device run shapes to O(log) per job."""
    p = MIN_RUN_CAPACITY
    while p < n:
        p *= 2
    return p


def resolve_run_engine(engine: str, device=None) -> str:
    """Resolve the pairwise run-merge backend: ``"pallas"`` (K1),
    ``"host"`` (numpy merge), or ``"auto"``: host on the CPU, K1 on the
    card, as the reference decides for its CPU and TPU backends."""
    if engine == "auto":
        return "host" if resolve_device(device).type == "cpu" else "pallas"
    if engine not in ("host", "pallas"):
        raise MergeError(f"unknown run merge engine {engine!r}")
    return engine


def merge_split_point(a_rows: np.ndarray, b_rows: np.ndarray,
                      m: int) -> int:
    """Merge-path partition with the ties-to-``a`` rule: the unique
    ``ia`` (with ``ib = m - ia``) such that the first ``m`` rows of the
    stable merge are exactly ``merge(a[:ia], b[:ib])`` — ``a[ia-1] <=
    b[ib]`` and ``b[ib-1] < a[ia]``. O(log n) full-row lexicographic
    compares."""
    na, nb = int(a_rows.shape[0]), int(b_rows.shape[0])
    lo, hi = max(0, m - nb), min(na, m)
    while lo < hi:
        ia = (lo + hi) // 2
        ib = m - ia
        # a[ia] <= b[ib-1]: that a row ties-or-precedes the b prefix
        # row, so it belongs in the prefix too -> ia is too small
        if ia < na and ib > 0 and tuple(a_rows[ia]) <= tuple(b_rows[ib - 1]):
            lo = ia + 1
        else:
            hi = ia
    return lo


class RowBufferPool:
    """Reusable pre-allocated host uint32 row buffers.

    Stage workers lease the row matrix of each run bound for the K1 fold;
    the merge consumer releases it once the run's copy to the device is
    done. On the card the buffers are pinned (page-locked) host memory, so
    that copy runs asynchronously on the merger's copy stream (a copy from
    pageable memory would wait for the host); on the CPU they are plain
    numpy. Pinned memory is slow to allocate, which is why the pool
    exists. Buffers are flat arrays reshaped per lease, so one big early
    buffer serves every later request that fits; the free list is bounded
    so a pathological size spread cannot hoard host memory. ``leased``
    counts the leases not yet released."""

    MAX_FREE = 8

    def __init__(self, device=None):
        self.pinned = resolve_device(device).type == "cuda"
        self._lock = threading.Lock()
        self._free: list[np.ndarray] = []
        self.leased = 0

    def _alloc(self, need: int) -> np.ndarray:
        if self.pinned:
            return torch.empty(need, dtype=torch.int32,
                               pin_memory=True).numpy().view(np.uint32)
        return np.empty(need, np.uint32)

    def lease(self, rows: int, cols: int) -> np.ndarray:
        need = rows * cols
        got = None
        with self._lock:
            for i, buf in enumerate(self._free):
                if buf.size >= need:
                    got = self._free.pop(i)
                    metrics.add("stage.buffer.reuses")
                    break
        if got is None:
            got = self._alloc(need)
        with self._lock:
            self.leased += 1
        return got[:need].reshape(rows, cols)

    def release(self, view: Optional[np.ndarray]) -> None:
        if view is None:
            return
        # walk the view back to the array that holds the whole buffer (a
        # pinned buffer's chain ends at the numpy view of its tensor)
        base = view
        while isinstance(base.base, np.ndarray):
            base = base.base
        flat = base.view(np.uint32).reshape(-1)
        with self._lock:
            self.leased -= 1
            self._free.append(flat)
            self._free.sort(key=lambda b: b.size)
            del self._free[self.MAX_FREE:]


def lex_cols_sorted(cols: Sequence[np.ndarray]) -> bool:
    """Vectorized lexicographic monotonicity over parallel uint columns:
    True when every adjacent pair is non-decreasing under first-column
    priority (O(n·k) — the already-sorted fast path that replaces an
    O(n log n) lexsort for Hadoop's map-side-sorted segments)."""
    n = cols[0].shape[0]
    if n < 2:
        return True
    lt = cols[0][:-1] < cols[0][1:]
    eq = cols[0][:-1] == cols[0][1:]
    for c in cols[1:]:
        lt = lt | (eq & (c[:-1] < c[1:]))
        eq = eq & (c[:-1] == c[1:])
    return bool(np.all(lt | eq))


def run_row_order(packed: packing.PackedKeys) -> Optional[np.ndarray]:
    """Per-run sort order under (words, len) — which equals comparator
    order for within-width keys. Returns None when the run is already
    sorted (identity order; the map-side sort contract the reference's
    merge leaned on, MergeManager.cc:47-63), else the int64 lexsort
    permutation. Stable: equal keys keep arrival order."""
    kw = packed.key_words.shape[1]
    cols = [packed.key_words[:, c] for c in range(kw)] \
        + [packed.key_lens.astype(np.uint32)]
    if lex_cols_sorted(cols):
        return None
    # np.lexsort: LAST key is primary -> reversed column priority
    return np.lexsort(tuple(reversed(cols))).astype(np.int64)


def fill_run_rows(rows: np.ndarray, packed: packing.PackedKeys,
                  order: Optional[np.ndarray], seg_index: int) -> None:
    """Fill a (cap >= n, kw+3) uint32 row matrix with the sorted
    composite-key rows (words..., content length, segment index,
    ORIGINAL row index) and PAD_WORD tail. ``order=None`` = identity."""
    n = packed.num_records
    kw = packed.key_words.shape[1]
    if order is None:
        rows[:n, :kw] = packed.key_words
        rows[:n, kw] = packed.key_lens.astype(np.uint32)
        rows[:n, kw + 2] = np.arange(n, dtype=np.uint32)
    else:
        rows[:n, :kw] = packed.key_words[order]
        rows[:n, kw] = packed.key_lens[order].astype(np.uint32)
        rows[:n, kw + 2] = order.astype(np.uint32)
    rows[:n, kw + 1] = np.uint32(seg_index)
    if rows.shape[0] > n:
        rows[n:] = PAD_WORD


def merge_row_pair(a_rows, b_rows, a_valid: int, b_valid: int,
                   engine: str):
    """Merge two sorted composite-key row runs into one. Host engine
    (numpy rows): a stable lexsort of the two valid prefixes. Pallas
    engine (uint32 tensors with their pad rows): K1 over every column —
    the columns (words, len, seg, row) are a total order, so K1's
    internal tie-break never decides between real rows."""
    if engine == "host":
        rows = np.concatenate([a_rows[:a_valid], b_rows[:b_valid]])
        order = np.lexsort(tuple(rows[:, c]
                                 for c in range(rows.shape[1] - 1, -1, -1)))
        return rows[order]
    return merge_sorted_pair(a_rows, b_rows, num_keys=int(a_rows.shape[1]))


def sorted_batch_order(batch: RecordBatch, kt: KeyType, width: int,
                       device=None) -> np.ndarray:
    """Device-computed stable sort permutation for one batch."""
    with metrics.timer("pack"):
        packed = packing.pack_keys(batch, kt, width)
    with metrics.timer("device_sort"):
        return sort.sort_permutation(packed, device)


def merge_batches(batches: Sequence[RecordBatch], kt: KeyType,
                  width: int, device=None) -> RecordBatch:
    """Merge k sorted (or unsorted — the sort is total) segments on the
    device: one stable sort of the concatenation. Overflow ranks are
    computed across the concatenation so they are globally consistent."""
    cat = RecordBatch.concat(list(batches))
    order = sorted_batch_order(cat, kt, width, device)
    return cat.take(order)


def merge_batches_host(batches: Sequence[RecordBatch], kt: KeyType) -> RecordBatch:
    """Host oracle: stable sort of the concatenation by comparator order.
    Equal keys keep (segment, record) arrival order."""
    cat = RecordBatch.concat(list(batches))
    idx = list(range(cat.num_records))
    keys = [cat.key(i) for i in idx]
    cmp = kt.compare
    order = sorted(idx, key=functools.cmp_to_key(
        lambda i, j: cmp(keys[i], keys[j])))
    return cat.take(np.asarray(order, dtype=np.int64))


def merge_record_streams(streams: Sequence[Iterator[Tuple[bytes, bytes]]],
                         kt: KeyType) -> Iterator[Tuple[bytes, bytes]]:
    """Streaming k-way heap merge over record iterators — the literal
    analogue of the reference's MergeQueue::next (MergeQueue.h:276-427).
    Memory held = one record per stream; equal keys keep stream order.

    For the stock bytewise comparators (``uses_default_bytewise``) the
    comparator order is Python's bytes order over ``kt.content``, so the
    merge runs as ``heapq.merge`` keyed by the content (stable by stream
    position too): the same order, with the comparisons in C."""
    if uses_default_bytewise(kt):
        content = kt.content
        return heapq.merge(*streams, key=lambda kv: content(kv[0]))
    return _merge_record_streams_cmp(streams, kt)


def _merge_record_streams_cmp(streams: Sequence[Iterator[Tuple[bytes, bytes]]],
                              kt: KeyType) -> Iterator[Tuple[bytes, bytes]]:
    """merge_record_streams by ``kt.compare``, for any comparator."""
    cmp = kt.compare

    class _Cursor:
        __slots__ = ("it", "seq", "head")

        def __init__(self, it: Iterator[Tuple[bytes, bytes]], seq: int):
            self.it = it
            self.seq = seq
            self.head: Optional[Tuple[bytes, bytes]] = next(it, None)

        def advance(self) -> None:
            self.head = next(self.it, None)

        def __lt__(self, other: "_Cursor") -> bool:
            c = cmp(self.head[0], other.head[0])
            if c != 0:
                return c < 0
            return self.seq < other.seq  # stable by segment order

    heap = [c for c in (_Cursor(iter(s), i) for i, s in enumerate(streams))
            if c.head is not None]
    heapq.heapify(heap)
    while heap:
        cur = heap[0]
        yield cur.head
        cur.advance()
        if cur.head is not None:
            heapq.heapreplace(heap, cur)
        else:
            heapq.heappop(heap)


def merge_iter_host(batches: Sequence[RecordBatch],
                    kt: KeyType) -> Iterator[Tuple[bytes, bytes]]:
    """merge_record_streams over in-memory batches."""
    return merge_record_streams([b.iter_records() for b in batches], kt)


# -- two-phase device merge -------------------------------------------------

def resolve_merge_mode(mode: str, num_batches: int, device=None) -> str:
    """Routing between the whole-shuffle re-sort ("resort") and the
    two-phase partial sort + device merge tree ("two_phase"). "auto" takes
    two-phase on the card and the re-sort on the CPU, as the reference
    decides for its TPU and CPU backends."""
    if mode not in ("auto", "on", "off"):
        raise MergeError(f"unknown merge two-phase mode {mode!r}")
    if num_batches < 2:
        return "resort"
    if mode == "on":
        return "two_phase"
    if mode == "off":
        return "resort"
    return "two_phase" if resolve_device(device).type == "cuda" \
        else "resort"


def _upload(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    return u32(torch.from_numpy(rows.view(np.int32)).to(device))


@contextlib.contextmanager
def _device_time(device: torch.device, name: str):
    """On the card, add the enclosed work's device time (ms, CUDA events)
    to counter ``name`` and wait for it, so the enclosing phase timer
    holds the device work it launched; nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    end.synchronize()
    metrics.add(name, start.elapsed_time(end))


def merge_batches_two_phase(batches: Sequence[RecordBatch], kt: KeyType,
                            width: int, engine: str = "auto",
                            device=None) -> RecordBatch:
    """Two-phase merge of k segments: per-run partial sort (usually just
    the monotonicity check) + pairwise merge tree, instead of re-sorting
    the concatenation.

    Byte-identical to :func:`merge_batches` by construction: the rows
    carry (words, len, segment, row) as a total composite key, so equal
    comparator keys order by original (segment, row) arrival — exactly
    the stable-sort contract. Overflow keys (content wider than the
    carried width) need a globally consistent rank column, which only the
    concatenation view can provide — those fall back to
    :func:`merge_batches`.

    Phases, each under its own ``metrics`` timer: ``merge.rows`` (pack,
    row build and, for K1, upload of each run), ``merge.fold`` (the merge
    tree, waited for on the card, whose device time by CUDA events goes
    to ``merge.fold.device_ms``) and ``merge.gather`` (read back the
    (segment, row) columns and gather the records on the host)."""
    dev = resolve_device(device)
    if sum(b.num_records for b in batches) == 0 or len(batches) < 2:
        return merge_batches(batches, kt, width, dev)
    engine = resolve_run_engine(engine, dev)
    runs: list[tuple] = []  # (rows, valid) per non-empty segment
    kw = width // 4
    with metrics.timer("merge.rows"):
        for seg_index, b in enumerate(batches):
            n = b.num_records
            if n == 0:
                continue
            packed = packing.pack_keys(b, kt, width)
            if int(np.max(packed.key_lens, initial=0)) > width:
                return merge_batches(batches, kt, width, dev)  # overflow
            cap = next_run_capacity(n) if engine == "pallas" else n
            rows = np.empty((cap, kw + ROW_EXTRA_COLS), np.uint32)
            fill_run_rows(rows, packed, run_row_order(packed), seg_index)
            if engine == "pallas":
                rows = _upload(rows, dev)
            runs.append((rows, n))
    metrics.add("merge.pipeline.two_phase")
    with metrics.timer("merge.fold"), \
            _device_time(dev, "merge.fold.device_ms"):
        rows, valid = _fold_runs(runs, engine)
    with metrics.timer("merge.gather"):
        src = rows[:valid, kw + 1:kw + 3]
        if engine == "pallas":
            src = i32(src).cpu().numpy().view(np.uint32)
        seg_col = src[:, 0].astype(np.int64)
        row_col = src[:, 1].astype(np.int64)
        sizes = np.asarray([b.num_records for b in batches], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        cat = RecordBatch.concat(list(batches))
        return cat.take(offsets[seg_col] + row_col)


def pad_rows_to(rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """Pad a device run up to ``capacity`` rows with PAD_WORD rows.
    Padding rows sort strictly last, so the validity prefix is preserved;
    capacities stay powers of two."""
    cur = int(rows.shape[0])
    if cur >= capacity:
        return rows
    pad = fill_words((capacity - cur, int(rows.shape[1])), rows.device,
                     int(PAD_WORD))
    return u32(torch.cat([i32(rows), i32(pad)]))


class Run:
    """One sorted run of a binary-counter forest: the overlapped merger's
    and the two-phase fold's.

    Rows are uint32[cap, C] with C = key words + 3: the composite key
    (words..., content length, segment index, row index). K1 runs are
    tensors padded to a power-of-two capacity with all-0xFFFFFFFF rows,
    which sort after every real row, so valid rows stay a prefix through
    any merge; host runs are exact-sized numpy. ``bucket`` is the
    binary-counter size class: next_run_capacity(valid) at first, doubled
    by each merge."""

    __slots__ = ("rows", "valid", "bucket")

    def __init__(self, rows, valid: int, bucket: int):
        self.rows = rows
        self.valid = valid
        self.bucket = bucket

    @property
    def capacity(self) -> int:
        return int(self.rows.shape[0])


def merge_run_pair(a: Run, b: Run, engine: str) -> Run:
    """Merge two forest runs (``a``'s rows first on equal keys) into one
    of twice the larger size class."""
    return Run(merge_row_pair(a.rows, b.rows, a.valid, b.valid, engine),
               a.valid + b.valid, 2 * max(a.bucket, b.bucket))


def carry_run(forest: dict, run: Run, merge: Callable) -> None:
    """Binary-counter insert into ``forest`` (size class -> run): while
    the forest holds a run of ``run``'s class, ``merge(that, run)``
    replaces both; then the result takes its class."""
    while run.bucket in forest:
        run = merge(forest.pop(run.bucket), run)
    forest[run.bucket] = run


def merge_leftover_runs(runs: Sequence[Run], engine: str,
                        merge: Callable) -> Optional[Run]:
    """Merge a forest's leftover runs, smallest size class first; K1 runs
    pad the smaller operand up to the larger capacity first
    (:func:`pad_rows_to`). None when there is no run."""
    if not runs:
        return None
    acc = runs[0]
    for nxt in runs[1:]:
        if engine == "pallas" and acc.capacity < nxt.capacity:
            acc = Run(pad_rows_to(acc.rows, nxt.capacity), acc.valid,
                      acc.bucket)
        acc = merge(acc, nxt)
    return acc


def _fold_runs(runs: list, engine: str):
    """Binary-counter fold of sorted (rows, valid) runs: equal size
    classes merge at once (:func:`carry_run`), the leftovers smallest
    first (:func:`merge_leftover_runs`). The reference's fold,
    ``uda_tpu/ops/merge.py:_fold_runs``."""
    merge = functools.partial(merge_run_pair, engine=engine)
    forest: dict[int, Run] = {}
    for rows, valid in runs:
        carry_run(forest, Run(rows, valid, next_run_capacity(valid)), merge)
    acc = merge_leftover_runs([forest[c] for c in sorted(forest)], engine,
                              merge)
    return (None, 0) if acc is None else (acc.rows, acc.valid)
