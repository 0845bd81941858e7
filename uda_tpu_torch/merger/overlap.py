"""Overlapped fetch/merge: the merge runs while fetches stream in.

The port's copy of ``uda_tpu/merger/overlap.py``. The reference's whole
reason to exist is that the merge runs WHILE fetches stream in (reference
src/Merger/MergeManager.cc:47-182: arriving MOFs join the k-way heap), so
by the time the last map output lands, most of the comparison work is
done. Its device-native shape is a **log-structured run forest**:

- as each segment's fetch completes it is packed (host, vectorized) and
  staged to the device as a sorted run, while later fetches are still in
  flight;
- runs merge pairwise on the device with K1 (``ops/merge.merge_row_pair``
  -> ``ops/pallas_merge.merge_sorted_pair``) under a binary-counter
  policy: each run is padded to a power-of-two capacity and two runs of
  equal capacity merge at once into one of twice the capacity, so every
  record moves through at most log2(k) merges;
- ``finish()`` merges the O(log k) leftover runs, largest capacity last,
  and gathers the records by the merged (segment, row) columns.

**Staging pipeline** (``pipeline=True``, the default through
``uda.tpu.stage.pipeline``): a bounded pool of stage workers materializes,
packs and (in streaming mode) spools DIFFERENT segments concurrently,
while ONE merge consumer drains the staged-run queue. On the card the
consumer copies each run from a pinned host lease to the device on its
own copy stream and merges on its own merge stream, so the copy of the
next run overlaps the merges of the previous one; it blocks only until
THAT copy is done before the lease goes back to the pool
(``merge.pipeline.put_ms``). In-flight bytes are budgeted
(``uda.tpu.stage.inflight.mb``): ``feed()`` blocks while fed-but-unmerged
bytes would exceed the cap (``stage.backpressure_events``), the credit
flow of the reference (MergeManager.cc:47-63). The serial path
(``pipeline=False``) stages and merges on ``stagers`` threads and is kept
as the twin the byte-identity tests diff against.

``merge.wait_ms`` measures how long the merge waited for each run to
become mergeable: feed()-to-staged latency (queue wait + materialize +
pack + spool).

Stability: the rows carry (key words, content length, segment index, row
index) as the composite sort key, so equal comparator keys order by
original (segment, row), independent of fetch COMPLETION order. Pipelined
and serial staging are byte-identical for the same reason.

Overflow fallback: keys whose content exceeds the carried width compare
by an overflow *rank*, only meaningful across ALL records, so the forest
detects oversize keys at staging and ``finish()`` falls back to the
global re-sort (``ops/merge.merge_batches``), as the reference does.

No quiet fallback: a failure of the device half (a K1 launch, the
kernels' build, a CUDA error) is latched and raised by ``finish()`` as
:class:`MergeError`, never answered by another engine or device.

Left out of the reference because they change no output byte: the
resource ledger's lease and gauge accounting, the flight recorder's
``overlap.abort`` record, span adoption and the ``merge.wait`` spans,
lockdep-tracked locks (``threading`` stands in), the native row merge
and its split merge (the host engine keeps ``merge_row_pair``'s lexsort,
as the reference does without its library).

Checkpointing (``merger/checkpoint.py``) adds two hooks: ``on_spool`` fires
with the segment index once its run file is on disk (the snapshot
trigger), outside every merger lock; ``adopt_run`` puts a run file a
previous attempt spooled into the forest before any feed, through the
same row build and ``_consume_run`` (so onto K1 on the card).
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.merger import streaming as stream_mod
from uda_tpu_torch.merger.emitter import frame_batch
from uda_tpu_torch.ops import merge as merge_ops
from uda_tpu_torch.ops import packing
from uda_tpu_torch.ops.merge import Run
from uda_tpu_torch.ops.sort import u32
from uda_tpu_torch.utils.comparators import KeyType, uses_default_bytewise
from uda_tpu_torch.utils.errors import MergeError, UdaError
from uda_tpu_torch.utils.ifile import (EOF_MARKER, RecordBatch,
                                       iter_file_records)
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["OverlappedMerger"]

log = get_logger()

_next_pow2 = merge_ops.next_run_capacity

# widest per-key content the vectorized overflow lexsort materializes
# as an n-by-width matrix; rarer/wider keys keep the comparator loop
_LEXSORT_MAX_KEY = 4096


class _StagedRun:
    """A stage worker's output awaiting the merge consumer: sorted host
    rows (a pool lease for K1 runs), fed timestamp (the merge.wait_ms
    anchor) and the in-flight byte charge it releases once merged."""

    __slots__ = ("rows", "valid", "lease", "fed_t", "charge")

    def __init__(self, rows, valid: int, lease, fed_t: float, charge: int):
        self.rows = rows
        self.valid = valid
        self.lease = lease
        self.fed_t = fed_t
        self.charge = charge


class OverlappedMerger:
    """Consumes completed segments during the fetch phase; produces the
    final order over the concatenated batches.

    ``engine`` selects the pairwise merge backend: "pallas" (K1; its
    plain version for a CPU ``device``), "host" (a numpy lexsort merge),
    or "auto" (host on the CPU, K1 on the card). ``device`` (``None`` =
    the card) is where K1 runs; without a card pass ``device="cpu"``.

    ``pipeline`` selects the staging architecture: False = the serial
    stage-then-merge loop on ``stagers`` threads; True = the bounded
    stage pool + single merge consumer (see module docstring).
    ``inflight_bytes`` > 0 bounds the fed-but-unmerged bytes in either
    mode. ``run_store`` (a :class:`~uda_tpu_torch.merger.streaming.
    RunStore`) turns on streaming mode: every segment spools to a sorted
    run file and releases its bytes; ``device_runs=False`` then keeps the
    runs off the device altogether.
    """

    def __init__(self, key_type: KeyType, width: int, engine: str = "auto",
                 run_store=None, max_pending: int = 0, stagers: int = 0,
                 device_runs: bool = True, pipeline: bool = False,
                 inflight_bytes: int = 0, device=None, on_spool=None):
        self.key_type = key_type
        self.width = width
        # the run-spool boundary hook (the checkpoint trigger); it never
        # raises (TaskCheckpoint.maybe_save absorbs its failures)
        self._on_spool = on_spool
        self.device_runs = bool(device_runs)
        if not self.device_runs and run_store is None:
            raise MergeError("device_runs=False requires streaming mode "
                             "(a run store)")
        self.device = resolve_device(device)
        self.engine = merge_ops.resolve_run_engine(engine, self.device)
        self.run_store = run_store
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        # one-way bool latches (a GIL-atomic store; readers may lag one
        # item, by design)
        self._aborted = False
        self._overflow = False
        self._forest: dict[int, Run] = {}   # size class -> run
        self._forest_lock = threading.Lock()
        self._state_lock = threading.Lock()  # counters
        # first-error latch: a lagging racer overwrites with its own
        # exception, either surfaces at finish()
        self._error: Optional[Exception] = None
        self._merges = 0
        self._staged = 0
        # in-flight bytes budget: feed() charges, the merge consumer (or
        # the spool/drop path) releases; 0 = unbounded
        self._inflight_cap = max(0, int(inflight_bytes))
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        # K1 runs are built in pool leases (pinned on the card) and copied
        # to the device, where the merger has its own copy and merge
        # streams: PyTorch's current stream would queue each copy behind
        # the merges already launched
        self._buf_pool = (merge_ops.RowBufferPool(self.device)
                          if self.engine == "pallas" else None)
        self._copy_stream = self._merge_stream = None
        if self.engine == "pallas" and self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._merge_stream = torch.cuda.Stream(self.device)
        self.pipeline = bool(pipeline)
        self._consumer_thread: Optional[threading.Thread] = None
        if self.pipeline:
            width_auto = max(2, min(4, os.cpu_count() or 2))
            nworkers = stagers if stagers > 0 else width_auto
            # the staged-run queue is bounded: a slow consumer
            # backpressures the workers (and, through the in-flight
            # budget, the transports feeding feed())
            self._staged_q: Optional[queue.Queue] = queue.Queue(
                maxsize=nworkers + 2)
            self._workers = [
                threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"uda-stage-w{i}")
                for i in range(nworkers)]
            self._consumer_thread = threading.Thread(
                target=self._consumer_loop, daemon=True,
                name="uda-overlap-merge")
            self._threads = self._workers + [self._consumer_thread]
        else:
            # serial staging: pack+sort+spool of DIFFERENT segments
            # parallelize over ``stagers`` threads; forest carries
            # serialize under _forest_lock
            self._staged_q = None
            self._workers = [
                threading.Thread(target=self._loop, daemon=True,
                                 name=f"uda-overlap-merge-{i}")
                for i in range(max(1, stagers))]
            self._threads = list(self._workers)
        for t in self._threads:
            t.start()

    # -- producer side (fetch completion callbacks, any thread) -------------

    def feed(self, seg_index: int, source) -> None:
        """Stage one completed segment's records (safe to call from a
        transport completion thread). ``source`` is a RecordBatch or an
        object with a ``record_batch()`` method (a Segment), materialized
        on a stage thread. BLOCKS while staging lags, on the bounded queue
        (streaming mode) and on the in-flight bytes budget: the intended
        backpressure on the transport thread."""
        charge = self._charge(source)
        if charge < 0:
            return  # aborted while waiting on the budget
        item = (seg_index, source, time.perf_counter(), charge)
        if self._q.maxsize <= 0:
            self._q.put(item)
        else:
            while True:
                if self._aborted:
                    self._release_charge(charge)
                    return
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
        if self._aborted:
            # the put may have raced abort(): _charge() saw the flag
            # unset, abort() then drained _q before our item landed, so
            # nothing would ever release its charge. Re-drain: an item is
            # consumed exactly once, by a live worker or here.
            self._reap_input_queue()

    @staticmethod
    def _source_bytes(source) -> int:
        """Byte size of a fed segment for the in-flight budget: a
        Segment's raw_length, a RecordBatch's buffer size."""
        raw = getattr(source, "raw_length", None)
        if raw:
            return int(raw)
        data = getattr(source, "data", None)
        if data is not None:
            return int(len(data))
        return 0

    def _charge(self, source) -> int:
        """Charge the segment against the in-flight budget, blocking
        (abort-responsive) while over it. Returns the charged bytes, or
        -1 when the merger aborted during the wait. A single oversized
        segment is admitted when nothing else is in flight: the budget
        bounds concurrency, it never wedges progress."""
        if self._inflight_cap <= 0:
            return 0
        charge = self._source_bytes(source)
        if charge <= 0:
            return 0
        blocked = False
        with self._inflight_cv:
            while (not self._aborted and self._inflight > 0
                   and self._inflight + charge > self._inflight_cap):
                if not blocked:
                    blocked = True
                    metrics.add("stage.backpressure_events")
                self._inflight_cv.wait(timeout=0.1)
            if self._aborted:
                return -1
            self._inflight += charge
        metrics.gauge_add("stage.inflight.bytes", charge)
        return charge

    def _release_charge(self, charge: int) -> None:
        if charge <= 0:
            return
        with self._inflight_cv:
            self._inflight -= charge
            self._inflight_cv.notify_all()
        metrics.gauge_add("stage.inflight.bytes", -charge)

    # -- serial merge threads (pipeline=False) -------------------------------

    def _loop(self) -> None:
        with self._on_device():
            while True:
                try:
                    item = self._q.get(timeout=0.25)
                except queue.Empty:
                    if self._aborted:
                        return  # abort() without a reachable poison pill
                    continue
                if item is None:
                    return
                seg_index, source, fed_t, charge = item
                if self._error is not None or self._aborted:
                    self._release_charge(charge)
                    continue  # drain; finish() will surface the error
                try:
                    self._stage(seg_index, source, fed_t)
                except Exception as e:  # surfaced at finish()
                    self._error = e
                finally:
                    self._release_charge(charge)

    def _stage(self, seg_index: int, source, fed_t: float) -> None:
        staged = self._prepare(seg_index, source, fed_t)
        if staged is None:
            return
        self._observe_wait(fed_t)
        try:
            self._consume_run(staged)
        finally:
            self._recycle(staged)

    # -- pipelined staging (pipeline=True) -----------------------------------

    def _worker_loop(self) -> None:
        """Stage worker: materialize + pack + row build + spool for ONE
        segment at a time; finished runs queue for the merge consumer."""
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._aborted:
                    return
                continue
            if item is None:
                return
            seg_index, source, fed_t, charge = item
            if self._error is not None or self._aborted:
                self._release_charge(charge)
                continue
            try:
                staged = self._prepare(seg_index, source, fed_t)
            except Exception as e:  # surfaced at finish()
                self._error = e
                self._release_charge(charge)
                continue
            if staged is None:
                self._release_charge(charge)
                continue
            staged.charge = charge
            self._put_staged(staged)

    def _put_staged(self, staged: _StagedRun) -> None:
        while not self._aborted:
            try:
                self._staged_q.put(staged, timeout=0.1)
                return
            except queue.Full:
                continue
        self._discard(staged)

    def _consumer_loop(self) -> None:
        """The merge loop as a consumer of staged runs: the copy of the
        next run overlaps the merges of the previous one (launches are
        asynchronous); the forest carry serializes here."""
        with self._on_device():
            while True:
                try:
                    staged = self._staged_q.get(timeout=0.25)
                except queue.Empty:
                    if self._aborted:
                        return
                    continue
                if staged is None:
                    return
                if self._error is not None or self._aborted:
                    self._discard(staged)
                    continue
                try:
                    self._observe_wait(staged.fed_t)
                    self._consume_run(staged)
                    metrics.add("merge.pipeline.runs")
                except Exception as e:  # surfaced at finish()
                    self._error = e
                    self._recycle(staged)
                finally:
                    self._release_charge(staged.charge)
                    staged.charge = 0

    def _discard(self, staged: _StagedRun) -> None:
        """Drop a staged run without merging (abort/error drain): release
        its budget charge and recycle its buffer lease."""
        self._release_charge(staged.charge)
        staged.charge = 0
        self._recycle(staged)

    def _recycle(self, staged: _StagedRun) -> None:
        if staged.lease is not None:
            self._buf_pool.release(staged.lease)
        staged.lease = None

    @staticmethod
    def _observe_wait(fed_t: float) -> None:
        metrics.observe("merge.wait_ms", (time.perf_counter() - fed_t) * 1e3)

    # -- staging ------------------------------------------------------------

    @staticmethod
    def _release(source) -> None:
        """Free a staged segment's fetched bytes (streaming mode only: the
        sorted run on disk is now the record source of truth)."""
        release = getattr(source, "release", None)
        if release is not None:
            release()

    def _prepare(self, seg_index: int, source,
                 fed_t: float) -> Optional[_StagedRun]:
        """The host half of staging: materialize, pack, per-run sort,
        spool. Returns the device-bound staged run, or None when nothing
        needs the forest (empty segment, spool-only modes, overflow)."""
        streaming = self.run_store is not None
        if self._overflow and not streaming:
            return None  # fast path already disabled; finish() re-sorts
        batch = (source if isinstance(source, RecordBatch)
                 else source.record_batch())
        n = batch.num_records
        if n == 0:
            if streaming:
                self._release(source)
            return None
        with metrics.timer("overlap_pack"):
            packed = packing.pack_keys(batch, self.key_type, self.width)
        metrics.add("stage.bytes",
                    int(batch.key_len.sum() + batch.val_len.sum()))
        if int(np.max(packed.key_lens, initial=0)) > self.width:
            # rank-bearing keys: cross-run rank consistency needs the
            # global view; disable the fast path (see module docstring)
            self._overflow = True
            if not streaming:
                return None
            # streaming keeps spooling, this run ordered by the FULL
            # comparator: finish falls back to the comparator-level
            # k-way merge over the run files
            order = self._overflow_order(batch, n)
            self.run_store.write_run(seg_index, batch, order)
            with self._state_lock:
                self._staged += 1
            metrics.add("merge.records", n)
            self._notify_spool(seg_index)
            self._observe_wait(fed_t)
            self._release(source)
            return None
        # map outputs arrive comparator-sorted (the map-side sort
        # contract), so the O(n·k) monotonicity check usually replaces
        # the lexsort (run_row_order)
        order = merge_ops.run_row_order(packed)
        if streaming:
            spool_order = (np.arange(n, dtype=np.int64) if order is None
                           else order)
            self.run_store.write_run(seg_index, batch, spool_order)
            self._release(source)
            self._notify_spool(seg_index)
        with self._state_lock:
            self._staged += 1
        metrics.add("merge.records", n)
        if self._overflow or not self.device_runs:
            self._observe_wait(fed_t)
            return None  # forest output won't be consumed; runs suffice
        return self._run_rows(packed, order, seg_index, fed_t)

    def _run_rows(self, packed, order: Optional[np.ndarray], seg_index: int,
                  fed_t: float) -> _StagedRun:
        """A run's composite-key rows, staged for the merge: exact-sized
        numpy for the host engine, a pool lease padded to a power-of-two
        capacity (a bounded set of shapes) for K1."""
        n = packed.num_records
        cols = packed.key_words.shape[1] + merge_ops.ROW_EXTRA_COLS
        if self._buf_pool is None:
            rows = np.empty((n, cols), np.uint32)
            merge_ops.fill_run_rows(rows, packed, order, seg_index)
            return _StagedRun(rows, n, None, fed_t, 0)
        with self._device_errors():
            lease = self._buf_pool.lease(_next_pow2(n), cols)
        try:
            merge_ops.fill_run_rows(lease, packed, order, seg_index)
        except BaseException:
            self._buf_pool.release(lease)
            raise
        return _StagedRun(lease, n, lease, fed_t, 0)

    def _notify_spool(self, seg_index: int) -> None:
        """Fire the run-spool boundary hook, outside every merger lock
        (the hook fsyncs)."""
        hook = self._on_spool
        if hook is not None:
            hook(seg_index)

    def adopt_run(self, seg_index: int, batch: RecordBatch) -> None:
        """Resume path: account a run file a previous attempt spooled; the
        re-cracked, already sorted batch joins the forest without being
        spooled again. Called before any feed(), so no stage thread races
        the forest. The run file is in sorted order, so the identity
        order (row index = file position) builds exactly the rows the
        original ``_prepare`` built: the output is byte-identical to an
        uninterrupted run's."""
        n = batch.num_records
        if n == 0:
            return
        with metrics.timer("overlap_pack"):
            packed = packing.pack_keys(batch, self.key_type, self.width)
        if int(np.max(packed.key_lens, initial=0)) > self.width:
            # oversize keys: as in _prepare, the fast path is off and
            # finish_streaming's k-way merge over the run files (this one
            # included) is the fallback
            self._overflow = True
        with self._state_lock:
            self._staged += 1
        metrics.add("merge.records", n)
        if self._overflow or not self.device_runs:
            return
        staged = self._run_rows(packed, None, seg_index, time.perf_counter())
        try:
            with self._on_device():
                self._consume_run(staged)
        finally:
            self._recycle(staged)

    def _overflow_order(self, batch: RecordBatch, n: int) -> np.ndarray:
        """Full-comparator sort order for an oversize-key run. Default
        bytewise comparators vectorize: memcmp-with-shorter-is-smaller
        order == lexsort over (zero-padded content bytes, content
        length). A custom ``compare`` override (or pathologically wide
        keys) keeps the comparator-faithful cmp_to_key path."""
        kt = self.key_type
        if uses_default_bytewise(kt):
            contents = [kt.content(batch.key(i)) for i in range(n)]
            lens = np.fromiter((len(c) for c in contents),
                               np.int64, count=n)
            width = int(lens.max(initial=0))
            if 0 < width <= _LEXSORT_MAX_KEY:
                mat = np.zeros((n, width), np.uint8)
                for i, c in enumerate(contents):
                    mat[i, :len(c)] = np.frombuffer(c, np.uint8)
                cols = [mat[:, j] for j in range(width)] + [lens]
                # np.lexsort is stable: ties keep arrival order, the
                # same (i - j) tiebreak the comparator path applies
                return np.lexsort(tuple(reversed(cols))).astype(np.int64)
        cmp = kt.compare
        keys = [batch.key(i) for i in range(n)]
        return np.asarray(sorted(range(n), key=functools.cmp_to_key(
            lambda i, j: cmp(keys[i], keys[j]) or (i - j))), np.int64)

    # -- the device half -----------------------------------------------------

    def _on_device(self):
        """The context that device work runs in: on the card, the merge
        stream (current stream and device are per thread, so every thread
        that launches K1 enters it)."""
        if self._merge_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._merge_stream)

    @contextlib.contextmanager
    def _device_errors(self) -> Iterator[None]:
        """Any failure of K1's half (a pinned lease, a copy, a launch or a
        shape K1 refuses, the kernels' build, a CUDA error, the readback)
        becomes a MergeError, which ``MergeManager.run`` turns into
        FallbackSignal: no run switches engine or device."""
        if self.engine != "pallas":
            yield
            return
        try:
            yield
        except UdaError:
            raise
        except Exception as e:
            raise MergeError(f"device merge on {self.device} failed: "
                             f"{type(e).__name__}: {e}") from e

    def _upload(self, staged: _StagedRun) -> torch.Tensor:
        """Copy a staged K1 run to the device and recycle its lease. On
        the card the copy runs on the copy stream from pinned memory, the
        merge stream waits for it, and this thread waits only for the
        copy (``merge.pipeline.put_ms``) before the lease goes back."""
        src = torch.from_numpy(staged.rows.view(np.int32))
        if self._copy_stream is None:
            rows = src.clone()  # the lease is reused: K1 gets its own copy
        else:
            if not src.is_pinned():
                raise MergeError("a staged run is not in pinned memory: "
                                 "its copy would not overlap the merges")
            with torch.cuda.stream(self._copy_stream):
                rows = src.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            self._merge_stream.wait_event(done)
            # allocated on the copy stream, used on the merge stream
            rows.record_stream(self._merge_stream)
            t0 = time.perf_counter()
            done.synchronize()
            metrics.observe("merge.pipeline.put_ms",
                            (time.perf_counter() - t0) * 1e3)
        self._recycle(staged)
        return u32(rows)

    def _consume_run(self, staged: _StagedRun) -> None:
        """Transfer + forest insert. The merges this triggers launch
        asynchronously; the only wait is the copy that frees a lease."""
        with metrics.timer("overlap_stage"), self._device_errors():
            rows = (self._upload(staged) if self.engine == "pallas"
                    else staged.rows)
            self._insert(Run(rows, staged.valid, _next_pow2(staged.valid)))

    def _insert(self, run: Run) -> None:
        # binary-counter carry: equal size classes merge immediately. The
        # lock serializes carries across serial stagers
        with self._forest_lock:
            merge_ops.carry_run(self._forest, run, self._merge)

    def _merge(self, a: Run, b: Run) -> Run:
        with metrics.timer("overlap_device_merge"):
            merged = merge_ops.merge_run_pair(a, b, self.engine)
        with self._state_lock:
            self._merges += 1
        return merged

    # -- consumer side -------------------------------------------------------

    @property
    def stats(self) -> dict:
        """Counters for observability/tests: merges that have completed
        and segments staged so far (both monotone)."""
        pending = self._q.qsize()
        if self._staged_q is not None:
            pending += self._staged_q.qsize()
        return {"device_merges": self._merges, "staged_runs": self._staged,
                "pending": pending, "overflow": self._overflow,
                "pipeline": self.pipeline,
                "inflight_bytes": self._inflight}

    def _reap_input_queue(self) -> None:
        """Release the budget charge of every item still in the input
        queue (each item is consumed exactly once: by a worker or here)."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._release_charge(item[3])

    def _reap_pending(self) -> None:
        """With every stage thread stopped, release what is still queued:
        budget charges and buffer leases."""
        self._reap_input_queue()
        if self._staged_q is None:
            return
        while True:
            try:
                staged = self._staged_q.get_nowait()
            except queue.Empty:
                break
            if staged is not None:
                self._discard(staged)

    def _drain(self) -> None:
        """Signal end of input and wait for staging to finish."""
        for _ in self._workers:
            self._q.put(None)
        for t in self._workers:
            t.join()
        if self._consumer_thread is not None:
            self._staged_q.put(None)
            self._consumer_thread.join()
        # error paths drop their items without consuming them
        self._reap_pending()
        if self._error is not None:
            raise self._error

    def _release_forest(self) -> None:
        """Drop every forest run (abort and fallback paths abandon the
        forest without merging it)."""
        with self._forest_lock:
            self._forest = {}

    def _merge_leftovers(self) -> Optional[Run]:
        """Merge the O(log k) leftover forest runs, smallest first
        (``ops/merge.merge_leftover_runs``). Returns None when nothing was
        staged."""
        with self._forest_lock:
            runs = [self._forest[c] for c in sorted(self._forest)]
            self._forest = {}
        return merge_ops.merge_leftover_runs(runs, self.engine, self._merge)

    def _merged(self) -> Optional[Run]:
        """The leftover forest merged into one run, ready for the calling
        thread to read: on the card its current stream waits for the
        merge stream."""
        with self._device_errors():
            with self._on_device():
                acc = self._merge_leftovers()
            if acc is not None and self._merge_stream is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_stream(self._merge_stream)
                acc.rows.record_stream(current)
        return acc

    def _seg_row_slabs(self, acc: Run,
                       slab: int = stream_mod.SLAB_RECORDS):
        """The merged run's (segment, row) columns, read back in slabs of
        ``np.uint32[m, 2]``: all that emission needs of the rows. A
        failed readback is a device failure (:meth:`_device_errors`)."""
        kw = int(acc.rows.shape[1]) - merge_ops.ROW_EXTRA_COLS
        with self._device_errors():
            yield from stream_mod.iter_row_slabs(
                acc.rows[:, kw + 1:kw + 3], acc.valid, slab)

    def _warn_overflow(self, fallback: str) -> None:
        log.warn(f"overlap fast path disabled (oversize keys); "
                 f"falling back to {fallback}")

    def _check_accounting(self, acc: Optional[Run], total: int) -> bool:
        """Lost-records guard shared by every finish variant. Returns
        False when nothing was staged AND nothing should have been (the
        all-empty case); raises when records went missing."""
        if acc is None:
            if total:
                raise MergeError(
                    f"overlap merge fed 0 of {total} records")
            return False
        if acc.valid != total:
            raise MergeError(
                f"overlap merge lost records: {acc.valid} of {total} "
                f"(segments fed != segments finished?)")
        return True

    def finish(self, batches: Sequence[RecordBatch]) -> RecordBatch:
        """Drain, merge the leftover forest, and materialize the sorted
        batch. ``batches`` must be ALL segments' batches in original
        segment-index order (the indices fed to :meth:`feed`)."""
        try:
            self._drain()
            if self._overflow:
                self._warn_overflow("global device re-sort")
                return merge_ops.merge_batches(batches, self.key_type,
                                               self.width, self.device)
            cat = RecordBatch.concat(list(batches))
            acc = self._merged()
            if not self._check_accounting(acc, cat.num_records):
                return cat  # all segments legitimately empty
            src = next(self._seg_row_slabs(acc, acc.valid))
            sizes = np.asarray([b.num_records for b in batches], np.int64)
            offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            return cat.take(offsets[src[:, 0].astype(np.int64)]
                            + src[:, 1].astype(np.int64))
        finally:
            self._release_forest()

    def emit_stream(self, batches: Sequence[RecordBatch], emitter,
                    consumer) -> int:
        """In-memory streaming emission: the same result bytes as
        ``emitter.emit_batch(self.finish(batches))`` but without ever
        concatenating the shuffle: each output slab's bytes are gathered
        straight from the per-segment batches and framed, so transient
        host memory is one slab."""
        try:
            with metrics.timer("merge"):
                self._drain()
                merged = acc = None
                if self._overflow:
                    self._warn_overflow("global device re-sort")
                    merged = merge_ops.merge_batches(
                        batches, self.key_type, self.width, self.device)
                else:
                    total = sum(b.num_records for b in batches)
                    acc = self._merged()
            if merged is not None:
                return emitter.emit_batch(merged, consumer)
            if not self._check_accounting(acc, total):
                return emitter.emit_framed(iter([EOF_MARKER]), consumer)

            def pieces():
                for src in self._seg_row_slabs(acc):
                    sub = stream_mod.slab_batch(
                        batches, src[:, 0].astype(np.int64),
                        src[:, 1].astype(np.int64))
                    yield frame_batch(sub, write_eof=False)
                yield EOF_MARKER

            return emitter.emit_framed(pieces(), consumer)
        finally:
            self._release_forest()

    def finish_streaming(self, emitter, consumer,
                         expected_records: Optional[int] = None) -> int:
        """Streaming-mode finish: drain staging, then emit the merged
        stream straight from the sorted run files (the permutation-driven
        k-way interleave of ``merger/streaming.py``). Host memory is one
        slab + one read buffer per run. Cleans up the run store."""
        store = self.run_store
        if store is None:
            raise MergeError("finish_streaming without a run store")
        try:
            with metrics.timer("merge"):
                self._drain()
                # read after the drain: a stager may still detect
                # oversize keys while it runs
                no_forest = self._overflow or not self.device_runs
                acc = None if no_forest else self._merged()
            total = store.total_records
            if expected_records is not None and total != expected_records:
                raise MergeError(
                    f"staged {total} of {expected_records} records")
            if total == 0:
                return emitter.emit_framed(iter([EOF_MARKER]), consumer)
            if no_forest:
                # every run is comparator-sorted (oversize segments by the
                # full comparator, in-width runs by (words, len), the
                # same order), so the fallback is a comparator-level
                # k-way merge over the run FILES: bounded memory
                if self._overflow:
                    self._warn_overflow("k-way merge over run files")
                else:
                    log.info("bounded-device streaming: k-way merge over "
                             "run files (no device forest)")
                streams = [iter_file_records(store.run_path(s))
                           for s in sorted(store.counts)]
                return emitter.emit(
                    merge_ops.merge_record_streams(streams, self.key_type),
                    consumer)
            self._check_accounting(acc, total)  # total>0: raises on loss
            return emitter.emit_framed(
                stream_mod.interleave_runs(self._seg_row_slabs(acc), store,
                                           seg_col=0), consumer)
        finally:
            store.cleanup()
            self._release_forest()

    def abort(self) -> None:
        """Stop the staging threads without producing output. ``_aborted``
        unblocks any transport thread waiting in feed() (queue OR
        in-flight budget) and makes the stage loops drain-and-exit even
        if no poison pill can land. Queued items' budget charges and
        buffer leases are reaped once every thread has stopped, and the
        run store is only cleaned then: never under a concurrent
        write_run."""
        self._aborted = True
        try:
            self._q.put_nowait(None)  # best effort: wake one instantly
        except queue.Full:
            pass
        if self._staged_q is not None:
            try:
                self._staged_q.put_nowait(None)
            except queue.Full:
                pass
        with self._inflight_cv:
            self._inflight_cv.notify_all()  # wake budget-blocked feeds
        deadline = 10.0
        for t in self._threads:
            t0 = time.monotonic()
            t.join(timeout=max(0.1, deadline))
            deadline -= time.monotonic() - t0
        stragglers = any(t.is_alive() for t in self._threads)
        if stragglers:
            if self.run_store is not None:
                log.warn("overlap abort: stager still running; leaving "
                         "scratch runs for it to fail safely")
            return
        self._reap_pending()
        if self.run_store is not None:
            self.run_store.cleanup()
        self._release_forest()
