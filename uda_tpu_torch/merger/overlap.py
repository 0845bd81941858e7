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
  policy: each run takes the power-of-two size class of its records and
  two runs of one class merge at once into a run of the next class, so
  every record moves through at most log2(k) merges. A staged run is
  padded to its class's capacity; K1 merges the two runs' valid
  prefixes only, so a merged run is of exact size;
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

Keys past the width: keys whose content exceeds the carried width stay
on the forest, their rows built as every run's (the padded prefix words,
then the true length, segment and row). K1's order is then the
comparator's but inside each block of consecutive oversize keys with
equal prefixes, so a latch set at staging puts the tie-fix
(``merger/streaming.tiefix_slabs``) between the merged rows and the
in-memory finishes' gather: it re-sorts each such block by its full
content. Where the reference re-sorts globally, the output is the same
bytes. Two cases keep the reference's fallback, latched at staging
(``_overflow``): the streaming finish (its runs spool in the full
comparator's order and ``finish_streaming`` k-way merges the files) and
a key type whose ``compare`` is overridden (``finish()`` and
``emit_stream`` re-sort globally, ``ops/merge.merge_batches``).

No quiet fallback: a failure of the device half (a K1 launch, the
kernels' build, a CUDA error) is latched and raised by ``finish()`` as
:class:`MergeError`, never answered by another engine or device.

Observability as in the reference: stage threads adopt the task's span,
the consumer's blocked time is ``merge.wait`` spans and each K1 run's copy
a ``merge.device_put`` span; the in-flight budget's condition is the
lockdep-tracked ``stage.inflight``; every finish and abort is a resource
ledger drain point of the merger's pool leases, and an abort is a flight
recorder event. The host engine merges runs with the native host
runtime's linear row merge while ``uda.tpu.use.native`` is on (resolved
once, at construction, outside every lock), splitting a large merge of the
pipelined forest across threads at merge-path points
(``ops/merge.merge_rows_split_into``); with the switch off it keeps
``merge_row_pair``'s lexsort. As in the reference, that pipelined forest
stages its runs and merges into ``RowBufferPool`` leases, each recycled
when its run merges into a larger one, so no merge allocates its output.

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
from uda_tpu_torch import native
from uda_tpu_torch.merger import streaming as stream_mod
from uda_tpu_torch.ops import merge as merge_ops
from uda_tpu_torch.ops import packing
from uda_tpu_torch.ops.merge import Run
from uda_tpu_torch.ops.sort import u32
from uda_tpu_torch.utils.comparators import KeyType, uses_default_bytewise
from uda_tpu_torch.utils.errors import MergeError, UdaError
from uda_tpu_torch.utils.ifile import (EOF_MARKER, RecordBatch,
                                       iter_file_records, native_enabled)
from uda_tpu_torch.utils.flightrec import flightrec
from uda_tpu_torch.utils.locks import TrackedCondition, TrackedLock
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.resledger import resledger

__all__ = ["OverlappedMerger"]

log = get_logger()

_next_pow2 = merge_ops.next_run_capacity

# widest per-key content the vectorized overflow lexsort materializes
# as an n-by-width matrix; rarer/wider keys keep the comparator loop
_LEXSORT_MAX_KEY = 4096
# a pipelined host merge of at least this many rows splits across threads
_MERGE_SPLIT_MIN_ROWS = 1 << 18


class _StagedRun:
    """A stage worker's output awaiting the merge consumer: sorted host
    rows (a pool lease for K1 runs and the pipelined host forest's), fed
    timestamp (the merge.wait_ms anchor) and the in-flight byte charge it
    releases once merged."""

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
                 inflight_bytes: int = 0, on_spool=None, device=None):
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
        # staging threads adopt the constructing thread's span (the
        # reduce-task root), so their pack/stage/merge timers land in the
        # right trace subtree
        self._parent_span = metrics.current_span()
        # the reduce task's teardown timer, started as a finish's emission
        # returns; the task stops it as run() returns
        self.teardown = None
        # udarace: lockfree=_q,_staged_q - queue.Queue is internally
        # locked; cross-thread put/get rides the Queue's own mutex
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        # udarace: lockfree=_aborted,_overflow,_oversize - one-way bool
        # latches (GIL-atomic store; readers may lag one item, by design)
        self._aborted = False
        self._overflow = False
        # a run held a key past the width and stayed on the forest: the
        # in-memory finishes run the tie-fix (read after the drain)
        self._oversize = False
        self._tiefix = (run_store is None
                        and uses_default_bytewise(key_type))
        self._forest: dict[int, Run] = {}   # size class -> run
        self._forest_lock = threading.Lock()
        self._state_lock = threading.Lock()  # counters
        # udarace: lockfree=_error - first-error latch: a lagging racer
        # overwrites with its own exception, either surfaces at finish()
        self._error: Optional[Exception] = None
        self._merges = 0
        self._staged = 0
        # in-flight bytes budget: feed() charges, the merge consumer (or
        # the spool/drop path) releases; 0 = unbounded
        self._inflight_cap = max(0, int(inflight_bytes))
        self._inflight = 0
        self._inflight_cv = TrackedCondition(TrackedLock("stage.inflight"))
        # the host engine's native row merge, resolved here so a cold
        # library builds before any carry runs under _forest_lock; the
        # pipelined forest splits large merges over the cores the stage
        # half leaves idle
        self._native_rows_merge = (merge_ops.resolve_native_rows_merge()
                                   if self.engine == "host" else None)
        host_pool = pipeline and self._native_rows_merge is not None
        self._merge_parts = (max(2, min(4, os.cpu_count() or 2))
                             if host_pool else 1)
        # K1 runs are built in pool leases (pinned on the card) and copied
        # to the device, where the merger has its own copy and merge
        # streams: PyTorch's current stream would queue each copy behind
        # the merges already launched. The pipelined host forest's runs
        # and merge outputs lease too, each recycled when its run merges
        # away (a fresh output per merge would page-fault every byte)
        self._buf_pool = (merge_ops.RowBufferPool(device=self.device)
                          if self.engine == "pallas" or host_pool else None)
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
        metrics.gauge_add("stage.inflight.bytes", charge)  # udalint: disable=UDA101 - feed() pairs every charge with one _release_charge()
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
        with metrics.use_span(self._parent_span), self._on_device():
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
        with metrics.use_span(self._parent_span):
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
        with metrics.use_span(self._parent_span), self._on_device():
            # merge.wait spans: the consumer's blocked-on-staging time as
            # a trace lane (the span twin of the merge.wait_ms histogram,
            # critpath's "wait" bucket), one span per contiguous wait
            wait = metrics.start_span("merge.wait")
            while True:
                try:
                    staged = self._staged_q.get(timeout=0.25)
                except queue.Empty:
                    if self._aborted:
                        wait.end(aborted=True)
                        return
                    continue
                wait.end()
                if staged is None:
                    return
                if self._error is not None or self._aborted:
                    self._discard(staged)
                    wait = metrics.start_span("merge.wait")
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
                wait = metrics.start_span("merge.wait")

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
            packed = packing.pack_keys(batch, self.key_type, self.width,
                                       ranks=False)
        metrics.add("stage.bytes",
                    int(batch.key_len.sum() + batch.val_len.sum()))
        oversize = int(np.max(packed.key_lens, initial=0)) > self.width
        if oversize and self._tiefix:
            # the run stays on the forest; the in-memory finishes re-sort
            # its blocks of equal-prefix oversize keys (module docstring)
            self._oversize = True
        elif oversize:
            # the streaming finish or a custom compare: disable the fast
            # path (see module docstring)
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
        for the host engine (a pool lease in the pipelined forest, else
        numpy), a pool lease padded to a power-of-two capacity (a bounded
        set of shapes) for K1."""
        n = packed.num_records
        cols = packed.key_words.shape[1] + merge_ops.ROW_EXTRA_COLS
        if self._buf_pool is None:
            rows = np.empty((n, cols), np.uint32)
            merge_ops.fill_run_rows(rows, packed, order, seg_index)
            return _StagedRun(rows, n, None, fed_t, 0)
        cap = _next_pow2(n) if self.engine == "pallas" else n
        with self._device_errors():
            lease = self._buf_pool.lease(cap, cols)
        try:
            merge_ops.fill_run_rows(lease, packed, order, seg_index)
            return _StagedRun(lease, n, lease, fed_t, 0)
        except BaseException:
            self._buf_pool.release(lease)
            raise

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
            rows = staged.rows
            if self.engine == "pallas":
                with metrics.span("merge.device_put", rows=staged.valid):
                    rows = self._upload(staged)
            # a host run KEEPS its pool lease (recycled when it merges
            # away); ownership moves to the Run, so an error path's
            # _recycle can never release it twice
            lease, staged.lease = staged.lease, None
            self._insert(Run(rows, staged.valid, _next_pow2(staged.valid),
                             lease))

    def _insert(self, run: Run) -> None:
        # binary-counter carry: equal size classes merge immediately. The
        # lock serializes carries across serial stagers
        with self._forest_lock:
            merge_ops.carry_run(self._forest, run, self._merge)

    def _merge(self, a: Run, b: Run) -> Run:
        with metrics.timer("overlap_device_merge"):
            if self.engine == "host" and self._buf_pool is not None:
                merged = self._merge_into_lease(a, b)
            else:
                merged = merge_ops.merge_run_pair(a, b, self.engine,
                                                  self._native_rows_merge)
        with self._state_lock:
            self._merges += 1
        return merged

    def _merge_into_lease(self, a: Run, b: Run) -> Run:
        """The pipelined host forest's merge: into a pool-leased output,
        split across threads at merge-path points when it is large (the
        native call releases the GIL). The output's lease moves to the
        returned Run; the inputs' recycle once it is done, and a failed
        merge returns only the output's."""
        total = a.valid + b.valid
        out = self._buf_pool.lease(total, int(a.rows.shape[1]))  # udalint: disable=UDA101 - handed to the returned Run
        parts = self._merge_parts if total >= _MERGE_SPLIT_MIN_ROWS else 1
        try:
            merge_ops.merge_rows_split_into(
                np.ascontiguousarray(a.rows[:a.valid]),
                np.ascontiguousarray(b.rows[:b.valid]), out, parts)
        except BaseException:
            self._buf_pool.release(out)
            raise
        self._release_run(a)
        self._release_run(b)
        return Run(out, total, 2 * max(a.bucket, b.bucket), out)

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

    def _release_run(self, run: Optional[Run]) -> None:
        """Recycle a run's pool lease (idempotent: the lease goes to
        None)."""
        if run is not None and run.lease is not None:
            self._buf_pool.release(run.lease)
            run.lease = None

    def _release_forest(self) -> None:
        """Drop every forest run and recycle its lease (abort and fallback
        paths abandon the forest without merging it)."""
        with self._forest_lock:
            runs, self._forest = list(self._forest.values()), {}
        for run in runs:
            self._release_run(run)

    def _finish_cleanup(self, acc: Optional[Run]) -> None:
        """The cleanup of every finish flavour's ``finally``: the merged
        run's lease and abandoned forest runs' go home, then the drain
        point asserts this merger's pool books are empty."""
        self._release_run(acc)
        self._release_forest()
        self._ledger_drain("merger.finish")

    def _ledger_drain(self, point: str) -> None:
        """ResourceLedger drain point (``UDA_TPU_RESLEDGER=1``): with this
        merger finished or aborted, its pool leases must all be settled;
        anything open is reported with its acquire stack. Drained under
        this merger's pool owner scope, so a concurrent merger's open
        leases are untouched. The staging gauges are process-global
        (owner-less) and are drained at the quiescent points instead
        (the bridge's EXIT, a test's teardown)."""
        if resledger.enabled and self._buf_pool is not None:
            resledger.drain(point, pairs=("pool.lease",),
                            owner=id(self._buf_pool))

    def _merge_leftovers(self) -> Optional[Run]:
        """Merge the O(log k) leftover forest runs, smallest first
        (``ops/merge.merge_leftover_runs``). Returns None when nothing was
        staged."""
        with self._forest_lock:
            runs = [self._forest[c] for c in sorted(self._forest)]
            self._forest = {}
        return merge_ops.merge_leftover_runs(runs, self._merge)

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
                       slab: int = stream_mod.SLAB_RECORDS,
                       whole: bool = False):
        """The merged run's (segment, row) columns, read back in slabs of
        ``np.uint32[m, 2]``: all that emission needs of the rows (with
        ``whole``, every column of the rows). A failed readback is a
        device failure (:meth:`_device_errors`)."""
        kw = int(acc.rows.shape[1]) - merge_ops.ROW_EXTRA_COLS
        with self._device_errors():
            yield from stream_mod.iter_row_slabs(
                acc.rows if whole else acc.rows[:, kw + 1:kw + 3],
                acc.valid, slab)

    def _pair_slabs(self, acc: Run, batches: Sequence[RecordBatch],
                    slab: int = stream_mod.SLAB_RECORDS):
        """The in-memory finishes' (segment, row) slabs: the merged run's,
        through the tie-fix where a run held a key past the width."""
        if not self._oversize:
            return self._seg_row_slabs(acc, slab)
        return stream_mod.tiefix_slabs(
            self._seg_row_slabs(acc, slab, whole=True), batches,
            self.key_type, self.width)

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
        acc = None
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
            src = np.concatenate(list(self._pair_slabs(acc, batches,
                                                       acc.valid)))
            sizes = np.asarray([b.num_records for b in batches], np.int64)
            offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            return cat.take(offsets[src[:, 0].astype(np.int64)]
                            + src[:, 1].astype(np.int64))
        finally:
            self._finish_cleanup(acc)

    def emit_stream(self, batches: Sequence[RecordBatch], emitter,
                    consumer) -> int:
        """In-memory streaming emission: the same result bytes as
        ``emitter.emit_batch(self.finish(batches))`` but without ever
        concatenating the shuffle: each output slab's bytes are gathered
        straight from the per-segment batches and framed, so transient
        host memory is one slab."""
        merged = acc = None
        try:
            with metrics.timer("merge"):
                self._drain()
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
            return emitter.emit_framed(
                stream_mod.frame_slabs(self._pair_slabs(acc, batches),
                                       batches), consumer)
        finally:
            self.teardown = metrics.start_timer("task_teardown")
            self._finish_cleanup(acc)

    def finish_streaming(self, emitter, consumer,
                         expected_records: Optional[int] = None) -> int:
        """Streaming-mode finish: drain staging, then emit the merged
        stream straight from the sorted run files (the permutation-driven
        k-way interleave of ``merger/streaming.py``). Host memory is one
        slab + one read buffer per run. Cleans up the run store."""
        store = self.run_store
        if store is None:
            raise MergeError("finish_streaming without a run store")
        acc = None
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
                paths = [store.run_path(s) for s in sorted(store.counts)]
                if native_enabled() and native.kway_supported(self.key_type):
                    return emitter.emit_framed(
                        native.kway_merge_paths(paths, self.key_type),
                        consumer)
                streams = [iter_file_records(p) for p in paths]
                return emitter.emit(
                    merge_ops.merge_record_streams(streams, self.key_type),
                    consumer)
            self._check_accounting(acc, total)  # total>0: raises on loss
            return emitter.emit_framed(
                stream_mod.interleave_runs(self._seg_row_slabs(acc), store,
                                           seg_col=0), consumer)
        finally:
            self.teardown = metrics.start_timer("task_teardown")
            store.cleanup()
            self._finish_cleanup(acc)

    def abort(self) -> None:
        """Stop the staging threads without producing output. ``_aborted``
        unblocks any transport thread waiting in feed() (queue OR
        in-flight budget) and makes the stage loops drain-and-exit even
        if no poison pill can land. Queued items' budget charges and
        buffer leases are reaped once every thread has stopped, and the
        run store is only cleaned then: never under a concurrent
        write_run."""
        self._aborted = True
        # black-box state transition: an abort is the merge half of
        # almost every failure post-mortem
        st = self.stats
        flightrec.record("overlap.abort", staged_runs=st.get("staged_runs", 0),
                         pending=st.get("pending", 0))
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
        # the abandoned forest goes, then the drain point asserts nothing
        # else is open (a straggler may still hold leases: no drain then)
        self._release_forest()
        self._ledger_drain("merger.abort")
