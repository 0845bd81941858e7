"""Merge manager: fetch scheduling + merge orchestration.

The port's copy of ``uda_tpu/merger/merge_manager.py`` for the online
merge, ``mapred.netmerger.merge.approach=1``, in all three of its forms
(``merge_manager.py:1003-1132`` of the reference, without checkpointing):

- the default, ``uda.tpu.merge.overlap=true``: ``fetch_all`` feeds every
  completed segment to the overlapped merger
  (``uda_tpu_torch/merger/overlap.py``), which stages runs to the device
  and merges them there with K1 while later fetches are in flight, then
  ``emit_stream`` frames the result slab by slab; with
  ``uda.tpu.stage.pipeline`` (on by default) through a stage pool and one
  merge consumer, else on serial stage threads;
- ``uda.tpu.online.streaming=true``: the same merger spools each segment
  to a sorted run file (``merger/streaming.RunStore`` under
  ``uda.tpu.spill.dirs``) and ``finish_streaming`` interleaves the files;
- ``uda.tpu.merge.overlap=false``: ``fetch_all`` -> ``merge_segments``
  (the two-phase merge tree on K1, or the whole re-sort) ->
  ``emit_framed``.

Equivalent of the reference's MergeManager (reference
src/Merger/MergeManager.cc): the fetch phase issues per-map fetch requests
in a seeded random order with a bounded in-flight window (the reference
shuffles its fetch list, MergeManager.cc:58-63, and bounds in-flight
fetches with RDMA credits); the merge phase produces the globally sorted
stream on the device and hands it to the consumer in
staging-buffer-sized IFile-framed blocks (MergeManager.cc:155-182).

Modes the port does not have yet raise :class:`ConfigError` naming the key
and the missing module, and never quietly take another path:
``mapred.netmerger.merge.approach`` 0 or 2, ``uda.tpu.ckpt.dir``,
``uda.tpu.watchdog.stall.s`` (checked by ``run()``), and
``uda.tpu.push.enable``, ``uda.tpu.coding.scheme``, ``uda.tpu.failpoints``,
``uda.tpu.fetch.speculate.pn`` and ``uda.tpu.fetch.resume`` (checked at
construction). On the card a ``uda.tpu.key.width`` above 112 bytes is
refused at construction too wherever K1 would merge (its rows hold at
most 31 words), and left to the whole re-sort where it would not.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.merger.emitter import FramedEmitter
from uda_tpu_torch.merger.overlap import OverlappedMerger
from uda_tpu_torch.merger.recovery import RecoveryLedger
from uda_tpu_torch.merger.segment import InputClient, Segment
from uda_tpu_torch.merger.streaming import RunStore, spill_dirs
from uda_tpu_torch.ops import merge as merge_ops
from uda_tpu_torch.ops.pallas_merge import MAX_COLS
from uda_tpu_torch.utils.budget import stage_inflight_cap
from uda_tpu_torch.utils.comparators import KeyType, get_key_type
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (ConfigError, FallbackSignal,
                                        MergeError, UdaError)
from uda_tpu_torch.utils.ifile import RecordBatch
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.retry import RetryPolicy

__all__ = ["MergeManager", "PenaltyBox"]

log = get_logger()

# (key, the value the port cannot honour, what is not ported): checked at
# construction (they change how fetches run) ...
_UNPORTED_FETCH = [
    ("uda.tpu.failpoints", lambda v: bool(v), "uda_tpu/utils/failpoints.py"),
    ("uda.tpu.push.enable", lambda v: bool(v), "uda_tpu/net/push.py"),
    ("uda.tpu.coding.scheme", lambda v: bool(v), "uda_tpu/coding"),
    ("uda.tpu.fetch.speculate.pn", lambda v: int(v) > 0,
     "speculative fetch (uda_tpu/merger/segment.py)"),
    ("uda.tpu.fetch.resume", lambda v: bool(v),
     "mid-partition resume (uda_tpu/merger/segment.py)"),
]
# ... and by run() (they choose its path)
_UNPORTED_RUN = [
    ("mapred.netmerger.merge.approach", lambda v: int(v) != 1,
     "the auto and hybrid approaches (uda_tpu/utils/budget.py, "
     "uda_tpu/merger/hybrid.py)"),
    ("uda.tpu.ckpt.dir", lambda v: bool(v), "uda_tpu/merger/checkpoint.py"),
    ("uda.tpu.watchdog.stall.s", lambda v: float(v) > 0,
     "uda_tpu/utils/watchdog.py"),
]


def _refuse_unported(cfg: Config, checks: list) -> None:
    for key, unported, module in checks:
        value = cfg.get(key)
        if unported(value):
            raise ConfigError(
                f"{key}={value!r} needs {module}, which is not ported to "
                f"uda_tpu_torch yet")


def _refuse_wide_rows(cfg: Config, device) -> None:
    """On the card every form of ``run()`` but the whole re-sort merges
    runs with K1, whose rows (key words + 3) hold at most
    ``pallas_merge.MAX_COLS`` words: wider keys are refused here, before
    anything is fetched, not by a failed merge."""
    width = int(cfg.get("uda.tpu.key.width"))
    cols = width // 4 + merge_ops.ROW_EXTRA_COLS
    if resolve_device(device).type != "cuda" or cols <= MAX_COLS:
        return
    k1 = (cfg.get("uda.tpu.online.streaming")
          or cfg.get("uda.tpu.merge.overlap")
          or merge_ops.resolve_merge_mode(
              str(cfg.get("uda.tpu.merge.two_phase")), 2, device)
          == "two_phase")
    if k1:
        raise ConfigError(
            f"uda.tpu.key.width={width} gives K1 rows of {cols} words; the "
            f"card's merge carries at most {MAX_COLS} (widths up to "
            f"{4 * (MAX_COLS - merge_ops.ROW_EXTRA_COLS)} B)")


class PenaltyBox:
    """Per-supplier fault tracker: a supplier whose fetches keep failing
    is *deprioritized* — its remaining maps rotate to the back of the
    fetch schedule. Boxing is never exclusion: when every pending supplier
    is boxed the scheduler proceeds anyway.

    Forgiveness DECAYS rather than resets: one success takes one fault
    off the record; only ``reset_successes`` CONSECUTIVE successes clear
    it outright."""

    def __init__(self, threshold: int = 2, penalty_s: float = 1.0,
                 reset_successes: int = 3):
        self.threshold = max(1, threshold)
        self.penalty_s = penalty_s
        self.reset_successes = max(1, reset_successes)
        self._lock = threading.Lock()
        self._faults: dict[str, int] = {}
        self._until: dict[str, float] = {}
        self._streak: dict[str, int] = {}  # consecutive successes

    def punish(self, key: str) -> bool:
        """Record one fault; returns True when this fault boxed the
        supplier (crossing the threshold, or extending an active box)."""
        with self._lock:
            self._streak.pop(key, None)  # a fault breaks the streak
            n = self._faults.get(key, 0) + 1
            self._faults[key] = n
            if n < self.threshold:
                return False
            self._until[key] = time.monotonic() + self.penalty_s
        metrics.add("fetch.penalties", supplier=key)
        return True

    def forgive(self, key: str) -> None:
        """One success decays the fault record one step (and unboxes a
        supplier that dropped below the threshold); the record clears
        entirely after ``reset_successes`` consecutive successes."""
        with self._lock:
            n = self._faults.get(key)
            if n is None:
                return
            streak = self._streak.get(key, 0) + 1
            n = max(0, n - 1)
            if streak >= self.reset_successes or n == 0:
                self._faults.pop(key, None)
                self._until.pop(key, None)
                self._streak.pop(key, None)
                return
            self._streak[key] = streak
            self._faults[key] = n
            if n < self.threshold:
                self._until.pop(key, None)

    def faults(self, key: str) -> int:
        with self._lock:
            return self._faults.get(key, 0)

    def penalized(self, key: str) -> bool:
        with self._lock:
            t = self._until.get(key)
            if t is None:
                return False
            if time.monotonic() >= t:
                # parole: out of the box, but one more fault re-boxes
                del self._until[key]
                self._faults[key] = self.threshold - 1
                return False
            return True


class MergeManager:
    """Orchestrates fetch -> pack -> device merge -> framed emission for
    one reduce task. ``device`` (``None`` = the card) is where the merge
    runs; without a card pass ``device="cpu"``."""

    def __init__(self, client: InputClient, key_type: KeyType | str,
                 config: Optional[Config] = None, seed: int = 0,
                 device=None):
        self.cfg = config or Config()
        _refuse_unported(self.cfg, _UNPORTED_FETCH)
        self.device = resolve_device(device)
        self.client = client
        self.key_type = (get_key_type(key_type) if isinstance(key_type, str)
                         else key_type)
        self.key_width = self.cfg.get("uda.tpu.key.width")
        _refuse_wide_rows(self.cfg, self.device)
        self.chunk_size = self.cfg.get("mapred.rdma.buf.size") * 1024
        self.window = max(1, self.cfg.get("mapred.rdma.wqe.per.conn"))
        self.seed = seed
        self.emitter = FramedEmitter(self.chunk_size)
        self.retry_policy = RetryPolicy.from_config(self.cfg)
        self.penalty_box = PenaltyBox(
            threshold=self.cfg.get("uda.tpu.fetch.penalty.threshold"),
            penalty_s=self.cfg.get("uda.tpu.fetch.penalty.ms") / 1e3)
        self.ledger = RecoveryLedger()
        self._active_overlap: Optional[OverlappedMerger] = None
        if self.cfg.get("uda.tpu.stats.enable"):
            metrics.enable_stats()

    # -- fetch phase --------------------------------------------------------

    def fetch_all(self, job_id: str, map_ids: Sequence, reduce_id: int,
                  on_segment: Optional[Callable] = None) -> list:
        """Fetch every map's partition, randomized order, sliding window.

        Entries are ``"map_id"`` or ``("host", "map_id")``. The window
        refills as individual segments complete (credit-flow semantics).
        Returns segments in the *original* map order (merge stability and
        reproducibility do not depend on fetch completion order).

        ``on_segment(index, segment)`` fires on each successful segment
        completion, from the transport's completion thread, after the
        segment's credit is released: the hook the overlapped merger uses
        to stage runs while later fetches are still in flight. Its errors
        are raised once every fetch has finished.

        Fault feedback: every transport fault reports the segment's
        supplier to the penalty box; maps of a boxed supplier rotate to
        the back of the pending schedule (see :class:`PenaltyBox`)."""
        def _norm(m):
            if not isinstance(m, tuple):
                return "", m
            host, mid = m
            if isinstance(host, (list, tuple)):
                raise MergeError(
                    f"replica host lists ({host!r}) need speculative and "
                    f"replicated fetch, not ported to uda_tpu_torch yet")
            return host, mid

        segs = [Segment(self.client, job_id, mid, reduce_id,
                        self.chunk_size, host=host, policy=self.retry_policy)
                for host, mid in map(_norm, map_ids)]
        index_of = {id(s): i for i, s in enumerate(segs)}
        order = list(range(len(segs)))
        random.Random(self.seed).shuffle(order)  # MergeManager.cc:58-63
        credits = threading.Semaphore(self.window)
        done_lock = threading.Lock()
        done = 0
        all_notified = threading.Event()  # every on_done callback returned
        cb_errors: list[Exception] = []
        box = self.penalty_box

        def on_fault(seg, exc) -> None:
            sup = getattr(exc, "supplier", None) or seg.supplier
            self.ledger.record("fault", supplier=sup, map_id=seg.map_id,
                               error=exc)
            if box.punish(sup):
                log.warn(f"supplier {sup!r} penalized "
                         f"after repeated fetch faults ({exc})")

        def on_done(seg) -> None:
            nonlocal done
            if seg.ready:
                box.forgive(seg.supplier)
            credits.release()
            try:
                if on_segment is not None and seg.ready:
                    on_segment(index_of[id(seg)], seg)
            except Exception as e:  # raised after the waits below
                cb_errors.append(e)
            finally:
                with done_lock:
                    done += 1
                    if done == len(segs):
                        all_notified.set()

        with metrics.timer("fetch"):
            pending = deque(order)
            while pending:
                credits.acquire()
                i = self._next_fetch_index(pending, segs)
                segs[i].on_done = on_done
                segs[i].on_fault = on_fault
                segs[i].start()
            for s in segs:
                s.wait()
            # a segment is done BEFORE its on_done callback runs: wait for
            # the callbacks too, or the caller could finish the on_segment
            # consumer (the overlapped merger) while the last completion
            # is still inside it
            if segs:
                all_notified.wait()
        if cb_errors:
            raise cb_errors[0]
        return segs

    def _next_fetch_index(self, pending: deque, segs) -> int:
        """Penalty-box-aware pick: the first pending segment whose
        supplier is not boxed; boxed ones rotate to the back. When every
        pending supplier is boxed, take the head anyway."""
        for _ in range(len(pending) - 1):
            if not self.penalty_box.penalized(segs[pending[0]].supplier):
                break
            pending.rotate(-1)
            metrics.add("fetch.deprioritized")
        return pending.popleft()

    # -- merge phase --------------------------------------------------------

    def merge_segments(self, segments: Sequence[Segment]) -> RecordBatch:
        """Merge all fetched segments into one sorted batch on the device.
        Routed by ``uda.tpu.merge.two_phase``: the two-phase merge (K1's
        merge tree on the card) or the whole-shuffle re-sort —
        byte-identical either way."""
        batches = [s.record_batch() for s in segments]
        metrics.add("merge.records", sum(b.num_records for b in batches))
        mode = merge_ops.resolve_merge_mode(
            str(self.cfg.get("uda.tpu.merge.two_phase")), len(batches),
            self.device)
        with metrics.timer("merge"):
            if mode == "two_phase":
                return merge_ops.merge_batches_two_phase(
                    batches, self.key_type, self.key_width,
                    device=self.device)
            return merge_ops.merge_batches(batches, self.key_type,
                                           self.key_width, self.device)

    def emit_framed(self, merged: RecordBatch,
                    consumer: Callable[[memoryview], None]) -> int:
        """Stream the sorted batch to ``consumer`` in IFile-framed blocks
        of at most the staging-buffer size (the dataFromUda contract: the
        block's memory is only valid during the call, reference
        UdaPlugin.java:368-402). Returns total bytes emitted."""
        return self.emitter.emit_batch(merged, consumer)

    def run(self, job_id: str, map_ids: Sequence, reduce_id: int,
            consumer: Callable[[memoryview], None]) -> int:
        """The online merge (reference merge_online,
        MergeManager.cc:184-193): fetch every partition, merge on the
        device (overlapped with the fetch by default), emit. Returns the
        bytes emitted.

        Failure contract: a terminal engine error (retries exhausted,
        merge invariant violation, a failed device merge — any
        ``UdaError``) is re-raised as :class:`FallbackSignal` carrying the
        root cause (the reference's ``failureInUda`` flip,
        UdaBridge.cc:506-530). A configured mode this port cannot run
        raises :class:`ConfigError` before anything is fetched."""
        _refuse_unported(self.cfg, _UNPORTED_RUN)
        try:
            with metrics.span("reduce_task", job=job_id, reduce=reduce_id,
                              maps=len(map_ids)):
                return self._run(job_id, map_ids, reduce_id, consumer)
        except UdaError as e:
            metrics.add("fallback.signals")
            log.error(f"merge failed terminally, requesting fallback: {e}")
            raise FallbackSignal(e) from e

    def _run(self, job_id: str, map_ids: Sequence, reduce_id: int,
             consumer: Callable[[memoryview], None]) -> int:
        streaming = bool(self.cfg.get("uda.tpu.online.streaming"))
        if not streaming and not self.cfg.get("uda.tpu.merge.overlap"):
            segments = self.fetch_all(job_id, map_ids, reduce_id)
            merged = self.merge_segments(segments)
            return self.emit_framed(merged, consumer)
        store = None
        if streaming:
            # bounded-host-memory online mode: segments spool to sorted
            # runs and release their bytes; the bounded feed queue keeps
            # pending segments at O(window); emission interleaves the
            # runs (the reference's staging-loop memory model,
            # StreamRW.cc:151-225)
            store = RunStore(spill_dirs(self.cfg),
                             tag=f"{job_id}.r{reduce_id}")
        # staged pipeline (uda.tpu.stage.pipeline, default on): stage pool
        # + merge consumer; off = the serial stage loop. Pool width:
        # uda.tpu.stage.pool, else uda.tpu.online.stagers, else auto
        pipelined = bool(self.cfg.get("uda.tpu.stage.pipeline"))
        pool = int(self.cfg.get("uda.tpu.stage.pool"))
        stagers = int(self.cfg.get("uda.tpu.online.stagers"))
        om = OverlappedMerger(
            self.key_type, self.key_width, run_store=store,
            max_pending=self.window if streaming else 0,
            stagers=pool if (pipelined and pool > 0) else stagers,
            pipeline=pipelined,
            inflight_bytes=stage_inflight_cap(self.cfg, self.window,
                                              self.chunk_size),
            device=self.device)
        self._active_overlap = om  # observability (tests, diagnostics)
        try:
            # feed the Segment itself: its record_batch() then runs on a
            # stage thread, not on the transport's completion thread
            segments = self.fetch_all(job_id, map_ids, reduce_id,
                                      on_segment=om.feed)
        except Exception:
            # the abort (which also cleans up the run store) must never
            # mask the fetch error that got us here
            try:
                om.abort()
            except Exception as cleanup_err:  # noqa: BLE001
                metrics.add("errors.swallowed")
                log.warn(f"overlap abort during failure unwind itself "
                         f"failed: {cleanup_err}")
            raise
        # the "merge" timer covers drain + leftover merges inside the
        # finish paths; emission stays under the emitter's "emit" timer
        if streaming:
            return om.finish_streaming(
                self.emitter, consumer,
                expected_records=sum(s.num_records for s in segments))
        return om.emit_stream([s.record_batch() for s in segments],
                              self.emitter, consumer)
