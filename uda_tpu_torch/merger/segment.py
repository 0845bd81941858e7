"""Segments: streaming views of one map-output partition.

The port's copy of ``uda_tpu/merger/segment.py``: the transport
abstraction, the in-process client and the chunked fetch with
partial-record carry, attempt timeouts, CRC re-fetch and whole-segment
retry, the ``segment.fetch`` failpoint, the administrative ``fail()`` (the
watchdog's and ``stop()``'s rescue) and the checkpoint's offset ledger
(``ckpt_export``/``ckpt_preload``: a preloaded segment issues its first
fetch at the checkpointed offset and checks the partition's identity on
its first chunk). The reference's host-routing client and its
survivable-shuffle rungs (speculative fetch, the transport-retry
mid-partition resume, k-of-n reconstruction) are not ported yet.

Equivalent of the reference's Segment/BaseSegment (reference
src/Merger/StreamRW.cc:334-590): a segment pulls its partition's bytes
chunk by chunk through an InputClient, handling records that break across
chunk boundaries. The reference does this with double-buffered RDMA
fetches and a ``switch_mem`` that ``join``s the split record into
``temp_kv`` (StreamRW.cc:462-590); here the same contract is a *carry
buffer*: each chunk is columnar-cracked up to its last complete record and
the partial tail is prepended to the next chunk.

``InputClient`` is the transport abstraction of reference
src/Merger/InputClient.h:30-56 (``start_fetch_req``/``comp_fetch_req``).
"""

from __future__ import annotations

import abc
import random
import threading
import time
import zlib
from typing import Optional

from uda_tpu_torch.mofserver.data_engine import (DataEngine, FetchResult,
                                                 ShuffleRequest)
from uda_tpu_torch.merger.streaming import framed_records
from uda_tpu_torch.utils.errors import (MergeError, StorageError,
                                        TenantError, TransportError,
                                        attribute_supplier)
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.ifile import RecordBatch, crack_partial
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.retry import RetryPolicy

log = get_logger()

__all__ = ["InputClient", "LocalFetchClient", "Segment"]


class InputClient(abc.ABC):
    """Transport abstraction (reference InputClient.h:30-56)."""

    @abc.abstractmethod
    def start_fetch(self, req: ShuffleRequest, on_complete) -> None:
        """Async fetch; ``on_complete(FetchResult | Exception)``."""

    def estimate_partition_bytes(self, job_id: str, map_ids,
                                 reduce_id: int):
        """Best-effort size of this reduce partition across ``map_ids``, or
        None when the transport cannot know it without fetching (the auto
        merge approach then takes the bounded-memory path)."""
        return None

    def resume_ok(self, host: str = "") -> bool:
        """May a segment keep its offset ledger and continue
        mid-partition? True by default: MOFs are immutable files."""
        return True

    def generation(self, host: str = "") -> Optional[int]:
        """The supplier's restart generation for ``host``, or None when the
        transport has none. A checkpoint's ledger recorded under another
        generation is dropped on resume (its run files are kept)."""
        return None

    def stop(self) -> None:
        pass


class LocalFetchClient(InputClient):
    """Single-host client: fetches straight from a DataEngine."""

    def __init__(self, engine: DataEngine):
        self.engine = engine

    def start_fetch(self, req: ShuffleRequest, on_complete) -> None:
        fut = self.engine.submit(req)

        def _done(f):
            err = f.exception()
            on_complete(err if err is not None else f.result())

        fut.add_done_callback(_done)

    def estimate_partition_bytes(self, job_id: str, map_ids,
                                 reduce_id: int):
        """Sum of raw_length over the map outputs. Exact or unknown: any
        unresolvable map makes the whole estimate None (a partial sum is a
        lower bound, which could steer the auto policy onto the
        host-resident path for a partition that is really huge)."""
        total = 0
        for mid in map_ids:
            try:
                total += int(self.engine.resolver.resolve(
                    job_id, mid, reduce_id).raw_length)
            except Exception as e:  # noqa: BLE001 - exact-or-unknown
                metrics.add("errors.swallowed")
                log.debug(f"size estimate: {mid} unresolvable ({e}); "
                          f"partition size unknown")
                return None
        return total


class Segment:
    """One partition's record stream, fetched chunk-wise with a carry
    buffer for records split across chunk boundaries.

    Drives ``chunk_size``-byte fetches at increasing offsets until the
    last chunk has arrived (the reference's send_request / switch_mem
    loop, StreamRW.cc:462-590), one fetch outstanding at a time. Completed
    chunks are cracked into RecordBatches immediately. A transport error
    restarts the whole segment from offset 0 while retries are left
    (``RetryPolicy``); every attempt has its own epoch, so a completion
    that arrives after its attempt timed out is dropped as stale."""

    _PENDING = object()  # sentinel: no inline completion delivered

    def __init__(self, client: InputClient, job_id: str, map_id: str,
                 reduce_id: int, chunk_size: int, host: str = "",
                 retries: int = 3, policy: Optional[RetryPolicy] = None):
        self.client = client
        self.job_id = job_id
        self.map_id = map_id
        self.reduce_id = reduce_id
        self.chunk_size = chunk_size
        self.host = host
        self.batches: list[RecordBatch] = []
        self.num_records = 0
        self.raw_length: Optional[int] = None
        self.on_done = None   # callback fired once when the fetch finishes
        self.on_fault = None  # callback fired on EVERY transport fault
        self.policy = policy or RetryPolicy(retries=max(0, retries))
        self._released = False
        self._carry = b""
        self._next_offset = 0
        self._retries_left = max(0, self.policy.retries)
        self._deadline: Optional[float] = None
        self._crc_refetched: set[int] = set()  # offsets re-fetched once
        self._rng = random.Random((self.policy.seed or 0)
                                  ^ zlib.crc32(map_id.encode()))
        self._issuing = False
        self._inline = self._PENDING
        self._epoch = 0          # id of the outstanding attempt
        self._epoch_settled = True
        self._resume_check = False   # next chunk must revalidate identity
        self._timeout_timer: Optional[threading.Timer] = None
        self._done = threading.Event()
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()

    @property
    def supplier(self) -> str:
        """The metric/penalty label of the source (host when routed per
        host, else the map id)."""
        return self.host or self.map_id

    def _finish(self, error: Optional[Exception]) -> bool:
        """The only terminal transition: the first caller wins, so on_done
        fires exactly once."""
        with self._lock:
            if self._done.is_set():
                return False
            self._error = error
            self._done.set()
        cb = self.on_done
        if cb is not None:
            cb(self)
        return True

    # -- fetch driving ------------------------------------------------------

    def start(self) -> None:
        if self.policy.deadline_ms > 0:
            self._deadline = time.monotonic() + self.policy.deadline_ms / 1e3
        with self._lock:
            resume_at = self._next_offset
        if resume_at > 0:
            # a checkpointed offset ledger (ckpt_preload): the bytes below
            # the offset are never refetched, and the first chunk checks
            # the partition's identity
            metrics.add("fetch.resumed", supplier=self.supplier)
            metrics.add("fetch.resumed.bytes", resume_at)
            log.info(f"fetch of {self.map_id} resuming at offset "
                     f"{resume_at} from a checkpointed ledger")
        self._drive(self._try_issue(resume_at))

    def _try_issue(self, offset: int):
        """Issue one fetch. Returns None when the transport took it
        asynchronously, or the RESULT (FetchResult or Exception) when the
        transport raised or completed inline — the caller's _drive loop
        then processes it without recursing."""
        with self._lock:
            if self._done.is_set():
                # failed administratively (fail()) while a retry backoff
                # was pending: issuing would open an attempt on a
                # finished segment
                return None
            self._inline = self._PENDING
            self._issuing = True
            self._epoch += 1
            self._epoch_settled = False
            epoch = self._epoch
        req = ShuffleRequest(self.job_id, self.map_id, self.reduce_id,
                             offset, self.chunk_size, host=self.host)
        try:
            # inside the try: an injected raise takes the path of a
            # transport that fails synchronously
            failpoint("segment.fetch", key=f"{self.map_id}@{self.host}")
            self.client.start_fetch(
                req, lambda res, e=epoch: self._on_complete(res, e))
        except Exception as e:  # noqa: BLE001 - a sync raise fails the
            # attempt; it must never escape into the transport's thread
            with self._lock:
                self._issuing = False
                if epoch == self._epoch:
                    self._epoch_settled = True
            return e
        with self._lock:
            self._issuing = False
            r = self._inline
            self._inline = self._PENDING
            if r is self._PENDING and not self._epoch_settled:
                self._arm_timeout(epoch)
        return None if r is self._PENDING else r

    def _arm_timeout(self, epoch: int) -> None:
        """Arm the per-attempt timeout (caller holds self._lock)."""
        timeout = self.policy.attempt_timeout_ms
        if timeout <= 0:
            return
        t = threading.Timer(timeout / 1e3, self._on_timeout, args=(epoch,))
        t.daemon = True
        self._timeout_timer = t
        t.start()

    def _cancel_timeout(self) -> None:
        with self._lock:
            t, self._timeout_timer = self._timeout_timer, None
        if t is not None:
            t.cancel()

    def _on_timeout(self, epoch: int) -> None:
        with self._lock:
            if epoch != self._epoch or self._epoch_settled:
                return  # the attempt completed first
        metrics.add("fetch.timeouts", supplier=self.supplier)
        self._on_complete(TransportError(
            f"fetch of {self.map_id} attempt timed out after "
            f"{self.policy.attempt_timeout_ms:g} ms"), epoch)

    def _on_complete(self, result, epoch: int) -> None:
        with self._lock:
            if self._epoch_settled or epoch != self._epoch:
                metrics.add("fetch.stale_completions")
                return  # superseded attempt (timed out or failed)
            self._epoch_settled = True
            inline = self._issuing
            if inline:  # inline completion: hand back to _drive
                self._inline = result
        if inline:
            return
        self._cancel_timeout()
        self._drive(result)

    def _notify_fault(self, exc: Exception) -> None:
        """Fire the on_fault hook (penalty-box feedback); its own errors
        are logged and swallowed."""
        hook = self.on_fault
        if hook is not None:
            try:
                hook(self, exc)
            except Exception as e:  # noqa: BLE001
                log.warn(f"on_fault hook failed for {self.map_id}: {e}")

    def _drive(self, result) -> None:
        """Iterative fetch state machine (one outstanding fetch at a time;
        runs on whichever thread delivered the completion)."""
        while result is not None:
            if isinstance(result, TenantError):
                # the service plane's refusal is terminal: no retry can
                # make a fenced epoch legal
                self._notify_fault(result)
                self._finish(result)
                return
            if isinstance(result, Exception):
                # transport-level retry: restart the WHOLE segment from
                # offset 0 (re-fetch-the-MOF granularity)
                deadline_hit = False
                with self._lock:
                    if self._done.is_set():
                        # failed administratively (fail()) while this
                        # attempt was in flight: no retry into a dead task
                        return
                    retry = self._retries_left > 0
                    if retry and self._deadline is not None \
                            and time.monotonic() >= self._deadline:
                        retry, deadline_hit = False, True
                    if retry:
                        self._retries_left -= 1
                        self.batches = []
                        self.num_records = 0
                        self._carry = b""
                        self._next_offset = 0
                        self._crc_refetched.clear()
                        self._resume_check = False
                    attempt = self.policy.retries - self._retries_left
                self._notify_fault(result)
                if not retry:
                    if deadline_hit:
                        metrics.add("fetch.deadline_exceeded")
                        log.warn(f"fetch of {self.map_id} gave up: "
                                 f"deadline passed with retries left")
                    self._finish(result)
                    return
                log.warn(f"fetch of {self.map_id} failed ({result}); "
                         f"retrying ({self._retries_left} left)")
                metrics.add("fetch.retries", supplier=self.supplier)
                delay = self.policy.backoff(attempt, self._rng)
                if self._deadline is not None:
                    delay = min(delay,
                                max(0.0, self._deadline - time.monotonic()))
                if delay > 0:
                    # back off without blocking the completion thread
                    metrics.add("fetch.backoff_seconds", delay)
                    t = threading.Timer(
                        delay, lambda: self._drive(self._try_issue(0)))
                    t.daemon = True
                    t.start()
                    return
                result = self._try_issue(0)
                continue
            if self._resume_check:
                # the first chunk after a checkpointed ledger: the
                # partition must be the one the ledger was built from,
                # else the StorageError restarts the fetch from zero
                with self._lock:
                    prev = self.raw_length
                    self._resume_check = False
                if prev is not None and result.raw_length != prev:
                    metrics.add("fetch.resume.invalidated")
                    result = StorageError(
                        f"partition {self.map_id} changed identity "
                        f"across the supplier restart (raw_length "
                        f"{result.raw_length} != {prev}); restarting "
                        f"the fetch from zero")
                    continue
            crc = getattr(result, "crc", None)
            if crc is not None and \
                    zlib.crc32(result.data) & 0xFFFFFFFF != crc:
                # integrity layer (uda.tpu.fetch.crc): one re-fetch per
                # offset; a second mismatch at the same offset becomes a
                # transport-level error and consumes the retry budget
                metrics.add("fetch.crc_mismatch")
                off = result.offset
                if off not in self._crc_refetched:
                    self._crc_refetched.add(off)
                    metrics.add("fetch.crc_refetch")
                    log.warn(f"chunk CRC mismatch at {self.map_id}:{off}; "
                             f"re-fetching once")
                    result = self._try_issue(off)
                    continue
                result = StorageError(
                    f"chunk CRC mismatch at {self.map_id}:{off} persists "
                    f"after re-fetch")
                continue
            try:
                last = self._ingest(result)
            except Exception as e:  # noqa: BLE001 - crack errors surface
                self._finish(e)     # to the waiter
                return
            if last:
                self._finish(None)
                return
            result = self._try_issue(self._next_offset)

    def _ingest(self, res: FetchResult) -> bool:
        """Absorb one chunk; returns True when the segment is complete."""
        with self._lock:
            self.raw_length = res.raw_length
            data = self._carry + res.data
            last = res.is_last
            if last and not data:
                self._carry = b""  # a legitimately empty partition
            else:
                # crack up to the last complete record; keep the tail
                batch, consumed, _ = crack_partial(data, expect_eof=last)
                if batch.num_records:
                    self.batches.append(batch)
                    self.num_records += batch.num_records
                self._carry = data[consumed:] if not last else b""
                self._next_offset = res.offset + len(res.data)
        metrics.add("fetch.bytes", len(res.data), supplier=self.supplier)
        metrics.add("fetch.chunks", supplier=self.supplier)
        return last

    def fail(self, exc: Exception) -> bool:
        """Administratively end the fetch (the watchdog's rescue, the stop
        path's drain): the segment completes now with ``exc`` and every
        waiter wakes. The outstanding attempt's epoch is invalidated, so a
        completion that arrives later is dropped as stale. Returns False
        when the segment had already finished. Fires on_done exactly once
        like every other terminal path."""
        with self._lock:
            if self._done.is_set():
                return False
            self._epoch += 1          # outstanding completions -> stale
            self._epoch_settled = True
        self._cancel_timeout()
        attribute_supplier(exc, self.supplier)
        if not self._finish(exc):
            return False  # a real terminal path won the race
        metrics.add("fetch.failed_admin")
        return True

    # -- consumption --------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._done.wait(timeout=timeout):
            raise MergeError(f"segment {self.map_id} fetch timed out")
        if self._error is not None:
            raise self._error

    @property
    def ready(self) -> bool:
        return self._done.is_set() and self._error is None

    def record_batch(self) -> RecordBatch:
        """All records of the partition as one batch (fetch must be done);
        the concatenation is cached."""
        self.wait()
        with self._lock:
            if self._released:
                raise MergeError(
                    f"segment {self.map_id} bytes were released "
                    f"(streaming mode spooled them to a sorted run)")
            if len(self.batches) == 1:
                return self.batches[0]
            cat = RecordBatch.concat(self.batches)
            self.batches = [cat]
            return cat

    def release(self) -> None:
        """Drop the fetched bytes (streaming mode: the sorted run file is
        now the source of truth; ``num_records`` survives for
        accounting). record_batch() raises after this."""
        with self._lock:
            self.batches = []
            self._released = True

    # -- checkpoint (merger/checkpoint.py) ----------------------------------

    def ckpt_export(self) -> Optional[dict]:
        """This segment's fetch offset ledger for a checkpoint manifest:
        the cracked batches framed (IFile framing, no EOF; a cracked
        chunk's own bytes) plus the carry tail, with the offsets that make
        it resumable. None when there is nothing worth keeping: the
        segment is done or released (its run file carries the records),
        or has fetched nothing yet. State is copied under the segment
        lock, framed outside it."""
        with self._lock:
            if self._done.is_set() or self._released \
                    or self._next_offset <= 0:
                return None
            batches = list(self.batches)
            carry = self._carry
            state = {"next_offset": self._next_offset,
                     "raw_length": self.raw_length,
                     "num_records": self.num_records,
                     "carry_len": len(carry)}
        framed = b"".join(framed_records(b) for b in batches)
        state["data"] = framed + bytes(carry)
        return state

    def ckpt_preload(self, *, data: bytes, carry_len: int,
                     next_offset: int, raw_length, num_records: int) -> None:
        """Restore a checkpointed offset ledger before start(): re-crack
        the framed bytes, check they hold exactly the recorded records,
        and arm the resume (start() then issues at ``next_offset``, and
        the first chunk checks the partition's identity). Raises
        :class:`StorageError` on any mismatch; the caller then drops the
        ledger and the segment fetches from zero."""
        framed_len = len(data) - int(carry_len)
        if framed_len < 0:
            raise StorageError(
                f"checkpoint ledger of {self.map_id}: carry "
                f"{carry_len} B exceeds payload {len(data)} B")
        batch, consumed, _ = crack_partial(bytes(data[:framed_len]),
                                           expect_eof=False)
        if consumed != framed_len or batch.num_records != int(num_records):
            raise StorageError(
                f"checkpoint ledger of {self.map_id} re-cracked to "
                f"{batch.num_records} records/{consumed} B, manifest "
                f"says {num_records}/{framed_len}")
        with self._lock:
            if self._epoch:
                raise StorageError(
                    f"ckpt_preload of {self.map_id} after start()")
            self.batches = [batch] if batch.num_records else []
            self.num_records = int(num_records)
            self._carry = bytes(data[framed_len:])
            self._next_offset = int(next_offset)
            self.raw_length = (int(raw_length) if raw_length is not None
                               else None)
            self._resume_check = True  # first chunk revalidates identity
