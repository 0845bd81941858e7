"""Segments: streaming views of one map-output partition.

The port's copy of ``uda_tpu/merger/segment.py``: the transport
abstraction, the in-process client and the chunked fetch with
partial-record carry, attempt timeouts, CRC re-fetch and whole-segment
retry. The reference's host-routing client, its survivable-shuffle
rungs (speculative fetch, mid-partition resume, k-of-n reconstruction)
and its administrative ``fail()`` (the watchdog's and ``stop()``'s
rescue) are not ported yet.

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
from uda_tpu_torch.utils.errors import (MergeError, StorageError,
                                        TransportError)
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
        self._drive(self._try_issue(0))

    def _try_issue(self, offset: int):
        """Issue one fetch. Returns None when the transport took it
        asynchronously, or the RESULT (FetchResult or Exception) when the
        transport raised or completed inline — the caller's _drive loop
        then processes it without recursing."""
        with self._lock:
            self._inline = self._PENDING
            self._issuing = True
            self._epoch += 1
            self._epoch_settled = False
            epoch = self._epoch
        req = ShuffleRequest(self.job_id, self.map_id, self.reduce_id,
                             offset, self.chunk_size, host=self.host)
        try:
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
            if isinstance(result, Exception):
                # transport-level retry: restart the WHOLE segment from
                # offset 0 (re-fetch-the-MOF granularity)
                deadline_hit = False
                with self._lock:
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
