"""Staging buffer arena: the mem_desc slot state machine.

The port's copy of ``uda_tpu/merger/arena.py``: the reference's registered
memory pools (reference src/DataNet/RDMAClient.cc:437-496) with their
per-buffer state machine ``mem_desc_t`` {INIT, FETCH_READY, MERGE_READY,
BUSY} (src/Merger/MergeQueue.h:37-115), here over host staging buffers with
the same bounded-slot backpressure. It backs the 2-slot framed-emission
double buffer (``merger/emitter.py``, the reference's 2 x 1 MB KV staging
pool). The wait for a free slot is the ``wait_mem`` timer (the reference's
total_wait_mem_time, reducer.h:80-90); slots in use are the paired gauge
``arena.slots_in_use``; an acquire that waits past ``pressure_after_s``
fires the soft-pressure hook once and counts ``arena.pressure_events``.
"""

from __future__ import annotations

import enum
import time
from typing import Callable, Optional

import numpy as np

from uda_tpu_torch.utils.errors import MergeError
from uda_tpu_torch.utils.locks import TrackedCondition, TrackedLock
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

log = get_logger()

__all__ = ["SlotState", "BufferSlot", "BufferArena"]


class SlotState(enum.Enum):
    # reference MergeQueue.h:44-49
    INIT = 0
    FETCH_READY = 1   # being filled by a fetch
    MERGE_READY = 2   # filled, ready for the merger
    BUSY = 3          # being consumed by the merger


class BufferSlot:
    """One staging buffer with its state + fill bookkeeping."""

    __slots__ = ("buf", "state", "length", "owner")

    def __init__(self, size: int):
        self.buf = np.empty(size, np.uint8)
        self.state = SlotState.INIT
        self.length = 0       # valid bytes
        self.owner = None     # segment currently holding the slot

    @property
    def size(self) -> int:
        return int(self.buf.shape[0])

    def write(self, data: bytes, offset: int = 0) -> None:
        end = offset + len(data)
        if end > self.size:
            raise MergeError(f"slot overflow: {end} > {self.size}")
        self.buf[offset:end] = np.frombuffer(data, np.uint8)
        self.length = end

    def view(self) -> np.ndarray:
        return self.buf[: self.length]


class BufferArena:
    """Fixed population of slots with blocking acquire (backpressure).

    ``acquire`` blocks until a slot is free, accumulating the wait in the
    ``wait_mem_time`` metric (reference total_wait_mem_time,
    reducer.h:84). Slots are sized once at construction like the
    reference page-aligns and validates its buffer size at INIT
    (reducer.cc:100-133).
    """

    def __init__(self, num_slots: int, slot_size: int,
                 on_pressure: Optional[Callable[[float], None]] = None,
                 pressure_after_s: float = 1.0):
        if num_slots <= 0 or slot_size <= 0:
            raise MergeError("arena needs positive slot count and size")
        self.slot_size = slot_size
        self._free: list[BufferSlot] = [BufferSlot(slot_size)
                                        for _ in range(num_slots)]
        # lockdep-tracked (utils/locks.py, UDA_TPU_LOCKDEP=1): the
        # arena cv is where the reference's wait-for-mem blocked, the
        # canonical seat of a lost-wakeup/inversion deadlock
        self._lock = TrackedLock("arena")
        self._cv = TrackedCondition(self._lock)
        self.num_slots = num_slots
        # soft-pressure hook: an acquire that waits past the threshold
        # reports the exhaustion ONCE per acquire (uda.tpu.arena.
        # pressure.s) — the signal a budget/stats layer uses to observe
        # "free slots stay exhausted" without ever blocking the arena
        self.on_pressure = on_pressure
        self.pressure_after_s = max(0.0, pressure_after_s)

    def acquire(self, owner=None, timeout: Optional[float] = None) -> BufferSlot:
        """Block until a slot frees. ``timeout`` is a TOTAL monotonic
        deadline across every wakeup — a notify/spurious wakeup that
        finds the free list empty resumes the SAME deadline instead of
        restarting the clock (the pre-fix bug: each loop iteration
        re-waited the full timeout, so a caller racing busy releasers
        could wait far longer than requested)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        t0 = time.monotonic()
        pressured = False
        with metrics.timer("wait_mem"):
            with self._cv:
                while not self._free:
                    now = time.monotonic()
                    remaining = (None if deadline is None
                                 else deadline - now)
                    if remaining is not None and remaining <= 0:
                        raise MergeError(
                            f"timed out waiting for a staging slot "
                            f"({timeout:g} s total deadline)")
                    wait_s = remaining
                    if (not pressured and self.on_pressure is not None):
                        to_pressure = self.pressure_after_s - (now - t0)
                        if to_pressure <= 0:
                            pressured = True
                            # drop the lock around the hook: a callback
                            # that reads arena state (free_slots) would
                            # otherwise self-deadlock
                            self._cv.release()
                            try:
                                self._pressure(now - t0)
                            finally:
                                self._cv.acquire()
                            continue
                        wait_s = (to_pressure if wait_s is None
                                  else min(wait_s, to_pressure))
                    self._cv.wait(timeout=wait_s)
                slot = self._free.pop()
        metrics.gauge_add("arena.slots_in_use", 1)
        slot.state = SlotState.FETCH_READY
        slot.length = 0
        slot.owner = owner
        return slot

    def _pressure(self, waited_s: float) -> None:
        """Fire the soft-pressure callback (caller holds the lock; the
        hook must be cheap and non-blocking — it is observability, not
        control flow, and its errors never fail the acquire)."""
        metrics.add("arena.pressure_events")
        try:
            self.on_pressure(waited_s)
        except Exception as e:  # noqa: BLE001
            log.warn(f"arena pressure callback failed: {e}")

    def try_acquire(self, owner=None) -> Optional[BufferSlot]:
        with self._cv:
            if not self._free:
                return None
            slot = self._free.pop()
        # the +1 rides the returned slot: whoever holds a BufferSlot
        # owns the -1 via release() (acquire() is the same contract;
        # it is exempted as the pair's own implementation name)
        metrics.gauge_add("arena.slots_in_use", 1)  # udalint: disable=UDA101
        slot.state = SlotState.FETCH_READY
        slot.length = 0
        slot.owner = owner
        return slot

    def release(self, slot: BufferSlot) -> None:
        metrics.gauge_add("arena.slots_in_use", -1)
        slot.state = SlotState.INIT
        slot.owner = None
        slot.length = 0
        with self._cv:
            self._free.append(slot)
            self._cv.notify()

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)
