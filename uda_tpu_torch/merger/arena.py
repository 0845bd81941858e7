"""Staging buffer arena: a fixed pool of host slots with blocking acquire.

The port's copy of ``uda_tpu/merger/arena.py`` for the framed-emission
double buffer (the reference's 2 x 1 MB KV staging pool,
NETLEV_KV_POOL_EXPO, src/include/NetlevComm.h:33); its slot state machine
(``mem_desc_t``, src/Merger/MergeQueue.h:37-115), soft-pressure hook and
gauges serve paths not ported yet. The wait for a free slot is counted in
the ``wait_mem_time`` timer (the reference's total_wait_mem_time,
reducer.h:80-90).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from uda_tpu_torch.utils.errors import MergeError
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["BufferSlot", "BufferArena"]


class BufferSlot:
    """One staging buffer and its fill length."""

    __slots__ = ("buf", "length")

    def __init__(self, size: int):
        self.buf = np.empty(size, np.uint8)
        self.length = 0       # valid bytes

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
    Slots are sized once at construction, like the reference validates its
    buffer size at INIT (reducer.cc:100-133)."""

    def __init__(self, num_slots: int, slot_size: int):
        if num_slots <= 0 or slot_size <= 0:
            raise MergeError("arena needs positive slot count and size")
        self.slot_size = slot_size
        self._free: list[BufferSlot] = [BufferSlot(slot_size)
                                        for _ in range(num_slots)]
        self._cv = threading.Condition(threading.Lock())
        self.num_slots = num_slots

    def acquire(self, timeout: Optional[float] = None) -> BufferSlot:
        """Block until a slot frees. ``timeout`` is a total deadline across
        every wakeup."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with metrics.timer("wait_mem"):
            with self._cv:
                while not self._free:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise MergeError(
                            f"timed out waiting for a staging slot "
                            f"({timeout:g} s total deadline)")
                    self._cv.wait(timeout=remaining)
                slot = self._free.pop()
        slot.length = 0
        return slot

    def release(self, slot: BufferSlot) -> None:
        slot.length = 0
        with self._cv:
            self._free.append(slot)
            self._cv.notify()
