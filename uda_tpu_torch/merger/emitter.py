"""Framed emission: sorted records -> consumer blocks via the staging
arena.

The port's copy of ``uda_tpu/merger/emitter.py``. ``emit_batch`` frames
through the native host runtime (``native.iter_framed_chunks``, one C pass
a chunk) while ``uda.tpu.use.native`` is on. The pure-Python
``frame_batch`` and ``iter_framed_chunks`` here are the plain versions the
C++ framer is held to, and ``native.frame_batch`` runs them with the
switch off. The one
place that implements the dataFromUda hand-off contract (reference
src/Merger/MergeManager.cc:155-182 + UdaPlugin.java:368-402): records are
IFile-framed into staging buffers of at most the configured block size
and handed to the consumer one filled block at a time, the final block
carrying the EOF marker.

The staging buffers come from a 2-slot BufferArena — the reference's
2 x 1 MB KV staging pool (NETLEV_KV_POOL_EXPO, src/include/NetlevComm.h:33).
The consumer receives a read-only memoryview of the slot, valid only for
the duration of the call.

Timers (``metrics.timer``; port-only, mapped by ``utils.critpath.
PORT_SPAN_BUCKETS``): ``emit_phase`` covers a whole delivery loop of
:meth:`FramedEmitter.emit` or :meth:`FramedEmitter.emit_framed`, the
pulls of the piece generator included, so the stages that generator
times (``emit_readback``, ``emit_gather``, ``emit_frame``) nest under
it; ``emit_deliver`` covers the port's own block handling (the arena
slot's acquire, the copy of framed bytes into it, the release) and the
reference's ``emit`` the consumer's call. No timer is held across a
``yield``, so the stages partition the phase.
"""

from __future__ import annotations

import io
from typing import Callable, Iterable, Iterator, Optional, Tuple

from uda_tpu_torch import native
from uda_tpu_torch.merger.arena import BufferArena, BufferSlot
from uda_tpu_torch.utils import vint
from uda_tpu_torch.utils.ifile import EOF_MARKER, IFileWriter, RecordBatch
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["FramedEmitter", "frame_batch", "emit_framed_records",
           "NUM_STAGE_BUFFERS"]

NUM_STAGE_BUFFERS = 2  # reference NUM_STAGE_MEM / 2x1MB kv pool

# records framed per pass in emit_batch: bounds the transient framed-bytes
# copy to a few MB regardless of merge size
FRAME_CHUNK_RECORDS = 1 << 16

def frame_batch(batch: RecordBatch, write_eof: bool = True) -> bytes:
    """A RecordBatch as IFile bytes, records in batch order (the framing
    of ``IFileWriter.append``, byte for byte), with the EOF marker when
    ``write_eof``. Key and value bytes are sliced out of the batch's
    buffer without a per-record copy (one slice where the value follows
    its key, as in every cracked batch); each (key length, value length)
    header is encoded once per call."""
    mem = memoryview(batch.data)
    headers: dict = {}
    parts = []
    put = parts.append
    for ko, kl, vo, vl in zip(batch.key_off.tolist(), batch.key_len.tolist(),
                              batch.val_off.tolist(), batch.val_len.tolist()):
        head = headers.get((kl, vl))
        if head is None:
            head = headers[(kl, vl)] = (vint.encode_vlong(kl)
                                        + vint.encode_vlong(vl))
        put(head)
        if vo == ko + kl:
            put(mem[ko:vo + vl])
        else:
            put(mem[ko:ko + kl])
            put(mem[vo:vo + vl])
    if write_eof:
        put(EOF_MARKER)
    return b"".join(parts)


class FramedEmitter:
    """Reusable emitter bound to one arena + block size."""

    def __init__(self, block_size: int,
                 arena: Optional[BufferArena] = None):
        self.block_size = block_size
        self.arena = arena or BufferArena(NUM_STAGE_BUFFERS, block_size)

    def _acquire(self, held: list) -> BufferSlot:
        """An empty arena slot to fill. The slot acquired before it,
        already handed to the consumer, is released here, one hand-over
        late (double-buffer: a pipelined consumer may still hold the prior
        block)."""
        slot = self.arena.acquire()
        held.append(slot)
        if len(held) > 1:
            self.arena.release(held.pop(0))
        return slot

    def _hand_over(self, slot: BufferSlot,
                   consumer: Callable[[memoryview], None]) -> int:
        """Hand a filled slot to the consumer as a read-only view, valid
        for the call only; returns its length."""
        with metrics.timer("emit"):
            consumer(slot.view().data.toreadonly())
        return slot.length

    def emit(self, records: Iterable[Tuple[bytes, bytes]],
             consumer: Callable[[memoryview], None]) -> int:
        """Frame ``records`` and stream them to ``consumer`` in blocks of
        at most the block size, the final one carrying the EOF marker;
        returns the bytes emitted."""
        out = io.BytesIO()
        writer = IFileWriter(out)
        total = 0
        held: list = []

        def flush() -> None:
            nonlocal total
            with metrics.timer("emit_deliver"):
                block = out.getvalue()
                out.seek(0)
                out.truncate()
            # a single oversized record may exceed the block size
            for start in range(0, len(block), self.block_size):
                with metrics.timer("emit_deliver"):
                    slot = self._acquire(held)
                    slot.write(block[start:start + self.block_size])
                total += self._hand_over(slot, consumer)

        with metrics.timer("emit_phase"):
            try:
                for key, value in records:
                    writer.append(key, value)
                    if out.tell() >= self.block_size:
                        flush()
                writer.close()
                if out.tell():
                    flush()
            finally:
                for slot in held:
                    self.arena.release(slot)
        metrics.add("emit.bytes", total)
        return total

    def emit_framed(self, pieces: Iterable[bytes],
                    consumer: Callable[[memoryview], None]) -> int:
        """Stream an already-framed record stream (``pieces`` concatenate
        to the complete IFile stream INCLUDING the EOF marker) to the
        consumer in exactly-block_size slices (blocks are not
        record-aligned). Each piece is copied straight into the arena slot
        being filled, across slots where it crosses a block boundary; a
        slot goes to the consumer once full, the last one partial. A
        consumer exception must not strand slots: the arena lives as long
        as the task."""
        total = 0
        held: list = []
        slot = None
        with metrics.timer("emit_phase"):
            try:
                for piece in pieces:
                    data = memoryview(piece).cast("B")
                    while data:
                        with metrics.timer("emit_deliver"):
                            if slot is None:
                                slot = self._acquire(held)
                            n = min(len(data), self.block_size - slot.length)
                            slot.write(data[:n], slot.length)
                            data = data[n:]
                        if slot.length == self.block_size:
                            total += self._hand_over(slot, consumer)
                            slot = None
                if slot is not None:
                    total += self._hand_over(slot, consumer)
            finally:
                for held_slot in held:
                    self.arena.release(held_slot)
        metrics.add("emit.bytes", total)
        return total

    def emit_batch(self, batch: RecordBatch,
                   consumer: Callable[[memoryview], None]) -> int:
        """Bulk emission of a RecordBatch: records framed in native chunk
        passes (``native.frame_batch``, the C++ twin of the reference's
        write_kv_to_stream loop, StreamRW.cc:151-225), streamed through
        emit_framed."""
        return self.emit_framed(
            _timed_pulls("emit_frame", native.iter_framed_chunks(
                batch, FRAME_CHUNK_RECORDS, write_eof=True)), consumer)


def _timed_pulls(name: str, pieces: Iterable[bytes]) -> Iterator[bytes]:
    """``pieces``, each pull timed under ``metrics.timer(name)``; the
    timer is closed before the piece is yielded."""
    it = iter(pieces)
    while True:
        with metrics.timer(name):
            piece = next(it, None)
        if piece is None:
            return
        yield piece


def emit_framed_records(records: Iterable[Tuple[bytes, bytes]],
                        block_size: int,
                        consumer: Callable[[memoryview], None]) -> int:
    """One-shot convenience wrapper of :meth:`FramedEmitter.emit`."""
    return FramedEmitter(block_size).emit(records, consumer)
