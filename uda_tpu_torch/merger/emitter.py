"""Framed emission: sorted records -> consumer blocks via the staging
arena.

The port's copy of ``uda_tpu/merger/emitter.py``, with its own pure-Python
``frame_batch`` and ``iter_framed_chunks`` (the reference's live in
``uda_tpu/native/__init__.py:235-279``, beside its C++ framer). The one
place that implements the dataFromUda hand-off contract (reference
src/Merger/MergeManager.cc:155-182 + UdaPlugin.java:368-402): records are
IFile-framed into staging buffers of at most the configured block size
and handed to the consumer one filled block at a time, the final block
carrying the EOF marker.

The staging buffers come from a 2-slot BufferArena — the reference's
2 x 1 MB KV staging pool (NETLEV_KV_POOL_EXPO, src/include/NetlevComm.h:33).
The consumer receives a read-only memoryview of the slot, valid only for
the duration of the call.
"""

from __future__ import annotations

import io
from typing import Callable, Iterable, Iterator, Optional, Tuple

from uda_tpu_torch.merger.arena import BufferArena
from uda_tpu_torch.utils import vint
from uda_tpu_torch.utils.ifile import EOF_MARKER, IFileWriter, RecordBatch
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["FramedEmitter", "frame_batch", "iter_framed_chunks",
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


def iter_framed_chunks(batch: RecordBatch, chunk_records: int = 1 << 16,
                       write_eof: bool = True) -> Iterator[bytes]:
    """Frame a RecordBatch in bounded chunks: yields IFile byte pieces
    whose concatenation equals ``frame_batch(batch)``."""
    n = batch.num_records
    for start in range(0, n, max(1, chunk_records)):
        stop = min(start + chunk_records, n)
        sub = RecordBatch(batch.data, batch.key_off[start:stop],
                          batch.key_len[start:stop],
                          batch.val_off[start:stop],
                          batch.val_len[start:stop])
        yield frame_batch(sub, write_eof=False)
    if write_eof:
        yield EOF_MARKER


class FramedEmitter:
    """Reusable emitter bound to one arena + block size."""

    def __init__(self, block_size: int,
                 arena: Optional[BufferArena] = None):
        self.block_size = block_size
        self.arena = arena or BufferArena(NUM_STAGE_BUFFERS, block_size)

    def _deliver(self, piece: bytes, held: list,
                 consumer: Callable[[memoryview], None]) -> int:
        """Hand one <= block_size piece to the consumer through an arena
        slot, releasing the previous slot one call late (double-buffer:
        a pipelined consumer may still hold the prior block)."""
        slot = self.arena.acquire()
        held.append(slot)
        slot.write(piece)
        if len(held) > 1:
            self.arena.release(held.pop(0))
        with metrics.timer("emit"):
            consumer(slot.view().data.toreadonly())
        return len(piece)

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
            block = out.getvalue()
            out.seek(0)
            out.truncate()
            # a single oversized record may exceed the block size
            for start in range(0, len(block), self.block_size):
                total += self._deliver(block[start:start + self.block_size],
                                       held, consumer)

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
        record-aligned). A consumer exception must not strand slots: the
        arena lives as long as the task."""
        total = 0
        held: list = []
        buf = bytearray()
        try:
            for piece in pieces:
                buf += piece
                while len(buf) >= self.block_size:
                    total += self._deliver(bytes(buf[:self.block_size]),
                                           held, consumer)
                    del buf[:self.block_size]
            while buf:
                total += self._deliver(bytes(buf[:self.block_size]),
                                       held, consumer)
                del buf[:self.block_size]
        finally:
            for slot in held:
                self.arena.release(slot)
        metrics.add("emit.bytes", total)
        return total

    def emit_batch(self, batch: RecordBatch,
                   consumer: Callable[[memoryview], None]) -> int:
        """Bulk emission of a RecordBatch: records framed in chunk passes
        (:func:`iter_framed_chunks`), streamed through emit_framed."""
        return self.emit_framed(
            iter_framed_chunks(batch, FRAME_CHUNK_RECORDS, write_eof=True),
            consumer)
