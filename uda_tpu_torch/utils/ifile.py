"""IFile record streams: Hadoop map-output segment format.

The port's copy of ``uda_tpu/utils/ifile.py``. As in the reference, a
buffer of 4 KiB or more is cracked by the native host runtime
(``uda_tpu_torch/native``) while ``uda.tpu.use.native`` is on
(``set_native_enabled``); the pure-Python form below is the plain version
it is held to, and the one taken with the switch off. Byte-exact implementation of the record framing the
reference reads and writes (reference src/Merger/StreamRW.cc): each record
is ``VInt(keyLen) VInt(valLen) key value``; end-of-stream is the marker
pair ``(-1, -1)`` (two 0xFF bytes).

Two access styles:

- streaming reader/writer (``IFileReader``/``IFileWriter``) matching the
  reference's record-at-a-time iterators;
- bulk *columnar cracking* (``crack``, ``crack_partial``): one pass
  converts a segment buffer into offset/length arrays over the raw
  bytes, the host-side preparation for packing keys into device columns.

As in the reference, an optional CRC32 trailer (``IFileWriter(with_crc=
True)``, ``crack(verify_crc=True)``) covers every record and the EOF
marker, 4 bytes big-endian after the marker.
"""

from __future__ import annotations

import dataclasses
import io
import zlib
from typing import BinaryIO, Iterable, Iterator, Optional, Tuple

import numpy as np

from uda_tpu_torch.utils import vint
from uda_tpu_torch.utils.errors import StorageError

__all__ = ["IFileWriter", "IFileReader", "RecordBatch", "crack",
           "crack_partial", "iter_file_records", "write_records",
           "set_native_enabled", "native_enabled", "EOF_MARKER"]

EOF_MARKER = b"\xff\xff"  # VInt(-1) VInt(-1)

# native codec dispatch: the C++ library (uda_tpu_torch/native) takes over
# the bulk scan for buffers past this size
_NATIVE_THRESHOLD = 4096
_native_enabled = True


def set_native_enabled(enabled: bool) -> None:
    """Toggle the native host runtime process-wide (the
    ``uda.tpu.use.native`` flag's hook)."""
    global _native_enabled
    _native_enabled = enabled


def native_enabled() -> bool:
    """Whether native dispatch is on (the switch's state; says nothing
    about whether the library is built)."""
    return _native_enabled


def _native_mod():
    """The native module while the switch is on (built at first use; a
    build failure raises), else None."""
    if not _native_enabled:
        return None
    from uda_tpu_torch import native

    native.build()
    return native


class IFileWriter:
    """Sequential record writer with EOF marker on close.

    Mirrors ``write_kv_to_stream`` framing (reference StreamRW.cc:151-225).
    """

    def __init__(self, out: BinaryIO, with_crc: bool = False):
        self._out = out
        self._crc = zlib.crc32(b"") if with_crc else None
        self.records = 0
        self.bytes_written = 0
        self._closed = False

    def append(self, key: bytes, value: bytes) -> None:
        rec = (vint.encode_vlong(len(key)) + vint.encode_vlong(len(value))
               + key + value)
        self._out.write(rec)
        if self._crc is not None:
            self._crc = zlib.crc32(rec, self._crc)
        self.records += 1
        self.bytes_written += len(rec)

    def close(self) -> None:
        if self._closed:
            return
        self._out.write(EOF_MARKER)
        self.bytes_written += len(EOF_MARKER)
        if self._crc is not None:
            self._crc = zlib.crc32(EOF_MARKER, self._crc)
            self._out.write(self._crc.to_bytes(4, "big"))
            self.bytes_written += 4
        self._closed = True

    def __enter__(self) -> "IFileWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class IFileReader:
    """Record-at-a-time reader (reference BaseSegment::nextKV semantics,
    StreamRW.cc:334-449): yields (key, value) until the EOF marker."""

    def __init__(self, src: BinaryIO):
        self._buf = src.read()
        self._pos = 0

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        buf = self._buf
        pos = self._pos
        while True:
            try:
                klen, pos = vint.decode_vlong(buf, pos)
                vlen, pos = vint.decode_vlong(buf, pos)
            except IndexError as e:
                raise StorageError(f"truncated IFile stream at offset {pos}: {e}") from e
            if klen == -1 and vlen == -1:
                return
            if klen < 0 or vlen < 0:
                raise StorageError(f"corrupt IFile record lengths {klen}/{vlen}")
            key = buf[pos:pos + klen]
            pos += klen
            val = buf[pos:pos + vlen]
            pos += vlen
            if len(key) != klen or len(val) != vlen:
                raise StorageError("truncated IFile record")
            yield bytes(key), bytes(val)


@dataclasses.dataclass
class RecordBatch:
    """Columnar view of one segment: raw bytes + per-record offsets.

    ``data`` holds the segment bytes; keys/values are addressed by
    (offset, length) int64 arrays. This is the host-side currency between
    the supplier, the merge and the emitter.
    """

    data: np.ndarray        # uint8, the full segment buffer (records are
                            # addressed by offset; any EOF marker / CRC
                            # trailer bytes at the tail are never addressed)
    key_off: np.ndarray     # int64 [n]
    key_len: np.ndarray     # int64 [n]
    val_off: np.ndarray     # int64 [n]
    val_len: np.ndarray     # int64 [n]

    @property
    def num_records(self) -> int:
        return int(self.key_off.shape[0])

    def key(self, i: int) -> bytes:
        o, n = int(self.key_off[i]), int(self.key_len[i])
        return self.data[o:o + n].tobytes()

    def value(self, i: int) -> bytes:
        o, n = int(self.val_off[i]), int(self.val_len[i])
        return self.data[o:o + n].tobytes()

    def iter_records(self) -> Iterator[Tuple[bytes, bytes]]:
        for i in range(self.num_records):
            yield self.key(i), self.value(i)

    def take(self, order: np.ndarray) -> "RecordBatch":
        """Reorder records (materializes a device-computed sort
        permutation back into record order)."""
        return RecordBatch(self.data, self.key_off[order], self.key_len[order],
                           self.val_off[order], self.val_len[order])

    @staticmethod
    def concat(batches: list["RecordBatch"]) -> "RecordBatch":
        """Concatenate batches into one (rebases offsets into one buffer)."""
        if not batches:
            return RecordBatch(np.zeros(0, np.uint8), *([np.zeros(0, np.int64)] * 4))
        datas, kos, kls, vos, vls = [], [], [], [], []
        base = 0
        for b in batches:
            datas.append(b.data)
            kos.append(b.key_off + base)
            kls.append(b.key_len)
            vos.append(b.val_off + base)
            vls.append(b.val_len)
            base += len(b.data)
        return RecordBatch(np.concatenate(datas), np.concatenate(kos),
                           np.concatenate(kls), np.concatenate(vos),
                           np.concatenate(vls))


def _vlong_at(mem, pos: int) -> tuple[int, int]:
    """One VLong at ``pos``: the one-byte non-negative form inline (every
    length under 128), the rest through :func:`vint.decode_vlong`."""
    first = mem[pos]
    if first < 128:
        return first, pos + 1
    return vint.decode_vlong(mem, pos)


def _batch(arr: np.ndarray, key_off, key_len, val_off, val_len
           ) -> RecordBatch:
    return RecordBatch(arr, np.asarray(key_off, dtype=np.int64),
                       np.asarray(key_len, dtype=np.int64),
                       np.asarray(val_off, dtype=np.int64),
                       np.asarray(val_len, dtype=np.int64))


def crack(buf: bytes | np.ndarray, expect_eof: bool = True,
          verify_crc: bool = False) -> RecordBatch:
    """One-pass columnar crack of an IFile segment buffer.

    Replaces per-record parsing in the merge hot loop (reference
    StreamRW.cc:334-449) with a single host pass producing offset/length
    columns. With ``verify_crc`` the 4 bytes after the EOF marker are
    checked as a big-endian CRC32 of everything before them (the trailer
    ``IFileWriter(with_crc=True)`` writes), after the native crack and the
    Python one alike.
    """
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    nat = _native_mod() if len(arr) >= _NATIVE_THRESHOLD else None
    if nat is not None:
        batch, consumed, saw = nat.crack_partial_native(arr)
        if expect_eof and not saw:
            raise StorageError("IFile segment missing EOF marker")
        if not saw and consumed != len(arr):
            raise StorageError(f"truncated IFile segment at offset {consumed}")
        if verify_crc:
            _check_crc_trailer(arr, consumed, saw)
        return batch
    mem = memoryview(arr)
    n = len(arr)
    key_off, key_len, val_off, val_len = [], [], [], []
    pos = 0
    saw_eof = False
    while pos < n:
        try:
            klen, p = _vlong_at(mem, pos)
            vlen, p = _vlong_at(mem, p)
        except IndexError as e:
            raise StorageError(f"truncated IFile segment at offset {pos}: {e}") from e
        if klen == -1 and vlen == -1:
            saw_eof = True
            pos = p
            break
        if klen < 0 or vlen < 0 or p + klen + vlen > n:
            raise StorageError(f"corrupt IFile segment at offset {pos}")
        key_off.append(p)
        key_len.append(klen)
        val_off.append(p + klen)
        val_len.append(vlen)
        pos = p + klen + vlen
    if expect_eof and not saw_eof:
        raise StorageError("IFile segment missing EOF marker")
    if verify_crc:
        _check_crc_trailer(arr, pos, saw_eof)
    return _batch(arr, key_off, key_len, val_off, val_len)


def _check_crc_trailer(arr: np.ndarray, pos: int, saw_eof: bool) -> None:
    """Verify the 4-byte big-endian CRC32 trailer after the EOF marker."""
    if not saw_eof or pos + 4 > len(arr):
        raise StorageError("IFile segment missing CRC trailer")
    mem = memoryview(arr)
    want = int.from_bytes(mem[pos:pos + 4], "big")
    got = zlib.crc32(mem[:pos])
    if want != got:
        raise StorageError(f"IFile CRC mismatch: trailer {want:#010x}, "
                           f"computed {got:#010x}")


def crack_partial(data: bytes, expect_eof: bool = False
                  ) -> Tuple[RecordBatch, int, bool]:
    """Crack the longest prefix of complete records; returns ``(batch,
    bytes_consumed, saw_eof)``.

    The incremental sibling of ``crack`` for chunked streams: a record
    split across a chunk boundary is left unconsumed so the caller can
    carry its bytes into the next chunk (the reference's temp_kv join
    across buffers, StreamRW.cc:542-590). With ``expect_eof`` the buffer
    must be a complete segment and everything is consumed.
    """
    if expect_eof:
        batch = crack(data, expect_eof=True)
        return batch, len(data), True
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    nat = _native_mod() if len(arr) >= _NATIVE_THRESHOLD else None
    if nat is not None:
        return nat.crack_partial_native(arr)
    mem = memoryview(arr)
    n = len(arr)
    key_off, key_len, val_off, val_len = [], [], [], []
    pos = 0
    saw_eof = False
    while pos < n:
        start = pos
        try:
            klen, p = _vlong_at(mem, pos)
            vlen, p = _vlong_at(mem, p)
        except IndexError:
            pos = start
            break
        if klen == -1 and vlen == -1:
            pos = p
            saw_eof = True
            break
        if klen < 0 or vlen < 0:
            raise StorageError(f"corrupt record framing at offset {start}")
        if p + klen + vlen > n:
            pos = start
            break
        key_off.append(p)
        key_len.append(klen)
        val_off.append(p + klen)
        val_len.append(vlen)
        pos = p + klen + vlen
    return _batch(arr, key_off, key_len, val_off, val_len), pos, saw_eof


def iter_file_records(path: str, buffer_size: int = 1 << 20
                      ) -> Iterator[Tuple[bytes, bytes]]:
    """Stream records from an IFile on disk with bounded memory: reads
    ``buffer_size`` chunks, cracks the complete records and carries the
    partial tail (the file-backed analogue of the reference's
    SuperSegment cursor, StreamRW.cc:813-861)."""
    carry = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(buffer_size)
            if not chunk:
                raise StorageError(f"IFile {path} missing EOF marker")
            data = carry + chunk
            batch, consumed, saw_eof = crack_partial(data)
            # slices of the bytes themselves: the records of
            # batch.key(i)/value(i) without a numpy slice each
            yield from ((data[ko:ko + kl], data[vo:vo + vl])
                        for ko, kl, vo, vl in zip(
                            batch.key_off.tolist(), batch.key_len.tolist(),
                            batch.val_off.tolist(), batch.val_len.tolist()))
            if saw_eof:
                return
            carry = data[consumed:]


def write_records(records: Iterable[Tuple[bytes, bytes]],
                  out: Optional[BinaryIO] = None) -> bytes:
    """Serialize records into IFile framing; returns the bytes when no
    stream is given (else ``b""``)."""
    stream = io.BytesIO() if out is None else out
    w = IFileWriter(stream)
    for k, v in records:
        w.append(k, v)
    w.close()
    return stream.getvalue() if out is None else b""
