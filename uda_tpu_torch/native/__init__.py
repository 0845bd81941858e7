"""ctypes bindings for the port's native host runtime
(``libuda_tpu_native.so``).

The port's copy of ``uda_tpu/native/__init__.py``, over its own C++
(``uda_tpu_torch/csrc/codec.cc``, ``reader.cc``, ``merge.cc``, ``lzo.cc``
and ``vlong.h``, the reference's sources with the same C ABI). The library
is built by ``ops/_build_host.build_native`` with ``g++`` at first use,
never at import, into the build directory (``uda_tpu_torch/_build/`` or
``$UDA_TPU_COMPILE_CACHE``).

One deliberate difference from the reference: the reference warns and
falls back to pure Python when its library cannot be built. The port
raises instead, wherever ``uda.tpu.use.native`` is on (the process-wide
switch ``utils.ifile.set_native_enabled``); turning the switch off is the
one way onto the pure-Python forms, which give the same bytes.

Every call into the library adds one to :data:`calls` under the entry's
name, so a run can show that it went through the native runtime.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from typing import Optional

import numpy as np

from uda_tpu_torch.utils.errors import StorageError
from uda_tpu_torch.utils.ifile import EOF_MARKER, RecordBatch
from uda_tpu_torch.utils.logging import get_logger

__all__ = ["available", "build", "crack_native", "crack_partial_native",
           "decode_vlongs_native", "write_records_native", "frame_batch",
           "iter_framed_chunks", "ReadPool", "kway_supported",
           "kway_merge_paths", "gather_spans_native", "merge_rows_native",
           "merge_rows_native_into", "calls", "reset_calls"]

log = get_logger()

_lib = None
_build_error: Optional[BaseException] = None
_lib_lock = threading.RLock()

# C entry point -> calls since the last reset_calls()
calls: collections.Counter = collections.Counter()
_count_lock = threading.Lock()


def reset_calls() -> None:
    with _count_lock:
        calls.clear()


def _count(name: str) -> None:
    with _count_lock:
        calls[name] += 1


def _load():
    """The bound library, built first if needed. Raises the build's or
    the load's error (cached: a failed build is not retried per call)."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        from uda_tpu_torch.ops import _build_host

        try:
            path, secs = _build_host.build_native()
            lib = _bind(ctypes.CDLL(path))
        except (OSError, RuntimeError, AttributeError) as e:
            _build_error = RuntimeError(
                f"uda_tpu_torch: the native host runtime cannot be built or "
                f"loaded ({e}); set uda.tpu.use.native=false to run the "
                f"pure-Python forms")
            raise _build_error from e
        log.debug(f"native host runtime ready: {path} ({secs:.2f} s)")
        _lib = lib
        return lib


def _bind(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.uda_crack.restype = ctypes.c_int64
    lib.uda_crack.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p,
                              i64p, ctypes.c_int64, i64p,
                              ctypes.POINTER(ctypes.c_int32)]
    lib.uda_decode_vlongs.restype = ctypes.c_int64
    lib.uda_decode_vlongs.argtypes = [u8p, ctypes.c_int64, i64p,
                                      ctypes.c_int64]
    lib.uda_pool_create.restype = ctypes.c_void_p
    lib.uda_pool_create.argtypes = [ctypes.c_int]
    lib.uda_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.uda_pool_submit.restype = ctypes.c_int
    lib.uda_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_int64,
                                    u8p, ctypes.c_uint64]
    lib.uda_pool_get_events.restype = ctypes.c_int
    lib.uda_pool_get_events.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), i64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double]
    lib.uda_pool_backend.restype = ctypes.c_int
    lib.uda_pool_backend.argtypes = [ctypes.c_void_p]
    lib.uda_pool_submit_batch.restype = ctypes.c_int
    lib.uda_pool_submit_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        i64p, i64p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.uda_write_records.restype = ctypes.c_int64
    lib.uda_write_records.argtypes = [u8p, i64p, i64p, i64p, i64p,
                                      ctypes.c_int64, u8p,
                                      ctypes.c_int64, ctypes.c_int32]
    lib.uda_kway_create.restype = ctypes.c_void_p
    lib.uda_kway_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, i64p]
    lib.uda_kway_next_block.restype = ctypes.c_int64
    lib.uda_kway_next_block.argtypes = [ctypes.c_void_p, u8p,
                                        ctypes.c_int64, i64p]
    lib.uda_kway_destroy.argtypes = [ctypes.c_void_p]
    szp = ctypes.POINTER(ctypes.c_size_t)
    lib.uda_lzo1x_decompress_safe.restype = ctypes.c_int
    lib.uda_lzo1x_decompress_safe.argtypes = [u8p, ctypes.c_size_t,
                                              u8p, szp]
    lib.uda_lzo1x_1_compress.restype = ctypes.c_int
    lib.uda_lzo1x_1_compress.argtypes = [u8p, ctypes.c_size_t, u8p, szp]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.uda_merge_rows.restype = None
    lib.uda_merge_rows.argtypes = [u32p, ctypes.c_int64, u32p,
                                   ctypes.c_int64, ctypes.c_int32, u32p]
    lib.uda_gather_spans.restype = None
    lib.uda_gather_spans.argtypes = [u8p, i64p, i64p, ctypes.c_int64,
                                     u8p, i64p]
    return lib


def available() -> bool:
    """Whether the library is built (or can be built now) and loads."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def build(quiet: bool = True) -> bool:
    """Build and load the library at most once per process. Returns True;
    raises ``RuntimeError`` (with the compiler's output) when it cannot be
    built or loaded. ``quiet`` is kept for the reference's signature: the
    build's output is shown only when it fails."""
    del quiet
    _load()
    return True


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u32ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _as_u8(data) -> np.ndarray:
    return (np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray)
            else np.ascontiguousarray(data, np.uint8))


def crack_partial_native(data) -> tuple[RecordBatch, int, bool]:
    """Native twin of ifile.crack_partial (same return contract)."""
    lib = _load()
    arr = _as_u8(data)
    n = len(arr)
    cap = max(16, n // 2 + 1)  # a record is >= 2 bytes of framing
    ko = np.empty(cap, np.int64)
    kl = np.empty(cap, np.int64)
    vo = np.empty(cap, np.int64)
    vl = np.empty(cap, np.int64)
    consumed = ctypes.c_int64(0)
    saw_eof = ctypes.c_int32(0)
    _count("crack")
    count = lib.uda_crack(_u8ptr(arr), n, _i64ptr(ko), _i64ptr(kl),
                          _i64ptr(vo), _i64ptr(vl), cap,
                          ctypes.byref(consumed), ctypes.byref(saw_eof))
    if count == -1:
        raise StorageError("corrupt record framing (native crack)")
    if count == -2:  # capacity overflow: cannot happen with cap >= n/2+1
        raise StorageError("native crack capacity overflow")
    c = int(count)
    batch = RecordBatch(arr, ko[:c].copy(), kl[:c].copy(), vo[:c].copy(),
                        vl[:c].copy())
    return batch, int(consumed.value), bool(saw_eof.value)


def crack_native(data, expect_eof: bool = True) -> RecordBatch:
    """Native twin of ifile.crack."""
    batch, consumed, saw_eof = crack_partial_native(data)
    n = len(data)
    if expect_eof and not saw_eof:
        raise StorageError("IFile segment missing EOF marker (native)")
    if not saw_eof and consumed != n:
        raise StorageError(f"truncated IFile segment at offset {consumed}")
    return batch


def decode_vlongs_native(data, count: int = -1) -> np.ndarray:
    lib = _load()
    arr = _as_u8(data)
    cap = len(arr) if count < 0 else count
    out = np.empty(max(cap, 1), np.int64)
    _count("decode_vlongs")
    n = lib.uda_decode_vlongs(_u8ptr(arr), len(arr), _i64ptr(out), cap)
    if count >= 0 and n < count:
        raise IndexError("truncated VLong stream (native)")
    return out[:n].copy()


def write_records_native(batch: RecordBatch, write_eof: bool = True) -> bytes:
    """Native twin of ifile.write_records over a RecordBatch: re-frames
    the batch's records as one IFile byte stream (the emit hot path)."""
    lib = _load()
    n = batch.num_records
    # worst case: 20 framing bytes per record (two max-width VLongs)
    cap = int(batch.key_len.sum() + batch.val_len.sum()) + 20 * n + 2
    out = np.empty(cap, np.uint8)
    data = np.ascontiguousarray(batch.data, np.uint8)
    _count("write_records")
    wrote = lib.uda_write_records(
        _u8ptr(data),
        _i64ptr(np.ascontiguousarray(batch.key_off, np.int64)),
        _i64ptr(np.ascontiguousarray(batch.key_len, np.int64)),
        _i64ptr(np.ascontiguousarray(batch.val_off, np.int64)),
        _i64ptr(np.ascontiguousarray(batch.val_len, np.int64)),
        n, _u8ptr(out), cap, 1 if write_eof else 0)
    if wrote < 0:
        raise StorageError("native write_records capacity overflow")
    return out[:wrote].tobytes()


def frame_batch(batch: RecordBatch, write_eof: bool = True) -> bytes:
    """Frame a whole RecordBatch as one IFile byte stream: one C pass over
    the columns where ``uda.tpu.use.native`` is on (raising if the library
    cannot be built), the pure-Python ``merger.emitter.frame_batch`` where
    it is off. Both give the same bytes."""
    from uda_tpu_torch.utils.ifile import native_enabled

    if native_enabled():
        return write_records_native(batch, write_eof=write_eof)
    from uda_tpu_torch.merger.emitter import frame_batch as frame_py

    return frame_py(batch, write_eof=write_eof)


def iter_framed_chunks(batch: RecordBatch, chunk_records: int = 1 << 16,
                       write_eof: bool = True):
    """Frame a RecordBatch in bounded chunks: yields IFile byte pieces
    whose concatenation equals ``frame_batch(batch)``. Peak transient
    memory is one chunk's framed bytes, so multi-GB spills stream to
    their file instead of materializing wholesale."""
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


# KeyType.name -> (key_mode, key_param) for the native loser-tree merge
# (merge.cc). The mode family is the reference's CompareFunc dispatch
# (CompareFunc.cc:70-113): identity memcmp, Text VInt-skip, BytesWritable
# 4-byte skip, plus the sign-flip numeric variants. Comparators outside
# this table (user-registered) take the Python heap merge.
_KWAY_MODES = {
    "raw": (0, 0), "boolean": (0, 0), "byte": (0, 0), "short": (0, 0),
    "int": (0, 0), "long": (0, 0),
    "text": (1, 0),
    "bytes": (2, 0), "ibytes": (2, 0),
    "int_numeric": (3, 4), "long_numeric": (3, 8),
}

_KWAY_ERRORS = {-1: "corrupt record framing / missing EOF marker",
                -4: "read failure"}


def kway_supported(kt) -> bool:
    """Whether the native merge implements this KeyType's comparator."""
    return kt.name in _KWAY_MODES


def kway_merge_paths(paths, kt, block_bytes: int = 1 << 20,
                     buffer_size: int = 1 << 20, write_eof: bool = True):
    """Streaming k-way merge of sorted IFile spill files: yields framed
    byte blocks whose concatenation is the merged record stream (+ EOF
    marker when ``write_eof``), byte for byte the heap merge of the same
    files re-framed. The C++ loser tree (merge.cc, the reference's
    MergeQueue.h:276-427) does all comparator and framing work; peak
    memory is one read buffer per file + one output block."""
    mode, param = _KWAY_MODES[kt.name]
    if not paths:
        if write_eof:
            yield EOF_MARKER
        return
    lib = _load()
    arr = (ctypes.c_char_p * len(paths))(
        *[os.fsencode(p) for p in paths])
    err = ctypes.c_int64(0)
    _count("kway_create")
    h = lib.uda_kway_create(arr, len(paths), mode, param, buffer_size,
                            ctypes.byref(err))
    if not h:
        reason = _KWAY_ERRORS.get(int(err.value), "open failed")
        raise StorageError(f"native kway merge over {list(paths)}: "
                           f"{reason}")
    try:
        cap = block_bytes
        out = np.empty(cap, np.uint8)
        need = ctypes.c_int64(0)
        while True:
            _count("kway_next_block")
            n = lib.uda_kway_next_block(h, _u8ptr(out), cap,
                                        ctypes.byref(need))
            if n == -3:  # one record larger than the block: grow
                cap = max(cap * 2, int(need.value))
                out = np.empty(cap, np.uint8)
                continue
            if n < 0:
                raise StorageError(
                    f"native kway merge: "
                    f"{_KWAY_ERRORS.get(int(n), f'error {n}')}")
            if n == 0:
                break
            yield out[:n].tobytes()
        if write_eof:
            yield EOF_MARKER
    finally:
        lib.uda_kway_destroy(h)


def gather_spans_native(src: np.ndarray, src_off: np.ndarray,
                        lens: np.ndarray, dst: np.ndarray,
                        dst_off: np.ndarray) -> bool:
    """Per-record memcpy gather: dst[dst_off_i:+len_i] = src[src_off_i:
    +len_i]. The byte-movement core of the streaming interleave (the numpy
    expand-index form moves 8 bytes of index per byte of payload).
    Returns True; raises ``ValueError`` on spans out of bounds."""
    lib = _load()
    # dst is written through its raw pointer: coercion would write into
    # a discarded copy, so demand the right layout outright; the C loop
    # is bounds-unchecked, so offset arrays must agree on n
    if dst.dtype != np.uint8 or not dst.flags["C_CONTIGUOUS"]:
        raise ValueError("gather destination must be contiguous uint8")
    n = src_off.shape[0]
    if lens.shape[0] != n or dst_off.shape[0] != n:
        raise ValueError(f"span arrays disagree: {n} offsets, "
                         f"{lens.shape[0]} lengths, "
                         f"{dst_off.shape[0]} destinations")
    # the C loop is a bounds-unchecked memcpy: corrupt spans must fail
    # here as the numpy form would, not scribble memory
    if n and (int(lens.min()) < 0
              or int((src_off + lens).max()) > src.size
              or int(src_off.min()) < 0 or int(dst_off.min()) < 0
              or int((dst_off + lens).max()) > dst.size):
        raise ValueError("gather spans out of bounds")
    src = np.ascontiguousarray(src, np.uint8)
    _count("gather_spans")
    lib.uda_gather_spans(
        _u8ptr(src), _i64ptr(np.ascontiguousarray(src_off, np.int64)),
        _i64ptr(np.ascontiguousarray(lens, np.int64)), n,
        _u8ptr(dst), _i64ptr(np.ascontiguousarray(dst_off, np.int64)))
    return True


def merge_rows_native(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Linear lexicographic merge of two sorted uint32 row matrices
    (ties to ``a``): the host engine's twin of K1's merge pass."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"row matrices disagree: {a.shape} and {b.shape}")
    out = np.empty((a.shape[0] + b.shape[0], a.shape[1]), np.uint32)
    merge_rows_native_into(a, b, out)
    return out


def merge_rows_native_into(a: np.ndarray, b: np.ndarray,
                           out: np.ndarray) -> bool:
    """merge_rows_native writing into a caller-owned ``out`` (C-contiguous
    uint32 with a.shape[0] + b.shape[0] rows): the overlap forest reuses
    its merge outputs from a buffer pool instead of page-faulting a fresh
    array per merge. Returns True."""
    lib = _load()
    for arr in (a, b, out):
        if arr.dtype != np.uint32 or arr.ndim != 2 \
                or not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("merge rows must be C-contiguous 2-D uint32")
    if out.shape[0] != a.shape[0] + b.shape[0] \
            or not out.shape[1] == a.shape[1] == b.shape[1]:
        raise ValueError(f"merge output {out.shape} does not hold "
                         f"{a.shape} + {b.shape}")
    _count("merge_rows")
    lib.uda_merge_rows(_u32ptr(a), a.shape[0], _u32ptr(b), b.shape[0],
                       a.shape[1], _u32ptr(out))
    return True


def lzo1x_1_compress(data: bytes):
    """The builtin LZO1X-1 compressor (lzo.cc): (rc, compressed bytes)."""
    lib = _load()
    src = np.frombuffer(bytes(data), np.uint8)
    n = len(src)
    out = np.empty(n + n // 16 + 67 + 3, np.uint8)
    out_len = ctypes.c_size_t(len(out))
    _count("lzo1x_1_compress")
    rc = lib.uda_lzo1x_1_compress(_u8ptr(src), n, _u8ptr(out),
                                  ctypes.byref(out_len))
    return rc, out[:out_len.value].tobytes()


def lzo1x_decompress_safe(data: bytes, uncompressed_len: int):
    """The builtin LZO1X decoder (lzo.cc): (rc, decoded bytes)."""
    lib = _load()
    src = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(max(uncompressed_len, 1), np.uint8)
    out_len = ctypes.c_size_t(uncompressed_len)
    _count("lzo1x_decompress_safe")
    rc = lib.uda_lzo1x_decompress_safe(_u8ptr(src), len(src), _u8ptr(out),
                                       ctypes.byref(out_len))
    return rc, out[:out_len.value].tobytes()


class ReadPool:
    """Async read pool over the native worker threads or the kernel's
    io_uring: the AIOHandler submit/get_events contract (reference
    AIOHandler.cc:122-235)."""

    def __init__(self, threads: int = 2):
        lib = _load()
        self._lib = lib
        self._pool = lib.uda_pool_create(threads)
        if not self._pool:
            raise StorageError("native read pool could not start")
        self._lock = threading.Lock()
        self._next_tag = 0
        self._pending: dict[int, tuple[np.ndarray, object]] = {}

    def backend(self) -> str:
        """Which rung this pool runs: "io_uring" when the ring backend was
        compiled in and the running kernel accepted io_uring_setup, else
        "pool" (pread worker threads)."""
        if not self._pool:
            return "pool"
        return ("io_uring"
                if self._lib.uda_pool_backend(self._pool) == 1
                else "pool")

    def submit(self, fd: int, offset: int, length: int):
        """Returns a tag; the destination buffer is allocated here and
        returned by poll() with the completion."""
        buf = np.empty(length, np.uint8)
        with self._lock:
            tag = self._next_tag
            self._next_tag += 1
            self._pending[tag] = (buf, None)
        _count("pool_submit")
        rc = self._lib.uda_pool_submit(self._pool, fd, offset, length,
                                       _u8ptr(buf), tag)
        if rc != 0:
            with self._lock:
                del self._pending[tag]
            raise StorageError("submit on stopped native pool")
        return tag

    def submit_batch(self, jobs) -> list:
        """Batched submission: every ``(fd, offset, length)`` job enters
        the native pool in one call (one lock round / ring doorbell for
        the burst). Returns the tags in job order; completions ride
        poll() like single submits."""
        n = len(jobs)
        if n == 0:
            return []
        bufs = [np.empty(length, np.uint8) for _, _, length in jobs]
        fds = (ctypes.c_int32 * n)(*[fd for fd, _, _ in jobs])
        offs = (ctypes.c_int64 * n)(*[off for _, off, _ in jobs])
        lens = (ctypes.c_int64 * n)(*[length for _, _, length in jobs])
        dsts = (ctypes.POINTER(ctypes.c_uint8) * n)(
            *[_u8ptr(b) for b in bufs])
        with self._lock:
            tags = list(range(self._next_tag, self._next_tag + n))
            self._next_tag += n
            for tag, buf in zip(tags, bufs):
                self._pending[tag] = (buf, None)
        ctags = (ctypes.c_uint64 * n)(*tags)
        _count("pool_submit_batch")
        rc = self._lib.uda_pool_submit_batch(self._pool, n, fds, offs,
                                             lens, dsts, ctags)
        if rc != 0:
            with self._lock:
                for tag in tags:
                    self._pending.pop(tag, None)
            raise StorageError("submit_batch on stopped native pool")
        return tags

    def poll(self, min_events: int = 1, timeout: float = 5.0
             ) -> list[tuple[int, object]]:
        """Drain completions: [(tag, result)] where result is the data
        sliced to the bytes actually read, or a StorageError for a failed
        read (per tag: one bad read never poisons other requests)."""
        max_events = 256
        tags = (ctypes.c_uint64 * max_events)()
        results = (ctypes.c_int64 * max_events)()
        n = self._lib.uda_pool_get_events(self._pool, tags, results,
                                          max_events, min_events, timeout)
        out: list[tuple[int, object]] = []
        for i in range(n):
            tag = int(tags[i])
            res = int(results[i])
            with self._lock:
                ent = self._pending.pop(tag, None)
            if ent is None:
                # a tag already settled by an error path: dropping it
                # beats killing the router thread every read shares
                continue
            buf, _ = ent
            if res < 0:
                out.append((tag, StorageError(
                    f"native read failed: errno {-res}")))
            else:
                out.append((tag, buf[:res]))
        return out

    def close(self) -> None:
        if self._pool:
            self._lib.uda_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self) -> "ReadPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
