"""Supplier data engine: bounded read admission + threaded segment reads.

The port's copy of ``uda_tpu/mofserver/data_engine.py``'s single-``pread``
serve path, which the reference's ``submit`` takes whatever
``uda.tpu.read.batch`` says (its batched plane feeds the network server,
not ported yet). TPU-native rebuild of the reference's DataEngine
(reference src/MOFServer/IndexInfo.cc:97-376): the libaio O_DIRECT read
loop with a 1000-chunk pool becomes a pread thread pool,
``mapred.uda.provider.blocked.threads.per.disk`` threads per local dir.

Backpressure: in-flight supplier memory is bounded by a read budget
(``uda.tpu.supplier.read.budget.mb``): a request past it is rejected with
StorageError and the reduce side's retry absorbs the push-back; ``submit``
never blocks, because chained fetches are re-issued from the pool's own
completion callbacks.

A fetch request asks for up to ``chunk_size`` bytes of one partition at
``offset`` within the partition; the reply carries (raw_length,
part_length, actual bytes, offset) — the fields of the reference's RDMA
ACK message (src/DataNet/RDMAServer.cc:537-631). Refcounted fd reuse
mirrors the reference's fd_counter map (IndexInfo.cc:195-233). Each read
passes the ``data_engine.pread`` failpoint (``uda.tpu.failpoints`` arms
the port's registry at construction, as the reference's does).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

from uda_tpu_torch.mofserver.index import IndexResolver
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import StorageError
from uda_tpu_torch.utils.failpoints import failpoint, failpoints
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["ShuffleRequest", "FetchResult", "DataEngine"]


@dataclasses.dataclass(frozen=True)
class ShuffleRequest:
    """One chunk fetch (reference shuffle_req_t, src/MOFServer/
    IndexInfo.h:64-77: jobid, map, reduceID, map_offset, chunk_size).
    ``host`` names the supplier serving this map output; single-host
    transports ignore it."""

    job_id: str
    map_id: str
    reduce_id: int
    offset: int          # offset within the partition's record bytes
    chunk_size: int
    host: str = ""


@dataclasses.dataclass
class FetchResult:
    """Reply payload (reference ACK fields, RDMAServer.cc:597-607).

    ``raw_length`` is the partition's uncompressed record-byte size and
    ``part_length`` its on-disk size; ``last`` is set by the producer.
    ``crc`` is the chunk's CRC32 as read from disk when
    ``uda.tpu.fetch.crc`` is on."""

    data: bytes
    raw_length: int
    part_length: int
    offset: int          # echo of the request offset
    path: str
    last: bool
    crc: Optional[int] = None

    @property
    def is_last(self) -> bool:
        return self.last


class _FdCache:
    """Refcounted fd reuse across requests for the same MOF (reference
    fd_counter, IndexInfo.cc:195-233). Entries whose refcount reaches zero
    stay open, least recently used first out past ``_IDLE_CAP``, so a
    partition served chunk by chunk opens its file once."""

    _IDLE_CAP = 128

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fds: Dict[str, list] = {}   # path -> [fd, refs]
        self._idle: list = []             # refs == 0 paths, oldest first

    def acquire(self, path: str) -> int:
        with self._lock:
            ent = self._fds.get(path)
            if ent is not None:
                if ent[1] == 0:
                    self._idle.remove(path)
                ent[1] += 1
                return ent[0]
        fd = os.open(path, os.O_RDONLY)
        with self._lock:
            ent = self._fds.get(path)
            if ent is not None:  # raced: keep the existing one
                if ent[1] == 0:
                    self._idle.remove(path)
                ent[1] += 1
                os.close(fd)
                return ent[0]
            self._fds[path] = [fd, 1]
            return fd

    def release(self, path: str) -> None:
        evicted = None
        with self._lock:
            ent = self._fds.get(path)
            if ent is None or ent[1] <= 0:
                return
            ent[1] -= 1
            if ent[1]:
                return
            self._idle.append(path)
            if len(self._idle) > self._IDLE_CAP:
                evicted = self._fds.pop(self._idle.pop(0))
        if evicted is not None:
            os.close(evicted[0])

    def close_all(self) -> None:
        with self._lock:
            ents = list(self._fds.values())
            self._fds.clear()
            self._idle.clear()
        for fd, _ in ents:
            os.close(fd)


class DataEngine:
    """Threaded chunk server over local map-output files."""

    def __init__(self, resolver: IndexResolver,
                 config: Optional[Config] = None, num_disks: int = 1):
        cfg = config or Config()
        spec = cfg.get("uda.tpu.failpoints")
        if spec:
            failpoints.arm_spec(spec)
        threads = max(1, cfg.get("mapred.uda.provider.blocked.threads.per.disk")) \
            * max(1, num_disks)
        self.chunk_size_default = cfg.get("mapred.rdma.buf.size") * 1024
        self._crc = bool(cfg.get("uda.tpu.fetch.crc"))
        budget_mb = int(cfg.get("uda.tpu.supplier.read.budget.mb"))
        if budget_mb <= 0:
            budget_mb = max(256, threads * 32)
        self.read_budget_bytes = budget_mb * (1 << 20)
        self._admitted_bytes = 0
        self._admit_lock = threading.Lock()
        self.resolver = resolver
        self._pool = ThreadPoolExecutor(max_workers=threads,
                                        thread_name_prefix="uda-data-engine")
        self._fds = _FdCache()
        self._stopped = False

    def submit(self, req: ShuffleRequest) -> Future:
        """Async fetch; the Future resolves to a FetchResult. Never
        blocks; safe to call from completion callbacks."""
        if self._stopped:
            raise StorageError("DataEngine is stopped")
        want = req.chunk_size or self.chunk_size_default
        self._admit_bytes(want)
        try:
            return self._pool.submit(self._serve, req, want)
        except BaseException:  # pool shutdown race: undo the accounting
            self._unadmit(want)
            raise

    def _admit_bytes(self, want: int) -> None:
        """The read-budget admission gate (the occupy_chunk pool bound,
        IndexInfo.cc:276-292, minus the blocking). An oversized single
        request is admitted when the pool is otherwise idle: progress
        beats the bound."""
        with self._admit_lock:
            if self._admitted_bytes > 0 and \
                    self._admitted_bytes + want > self.read_budget_bytes:
                metrics.add("supplier.admission.rejections")
                raise StorageError(
                    f"supplier read pool exhausted: {self._admitted_bytes}"
                    f" B in flight + {want} B > budget "
                    f"{self.read_budget_bytes} B (retry with backoff, or "
                    f"raise uda.tpu.supplier.read.budget.mb)")
            self._admitted_bytes += want

    def _unadmit(self, want: int) -> None:
        with self._admit_lock:
            self._admitted_bytes -= want

    def _serve(self, req: ShuffleRequest, admitted: int) -> FetchResult:
        try:
            with metrics.timer("supplier_read"):
                return self._serve_inner(req)
        finally:
            self._unadmit(admitted)

    def _serve_inner(self, req: ShuffleRequest) -> FetchResult:
        rec = self.resolver.resolve(req.job_id, req.map_id, req.reduce_id)
        served = rec.part_length  # the on-disk domain
        if req.offset < 0 or req.offset >= max(served, 1):
            raise StorageError(
                f"offset {req.offset} outside partition (on-disk "
                f"{served}) for {req.map_id}/{req.reduce_id}")
        want = min(req.chunk_size or self.chunk_size_default,
                   served - req.offset)
        fd = self._fds.acquire(rec.path)
        try:
            data = os.pread(fd, want, rec.start_offset + req.offset)
        finally:
            self._fds.release(rec.path)
        if len(data) != want:
            raise StorageError(
                f"short read {len(data)}/{want} at {rec.path}:"
                f"{rec.start_offset + req.offset}")
        # CRC stamped from the bytes as read, before the failpoint can
        # mangle them: injected damage then looks like wire damage to the
        # validating Segment
        crc = zlib.crc32(data) & 0xFFFFFFFF if self._crc else None
        data = failpoint("data_engine.pread", data=data,
                         key=f"{req.map_id}/{req.reduce_id}")
        metrics.add("supplier.bytes", len(data))
        return FetchResult(data, rec.raw_length, rec.part_length,
                           req.offset, rec.path,
                           last=req.offset + len(data) >= served, crc=crc)

    def stop(self) -> None:
        self._stopped = True
        self._pool.shutdown(wait=True)
        self._fds.close_all()
