"""Supplier data engine: bounded read admission + threaded segment reads.

The port's copy of ``uda_tpu/mofserver/data_engine.py``: the
single-``pread`` serve path (``submit``, ``fetch``), the zero-copy serve
plane the network server takes by default (``try_plan``,
``submit_serve``: an :class:`FdSlice` of ``(fd, offset, length)``
instead of bytes, streamed by ``os.sendfile`` or out of the MOF's cached
``mmap``) and the batched host-I/O plane (``submit_batch``: one pool
handoff per request burst, per-fd grouping, gap-threshold range
coalescing, vectored reads down the backend ladder). TPU-native rebuild
of the reference's DataEngine (reference src/MOFServer/IndexInfo.cc:
97-376): the libaio O_DIRECT read loop with a 1000-chunk pool becomes a
pread thread pool, ``mapred.uda.provider.blocked.threads.per.disk``
threads per local dir.

Backpressure: in-flight supplier memory is bounded by a read budget
(``uda.tpu.supplier.read.budget.mb``): a request past it is rejected with
StorageError and the reduce side's retry absorbs the push-back; no serve
path blocks, because chained fetches are re-issued from the pool's own
completion callbacks.

A fetch request asks for up to ``chunk_size`` bytes of one partition at
``offset`` within the partition; the reply carries (raw_length,
part_length, actual bytes, offset) — the fields of the reference's RDMA
ACK message (src/DataNet/RDMAServer.cc:537-631). Refcounted fd reuse
mirrors the reference's fd_counter map (IndexInfo.cc:195-233). Each read
passes the ``data_engine.pread`` failpoint, and each batched read the
``data_engine.preadv`` one too (``uda.tpu.failpoints`` arms the port's
registry at construction, as the reference's does).

The batched plane's backend ladder is the reference's io_uring -> preadv
-> pread, entered at ``uda.tpu.read.backend`` or the tune cache's
``io.read`` winner. The io_uring rung needs the reference's native
reader (C++, not ported), so the ladder never finds it here and lands on
preadv: served bytes are the same on every rung.

Two planes attach to a running engine. ``attach_store`` hands it a
:class:`~uda_tpu_torch.mofserver.store.StoreManager`: every serve path
(``submit``, ``submit_serve``, ``try_plan``, ``submit_batch``) routes a
store-managed partition (a blob primary, or a local one with a blob
twin) through the store's failover router, and ``try_plan`` declines
zero-copy for it; unmanaged partitions keep the fd path, zero-copy
included. ``set_tenant_registry`` turns on the per-tenant read-budget
partitions: a request stamped with a tenant (``ShuffleRequest.tenant``,
set by the network server from its connection's MSG_JOB binding) is also
admitted against that tenant's weighted share of the budget.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional, Sequence

from uda_tpu_torch.mofserver.index import IndexResolver
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import ConfigError, StorageError
from uda_tpu_torch.utils.failpoints import failpoint, failpoints
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["ShuffleRequest", "FetchResult", "FdSlice", "DataEngine",
           "plan_coalesced", "BATCH_BACKENDS"]

log = get_logger()

# The batched-read backend ladder, best rung first: "io_uring" = the
# reference's native ring reader (never present in the port); "preadv" =
# one os.preadv per coalesced run; "pread" = per-request os.pread on the
# batch worker (one pool handoff per batch).
BATCH_BACKENDS = ("io_uring", "preadv", "pread")


@dataclasses.dataclass(frozen=True)
class ShuffleRequest:
    """One chunk fetch (reference shuffle_req_t, src/MOFServer/
    IndexInfo.h:64-77: jobid, map, reduceID, map_offset, chunk_size).
    ``host`` names the supplier serving this map output; single-host
    transports ignore it. ``tenant`` is the supplier's in-process stamp
    of the connection's MSG_JOB binding (empty = untenanted); it never
    rides the wire, so a client cannot spoof a neighbour's tenant."""

    job_id: str
    map_id: str
    reduce_id: int
    offset: int          # offset within the partition's record bytes
    chunk_size: int
    host: str = ""
    tenant: str = ""


@dataclasses.dataclass
class FetchResult:
    """Reply payload (reference ACK fields, RDMAServer.cc:597-607).

    ``raw_length`` is the partition's uncompressed record-byte size and
    ``part_length`` its on-disk size (they differ under compression);
    ``last`` is set by the producer in whatever domain it serves
    (DataEngine: on-disk bytes; DecompressingClient: the uncompressed
    stream). ``crc`` is the chunk's CRC32 as read from disk when
    ``uda.tpu.fetch.crc`` is on. ``data`` is bytes-like: the network
    client donates its per-frame receive bytearray straight into it."""

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


@dataclasses.dataclass
class FdSlice:
    """A zero-copy serve plan: one chunk of a MOF described as ``(fd,
    offset, length)`` instead of bytes; the network server streams it
    with ``os.sendfile`` (or out of the file's cached mmap) so the chunk
    never becomes a Python-heap object.

    Holds one fd-cache reference and the request's admission charge
    until :meth:`release`, which is idempotent and must run once on every
    path (written, torn, dropped)."""

    fd: int
    file_offset: int     # absolute offset in the MOF file
    length: int          # chunk bytes to serve
    raw_length: int      # the FetchResult ACK fields, verbatim
    part_length: int
    offset: int          # echo of the request offset
    path: str
    last: bool
    _engine: "DataEngine" = dataclasses.field(repr=False, default=None)
    _admitted: int = 0
    _released: bool = False
    _tenant: str = ""    # the admission charge's tenant partition

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._engine._fds.release(self.path)
        if self._admitted:
            self._engine._unadmit(self._admitted, self._tenant)

    def view(self):
        """A memoryview of the chunk inside the MOF's cached whole-file
        mmap, or None when the file cannot be mapped (the caller falls
        back to sendfile). Valid only while this slice is unreleased."""
        if self._released:
            return None
        mm = self._engine._fds.mmap_for(self.path)
        if mm is None:
            return None
        return memoryview(mm)[self.file_offset:
                              self.file_offset + self.length]


class _FdCache:
    """Refcounted fd reuse across requests for the same MOF (reference
    fd_counter, IndexInfo.cc:195-233), with an optional read-only
    ``mmap`` of the whole file per entry (the zero-copy plane's mmap
    mode slices memoryviews out of it). Entries whose refcount reaches
    zero stay open, least recently used first out past ``_IDLE_CAP``, so
    a partition served chunk by chunk opens (and maps) its file once."""

    _IDLE_CAP = 128

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fds: Dict[str, list] = {}   # path -> [fd, refs, mmap|None]
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
            self._fds[path] = [fd, 1, None]
            return fd

    def mmap_for(self, path: str):
        """The whole-file read-only map of an entry the caller holds a
        reference on (made on first use, cached with the fd), or None
        when the file cannot be mapped (empty file, exotic fs)."""
        import mmap as mmap_mod

        with self._lock:
            ent = self._fds.get(path)
            if ent is None:
                return None
            if ent[2] is not None:
                return ent[2]
            fd = ent[0]
        try:
            mm = mmap_mod.mmap(fd, 0, prot=mmap_mod.PROT_READ)
        except (ValueError, OSError):
            return None
        with self._lock:
            ent = self._fds.get(path)
            if ent is None or ent[2] is not None:
                mm.close()
                return ent[2] if ent else None
            ent[2] = mm
            return mm

    @staticmethod
    def _close_entry(fd: int, mm) -> None:
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                # a serve-path memoryview still points into the map: leak
                # the mapping until exit rather than crash
                log.warn("mmap still exported at fd-cache release; "
                         "leaking the mapping")
        os.close(fd)

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
            self._close_entry(evicted[0], evicted[2])

    def close_all(self) -> None:
        with self._lock:
            ents = list(self._fds.values())
            self._fds.clear()
            self._idle.clear()
        for fd, _, mm in ents:
            self._close_entry(fd, mm)


# one coalesced run never exceeds this many entries: each entry costs up
# to two iovecs (its buffer + a gap scratch view), and preadv rejects more
# than IOV_MAX (1024) buffers per call with EINVAL
_MAX_RUN_ITEMS = 511


def plan_coalesced(ranges: Sequence[tuple], gap_bytes: int,
                   max_run_bytes: int,
                   max_items: int = _MAX_RUN_ITEMS) -> List[list]:
    """Group ``(item, file_off, length)`` triples into coalesced runs:
    within a run, ranges ascend, never overlap, successive ranges are at
    most ``gap_bytes`` apart, the whole read span stays under
    ``max_run_bytes`` and the run holds at most ``max_items`` entries (the
    IOV_MAX bound); each run becomes one vectored read (the gaps are read
    into scratch and discarded). Overlapping or duplicate ranges start a
    fresh run: a scatter list cannot write the same disk bytes into two
    buffers in one preadv."""
    if not ranges:
        return []
    ordered = sorted(ranges, key=lambda r: (r[1], r[2]))
    runs: List[list] = []
    run: list = [ordered[0]]
    run_start = ordered[0][1]
    run_end = ordered[0][1] + ordered[0][2]
    for item in ordered[1:]:
        _, off, length = item
        if (off >= run_end and off - run_end <= gap_bytes
                and (off + length) - run_start <= max_run_bytes
                and len(run) < max_items):
            run.append(item)
            run_end = off + length
        else:
            runs.append(run)
            run = [item]
            run_start, run_end = off, off + length
    runs.append(run)
    return runs


def _preadv_full(fd: int, bufs: Sequence, offset: int) -> tuple:
    """os.preadv until every buffer is full or EOF: one scatter read for
    the common case, continuation reads re-sliced past the filled prefix
    when the kernel returns short. Returns (bytes_read, syscalls)."""
    views = [memoryview(b) for b in bufs]
    lens = [len(v) for v in views]
    total = sum(lens)
    got = 0
    syscalls = 0
    while got < total:
        acc = 0
        i = 0
        while i < len(views) and acc + lens[i] <= got:
            acc += lens[i]
            i += 1
        iov = [views[i][got - acc:]] + views[i + 1:]
        n = os.preadv(fd, iov, offset + got)
        syscalls += 1
        if n <= 0:
            break  # EOF mid-run: callers fail the unfilled ranges
        got += n
    return got, syscalls


class _BatchEntry:
    """One request's slot in a submitted batch: the future the caller
    holds, the admission it owes, and the state the batch worker fills in
    as the stages (resolve -> read -> finish) run. ``err`` short-circuits
    later stages: one failing request never touches its batch-mates."""

    __slots__ = ("req", "want_admit", "fut", "rec", "want", "file_off",
                 "fd", "buf", "got", "err")

    def __init__(self, req: ShuffleRequest, want_admit: int, fut: Future):
        self.req = req
        self.want_admit = want_admit
        self.fut = fut
        self.rec = None
        self.want = 0          # actual chunk bytes (clamped to the MOF)
        self.file_off = 0
        self.fd = -1
        self.buf = None        # per-request read buffer (bytearray)
        self.got = 0           # bytes actually landed in buf
        self.err: Optional[Exception] = None


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
        # the synchronous path's wait bound (fetch()): the reduce side's
        # retry knobs, else 60 s
        attempt_ms = int(cfg.get("mapred.rdma.fetch.attempt.timeout.ms"))
        deadline_ms = int(cfg.get("mapred.rdma.fetch.deadline.ms"))
        self.sync_fetch_timeout_s = (
            (attempt_ms or deadline_ms) / 1e3
            if (attempt_ms or deadline_ms) else 60.0)
        self._admitted_bytes = 0
        self._admit_lock = threading.Lock()
        # per-tenant read-budget partitions (set_tenant_registry)
        self._tenant_registry = None
        self._tenant_admitted: Dict[str, int] = {}
        self.resolver = resolver
        # the disaggregated store (attach_store): None = every partition
        # on the fd path
        self.store = None
        self._pool = ThreadPoolExecutor(max_workers=threads,
                                        thread_name_prefix="uda-data-engine")
        self._fds = _FdCache()
        self._stopped = False
        self._resolve_batch_plane(cfg)

    def _resolve_batch_plane(self, cfg: Config) -> None:
        """Resolve the batched host-I/O plane's parameters. Per knob:
        explicit config > tune-cache winner (domain ``io.read``, key
        ``sys.platform``) > built-in default. An explicit
        ``uda.tpu.tune.cache.path`` also installs that cache as the
        process default (``set_default_cache``), as the reference does.
        The backend ladder walks down from the wanted rung to one this
        process can drive; the rung is recorded as :attr:`io_backend` and
        the ``io.backend`` metric label."""
        winner: dict = {}
        explicit = cfg.is_set("uda.tpu.tune.cache.path")
        tc_path = (str(cfg.get("uda.tpu.tune.cache.path")) if explicit
                   else "")
        if not tc_path:
            from uda_tpu_torch.utils.tuncache import cache_path_from_env
            tc_path = cache_path_from_env()
        if tc_path:
            from uda_tpu_torch.utils.tuncache import (TuneCache,
                                                      set_default_cache,
                                                      tune_cache)
            if explicit:
                cache = set_default_cache(tc_path)
                if cache.path != tc_path:
                    cache = TuneCache(tc_path)
            else:
                cache = tune_cache
            rec = cache.lookup("io.read", sys.platform)
            if rec is not None and isinstance(rec.get("winner"), dict):
                winner = rec["winner"]
        mode = str(cfg.get("uda.tpu.read.batch")).strip().lower()
        if mode not in ("on", "off", "auto"):
            raise ConfigError(f"uda.tpu.read.batch={mode!r} is not "
                              f"on/off/auto")
        if mode == "auto" and winner.get("batch") in ("on", "off"):
            mode = winner["batch"]
        self.batch_enabled = mode != "off"
        gap_kb = int(cfg.get("uda.tpu.read.coalesce.gap.kb"))
        if not cfg.is_set("uda.tpu.read.coalesce.gap.kb") \
                and isinstance(winner.get("gap_kb"), int) \
                and winner["gap_kb"] >= 0:
            gap_kb = winner["gap_kb"]
        self.coalesce_gap_bytes = max(0, gap_kb) << 10
        bmax = int(cfg.get("uda.tpu.read.batch.max"))
        if not cfg.is_set("uda.tpu.read.batch.max") \
                and isinstance(winner.get("batch_max"), int) \
                and winner["batch_max"] > 0:
            bmax = winner["batch_max"]
        self.batch_max = max(1, bmax)
        # one coalesced run's span stays bounded so gap scratch and
        # per-request buffers cannot balloon past the admission budget
        self.max_run_bytes = self.batch_max * (64 << 10)
        want_backend = str(cfg.get("uda.tpu.read.backend")).strip().lower()
        if want_backend not in BATCH_BACKENDS + ("auto",):
            raise ConfigError(f"uda.tpu.read.backend={want_backend!r} "
                              f"is not one of {BATCH_BACKENDS + ('auto',)}")
        if want_backend == "auto" and winner.get("backend") \
                in BATCH_BACKENDS:
            want_backend = winner["backend"]
        self.io_backend = self._walk_backend_ladder(want_backend)
        metrics.add("io.backend", backend=self.io_backend)

    @staticmethod
    def _walk_backend_ladder(want: str) -> str:
        """The io_uring -> preadv -> pread ladder, entered at ``want``
        ("auto" = the top): a rung is taken only when this process can
        drive it. io_uring needs the reference's native ring reader,
        which the port does not have, so it is always passed over."""
        start = 0 if want == "auto" else BATCH_BACKENDS.index(want)
        for rung in BATCH_BACKENDS[start:]:
            if rung == "preadv" and hasattr(os, "preadv"):
                return rung
            if rung == "pread":
                return rung
        return "pread"

    def submit(self, req: ShuffleRequest) -> Future:
        """Async fetch; the Future resolves to a FetchResult. Never
        blocks; safe to call from completion callbacks."""
        if self._stopped:
            raise StorageError("DataEngine is stopped")
        want = req.chunk_size or self.chunk_size_default
        self._admit_bytes(want, req.tenant)
        try:
            return self._pool.submit(self._serve, req, want)
        except BaseException:  # pool shutdown race: undo the accounting
            self._unadmit(want, req.tenant)
            raise

    def attach_store(self, store) -> None:
        """Attach a :class:`~uda_tpu_torch.mofserver.store.StoreManager`:
        reads of partitions it manages route through its failover router
        (``read``/``read_ranges``). Byte semantics are the fd path's:
        short-read checks, CRC stamping and the ``data_engine.pread``
        failpoint run on the routed bytes."""
        self.store = store

    def _store_managed(self, rec) -> bool:
        store = self.store
        return store is not None and store.manages(rec.path)

    def set_tenant_registry(self, registry) -> None:
        """Attach the multi-tenant registry: tenant-stamped requests are
        admitted against per-tenant budget shares
        (``registry.share_bytes``), and a retiring job's tenant book is
        checked (:meth:`drain_tenant`)."""
        self._tenant_registry = registry
        if registry is not None:
            registry.on_retire(lambda tenant, job:
                               self.drain_tenant(tenant))

    def drain_tenant(self, tenant: str) -> int:
        """The retire hook: the bytes ``tenant`` still has admitted (0
        when it is quiescent). Bytes in flight at retirement are live
        obligations, settled by their own serves, not leaks."""
        with self._admit_lock:
            return max(0, self._tenant_admitted.get(tenant, 0))

    def _admit_bytes(self, want: int, tenant: str = "") -> None:
        """The read-budget admission gate (the occupy_chunk pool bound,
        IndexInfo.cc:276-292, minus the blocking) every serve path
        charges through; each non-serving outcome pairs the charge with
        :meth:`_unadmit`. An oversized single request is admitted when the
        pool is otherwise idle: progress beats the bound. With a tenant
        registry a tenant-stamped request must also fit its tenant's share
        (the idle escape is per tenant there, so one tenant's giant
        request rides its own idle slice, never a neighbour's
        headroom)."""
        reg = self._tenant_registry
        with self._admit_lock:
            if self._admitted_bytes > 0 and \
                    self._admitted_bytes + want > self.read_budget_bytes:
                metrics.add("supplier.admission.rejections")
                raise StorageError(
                    f"supplier read pool exhausted: {self._admitted_bytes}"
                    f" B in flight + {want} B > budget "
                    f"{self.read_budget_bytes} B (retry with backoff, or "
                    f"raise uda.tpu.supplier.read.budget.mb)")
            if tenant and reg is not None:
                mine = self._tenant_admitted.get(tenant, 0)
                share = reg.share_bytes(tenant, self.read_budget_bytes)
                if mine > 0 and mine + want > share:
                    metrics.add("supplier.admission.rejections")
                    metrics.add("tenant.admission.rejections",
                                tenant=tenant)
                    raise StorageError(
                        f"tenant {tenant!r} read share exhausted: "
                        f"{mine} B in flight + {want} B > share "
                        f"{share} B of the supplier budget (this "
                        f"tenant's clients pace; others are unaffected)")
            self._admitted_bytes += want
            if tenant:
                self._tenant_admitted[tenant] = \
                    self._tenant_admitted.get(tenant, 0) + want
        if tenant:
            metrics.gauge_add("tenant.read.bytes.on_air", want)

    def _unadmit(self, want: int, tenant: str = "") -> None:
        with self._admit_lock:
            self._admitted_bytes -= want
            if tenant:
                left = self._tenant_admitted.get(tenant, 0) - want
                if left > 0:
                    self._tenant_admitted[tenant] = left
                else:
                    self._tenant_admitted.pop(tenant, None)
        if tenant:
            metrics.gauge_add("tenant.read.bytes.on_air", -want)

    def submit_serve(self, req: ShuffleRequest) -> Future:
        """Like :meth:`submit`, but the Future may resolve to an
        :class:`FdSlice` instead of a FetchResult. The byte path is taken
        whenever the chunk cannot be served straight off the fd: CRC
        stamping is on, or the ``data_engine.pread`` failpoint is armed
        (injected damage must keep mangling real bytes). Callers that
        receive an FdSlice own its release()."""
        if self._stopped:
            raise StorageError("DataEngine is stopped")
        want = req.chunk_size or self.chunk_size_default
        self._admit_bytes(want, req.tenant)
        try:
            return self._pool.submit(self._serve_plan, req, want)
        except BaseException:  # pool shutdown race: undo the accounting
            self._unadmit(want, req.tenant)
            raise

    def slice_eligible(self) -> bool:
        """Whether zero-copy FdSlice planning is possible now (CRC off,
        pread failpoint disarmed). The network server routes on it:
        eligible requests keep the zero-copy plane, the rest ride the
        batched byte path when batching is on."""
        return not self._crc \
            and not failpoints.is_armed("data_engine.pread")

    # -- the batched host-I/O plane ------------------------------------------

    def submit_batch(self, reqs: Sequence[ShuffleRequest]) -> List[Future]:
        """Batch submission: the whole burst rides one pool handoff; the
        worker groups per fd, coalesces adjacent and near-adjacent ranges
        (``uda.tpu.read.coalesce.gap.kb``) and issues vectored reads.
        Returns one Future per request, resolving to FetchResults like
        submit()'s. Admission is per request (an over-budget request fails
        only its own future), and this never raises: a stopped engine or
        a pool-shutdown race fails the futures. One failing range (bad
        offset, short read, injected ``data_engine.preadv`` fault) fails
        only its request."""
        futs: List[Future] = []
        entries: List[_BatchEntry] = []
        stopped = self._stopped
        for req in reqs:
            fut = Future()
            futs.append(fut)
            if stopped:
                fut.set_exception(StorageError("DataEngine is stopped"))
                continue
            want = req.chunk_size or self.chunk_size_default
            try:
                self._admit_bytes(want, req.tenant)
            except StorageError as e:
                fut.set_exception(e)
                continue
            entries.append(_BatchEntry(req, want, fut))
        if not entries:
            return futs
        metrics.add("io.batch.submits")
        metrics.add("io.batch.requests", len(entries))
        try:
            self._pool.submit(self._serve_batch, entries)
        except BaseException as exc:  # pool shutdown race: undo + fail
            for e in entries:
                self._unadmit(e.want_admit, e.req.tenant)
                err = StorageError("DataEngine is stopped")
                err.__cause__ = exc
                e.fut.set_exception(err)
        return futs

    def _serve_batch(self, entries: List[_BatchEntry]) -> None:
        """Worker-side body of submit_batch, on one pool thread for the
        whole batch: resolve each request, read per the backend rung, then
        finish every entry (CRC, failpoints, FetchResult)."""
        try:
            with metrics.timer("supplier_read"):
                self._batch_resolve(entries)
                live = [e for e in entries if e.err is None]
                if live:
                    self._read_batch_runs(live)
                self._batch_finish(entries)
        except BaseException as exc:  # a worker bug must still resolve
            # every future (callers wait on them)
            for e in entries:
                if not e.fut.done():
                    e.fut.set_exception(
                        exc if isinstance(exc, StorageError)
                        else StorageError(f"batch serve failed: {exc}"))
        finally:
            for e in entries:
                self._unadmit(e.want_admit, e.req.tenant)
                if not e.fut.done():
                    e.fut.set_exception(
                        StorageError("batch entry never served"))

    def _batch_resolve(self, entries: List[_BatchEntry]) -> None:
        for e in entries:
            req = e.req
            try:
                rec = self.resolver.resolve(req.job_id, req.map_id,
                                            req.reduce_id)
                served = rec.part_length
                if req.offset < 0 or req.offset >= max(served, 1):
                    raise StorageError(
                        f"offset {req.offset} outside partition "
                        f"(on-disk {served}) for {req.map_id}/"
                        f"{req.reduce_id}")
                e.rec = rec
                e.want = min(req.chunk_size or self.chunk_size_default,
                             served - req.offset)
                e.file_off = rec.start_offset + req.offset
            except Exception as exc:  # noqa: BLE001 - per request
                e.err = exc

    def _read_batch_runs(self, live: List[_BatchEntry]) -> None:
        """The preadv and pread rungs: group per MOF (one fd pin per file
        across the batch), coalesce, read."""
        by_path: Dict[str, List[_BatchEntry]] = {}
        for e in live:
            by_path.setdefault(e.rec.path, []).append(e)
        for path, group in by_path.items():
            if self.store is not None and self.store.manages(path):
                self._read_batch_store(path, group)
                continue
            try:
                fd = self._fds.acquire(path)
            except OSError as exc:
                for e in group:
                    e.err = StorageError(f"cannot open {path}: {exc}")
                continue
            try:
                for e in group:
                    e.fd = fd
                if self.io_backend == "preadv":
                    runs = plan_coalesced(
                        [(e, e.file_off, e.want) for e in group],
                        self.coalesce_gap_bytes, self.max_run_bytes)
                    for run in runs:
                        self._read_run_preadv(fd, run)
                else:  # the pread floor: one read a request, still one
                    # pool handoff for the batch
                    for e in group:
                        try:
                            data = os.pread(fd, e.want, e.file_off)
                            metrics.add("io.batch.reads", backend="pread")
                            e.buf = bytearray(data)
                            e.got = len(data)
                        except OSError as exc:
                            e.err = StorageError(
                                f"read failed at {path}:{e.file_off}: "
                                f"{exc}")
            finally:
                self._fds.release(path)

    def _read_batch_store(self, path: str,
                          group: List[_BatchEntry]) -> None:
        """One store-managed path group of a batch: the router's vectored
        read, a failed range failing only its own request."""
        results = self.store.read_ranges(
            path, [(e.file_off, e.want) for e in group],
            keys=[f"{e.req.map_id}/{e.req.reduce_id}" for e in group])
        for e, res in zip(group, results):
            if isinstance(res, Exception):
                e.err = res
            else:
                e.buf = bytearray(res)
                e.got = len(res)

    def _read_run_preadv(self, fd: int, run: List[tuple]) -> None:
        """One coalesced run -> one vectored read into per-request
        bytearrays (they become FetchResult.data) interleaved with scratch
        views over the gaps. A short read fails only the requests whose
        ranges the kernel did not fill."""
        entries = [item[0] for item in run]
        run_start = run[0][1]
        run_end = run[-1][1] + run[-1][2]
        gap_total = (run_end - run_start) - sum(e.want for e in entries)
        metrics.add("io.coalesce.runs")
        if gap_total > 0:
            metrics.add("io.coalesce.gap.bytes", gap_total)
        scratch = memoryview(bytearray(gap_total)) if gap_total else None
        iov: list = []
        spans: List[tuple] = []  # (entry, start-in-run, end-in-run)
        pos = run_start
        scratch_used = 0
        for e in entries:
            if e.file_off > pos:
                gap = e.file_off - pos
                iov.append(scratch[scratch_used:scratch_used + gap])
                scratch_used += gap
                pos = e.file_off
            e.buf = bytearray(e.want)
            iov.append(e.buf)
            spans.append((e, pos - run_start, pos - run_start + e.want))
            pos += e.want
        try:
            got, syscalls = _preadv_full(fd, iov, run_start)
        except OSError as exc:
            for e in entries:
                e.err = StorageError(
                    f"vectored read failed at {e.rec.path}:"
                    f"{run_start}: {exc}")
            return
        metrics.add("io.batch.reads", syscalls, backend="preadv")
        for e, lo, _ in spans:
            e.got = max(0, min(got - lo, e.want)) if got > lo else 0

    def _batch_finish(self, entries: List[_BatchEntry]) -> None:
        """Per entry: the short-read check, the CRC from the bytes as read
        (before a failpoint can mangle them), the two injection sites, the
        FetchResult."""
        for e in entries:
            req = e.req
            if e.err is None and e.got != e.want:
                e.err = StorageError(
                    f"short read {e.got}/{e.want} at {e.rec.path}:"
                    f"{e.file_off}")
            if e.err is not None:
                e.fut.set_exception(e.err)
                continue
            try:
                data = e.buf
                crc = zlib.crc32(data) & 0xFFFFFFFF if self._crc else None
                data = failpoint("data_engine.preadv", data=data,
                                 key=f"{e.fd}@{e.file_off}")
                data = failpoint("data_engine.pread", data=data,
                                 key=f"{req.map_id}/{req.reduce_id}")
                metrics.add("supplier.bytes", len(data))
                e.fut.set_result(FetchResult(
                    data, e.rec.raw_length, e.rec.part_length, req.offset,
                    e.rec.path, last=req.offset + len(data)
                    >= e.rec.part_length, crc=crc))
            except Exception as exc:  # noqa: BLE001 - injected faults stay
                # per request: batch-mates complete untouched
                e.err = exc
                e.fut.set_exception(exc)

    # -- the zero-copy serve plane -------------------------------------------

    def try_plan(self, req: ShuffleRequest) -> Optional[FdSlice]:
        """The synchronous zero-copy fast path: an FdSlice built inline
        from the index cache, no pool handoff, no IO. Returns None
        whenever planning would need blocking work (cold index entry, CRC
        stamping on, armed pread failpoint, stopped engine); the caller
        then falls back to :meth:`submit_serve`. Admission is submit()'s:
        an over-budget request raises StorageError, and the slice holds
        its charge until release()."""
        if self._stopped or not self.slice_eligible():
            return None
        rec = self.resolver.resolve_cached(req.job_id, req.map_id,
                                           req.reduce_id)
        if rec is None or self._store_managed(rec):
            # a store-managed partition needs the router's failover: no
            # slice can express a mid-read tier switch
            return None
        want_admit = req.chunk_size or self.chunk_size_default
        self._admit_bytes(want_admit, req.tenant)
        try:
            return self._build_slice(rec, req, want_admit)
        except BaseException:
            # bad offset or a failed open: the charge must unwind
            self._unadmit(want_admit, req.tenant)
            raise

    def _serve_plan(self, req: ShuffleRequest, admitted: int):
        """Worker-side body of submit_serve: resolve on the pool thread,
        then pin an FdSlice or fall through to the byte serve. An FdSlice
        keeps its admission charge until release(); every other outcome
        settles here."""
        sliced = False
        try:
            if self.slice_eligible():
                rec = self.resolver.resolve(req.job_id, req.map_id,
                                            req.reduce_id)
                if not self._store_managed(rec):
                    plan = self._build_slice(rec, req, admitted)
                    sliced = True
                    return plan
            with metrics.timer("supplier_read"):
                return self._serve_inner(req)
        finally:
            if not sliced:
                self._unadmit(admitted, req.tenant)

    def _build_slice(self, rec, req: ShuffleRequest,
                     admitted: int) -> FdSlice:
        """The slice constructor both plan paths share: offset check,
        chunk sizing, fd pin."""
        served = rec.part_length  # the on-disk domain
        if req.offset < 0 or req.offset >= max(served, 1):
            raise StorageError(
                f"offset {req.offset} outside partition (on-disk "
                f"{served}) for {req.map_id}/{req.reduce_id}")
        want = min(req.chunk_size or self.chunk_size_default,
                   served - req.offset)
        fd = self._fds.acquire(rec.path)
        metrics.add("supplier.bytes", want)
        return FdSlice(fd=fd, file_offset=rec.start_offset + req.offset,
                       length=want, raw_length=rec.raw_length,
                       part_length=rec.part_length, offset=req.offset,
                       path=rec.path, last=req.offset + want >= served,
                       _engine=self, _admitted=admitted,
                       _tenant=req.tenant)

    def fetch(self, req: ShuffleRequest) -> FetchResult:
        """Synchronous fetch, bounded by the fetch retry knobs (the
        per-attempt timeout, else the per-segment deadline, else 60 s); a
        timeout is a StorageError, like a dead disk's."""
        fut = self.submit(req)
        try:
            return fut.result(timeout=self.sync_fetch_timeout_s)
        except FutureTimeout as e:
            if fut.cancel():
                # cancelled while still queued: _serve never runs, so its
                # accounting is undone here
                self._unadmit(req.chunk_size or self.chunk_size_default,
                              req.tenant)
            raise StorageError(
                f"synchronous fetch of {req.map_id}/{req.reduce_id} at "
                f"offset {req.offset} did not complete within "
                f"{self.sync_fetch_timeout_s:g} s (bounded by the "
                f"mapred.rdma.fetch.* knobs)") from e

    def _serve(self, req: ShuffleRequest, admitted: int) -> FetchResult:
        try:
            with metrics.timer("supplier_read"):
                return self._serve_inner(req)
        finally:
            self._unadmit(admitted, req.tenant)

    def _serve_inner(self, req: ShuffleRequest) -> FetchResult:
        rec = self.resolver.resolve(req.job_id, req.map_id, req.reduce_id)
        served = rec.part_length  # the on-disk domain
        if req.offset < 0 or req.offset >= max(served, 1):
            raise StorageError(
                f"offset {req.offset} outside partition (on-disk "
                f"{served}) for {req.map_id}/{req.reduce_id}")
        want = min(req.chunk_size or self.chunk_size_default,
                   served - req.offset)
        if self._store_managed(rec):
            # the store's router: tier health, the store.get failpoint
            # and twin failover live there; the bytes come back through
            # the same CRC/failpoint tail as the fd path below
            data = self.store.read(
                rec.path, rec.start_offset + req.offset, want,
                key=f"{req.map_id}/{req.reduce_id}")
        else:
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

    def __enter__(self) -> "DataEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
