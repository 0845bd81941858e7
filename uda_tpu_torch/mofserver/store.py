"""Elastic disaggregated MOF storage: backends, spill ladder, failover.

The port's copy of ``uda_tpu/mofserver/store.py``. The reference pins
every map output to the supplier that produced it, so a job's footprint
and fault domain are welded to the map fleet; Exoshuffle-CloudSort
(arXiv:2301.03734) breaks that coupling to sort beyond cluster RAM. This
module is that seam:

- :class:`MOFStore`, the backend ABC. :class:`LocalFdStore` is the
  supplier-local fd/pread path (byte-identical; the DataEngine keeps its
  zero-copy FdSlice serve for partitions the store does not manage, see
  ``DataEngine.attach_store``). :class:`BlobStore` is the object-store
  tier: range reads over an emulated blob root, vectored through the
  batched plane's ``plan_coalesced``/``_preadv_full``, and CRC-verified
  streamed object writes.

- **Spill ladder** (:meth:`StoreManager.account_write` ->
  :meth:`StoreManager.maybe_spill`): when the supplier's locally
  retained MOF bytes cross the watermark (:func:`spill_watermark_bytes`:
  the explicit MB knob, else a fraction of the
  :class:`~uda_tpu_torch.utils.budget.MemoryBudget` host budget), whole
  partitions migrate oldest first to the blob tier: streamed copy, CRC
  read-back, the v2 UDIX index (stripe locators kept) rewritten at the
  blob root, the local index unlinked as the atomic cut-over (the index
  file is the DirIndexResolver's routing key), ``store.spilled.bytes``
  counted.

- **Degraded-backend failover** (:meth:`StoreManager.read`): each tier
  has PenaltyBox-style health (:class:`BackendHealth`); a read against a
  failing tier re-routes to the partition's twin on the surviving tier
  (blob->local when a spill kept a shadow, local->blob for replicated
  partitions), counted ``store.failover``. Failures are typed
  :class:`~uda_tpu_torch.utils.errors.StoreError` with structured
  ``cause``/``backend`` and feed the task's RecoveryLedger as the
  ``store`` rung; with no twin the typed error climbs the fetch ladder
  (retry, speculation, reconstruction) unchanged.

- **Drain** (:meth:`StoreManager.drain`): a departing supplier migrates
  its retained partitions to the blob tier (moved, not reconstructed)
  before its server stops: the storage half of mid-job membership (the
  net half is the CAP_ELASTIC/CAP_DRAINING HELLO bits).

Failpoint sites ``store.get``/``store.put``/``store.migrate`` are keyed
``<backend>:<key>`` so a spec's ``match:blob`` trigger kills exactly one
tier while the other keeps serving.

Left out, as in the port's other modules: the flight recorder's records,
the resource ledger's fd and migration obligations, and the reference's
lock-order instrumentation (a plain ``threading.Lock`` stands in).
"""

from __future__ import annotations

import abc
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from uda_tpu_torch.mofserver.index import (DirIndexResolver,
                                           read_index_file,
                                           write_index_file)
from uda_tpu_torch.utils.errors import StorageError, StoreError
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

log = get_logger()

__all__ = ["MOFStore", "LocalFdStore", "BlobStore", "BackendHealth",
           "StoreManager", "spill_watermark_bytes"]

_COPY_CHUNK = 1 << 20  # streamed-migration chunk: RSS stays O(1 MiB)


def spill_watermark_bytes(cfg, budget=None) -> int:
    """The supplier's local-retention watermark in bytes: the explicit
    MB knob when set, else ``uda.tpu.store.spill.frac`` of the host
    memory budget (the :class:`~uda_tpu_torch.utils.budget.MemoryBudget`
    derived-cap idiom, the detection ``stage_inflight_cap`` rides). 0 =
    the spill ladder is off. Only the host budget is read: the supplier
    runs no merge, so the budget is built for the CPU."""
    mb = int(cfg.get("uda.tpu.store.spill.watermark.mb"))
    if mb > 0:
        return mb << 20
    frac = float(cfg.get("uda.tpu.store.spill.frac"))
    if frac <= 0:
        return 0
    if budget is None:
        from uda_tpu_torch.utils.budget import MemoryBudget
        budget = MemoryBudget.from_config(cfg, device="cpu")
    return int(budget.host_budget_bytes * frac)


class MOFStore(abc.ABC):
    """One storage tier. ``read`` returns exactly ``length`` bytes or
    raises a typed :class:`StoreError` — short reads never escape as
    silent truncation (the Segment-side CRC would catch them late and
    blame the wire)."""

    name = "store"
    zero_copy = False  # may the DataEngine serve this tier via FdSlice?

    @abc.abstractmethod
    def read(self, path: str, file_off: int, length: int) -> bytes:
        """Range read: ``length`` bytes at ``file_off`` of ``path``."""

    def read_ranges(self, path: str,
                    ranges: Sequence[Tuple[int, int]]) -> List[bytes]:
        """Batch range read; the base implementation loops
        :meth:`read` (backends with a vectored plane override)."""
        return [self.read(path, off, ln) for off, ln in ranges]

    def acquire_fd(self, path: str) -> int:
        """Open a backend object for reading (paired with
        :meth:`release_fd`)."""
        try:
            return os.open(path, os.O_RDONLY)
        except OSError as e:
            raise StoreError(f"{self.name}: cannot open {path}: {e}",
                             cause="missing", backend=self.name) from e

    def release_fd(self, path: str, fd: int) -> None:
        os.close(fd)

    def _pread_full(self, path: str, file_off: int, length: int) -> bytes:
        fd = self.acquire_fd(path)
        try:
            data = os.pread(fd, length, file_off)
        except OSError as e:
            raise StoreError(
                f"{self.name}: read failed at {path}:{file_off}: {e}",
                cause="get", backend=self.name) from e
        finally:
            self.release_fd(path, fd)
        if len(data) != length:
            raise StoreError(
                f"{self.name}: short read {len(data)}/{length} at "
                f"{path}:{file_off}", cause="short_read",
                backend=self.name)
        return data

    def close(self) -> None:
        """Nothing is held between calls: every read opens and closes its
        own handle."""


class LocalFdStore(MOFStore):
    """Today's supplier-local fd path, extracted behind the seam.
    Byte-identical to the in-engine pread serve; the DataEngine keeps
    its zero-copy FdSlice fast path for partitions this tier owns
    exclusively (the store only intercepts store-managed paths)."""

    name = "local"
    zero_copy = True

    def read(self, path: str, file_off: int, length: int) -> bytes:
        return self._pread_full(path, file_off, length)


class BlobStore(MOFStore):
    """Object-store-style tier over an emulated blob root: range GETs
    (vectored through the batched plane's coalescer when the host has
    preadv)
    and CRC-verified streamed object PUTs. The on-disk layout mirrors
    the DirIndexResolver contract (``<root>/<job>/<map>/file.out`` +
    index) so the blob root slots into the resolver's root list and
    migrated partitions resolve with zero resolver changes."""

    name = "blob"
    zero_copy = False

    def __init__(self, root: str, gap_bytes: int = 64 << 10,
                 max_run_bytes: int = 8 << 20):
        self.root = os.path.abspath(root)
        self.gap_bytes = max(0, int(gap_bytes))
        self.max_run_bytes = max(1 << 16, int(max_run_bytes))
        os.makedirs(self.root, exist_ok=True)

    def read(self, path: str, file_off: int, length: int) -> bytes:
        return self._pread_full(path, file_off, length)

    def read_ranges(self, path: str,
                    ranges: Sequence[Tuple[int, int]]) -> List[bytes]:
        """Vectored range GET: coalesce adjacent ranges into runs
        (``plan_coalesced``, the batched plane's planner) and
        read each run with one preadv; hosts without preadv take the
        per-range floor."""
        if not ranges:
            return []
        if not hasattr(os, "preadv"):
            return [self.read(path, off, ln) for off, ln in ranges]
        # lazy import: data_engine imports nothing from this module,
        # but keeping the planner import out of module scope means a
        # half-initialized engine module can still import the store
        from uda_tpu_torch.mofserver.data_engine import (_preadv_full,
                                                         plan_coalesced)
        out: List[Optional[bytes]] = [None] * len(ranges)
        fd = self.acquire_fd(path)
        try:
            runs = plan_coalesced(
                [(i, off, ln) for i, (off, ln) in enumerate(ranges)],
                self.gap_bytes, self.max_run_bytes)
            for run in runs:
                run_start = run[0][1]
                run_end = run[-1][1] + run[-1][2]
                bufs = []
                iov: list = []
                pos = run_start
                for i, off, ln in run:
                    if off > pos:
                        iov.append(memoryview(bytearray(off - pos)))
                        pos = off
                    buf = bytearray(ln)
                    bufs.append((i, buf, pos - run_start))
                    iov.append(buf)
                    pos += ln
                try:
                    got, syscalls = _preadv_full(fd, iov, run_start)
                except OSError as e:
                    raise StoreError(
                        f"blob: vectored read failed at {path}:"
                        f"{run_start}: {e}", cause="get",
                        backend=self.name) from e
                metrics.add("store.blob.reads", syscalls)
                for i, buf, lo in bufs:
                    if got < lo + len(buf):
                        raise StoreError(
                            f"blob: short read at {path}:{run_start} "
                            f"(run length {run_end - run_start}, got "
                            f"{got})", cause="short_read",
                            backend=self.name)
                    out[i] = bytes(buf)
        finally:
            self.release_fd(path, fd)
        return [b for b in out if b is not None]

    def put_file(self, src: str, dst: str, key: str = "") -> Tuple[int, int]:
        """Streamed object PUT with CRC read-back verification:
        ``src`` is copied in :data:`_COPY_CHUNK` chunks (migration RSS
        stays O(1 MiB) regardless of partition size), then the stored
        object is re-read and its CRC32 compared — a torn or damaged
        PUT raises a typed :class:`StoreError` and the caller keeps
        the source copy authoritative. Returns (bytes, crc)."""
        failpoint("store.put", key=f"{self.name}:{key or dst}")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        crc = 0
        nbytes = 0
        with open(src, "rb") as fin, open(dst, "wb") as fout:
            while True:
                chunk = fin.read(_COPY_CHUNK)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                nbytes += len(chunk)
                fout.write(chunk)
        if self.object_crc(dst) != (crc & 0xFFFFFFFF):
            try:
                os.unlink(dst)  # never leave a corrupt object servable
            except OSError as e:
                metrics.add("errors.swallowed")
                log.warn(f"blob: cannot remove corrupt object {dst}: {e}")
            raise StoreError(
                f"blob: CRC mismatch after put of {src} -> {dst}",
                cause="crc", backend=self.name)
        return nbytes, crc & 0xFFFFFFFF

    def object_crc(self, path: str) -> int:
        """Streamed CRC32 of a stored object (the put verification and
        the checkpoint-resume locator revalidation both use this)."""
        crc = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(_COPY_CHUNK)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
        return crc & 0xFFFFFFFF


class BackendHealth:
    """Per-backend fault tracker, the PenaltyBox posture applied to
    storage tiers (``merger/merge_manager.PenaltyBox`` is the model):
    repeated faults box a tier for ``penalty_s`` and the router serves
    the twin tier proactively; a success decays the record. Boxing is
    never exclusion — a partition whose ONLY copy lives on a boxed
    tier is still read from it (progress beats politeness)."""

    def __init__(self, threshold: int = 2, penalty_s: float = 1.0):
        self.threshold = max(1, threshold)
        self.penalty_s = penalty_s
        self._lock = threading.Lock()
        self._faults: Dict[str, int] = {}
        self._until: Dict[str, float] = {}

    def punish(self, backend: str) -> bool:
        """Record one fault; True when this fault boxed the tier."""
        with self._lock:
            n = self._faults.get(backend, 0) + 1
            self._faults[backend] = n
            if n < self.threshold:
                return False
            self._until[backend] = time.monotonic() + self.penalty_s
        metrics.add("store.penalties", backend=backend)
        return True

    def forgive(self, backend: str) -> None:
        with self._lock:
            n = self._faults.get(backend)
            if n is None:
                return
            n -= 1
            if n <= 0:
                self._faults.pop(backend, None)
                self._until.pop(backend, None)
                return
            self._faults[backend] = n
            if n < self.threshold:
                self._until.pop(backend, None)

    def boxed(self, backend: str) -> bool:
        with self._lock:
            t = self._until.get(backend)
            if t is None:
                return False
            if time.monotonic() >= t:
                # parole: one more fault re-boxes (PenaltyBox posture)
                del self._until[backend]
                self._faults[backend] = self.threshold - 1
                return False
            return True

    def faults(self, backend: str) -> int:
        with self._lock:
            return self._faults.get(backend, 0)

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {"faults": dict(self._faults),
                    "boxed": [b for b, t in self._until.items()
                              if t > now]}


class StoreManager:
    """Placement policy + spill ladder + failover router over the two
    tiers. Attach to a DataEngine with ``engine.attach_store(mgr)``:
    the engine then routes reads of *store-managed* partitions (blob
    primaries and twin-holding local partitions) through
    :meth:`read`/:meth:`read_ranges`; everything else keeps the
    classic fd path, zero-copy serve included."""

    def __init__(self, resolver, blob_root: str, *,
                 watermark_bytes: int = 0, shadow: bool = False,
                 recovery=None, health: Optional[BackendHealth] = None):
        self.resolver = resolver
        self.blob_root = os.path.abspath(blob_root)
        self.local = LocalFdStore()
        self.blob = BlobStore(self.blob_root)
        self._backends: Dict[str, MOFStore] = {"local": self.local,
                                               "blob": self.blob}
        self.health = health or BackendHealth()
        self.recovery = recovery  # RecoveryLedger: the storage rung
        self.watermark_bytes = max(0, int(watermark_bytes))
        self.shadow = bool(shadow)
        self._lock = threading.Lock()
        # mof path -> its copy on the other tier (both directions);
        # the failover router's candidate table
        self._twin: Dict[str, str] = {}
        # (job, map) -> locally retained bytes, insertion-ordered so
        # the spill ladder evicts oldest-first
        self._retained: Dict[Tuple[str, str], int] = {}
        self._retained_total = 0
        self._migrations: List[dict] = []
        # the blob root joins the resolver's search path so migrated
        # partitions resolve with the stock map_dir walk (the local
        # index unlink below is the cut-over that makes it win)
        if isinstance(resolver, DirIndexResolver) \
                and self.blob_root not in resolver.roots:
            resolver.roots.append(self.blob_root)

    @classmethod
    def from_config(cls, resolver, cfg, recovery=None,
                    budget=None) -> Optional["StoreManager"]:
        """The flag-wired constructor: None when no blob root is
        configured (the seed behavior — supplier-local storage
        only)."""
        root = str(cfg.get("uda.tpu.store.blob.root"))
        if not root:
            return None
        return cls(
            resolver, root,
            watermark_bytes=spill_watermark_bytes(cfg, budget),
            shadow=bool(cfg.get("uda.tpu.store.shadow")),
            recovery=recovery,
            health=BackendHealth(
                threshold=int(cfg.get("uda.tpu.store.health.threshold")),
                penalty_s=float(
                    cfg.get("uda.tpu.store.health.penalty.ms")) / 1e3))

    # -- placement ----------------------------------------------------------

    def backend_of(self, path: str) -> str:
        return "blob" if os.path.abspath(path).startswith(
            self.blob_root + os.sep) else "local"

    def manages(self, path: str) -> bool:
        """Should the DataEngine route reads of ``path`` through the
        store? Blob primaries always (range-GET semantics + failover);
        local partitions only once they have a blob twin (replicated —
        the local->blob failover arrangement). Plain never-migrated
        local partitions stay on the classic fd path: byte-identical,
        zero-copy serve preserved."""
        if self.backend_of(path) == "blob":
            return True
        with self._lock:
            return path in self._twin

    def _candidates(self, path: str) -> List[Tuple[str, str]]:
        cands = [(self.backend_of(path), path)]
        with self._lock:
            twin = self._twin.get(path)
        if twin is not None and os.path.exists(twin):
            cands.append((self.backend_of(twin), twin))
        # proactive reroute: a boxed primary with a live twin serves
        # from the surviving tier without burning a failed attempt
        if len(cands) > 1 and self.health.boxed(cands[0][0]):
            metrics.add("store.rerouted", backend=cands[0][0])
            cands.reverse()
        return cands

    # -- the read path ------------------------------------------------------

    def _get(self, backend: str, path: str, file_off: int, length: int,
             key: str) -> bytes:
        t0 = time.perf_counter()
        failpoint("store.get", key=f"{backend}:{key or path}")
        data = self._backends[backend].read(path, file_off, length)
        metrics.observe("store.read.latency_ms",
                        (time.perf_counter() - t0) * 1e3, backend=backend)
        metrics.add("store.read.bytes", len(data), backend=backend)
        return data

    def read(self, path: str, file_off: int, length: int,
             key: str = "") -> bytes:
        """Failover range read: the partition's primary tier first
        (unless boxed with a live twin), the twin on a typed failure.
        Every fault punishes the tier's health and feeds the recovery
        ledger's ``store`` rung; success on a non-primary candidate
        counts ``store.failover``."""
        cands = self._candidates(path)
        primary = self.backend_of(path)
        last: Optional[StorageError] = None
        for backend, p in cands:
            try:
                data = self._get(backend, p, file_off, length, key)
            except StorageError as e:
                last = e
                self._fault(backend, key, e)
                continue
            self.health.forgive(backend)
            if backend != primary:
                metrics.add("store.failover", backend=backend)
            return data
        raise StoreError(
            f"no surviving store tier for {key or path} "
            f"({len(cands)} candidate(s) failed)", cause="get",
            backend=primary) from last

    def read_ranges(self, path: str, ranges: Sequence[Tuple[int, int]],
                    keys: Optional[Sequence[str]] = None) -> List[object]:
        """Batch read for the DataEngine's submit_batch plane: the
        primary tier's vectored read when healthy, per-range failover
        via :meth:`read` otherwise. Returns one ``bytes`` or
        ``Exception`` per range — per-request error isolation, the
        batch plane's contract."""
        keys = list(keys) if keys is not None else ["" for _ in ranges]
        backend = self.backend_of(path)
        if not self.health.boxed(backend):
            try:
                for k in keys:
                    failpoint("store.get", key=f"{backend}:{k or path}")
                t0 = time.perf_counter()
                data = self._backends[backend].read_ranges(path, ranges)
                metrics.observe("store.read.latency_ms",
                                (time.perf_counter() - t0) * 1e3,
                                backend=backend)
                metrics.add("store.read.bytes",
                            sum(len(b) for b in data), backend=backend)
                self.health.forgive(backend)
                return list(data)
            except StorageError as e:
                self._fault(backend, keys[0] if keys else path, e)
        else:
            metrics.add("store.rerouted", backend=backend)
        out: List[object] = []
        for (off, ln), k in zip(ranges, keys):
            try:
                out.append(self.read(path, off, ln, key=k))
            except StorageError as e:
                out.append(e)  # forwarded to that request's future
        return out

    def _fault(self, backend: str, key: str, error: Exception) -> None:
        metrics.add("store.errors", backend=backend)
        if self.health.punish(backend):
            log.warn(f"store: backend {backend!r} penalized after "
                     f"repeated faults ({error})")
        if self.recovery is not None:
            self.recovery.record("store", supplier=backend, map_id=key,
                                 error=error)

    # -- the spill ladder ---------------------------------------------------

    def account_write(self, job_id: str, map_id: str,
                      nbytes: int) -> None:
        """Writer hook: ``nbytes`` of MOF just landed on the local
        tier. Crossing the watermark triggers the spill ladder."""
        nbytes = int(nbytes)
        with self._lock:
            key = (job_id, map_id)
            self._retained[key] = self._retained.get(key, 0) + nbytes
            self._retained_total += nbytes
        metrics.gauge_add("store.local.retained.bytes", nbytes)
        self.maybe_spill()

    def retained_bytes(self) -> int:
        with self._lock:
            return self._retained_total

    def maybe_spill(self) -> List[dict]:
        """Migrate oldest-first while retained bytes exceed the
        watermark. Spill is an optimization: a failed migration leaves
        the partition locally servable and the ladder retries at the
        next write."""
        out: List[dict] = []
        while True:
            with self._lock:
                if (self.watermark_bytes <= 0 or not self._retained
                        or self._retained_total <= self.watermark_bytes):
                    return out
                job_id, map_id = next(iter(self._retained))
            try:
                out.append(self.migrate(job_id, map_id, reason="spill",
                                        shadow=self.shadow))
            except StorageError as e:
                metrics.add("errors.swallowed")
                log.warn(f"store: spill of {job_id}/{map_id} failed "
                         f"(partition stays local, retried at the next "
                         f"write): {e}")
                return out

    # -- migration ----------------------------------------------------------

    def _local_dir(self, job_id: str, map_id: str) -> str:
        if isinstance(self.resolver, DirIndexResolver):
            for r in self.resolver.roots:
                if r == self.blob_root:
                    continue
                d = os.path.join(r, job_id, map_id)
                if os.path.exists(os.path.join(d, "file.out.index")):
                    return d
            return os.path.join(self.resolver.root, job_id, map_id)
        raise StoreError(
            f"store: cannot locate local dir of {job_id}/{map_id} "
            f"(resolver has no directory layout)", cause="missing",
            backend="local")

    def migrate(self, job_id: str, map_id: str, *, reason: str = "spill",
                shadow: Optional[bool] = None,
                cutover: bool = True) -> dict:
        """Move one whole MOF partition set to the blob tier: streamed
        CRC-verified object PUT, the v2 UDIX index (stripe locators
        preserved) rewritten at the blob root, then — with ``cutover``
        — the local index unlinked (the resolver's routing key: the
        next resolve finds the blob copy) and the resolver cache
        invalidated. ``shadow`` keeps the local ``file.out`` as the
        blob tier's failover twin; ``cutover=False`` replicates
        instead (blob copy + twin registration, local stays primary —
        the local->blob failover arrangement). All-or-nothing: any
        failure before the cut-over leaves the local copy
        authoritative and servable."""
        shadow = self.shadow if shadow is None else bool(shadow)
        key = f"{job_id}/{map_id}"
        src_dir = self._local_dir(job_id, map_id)
        src_mof = os.path.join(src_dir, "file.out")
        src_idx = os.path.join(src_dir, "file.out.index")
        if not (os.path.exists(src_mof) and os.path.exists(src_idx)):
            raise StoreError(f"store: no local MOF for {key} under "
                             f"{src_dir}", cause="missing",
                             backend="local")
        failpoint("store.migrate", key=f"local:{key}")
        nbytes = os.path.getsize(src_mof)
        dst_dir = os.path.join(self.blob_root, job_id, map_id)
        dst_mof = os.path.join(dst_dir, "file.out")
        dst_idx = os.path.join(dst_dir, "file.out.index")
        # bytes mid-migration, a paired gauge: a migration that dies
        # with it up is a leak
        metrics.gauge_add("store.migrate.bytes.on_air", nbytes)
        try:
            copied, crc = self.blob.put_file(src_mof, dst_mof, key=key)
            # the index is rewritten (not copied) so the v2 stripe
            # section survives byte-exact through the re-encode — the
            # locators keep addressing the (identical) blob object
            records = read_index_file(src_idx, dst_mof)
            triples = [(r.start_offset, r.raw_length, r.part_length)
                       for r in records]
            stripe = None
            if records and records[0].stripe is not None:
                st = records[0].stripe
                stripe = (st.k, st.n,
                          [list(r.stripe.parity) for r in records])
            write_index_file(dst_idx, triples, stripe=stripe)
        finally:
            metrics.gauge_add("store.migrate.bytes.on_air", -nbytes)
        if cutover:
            os.unlink(src_idx)  # the atomic routing cut-over
            if shadow:
                with self._lock:
                    self._twin[dst_mof] = src_mof
                    self._twin[src_mof] = dst_mof
            else:
                os.unlink(src_mof)
        else:
            with self._lock:
                self._twin[dst_mof] = src_mof
                self._twin[src_mof] = dst_mof
        invalidate = getattr(self.resolver, "invalidate", None)
        if invalidate is not None:
            invalidate(job_id)
        with self._lock:
            retained = self._retained.pop((job_id, map_id), 0)
            self._retained_total -= retained
        if retained:
            metrics.gauge_add("store.local.retained.bytes", -retained)
        metrics.add("store.migrations", reason=reason)
        metrics.add("store.migrated.bytes", copied)
        if reason == "spill":
            metrics.add("store.spilled.bytes", copied)
        entry = {"job": job_id, "map": map_id, "reason": reason,
                 "src": src_mof, "dst": dst_mof, "bytes": copied,
                 "crc": crc, "shadow": shadow, "cutover": cutover}
        # the migration log is appended on the producer/drain thread and
        # read by resume revalidation on the merge thread: every touch
        # goes through self._lock
        with self._lock:
            self._migrations.append(entry)
        log.info(f"store: migrated {key} -> blob tier ({copied} bytes, "
                 f"reason={reason}, shadow={shadow}, cutover={cutover})")
        return entry

    def replicate(self, job_id: str, map_id: str) -> dict:
        """Blob replica of a local-primary partition (the local->blob
        failover arrangement; reads keep the local fast path until the
        local tier faults)."""
        return self.migrate(job_id, map_id, reason="replicate",
                            shadow=True, cutover=False)

    # -- elasticity: drain + resume revalidation ----------------------------

    def drain(self, job_id: Optional[str] = None) -> List[dict]:
        """The departing supplier's storage handoff: migrate every
        retained partition (optionally one job's) to the blob tier —
        moved, NOT left for parity reconstruction — so its partitions
        stay fetchable after the server stops warm."""
        out: List[dict] = []
        while True:
            with self._lock:
                pending = [k for k in self._retained
                           if job_id is None or k[0] == job_id]
            if not pending:
                break
            j, m = pending[0]
            out.append(self.migrate(j, m, reason="drain", shadow=False))
        if out:
            metrics.add("store.drained.partitions", len(out))
        return out

    def validate_spilled(self, job_id: Optional[str] = None) -> int:
        """Checkpoint-resume hook (``merger/checkpoint.py``):
        re-verify the streamed CRC of every spilled blob object before
        a resumed task trusts its locators — a blob object damaged
        while the task was down must surface as a typed error at
        resume, not as a late Segment CRC mismatch blamed on the
        wire."""
        n = 0
        with self._lock:
            entries = list(self._migrations)
        for entry in entries:
            if job_id is not None and entry["job"] != job_id:
                continue
            dst = entry["dst"]
            if not os.path.exists(dst):
                raise StoreError(
                    f"store: spilled object {dst} missing at resume "
                    f"revalidation", cause="missing", backend="blob")
            if self.blob.object_crc(dst) != entry["crc"]:
                raise StoreError(
                    f"store: spilled object {dst} failed CRC "
                    f"revalidation at resume", cause="crc",
                    backend="blob")
            n += 1
        if n:
            metrics.add("store.revalidated", n)
        return n

    # -- introspection / lifecycle ------------------------------------------

    def migrations(self) -> List[dict]:
        with self._lock:
            return list(self._migrations)

    def snapshot(self) -> dict:
        """Stats-surface view: health, retention level, migrations."""
        with self._lock:
            retained = dict(self._retained)
            total = self._retained_total
            nmig = len(self._migrations)
        return {"health": self.health.snapshot(),
                "retained_bytes": total,
                "retained_partitions": len(retained),
                "watermark_bytes": self.watermark_bytes,
                "migrations": nmig}

    def close(self) -> None:
        self.local.close()
        self.blob.close()
