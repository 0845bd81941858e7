"""Segments: streaming views of one map-output partition.

The port's copy of ``uda_tpu/merger/segment.py``: the transport
abstraction, the in-process client, the per-host routing client and the
chunked fetch with partial-record carry, attempt timeouts, CRC re-fetch
and whole-segment retry, the ``segment.fetch`` failpoint, the
administrative ``fail()`` (the watchdog's and ``stop()``'s rescue), the
checkpoint's offset ledger (``ckpt_export``/``ckpt_preload``) and the
survivable-shuffle rungs: speculative dual-source fetch, the
transport-retry mid-partition resume and k-of-n stripe reconstruction.
``HostRoutingClient``'s default connect dials suppliers over sockets
(``net/client.py``). Each segment's fetch is a ``fetch.segment`` span
under the task's ``reduce_task`` span, the transport's parent for every
request it issues; its transitions are flight-recorder events.

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

from uda_tpu_torch import native
from uda_tpu_torch.coding.recovery import start_recovery
from uda_tpu_torch.mofserver.data_engine import (DataEngine, FetchResult,
                                                 ShuffleRequest)
from uda_tpu_torch.tenant import current_tenant
from uda_tpu_torch.utils.errors import (MergeError, StorageError,
                                        TenantError, TransportError,
                                        attribute_supplier)
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.flightrec import flightrec
from uda_tpu_torch.utils.ifile import RecordBatch, crack_partial
from uda_tpu_torch.utils.locks import TrackedLock
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.retry import RetryPolicy, SpeculationPolicy

log = get_logger()

__all__ = ["InputClient", "LocalFetchClient", "HostRoutingClient",
           "Segment"]


class InputClient(abc.ABC):
    """Transport abstraction (reference InputClient.h:30-56)."""

    @abc.abstractmethod
    def start_fetch(self, req: ShuffleRequest, on_complete) -> None:
        """Async fetch; ``on_complete(FetchResult | Exception)``."""

    def estimate_partition_bytes(self, job_id: str, map_ids,
                                 reduce_id: int):
        """Best-effort size of this reduce partition across ``map_ids``, or
        None when the transport cannot know it without fetching (the auto
        merge approach then takes the bounded-memory path)."""
        return None

    def resume_ok(self, host: str = "") -> bool:
        """May a segment keep its offset ledger and continue
        mid-partition? True by default: MOFs are immutable files."""
        return True

    def speculate_ok(self) -> bool:
        """May the straggler detector issue a duplicate in-flight fetch
        for the same (job, map, reduce) through this transport? True by
        default: stateless transports serve concurrent duplicates
        independently (the reference's stateful decompressing wrapper
        answers False)."""
        return True

    def generation(self, host: str = "") -> Optional[int]:
        """The supplier's restart generation for ``host``, or None when the
        transport has none. A checkpoint's ledger recorded under another
        generation is dropped on resume (its run files are kept)."""
        return None

    def recover_partition(self, req: ShuffleRequest, ctx,
                          on_complete) -> bool:
        """k-of-n stripe reconstruction (``coding``): rebuild ``req``'s
        whole partition from any k of its n stripe chunks, delivering a
        full-partition FetchResult (or an Exception) to ``on_complete``.
        Returns False when unsupported (no stripe context): the Segment
        then fails terminally. The default drives the recovery over this
        transport's ``start_fetch`` (shard pseudo-maps route per host
        like any other fetch)."""
        if ctx is None:
            return False
        start_recovery(self, req, ctx, on_complete)
        return True

    def stop(self) -> None:
        pass


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

    def estimate_partition_bytes(self, job_id: str, map_ids,
                                 reduce_id: int):
        """Sum of raw_length over the map outputs. Exact or unknown: any
        unresolvable map makes the whole estimate None (a partial sum is a
        lower bound, which could steer the auto policy onto the
        host-resident path for a partition that is really huge)."""
        total = 0
        for mid in map_ids:
            try:
                total += int(self.engine.resolver.resolve(
                    job_id, mid, reduce_id).raw_length)
            except Exception as e:  # noqa: BLE001 - exact-or-unknown
                metrics.add("errors.swallowed")
                log.debug(f"size estimate: {mid} unresolvable ({e}); "
                          f"partition size unknown")
                return None
        return total


class HostRoutingClient(InputClient):
    """Per-supplier-host transport table with lazy connect.

    The reference's reduce-side client opens one connection per supplier
    host on first use and caches it (reference
    src/DataNet/RDMAClient.cc:498-527, 602-629). Here ``connect(host)``
    builds the host's transport (e.g. a LocalFetchClient over that host's
    DataEngine) the first time a fetch addresses it; every later fetch for
    the host reuses it, and a losing concurrent connect for the same host
    is torn down. A failed connect surfaces through the fetch's completion
    callback like any transport error.

    With no ``connect`` the router defaults to the socket data plane: each
    host dials that supplier's ShuffleServer as ``host[:port]`` (the port
    defaulting to ``uda.tpu.net.port``) through a
    :class:`~uda_tpu_torch.net.client.RemoteFetchClient`, one multiplexed
    connection per supplier host.

    Elastic membership (``notify_join``/``notify_drain``) is advisory
    routing state: fetches still address whatever host the entry names;
    ``members``/``is_draining`` report it, and
    ``MergeManager.notify_join`` widens in-flight segments beside it.
    Push registrations (``push_register``) are applied to every transport
    the router builds, including ones dialled after the registration (a
    joiner, a re-dial after ``refresh``)."""

    def __init__(self, connect=None, config=None):
        self._connect = (connect if connect is not None
                         else self._socket_factory(config))
        self._clients: dict[str, InputClient] = {}
        self._stopped = False
        self._members: set[str] = set()
        self._draining: set[str] = set()
        self._push_regs: dict = {}   # (job, reduce) -> staging
        self._lock = TrackedLock("host_router")

    @staticmethod
    def _socket_factory(config):
        """The default connect: dial ``host[:port]`` over TCP (imported
        lazily: ``net`` imports this module)."""
        def connect(host: str) -> InputClient:
            from uda_tpu_torch.net.client import RemoteFetchClient
            from uda_tpu_torch.utils.config import Config

            # accepted shapes: "name", "name:port", "[v6addr]:port", and
            # a bare IPv6 literal (two or more colons, no brackets)
            name, port = host, ""
            if host.startswith("["):
                name, bracket, rest = host[1:].partition("]")
                if not bracket or (rest and not rest.startswith(":")):
                    raise TransportError(
                        f"malformed supplier address {host!r}")
                port = rest[1:]
            elif host.count(":") == 1:
                name, _, port = host.partition(":")
            if not name:
                # an empty host would resolve to localhost and misdirect
                # the fetch to whatever listens there: a wiring bug
                raise TransportError(
                    "socket fetch routing needs a supplier host per "
                    "map entry; got an empty host")
            if port and not port.isdigit():
                raise TransportError(
                    f"malformed supplier port in {host!r}")
            return RemoteFetchClient(
                name, int(port) if port else None,
                config=config or Config())
        return connect

    def _client_for(self, host: str) -> InputClient:
        with self._lock:
            if self._stopped:
                raise MergeError("HostRoutingClient is stopped")
            client = self._clients.get(host)
        if client is None:
            client = self._connect(host)
            with self._lock:
                if self._stopped:
                    loser = client  # connected after stop(): tear down
                else:
                    # a concurrent connect for the same host may have won;
                    # the loser is torn down, not leaked
                    winner = self._clients.setdefault(host, client)
                    loser = None if winner is client else client
                    client = winner
            if loser is not None:
                loser.stop()
            with self._lock:
                if self._stopped:
                    raise MergeError("HostRoutingClient is stopped")
                regs = list(self._push_regs.items())
            self._apply_push_regs(client, regs)
        return client

    @staticmethod
    def _apply_push_regs(client: InputClient, regs) -> None:
        """Subscribe armed push registrations on one transport;
        transports without a push plane (LocalFetchClient, custom
        connects) stay pull only."""
        reg = getattr(client, "push_register", None)
        if not callable(reg):
            return
        for (job_id, reduce_id), staging in regs:
            reg(job_id, reduce_id, staging)

    # -- the push plane ------------------------------------------------------

    def push_register(self, job_id: str, reduce_id: int, staging,
                      hosts=None) -> None:
        """Register reduce-side staging across the supplier fleet: every
        cached transport subscribes now, every later one when it is
        built. ``hosts`` (and the members) are dialled eagerly so pushes
        can arrive before the first fetch; a failed dial leaves that host
        pull only until it is fetched from."""
        with self._lock:
            if self._stopped:
                return
            self._push_regs[(job_id, int(reduce_id))] = staging
            cached = list(self._clients.values())
        regs = [((job_id, int(reduce_id)), staging)]
        for client in cached:
            self._apply_push_regs(client, regs)
        for host in set(hosts or ()) | set(self.members()):
            try:
                self._client_for(host)  # the build applies the regs
            except Exception:  # noqa: BLE001 - the eager dial is advisory
                metrics.add("push.dial.failures", supplier=host)

    def push_unregister(self, job_id: str, reduce_id: int) -> None:
        with self._lock:
            self._push_regs.pop((job_id, int(reduce_id)), None)
            cached = list(self._clients.values())
        for client in cached:
            unreg = getattr(client, "push_unregister", None)
            if callable(unreg):
                unreg(job_id, reduce_id)

    # -- elastic membership --------------------------------------------------

    def notify_join(self, host: str) -> None:
        """A supplier registered mid-job: fold it into the membership and
        refresh a stale cached transport, so the next fetch re-dials and
        reads the joiner's current banner."""
        with self._lock:
            already = host in self._members
            self._members.add(host)
            self._draining.discard(host)
        if not already:
            metrics.add("elastic.joins", supplier=host)
        self.refresh(host)

    def notify_drain(self, host: str) -> None:
        """A supplier announced departure: its transport stays (in-flight
        fetches complete against it) but candidate ranking demotes it."""
        with self._lock:
            self._members.discard(host)
            self._draining.add(host)

    def refresh(self, host: str) -> None:
        """Drop the host's cached transport (stopping it) so the next
        fetch re-dials; a no-op for an unconnected host."""
        with self._lock:
            client = self._clients.pop(host, None)
        if client is not None:
            client.stop()

    def members(self) -> list[str]:
        """The advisory membership (joiners minus announced leavers),
        sorted for deterministic placement."""
        with self._lock:
            return sorted(self._members)

    def is_draining(self, host: str) -> bool:
        """Has this host announced drain, through notify_drain or a
        CAP_DRAINING banner its live transport saw?"""
        with self._lock:
            if host in self._draining:
                return True
            client = self._clients.get(host)
        probe = getattr(client, "peer_draining", None)
        return bool(probe(host)) if callable(probe) else False

    def start_fetch(self, req: ShuffleRequest, on_complete) -> None:
        try:
            client = self._client_for(req.host)
        except Exception as e:  # noqa: BLE001 - connect failure ->
            on_complete(e)      # completion error, like the reference
            return
        client.start_fetch(req, on_complete)

    def resume_ok(self, host: str = "") -> bool:
        """Delegate to the host's transport; an unconnected host is
        resumable by default (the reconnect itself revalidates)."""
        with self._lock:
            client = self._clients.get(host)
        return True if client is None else client.resume_ok(host)

    def generation(self, host: str = "") -> Optional[int]:
        """Delegate to the host's transport; an unconnected host has no
        observed generation yet."""
        with self._lock:
            client = self._clients.get(host)
        return None if client is None else client.generation(host)

    def estimate_partition_bytes(self, job_id: str, map_ids,
                                 reduce_id: int):
        """Per-host fan-out of the size estimate: entries group by
        supplier host and each host's transport answers for its own maps.
        Exact-or-unknown like LocalFetchClient: any host that cannot
        answer makes the whole estimate None. Replicated entries (a host
        list per map) are estimated against their first (primary) host."""
        by_host: dict[str, list[str]] = {}
        for entry in map_ids:
            host, mid = entry if isinstance(entry, tuple) else ("", entry)
            if isinstance(host, (list, tuple)):
                host = host[0] if host else ""
            by_host.setdefault(host, []).append(mid)

        def probe(host: str, mids: list[str]):
            try:
                return self._client_for(host).estimate_partition_bytes(
                    job_id, mids, reduce_id)
            except Exception as e:  # noqa: BLE001 - best effort, counted
                metrics.add("errors.swallowed")
                log.debug(f"size estimate: probe of host {host!r} "
                          f"failed ({e}); partition size unknown")
                return None

        if len(by_host) == 1:  # the common case, no thread overhead
            host, mids = next(iter(by_host.items()))
            return probe(host, mids)
        # many hosts: probe concurrently, so one slow supplier's probe
        # does not stack per host
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(16, len(by_host)),
                thread_name_prefix="uda-size-probe") as pool:
            estimates = list(pool.map(lambda kv: probe(*kv),
                                      by_host.items()))
        if any(est is None for est in estimates):
            return None
        return sum(estimates)

    def stop(self) -> None:
        # timed apart from each connection's stop, which times its own
        with metrics.timer("client_stop"), self._lock:
            self._stopped = True
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.stop()


class Segment:
    """One partition's record stream, fetched chunk-wise with a carry
    buffer for records split across chunk boundaries.

    Drives ``chunk_size``-byte fetches at increasing offsets until the
    last chunk has arrived (the reference's send_request / switch_mem
    loop, StreamRW.cc:462-590). Completed chunks are cracked into
    RecordBatches immediately. A transport error restarts the whole
    segment from offset 0 while retries are left (``RetryPolicy``); every
    attempt has its own epoch, so a completion that arrives after its
    attempt was superseded is dropped as stale.

    Survivable-shuffle ladder (every rung shares the task's
    :class:`~uda_tpu_torch.merger.recovery.RecoveryLedger`):

    - **speculation** (``uda.tpu.fetch.speculate.pn``): an in-flight
      chunk that outlives max(floor, pN of the observed
      ``fetch.latency_ms`` histogram) gets a DUPLICATE fetch issued to
      the best-ranked alternate source (PenaltyBox rank over
      ``hosts``; the same source when no alternate exists).
      First-completion-wins rides the attempt-epoch machinery — the
      loser's completion is discarded as stale — and a speculation win
      switches the segment to the faster source for its remaining
      chunks. Each race is timed from the primary's issue to the
      completion that settles it (``fetch_hedge``), and the bytes the
      winning source then serves count as ``fetch.hedged.bytes``;
    - **resume** (``uda.tpu.fetch.resume``): a transport-level retry
      against a resumable source (InputClient.resume_ok — warm
      supplier restart, immutable MOFs) keeps the offset ledger
      (batches + carry + next offset) and continues mid-partition
      instead of refetching from zero; the first resumed chunk's
      ``raw_length`` must match the pre-fault identity or the segment
      falls back to a full restart;
    - **reconstruction** (``uda.tpu.coding.scheme``): once retries are
      exhausted, the partition is rebuilt from any k of its n erasure
      stripe chunks on the surviving suppliers
      (InputClient.recover_partition) — the rung that turns a dead
      supplier from a FallbackSignal into a completed task.
    """

    def __init__(self, client: InputClient, job_id: str, map_id: str,
                 reduce_id: int, chunk_size: int, host: str = "",
                 retries: int = 3, policy: Optional[RetryPolicy] = None,
                 *, hosts=None, ledger=None,
                 speculation: Optional[SpeculationPolicy] = None,
                 resume: bool = False, stripe=None):
        self.client = client
        self.job_id = job_id
        self.map_id = map_id
        self.reduce_id = reduce_id
        self.chunk_size = chunk_size
        # candidate sources: ``hosts`` are suppliers known to hold this
        # map output (replicas); the primary is (re)picked by ledger
        # rank, speculation duplicates to the best alternate
        self.hosts: list[str] = [h for h in (hosts or ([host] if host
                                                       else [""]))]
        self.host = host or self.hosts[0]
        self.ledger = ledger
        self.speculation = speculation
        if speculation is not None:
            speculation.keep_latencies()
        self.resume_enabled = bool(resume)
        self.stripe = stripe  # StripeContext when k-of-n coding is on
        self.batches: list[RecordBatch] = []
        self.num_records = 0  # monotone fetch-side record count
        self.raw_length: Optional[int] = None
        self.on_done = None  # callback fired once when fetch finishes
        self.on_fault = None  # callback fired on EVERY transport fault
        # (retried or terminal) — the penalty-box feedback channel
        self.policy = policy or RetryPolicy(retries=max(0, retries))
        self.trace_span = None
        self._issue_t0 = 0.0
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
        self._next_epoch = 0     # attempt-id allocator (monotone)
        self._epoch = 0          # id of the outstanding PRIMARY attempt
        self._spec: Optional[tuple] = None  # (epoch, host) of the live
        # speculative duplicate, if any — the `speculative` epoch flag
        self._hedge = None  # the open race's fetch_hedge timer
        self._hedge_source: Optional[str] = None  # the source that won
        # this segment's last race: its bytes count as fetch.hedged.bytes
        self._epoch_settled = True  # the attempt group has completed
        self._open_attempts = 0  # live attempts (on-air accounting)
        self._attempt_hosts: dict[int, str] = {}
        self._resume_check = False   # next chunk must revalidate identity
        self._recover_tried = False  # the reconstruction rung is one-shot
        self._timeout_timer: Optional[threading.Timer] = None
        self._spec_timer: Optional[threading.Timer] = None
        self._done = threading.Event()
        self._error: Optional[Exception] = None
        # the state machine is driven from transport completion threads,
        # retry and speculation timers and the merge thread
        self._lock = TrackedLock("segment.state")

    @property
    def supplier(self) -> str:
        """The metric/penalty label of the CURRENT source (host when
        routed per host, else the map id); tracks speculation wins."""
        return self.host or self.map_id

    def add_host(self, host: str) -> bool:
        """A supplier that joined mid-job widens this in-flight segment's
        candidates, so the ledger-ranked paths (retry re-pick,
        speculation alternate, reconstruction) can elect it; no attempt is
        re-routed eagerly. True when the host was added (unknown and the
        segment not done)."""
        if not host:
            return False
        with self._lock:
            if self._done.is_set() or host in self.hosts:
                return False
            self.hosts.append(host)
        return True

    def _notify_done(self, err: Optional[Exception]) -> None:
        span = self.trace_span
        if span is not None:
            span.end(**({"error": type(err).__name__} if err else {}))
        cb = self.on_done
        if cb is not None:
            with metrics.timer("fetch_handoff"):
                cb(self)

    def _finish(self, error: Optional[Exception]) -> bool:
        """The only terminal transition: the first caller wins, so on_done
        fires exactly once."""
        with self._lock:
            if self._done.is_set():
                return False
            self._error = error
            self._done.set()
        # black-box state transition (per segment, off the chunk path)
        flightrec.record("segment.done", map=self.map_id,
                         supplier=self.supplier,
                         error=type(error).__name__ if error else None)
        self._notify_done(error)
        return True

    # -- fetch driving ------------------------------------------------------

    _PENDING = object()  # sentinel: no inline completion delivered

    def start(self) -> None:
        if self.policy.deadline_ms > 0:
            self._deadline = time.monotonic() + self.policy.deadline_ms / 1e3
        # consult box rank BEFORE the primary pick, not only on fault:
        # a replicated segment opens against the healthiest source
        if len(self.hosts) > 1 and self.ledger is not None:
            self.host = self.ledger.rank(self.hosts)[0]
        # child of the caller's current span (the fetch phase of the
        # reduce-task trace); ended by _notify_done on any terminal path
        self.trace_span = metrics.start_span(
            "fetch.segment", map=self.map_id, supplier=self.supplier,
            reduce=self.reduce_id)
        flightrec.record("segment.start", map=self.map_id,
                         supplier=self.supplier)
        with self._lock:
            resume_at = self._next_offset
        if resume_at > 0:
            # checkpoint-preloaded offset ledger (ckpt_preload): the
            # fetch continues mid-partition; the bytes below the offset
            # are never refetched, and the first chunk revalidates the
            # partition identity through the _resume_check ladder
            metrics.add("fetch.resumed", supplier=self.supplier)
            metrics.add("fetch.resumed.bytes", resume_at)
            flightrec.record("segment.ckpt_resume", map=self.map_id,
                             supplier=self.supplier, offset=resume_at)
            log.info(f"fetch of {self.map_id} resuming at offset "
                     f"{resume_at} from a checkpointed ledger")
        self._drive(self._try_issue(resume_at))

    def _try_issue(self, offset: int):
        """Issue one fetch. Returns None when the transport took it
        asynchronously (the completion callback will fire later), or
        the RESULT (FetchResult or Exception) when the transport raised
        synchronously / invoked the callback inline — the caller's
        _drive loop then processes it WITHOUT recursing, so a transport
        that fails inline (e.g. a router's connect error) cannot
        overflow the stack however large the retry budget is.

        Each issue opens a new attempt epoch; completions (real,
        injected, or timeout-generated) carry their epoch and only the
        FIRST one for the current epoch is accepted — a late completion
        racing its own attempt timeout is dropped as stale instead of
        double-driving the state machine."""
        with self._lock:
            if self._done.is_set():
                # administratively failed (fail()) while a retry backoff
                # timer was pending: the segment is finished — issuing
                # would open a fresh epoch on a dead segment and fire
                # on_done twice when it completed
                return None
            self._inline = self._PENDING
            self._issuing = True
            self._next_epoch += 1
            self._epoch = self._next_epoch
            self._epoch_settled = False
            self._open_attempts += 1
            self._issue_t0 = time.perf_counter()
            epoch = self._epoch
            host = self.host
            self._attempt_hosts[epoch] = host
        req = ShuffleRequest(self.job_id, self.map_id, self.reduce_id,
                             offset, self.chunk_size, host=host)
        # on-air accounting (reference AIOHandler on-air counters):
        # +1 per attempt epoch, -1 when that epoch settles (accepted
        # completion, timeout-generated completion, sync raise, or
        # abandonment of a speculation loser)
        # the +1 hands off to the attempt epoch: _on_complete (accepted
        # or timeout-generated completion) owns the -1; only the sync
        # raise below settles it here
        metrics.gauge_add("fetch.on_air", 1)  # udalint: disable=UDA101 - _on_complete owns the -1
        try:
            # the failpoint is inside the try: an injected raise takes
            # the same sync-failure path as a stopped transport. The
            # key carries map AND source so chaos schedules can target
            # one supplier of a replicated segment (match:@host)
            failpoint("segment.fetch", key=f"{self.map_id}@{host}")
            # the segment's span is the transport's parent for this issue:
            # spans a transport opens (net.fetch) join the fetch span tree
            # even when the issue happens on a completion thread
            with metrics.use_span(self.trace_span):
                self.client.start_fetch(
                    req, lambda res, e=epoch: self._on_complete(res, e))
        except Exception as e:  # noqa: BLE001 - a sync raise must fail
            # the segment, never escape into the transport's thread
            with self._lock:
                self._issuing = False
                # settle only a live attempt: fail() (watchdog rescue /
                # stop drain) may have settled this epoch's on-air
                # charge while we were wedged inside the issue
                live = epoch in self._attempt_hosts
                if live:
                    self._epoch_settled = True
                    self._open_attempts -= 1
                    self._attempt_hosts.pop(epoch, None)
            if live:
                metrics.gauge_add("fetch.on_air", -1)
            return e
        with self._lock:
            self._issuing = False
            r = self._inline
            self._inline = self._PENDING
            if r is self._PENDING and not self._epoch_settled:
                self._arm_timeout(epoch)  # only for an async in-flight fetch
                self._arm_speculation(epoch, offset)
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
            s, self._spec_timer = self._spec_timer, None
        if t is not None:
            t.cancel()
        if s is not None:
            s.cancel()

    def _on_timeout(self, epoch: int) -> None:
        with self._lock:
            spec_epoch = self._spec[0] if self._spec else None
            if epoch not in (self._epoch, spec_epoch) \
                    or self._epoch_settled:
                return  # the attempt completed first
        tenant = current_tenant()
        if tenant:
            metrics.add("fetch.timeouts", supplier=self.supplier,
                        tenant=tenant)
        else:
            metrics.add("fetch.timeouts", supplier=self.supplier)
        self._on_complete(TransportError(
            f"fetch of {self.map_id} attempt timed out after "
            f"{self.policy.attempt_timeout_ms:g} ms"), epoch)

    # -- speculation (the straggler detector) -------------------------------

    def _arm_speculation(self, epoch: int, offset: int) -> None:
        """Arm the straggler timer for one in-flight attempt (caller
        holds self._lock): fires at max(floor, pN of the observed
        fetch.latency_ms histogram)."""
        sp = self.speculation
        if sp is None or not sp.enabled or self._spec is not None \
                or not self.client.speculate_ok():
            return
        t = threading.Timer(sp.threshold_ms() / 1e3,
                            self._maybe_speculate, args=(epoch, offset))
        t.daemon = True
        self._spec_timer = t
        t.start()

    def _pick_alt(self) -> str:
        """The speculation target: best PenaltyBox-ranked candidate
        that is not the current source; the current source itself when
        the segment has no alternates (a duplicate fetch still races a
        per-request stall)."""
        ranked = (self.ledger.rank(self.hosts) if self.ledger is not None
                  else list(self.hosts))
        for h in ranked:
            if h != self.host:
                return h
        return self.host

    def _maybe_speculate(self, epoch: int, offset: int) -> None:
        """Straggler-timer body: issue the speculative duplicate. Runs
        on the timer thread; a speculative attempt that fails (sync or
        async) is simply dropped — it must never fail the segment while
        the primary race is still open."""
        with self._lock:
            if self._done.is_set() or self._epoch_settled \
                    or epoch != self._epoch or self._spec is not None:
                return
            alt = self._pick_alt()
            self._next_epoch += 1
            spec_epoch = self._next_epoch
            self._spec = (spec_epoch, alt)
            self._attempt_hosts[spec_epoch] = alt
            self._open_attempts += 1
            # the race runs from the primary's issue to the completion
            # that settles the attempt group (or the segment's fail())
            self._hedge = metrics.start_timer(
                "fetch_hedge", parent=self.trace_span, t0=self._issue_t0)
        metrics.add("fetch.speculated", supplier=alt or self.map_id)
        flightrec.record("segment.speculate", map=self.map_id,
                         primary=self.host, alternate=alt)
        # hands off to the speculative epoch: _on_complete settles the
        # winner, _drop_attempt the loser (and the sync-raise path)
        metrics.gauge_add("fetch.on_air", 1)  # udalint: disable=UDA101 - _on_complete owns the -1
        log.warn(f"fetch of {self.map_id} chunk at {offset} is a "
                 f"straggler; speculating against "
                 f"{alt or 'the same source'}")
        req = ShuffleRequest(self.job_id, self.map_id, self.reduce_id,
                             offset, self.chunk_size, host=alt)
        try:
            failpoint("segment.fetch", key=f"{self.map_id}@{alt}#spec")
            with metrics.use_span(self.trace_span):
                self.client.start_fetch(
                    req, lambda res, e=spec_epoch: self._on_complete(res, e))
        except Exception as e:  # noqa: BLE001 - a failed spec issue is
            # a dropped duplicate, not a segment failure
            self._drop_attempt(spec_epoch, e)

    def _drop_attempt(self, epoch: int, exc: Optional[Exception]) -> None:
        """Close ONE of two live attempts (a speculation loser that
        errored): the race continues on the surviving attempt.

        Racing failures: when BOTH attempts fail concurrently, the
        first drop leaves one live attempt (possibly by promotion) and
        the second drop finds ``_spec`` already None — that second
        failure now belongs to the SOLE live attempt, so it settles
        the group and drives the ordinary retry ladder instead of
        being discarded (discarding it would strand the segment with
        zero attempts in flight and nothing left to wake it)."""
        promoted = False
        sole_failure = False
        with self._lock:
            if self._epoch_settled:
                return
            spec = self._spec
            host = self._attempt_hosts.pop(epoch, self.host)
            if spec is not None and epoch == spec[0]:
                self._spec = None
            elif spec is not None and epoch == self._epoch:
                # the PRIMARY died while a speculative duplicate is in
                # flight: promote the duplicate — it is now the fetch
                self._epoch = spec[0]
                self._spec = None
                self.host = spec[1]
                promoted = True
                old_t, self._timeout_timer = self._timeout_timer, None
            elif spec is None and epoch == self._epoch:
                # the other attempt was dropped/promoted first: this
                # failure is the last live attempt's — settle and retry
                sole_failure = True
                self._epoch_settled = True
                settled_n = self._open_attempts
                self._open_attempts = 0
                hedge, self._hedge = self._hedge, None
            else:
                return  # neither live attempt: stale
            if not sole_failure:
                self._open_attempts -= 1
            if promoted:
                self._arm_timeout(self._epoch)
        if sole_failure:
            metrics.gauge_add("fetch.on_air", -settled_n)
            if hedge is not None:
                hedge.stop(error="both attempts failed")
            self._cancel_timeout()
            if exc is None:
                exc = TransportError(
                    f"fetch of {self.map_id}: both racing attempts "
                    f"failed")
            attribute_supplier(exc, host or self.map_id)
            self._drive(exc)
            return
        metrics.gauge_add("fetch.on_air", -1)
        if promoted and old_t is not None:
            old_t.cancel()
        if exc is not None:
            attribute_supplier(exc, host or self.map_id)
            self._notify_fault(exc)

    def _on_complete(self, result, epoch: int) -> None:
        with self._lock:
            spec = self._spec
            spec_epoch = spec[0] if spec else None
            if self._epoch_settled or \
                    epoch not in (self._epoch, spec_epoch):
                metrics.add("fetch.stale_completions")
                return  # superseded attempt (timed out or re-issued)
            two_live = spec_epoch is not None
            drop_loser = isinstance(result, Exception) and two_live
            if not drop_loser:
                # accepted: this completion settles the attempt GROUP;
                # the loser of a speculation race is abandoned now (its
                # own completion, if it ever lands, is stale)
                self._epoch_settled = True
                won_spec = two_live and epoch == spec_epoch
                if won_spec:
                    self.host = spec[1]  # sticky: the faster source
                    # serves this segment's remaining chunks too
                    self._hedge_source = spec[1]
                hedge, self._hedge = self._hedge, None
                self._spec = None
                self._attempt_hosts.clear()
                settled = self._open_attempts
                self._open_attempts = 0
                inline = self._issuing
                if inline:  # inline completion: hand back to _drive
                    self._inline = result
        if drop_loser:
            # one of TWO racing attempts failed: close it and keep
            # racing on the survivor (a failed primary promotes the
            # speculative duplicate)
            self._drop_attempt(epoch, result)
            return
        metrics.gauge_add("fetch.on_air", -settled)
        if hedge is not None:
            hedge.stop(won=won_spec)
        if two_live:
            if won_spec:
                metrics.add("fetch.speculation.won",
                            supplier=self.supplier)
            else:
                metrics.add("fetch.speculation.lost")
        if inline:
            return
        self._cancel_timeout()
        self._drive(result)

    def _notify_fault(self, exc: Exception) -> None:
        """Fire the on_fault hook (penalty-box feedback). The hook must
        never decide the segment's fate: its own errors are logged and
        swallowed."""
        hook = self.on_fault
        if hook is not None:
            try:
                hook(self, exc)
            except Exception as e:  # noqa: BLE001
                log.warn(f"on_fault hook failed for {self.map_id}: {e}")

    def _drive(self, result) -> None:
        """Iterative fetch state machine (one outstanding fetch at a
        time; runs on whichever thread delivered the completion)."""
        while result is not None:
            if isinstance(result, TenantError):
                # the service plane's refusal is TERMINAL: a fenced
                # epoch / retired job / failed registration cannot be
                # retried into legality — burning the retry+backoff
                # budget against the registry would only delay the
                # fallback (and churn the penalty box against a
                # healthy supplier)
                self._notify_fault(result)
                self._finish(result)
                return
            if isinstance(result, Exception):
                # transport-level retry (the reference retries its
                # connect dance 5x and RNR-retries sends,
                # RDMAClient.cc:41, 235-344; RDMAComm.h:29). Default:
                # restart the WHOLE segment from offset 0 —
                # re-fetch-the-MOF granularity, which also resets any
                # decompressing wrapper's stream state cleanly. With
                # uda.tpu.fetch.resume on and a resumable source
                # (warm-restarted supplier, immutable MOF), keep the
                # offset ledger and continue mid-partition instead —
                # already-served bytes are never refetched.
                deadline_hit = False
                # transport capability probed OUTSIDE self._lock (the
                # client has locks of its own; no order edge wanted).
                # Resumable failures: a disconnect (TransportError), or
                # a REMOTE StorageError (structured remote_kind stamp,
                # net/wire.py) — the supplier answered with a typed ERR
                # frame on a healthy stream, so every chunk ingested
                # before it is valid and a transient pread failure must
                # not cost a full refetch (a per-call fault probability
                # compounds over a partition's chunk count, so refetch-
                # from-zero retries lose ground they never recover —
                # the chaos error-schedule livelock shape). A LOCAL
                # StorageError (no remote_kind) still restarts from
                # zero: that class includes the resume-identity
                # invalidation below, which exists to force exactly
                # that restart.
                remote_storage = (isinstance(result, StorageError)
                                  and getattr(result, "remote_kind",
                                              None) is not None)
                resumable = (self.resume_enabled
                             and (isinstance(result, TransportError)
                                  or remote_storage)
                             and self.client.resume_ok(self.host))
                with self._lock:
                    if self._done.is_set():
                        # administratively failed (fail()) while this
                        # attempt was in flight: the segment's fate is
                        # sealed — retrying into a dead job would only
                        # burn backoff timers and churn the penalty box
                        return
                    retry = self._retries_left > 0
                    if retry and self._deadline is not None \
                            and time.monotonic() >= self._deadline:
                        retry, deadline_hit = False, True
                    resume = retry and resumable and self._next_offset > 0
                    if retry and not resume:
                        self._retries_left -= 1
                        self.batches = []
                        self.num_records = 0
                        self._carry = b""
                        self._next_offset = 0
                        self._crc_refetched.clear()
                        self._resume_check = False
                    elif resume:
                        self._retries_left -= 1
                        self._resume_check = True  # revalidate identity
                    offset = self._next_offset if resume else 0
                    attempt = self.policy.retries - self._retries_left
                    cands = list(self.hosts)
                self._notify_fault(result)
                if retry and not resume and len(cands) > 1 \
                        and self.ledger is not None:
                    # restart-from-zero retries re-rank the candidate
                    # list: a punished primary falls behind a healthy
                    # replica. Resumed retries must stay put: the offset
                    # ledger is only valid against the host that served
                    # it.
                    self.host = self.ledger.rank(cands)[0]
                if not retry:
                    if deadline_hit:
                        metrics.add("fetch.deadline_exceeded")
                        log.warn(f"fetch of {self.map_id} gave up: "
                                 f"deadline passed with retries left")
                    if self._try_recover(result):
                        return  # the reconstruction rung owns the
                        # segment now (completes it via _on_recovered)
                    self._finish(result)
                    return
                if resume:
                    metrics.add("fetch.resumed", supplier=self.supplier)
                    metrics.add("fetch.resumed.bytes", offset)
                    log.warn(f"fetch of {self.map_id} failed ({result}); "
                             f"resuming at offset {offset} "
                             f"({self._retries_left} retries left)")
                else:
                    log.warn(f"fetch of {self.map_id} failed ({result}); "
                             f"retrying ({self._retries_left} left)")
                tenant = current_tenant()
                if tenant:
                    metrics.add("fetch.retries", supplier=self.supplier,
                                tenant=tenant)
                else:
                    metrics.add("fetch.retries", supplier=self.supplier)
                flightrec.record("segment.retry", map=self.map_id,
                                 supplier=self.supplier,
                                 error=type(result).__name__,
                                 resume=resume, left=self._retries_left)
                delay = self.policy.backoff(attempt, self._rng)
                if self._deadline is not None:
                    delay = min(delay,
                                max(0.0, self._deadline - time.monotonic()))
                if delay > 0:
                    # back off without blocking the completion thread
                    # (it may be a transport worker the retry needs)
                    metrics.add("fetch.backoff_seconds", delay)
                    t = threading.Timer(
                        delay,
                        lambda o=offset: self._drive(self._try_issue(o)))
                    t.daemon = True
                    t.start()
                    return
                result = self._try_issue(offset)
                continue
            if self._resume_check:
                # first chunk after a resumed retry: the partition's
                # identity must match what the ledger was built from —
                # a supplier restarted onto a DIFFERENT map attempt
                # must not splice two attempts' bytes together. The
                # StorageError (not a TransportError) forces the next
                # retry to restart from zero.
                with self._lock:
                    prev = self.raw_length
                    self._resume_check = False
                if prev is not None and result.raw_length != prev:
                    metrics.add("fetch.resume.invalidated")
                    result = StorageError(
                        f"partition {self.map_id} changed identity "
                        f"across the supplier restart (raw_length "
                        f"{result.raw_length} != {prev}); restarting "
                        f"the fetch from zero")
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
            except Exception as e:  # crack errors -> surfaced to waiter
                self._finish(e)
                return
            # notify exactly once, outside _ingest's try scope: an
            # exception thrown by the on_done callback itself must NOT
            # re-enter the error path above and fire on_done a second
            # time (double credit release / double progress count)
            if last:
                self._finish(None)
                return
            with metrics.timer("fetch_issue"):
                result = self._try_issue(self._next_offset)

    def _ingest(self, res: FetchResult) -> bool:
        """Absorb one chunk; returns True when the segment is complete.
        Never calls callbacks and never touches them under self._lock —
        the completion callback may call record_batch(), which takes the
        same (non-reentrant) lock on this same thread."""
        with metrics.timer("fetch_crack"), self._lock:
            self.raw_length = res.raw_length
            data = self._carry + res.data
            last = res.is_last
            if last and not data:
                # legitimately empty partition (raw_length == 0: a byte
                # range with no records and no EOF marker, as foreign
                # writers may produce for empty reducers)
                self._carry = b""
            else:
                # crack up to the last complete record; keep the tail
                batch, consumed, _ = crack_partial(data, expect_eof=last)
                if batch.num_records:
                    self.batches.append(batch)
                    self.num_records += batch.num_records
                self._carry = data[consumed:] if not last else b""
                self._next_offset = res.offset + len(res.data)
            issue_t0 = self._issue_t0
            hedged = self._hedge_source == self.host
        tenant = current_tenant()
        if tenant:
            # a tenanted reduce task labels the hot-path fetch counters
            # (one module-global read per chunk)
            metrics.add("fetch.bytes", len(res.data),
                        supplier=self.supplier, tenant=tenant)
            metrics.add("fetch.chunks", supplier=self.supplier,
                        tenant=tenant)
            metrics.observe("fetch.latency_ms",
                            (time.perf_counter() - issue_t0) * 1e3,
                            supplier=self.supplier, tenant=tenant)
            metrics.observe("fetch.chunk.bytes", len(res.data),
                            tenant=tenant)
        else:
            metrics.add("fetch.bytes", len(res.data),
                        supplier=self.supplier)
            metrics.add("fetch.chunks", supplier=self.supplier)
            metrics.observe("fetch.latency_ms",
                            (time.perf_counter() - issue_t0) * 1e3,
                            supplier=self.supplier)
            metrics.observe("fetch.chunk.bytes", len(res.data))
        if hedged:
            metrics.add("fetch.hedged.bytes", len(res.data),
                        supplier=self.supplier)
        return last

    def _try_recover(self, cause: Exception) -> bool:
        """The post-retry reconstruction rung: rebuild the partition
        from any k of its n stripe chunks (``coding``). One-shot;
        returns False when coding is off or the transport cannot
        recover — the caller then finishes the segment with ``cause``
        exactly as before."""
        if self.stripe is None or self._recover_tried:
            return False
        self._recover_tried = True
        with self._lock:
            # the recovery replaces the whole partition: drop whatever
            # partial state the failed attempts left behind
            self.batches = []
            self.num_records = 0
            self._carry = b""
            self._next_offset = 0
            self._resume_check = False
            self._issue_t0 = time.perf_counter()
        # anchor placement at the WRITER's primary (hosts[0] — the map
        # entry's first host), never the current source: rank-picks and
        # speculation wins move self.host, but the stripe was placed by
        # rotation from where the map was written
        req = ShuffleRequest(self.job_id, self.map_id, self.reduce_id,
                             0, self.chunk_size, host=self.hosts[0])
        metrics.add("coding.recover.attempts", supplier=self.supplier)
        log.warn(f"fetch of {self.map_id} exhausted retries ({cause}); "
                 f"attempting k-of-n stripe reconstruction")
        # the rung's timer runs until the decoded partition (or the
        # reconstruction's error) is handed back; its span, a child of
        # the fetch span, fathers the shard streams and the decode
        timer = metrics.start_timer("coding_recover",
                                    parent=self.trace_span)

        def recovered(result) -> None:
            timer.stop(**({"error": type(result).__name__}
                          if isinstance(result, Exception) else {}))
            self._on_recovered(result)

        try:
            with metrics.use_span(timer.span):
                started = bool(self.client.recover_partition(
                    req, self.stripe, recovered))
        except Exception as e:  # noqa: BLE001 - a recovery that cannot
            # even start must fall through to the terminal path, not
            # escape into the completion thread
            timer.stop(error=type(e).__name__)
            metrics.add("coding.recover.failures")
            log.warn(f"stripe reconstruction of {self.map_id} could "
                     f"not start: {e}")
            return False
        if not started:
            timer.stop()
        return started

    def _on_recovered(self, result) -> None:
        """Reconstruction completion: a full-partition FetchResult (the
        decoded on-disk bytes, decompressed by any wrapper on the way
        up) or the reconstruction's terminal error."""
        if isinstance(result, Exception):
            metrics.add("coding.recover.failures")
            self._finish(result)
            return
        try:
            last = self._ingest(result)
        except Exception as e:  # noqa: BLE001 - crack errors surface to
            # the waiter like any fetched chunk's would
            self._finish(e)
            return
        self._finish(None if last else MergeError(
            f"stripe reconstruction of {self.map_id} delivered a "
            f"non-final chunk"))

    def fail(self, exc: Exception) -> bool:
        """Administratively terminate the fetch (watchdog rescue / stop-
        path drain): the segment completes NOW with ``exc`` and every
        waiter wakes. The outstanding attempts' epochs are invalidated,
        so a transport completion that eventually arrives (e.g. a wedged
        worker finishing minutes later) is dropped as stale instead of
        double-driving the state machine. Returns False when the segment
        had already finished (success or error) — fail() never rewrites
        history. Safe from any thread; fires on_done (credit release)
        exactly once like every other terminal path.

        The failing supplier rides the STRUCTURED cause: ``exc`` gains
        a ``supplier`` attribute (first unset wins — a shared stop-path
        error keeps its first attribution) and the recovery ledger gets
        an exact per-segment record, so downstream consumers never
        parse reason strings."""
        with self._lock:
            if self._done.is_set():
                return False
            open_attempts = self._open_attempts
            self._open_attempts = 0
            self._next_epoch += 1     # outstanding completions -> stale
            self._epoch = self._next_epoch
            self._spec = None
            self._attempt_hosts.clear()
            self._epoch_settled = True
            hedge, self._hedge = self._hedge, None
        if hedge is not None:
            hedge.stop(error=type(exc).__name__)
        if open_attempts:
            # settle the abandoned attempts' on-air accounting (their
            # own completions, if they ever land, see a stale epoch and
            # must not decrement a second time)
            metrics.gauge_add("fetch.on_air", -open_attempts)
        self._cancel_timeout()
        attribute_supplier(exc, self.supplier)
        if self.ledger is not None:
            self.ledger.record("admin_fail", supplier=self.supplier,
                               map_id=self.map_id, error=exc)
        if not self._finish(exc):
            return False  # a real terminal path won the race
        metrics.add("fetch.failed_admin")
        flightrec.record("segment.admin_fail", map=self.map_id,
                         supplier=self.supplier, error=type(exc).__name__)
        return True

    # -- consumption --------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._done.wait(timeout=timeout):
            raise MergeError(f"segment {self.map_id} fetch timed out")
        with self._lock:
            err = self._error
        if err is not None:
            raise err

    @property
    def ready(self) -> bool:
        return self._done.is_set() and self._error is None

    def record_batch(self) -> RecordBatch:
        """All records of the partition as one batch (fetch must be
        done). The concat is cached: callers on different threads (the
        overlap staging thread, then the finish pass) pay for it once."""
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
        """Drop the fetched bytes (streaming online mode: the sorted run
        file is now the source of truth; ``num_records`` survives for
        accounting). record_batch() raises after this."""
        with self._lock:
            self.batches = []
            self._released = True

    # -- checkpoint (merger/checkpoint.py) ----------------------------------

    def ckpt_export(self) -> Optional[dict]:
        """Snapshot this segment's fetch offset ledger for a checkpoint
        manifest: the cracked batches re-framed (IFile framing, no EOF)
        plus the carry tail, with the offsets that make the state
        resumable. None when there is nothing worth persisting — the
        segment is done/released (its run file carries the records) or
        has fetched nothing yet (a fresh fetch costs the same).

        Crash-consistent by construction: state is copied under the
        segment lock (batches are immutable once appended and
        ``_next_offset`` advances in the same critical section as the
        append, so the copy is internally consistent); the re-framing
        runs outside the lock."""
        with self._lock:
            if self._done.is_set() or self._released \
                    or self._next_offset <= 0:
                return None
            batches = list(self.batches)
            carry = self._carry
            state = {"next_offset": self._next_offset,
                     "raw_length": self.raw_length,
                     "num_records": self.num_records,
                     "carry_len": len(carry)}
        framed = b"".join(native.frame_batch(b, write_eof=False)
                          for b in batches)
        state["data"] = framed + bytes(carry)
        return state

    def ckpt_preload(self, *, data: bytes, carry_len: int,
                     next_offset: int, raw_length, num_records: int) -> None:
        """Restore a checkpointed offset ledger BEFORE start(): re-crack
        the persisted framed bytes, verify they account for exactly the
        recorded records, and arm the resume (start() then issues at
        ``next_offset`` and the first chunk revalidates identity).
        Raises :class:`StorageError` on any mismatch — the caller drops
        the ledger and the segment fetches from zero."""
        framed_len = len(data) - int(carry_len)
        if framed_len < 0:
            raise StorageError(
                f"checkpoint ledger of {self.map_id}: carry "
                f"{carry_len} B exceeds payload {len(data)} B")
        batch, consumed, _ = crack_partial(bytes(data[:framed_len]),
                                           expect_eof=False)
        if consumed != framed_len or batch.num_records != int(num_records):
            raise StorageError(
                f"checkpoint ledger of {self.map_id} re-cracked to "
                f"{batch.num_records} records/{consumed} B, manifest "
                f"says {num_records}/{framed_len}")
        with self._lock:
            if self._next_epoch:
                raise StorageError(
                    f"ckpt_preload of {self.map_id} after start()")
            self.batches = [batch] if batch.num_records else []
            self.num_records = int(num_records)
            self._carry = bytes(data[framed_len:])
            self._next_offset = int(next_offset)
            self.raw_length = (int(raw_length) if raw_length is not None
                               else None)
            self._resume_check = True  # first chunk revalidates identity


