"""RemoteFetchClient: the reduce-side endpoint on the shared event loop.

The port's copy of ``uda_tpu/net/client.py``. Every supplier connection
of every client in the process is multiplexed onto one shared loop thread
(:func:`~uda_tpu_torch.net.evloop.shared_client_loop`; the reference ran
one completion-channel epoll thread for all QPs, RDMAClient.cc:498-527).
The contract:

- one multiplexed connection per supplier host, a request-id correlation
  table, completions delivered out of order;
- a dead connection (EOF, torn frame, decode error, send failure) fails
  every in-flight request with ``TransportError``, each into its
  Segment's retry machinery, and the next ``start_fetch`` dials fresh
  (request ids are never reused, so frames of a dead connection can
  complete nothing new);
- typed ERR frames re-raise the server-side error class, stamped with
  ``remote_kind`` (a remote ``StorageError`` is resumable);
- the HELLO banner's generation is tracked: a changed generation without
  the warm flag (a cold supplier restart) revokes ``resume_ok`` for
  good;
- ``estimate_partition_bytes`` rides the same connection (SIZE frames),
  exact or unknown; ``fetch_stats`` polls MSG_STATS.

The receive path lands each frame's payload in its own bytearray, which
becomes ``FetchResult.data`` (``wire.decode_result_take``): one heap copy
a chunk. Completion upcalls (a Segment's ``on_complete``, which may block
on admission) run on the loop's dispatcher thread, never the loop thread.

The port keeps no span trees, so its REQ frames carry no trace tail,
which is what the reference client sends with no current span.

The tenant plane: with ``uda.tpu.tenant.id`` set (or after
``bind_tenant``) the first fetch of each job on each connection to a
CAP_TENANT peer is preceded by an authenticated MSG_JOB frame binding
(tenant, job, epoch) in the supplier's registry; TCP order makes
register-before-fetch a wire guarantee. ``bind_job``/``retire_job`` are
the blocking round trips. The binding comes from this client's own
``Config``, never from the process-global ``current_tenant()``.

The push plane: ``push_register(job, reduce, staging)`` subscribes a
:class:`~uda_tpu_torch.net.push.PushStaging` with MSG_PUSH_SUB on every
connection whose banner advertises CAP_PUSH (again after each fresh
banner: a reconnect or a restarted supplier is subscribed anew). Each
MSG_PUSH chunk goes to ``PushStaging.offer`` on the dispatcher thread and
is answered with PUSH_ACK or PUSH_NACK.

Failpoints: ``net.connect`` per dial and ``net.frame`` per outbound
request frame, both on the caller thread (a truncation sends the torn
bytes, then tears the connection down).
"""

from __future__ import annotations

import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from uda_tpu_torch.merger.segment import InputClient
from uda_tpu_torch.mofserver.data_engine import ShuffleRequest
from uda_tpu_torch.net import wire
from uda_tpu_torch.net.evloop import (EventLoop, loop_callback,
                                      shared_client_loop)
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (ProtocolError, TransportError,
                                        UdaError)
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["RemoteFetchClient", "EvLoopFetchClient", "fetch_remote_stats"]

log = get_logger()

_READ = selectors.EVENT_READ
_WRITE = selectors.EVENT_WRITE

_SIZE_PROBE_TIMEOUT_S = 30.0


class _Waiter:
    """One in-flight request's completion slot."""

    __slots__ = ("on_complete", "t0", "timed")

    def __init__(self, on_complete: Callable, t0: float,
                 timed: bool = True):
        self.on_complete = on_complete
        self.t0 = t0
        self.timed = timed


class _ClientConn:
    """One connection's loop-side state machine (the loop thread owns
    every field except ``dead``, which other threads may read)."""

    def __init__(self, client: "EvLoopFetchClient", loop: EventLoop,
                 sock: socket.socket):
        self.client = client
        self.loop = loop
        self.sock = sock
        self.dead = False
        # write side: any thread may send inline under _wlock
        self._wlock = threading.Lock()
        self._outq: "deque" = deque()  # [memoryview, close_after] pairs
        self._poison = False
        self._mask = 0
        self._hdr = bytearray(wire.HEADER.size)
        self._hdr_got = 0
        self._payload: Optional[bytearray] = None
        self._pay_got = 0
        self._cur = (0, 0)
        # (job, reduce) pairs MSG_PUSH_SUB'd on this connection (guarded
        # by the client's lock)
        self.push_subbed: set = set()

    # -- registration --------------------------------------------------------

    @loop_callback
    def register(self) -> None:
        if self.dead:
            return
        self.loop.register(self.sock, _READ, self._on_event)
        self._mask = _READ

    def _update_interest(self) -> None:
        if self.dead:
            return
        mask = _READ | (_WRITE if self._outq else 0)
        if mask != self._mask:
            self.loop.set_events(self.sock, mask)
            self._mask = mask

    @loop_callback
    def _kick(self) -> None:
        self._update_interest()

    # -- outbound (any thread; _wlock serializes writers) --------------------

    def send_frame(self, data: bytes, close_after: bool = False) -> None:
        """Queue one frame and write it now on the calling thread; the
        loop takes over only a would-block residual."""
        with self._wlock:
            if self.dead or self._poison:
                return  # teardown fails this frame's waiter
            self._outq.append([memoryview(data), close_after])
            err = self._drain_locked()
            backlog = bool(self._outq) and not self._poison
        if err is not None:
            self.loop.call_soon(self.die, err)
        elif backlog:
            self.loop.call_soon(self._kick)

    def _drain_locked(self) -> Optional[Exception]:
        """_wlock held: send from the queue head until it would block.
        Returns a fatal error (send failure or a sent torn frame) or
        None."""
        while self._outq and not self._poison:
            ent = self._outq[0]
            try:
                n = self.sock.send(ent[0])
            except (BlockingIOError, InterruptedError):
                return None
            except OSError as e:
                self._poison = True
                return e
            metrics.add("net.bytes.out", n, role="client")
            if n < len(ent[0]):
                ent[0] = ent[0][n:]
                continue
            self._outq.popleft()
            if ent[1]:
                # the server's stream was knowingly desynced (torn
                # net.frame): finish the damage deterministically
                self._poison = True
                return TransportError("request frame torn by failpoint")
        return None

    @loop_callback
    def _flush(self) -> None:
        with self._wlock:
            err = self._drain_locked()
        if err is not None:
            self._die(err)
            return
        self._update_interest()

    # -- inbound -------------------------------------------------------------

    @loop_callback
    def _on_event(self, mask: int) -> None:
        if self.dead:
            return
        if mask & _WRITE:
            self._flush()
        if self.dead:
            return
        if mask & _READ:
            self._do_read()

    def _do_read(self) -> None:
        # receive straight into the header buffer or the frame's own
        # payload buffer; keep reading while each recv fills what it
        # asked for, back to select on the first partial return
        while not self.dead:
            if self._payload is None:
                dest = memoryview(self._hdr)[self._hdr_got:]
            else:
                dest = memoryview(self._payload)[self._pay_got:]
            want = len(dest)
            try:
                n = self.sock.recv_into(dest)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self._die(e)
                return
            finally:
                # the buffer-donating decode resizes the payload in
                # place, which a live export would veto
                dest.release()
            if n == 0:
                self._die(TransportError("supplier closed the connection"))
                return
            metrics.add("net.bytes.in", n, role="client")
            try:
                self._advance(n)
            except TransportError as e:
                self._die(e)
                return
            if n < want:
                return

    def _advance(self, n: int) -> None:
        if self._payload is None:
            self._hdr_got += n
            if self._hdr_got == wire.HEADER.size:
                msg_type, req_id, length = wire.decode_header(
                    bytes(self._hdr))
                self._cur = (msg_type, req_id)
                self._payload = bytearray(length)
                self._pay_got = 0
                if length == 0:
                    self._frame_done()
        else:
            self._pay_got += n
            if self._pay_got == len(self._payload):
                self._frame_done()

    def _frame_done(self) -> None:
        msg_type, req_id = self._cur
        payload = self._payload
        self._payload = None
        self._hdr_got = 0
        if msg_type == wire.MSG_DATA:
            # the per-frame receive buffer becomes FetchResult.data
            result = wire.decode_result_take(payload)
        elif msg_type == wire.MSG_ERR:
            result = wire.decode_error(memoryview(payload))
        elif msg_type == wire.MSG_SIZE:
            result = wire.decode_size(memoryview(payload))
        elif msg_type == wire.MSG_JOB_OK:
            result = wire.decode_job_ok(payload)
        elif msg_type == wire.MSG_STATS_REPLY:
            result = wire.decode_stats_reply(memoryview(payload))
        elif msg_type == wire.MSG_HELLO:
            generation, warm, caps = wire.decode_hello_ex(bytes(payload))
            self.client._on_hello(generation, warm, caps)
            return
        elif msg_type == wire.MSG_PUSH:
            # a supplier-initiated chunk, only on connections that
            # subscribed; admission may write a spill file, so it runs
            # on the dispatcher, never the loop
            self.loop.dispatch(self.client._handle_push, self, req_id,
                               payload)
            return
        else:
            raise TransportError(
                f"unexpected frame type {msg_type} on the client side")
        self.client._complete(self, req_id, result, msg_type)

    # -- teardown ------------------------------------------------------------

    def _die(self, cause: Exception) -> None:
        """Loop thread: close this connection and fail everything in
        flight on it (through the client, which owns the table)."""
        if self.dead:
            return
        self.dead = True
        with self._wlock:
            self._poison = True
            self._outq.clear()
        self.loop.unregister(self.sock)
        wire.close_hard(self.sock)
        self.client._on_conn_dead(self, cause)

    @loop_callback
    def die(self, cause: Exception) -> None:
        self._die(cause)

    @loop_callback
    def close_quiet(self) -> None:
        """Stop-path close: the client settled its own table already."""
        if self.dead:
            return
        self.dead = True
        with self._wlock:
            self._poison = True
            self._outq.clear()
        self.loop.unregister(self.sock)
        wire.close_hard(self.sock)


class EvLoopFetchClient(InputClient):
    """Multiplexed fetch client for one supplier host, on the shared
    process-wide event loop."""

    def __init__(self, host: str, port: Optional[int] = None,
                 config: Optional[Config] = None):
        cfg = config or Config()
        self.host = host
        self.port = int(port if port is not None
                        else cfg.get("uda.tpu.net.port"))
        self.connect_timeout_s = float(
            cfg.get("uda.tpu.net.connect.timeout.s"))
        self.sockbuf_kb = int(cfg.get("uda.tpu.net.sockbuf.kb"))
        self._lock = threading.Lock()  # table + connection identity
        self._conn: Optional[_ClientConn] = None
        self._pending: dict = {}       # req_id -> _Waiter
        self._next_id = 0              # never reused across connections
        self._stopped = False
        # warm-restart continuity: the last server generation seen, and
        # whether a resumed offset ledger is still continuous with it
        self._generation: Optional[int] = None
        self._resumable = True
        # the peer's capability bits from its banner (0 until it lands)
        self._peer_caps = 0
        self._hello_seen = threading.Event()
        # the tenant binding (empty tenant = the untenanted client, frame
        # for frame) and the jobs MSG_JOB'd on the current connection:
        # job -> Event set once the bind frame is on the wire, so a
        # concurrent first fetch of the job waits for it
        self._tenant = str(cfg.get("uda.tpu.tenant.id"))
        self._tenant_epoch = max(1, int(cfg.get("uda.tpu.tenant.epoch")))
        self._tenant_weight = max(1,
                                  int(cfg.get("uda.tpu.tenant.weight")))
        self._tenant_secret = str(cfg.get("uda.tpu.tenant.secret"))
        self._bound_jobs: dict = {}
        # the push plane: (job, reduce) -> PushStaging; registrations
        # outlive connections
        self._push_staging: dict = {}
        self._push_window = max(1, int(cfg.get("uda.tpu.push.window")))
        self._push_chunk = int(cfg.get("mapred.rdma.buf.size")) * 1024

    def _on_hello(self, generation: int, warm: bool,
                  caps: int = 0) -> None:
        """Loop thread (the first frame of every connection). A changed
        generation is a supplier restart: warm keeps resume legal, cold
        revokes it for good (a later warm bounce does not re-legalize a
        ledger that may predate the cold generation)."""
        with self._lock:
            prev = self._generation
            self._generation = generation
            self._peer_caps = caps
            if prev is not None and generation != prev and not warm:
                self._resumable = False
        self._hello_seen.set()
        if prev is not None and generation != prev:
            metrics.add("net.generation.changes", host=self.host,
                        warm=str(bool(warm)).lower())
            log.warn(f"net: supplier {self.host}:{self.port} restarted "
                     f"(generation {prev} -> {generation}, "
                     f"{'warm' if warm else 'COLD'})")

    def resume_ok(self, host: str = "") -> bool:
        """May a retrying segment keep its offset ledger against this
        supplier? True until a cold restart is observed; the resumed
        fetch's identity check revalidates on its first chunk."""
        with self._lock:
            return self._resumable

    def generation(self, host: str = "") -> Optional[int]:
        """The last HELLO generation from this supplier (None until the
        first handshake)."""
        with self._lock:
            return self._generation

    def peer_caps(self, host: str = "") -> int:
        """The last HELLO capability bits (0 until the first handshake)."""
        with self._lock:
            return self._peer_caps

    def peer_draining(self, host: str = "") -> bool:
        """Did the last banner carry CAP_DRAINING?"""
        with self._lock:
            return bool(self._peer_caps & wire.CAP_DRAINING)

    # -- connection management ----------------------------------------------

    def _ensure_connected(self) -> _ClientConn:
        """The live connection, dialing fresh when there is none. The dial
        blocks with a timeout on the caller's thread (never the loop); a
        failed dial raises TransportError and the Segment's RetryPolicy
        paces the reconnects."""
        with self._lock:
            if self._stopped:
                raise TransportError(
                    f"RemoteFetchClient({self.host}) is stopped")
            if self._conn is not None:
                return self._conn
        failpoint("net.connect", key=f"{self.host}:{self.port}")
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s)
        except OSError as e:
            metrics.add("net.connect.failures", host=self.host)
            raise TransportError(
                f"connect to supplier {self.host}:{self.port} failed: "
                f"{e}") from e
        sock.setblocking(False)
        wire.tune_socket(sock, self.sockbuf_kb)
        loop = shared_client_loop()
        conn = _ClientConn(self, loop, sock)
        with self._lock:
            if self._stopped or self._conn is not None:
                # lost the dial race (or stopped underneath)
                wire.close_hard(sock)
                if self._stopped:
                    raise TransportError(
                        f"RemoteFetchClient({self.host}) is stopped")
                return self._conn
            self._conn = conn
        metrics.add("net.connects", host=self.host)
        metrics.gauge_add("net.client.connections", 1)
        loop.call_soon(conn.register)
        # a bounded wait for the banner (generation, caps); a timeout only
        # means the first frames go out before it, which is legal
        self._hello_seen.wait(timeout=min(2.0, self.connect_timeout_s))
        # re-subscribe the push plane on every fresh banner: the server's
        # tables died with the previous socket (a timed-out banner leaves
        # caps 0: no SUB, pull only)
        self._send_push_subs(conn)
        return conn

    def _on_conn_dead(self, conn: _ClientConn, cause: Exception) -> None:
        """Loop thread (via _die): fail every request in flight on this
        connection. Generation and resume state are kept: the next
        banner judges them."""
        with self._lock:
            if self._conn is not conn:
                return  # the stop path (or an earlier _die) settled it
            self._conn = None
            orphans = list(self._pending.items())
            self._pending.clear()
            self._peer_caps = 0
            self._hello_seen.clear()
            # bindings are per connection: the next fetch re-sends MSG_JOB
            self._bound_jobs.clear()
        metrics.gauge_add("net.client.connections", -1)
        metrics.add("net.disconnects", role="client")
        err = TransportError(
            f"connection to supplier {self.host}:{self.port} lost "
            f"({type(cause).__name__}: {cause}); "
            f"{len(orphans)} fetches in flight")
        for req_id, waiter in orphans:
            conn.loop.dispatch(self._deliver, req_id, waiter, err)

    def _complete(self, conn: _ClientConn, req_id: int, result,
                  msg_type: int) -> None:
        """Loop thread: correlate one decoded frame to its waiter and hand
        the upcall to the dispatcher."""
        with self._lock:
            waiter = self._pending.pop(req_id, None)
        if waiter is None:
            metrics.add("net.frames.orphaned")
            return
        if waiter.timed:
            metrics.observe("net.frame.latency_ms",
                            (time.perf_counter() - waiter.t0) * 1e3,
                            role="client")
        conn.loop.dispatch(self._deliver, req_id, waiter, result)

    @staticmethod
    def _deliver(req_id: int, waiter: _Waiter, result) -> None:
        """Dispatcher thread: the upcall."""
        try:
            waiter.on_complete(result)
        except Exception as e:  # noqa: BLE001 - one waiter's bug must
            # not starve later completions
            log.warn(f"net: completion callback for req {req_id} "
                     f"raised: {e}")

    def _register(self, conn: _ClientConn, on_complete,
                  timed: bool = True) -> Optional[int]:
        """A fresh req id and waiter on ``conn``, or None when the
        connection died in between."""
        with self._lock:
            if self._conn is not conn:
                return None
            self._next_id += 1
            req_id = self._next_id
            self._pending[req_id] = _Waiter(on_complete,
                                            time.perf_counter(), timed)
        return req_id

    # -- the tenant handshake -----------------------------------------------

    def bind_tenant(self, tenant_id: str, epoch: int = 1,
                    weight: int = 1, secret: str = "") -> None:
        """Install (or change) this client's tenant identity, the
        programmatic twin of the ``uda.tpu.tenant.*`` keys. Each job binds
        again on its next fetch."""
        with self._lock:
            self._tenant = str(tenant_id)
            self._tenant_epoch = max(1, int(epoch))
            self._tenant_weight = max(1, int(weight))
            if secret:
                self._tenant_secret = secret
            self._bound_jobs.clear()

    def _job_frame(self, req_id: int, job_id: str,
                   retire: bool = False) -> bytes:
        from uda_tpu_torch.tenant import sign_job

        return wire.encode_job(
            req_id, self._tenant, job_id, self._tenant_epoch,
            weight=self._tenant_weight,
            token=sign_job(self._tenant_secret, self._tenant, job_id,
                           self._tenant_epoch),
            retire=retire)

    def _maybe_bind(self, conn: _ClientConn, job_id: str) -> None:
        """Send MSG_JOB for ``job_id`` ahead of its first request on this
        connection (fire and forget: a refusal comes back as a typed ERR,
        counted; the job's requests then draw their own typed errors from
        the server's fence). A no-op without a tenant or a CAP_TENANT
        peer. The winner of a concurrent first fetch posts the frame; the
        others wait (bounded) until it is on the wire, so no request
        overtakes the registration."""
        with self._lock:
            if not self._tenant or self._conn is not conn \
                    or not self._peer_caps & wire.CAP_TENANT:
                return
            posted = self._bound_jobs.get(job_id)
            if posted is None:
                posted = threading.Event()
                self._bound_jobs[job_id] = posted
                self._next_id += 1
                req_id = self._next_id

                def on_bound(result) -> None:
                    if isinstance(result, Exception):
                        metrics.add("tenant.bind.errors")
                        log.warn(f"tenant bind of {self._tenant}/"
                                 f"{job_id} on {self.host} refused: "
                                 f"{result}")

                self._pending[req_id] = _Waiter(
                    on_bound, time.perf_counter(), timed=False)
            else:
                req_id = None
        if req_id is None:
            # a timeout degrades to the server-side fence, never an error
            posted.wait(timeout=min(5.0, self.connect_timeout_s))
            return
        try:
            self._post(conn, self._job_frame(req_id, job_id))
        finally:
            posted.set()

    def _job_roundtrip(self, job_id: str, retire: bool,
                       timeout: float) -> int:
        """Blocking MSG_JOB round trip: the granted epoch, or the typed
        registry refusal re-raised."""
        conn = self._ensure_connected()
        box: list = [None]
        got = threading.Event()

        def on_reply(result) -> None:
            box[0] = result
            got.set()

        posted = threading.Event()
        with self._lock:
            if self._conn is not conn:
                raise TransportError(
                    f"connection to {self.host} lost before the "
                    f"MSG_JOB round trip")
            if not retire:
                self._bound_jobs[job_id] = posted
            self._next_id += 1
            req_id = self._next_id
            self._pending[req_id] = _Waiter(on_reply, time.perf_counter(),
                                            timed=False)
        try:
            self._post(conn,
                       self._job_frame(req_id, job_id, retire=retire))
        finally:
            posted.set()
        if not got.wait(timeout=timeout):
            with self._lock:
                self._pending.pop(req_id, None)
            raise TransportError(
                f"MSG_JOB to {self.host} timed out after {timeout:g}s")
        result = box[0]
        if isinstance(result, Exception):
            if not retire:
                with self._lock:
                    self._bound_jobs.pop(job_id, None)
            raise result
        return int(result)

    def bind_job(self, job_id: str, timeout: float = 10.0) -> int:
        """Register (tenant, job, epoch) with the supplier and wait for
        the grant; raises the typed TenantError on refusal."""
        return self._job_roundtrip(job_id, retire=False, timeout=timeout)

    def retire_job(self, job_id: str, timeout: float = 10.0) -> int:
        """Retire the job in the supplier's registry; its later requests
        draw typed errors."""
        return self._job_roundtrip(job_id, retire=True, timeout=timeout)

    # -- the push plane ------------------------------------------------------

    def push_register(self, job_id: str, reduce_id: int, staging,
                      hosts=None) -> None:
        """Arm ``staging`` for (job, reduce) and subscribe the supplier:
        committed partitions start arriving as MSG_PUSH chunks. The dial
        is eager but best effort (a failed dial leaves the plane pull
        only until the next fetch redials), and a peer without CAP_PUSH
        is never sent a SUB."""
        with self._lock:
            if self._stopped:
                return
            self._push_staging[(job_id, int(reduce_id))] = staging
        try:
            conn = self._ensure_connected()
        except TransportError:
            return
        self._send_push_subs(conn)

    def push_unregister(self, job_id: str, reduce_id: int) -> None:
        """Drop the registration. There is no un-SUB frame: a late push
        finds no staging, draws PUSH_NACK(UNKNOWN), and the supplier marks
        the partition pull-only."""
        with self._lock:
            self._push_staging.pop((job_id, int(reduce_id)), None)

    def _send_push_subs(self, conn: _ClientConn) -> None:
        """MSG_PUSH_SUB for every registration not yet subscribed on
        ``conn`` (idempotent; any thread). Fire and forget: a refusal
        comes back as a typed ERR with no waiter, counted as an orphan,
        and the plane stays pull only."""
        frames = []
        with self._lock:
            if self._conn is not conn or not self._push_staging \
                    or not self._peer_caps & wire.CAP_PUSH:
                return
            for key in self._push_staging:
                if key in conn.push_subbed:
                    continue
                conn.push_subbed.add(key)
                self._next_id += 1
                frames.append(wire.encode_push_sub(
                    self._next_id, job_id=key[0], reduce_id=key[1],
                    window=self._push_window,
                    chunk_size=self._push_chunk))
        for frame in frames:
            self._post(conn, frame)

    def _handle_push(self, conn: _ClientConn, push_id: int,
                     payload: bytearray) -> None:
        """Dispatcher thread: decode, run the staging admission ladder,
        answer PUSH_ACK or PUSH_NACK."""
        from uda_tpu_torch.net.push import NACK_UNKNOWN
        try:
            (job_id, map_id, reduce_id, offset, raw_length, last,
             data) = wire.decode_push_take(payload)
        except UdaError as e:
            conn.loop.call_soon(conn.die, e)
            return
        with self._lock:
            staging = self._push_staging.get((job_id, int(reduce_id)))
        if staging is None:
            metrics.add("push.refused", reason="unknown")
            verdict = NACK_UNKNOWN
        else:
            verdict = staging.offer(map_id, offset, raw_length, last,
                                    data)
        frame = (wire.encode_push_ack(push_id) if verdict == 0
                 else wire.encode_push_nack(push_id, verdict))
        self._post(conn, frame)

    # -- InputClient --------------------------------------------------------

    def start_fetch(self, req: ShuffleRequest, on_complete) -> None:
        """Issue one fetch on the multiplexed connection. The completion
        (FetchResult, typed remote error or disconnect TransportError)
        arrives on the shared dispatcher thread."""
        try:
            conn = self._ensure_connected()
        except TransportError as e:
            on_complete(e)
            return
        # the tenant plane: the job's MSG_JOB precedes its first REQ on
        # this connection (TCP order = registration order)
        self._maybe_bind(conn, req.job_id)
        req_id = self._register(conn, on_complete)
        if req_id is None:
            # the connection died between dial and registration;
            # complete outside the lock, the callback may re-issue
            on_complete(TransportError(
                f"connection to {self.host}:{self.port} lost before the "
                f"fetch was issued"))
            return
        self._post(conn, wire.encode_request(req_id, req))

    def _post(self, conn: _ClientConn, frame: bytes) -> None:
        """Write one frame, inline when the socket has room. ``net.frame``
        fires here: an injected error tears the connection down, a
        truncation sends the torn bytes with a teardown behind them."""
        try:
            out = failpoint("net.frame", data=frame,
                            key=f"client:{self.host}")
        except Exception as e:  # noqa: BLE001
            conn.loop.call_soon(conn.die, e)
            return
        conn.send_frame(out, len(out) != len(frame))

    def _round_trip(self, frame_of, timeout: float, timed: bool,
                    job_id: str = ""):
        """One blocking request/reply on the connection: the reply, or
        None on transport trouble or timeout. A ``job_id`` is bound first
        (the tenant plane's MSG_JOB discipline)."""
        try:
            conn = self._ensure_connected()
        except TransportError:
            return None
        if job_id:
            self._maybe_bind(conn, job_id)
        box: list = [None]
        got = threading.Event()

        def on_reply(result) -> None:
            box[0] = result
            got.set()

        req_id = self._register(conn, on_reply, timed)
        if req_id is None:
            return None
        self._post(conn, frame_of(req_id))
        if not got.wait(timeout=timeout):
            with self._lock:
                self._pending.pop(req_id, None)  # a late reply is orphaned
            return None
        return box[0]

    def estimate_partition_bytes(self, job_id: str, map_ids: Sequence[str],
                                 reduce_id: int) -> Optional[int]:
        """Partition size probe over the wire (SIZE frames). Best effort:
        transport trouble or a timeout is None, never a failed task."""
        result = self._round_trip(
            lambda rid: wire.encode_size_request(rid, job_id, list(map_ids),
                                                 reduce_id),
            _SIZE_PROBE_TIMEOUT_S, timed=False, job_id=job_id)
        return None if isinstance(result, Exception) else result

    def fetch_stats(self, timeout: float = _SIZE_PROBE_TIMEOUT_S,
                    window_s: Optional[int] = None) -> Optional[dict]:
        """The supplier's introspection snapshot over MSG_STATS (uncredited
        on the server). ``window_s`` asks a CAP_OBS peer for the
        observability sections too. Best effort: None on trouble."""
        def frame_of(rid: int) -> bytes:
            if window_s is not None and self.peer_caps() & wire.CAP_OBS:
                return wire.encode_stats_request(rid, window_s=window_s)
            return wire.encode_stats_request(rid)

        result = self._round_trip(frame_of, timeout, timed=True)
        return result if isinstance(result, dict) else None

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            conn, self._conn = self._conn, None
            orphans = list(self._pending.values())
            self._pending.clear()
        if conn is not None:
            conn.loop.call_soon(conn.close_quiet)
            metrics.gauge_add("net.client.connections", -1)
        err = TransportError(
            f"RemoteFetchClient({self.host}) stopped with "
            f"{len(orphans)} fetches in flight")
        for waiter in orphans:
            try:
                waiter.on_complete(err)
            except Exception as e:  # noqa: BLE001
                log.warn(f"net: completion callback raised during "
                         f"stop: {e}")


RemoteFetchClient = EvLoopFetchClient


def fetch_remote_stats(host: str, port: Optional[int] = None,
                       timeout: float = 5.0,
                       config: Optional[Config] = None,
                       window_s: Optional[int] = None) -> dict:
    """One-shot MSG_STATS poll over a plain blocking socket: consume the
    HELLO banner, send MSG_STATS, return the decoded snapshot. Raises
    TransportError on a failed dial or timeout and re-raises the typed
    remote error of an ERR answer. ``window_s`` requests the CAP_OBS
    sections, sent only after the banner advertised CAP_OBS."""
    cfg = config or Config()
    if port is None:
        port = int(cfg.get("uda.tpu.net.port"))
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
    except OSError as e:
        raise TransportError(
            f"stats poll: connect to {host}:{port} failed: {e}") from e
    try:
        sock.settimeout(timeout)
        wire.tune_socket(sock)
        sent = window_s is None  # a plain poll needs no caps
        if sent:
            try:
                sock.sendall(wire.encode_stats_request(1))
            except OSError as e:
                raise TransportError(
                    f"stats poll: send to {host}:{port} failed: "
                    f"{e}") from e
        while True:
            try:
                frame = wire.recv_frame(sock)
            except socket.timeout as e:
                raise TransportError(
                    f"stats poll: {host}:{port} did not answer within "
                    f"{timeout:g} s") from e
            except OSError as e:
                raise TransportError(
                    f"stats poll: {host}:{port} connection lost: "
                    f"{e}") from e
            if frame is None:
                raise ProtocolError(
                    f"stats poll: {host}:{port} closed the connection "
                    f"on MSG_STATS (pre-observability peer)")
            msg_type, _req_id, payload = frame
            if msg_type == wire.MSG_HELLO:
                if not sent:
                    _gen, _warm, caps = wire.decode_hello_ex(payload)
                    req = (wire.encode_stats_request(1, window_s=window_s)
                           if caps & wire.CAP_OBS
                           else wire.encode_stats_request(1))
                    try:
                        sock.sendall(req)
                    except OSError as e:
                        raise TransportError(
                            f"stats poll: send to {host}:{port} "
                            f"failed: {e}") from e
                    sent = True
                continue  # the banner precedes every reply
            if msg_type == wire.MSG_STATS_REPLY:
                return wire.decode_stats_reply(payload)
            if msg_type == wire.MSG_ERR:
                raise wire.decode_error(payload)
            raise TransportError(
                f"stats poll: unexpected frame type {msg_type} from "
                f"{host}:{port}")
    finally:
        wire.close_hard(sock)
