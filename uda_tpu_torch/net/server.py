"""ShuffleServer: the event-loop supplier endpoint with a zero-copy
serve path.

The port's copy of ``uda_tpu/net/server.py``. One loop thread
(:mod:`uda_tpu_torch.net.evloop`) multiplexes every connection:
non-blocking sockets, per-connection state machines for frame reassembly
and outbound queues. Semantics, frame for frame the reference's:

- **credit cap** (``mapred.rdma.wqe.per.conn``): a request past the cap
  is parked and the connection's read interest paused; the kernel
  receive buffer fills and TCP flow control pushes back on the client. A
  settled response re-arms read interest;
- **out-of-order completion** from DataEngine futures;
- **typed ERR frames** for engine errors (missing MOF, admission
  rejection, injected faults), never a teardown;
- **drain-on-stop** (``uda.tpu.net.drain.s``) against
  ``stop(drain=False)``, the killed supplier.

The zero-copy serve path (``uda.tpu.net.zerocopy``, default on): DATA
chunks are served from the DataEngine's fd cache as
:class:`~uda_tpu_torch.mofserver.data_engine.FdSlice` plans and streamed
with ``os.sendfile``, or sent with ``sendmsg`` out of the MOF's cached
mmap (``uda.tpu.net.zerocopy.mode``; ``auto`` times both once a process
and takes the faster). When a chunk cannot be fd-backed (CRC stamping
on, the ``data_engine.pread`` failpoint armed, a sendfile-refusing fd),
``sendmsg`` scatter-gathers ``[head, chunk]`` from the engine's buffer.
``net.serve.fd`` / ``net.serve.copy`` count the split,
``net.sendfile.bytes`` and ``net.mmap.bytes`` the zero-copy bytes.

**Inline writes**: an engine completion writes its response on the
completing thread under the connection's write lock when the socket has
room; the loop takes over only a residual that would block. Credit
settlement is marshalled back to the loop.

**Batched byte-path serves** (``uda.tpu.read.batch``): requests that take
the engine's byte path (zero-copy off, CRC stamping on, pread failpoint
armed) accumulate per connection during one recv's frame burst or one
credit-unpark sweep and go to the engine as one
``DataEngine.submit_batch``; slice-eligible requests keep the zero-copy
plane.

**Warm restart** (``uda.tpu.net.handoff.path``): a graceful stop writes
a handoff record (generation + served-offset watermarks); the next start
consumes it and advertises generation+1 with the warm flag, so resuming
clients keep their offsets. Without a record the generation is fresh and
random: a cold restart.

**Push plane** (``uda.tpu.push.enable``, :mod:`uda_tpu_torch.net.push`):
the banner carries CAP_PUSH, MSG_PUSH_SUB subscribes a connection,
``notify_commit`` (a writer's ``on_commit``) pushes each committed map to
its subscribers as MSG_PUSH frames through the connection's outbound
queue, uncredited (PUSH_ACK/PUSH_NACK settle the push plane's own
window). Off, MSG_PUSH_SUB draws the unknown-frame typed ERR.

**Tenant plane** (``uda.tpu.tenant.enable`` or a ``registry=``,
:mod:`uda_tpu_torch.tenant`): the banner carries CAP_TENANT; MSG_JOB
registers, heartbeats or retires a (tenant, job, epoch) and binds it to
the connection (MSG_JOB_OK, or the registry's typed ERR); every REQ of a
bound job is validated against the registry, a refused registration
fences the job's REQs, and unbound jobs ride the default tenant (or are
refused under ``uda.tpu.tenant.strict``). Requests park in a shared
``CreditScheduler`` (``uda.tpu.tenant.wqe.total`` credits, weighted
deficit round-robin in byte quanta) ahead of the per-connection cap, and
the engine admits each against its tenant's budget share. Off, MSG_JOB
draws the "runs no tenant plane" typed ERR.

A CAP_OBS stats poll gets the sections of a disarmed telemetry plane
(the port has none of the reference's rollups, SLI book or anomaly
engine).

Failpoints: ``net.accept`` per accepted connection, ``net.frame`` per
outbound frame (applied to its head: a truncated head is a torn frame
and the connection closes after sending it), ``net.handoff`` around the
handoff record's load and save, ``net.push`` per MSG_PUSH frame.
"""

from __future__ import annotations

import errno
import json
import os
import dataclasses
import selectors
import socket
import threading
import time
from collections import deque
from typing import Optional

from uda_tpu_torch.mofserver.data_engine import DataEngine, FdSlice
from uda_tpu_torch.net import wire
from uda_tpu_torch.net.evloop import EventLoop, loop_callback
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (ProtocolError, StorageError,
                                        TenantError, TransportError,
                                        UdaError)
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["ShuffleServer", "EvLoopShuffleServer", "introspection_snapshot"]

log = get_logger()

_READ = selectors.EVENT_READ
_WRITE = selectors.EVENT_WRITE

_RECV_CHUNK = 256 * 1024   # reusable inbound buffer per connection
_SENDFILE_MAX = 4 << 20    # bytes per sendfile syscall (fairness bound)

# errnos on which os.sendfile is permanently useless for this pairing
# (fs/socket refuses the splice) -> fall back to the pread+sendmsg path
_SENDFILE_FALLBACK_ERRNOS = (errno.EINVAL, errno.ENOSYS, errno.EOPNOTSUPP)


# -- the MSG_STATS snapshot ---------------------------------------------------

def introspection_snapshot(providers: dict) -> dict:
    """The live record served over MSG_STATS: counters, gauges, histogram
    summaries, the time and pid, and each of ``providers``' blocks
    (name -> callable; one that raises degrades to an error marker)."""
    snap = {"counters": metrics.snapshot(),
            "gauges": metrics.gauges_snapshot(),
            "histograms": {}}
    for name in list(metrics.histograms):
        h = metrics.histogram(name)
        if h["count"]:
            snap["histograms"][name] = h
    snap["ts"] = round(time.time(), 3)
    snap["pid"] = os.getpid()
    blocks = {}
    for name, fn in providers.items():
        try:
            blocks[name] = fn()
        except Exception as e:  # noqa: BLE001 - the poll must answer
            blocks[name] = {"error": type(e).__name__}
    snap["providers"] = blocks
    return snap


def _disarmed_sections(sections: int) -> dict:
    """The CAP_OBS sections a disarmed telemetry plane answers (the
    reference's rollup ring, SLI book and anomaly engine, never armed:
    the port has none of them)."""
    out: dict = {}
    if sections & wire.STATS_SEC_TS:
        out["timeseries"] = {"running": False, "interval_s": 1.0,
                             "window": 120, "samples": 0, "last_seq": 0,
                             "last_ts": 0.0, "rollups": []}
    if sections & wire.STATS_SEC_SLI:
        out["sli"] = {"armed": False, "objective": 0.99,
                      "targets": {"fetch_p99_ms": 0.0,
                                  "serve_p99_ms": 0.0, "share": 0.5},
                      "tenants": {}}
    if sections & wire.STATS_SEC_ANOMALY:
        out["anomalies"] = {"armed": False, "fired": 0, "dumps": 0,
                            "dump_enabled": False, "active": []}
    return out


# -- the zero-copy mechanism probe --------------------------------------------

def _pick_zerocopy_mode() -> str:
    """One-time per-process probe for ``zerocopy.mode=auto``: time
    ``os.sendfile`` against ``send`` out of an mmap over a loopback TCP
    pair and serve with the faster. Both keep chunk bytes off the Python
    heap; which the kernel moves faster varies (emulated kernels copy in
    sendfile, bare metal favours it). sendfile wins unless mmap beats it
    by more than 30% (the probe's noise floor); a failed probe means
    sendfile."""
    global _PROBED_MODE
    with _PROBE_LOCK:
        if _PROBED_MODE is not None:
            return _PROBED_MODE
        mode = "sendfile"
        try:
            import mmap as mmap_mod
            import tempfile

            nbytes = 4 << 20
            with tempfile.NamedTemporaryFile() as tf:
                tf.write(b"\0" * nbytes)
                tf.flush()
                fd = tf.fileno()
                mm = mmap_mod.mmap(fd, 0, prot=mmap_mod.PROT_READ)

                def tcp_pair():
                    srv = socket.socket(socket.AF_INET,
                                        socket.SOCK_STREAM)
                    srv.bind(("127.0.0.1", 0))
                    srv.listen(1)
                    c = socket.create_connection(srv.getsockname()[:2])
                    s, _ = srv.accept()
                    srv.close()
                    for x in (c, s):
                        x.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
                    return c, s

                def timed(send_once) -> float:
                    a, b = tcp_pair()
                    stop = threading.Event()
                    sink = bytearray(1 << 20)

                    def drain() -> None:
                        while not stop.is_set():
                            try:
                                if not b.recv_into(sink):
                                    return
                            except OSError:
                                return

                    t = threading.Thread(target=drain, daemon=True)
                    t.start()
                    send_once(a)  # untimed warm-up: steady state counts
                    t0 = time.perf_counter()
                    for _ in range(3):
                        send_once(a)
                    dt = time.perf_counter() - t0
                    stop.set()
                    wire.close_hard(a)
                    wire.close_hard(b)
                    t.join(timeout=1.0)
                    return dt

                def via_sendfile(sock) -> None:
                    off = 0
                    while off < nbytes:
                        off += os.sendfile(sock.fileno(), fd, off,
                                           nbytes - off)

                view = memoryview(mm)

                def via_mmap(sock) -> None:
                    sock.sendall(view)

                t_sf = timed(via_sendfile)
                t_mm = timed(via_mmap)
                view.release()
                mm.close()
                if t_mm * 1.3 < t_sf:
                    mode = "mmap"
                log.info(f"net: zerocopy auto-probe: sendfile "
                         f"{t_sf * 1e3:.1f} ms vs mmap+send "
                         f"{t_mm * 1e3:.1f} ms for {3 * nbytes >> 20} MB "
                         f"-> {mode}")
        except Exception as e:  # noqa: BLE001 - a probe failure must
            # never break serving; sendfile is the safe default
            log.warn(f"net: zerocopy auto-probe failed ({e}); "
                     f"using sendfile")
        _PROBED_MODE = mode
        return mode


_PROBED_MODE: Optional[str] = None
_PROBE_LOCK = threading.Lock()


class _BufItem:
    """An outbound frame already materialized as buffers: ERR, SIZE, the
    byte-path DATA frames (``[head, chunk]`` scatter-gather) and mmap-mode
    zero-copy DATA frames (the chunk memoryview points into the MOF's
    mapping; ``slice`` pins it until written)."""

    __slots__ = ("bufs", "credited", "t0", "close_after", "slice",
                 "zc_bytes", "tenant")

    def __init__(self, bufs, credited: bool, t0: float,
                 close_after: bool = False, sl=None, zc_bytes: int = 0,
                 tenant: str = ""):
        self.bufs = [memoryview(b) for b in bufs]
        self.credited = credited
        self.t0 = t0
        self.close_after = close_after
        self.slice = sl
        self.zc_bytes = zc_bytes
        self.tenant = tenant  # the credit's scheduler account


def _release_item(item) -> None:
    """Release an item's fd-cache pin (idempotent), dropping its
    mmap-backed memoryviews first so the cache can unmap cleanly."""
    if item.slice is None:
        return
    if isinstance(item, _BufItem):
        item.bufs.clear()
    item.slice.release()


class _FileItem:
    """An outbound DATA frame whose chunk is an fd-backed FdSlice: head
    bytes, then ``os.sendfile`` straight from the MOF fd."""

    __slots__ = ("head", "slice", "file_off", "remaining", "credited",
                 "t0", "close_after", "tenant")

    def __init__(self, head: bytes, sl: FdSlice, t0: float,
                 tenant: str = ""):
        self.head: Optional[memoryview] = memoryview(head)
        self.slice = sl
        self.file_off = sl.file_offset
        self.remaining = sl.length
        self.credited = True
        self.t0 = t0
        self.close_after = False
        self.tenant = tenant


class _EvConn:
    """One accepted connection's state machine.

    The read side (reassembly, credits, parked requests, selector
    interest) belongs to the loop thread; the write side (outbound queue
    and socket sends) is guarded by ``_wlock`` so completion threads can
    write inline. The stop path only reads the monotone
    ``closed``/``inflight`` fields and marshals mutations through
    ``call_soon``."""

    def __init__(self, server: "EvLoopShuffleServer", sock: socket.socket,
                 peer: str):
        self.server = server
        self.loop = server._loop
        self.sock = sock
        self.peer = peer
        self._rbuf = memoryview(bytearray(_RECV_CHUNK))
        self._hdr = bytearray(wire.HEADER.size)
        self._hdr_got = 0
        self._payload: Optional[bytearray] = None
        self._pay_got = 0
        self._cur = (0, 0)  # (msg_type, req_id) of the frame being read
        self._wlock = threading.Lock()
        self._outq: "deque" = deque()
        self._poison = False        # no more writes (torn/failed/closed)
        # decoded requests waiting for a connection credit; with the
        # tenant plane on each already holds a tenant credit (_admit)
        self._parked: "deque" = deque()
        self._credits = server.credit
        self._unparking = False
        # the tenant plane: this connection's MSG_JOB bindings (job ->
        # (tenant, epoch)), its tenant (the default one until a job
        # binds) and how many of its requests wait, creditless, in the
        # server's CreditScheduler
        self.tenant = server.default_tenant
        self.bindings: dict = {}
        self._tparked = 0
        # byte-path requests of one recv burst / unpark sweep, flushed as
        # one engine.submit_batch
        self._batch: list = []
        self._batch_flushing = False
        self.inflight = 0
        self._read_paused = False
        self._mask = 0
        self.draining = False
        self.closed = False

    # -- registration / interest (loop thread) -------------------------------

    def register(self) -> None:
        self.loop.register(self.sock, _READ, self._on_event)
        self._mask = _READ

    def _set_mask(self, mask: int) -> None:
        if mask == self._mask or self.closed:
            return
        if mask == 0:
            self.loop.set_events(self.sock, 0)
        elif self._mask == 0:
            self.loop.resume(self.sock, mask)
        else:
            self.loop.set_events(self.sock, mask)
        self._mask = mask

    def _update_interest(self) -> None:
        if self.closed:
            return
        mask = 0
        if not self._read_paused and not self.draining:
            mask |= _READ
        if self._outq:  # racy read is fine: _kick converges it
            mask |= _WRITE
        self._set_mask(mask)

    @loop_callback
    def _kick(self) -> None:
        """A foreign-thread writer left residual bytes: arm writable
        interest so the loop takes the backlog over."""
        self._update_interest()

    # -- inbound (loop thread) -----------------------------------------------

    @loop_callback
    def _on_event(self, mask: int) -> None:
        if self.closed:
            return
        if mask & _WRITE:
            self._flush()
        if self.closed:
            return
        if mask & _READ and not self._read_paused and not self.draining:
            self._do_read()

    def _do_read(self) -> None:
        try:
            n = self.sock.recv_into(self._rbuf)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(TransportError("recv failed (peer reset?)"))
            return
        if n == 0:
            self._eof()
            return
        metrics.add("net.bytes.in", n, role="server")
        try:
            self._feed(self._rbuf[:n])
        except TransportError as e:
            self._drop(e)
        # one recv's decoded burst -> one batch submission
        self._flush_batch()

    def _feed(self, mv) -> None:
        """Incremental frame reassembly over one recv's bytes; state
        survives across recvs."""
        off, n = 0, len(mv)
        while off < n and not self.closed:
            if self._payload is None:
                take = min(wire.HEADER.size - self._hdr_got, n - off)
                self._hdr[self._hdr_got:self._hdr_got + take] = \
                    mv[off:off + take]
                self._hdr_got += take
                off += take
                if self._hdr_got < wire.HEADER.size:
                    return
                msg_type, req_id, length = wire.decode_header(
                    bytes(self._hdr))
                self._cur = (msg_type, req_id)
                self._payload = bytearray(length)
                self._pay_got = 0
                if length == 0:
                    self._frame_done()
            else:
                take = min(len(self._payload) - self._pay_got, n - off)
                self._payload[self._pay_got:self._pay_got + take] = \
                    mv[off:off + take]
                self._pay_got += take
                off += take
                if self._pay_got == len(self._payload):
                    self._frame_done()

    def _frame_done(self) -> None:
        msg_type, req_id = self._cur
        payload = memoryview(self._payload)
        self._payload = None
        self._hdr_got = 0
        if msg_type == wire.MSG_REQ:
            # a trace tail is accepted and ignored: the port keeps no
            # span trees
            req, _trace = wire.decode_request_ex(payload)
            self._admit(("req", req_id, req))
        elif msg_type == wire.MSG_SIZE_REQ:
            body, _trace = wire.decode_size_request_ex(payload)
            self._admit(("size", req_id, body))
        elif msg_type == wire.MSG_STATS:
            # uncredited, like HELLO: a poll must answer even when the
            # data pipeline holds every credit
            self.loop.dispatch(self._do_stats, req_id,
                               wire.decode_stats_request(payload))
        elif msg_type == wire.MSG_JOB:
            # uncredited like HELLO, and inline on the loop thread: TCP
            # order is the registration contract (a client sends MSG_JOB
            # and its first REQ back to back)
            self._on_job(req_id, payload)
        elif msg_type == wire.MSG_PUSH_SUB \
                and self.server.push is not None:
            # uncredited and inline for the same reason: a SUB is
            # recorded before any REQ behind it is admitted
            try:
                job_id, reduce_id, window, chunk = \
                    wire.decode_push_sub(payload)
            except UdaError as e:
                self._drop(e)
                return
            self.server.push.subscribe(self, job_id, reduce_id,
                                       window, chunk)
        elif msg_type == wire.MSG_PUSH_ACK \
                and self.server.push is not None:
            if len(payload):
                self._drop(TransportError("malformed PUSH_ACK frame"))
                return
            self.server.push.on_ack(self, req_id)
        elif msg_type == wire.MSG_PUSH_NACK \
                and self.server.push is not None:
            try:
                reason = wire.decode_push_nack(payload)
            except UdaError as e:
                self._drop(e)
                return
            self.server.push.on_nack(self, req_id, reason)
        else:
            # in-range but unknown or unexpected (MSG_PUSH_SUB on a
            # push-less server among them): a typed ERR on the same req
            # id, and the connection keeps serving
            log.warn(f"net: unsupported frame type {msg_type} from "
                     f"{self.peer}; answering typed ERR")
            metrics.add("net.errors")
            err = ProtocolError(
                f"unsupported frame type {msg_type} (this peer speaks "
                f"wire v{wire.WIRE_VERSION})")
            frame = wire.encode_error(req_id, err)
            self._enqueue(_BufItem([frame], credited=False,
                                   t0=time.perf_counter()), frame)

    def _eof(self) -> None:
        if self._hdr_got or self._payload is not None:
            self._drop(TransportError("connection closed mid-frame"))
            return
        # clean hangup at a frame boundary: in-flight responses still
        # flush, then the connection closes itself
        self.draining = True
        self._drop_parked()
        self.server._sweep()
        self._update_interest()
        if self.inflight == 0 and not self._outq:
            self.close()

    def _drop(self, cause: Exception) -> None:
        if not self.closed:
            log.warn(f"net: dropping connection {self.peer}: {cause}")
            metrics.add("net.disconnects", role="server")
        self.close()

    # -- the tenant handshake (loop thread) ----------------------------------

    def _on_job(self, req_id: int, payload) -> None:
        """MSG_JOB: register, heartbeat or retire one (tenant, job,
        epoch) and bind it to this connection. The reply is MSG_JOB_OK
        (the granted epoch) or a typed ERR carrying the registry's
        refusal, uncredited either way. A malformed payload raises
        TransportError out of the frame machine (a desync: the caller
        drops the connection)."""
        tenant, job, epoch, weight, token, retire = \
            wire.decode_job(payload)
        reg = self.server.registry
        if reg is None:
            metrics.add("net.errors")
            err = ProtocolError(
                "this supplier runs no tenant plane "
                "(uda.tpu.tenant.enable is off); MSG_JOB refused")
            reply = wire.encode_error(req_id, err)
        else:
            try:
                if retire:
                    reg.retire(tenant, job, epoch, token=token)
                    # the binding is kept: later REQs of the job go on
                    # through validate (typed "retired" errors), never
                    # back to the unbound default-tenant pass
                    reply = wire.encode_job_ok(req_id, epoch)
                else:
                    rec = reg.register(tenant, job, epoch,
                                       weight=weight, token=token)
                    self.tenant = rec.tenant_id
                    self.bindings[job] = (rec.tenant_id, rec.epoch)
                    reply = wire.encode_job_ok(req_id, rec.epoch)
            except UdaError as e:
                # a typed refusal, never a teardown. The fence: a refused
                # registration poisons the job's binding (epoch 0), so a
                # stale-epoch predecessor cannot slide back onto the
                # default-tenant pass and read its successor's chunks
                if not retire:
                    self.bindings[job] = (tenant, 0)
                metrics.add("net.errors")
                reply = wire.encode_error(req_id, e)
        self._enqueue(_BufItem([reply], credited=False,
                               t0=time.perf_counter()), reply)

    def _entry_tenant(self, entry) -> str:
        """The scheduling tenant of one decoded request: its job's
        MSG_JOB binding, else this connection's tenant."""
        kind, _rid, body = entry
        job = body.job_id if kind == "req" else body[0]
        bound = self.bindings.get(job)
        return (bound[0] or self.tenant) if bound else self.tenant

    def _entry_cost(self, entry) -> int:
        """The WDRR charge of one request: its requested bytes under byte
        quanta (a chunk_size of 0 is charged the engine's default serve
        size), 1 in request-count mode; SIZE probes cost 1."""
        if not self.server.quantum_bytes:
            return 1
        kind, _rid, body = entry
        if kind != "req":
            return 1
        return max(1, int(body.chunk_size)
                   or self.server.chunk_bytes_default)

    # -- credit + request admission (loop thread) ----------------------------

    def _admit(self, entry) -> None:
        if self.draining:
            return
        if self.server.tenancy:
            # the tenant gate first: an entry in self._parked always
            # holds a tenant credit, one in the scheduler's queues never
            # does. Reading pauses only past the per-connection high
            # water mark (the wqe.per.conn cap), so several tenants can
            # hold backlog at once and the weights bite
            if not self.server._sched.admit(self._entry_tenant(entry),
                                            (self, entry),
                                            cost=self._entry_cost(entry)):
                self._tparked += 1
                if not self._read_paused \
                        and self._tparked >= self.server.credit:
                    self._read_paused = True
                    self._update_interest()
                return
        self._conn_gate(entry)

    def _maybe_resume_read(self) -> None:
        """Resume reading once nothing is connection-parked and the
        tenant backlog is under the low water mark (half the cap)."""
        if self._read_paused and not self._parked \
                and self._tparked <= self.server.credit // 2:
            self._read_paused = False
            self._update_interest()

    def _conn_gate(self, entry) -> None:
        """The per-connection credit bound."""
        if self._credits <= 0:
            self._parked.append(entry)
            if not self._read_paused:
                # the wqe.per.conn bound: stop reading until a response
                # settles; TCP backpressure is the credit return
                self._read_paused = True
                self._update_interest()
            return
        self._start(entry)

    def _granted(self, entry) -> None:
        """A WDRR grant from the server's sweep (loop thread): the entry
        now holds a tenant credit; run it through the connection gate."""
        self._tparked -= 1
        if self.closed or self.draining:
            self.server._sched.release(self._entry_tenant(entry))
            return
        self._conn_gate(entry)
        self._maybe_resume_read()
        self._flush_batch()

    def _drop_parked(self) -> None:
        """Drop every parked entry (EOF, drain, close): connection-parked
        ones hold tenant credits, which are released; scheduler-parked
        ones hold none and just leave the queues."""
        if self.server.tenancy:
            for entry in self._parked:
                self.server._sched.release(self._entry_tenant(entry))
            if self._tparked:
                self.server._sched.drop_conn(self)
                self._tparked = 0
        self._parked.clear()

    def _start(self, entry) -> None:
        kind, req_id, body = entry
        self._credits -= 1
        self.inflight += 1
        metrics.gauge_add("net.server.inflight", 1)
        if kind == "req":
            self._start_req(req_id, body)
        else:
            self.loop.dispatch(self._do_size, req_id, body,
                               time.perf_counter(),
                               self._entry_tenant(entry)
                               if self.server.tenancy else "")

    def _settle(self, credited: bool, tenant: str = "") -> None:
        """The one credit-settle point (loop thread): every response,
        written, torn or abandoned, passes here once. ``tenant`` is the
        credit's scheduler account (empty: the connection's tenant). The
        unpark loop is iterative: a parked entry can be served fully
        inline (try_plan -> enqueue -> send -> settle), which re-enters
        here; the ``_unparking`` guard turns that into a plain credit
        increment for the outer loop (the server's sweep has the same
        guard)."""
        if not credited:
            return
        self._credits += 1
        self.inflight -= 1
        metrics.gauge_add("net.server.inflight", -1)
        if self.server.tenancy:
            self.server._sched.release(tenant or self.tenant)
        if self.closed or self.draining or self._unparking:
            if not self.closed:
                # the freed tenant credit must still reach parked
                # neighbours
                self.server._sweep()
            return
        self._unparking = True
        try:
            while self._credits > 0 and self._parked \
                    and not self.closed and not self.draining:
                self._start(self._parked.popleft())
            self._maybe_resume_read()
        finally:
            self._unparking = False
        self._flush_batch()
        # the freed tenant credit may belong to another connection's
        # parked backlog
        self.server._sweep()

    def _settle_offloop(self, res, tenant: str = "") -> None:
        """Settle a completion for a dead connection (or after the loop
        stopped), on whatever thread noticed. The tenant credit goes back
        through the loop (the scheduler is loop-confined)."""
        if isinstance(res, FdSlice):
            res.release()
        metrics.gauge_add("net.server.inflight", -1)
        if self.server.tenancy and self.loop.alive():
            self.loop.call_soon(self.server._release_and_sweep,
                                tenant or self.tenant)

    # -- serving -------------------------------------------------------------

    def _start_req(self, req_id: int, req) -> None:
        metrics.add("net.requests")
        t0 = time.perf_counter()
        server = self.server
        try:
            if server.tenancy:
                # the per-REQ registry gate; the tenant is stamped from
                # the connection's authenticated binding, never from the
                # payload, and before validation, so a refusal settles
                # the account the admit charged
                req = dataclasses.replace(
                    req, tenant=self._entry_tenant(("req", req_id, req)))
                server._validate_req(self, req)
            if server.zero_copy:
                # the inline fast path: an index-cache hit plans the
                # slice on the loop thread, no pool handoff
                plan = server.engine.try_plan(req)
                if plan is not None:
                    self._complete(req_id, plan, None, t0, req)
                    return
            if server.batch_reads and not (
                    server.zero_copy and server.engine.slice_eligible()):
                # the byte path will be taken: accumulate the burst for
                # one submit_batch
                self._batch.append((req_id, req, t0))
                return
            if server.zero_copy:
                fut = server.engine.submit_serve(req)
            else:
                fut = server.engine.submit(req)
        except Exception as e:  # noqa: BLE001 - sync rejection (stopped
            # engine, admission push-back, bad offset) -> typed ERR
            self._complete(req_id, None, e, t0, req)
            return
        fut.add_done_callback(
            lambda f: self._engine_done(req_id, f, t0, req))

    def _flush_batch(self) -> None:
        """Submit the accumulated byte-path burst (loop thread);
        iterative like the unpark sweep."""
        if self._batch_flushing or self.closed or not self._batch:
            return
        self._batch_flushing = True
        try:
            while self._batch:
                entries, self._batch = self._batch, []
                bmax = self.server.batch_max
                for i in range(0, len(entries), bmax):
                    part = entries[i:i + bmax]
                    futs = self.server.engine.submit_batch(
                        [ent[1] for ent in part])
                    for (req_id, req, t0), fut in zip(part, futs):
                        fut.add_done_callback(
                            lambda f, req_id=req_id, t0=t0, req=req:
                            self._engine_done(req_id, f, t0, req))
        finally:
            self._batch_flushing = False

    def _engine_done(self, req_id: int, f, t0: float, req) -> None:
        """Engine worker thread (or the loop, when the future was already
        resolved at callback registration)."""
        err = f.exception()
        res = None if err is not None else f.result(timeout=0)
        if self.closed or not self.loop.alive():
            self._settle_offloop(res, req.tenant)
            return
        self._complete(req_id, res, err, t0, req)

    def _complete(self, req_id: int, res, err, t0: float, req) -> None:
        """Engine completion -> outbound item, on the completing thread
        (the inline-write fast path). Responses complete out of order."""
        tenant = req.tenant
        try:
            if err is not None:
                head = wire.encode_error(req_id, err)
                item = _BufItem([head], credited=True, t0=t0,
                                tenant=tenant)
                metrics.add("net.errors")
                if self.server.tenancy and tenant and \
                        isinstance(err, (StorageError, TenantError)):
                    # tenant-scoped penalty feedback: repeated admission
                    # push-back or injected faults box this tenant in the
                    # WDRR (deprioritized, not starved)
                    self.loop.call_soon(self.server._note_fault, tenant)
            elif isinstance(res, FdSlice):
                view = (res.view()
                        if self.server.zc_mode == "mmap" else None)
                if view is None and self.server._sendfile_refused:
                    # last rung: neither sendfile (refused) nor mmap
                    # (unmappable file): serve these bytes once, then
                    # stop planning slices
                    data = os.pread(res.fd, res.length, res.file_offset)
                    if len(data) != res.length:
                        raise TransportError(
                            f"short read {len(data)}/{res.length} at "
                            f"{res.path}:{res.file_offset}")
                    res.release()
                    self.server.zero_copy = False
                    log.warn("net: zero-copy serve disabled (sendfile "
                             "refused and MOF not mappable); serving "
                             "via engine byte reads")
                    head = wire.encode_result_head(
                        req_id, raw_length=res.raw_length,
                        part_length=res.part_length, offset=res.offset,
                        last=res.last, path=res.path, crc=None,
                        data_len=len(data))
                    item = _BufItem([head, data], credited=True, t0=t0,
                                    tenant=tenant)
                    metrics.add("net.serve.copy")
                else:
                    head = wire.encode_result_head(
                        req_id, raw_length=res.raw_length,
                        part_length=res.part_length, offset=res.offset,
                        last=res.last, path=res.path, crc=None,
                        data_len=res.length)
                    if view is not None:
                        item = _BufItem([head, view], credited=True,
                                        t0=t0, sl=res,
                                        zc_bytes=res.length, tenant=tenant)
                    else:
                        item = _FileItem(head, res, t0, tenant=tenant)
                    metrics.add("net.serve.fd")
            else:
                head = wire.encode_result_head(
                    req_id, raw_length=res.raw_length,
                    part_length=res.part_length, offset=res.offset,
                    last=res.last, path=res.path, crc=res.crc,
                    data_len=len(res.data))
                item = _BufItem([head, res.data], credited=True, t0=t0,
                                tenant=tenant)
                metrics.add("net.serve.copy")
        except Exception as e:  # noqa: BLE001 - an unencodable response
            # would strand its credit: settle and drop, the client
            # re-fetches on the disconnect
            log.error(f"net: response encoding for {self.peer} failed: "
                      f"{e}; dropping the connection")
            if isinstance(res, FdSlice):
                res.release()
            self.loop.call_soon(self._abandon_item,
                                _BufItem([], credited=True, t0=t0,
                                         tenant=tenant), e)
            return
        if err is None:
            # warm-restart watermark: the highest partition offset served
            # (advisory; the resuming client's own ledger is the truth)
            served = res.length if isinstance(res, FdSlice) \
                else len(res.data)
            self.server._mark_served(req, req.offset + served, tenant)
        self._enqueue(item, head)

    def _do_size(self, req_id: int, body, t0: float,
                 tenant: str = "") -> None:
        """Dispatcher thread: the size sum through LocalFetchClient, so
        wire and in-process estimates cannot diverge (exact or
        unknown)."""
        from uda_tpu_torch.merger.segment import LocalFetchClient

        job_id, mids, reduce_id = body
        total = LocalFetchClient(self.server.engine) \
            .estimate_partition_bytes(job_id, mids, reduce_id)
        frame = wire.encode_size(req_id, total)
        if self.closed or not self.loop.alive():
            metrics.gauge_add("net.server.inflight", -1)
            if self.server.tenancy and self.loop.alive():
                self.loop.call_soon(self.server._release_and_sweep,
                                    tenant or self.tenant)
            return
        self._enqueue(_BufItem([frame], credited=True, t0=t0,
                               tenant=tenant), frame)

    def _do_stats(self, req_id: int, opt: Optional[tuple]) -> None:
        """Dispatcher thread: build and encode the snapshot; a CAP_OBS
        poll (``opt`` = window seconds, section bits) also gets the
        sections it asked for."""
        metrics.add("net.stats.requests")
        try:
            snap = introspection_snapshot(
                {"net.server": self.server._stats_snapshot})
            if opt is not None:
                snap.update(_disarmed_sections(opt[1]))
            frame = wire.encode_stats_reply(req_id, snap)
        except Exception as e:  # noqa: BLE001 - degrade to a typed ERR
            log.warn(f"net: stats snapshot failed: {e}")
            frame = wire.encode_error(req_id, e)
        if self.closed or not self.loop.alive():
            return  # uncredited: nothing to settle
        self._enqueue(_BufItem([frame], credited=False,
                               t0=time.perf_counter()), frame)

    # -- outbound (any thread; _wlock serializes writers) --------------------

    def push_frame(self, frame: bytes, close_after: bool = False) -> None:
        """Queue one supplier-initiated frame (MSG_PUSH), any thread.
        Uncredited: the push plane runs its own window (PUSH_ACK settles
        it), so pushes never take the fetch pipeline's credits."""
        self._enqueue(_BufItem([frame], credited=False,
                               t0=time.perf_counter(),
                               close_after=close_after), frame)

    def _enqueue(self, item, head: bytes) -> None:
        """Queue one response and write it now on the calling thread when
        the socket has room. The ``net.frame`` failpoint fires here, once
        per response frame, against the frame head."""
        try:
            out = failpoint("net.frame", data=head, key=self.peer)
        except Exception as e:  # noqa: BLE001 - injected send failure
            _release_item(item)
            self.loop.call_soon(self._abandon_item, item, e)
            return
        if len(out) != len(head):
            # torn frame: send the damaged head, then close
            _release_item(item)
            item = _BufItem([out], credited=item.credited, t0=item.t0,
                            close_after=True, tenant=item.tenant)
        abandoned = False
        with self._wlock:
            if self.closed or self._poison:
                abandoned = True
            else:
                self._outq.append(item)
                completed, err = self._drain_locked()
                backlog = bool(self._outq) and not self._poison
        if abandoned:
            _release_item(item)
            self.loop.call_soon(self._abandon_item, item, None)
            return
        on_loop = self.loop.on_loop_thread()
        for it in completed:
            if on_loop:
                self._settle_item(it)
            else:
                self.loop.call_soon(self._settle_item, it)
        if err is not None:
            self.loop.call_soon(self._writer_failed, err)
        elif backlog:
            if on_loop:
                self._update_interest()
            else:
                self.loop.call_soon(self._kick)

    def _drain_locked(self):
        """_wlock held. Send from the queue head until it would block.
        Returns (completed items, fatal send error or None)."""
        completed = []
        while self._outq and not self._poison:
            item = self._outq[0]
            try:
                done = (self._send_file(item)
                        if isinstance(item, _FileItem)
                        else self._send_bufs(item))
            except (BlockingIOError, InterruptedError):
                break
            except Exception as e:  # noqa: BLE001 - peer gone or injected
                self._poison = True
                return completed, e
            if not done:
                break
            self._outq.popleft()
            completed.append(item)
            if item.close_after:
                self._poison = True
                break
        return completed, None

    @loop_callback
    def _flush(self) -> None:
        """Loop-side writable handler: take the backlog over."""
        with self._wlock:
            completed, err = self._drain_locked()
        for it in completed:
            self._settle_item(it)
        if err is not None:
            self._writer_failed(err)
            return
        self._update_interest()
        if self.draining and self.inflight == 0 and not self._outq:
            self.close()

    @loop_callback
    def _settle_item(self, item) -> None:
        if item.credited:
            metrics.observe("net.frame.latency_ms",
                            (time.perf_counter() - item.t0) * 1e3,
                            role="server")
        self._settle(item.credited, item.tenant)
        if item.close_after and not self.closed:
            log.warn(f"net: frame to {self.peer} torn by failpoint; "
                     f"closing")
            metrics.add("net.disconnects", role="server")
            self.close()
        elif self.draining and self.inflight == 0 and not self._outq:
            self.close()

    @loop_callback
    def _abandon_item(self, item, cause) -> None:
        """Settle a response that will never be written (closed or
        poisoned connection, injected send failure, unencodable)."""
        self._settle(item.credited, item.tenant)
        if cause is not None:
            if not self.closed:
                log.warn(f"net: send to {self.peer} failed: {cause}")
                metrics.add("net.disconnects", role="server")
            self.close()

    @loop_callback
    def _writer_failed(self, cause: Exception) -> None:
        if not self.closed:
            log.warn(f"net: send to {self.peer} failed: {cause}")
            metrics.add("net.disconnects", role="server")
        self.close()

    def _send_bufs(self, item: _BufItem) -> bool:
        while item.bufs:
            sent = self.sock.sendmsg(item.bufs)
            metrics.add("net.bytes.out", sent, role="server")
            while sent:
                if sent >= len(item.bufs[0]):
                    sent -= len(item.bufs[0])
                    item.bufs.pop(0)
                else:
                    item.bufs[0] = item.bufs[0][sent:]
                    sent = 0
        if item.zc_bytes:
            metrics.add("net.mmap.bytes", item.zc_bytes)
        if item.slice is not None:
            item.slice.release()
        return True

    def _send_file(self, item: _FileItem) -> bool:
        while item.head is not None:
            n = self.sock.send(item.head)
            metrics.add("net.bytes.out", n, role="server")
            item.head = item.head[n:] if n < len(item.head) else None
        while item.remaining:
            try:
                n = os.sendfile(self.sock.fileno(), item.slice.fd,
                                item.file_off,
                                min(item.remaining, _SENDFILE_MAX))
            except OSError as e:
                if isinstance(e, (BlockingIOError, InterruptedError)):
                    raise
                if e.errno in _SENDFILE_FALLBACK_ERRNOS:
                    # the pairing refuses the splice: one pread + sendmsg
                    # for this chunk, and the refusal is remembered
                    self.server._sendfile_refused_once()
                    metrics.add("net.serve.copy")
                    data = os.pread(item.slice.fd, item.remaining,
                                    item.file_off)
                    if len(data) != item.remaining:
                        raise TransportError(
                            f"short read {len(data)}/{item.remaining} "
                            f"at {item.slice.path}:{item.file_off}")
                    item.slice.release()
                    self._outq[0] = _BufItem([data],
                                             credited=item.credited,
                                             t0=item.t0,
                                             tenant=item.tenant)
                    return self._send_bufs(self._outq[0])
                raise
            if n == 0:
                raise TransportError(
                    f"sendfile hit EOF mid-chunk at {item.slice.path}:"
                    f"{item.file_off} (truncated MOF?)")
            item.file_off += n
            item.remaining -= n
            metrics.add("net.bytes.out", n, role="server")
            metrics.add("net.sendfile.bytes", n)
        item.slice.release()
        return True

    # -- teardown (loop thread) ----------------------------------------------

    @loop_callback
    def begin_drain(self) -> None:
        """Stop reading; let in-flight responses flush (stop(drain=True))."""
        if self.closed or self.draining:
            return
        self.draining = True
        self._drop_parked()
        self.server._sweep()
        self._update_interest()
        if self.inflight == 0 and not self._outq:
            self.close()

    def drained(self) -> bool:
        return self.inflight == 0 and not self._outq

    @loop_callback
    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.loop.unregister(self.sock)
        wire.close_hard(self.sock)  # shutdown-then-close: the FIN leaves
        # and the peer's blocked reader wakes
        with self._wlock:
            items = list(self._outq)
            self._outq.clear()
            self._poison = True
        for item in items:
            _release_item(item)
            self._settle(item.credited, item.tenant)
        # batched-but-unflushed requests die with the connection: they
        # were credited at _start, so settle them like torn responses
        batch, self._batch = self._batch, []
        for (_req_id, req, _t0) in batch:
            self._settle(True, req.tenant)
        self._drop_parked()
        if self.server.push is not None:
            # settle the push window and forget the subscriptions
            self.server.push.drop_conn(self)
        self.server._forget(self)
        metrics.gauge_add("net.server.connections", -1)
        self.server._sweep()  # freed tenant credits flow to neighbours


class EvLoopShuffleServer:
    """Serves many concurrent reduce clients over TCP from one
    DataEngine, all on one event loop. ``port=0`` binds an ephemeral port;
    read the bound address back from :attr:`address` / :attr:`port`."""

    def __init__(self, engine: DataEngine, config: Optional[Config] = None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 registry=None):
        cfg = config or Config()
        self.engine = engine
        self.bind_host = host if host is not None \
            else str(cfg.get("uda.tpu.net.bind"))
        self.bind_port = int(port if port is not None
                             else cfg.get("uda.tpu.net.port"))
        self.credit = max(1, int(cfg.get("mapred.rdma.wqe.per.conn")))
        # the tenant plane: on with an injected registry or
        # uda.tpu.tenant.enable. Off = the single-job data plane, bit for
        # bit (no registry lookups, no scheduler, empty tenant stamps)
        self.tenancy = registry is not None \
            or bool(cfg.get("uda.tpu.tenant.enable"))
        self.registry = registry
        self._sched = None
        self.quantum_bytes = 0
        self.default_tenant = ""
        self.strict_tenancy = False
        self._sweeping = False
        if self.tenancy:
            from uda_tpu_torch.tenant import (DEFAULT_TENANT,
                                              CreditScheduler,
                                              TenantRegistry)
            if self.registry is None:
                self.registry = TenantRegistry.from_config(cfg)
            self.default_tenant = DEFAULT_TENANT
            self.strict_tenancy = bool(cfg.get("uda.tpu.tenant.strict"))
            # the shared credit pool, by default the per-connection cap
            total = int(cfg.get("uda.tpu.tenant.wqe.total")) \
                or self.credit
            # byte-cost quanta (0 = request-count quanta); a REQ of
            # chunk_size 0 is charged the engine's default serve size
            self.quantum_bytes = max(
                0, int(cfg.get("uda.tpu.tenant.quantum.kb"))) * 1024
            self.chunk_bytes_default = max(1, int(getattr(
                engine, "chunk_size_default",
                int(cfg.get("mapred.rdma.buf.size")) * 1024)))
            self._sched = CreditScheduler(
                total, weight_of=self.registry.weight_of,
                quantum=float(self.quantum_bytes or 1),
                penalty_threshold=int(
                    cfg.get("uda.tpu.tenant.penalty.threshold")),
                penalty_ms=int(cfg.get("uda.tpu.tenant.penalty.ms")))
            # per-tenant read-budget partitions (stub engines without
            # the seam skip them)
            wire_registry = getattr(engine, "set_tenant_registry", None)
            if wire_registry is not None:
                wire_registry(self.registry)
        self.drain_s = float(cfg.get("uda.tpu.net.drain.s"))
        self.sockbuf_kb = int(cfg.get("uda.tpu.net.sockbuf.kb"))
        self.zero_copy = bool(cfg.get("uda.tpu.net.zerocopy"))
        mode = str(cfg.get("uda.tpu.net.zerocopy.mode")).strip().lower()
        if not self.zero_copy:
            self.zc_mode = "off"
        elif mode in ("sendfile", "mmap"):
            self.zc_mode = mode
        else:  # auto: probe once per process
            self.zc_mode = _pick_zerocopy_mode()
        self._sendfile_refused = False
        # batched byte-path serves (the engine resolves uda.tpu.read.batch
        # and the tune cache; getattr keeps stub engines working)
        self.batch_reads = bool(getattr(engine, "batch_enabled", False))
        self.batch_max = int(getattr(engine, "batch_max", 256))
        self._listener: Optional[socket.socket] = None
        self._loop: Optional[EventLoop] = None
        self._conns: set = set()
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self.handoff_path = str(cfg.get("uda.tpu.net.handoff.path"))
        self.generation = 0
        self.warm_restart = False
        # elastic drain: once announce_drain() flips it, every later
        # banner carries CAP_DRAINING (a one-way latch)
        self._draining = False
        self._marks: dict = {}  # "tenant|job|map|reduce" -> served end
        self._marks_lock = threading.Lock()
        # the push plane (uda.tpu.push.enable). Off = pull only, bit for
        # bit: no CAP_PUSH in the banner, MSG_PUSH_SUB refused
        self.push = None
        if bool(cfg.get("uda.tpu.push.enable")):
            from uda_tpu_torch.net.push import PushScheduler
            self.push = PushScheduler(self, engine, cfg)

    # -- warm-restart handoff -----------------------------------------------

    def _load_generation(self) -> tuple[int, bool]:
        """The advertised generation: a handoff record continues as
        generation+1 with the warm flag; without one (first boot, kill -9,
        unreadable record) a fresh random generation is minted, so a cold
        restart can never pass as the same instance. The record is
        consumed: it proves exactly one graceful stop."""
        path = self.handoff_path
        if path:
            try:
                failpoint("net.handoff", key="load")
                with open(path) as f:
                    rec = json.load(f)
                os.unlink(path)
                gen = (int(rec["generation"]) + 1) & 0x7FFFFFFF
                metrics.add("net.handoff.loaded")
                return max(1, gen), True
            except FileNotFoundError:
                pass  # first boot: cold by definition
            except Exception as e:  # noqa: BLE001 - a bad record is a
                # cold start, never a refused start
                metrics.add("errors.swallowed")
                log.warn(f"net: handoff record {path} unreadable ({e}); "
                         f"cold start")
        gen = int.from_bytes(os.urandom(4), "big") & 0x7FFFFFFF
        return max(1, gen), False

    # -- the weighted-fair credit plane (loop thread) ------------------------

    def _sweep(self) -> None:
        """The WDRR grant sweep: move freed credits to parked requests
        across every connection. Iterative like the per-connection unpark
        loop: a grant served fully inline re-enters through _settle, which
        the ``_sweeping`` guard turns into a no-op for the outer loop."""
        if not self.tenancy or self._sweeping:
            return
        self._sweeping = True
        try:
            while True:
                granted = self._sched.grant_parked()
                if not granted:
                    return
                for conn, entry in granted:
                    conn._granted(entry)
        finally:
            self._sweeping = False

    def _release_and_sweep(self, tenant: str) -> None:
        """Loop-marshalled credit return for off-loop settles."""
        if self.tenancy:
            self._sched.release(tenant)
            self._sweep()

    def _note_fault(self, tenant: str) -> None:
        """Loop-marshalled tenant penalty feedback."""
        if self.tenancy:
            self._sched.note_fault(tenant)

    def _validate_req(self, conn: _EvConn, req) -> None:
        """The per-REQ registry gate: a bound job is validated on every
        request (typed TenantError when unknown, retired or of a stale
        epoch); an unbound job rides the default tenant unless
        ``uda.tpu.tenant.strict`` demands registration."""
        bound = conn.bindings.get(req.job_id)
        if bound is None:
            if self.strict_tenancy:
                raise TenantError(
                    f"job {req.job_id!r} is not registered on this "
                    f"connection and the daemon requires MSG_JOB "
                    f"registration (uda.tpu.tenant.strict)")
            return
        tenant, epoch = bound
        if epoch <= 0:
            raise TenantError(
                f"job {req.job_id!r}: registration was refused on "
                f"this connection (stale epoch or failed auth); its "
                f"fetches stay fenced")
        self.registry.validate(tenant, req.job_id, epoch)

    _MARKS_CAP = 4096  # bound the table: oldest partition evicted

    def _mark_served(self, req, end: int, tenant: str = "") -> None:
        """The served-offset watermark per partition, keyed by (tenant,
        job, map, reduce): two tenants may carry the same job, map and
        reduce ids. Advisory: resume correctness rests on the client's
        ledger; the record is the drain proof a restarted supplier starts
        from."""
        if not self.handoff_path:
            return
        key = f"{tenant}|{req.job_id}|{req.map_id}|{req.reduce_id}"
        with self._marks_lock:
            if end > self._marks.get(key, -1):
                self._marks.pop(key, None)  # refresh insertion order
                self._marks[key] = end
                if len(self._marks) > self._MARKS_CAP:
                    self._marks.pop(next(iter(self._marks)))

    def _write_handoff(self) -> None:
        if not self.handoff_path:
            return
        with self._marks_lock:
            marks = dict(self._marks)
        try:
            failpoint("net.handoff", key="save")
            tmp = self.handoff_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"generation": self.generation,
                           "watermarks": marks}, f)
            os.replace(tmp, self.handoff_path)
            metrics.add("net.handoff.persisted")
        except Exception as e:  # noqa: BLE001 - a lost handoff makes the
            # next start cold; it must not turn a graceful stop into a
            # crash
            metrics.add("errors.swallowed")
            log.warn(f"net: handoff record {self.handoff_path} not "
                     f"persisted ({e}); next start will be cold")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "EvLoopShuffleServer":
        if self._listener is not None:
            raise UdaError("ShuffleServer already started")
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.bind_host, self.bind_port))
        ls.listen(128)
        ls.setblocking(False)
        # the handoff record is consumed, so load it only once bind and
        # listen succeeded: a transient EADDRINUSE must not turn a retry
        # cold
        self.generation, self.warm_restart = self._load_generation()
        self._listener = ls
        self._stopping.clear()
        self._loop = EventLoop("uda-net-loop").start()
        self._loop.call_soon(self._loop.register, ls, _READ,
                             self._on_accept)
        log.info(f"shuffle server listening on {self.address[0]}:"
                 f"{self.address[1]} (credit/conn={self.credit}, "
                 f"zerocopy={self.zero_copy}, "
                 f"generation={self.generation}"
                 f"{' warm' if self.warm_restart else ''})")
        return self

    @property
    def address(self) -> tuple:
        if self._listener is None:
            raise UdaError("ShuffleServer not started")
        return self._listener.getsockname()[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    @loop_callback
    def _on_accept(self, mask: int) -> None:
        ls = self._listener  # stop() nulls the attribute concurrently
        if ls is None:
            return
        while True:
            try:
                sock, addr = ls.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listener closed (stop path)
            peer = f"{addr[0]}:{addr[1]}"
            try:
                failpoint("net.accept", key=peer)
            except UdaError as e:
                log.warn(f"net: accept of {peer} rejected: {e}")
                wire.close_hard(sock)
                continue
            sock.setblocking(False)
            wire.tune_socket(sock, self.sockbuf_kb)
            conn = _EvConn(self, sock, peer)
            with self._lock:
                # the stopping check and the add are atomic under the
                # lock: a connection accepted during stop() is closed here
                # or appears in stop()'s snapshot
                if self._stopping.is_set():
                    wire.close_hard(sock)
                    return
                self._conns.add(conn)
            metrics.add("net.accepts")
            metrics.gauge_add("net.server.connections", 1)
            conn.register()
            # the accept banner, the first frame on the connection
            # (uncredited); rides _enqueue so net.frame can tear it
            caps = wire.CAP_TRACE | wire.CAP_OBS | wire.CAP_ELASTIC \
                | (wire.CAP_TENANT if self.tenancy else 0) \
                | (wire.CAP_DRAINING if self._draining else 0) \
                | (wire.CAP_PUSH if self.push is not None
                   and not self._draining else 0)
            hello = wire.encode_hello(self.generation, self.warm_restart,
                                      caps=caps)
            conn._enqueue(_BufItem([hello], credited=False,
                                   t0=time.perf_counter()), hello)

    def _forget(self, conn: _EvConn) -> None:
        with self._lock:
            self._conns.discard(conn)

    def notify_commit(self, job_id: str, map_id: str) -> None:
        """The writer's commit seam: a map output just became fetchable;
        push it to every subscribed reduce connection (wire a writer with
        ``on_commit=server.notify_commit``). A no-op on a pull-only or
        draining server, so callers may call it unconditionally."""
        if self.push is not None and not self._draining:
            self.push.notify_commit(job_id, map_id)

    def _stats_snapshot(self) -> dict:
        """The introspection provider: generation, bound port, loop health
        and the per-connection table (racy reads of monotone fields, the
        contract of a live console)."""
        with self._lock:
            conns = list(self._conns)
        loop = self._loop
        with self._marks_lock:
            nmarks = len(self._marks)
        snap = {
            "generation": self.generation,
            "warm_restart": self.warm_restart,
            "port": (self._listener.getsockname()[1]
                     if self._listener is not None else None),
            "credit_per_conn": self.credit,
            "zerocopy_mode": self.zc_mode,
            "loop": (loop.stats() if loop is not None
                     else {"alive": False}),
            "watermarks": nmarks,
            "connections": [
                {"peer": c.peer, "inflight": c.inflight,
                 "parked": len(c._parked), "credits": c._credits,
                 "tenant": c.tenant, "draining": c.draining,
                 "closed": c.closed}
                for c in conns],
        }
        if self.tenancy:
            # a racy glance of loop-owned scheduler state; a walk that
            # races a sweep answers with a marker, the next poll answers
            try:
                snap["tenancy"] = {"registry": self.registry.snapshot(),
                                   "scheduler": self._sched.stats()}
            except RuntimeError:
                snap["tenancy"] = {"racing": True}
        return snap

    def _sendfile_refused_once(self) -> None:
        """The first sendfile refusal (EINVAL class): stop planning
        sendfile; later slices ride the mmap mechanism."""
        if self._sendfile_refused:
            return
        self._sendfile_refused = True
        if self.zc_mode == "sendfile":
            self.zc_mode = "mmap"
            log.warn("net: sendfile refused by the fs/socket pairing; "
                     "switching the zero-copy serve mechanism to mmap")

    def announce_drain(self, store=None, job_id: Optional[str] = None):
        """Begin elastic departure: flip the banner to CAP_DRAINING, so
        every connection accepted from here on learns this supplier is
        leaving (connected peers keep their credits; in-flight serves
        complete), and, with a
        :class:`~uda_tpu_torch.mofserver.store.StoreManager`, migrate the
        retained partitions (``job_id``'s, or all) to the blob tier so the
        job can still fetch them after this process exits. Idempotent;
        returns the migration records (empty without a store). The caller
        follows with ``stop(drain=True)`` once its producers are
        quiet."""
        if not self._draining:
            metrics.add("elastic.drains")
            log.info(f"net: drain announced (generation "
                     f"{self.generation}); new banners carry "
                     f"CAP_DRAINING")
        self._draining = True
        return store.drain(job_id) if store is not None else []

    def stop(self, drain: bool = True) -> None:
        """Stop serving. ``drain=True`` completes what the engine already
        accepted: stop reading new requests everywhere, flush in-flight
        responses for up to ``uda.tpu.net.drain.s``, write the handoff
        record, then close. ``drain=False`` tears connections down
        mid-stream (clients see TransportError: the killed supplier)."""
        if self._loop is None:
            return
        self._stopping.set()
        if self.push is not None:
            self.push.stop()
        loop = self._loop
        ls, self._listener = self._listener, None
        if ls is not None:
            loop.call_soon(loop.unregister, ls)
            wire.close_hard(ls)
        with self._lock:
            conns = list(self._conns)
        if drain:
            for c in conns:
                loop.call_soon(c.begin_drain)
            deadline = time.monotonic() + self.drain_s
            while time.monotonic() < deadline:
                if all(c.drained() or c.closed for c in conns):
                    break
                time.sleep(0.01)
            self._write_handoff()
        for c in conns:
            loop.call_soon(c.close)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            if all(c.closed for c in conns):
                break
            time.sleep(0.005)
        loop.stop()
        self._loop = None

    def __enter__(self) -> "EvLoopShuffleServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


ShuffleServer = EvLoopShuffleServer
