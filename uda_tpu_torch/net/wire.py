"""Wire framing of the shuffle data plane.

The port's copy of ``uda_tpu/net/wire.py``: every frame byte for byte
the reference's, so a reference server serves a port client and the
reverse. Binary encoding of the existing ``ShuffleRequest``/``FetchResult``
dataclasses — the socket stand-in for the reference's ibverbs message
pair: ``shuffle_req_t`` (jobid, map, reduceID, map_offset, chunk_size,
reference src/MOFServer/IndexInfo.h:64-77) and the RDMA ACK string
``"rawLen:partLen:sentSize:mofOffset:path"`` (reference
src/DataNet/RDMAServer.cc:597-607). Where the reference rode these on
pre-established QPs, here every message is one length-prefixed frame on
a TCP stream:

    +-------+---------+------+------------+-------------+---------+
    | magic | version | type | request id | payload len | payload |
    | 2 B   | 1 B     | 1 B  | 8 B        | 4 B         | ...     |
    +-------+---------+------+------------+-------------+---------+

(network byte order throughout). The request id is the multiplexing
correlation key: a client may have many requests in flight on one
connection and the server completes them out of order, exactly like
RDMA work completions.

Frame types::

    REQ        one chunk fetch            (ShuffleRequest)
    DATA       one chunk reply            (FetchResult; the ACK fields)
    ERR        typed failure for one req  (error kind + message)
    SIZE_REQ   partition size probe       (job, reduce, map ids)
    SIZE       size reply                 (total bytes, -1 = unknown)
    HELLO      accept banner              (server generation + warm flag +
                                           capability bits; the FIRST
                                           frame on every accepted
                                           connection — a warm-restarted
                                           supplier advertises
                                           generation+1 so clients know
                                           resumed offsets are
                                           continuous)
    STATS      introspection snapshot req (empty payload; uncredited,
                                           riding the HELLO-banner
                                           precedent — it answers no
                                           fetch and must not compete
                                           with data for credits)
    STATS_REPLY                           (UTF-8 JSON: the remote
                                           process's live counters,
                                           gauges, histograms and its
                                           server's conn table —
                                           utils/stats.py
                                           introspection_snapshot)
    JOB        tenant handshake           (bind this connection to a
                                           (tenant, job, epoch) in the
                                           daemon's TenantRegistry —
                                           register/heartbeat/retire,
                                           HMAC-authenticated;
                                           uncredited like HELLO; sent
                                           to CAP_TENANT peers before
                                           a job's first REQ)
    JOB_OK     registration granted       (echoes the epoch; refusals
                                           are typed TenantError ERR
                                           frames on the same req id)
    PUSH       supplier-initiated chunk   (one partition chunk pushed
                                           from the supplier's commit
                                           point into reduce-side
                                           staging; req id is a
                                           server-minted push id the
                                           receiver echoes in PUSH_ACK/
                                           PUSH_NACK — sent ONLY on
                                           connections that subscribed
                                           via PUSH_SUB, so a push-less
                                           client never sees one)
    PUSH_SUB   push subscription          (client -> server: push this
                                           (job, reduce)'s partitions
                                           as they commit; carries the
                                           receiver's window and chunk
                                           preferences. Send only to
                                           CAP_PUSH peers)
    PUSH_ACK   push accepted              (empty payload; the push id
                                           correlates — releases one
                                           slot of the supplier's push
                                           window, the DATA credit
                                           discipline mirrored)
    PUSH_NACK  push refused               (reason code; the supplier
                                           marks the partition
                                           pull-only and the bytes
                                           already accepted stay
                                           usable as a resume prefix —
                                           over-budget/unknown pushes
                                           convert to ordinary pull
                                           with no bytes lost)

**Wire trace context** (versioned by LENGTH, as the v2 index is): REQ
and SIZE_REQ payloads may carry an optional trailing
``(trace_id, parent_span_id)`` pair (two u64s). An old decoder never
sees it — new clients append the block only to peers whose HELLO
banner advertises :data:`CAP_TRACE` — and a new decoder accepts both
shapes (exactly-zero or exactly-16 trailing bytes). The supplier adopts
the pair as the parent of its ``net.serve`` span, in both packages.

Decoding is STRICT: a bad magic, an unknown version, an out-of-range
type, a length over :data:`MAX_FRAME`, a short buffer or trailing
garbage all raise :class:`TransportError` — the receiving side treats
any of them as a broken connection (the stream has lost frame sync;
there is no resynchronization, like a torn RDMA connection there is
only reconnect). One deliberate soft spot: an in-range but UNKNOWN
frame type decodes fine at the header layer and is answered by the
server with a typed ``ERR`` frame instead of a teardown — a newer peer
probing an optional message (MSG_STATS-style) must get a clean refusal,
not a disconnect. ``ERR`` payloads carry the error's class name so the
reduce side re-raises the TYPED error (a supplier-side
``StorageError`` admission rejection must look like a StorageError to
the Segment retry machinery, not like a generic transport fault).
"""

from __future__ import annotations

import socket as _socket
import struct
from typing import Optional, Sequence

from uda_tpu_torch.mofserver.data_engine import FetchResult, ShuffleRequest
from uda_tpu_torch.utils.errors import (CompressionError, ConfigError,
                                        MergeError, ProtocolError,
                                        StorageError, StoreError,
                                        TenantError, TransportError, UdaError)

__all__ = ["MAGIC", "WIRE_VERSION", "MAX_FRAME", "HEADER", "WIRE_CODECS",
           "MSG_REQ", "MSG_DATA", "MSG_ERR", "MSG_SIZE_REQ", "MSG_SIZE",
           "MSG_HELLO", "MSG_STATS", "MSG_STATS_REPLY",
           "MSG_JOB", "MSG_JOB_OK",
           "MSG_PUSH", "MSG_PUSH_SUB", "MSG_PUSH_ACK", "MSG_PUSH_NACK",
           "CAP_TRACE", "CAP_TENANT", "CAP_OBS",
           "CAP_ELASTIC", "CAP_DRAINING", "CAP_PUSH",
           "encode_push", "decode_push_take",
           "encode_push_sub", "decode_push_sub",
           "encode_push_ack", "encode_push_nack", "decode_push_nack",
           "STATS_SEC_TS", "STATS_SEC_SLI", "STATS_SEC_ANOMALY",
           "STATS_SEC_ALL", "decode_stats_request",
           "encode_job", "decode_job", "encode_job_ok", "decode_job_ok",
           "encode_request", "decode_request", "decode_request_ex",
           "encode_result",
           "encode_result_head", "decode_result", "decode_result_take",
           "encode_error", "decode_error", "encode_size_request",
           "decode_size_request", "decode_size_request_ex",
           "encode_size", "decode_size",
           "encode_hello", "decode_hello", "decode_hello_ex",
           "encode_stats_request", "encode_stats_reply",
           "decode_stats_reply",
           "encode_frame", "decode_header", "recv_frame", "close_hard",
           "tune_socket"]

MAGIC = b"UD"
WIRE_VERSION = 1
# Frames above this are rejected before allocation: a desynced stream
# read as a length field must not turn into a multi-GB recv buffer.
MAX_FRAME = (1 << 30) + 4096

HEADER = struct.Struct("!2sBBQI")  # magic, version, type, req id, len

MSG_REQ = 1
MSG_DATA = 2
MSG_ERR = 3
MSG_SIZE_REQ = 4
MSG_SIZE = 5
MSG_HELLO = 6
MSG_STATS = 7        # introspection snapshot request (empty payload)
MSG_STATS_REPLY = 8  # introspection snapshot (UTF-8 JSON payload)
MSG_JOB = 9          # tenant handshake: bind this connection to
                     # (tenant, job, epoch) in the daemon's registry
                     # (register / heartbeat / retire; authenticated by
                     # an HMAC token when the server carries a secret).
                     # Uncredited like HELLO — registration must never
                     # compete with data for credits.
MSG_JOB_OK = 10      # MSG_JOB accepted: echoes the granted epoch.
                     # Refusals ride a typed ERR (TenantError) on the
                     # MSG_JOB's req id instead.
MSG_PUSH = 11        # supplier-initiated partition chunk (server ->
                     # client). Sent ONLY on connections that
                     # subscribed with MSG_PUSH_SUB, so push-less
                     # clients never see one. The req id is a
                     # server-minted push id echoed by PUSH_ACK/NACK.
MSG_PUSH_SUB = 12    # client -> server: push me (job, reduce) chunks
                     # as maps commit. Uncredited like MSG_JOB. Send
                     # only to CAP_PUSH peers — an older server answers
                     # a typed ERR (forward-compat contract) and the
                     # client just stays pull-only.
MSG_PUSH_ACK = 13    # push accepted into reduce-side staging (empty
                     # payload). Releases one slot of the supplier's
                     # push window — MSG_DATA's credit discipline,
                     # receiver-paced.
MSG_PUSH_NACK = 14   # push refused: reason code. The supplier marks
                     # the partition pull-only on this connection; the
                     # contiguous prefix already ACKed stays usable as
                     # a resume preload, so refusal costs zero bytes.

_TYPES = (MSG_REQ, MSG_DATA, MSG_ERR, MSG_SIZE_REQ, MSG_SIZE, MSG_HELLO,
          MSG_STATS, MSG_STATS_REPLY, MSG_JOB, MSG_JOB_OK,
          MSG_PUSH, MSG_PUSH_SUB, MSG_PUSH_ACK, MSG_PUSH_NACK)

# The frame-family table: every MSG_* constant maps to its (encoder,
# strict decoder) by NAME. A decoder of None is legal ONLY for
# header-only frames and carries its reason on the same line, so a new
# frame family lands fully wired (encoder + decoder + dispatch) or not
# at all.
WIRE_CODECS = {
    MSG_REQ: ("encode_request", "decode_request"),
    MSG_DATA: ("encode_result", "decode_result"),
    MSG_ERR: ("encode_error", "decode_error"),
    MSG_SIZE_REQ: ("encode_size_request", "decode_size_request"),
    MSG_SIZE: ("encode_size", "decode_size"),
    MSG_HELLO: ("encode_hello", "decode_hello"),
    MSG_STATS: ("encode_stats_request", "decode_stats_request"),
    MSG_STATS_REPLY: ("encode_stats_reply", "decode_stats_reply"),
    MSG_JOB: ("encode_job", "decode_job"),
    MSG_JOB_OK: ("encode_job_ok", "decode_job_ok"),
    MSG_PUSH: ("encode_push", "decode_push_take"),
    MSG_PUSH_SUB: ("encode_push_sub", "decode_push_sub"),
    MSG_PUSH_ACK: ("encode_push_ack",
                   None),  # header-only: the echoed push id IS the ack
    MSG_PUSH_NACK: ("encode_push_nack", "decode_push_nack"),
}
# the header accepts any type in this reserved range; semantically
# unknown ones get a typed ERR from the server, never a teardown (the
# forward-compat contract — see the module docstring). Anything past
# the range is a desynced stream, same as a bad magic.
_MAX_TYPE = 32

_REQ = struct.Struct("!IQI")      # reduce_id, offset, chunk_size
_DATA = struct.Struct("!QQQB")    # raw_length, part_length, offset, flags
_CRC = struct.Struct("!I")
_SIZE_REQ = struct.Struct("!II")  # reduce_id, num maps
_SIZE = struct.Struct("!q")       # total bytes, -1 = unknown
_HELLO = struct.Struct("!IB")     # server generation, flags
_TRACE = struct.Struct("!QQ")     # trace_id, parent_span_id (optional
                                  # REQ/SIZE_REQ tail — see docstring)
_JOB = struct.Struct("!IBH")      # epoch, flags (retire bit), weight
_JOB_OK = struct.Struct("!I")     # granted epoch echo
_PUSH = struct.Struct("!IQQB")    # reduce_id, offset, raw_length, flags
_PUSH_SUB = struct.Struct("!III")  # reduce_id, window, chunk bytes
_PUSH_NACK = struct.Struct("!B")  # reason code (uda_tpu.net.push)

_JOB_RETIRE = 0x01  # MSG_JOB flags: this is a retire, not a register

_HELLO_WARM = 0x01  # the generation continues a persisted handoff
# HELLO capability bits (old decoders mask only the bits they know —
# decode_hello tests _HELLO_WARM and ignores the rest, so advertising
# new bits is free):
CAP_TRACE = 0x02    # peer decodes the trace-context REQ/SIZE_REQ tail
                    # and serves MSG_STATS (the observability plane)
CAP_TENANT = 0x04   # peer runs the multi-tenant service plane: it
                    # accepts MSG_JOB registration and validates REQs
                    # against its job/epoch registry (uda_tpu/tenant/).
                    # Clients without a tenant binding ignore it; old
                    # clients never see it (decode_hello masks only
                    # the warm bit)
CAP_OBS = 0x08      # peer runs the live-telemetry plane:
                    # its MSG_STATS decoder accepts the optional
                    # trailing window/sections block (the _take_trace
                    # length-versioning discipline) and its replies can
                    # carry time-series rollup windows, per-tenant SLI
                    # blocks and the active-anomaly table. Send the
                    # tail ONLY to CAP_OBS peers — an older server
                    # treats trailing bytes as a torn frame
CAP_ELASTIC = 0x10  # peer participates in elastic membership: it
                    # may register mid-job (reduce sides fold
                    # a fresh CAP_ELASTIC banner into the candidate
                    # ring via HostRoutingClient.notify_join) and
                    # understands the symmetric drain announcement
CAP_DRAINING = 0x20  # peer is LEAVING: it has announced drain, is
                     # migrating its retained MOFs to the blob tier
                     # (StoreManager.drain) and will refuse no inflight
                     # work but should receive no NEW placements; the
                     # reduce side demotes it in candidate ranking
CAP_PUSH = 0x40     # peer runs the push plane: it accepts
                    # MSG_PUSH_SUB subscriptions and will push
                    # committed partitions as MSG_PUSH frames. A
                    # draining supplier stops advertising it so new
                    # conns stay pull-only; clients subscribe ONLY
                    # when the banner carries this bit.

# the optional MSG_STATS request tail: requested rollup-window seconds
# + a section bitmask. Exactly 0 bytes (the plain snapshot's shape)
# or exactly _STATS_OPT.size bytes may follow the (empty)
# base payload — the length IS the version.
_STATS_OPT = struct.Struct("!II")
STATS_SEC_TS = 0x01       # timeseries: the rollup-ring window
STATS_SEC_SLI = 0x02      # sli: the per-tenant SLI/SLO book
STATS_SEC_ANOMALY = 0x04  # anomalies: the active-anomaly table
STATS_SEC_ALL = STATS_SEC_TS | STATS_SEC_SLI | STATS_SEC_ANOMALY

_FLAG_LAST = 0x01
_FLAG_CRC = 0x02

# ERR frames carry the error's class name; the decoder re-raises the
# same typed error on the reduce side so recovery paths (Segment retry,
# supplier-admission backoff) see realistic types across the wire.
_ERROR_CLASSES = {cls.__name__: cls for cls in
                  (UdaError, ConfigError, ProtocolError, TransportError,
                   MergeError, StorageError, StoreError, CompressionError,
                   TenantError)}


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise ProtocolError(f"string field too long for the wire "
                            f"({len(b)} B > 65535)")
    return struct.pack("!H", len(b)) + b


def _unpack_str(payload, off: int, what: str) -> tuple[str, int]:
    """Buffer-agnostic (bytes OR memoryview: the event-loop cores decode
    straight out of their receive buffers without materializing the
    payload as bytes first)."""
    if off + 2 > len(payload):
        raise TransportError(f"truncated frame: no length for {what}")
    (n,) = struct.unpack_from("!H", payload, off)
    off += 2
    if off + n > len(payload):
        raise TransportError(f"truncated frame: {what} needs {n} B, "
                             f"{len(payload) - off} left")
    return bytes(payload[off:off + n]).decode("utf-8"), off + n


def _done(payload: bytes, off: int, what: str) -> None:
    if off != len(payload):
        raise TransportError(f"malformed {what} frame: "
                             f"{len(payload) - off} trailing bytes")


# -- encode ------------------------------------------------------------------

def encode_frame(msg_type: int, req_id: int, payload: bytes) -> bytes:
    return HEADER.pack(MAGIC, WIRE_VERSION, msg_type, req_id,
                       len(payload)) + payload


def encode_request(req_id: int, req: ShuffleRequest,
                   trace: Optional[tuple] = None) -> bytes:
    """``trace`` is the optional ``(trace_id, parent_span_id)`` pair —
    append it ONLY to peers whose HELLO advertised :data:`CAP_TRACE`
    (an old decoder treats trailing bytes as a torn frame)."""
    payload = (_REQ.pack(req.reduce_id, req.offset, req.chunk_size)
               + _pack_str(req.job_id) + _pack_str(req.map_id))
    if trace is not None:
        payload += _TRACE.pack(trace[0], trace[1])
    return encode_frame(MSG_REQ, req_id, payload)


def encode_result_head(req_id: int, *, raw_length: int, part_length: int,
                       offset: int, last: bool, path: str,
                       crc: Optional[int] = None, data_len: int) -> bytes:
    """Everything of a DATA frame BEFORE the chunk bytes — frame header
    plus the ACK fields — with the payload length accounting for
    ``data_len`` chunk bytes that the caller sends separately (the
    buffer-donating encode: ``sendmsg([head, chunk])`` scatter-gather,
    or ``head`` + ``os.sendfile`` when the chunk is fd-backed). The
    chunk bytes never pass through an encode-side concatenation."""
    flags = (_FLAG_LAST if last else 0) | \
            (_FLAG_CRC if crc is not None else 0)
    meta = _DATA.pack(raw_length, part_length, offset, flags)
    if crc is not None:
        meta += _CRC.pack(crc & 0xFFFFFFFF)
    meta += _pack_str(path)
    return HEADER.pack(MAGIC, WIRE_VERSION, MSG_DATA, req_id,
                       len(meta) + data_len) + meta


def encode_result(req_id: int, res: FetchResult) -> bytes:
    return encode_result_head(
        req_id, raw_length=res.raw_length, part_length=res.part_length,
        offset=res.offset, last=res.last, path=res.path, crc=res.crc,
        data_len=len(res.data)) + res.data


def encode_error(req_id: int, exc: BaseException) -> bytes:
    """Total by construction: the message is diagnostics, so an
    over-long one is truncated to fit the u16 string field rather than
    failing the encode — an ERR frame that cannot be encoded would
    strand the request's credit on the server."""
    message = str(exc)
    if len(message.encode("utf-8")) > 0xFFF0:
        message = message.encode("utf-8")[:0xFFF0].decode("utf-8",
                                                          "ignore")
    payload = _pack_str(type(exc).__name__[:256]) + _pack_str(message)
    return encode_frame(MSG_ERR, req_id, payload)


def encode_size_request(req_id: int, job_id: str, map_ids: Sequence[str],
                        reduce_id: int,
                        trace: Optional[tuple] = None) -> bytes:
    payload = b"".join([_SIZE_REQ.pack(reduce_id, len(map_ids)),
                        _pack_str(job_id),
                        *(_pack_str(mid) for mid in map_ids)])
    if trace is not None:
        payload += _TRACE.pack(trace[0], trace[1])
    return encode_frame(MSG_SIZE_REQ, req_id, payload)


def encode_size(req_id: int, total: Optional[int]) -> bytes:
    return encode_frame(MSG_SIZE, req_id,
                        _SIZE.pack(-1 if total is None else total))


def encode_hello(generation: int, warm: bool,
                 caps: int = CAP_TRACE) -> bytes:
    """The accept banner (req id 0 — it correlates with nothing).
    ``caps`` bits advertise optional capabilities (trace-context
    frames, MSG_STATS); decoders from before a bit existed ignore
    it."""
    flags = (_HELLO_WARM if warm else 0) | (caps & 0xFE)
    return encode_frame(MSG_HELLO, 0,
                        _HELLO.pack(generation & 0xFFFFFFFF, flags))


def decode_hello(payload) -> tuple[int, bool]:
    """-> (server generation, warm). Ignores capability bits it does
    not know — the forward-compat contract that lets new servers
    advertise CAP_TRACE to old clients."""
    generation, warm, _ = decode_hello_ex(payload)
    return generation, warm


def decode_hello_ex(payload) -> tuple[int, bool, int]:
    """-> (server generation, warm, capability bits)."""
    if len(payload) != _HELLO.size:
        raise TransportError(f"malformed HELLO frame ({len(payload)} B)")
    generation, flags = _HELLO.unpack(payload)
    return generation, bool(flags & _HELLO_WARM), flags & 0xFE


def encode_job(req_id: int, tenant_id: str, job_id: str, epoch: int,
               weight: int = 1, token: str = "",
               retire: bool = False) -> bytes:
    """MSG_JOB: bind the connection to (tenant, job, epoch) in the
    daemon's registry. ``token`` is the HMAC authentication string
    (:func:`uda_tpu.tenant.registry.sign_job`; empty when the server
    carries no secret); ``retire`` flips the frame from register/
    heartbeat to the job's retirement. Send only to peers whose HELLO
    advertised :data:`CAP_TENANT` — an older server answers a typed
    ProtocolError ERR, which is a clean refusal but a wasted frame."""
    flags = _JOB_RETIRE if retire else 0
    payload = (_JOB.pack(int(epoch) & 0xFFFFFFFF, flags,
                         max(1, int(weight)) & 0xFFFF)
               + _pack_str(tenant_id) + _pack_str(job_id)
               + _pack_str(token))
    return encode_frame(MSG_JOB, req_id, payload)


def decode_job(payload) -> tuple:
    """-> (tenant_id, job_id, epoch, weight, token, retire)."""
    if len(payload) < _JOB.size:
        raise TransportError(f"truncated JOB frame ({len(payload)} B)")
    epoch, flags, weight = _JOB.unpack_from(payload, 0)
    tenant_id, off = _unpack_str(payload, _JOB.size, "tenant id")
    job_id, off = _unpack_str(payload, off, "job id")
    token, off = _unpack_str(payload, off, "token")
    _done(payload, off, "JOB")
    return (tenant_id, job_id, epoch, weight, token,
            bool(flags & _JOB_RETIRE))


def encode_job_ok(req_id: int, epoch: int) -> bytes:
    """MSG_JOB accepted: the granted epoch, echoed (refusals are typed
    ERR frames on the same req id — TenantError for auth/stale-epoch/
    retired, so the client re-raises the exact registry error)."""
    return encode_frame(MSG_JOB_OK, req_id,
                        _JOB_OK.pack(int(epoch) & 0xFFFFFFFF))


def decode_job_ok(payload) -> int:
    if len(payload) != _JOB_OK.size:
        raise TransportError(f"malformed JOB_OK frame ({len(payload)} B)")
    return _JOB_OK.unpack(bytes(payload))[0]


def encode_stats_request(req_id: int, window_s: Optional[int] = None,
                         sections: int = STATS_SEC_ALL) -> bytes:
    """MSG_STATS: snapshot a remote process's live telemetry. Empty
    payload; uncredited on the server (the HELLO precedent) so an
    introspection poll can never be starved by a full data pipeline.

    ``window_s`` asks a :data:`CAP_OBS` peer to append the requested
    observability ``sections`` (time-series rollups over the trailing
    ``window_s`` seconds, per-tenant SLI blocks, active anomalies) —
    the optional tail rides the same exactly-0-or-exactly-N
    length-versioning as the trace context. Append it ONLY to CAP_OBS
    peers."""
    payload = b""
    if window_s is not None:
        payload = _STATS_OPT.pack(max(0, int(window_s)) & 0xFFFFFFFF,
                                  sections & 0xFFFFFFFF)
    return encode_frame(MSG_STATS, req_id, payload)


def decode_stats_request(payload) -> Optional[tuple]:
    """-> ``(window_s, sections)`` when the CAP_OBS tail is present,
    None for the plain empty-payload shape. Anything else is a torn
    frame (the _take_trace discipline)."""
    if len(payload) == 0:
        return None
    if len(payload) == _STATS_OPT.size:
        return _STATS_OPT.unpack(bytes(payload))
    raise TransportError(f"malformed STATS frame: {len(payload)} "
                         f"trailing bytes")


def encode_stats_reply(req_id: int, snapshot: dict) -> bytes:
    """The introspection snapshot as UTF-8 JSON (the shape is
    ``uda_tpu_torch.utils.stats.introspection_snapshot``)."""
    import json

    return encode_frame(MSG_STATS_REPLY, req_id,
                        json.dumps(snapshot, default=repr).encode("utf-8"))


def decode_stats_reply(payload) -> dict:
    import json

    try:
        return json.loads(bytes(payload).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise TransportError(f"malformed STATS_REPLY frame: {e}") from e


def encode_push(push_id: int, *, job_id: str, map_id: str, reduce_id: int,
                offset: int, raw_length: int, last: bool,
                data: bytes) -> bytes:
    """MSG_PUSH: one supplier-initiated partition chunk. ``offset`` is
    the chunk's position in the partition's raw on-disk byte stream and
    ``raw_length`` its total — the same coordinates a resumed fetch
    would use, which is what lets the receiver ledger pushed bytes as
    if they were fetched. ``last`` marks the partition's final chunk.

    ``push_id`` is minted by the supplier; PUSH_ACK/PUSH_NACK echo it."""
    payload = (_PUSH.pack(reduce_id & 0xFFFFFFFF, offset, raw_length,
                          _FLAG_LAST if last else 0)
               + _pack_str(job_id) + _pack_str(map_id) + bytes(data))
    return encode_frame(MSG_PUSH, push_id, payload)


def decode_push_take(payload: bytearray) -> tuple:
    """-> ``(job_id, map_id, reduce_id, offset, raw_length, last,
    data)``. Buffer-donating like :func:`decode_result_take`: the chunk
    bytes are carved out of ``payload`` without a second copy of the
    metadata prefix."""
    if len(payload) < _PUSH.size:
        raise TransportError("truncated PUSH frame")
    reduce_id, offset, raw_length, flags = _PUSH.unpack_from(
        bytes(payload[:_PUSH.size]))
    job_id, off = _unpack_str(payload, _PUSH.size, "job id")
    map_id, off = _unpack_str(payload, off, "map id")
    del payload[:off]
    return (job_id, map_id, reduce_id, offset, raw_length,
            bool(flags & _FLAG_LAST), payload)


def encode_push_sub(req_id: int, *, job_id: str, reduce_id: int,
                    window: int, chunk_size: int) -> bytes:
    """MSG_PUSH_SUB: subscribe this connection to (job, reduce) pushes.
    ``window`` is the receiver's un-ACKed-push ceiling and
    ``chunk_size`` its preferred chunk bytes; the supplier takes the
    min with its own knobs. Send only to :data:`CAP_PUSH` peers."""
    payload = (_PUSH_SUB.pack(reduce_id & 0xFFFFFFFF,
                              window & 0xFFFFFFFF,
                              chunk_size & 0xFFFFFFFF)
               + _pack_str(job_id))
    return encode_frame(MSG_PUSH_SUB, req_id, payload)


def decode_push_sub(payload) -> tuple:
    """-> ``(job_id, reduce_id, window, chunk_size)``."""
    if len(payload) < _PUSH_SUB.size:
        raise TransportError("truncated PUSH_SUB frame")
    reduce_id, window, chunk_size = _PUSH_SUB.unpack(
        bytes(payload[:_PUSH_SUB.size]))
    job_id, off = _unpack_str(payload, _PUSH_SUB.size, "job id")
    _done(payload, off, "PUSH_SUB frame")
    return job_id, reduce_id, window, chunk_size


def encode_push_ack(push_id: int) -> bytes:
    """MSG_PUSH_ACK: the chunk landed in staging. Empty payload — the
    push id says it all. Releases one push-window slot."""
    return encode_frame(MSG_PUSH_ACK, push_id, b"")


def encode_push_nack(push_id: int, reason: int) -> bytes:
    """MSG_PUSH_NACK: the chunk was refused (reason codes live in
    ``uda_tpu.net.push``). The supplier marks the partition pull-only;
    the ACKed prefix stays valid."""
    return encode_frame(MSG_PUSH_NACK, push_id,
                        _PUSH_NACK.pack(reason & 0xFF))


def decode_push_nack(payload) -> int:
    """-> reason code."""
    if len(payload) != _PUSH_NACK.size:
        raise TransportError("malformed PUSH_NACK frame")
    return _PUSH_NACK.unpack(bytes(payload))[0]


# -- decode ------------------------------------------------------------------

def decode_header(header: bytes) -> tuple[int, int, int]:
    """Strict header decode -> (msg_type, req_id, payload_len)."""
    if len(header) != HEADER.size:
        raise TransportError(f"truncated frame header "
                             f"({len(header)}/{HEADER.size} B)")
    magic, version, msg_type, req_id, length = HEADER.unpack(header)
    if magic != MAGIC:
        raise TransportError(f"bad frame magic {magic!r} (stream lost "
                             f"frame sync or peer is not a uda_tpu "
                             f"shuffle endpoint)")
    if version != WIRE_VERSION:
        raise TransportError(f"wire version mismatch: peer speaks "
                             f"v{version}, this side v{WIRE_VERSION}")
    if not 1 <= msg_type <= _MAX_TYPE:
        # far outside the reserved range: this is a desynced stream,
        # not a newer peer — in-range unknown types pass here and get
        # a typed ERR from the semantic layer instead of a teardown
        raise TransportError(f"unknown frame type {msg_type}")
    if length > MAX_FRAME:
        raise TransportError(f"frame length {length} exceeds the "
                             f"{MAX_FRAME} B cap (desynced stream?)")
    return msg_type, req_id, length


def _take_trace(payload, off: int, what: str) -> Optional[tuple]:
    """The optional trailing trace-context block: exactly zero or
    exactly ``_TRACE.size`` bytes may remain (the length IS the
    version, as for the v2 index); anything else is a torn frame."""
    rest = len(payload) - off
    if rest == 0:
        return None
    if rest == _TRACE.size:
        return _TRACE.unpack_from(payload, off)
    raise TransportError(f"malformed {what} frame: {rest} trailing bytes")


def decode_request(payload: bytes) -> ShuffleRequest:
    return decode_request_ex(payload)[0]


def decode_request_ex(payload) -> tuple[ShuffleRequest, Optional[tuple]]:
    """-> (request, optional (trace_id, parent_span_id) wire trace
    context). Old peers send no trace tail; both shapes decode."""
    if len(payload) < _REQ.size:
        raise TransportError(f"truncated REQ frame ({len(payload)} B)")
    reduce_id, offset, chunk_size = _REQ.unpack_from(payload, 0)
    job_id, off = _unpack_str(payload, _REQ.size, "job id")
    map_id, off = _unpack_str(payload, off, "map id")
    trace = _take_trace(payload, off, "REQ")
    return (ShuffleRequest(job_id, map_id, reduce_id, offset, chunk_size),
            trace)


def _decode_result_meta(payload):
    """Parse a DATA payload's meta prefix in place -> (raw_length,
    part_length, offset, last, crc, path, data_start)."""
    if len(payload) < _DATA.size:
        raise TransportError(f"truncated DATA frame ({len(payload)} B)")
    raw_length, part_length, offset, flags = _DATA.unpack_from(payload, 0)
    off = _DATA.size
    crc = None
    if flags & _FLAG_CRC:
        if off + _CRC.size > len(payload):
            raise TransportError("truncated DATA frame: CRC flagged "
                                 "but absent")
        (crc,) = _CRC.unpack_from(payload, off)
        off += _CRC.size
    path, off = _unpack_str(payload, off, "path")
    return (raw_length, part_length, offset, bool(flags & _FLAG_LAST),
            crc, path, off)


def decode_result(payload) -> FetchResult:
    """Accepts bytes or a memoryview (meta fields are parsed in place;
    the single ``bytes()`` of the data region is the only copy)."""
    raw_length, part_length, offset, last, crc, path, off = \
        _decode_result_meta(payload)
    return FetchResult(bytes(payload[off:]), raw_length, part_length,
                       offset, path, last=last, crc=crc)


def decode_result_take(payload: bytearray) -> FetchResult:
    """Buffer-donating decode: ``payload`` is a bytearray the caller
    OWNS (the event-loop client's per-frame receive buffer) — the meta
    fields are parsed in place, the short meta prefix is deleted with
    one memmove, and the SAME bytearray becomes ``FetchResult.data``.
    Zero allocations, zero full-payload copies on the receive path;
    every downstream consumer (record cracking, CRC, decompress,
    ``carry + data`` concatenation) is buffer-agnostic."""
    raw_length, part_length, offset, last, crc, path, off = \
        _decode_result_meta(payload)
    del payload[:off]  # one short memmove; the chunk stays in place
    return FetchResult(payload, raw_length, part_length, offset, path,
                       last=last, crc=crc)


def decode_error(payload: bytes) -> UdaError:
    kind, off = _unpack_str(payload, 0, "error kind")
    message, off = _unpack_str(payload, off, "error message")
    _done(payload, off, "ERR")
    cls = _ERROR_CLASSES.get(kind, TransportError)
    err = cls(f"remote: {message}")
    err.remote_kind = kind
    return err


def decode_size_request(payload: bytes) -> tuple[str, list[str], int]:
    return decode_size_request_ex(payload)[0]


def decode_size_request_ex(payload) -> tuple[tuple, Optional[tuple]]:
    """-> ((job_id, map_ids, reduce_id), optional trace context)."""
    if len(payload) < _SIZE_REQ.size:
        raise TransportError(f"truncated SIZE_REQ frame ({len(payload)} B)")
    reduce_id, n = _SIZE_REQ.unpack_from(payload, 0)
    job_id, off = _unpack_str(payload, _SIZE_REQ.size, "job id")
    mids = []
    for i in range(n):
        mid, off = _unpack_str(payload, off, f"map id {i}")
        mids.append(mid)
    trace = _take_trace(payload, off, "SIZE_REQ")
    return (job_id, mids, reduce_id), trace


def decode_size(payload: bytes) -> Optional[int]:
    if len(payload) != _SIZE.size:
        raise TransportError(f"malformed SIZE frame ({len(payload)} B)")
    (total,) = _SIZE.unpack(payload)
    return None if total < 0 else total


# -- socket helpers ----------------------------------------------------------

def tune_socket(sock, sockbuf_kb: int = 0) -> None:
    """Data-plane socket tuning, applied to EVERY connection on both
    sides and both cores: ``TCP_NODELAY`` always (small REQ/SIZE frames
    must not eat Nagle delays waiting for an ACK that the peer is
    itself delaying), and ``SO_SNDBUF``/``SO_RCVBUF`` sized from the
    ``uda.tpu.net.sockbuf.kb`` knob when non-zero (0 = leave the OS
    autotuned defaults alone)."""
    try:
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    except OSError:
        pass  # not a TCP socket (socketpair in tests)
    if sockbuf_kb > 0:
        nbytes = int(sockbuf_kb) * 1024
        for opt in (_socket.SO_SNDBUF, _socket.SO_RCVBUF):
            try:
                sock.setsockopt(_socket.SOL_SOCKET, opt, nbytes)
            except OSError:
                pass  # kernel caps (wmem_max) clamp silently anyway


def close_hard(sock) -> None:
    """shutdown() then close(): close() alone neither wakes a thread
    blocked in recv() on the socket nor sends the FIN while that
    thread's syscall pins the file description — the reader (ours or
    the peer's) would block forever on a 'closed' connection. Also the
    only reliable way to wake a thread blocked in accept() on a
    listening socket."""
    try:
        sock.shutdown(_socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock, n: int, what: str,
                allow_eof: bool = False) -> Optional[bytes]:
    """Read exactly ``n`` bytes. Clean EOF before the FIRST byte returns
    None when ``allow_eof`` (a peer closing between frames is a normal
    hangup); EOF anywhere else is a mid-frame disconnect ->
    TransportError."""
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if not parts and allow_eof:
                return None
            raise TransportError(
                f"connection closed mid-frame ({got}/{n} B of {what})")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def recv_frame(sock) -> Optional[tuple[int, int, bytes]]:
    """Read one complete frame -> (msg_type, req_id, payload), or None
    on a clean EOF at a frame boundary. Strict: any malformation raises
    TransportError and the caller must drop the connection."""
    header = _recv_exact(sock, HEADER.size, "frame header", allow_eof=True)
    if header is None:
        return None
    msg_type, req_id, length = decode_header(header)
    payload = _recv_exact(sock, length, "frame payload") if length else b""
    return msg_type, req_id, payload
