"""Push-based pipelined shuffle: the supplier-initiated MSG_PUSH plane.

The port's copy of ``uda_tpu/net/push.py``. Pull alone makes the merge
wait for the first fetch wave, so map, shuffle and reduce serialize at
that barrier; with push (the Exoshuffle policy, arXiv:2203.05072) the
supplier streams each partition to the reduce side's staging as its map
output commits, and the phases overlap. The plane rides seams the data
plane already has:

- **Negotiation**: the HELLO banner advertises :data:`wire.CAP_PUSH`; a
  client that wants pushes subscribes a (job, reduce) with MSG_PUSH_SUB.
  No subscription, no pushes: a push-less client on a push server (or
  the reverse) stays pure pull, byte for byte.
- **Supplier side** (:class:`PushScheduler`, owned by the ShuffleServer):
  each commit notification (``MOFWriter(on_commit=)`` ->
  ``ShuffleServer.notify_commit``) queues one push task per subscribed
  connection; a per-connection window of un-ACKed pushes (the smaller of
  both peers' ``uda.tpu.push.window``) gates chunk reads through
  ``DataEngine.submit``, the copy path, never the zero-copy plane. A
  draining supplier stops initiating.
- **Reduce side** (:class:`PushStaging`, owned by the MergeManager):
  pushed chunks accumulate per map as the partition's contiguous raw
  prefix, the coordinates of a resumed fetch. The admission ladder
  decides per chunk: accept into memory under the eager cap, spill to a
  staging file under the staged cap, else PUSH_NACK(BUDGET); the supplier
  marks that partition pull-only and the prefix already accepted stays
  usable.
- **Adoption**: when a segment starts, the merge manager ``take()``s the
  staged prefix and arms it with ``Segment.ckpt_preload``: pushed bytes
  enter the offset ledger as a resumed fetch would, so retry,
  speculation, reconstruction and checkpoints compose unchanged. The
  last staged chunk is always withheld: the pull path refetches the
  tail and stays the byte-identity oracle on every partition.

``take()`` claims the map: later pushes for it draw PUSH_NACK(CLAIMED),
the dedup against the now in-flight fetch.
"""

from __future__ import annotations

import os
import tempfile
from collections import OrderedDict, deque
from typing import Optional

from uda_tpu_torch.utils.errors import UdaError
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.ifile import crack_partial
from uda_tpu_torch.utils.locks import TrackedLock, race_instrument
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["PushStaging", "PushScheduler", "NACK_BUDGET", "NACK_UNKNOWN",
           "NACK_CLAIMED", "NACK_DISABLED", "NACK_GAP", "NACK_REASONS",
           "nack_reason_name"]

log = get_logger()

# PUSH_NACK reason codes (the wire carries the int; the names label
# metrics and logs; branch on the code)
NACK_BUDGET = 1    # staging caps exhausted; prefix kept, pull the rest
NACK_UNKNOWN = 2   # no staging for (job, reduce), e.g. unregistered
NACK_CLAIMED = 3   # a Segment already took this map (in-flight fetch)
NACK_DISABLED = 4  # push plane off on this peer
NACK_GAP = 5       # offset is not the contiguous next byte; prefix kept

NACK_REASONS = {
    NACK_BUDGET: "budget",
    NACK_UNKNOWN: "unknown",
    NACK_CLAIMED: "claimed",
    NACK_DISABLED: "disabled",
    NACK_GAP: "gap",
}


def nack_reason_name(code: int) -> str:
    return NACK_REASONS.get(code, f"code{code}")


# -- reduce side -------------------------------------------------------------


class _MapStage:
    """One partition's staged contiguous prefix: raw on-disk bytes from
    offset 0, an in-memory bytearray (the eager tier) followed by an
    overflow file (the spill tier)."""

    __slots__ = ("mem", "spill_path", "spill_bytes", "chunk_lens",
                 "next_off", "raw_length", "complete", "claimed")

    def __init__(self):
        self.mem = bytearray()
        self.spill_path: Optional[str] = None
        self.spill_bytes = 0
        self.chunk_lens: list[int] = []
        self.next_off = 0
        self.raw_length: Optional[int] = None
        self.complete = False
        self.claimed = False

    @property
    def total(self) -> int:
        return len(self.mem) + self.spill_bytes


@race_instrument("_maps")
class PushStaging:
    """Reduce-side staging for one (job, reduce): the landing zone of
    MSG_PUSH chunks and the preload source of the merge's Segments.

    ``offer`` runs on the client loop's dispatcher thread, ``take`` and
    ``close`` on the merge manager's thread; one lock serializes them."""

    def __init__(self, job_id: str, reduce_id: int, *, cfg,
                 budget=None):
        self.job_id = job_id
        self.reduce_id = int(reduce_id)
        eager_mb = float(cfg.get("uda.tpu.push.eager.mb"))
        staged_mb = float(cfg.get("uda.tpu.push.staged.mb"))
        if eager_mb > 0:
            self.eager_cap = int(eager_mb * (1 << 20))
        elif budget is not None:
            # auto: an eighth of the host read budget, so pushes never
            # crowd out the fetch pipeline's own admission
            self.eager_cap = max(1 << 20, budget.host_budget_bytes // 8)
        else:
            self.eager_cap = 8 << 20
        self.staged_cap = (int(staged_mb * (1 << 20)) if staged_mb > 0
                           else 4 * self.eager_cap)
        self.spill_ok = bool(cfg.get("uda.tpu.push.spill"))
        from uda_tpu_torch.merger.streaming import spill_dirs
        self._spill_dir = spill_dirs(cfg)[0]
        self._lock = TrackedLock("push.staging")
        self._maps: "OrderedDict[str, _MapStage]" = OrderedDict()
        self._closed = False

    # -- admission ladder (one verdict per pushed chunk) --

    def offer(self, map_id: str, offset: int, raw_length: int,
              last: bool, data) -> int:
        """Admit one pushed chunk. Returns 0 (ACK) or a NACK reason code.
        The contiguous prefix accepted so far survives every refusal: a
        NACK turns the remainder into ordinary pull."""
        n = len(data)
        with self._lock:
            if self._closed:
                return self._refused(NACK_UNKNOWN)
            st = self._maps.get(map_id)
            if st is None:
                st = self._maps[map_id] = _MapStage()
            if st.claimed:
                return self._refused(NACK_CLAIMED)
            if offset != st.next_off:
                return self._refused(NACK_GAP)
            try:
                failpoint("push.admit", key=f"{self.job_id}:{map_id}")
            except UdaError:
                return self._refused(NACK_BUDGET)
            total = sum(s.total for s in self._maps.values())
            if total + n > self.staged_cap:
                return self._refused(NACK_BUDGET)
            mem = sum(len(s.mem) for s in self._maps.values())
            if st.spill_path is None and mem + n <= self.eager_cap:
                st.mem += data
                tier = "eager"
            elif self.spill_ok:
                try:
                    self._spill(st, data)
                except OSError as e:
                    log.warn(f"push: staging spill failed ({e}); "
                             f"refusing chunk")
                    return self._refused(NACK_BUDGET)
                tier = "spill"
            else:
                return self._refused(NACK_BUDGET)
            st.chunk_lens.append(n)
            st.next_off = offset + n
            st.raw_length = int(raw_length)
            st.complete = bool(last)
            metrics.add("push.accepted", tier=tier)
            metrics.add("push.accepted.bytes", n)
            metrics.gauge_add("push.staged.bytes", n)  # take()/close() settle
            return 0

    @staticmethod
    def _refused(reason: int) -> int:
        metrics.add("push.refused", reason=nack_reason_name(reason))
        return reason

    def _spill(self, st: _MapStage, data) -> None:
        """Append ``data`` to the map's staging file (the spill tier keeps
        strict byte order after the memory prefix)."""
        if st.spill_path is None:
            fd, st.spill_path = tempfile.mkstemp(
                prefix=f"uda-push-{self.reduce_id}-", suffix=".stage",
                dir=self._spill_dir)
            os.close(fd)
        with open(st.spill_path, "ab") as f:
            f.write(data)
        st.spill_bytes += len(data)
        metrics.add("push.spilled.bytes", len(data))

    # -- adoption --

    def take(self, map_id: str) -> Optional[dict]:
        """Claim ``map_id`` and return ``Segment.ckpt_preload`` arguments
        for its staged prefix, or None when nothing usable is staged. The
        claim is unconditional: from here on pushes for this map draw
        NACK_CLAIMED.

        The last staged chunk is withheld, so ``next_offset`` stays
        strictly inside the partition: the pull path always refetches a
        tail chunk and remains the byte-identity oracle."""
        with self._lock:
            st = self._maps.get(map_id)
            if st is None:
                st = self._maps[map_id] = _MapStage()
                st.claimed = True
                return None
            if st.claimed:
                return None
            st.claimed = True
            total = st.total
            if total:
                metrics.gauge_add("push.staged.bytes", -total)
            if not st.chunk_lens:
                return None
            usable = total - st.chunk_lens[-1]
            if usable <= 0:
                self._free(st)
                return None
            data = bytes(st.mem)
            if st.spill_bytes:
                with open(st.spill_path, "rb") as f:
                    data += f.read()
            raw_length = st.raw_length
            self._free(st)
        data = data[:usable]
        try:
            batch, consumed, _ = crack_partial(data, expect_eof=False)
        except UdaError:
            metrics.add("push.invalidated")
            return None
        return dict(data=data, carry_len=len(data) - consumed,
                    next_offset=usable, raw_length=raw_length,
                    num_records=batch.num_records)

    @staticmethod
    def _free(st: _MapStage) -> None:
        """Lock held: drop a claimed map's staged bytes (the gauge was
        settled by the claim)."""
        st.mem = bytearray()
        st.chunk_lens = []
        if st.spill_path is not None:
            try:
                os.unlink(st.spill_path)
            except OSError:
                pass
            st.spill_path = None
        st.spill_bytes = 0

    def staged_bytes(self) -> int:
        with self._lock:
            return sum(s.total for s in self._maps.values()
                       if not s.claimed)

    def close(self) -> None:
        """Discard everything unclaimed and settle the staged gauge
        (idempotent; the MergeManager calls it when the run ends)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for st in self._maps.values():
                if not st.claimed and st.total:
                    metrics.gauge_add("push.staged.bytes", -st.total)
                st.claimed = True
                self._free(st)
            self._maps.clear()


# -- supplier side -----------------------------------------------------------


class _PushTask:
    """One (subscription, map) pair being pushed: its chunks go out one at
    a time (ordering by construction; the window runs tasks side by
    side)."""

    __slots__ = ("job_id", "map_id", "reduce_id", "offset", "inflight",
                 "dead")

    def __init__(self, job_id: str, map_id: str, reduce_id: int):
        self.job_id = job_id
        self.map_id = map_id
        self.reduce_id = reduce_id
        self.offset = 0
        self.inflight = False
        self.dead = False


class _ConnSub:
    """Per-connection push state: the subscriptions this peer asked for,
    the task queue feeding it and the un-ACKed window."""

    __slots__ = ("conn", "subs", "tasks", "window", "chunk", "on_air",
                 "pull_only")

    def __init__(self, conn, window: int, chunk: int):
        self.conn = conn
        self.subs: set = set()        # {(job_id, reduce_id)}
        self.tasks: deque = deque()
        self.window = window
        self.chunk = chunk
        self.on_air = 0
        self.pull_only: set = set()   # {(job_id, reduce_id, map_id)}


@race_instrument("_subs", "_commits", "_inflight")
class PushScheduler:
    """Supplier-side push pump, owned by the ShuffleServer.

    ``subscribe``/``on_ack``/``on_nack``/``drop_conn`` arrive on the loop
    thread, ``notify_commit`` on whatever thread runs the writer, chunk
    completions on the engine's pool threads. One lock guards the tables
    and is never held across an engine submit or a connection
    enqueue."""

    def __init__(self, server, engine, cfg):
        self.server = server
        self.engine = engine
        self.window = max(1, int(cfg.get("uda.tpu.push.window")))
        self.chunk = int(cfg.get("mapred.rdma.buf.size")) * 1024
        self._lock = TrackedLock("push.sched")
        self._subs: dict = {}        # id(conn) -> _ConnSub
        self._commits: dict = {}     # job_id -> OrderedDict[map_id]
        self._inflight: dict = {}    # push_id -> (_ConnSub, _PushTask)
        self._next_id = 1
        self._stopped = False

    # -- control-plane entry points --

    def subscribe(self, conn, job_id: str, reduce_id: int,
                  window: int, chunk: int) -> None:
        """MSG_PUSH_SUB: remember the subscription and catch up on maps
        that committed before it arrived."""
        metrics.add("push.subs")
        with self._lock:
            if self._stopped:
                return
            cs = self._subs.get(id(conn))
            if cs is None:
                cs = self._subs[id(conn)] = _ConnSub(
                    conn,
                    window=max(1, min(self.window, int(window) or 1)),
                    chunk=max(4096, min(self.chunk, int(chunk)
                                        or self.chunk)))
            key = (job_id, int(reduce_id))
            if key in cs.subs:
                return
            cs.subs.add(key)
            for map_id in self._commits.get(job_id, ()):
                cs.tasks.append(_PushTask(job_id, map_id,
                                          int(reduce_id)))
        self._pump(conn)

    def notify_commit(self, job_id: str, map_id: str) -> None:
        """A writer committed ``map_id``: one push task to every
        subscribed connection (any thread)."""
        metrics.add("push.commits")
        conns = []
        with self._lock:
            if self._stopped:
                return
            self._commits.setdefault(job_id, OrderedDict())[map_id] = \
                None
            for cs in self._subs.values():
                for (job, reduce_id) in cs.subs:
                    if job == job_id:
                        cs.tasks.append(_PushTask(job_id, map_id,
                                                  reduce_id))
                        conns.append(cs.conn)
        for conn in conns:
            self._pump(conn)

    def on_ack(self, conn, push_id: int) -> None:
        metrics.add("push.acks")
        with self._lock:
            entry = self._inflight.pop(push_id, None)
            if entry is not None:
                self._settle_locked(entry[0])
        if entry is not None:
            self._pump(conn)

    def on_nack(self, conn, push_id: int, reason: int) -> None:
        """The receiver refused a chunk: the partition goes pull-only on
        this connection (its ACKed prefix stays valid over there)."""
        metrics.add("push.nacks", reason=nack_reason_name(reason))
        with self._lock:
            entry = self._inflight.pop(push_id, None)
            if entry is not None:
                cs, task = entry
                self._settle_locked(cs)
                task.dead = True
                cs.pull_only.add((task.job_id, task.reduce_id,
                                  task.map_id))
        if entry is not None:
            self._pump(conn)

    def drop_conn(self, conn) -> None:
        """Connection closed: settle its whole window and forget its
        subscriptions."""
        with self._lock:
            cs = self._subs.pop(id(conn), None)
            if cs is None:
                return
            dead = [pid for pid, (owner, _t) in self._inflight.items()
                    if owner is cs]
            for pid in dead:
                del self._inflight[pid]
            if cs.on_air:
                metrics.gauge_add("push.on_air", -cs.on_air)
            cs.on_air = 0
            cs.tasks.clear()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            for cs in self._subs.values():
                if cs.on_air:
                    metrics.gauge_add("push.on_air", -cs.on_air)
                cs.on_air = 0
                cs.tasks.clear()
            self._subs.clear()
            self._inflight.clear()

    @staticmethod
    def _settle_locked(cs: _ConnSub) -> None:
        if cs.on_air > 0:
            cs.on_air -= 1
            metrics.gauge_add("push.on_air", -1)

    # -- the pump --

    def _pump(self, conn) -> None:
        """Issue engine chunk reads for ``conn`` until its window is full:
        plan under the lock, submit outside it."""
        issues = []
        with self._lock:
            if self._stopped or self.server._draining:
                return
            cs = self._subs.get(id(conn))
            if cs is None:
                return
            while cs.on_air < cs.window:
                task = self._next_task_locked(cs)
                if task is None:
                    break
                push_id = self._next_id
                self._next_id += 1
                task.inflight = True
                cs.on_air += 1
                metrics.gauge_add("push.on_air", 1)  # ACK/NACK/drop settle
                self._inflight[push_id] = (cs, task)
                issues.append((push_id, cs, task, task.offset))
        from uda_tpu_torch.mofserver.data_engine import ShuffleRequest
        for push_id, cs, task, offset in issues:
            req = ShuffleRequest(job_id=task.job_id, map_id=task.map_id,
                                 reduce_id=task.reduce_id, offset=offset,
                                 chunk_size=cs.chunk)
            try:
                fut = self.engine.submit(req)
            except Exception as e:  # noqa: BLE001 - sync rejection
                self._push_failed(push_id, e)
                continue
            fut.add_done_callback(
                lambda f, pid=push_id: self._chunk_done(pid, f))

    def _next_task_locked(self, cs: _ConnSub) -> Optional[_PushTask]:
        while cs.tasks and cs.tasks[0].dead:
            cs.tasks.popleft()
        for task in cs.tasks:
            if task.dead or task.inflight:
                continue
            key = (task.job_id, task.reduce_id, task.map_id)
            if key in cs.pull_only:
                task.dead = True
                continue
            return task
        return None

    def _chunk_done(self, push_id: int, fut) -> None:
        """Engine completion (pool thread): frame the chunk, run the
        ``net.push`` failpoint, hand the frame to the connection's
        outbound queue (the inline-write path DATA rides)."""
        try:
            res = fut.result()
        except Exception as e:  # noqa: BLE001 - missing MOF, stopped
            # engine, injected fault: this partition goes pull-only
            self._push_failed(push_id, e)
            return
        with self._lock:
            entry = self._inflight.get(push_id)
            if entry is None:  # the connection dropped while reading
                return
            cs, task = entry
            conn = cs.conn
        from uda_tpu_torch.net import wire
        frame = wire.encode_push(
            push_id, job_id=task.job_id, map_id=task.map_id,
            reduce_id=task.reduce_id, offset=res.offset,
            raw_length=res.raw_length, last=res.last, data=res.data)
        try:
            out = failpoint("net.push", data=frame,
                            key=getattr(conn, "peer", ""))
        except Exception as e:  # noqa: BLE001 - injected push failure
            self._push_failed(push_id, e)
            return
        torn = len(out) != len(frame)
        with self._lock:
            if self._inflight.get(push_id) is None:
                return
            task.inflight = False
            if torn or res.last:
                # the last chunk is sent (or the stream is about to
                # tear): the task is done; its window slot stays charged
                # until the ACK
                task.dead = True
            else:
                task.offset = res.offset + len(res.data)
        metrics.add("push.chunks")
        metrics.add("push.bytes", len(res.data))
        conn.push_frame(out, close_after=torn)
        if not torn:
            self._pump(conn)

    def _push_failed(self, push_id: int, err: Exception) -> None:
        metrics.add("push.errors")
        with self._lock:
            entry = self._inflight.pop(push_id, None)
            if entry is None:
                return
            cs, task = entry
            task.inflight = False
            task.dead = True
            cs.pull_only.add((task.job_id, task.reduce_id,
                              task.map_id))
            self._settle_locked(cs)
            conn = cs.conn
        log.debug(f"push: {task.job_id}/{task.map_id} -> pull-only "
                  f"({err})")
        self._pump(conn)
