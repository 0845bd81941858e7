"""CreditScheduler: weighted-fair credit flow across tenants.

The port's copy of ``uda_tpu/tenant/sched.py``. The single
``mapred.rdma.wqe.per.conn`` cap bounds the pipeline per CONNECTION;
with many jobs on one daemon that is no bound at all: one
tenant opening N connections (or bursting on one) takes N x credit of
the shared engine while a neighbor drains at a trickle. This scheduler
is the shared bound: a pool of ``uda.tpu.tenant.wqe.total`` credits
over ALL connections, granted by weighted deficit round-robin (DRR,
Shreedhar & Varghese) over the per-tenant parked queues:

- a request that cannot take a credit parks in ITS tenant's FIFO (the
  server pauses that connection's read interest — TCP backpressure is
  still the credit return, now per tenant);
- every settled response releases one credit and runs the grant sweep:
  each non-empty tenant queue is visited in ring order, its deficit
  grows by ``quantum x weight``, and it unparks requests while the
  deficit covers their COST — so over any busy interval tenant grants
  converge to the weight ratio regardless of arrival order or
  connection count;
- a BACKLOGGED queue accumulates deficit uncapped (classic DRR: over
  any busy interval deficit tracks earned-minus-served, which is what
  keeps grants weight-proportional even when head costs dwarf one
  turn's earning); banked POSITIVE credit is forfeited when the queue
  empties (the anti-burst rule; negative deficit — byte DEBT from a
  force-served oversized head — survives the reset, or serial big
  requests would never repay) — the fairness invariants
  ``tests/test_tenant.py`` pins.

**Byte-cost quanta**: cost is the unit the
deficit is earned and charged in. The server passes each request's
REQUESTED BYTES (``ShuffleRequest.chunk_size``) as its cost and sets
``quantum`` from ``uda.tpu.tenant.quantum.kb``, so mixed chunk sizes
stay byte-fair: a tenant fetching 1 MB chunks draws weight-
proportional BYTES, not weight-proportional request counts. Callers
that pass no cost get the request-count behavior unchanged (cost 1,
quantum 1). Classic DRR assumes quantum >= the largest packet; a head
request dearer than one turn's earning instead ACCUMULATES deficit
across sweeps (uncapped while backlogged — see above), and a sweep
that would otherwise return empty-handed with free credits and
eligible backlog force-serves the most-indebted head (largest
earned-minus-served, i.e. the weighted-fair pick; its deficit goes
negative — the byte debt is repaid before its next grant), so an
oversized request can delay but never deadlock the pool.

The **tenant penalty box** (the PenaltyBox idea, tenant-scoped): an
abusive tenant — repeated admission rejections, injected faults on its
requests — is *deprioritized*: while boxed, its queue is only visited
when no unboxed tenant has backlog. Never starved: with no competing
backlog a boxed tenant is served normally, so the box degrades exactly
one tenant and only under contention (the isolation contract).

Threading: loop-thread-confined BY DESIGN (the event-loop server owns
every parked request); no locks. ``penalize`` may be called from
completion threads via ``EventLoop.call_soon``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from uda_tpu_torch.utils.locks import race_instrument
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["CreditScheduler"]

log = get_logger()


class _TenantQ:
    __slots__ = ("queue", "deficit", "faults", "boxed_until",
                 "vfinish")

    def __init__(self) -> None:
        self.queue: deque = deque()   # ((conn, entry), cost) waiting
        self.deficit = 0.0
        self.faults = 0
        self.boxed_until = 0.0
        self.vfinish = 0.0            # SFQ virtual finish of the last
        # grant (cost/weight units) — the force-serve pick's clock


@race_instrument("_tenants")
class CreditScheduler:
    """``total`` credits shared across tenants; ``weight_of(tenant)``
    supplies the live weights (the registry's view, consulted at each
    sweep so a re-registration's new weight applies immediately)."""

    def __init__(self, total: int,
                 weight_of: Optional[Callable[[str], int]] = None,
                 quantum: float = 1.0,
                 penalty_threshold: int = 4, penalty_ms: int = 1000):
        self.total = max(1, int(total))
        self._free = self.total
        self._weight_of = weight_of or (lambda t: 1)
        self.quantum = float(quantum)
        self.penalty_threshold = max(1, int(penalty_threshold))
        self.penalty_s = max(0, int(penalty_ms)) / 1e3
        self._tenants: Dict[str, _TenantQ] = {}
        self._ring: List[str] = []    # visit order (insertion)
        self._ring_pos = 0
        # a turn interrupted by credit exhaustion RESUMES at the same
        # tenant with its leftover deficit (and without re-earning):
        # without this, single-credit settles would degrade weighted
        # DRR to plain round-robin — every sweep would start a fresh
        # turn at the next ring position
        self._turn_earned = False
        self._inflight: Dict[str, int] = {}
        self._vtime = 0.0             # SFQ system virtual time
        self.grants = 0               # lifetime grants (tests/invariants)
        self.granted_cost: Dict[str, int] = {}  # lifetime granted cost
        # per tenant (bytes under byte quanta) — the byte-fairness
        # record the WDRR invariant tests read

    # -- queries -------------------------------------------------------------

    @property
    def free(self) -> int:
        return self._free

    def backlog(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            tq = self._tenants.get(tenant)
            return len(tq.queue) if tq else 0
        return sum(len(tq.queue) for tq in self._tenants.values())

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def _tq(self, tenant: str) -> _TenantQ:
        tq = self._tenants.get(tenant)
        if tq is None:
            tq = self._tenants[tenant] = _TenantQ()
            self._ring.append(tenant)
        return tq

    def _boxed(self, tq: _TenantQ, now: float) -> bool:
        return tq.boxed_until > now

    # -- credit flow ---------------------------------------------------------

    def admit(self, tenant: str, item: Tuple, cost: int = 1) -> bool:
        """Take a credit NOW (True) or park ``item`` in the tenant's
        queue (False). ``cost`` is the deficit charge of serving this
        item (requested bytes under byte quanta; 1 = request-count
        mode). A tenant with backlog — or in the penalty box while
        others compete — always parks behind its queue, so a burst
        cannot overtake its own earlier requests or jump a neighbor's
        earned deficit."""
        tq = self._tq(tenant)
        now = time.monotonic()
        if (self._free > 0 and not tq.queue
                and not (self._boxed(tq, now) and self._other_backlog(
                    tenant, now))):
            if tq.deficit < 0:
                # a debtor's uncontended inline draw stays granted
                # (work conservation: an idle credit serves nobody by
                # waiting, and denying here could strand the park with
                # no settle to sweep it) but DEEPENS the recorded
                # debt — repayment binds at the next contention, when
                # DRR earning must cover it before in-loop serves and
                # the SFQ clock orders the force-serves
                tq.deficit -= max(1, int(cost))
            self._grant(tenant, cost)
            return True
        tq.queue.append((item, max(1, int(cost)), now))
        metrics.add("tenant.sched.parked")
        return False

    def _other_backlog(self, tenant: str, now: float) -> bool:
        for t, tq in self._tenants.items():
            if t != tenant and tq.queue and not self._boxed(tq, now):
                return True
        return False

    def _grant(self, tenant: str, cost: int = 1) -> None:
        self._free -= 1
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        self.grants += 1
        self.granted_cost[tenant] = (self.granted_cost.get(tenant, 0)
                                     + max(1, int(cost)))
        # SFQ virtual clock (start-time fair queuing): every grant
        # stamps its tenant's virtual finish = max(own finish, system
        # time) + cost/weight, and advances system time to the grant's
        # virtual START. The force-serve pick orders by this clock —
        # the scheme that stays weight-PROPORTIONAL when the pool's
        # service rate (one settle, one grant), not deficit earnings,
        # is the binding constraint (max-debt picking there converges
        # to equal-drift round robin instead). max(own, system) is the
        # fresh-start rule: an idle tenant rejoins at the current clock,
        # it cannot bank virtual time.
        weight = max(1, int(self._weight_of(tenant)))
        tq = self._tq(tenant)
        vstart = max(tq.vfinish, self._vtime)
        self._vtime = vstart
        tq.vfinish = vstart + max(1, int(cost)) / weight
        metrics.add("tenant.sched.grants", tenant=tenant)

    def release(self, tenant: str) -> None:
        """One response settled: its credit returns to the pool. The
        caller follows with :meth:`grant_parked`."""
        self._free = min(self.total, self._free + 1)
        left = self._inflight.get(tenant, 0) - 1
        if left > 0:
            self._inflight[tenant] = left
        else:
            self._inflight.pop(tenant, None)

    def grant_parked(self) -> List[Tuple]:
        """The DRR sweep: unpark up to ``free`` items across tenants by
        weighted deficit round-robin. Returns the granted (conn, entry)
        items — each HOLDS one credit; the caller starts them (and
        releases via :meth:`release` when they settle or drop)."""
        granted: List[Tuple] = []
        ring = self._ring
        n = len(ring)
        if n == 0 or self._free <= 0:
            return granted
        now = time.monotonic()
        # visit budget: a full ring pass with eligible backlog either
        # serves an item or grows some queue's deficit toward its head
        # cost (bounded passes per head under byte quanta); the
        # force-serve fallback below guarantees progress even when the
        # budget runs out with credits free
        visits = n * (self.total + 2)
        while self._free > 0 and visits > 0:
            unboxed_backlog = any(
                tq.queue and not self._boxed(tq, now)
                for tq in self._tenants.values())
            if not unboxed_backlog and not any(
                    tq.queue for tq in self._tenants.values()):
                break
            tenant = ring[self._ring_pos % n]
            tq = self._tenants[tenant]
            if not tq.queue or (self._boxed(tq, now)
                                and unboxed_backlog):
                if not tq.queue:
                    # DRR: an empty queue forfeits banked credit
                    # (anti-burst) — but KEEPS its debt: a force-served
                    # oversized head's negative deficit must survive
                    # the queue emptying, or a tenant issuing big
                    # requests one at a time never repays
                    tq.deficit = min(tq.deficit, 0.0)
                self._advance()
                visits -= 1
                continue
            if not self._turn_earned:
                weight = max(1, int(self._weight_of(tenant)))
                earn = self.quantum * weight
                # a BACKLOGGED queue accumulates uncapped (classic
                # DRR: the anti-burst forfeit applies when the queue
                # EMPTIES, not while it waits). Capping accumulation
                # at the head cost saturated EVERY backlogged tenant
                # at the same ceiling under oversized heads — the
                # weight signal vanished and grants degenerated to
                # round-robin. Uncapped, deficit tracks earned-minus-served,
                # so both the in-loop serve and the force-serve
                # max-debt pick converge to weight-proportional BYTES
                tq.deficit += earn
                self._turn_earned = True
            while tq.queue and tq.deficit >= tq.queue[0][1] \
                    and self._free > 0:
                item, cost, t_enq = tq.queue.popleft()
                tq.deficit -= cost
                self._grant(tenant, cost)
                metrics.observe("tenant.queue.wait_ms",
                                (now - t_enq) * 1000.0, tenant=tenant)
                granted.append(item)
            if tq.queue and tq.deficit >= tq.queue[0][1]:
                break  # credits ran out mid-turn: the NEXT sweep
                # resumes this tenant's turn with its leftover deficit
            if not tq.queue:
                tq.deficit = min(tq.deficit, 0.0)  # forfeit credit,
                # keep debt (see above)
            self._advance()
            visits -= 1
        if not granted and self._free > 0:
            # progress guarantee under byte quanta: free credits +
            # eligible backlog must never idle behind a head whose
            # cost outruns the visit budget — serve the most-indebted
            # eligible head; the negative deficit is the byte debt its
            # tenant repays before its next grant
            self._force_serve(granted, now)
        metrics.gauge("tenant.sched.backlog", self.backlog())
        return granted

    def _force_serve(self, granted: List[Tuple], now: float) -> None:
        unboxed = [(t, tq) for t, tq in self._tenants.items()
                   if tq.queue and not self._boxed(tq, now)]
        pool = unboxed or [(t, tq) for t, tq in self._tenants.items()
                           if tq.queue]
        if not pool:
            return
        # SFQ pick: the earliest virtual START (see _grant) — weight-
        # proportional service under oversized heads, where the
        # deficit clock cannot bite within one sweep's visit budget
        tenant, tq = min(
            pool, key=lambda x: max(x[1].vfinish, self._vtime))
        item, cost, t_enq = tq.queue.popleft()
        tq.deficit -= cost
        self._grant(tenant, cost)
        metrics.observe("tenant.queue.wait_ms",
                        (now - t_enq) * 1000.0, tenant=tenant)
        granted.append(item)

    def _advance(self) -> None:
        self._ring_pos = (self._ring_pos + 1) % max(1, len(self._ring))
        self._turn_earned = False

    def drop_conn(self, conn) -> int:
        """A connection died: its parked (unstarted, creditless) items
        leave the queues. Returns how many were dropped."""
        dropped = 0
        for tq in self._tenants.values():
            keep = deque(entry for entry in tq.queue
                         if entry[0][0] is not conn)
            dropped += len(tq.queue) - len(keep)
            tq.queue = keep
        return dropped

    # -- the tenant penalty box ----------------------------------------------

    def note_fault(self, tenant: str) -> None:
        """One abusive event (admission rejection, injected fault on
        this tenant's request): past the threshold the tenant enters
        the box for ``penalty_ms`` (extended while faults continue;
        a clean grant sweep is the implicit forgiveness — the box
        simply expires)."""
        tq = self._tq(tenant)
        tq.faults += 1
        if tq.faults >= self.penalty_threshold:
            now = time.monotonic()
            first = tq.boxed_until <= now
            tq.boxed_until = now + self.penalty_s
            tq.faults = 0
            if first:
                metrics.add("tenant.penalties", tenant=tenant)
                log.warn(f"tenant {tenant!r} penalty-boxed for "
                         f"{self.penalty_s:g}s (repeated faults); its "
                         f"parked requests yield to other tenants")

    def boxed(self, tenant: str) -> bool:
        tq = self._tenants.get(tenant)
        return bool(tq and self._boxed(tq, time.monotonic()))

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        now = time.monotonic()
        return {
            "total": self.total, "free": self._free,
            "grants": self.grants,
            "tenants": {
                t: {"parked": len(tq.queue),
                    "parked_cost": sum(e[1] for e in tq.queue),
                    "granted_cost": self.granted_cost.get(t, 0),
                    "inflight": self._inflight.get(t, 0),
                    "deficit": round(tq.deficit, 3),
                    "weight": max(1, int(self._weight_of(t))),
                    "boxed": self._boxed(tq, now)}
                for t, tq in sorted(self._tenants.items())},
        }
