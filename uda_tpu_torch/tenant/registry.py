"""TenantRegistry: the job/epoch registry of the multi-tenant daemon.

The port's copy of ``uda_tpu/tenant/registry.py``. One long-lived
supplier process serves many jobs (the Exoshuffle service thesis): every
job announces itself with an authenticated ``MSG_JOB`` frame carrying
``(tenant, job, epoch)`` and every subsequent REQ on the data plane is
validated against this registry. The lifecycle:

- **register** — first registration creates the record; re-registering
  the SAME epoch is a heartbeat; a HIGHER epoch supersedes (fences) the
  old one — a restarted job attempt registers epoch+1 and the
  predecessor's connections start drawing typed :class:`TenantError`
  on their next REQ, so a zombie reducer can never read bytes meant
  for its successor; a LOWER epoch is refused outright (stale).
- **heartbeat** — refreshes the idle clock (``uda.tpu.tenant.ttl.s``;
  0 = jobs never expire). Any validated REQ counts as one.
- **retire** — the job is done: later REQs draw typed errors, the
  retire callbacks fire (the DataEngine drains the tenant's
  ResourceLedger books there, attributing any leaked admission bytes
  to the job that leaked them), and the record is kept as a tombstone
  until the TTL sweep collects it.

Authentication: when ``uda.tpu.tenant.secret`` is set, MSG_JOB must
carry ``sign_job(secret, tenant, job, epoch)`` — an HMAC-SHA256 over
the identity triple, compared constant-time. An empty secret disables
the check (the trusted-fabric default, matching the reference's
unauthenticated rdma_cm plane).

Thread-safety: every method is safe from any thread (one registry
serves the event loop, the engine's pool workers and the MSG_STATS
dispatcher); the lock is a leaf.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import time
from typing import Callable, Dict, List, Optional, Tuple

from uda_tpu_torch.utils.errors import TenantError
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.locks import TrackedLock
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["DEFAULT_TENANT", "TenantRecord", "TenantRegistry", "sign_job"]

log = get_logger()

# The implicit tenant of connections that never sent MSG_JOB (old
# clients; the HELLO capability bit is advertisement, not demand) and
# of every request when tenancy is off. Weight 1, full budget — the
# single-job behavior, bit for bit.
DEFAULT_TENANT = "default"


def sign_job(secret: str, tenant_id: str, job_id: str, epoch: int) -> str:
    """The MSG_JOB authentication token: HMAC-SHA256 over the identity
    triple. Empty secret -> empty token (auth off)."""
    if not secret:
        return ""
    msg = f"{tenant_id}|{job_id}|{epoch}".encode("utf-8")
    return hmac.new(secret.encode("utf-8"), msg,
                    hashlib.sha256).hexdigest()


@dataclasses.dataclass
class TenantRecord:
    """One (tenant, job)'s registry entry."""

    tenant_id: str
    job_id: str
    epoch: int
    weight: int = 1
    state: str = "active"        # "active" | "retired"
    registered_mono: float = 0.0
    last_seen_mono: float = 0.0

    @property
    def active(self) -> bool:
        return self.state == "active"


class TenantRegistry:
    """The registry. ``secret``/``ttl_s``/``max_jobs`` may come from a
    Config (``from_config``) or be passed directly (tests, embedders)."""

    def __init__(self, secret: str = "", ttl_s: float = 0.0,
                 max_jobs: int = 4096):
        self.secret = str(secret or "")
        self.ttl_s = float(ttl_s)
        self.max_jobs = int(max_jobs)
        self._lock = TrackedLock("tenant.registry")
        self._jobs: Dict[Tuple[str, str], TenantRecord] = {}
        # tenant -> weight, maintained INCREMENTALLY (set on register,
        # recomputed-or-dropped for the affected tenant on retire and
        # TTL expiry): the scheduler's weight_of view AND the admission
        # gate's share table — share_bytes runs per served chunk, so it
        # must be O(active tenants), never a walk of the job table
        self._weights: Dict[str, int] = {}
        self._retire_cbs: List[Callable[[str, str], None]] = []

    @classmethod
    def from_config(cls, cfg) -> "TenantRegistry":
        return cls(secret=str(cfg.get("uda.tpu.tenant.secret")),
                   ttl_s=float(cfg.get("uda.tpu.tenant.ttl.s")))

    # -- lifecycle -----------------------------------------------------------

    def _check_token(self, tenant_id: str, job_id: str, epoch: int,
                     token: str) -> None:
        if not self.secret:
            return
        want = sign_job(self.secret, tenant_id, job_id, epoch)
        if not hmac.compare_digest(want, token or ""):
            metrics.add("tenant.rejected", cause="auth")
            raise TenantError(
                f"MSG_JOB authentication failed for tenant "
                f"{tenant_id!r} job {job_id!r}")

    def register(self, tenant_id: str, job_id: str, epoch: int,
                 weight: int = 1, token: str = "") -> TenantRecord:
        """Register (or heartbeat, or fence) one (tenant, job, epoch).
        Raises :class:`TenantError` on auth failure or a stale epoch."""
        tenant_id = str(tenant_id or DEFAULT_TENANT)
        epoch = int(epoch)
        if epoch < 1:
            raise TenantError(f"job epoch must be >= 1, got {epoch}")
        self._check_token(tenant_id, job_id, epoch, token)
        failpoint("tenant.register", key=tenant_id)
        now = time.monotonic()
        with self._lock:
            self._expire_locked(now)
            key = (tenant_id, job_id)
            rec = self._jobs.get(key)
            if rec is not None:
                if epoch < rec.epoch:
                    metrics.add("tenant.rejected", cause="stale_epoch")
                    raise TenantError(
                        f"stale epoch {epoch} for {tenant_id}/{job_id} "
                        f"(current {rec.epoch}); a predecessor attempt "
                        f"cannot re-register under its successor")
                if epoch == rec.epoch:
                    if not rec.active:
                        metrics.add("tenant.rejected", cause="retired")
                        raise TenantError(
                            f"{tenant_id}/{job_id} epoch {epoch} is "
                            f"retired; a finished job cannot resume — "
                            f"restart with a higher epoch")
                    rec.last_seen_mono = now
                    rec.weight = max(1, int(weight))
                    self._weights[tenant_id] = rec.weight
                    metrics.add("tenant.heartbeats")
                    return rec
                # epoch > rec.epoch: fence the predecessor
                metrics.add("tenant.epoch.fenced")
                log.warn(f"tenant {tenant_id}/{job_id}: epoch "
                         f"{rec.epoch} fenced by {epoch}")
            elif len(self._jobs) >= self.max_jobs:
                metrics.add("tenant.rejected", cause="capacity")
                raise TenantError(
                    f"tenant registry full ({self.max_jobs} jobs); "
                    f"retire finished jobs or raise the cap")
            rec = TenantRecord(tenant_id, job_id, epoch,
                               weight=max(1, int(weight)),
                               registered_mono=now, last_seen_mono=now)
            self._jobs[key] = rec
            self._weights[tenant_id] = rec.weight
            active = sum(1 for r in self._jobs.values() if r.active)
        metrics.add("tenant.registered", tenant=tenant_id)
        metrics.gauge("tenant.jobs.active", active)
        log.info(f"tenant {tenant_id}: job {job_id} registered at "
                 f"epoch {epoch} (weight {rec.weight})")
        return rec

    def heartbeat(self, tenant_id: str, job_id: str) -> None:
        with self._lock:
            rec = self._jobs.get((str(tenant_id or DEFAULT_TENANT),
                                  job_id))
            if rec is not None and rec.active:
                rec.last_seen_mono = time.monotonic()
        metrics.add("tenant.heartbeats")

    def _reweigh_locked(self, tenant_id: str) -> None:
        """Recompute one tenant's weight from its remaining ACTIVE
        jobs (max wins — deterministic across dict order); a tenant
        with none leaves the active-weight table entirely, so it stops
        diluting the neighbors' budget shares."""
        ws = [r.weight for (tid, _), r in self._jobs.items()
              if tid == tenant_id and r.active]
        if ws:
            self._weights[tenant_id] = max(ws)
        else:
            self._weights.pop(tenant_id, None)

    def retire(self, tenant_id: str, job_id: str, epoch: int,
               token: str = "") -> None:
        """Retire one job (idempotent; a stale-epoch retire is ignored —
        the successor attempt owns the record now). Fires the retire
        callbacks OUTSIDE the lock."""
        tenant_id = str(tenant_id or DEFAULT_TENANT)
        self._check_token(tenant_id, job_id, int(epoch), token)
        fired = False
        with self._lock:
            rec = self._jobs.get((tenant_id, job_id))
            if rec is not None and rec.active and int(epoch) >= rec.epoch:
                rec.state = "retired"
                rec.last_seen_mono = time.monotonic()
                self._reweigh_locked(tenant_id)
                fired = True
            active = sum(1 for r in self._jobs.values() if r.active)
        if fired:
            metrics.add("tenant.retired", tenant=tenant_id)
            metrics.gauge("tenant.jobs.active", active)
            log.info(f"tenant {tenant_id}: job {job_id} retired")
            for cb in list(self._retire_cbs):
                try:
                    cb(tenant_id, job_id)
                except Exception as e:  # noqa: BLE001 - one consumer's
                    # retire hook must not block another's (or the
                    # data plane); counted, never silent
                    metrics.add("errors.swallowed")
                    log.warn(f"tenant retire callback failed: {e}")

    def on_retire(self, cb: Callable[[str, str], None]) -> None:
        """Register a retire hook (the DataEngine drains the tenant's
        obligation books there)."""
        self._retire_cbs.append(cb)

    # -- the per-REQ gate ----------------------------------------------------

    def validate(self, tenant_id: str, job_id: str,
                 epoch: Optional[int] = None) -> TenantRecord:
        """THE data-plane gate: every REQ on a tenant-bound connection
        flows through here. Raises typed :class:`TenantError` for an
        unknown job, a retired job, or a stale epoch (the connection
        bound before a successor fenced it). A validated REQ is a
        heartbeat."""
        tenant_id = str(tenant_id or DEFAULT_TENANT)
        failpoint("tenant.validate", key=tenant_id)
        now = time.monotonic()
        with self._lock:
            self._expire_locked(now)
            rec = self._jobs.get((tenant_id, job_id))
            if rec is None:
                metrics.add("tenant.rejected", cause="unknown")
                raise TenantError(
                    f"unknown job {tenant_id}/{job_id}: not registered "
                    f"(or expired past uda.tpu.tenant.ttl.s)")
            if not rec.active:
                metrics.add("tenant.rejected", cause="retired")
                raise TenantError(
                    f"job {tenant_id}/{job_id} is retired")
            if epoch is not None and int(epoch) != rec.epoch:
                metrics.add("tenant.rejected", cause="stale_epoch")
                raise TenantError(
                    f"stale epoch {epoch} for {tenant_id}/{job_id} "
                    f"(current {rec.epoch}): a restarted job's "
                    f"predecessor cannot read its chunks")
            rec.last_seen_mono = now
            return rec

    def _expire_locked(self, now: float) -> None:
        """TTL sweep (lock held): idle jobs expire, retired tombstones
        are collected one TTL after retirement. 0 = never."""
        if self.ttl_s <= 0:
            return
        dead = [k for k, r in self._jobs.items()
                if now - r.last_seen_mono > self.ttl_s]
        for k in dead:
            rec = self._jobs.pop(k)
            if rec.active:
                log.warn(f"tenant {rec.tenant_id}: job {rec.job_id} "
                         f"expired after {self.ttl_s:g}s idle")
                metrics.add("tenant.expired")
        # recompute only the AFFECTED tenants (a multi-job tenant must
        # keep its surviving jobs' weight, not an arbitrary one's)
        for tenant_id in {k[0] for k in dead}:
            self._reweigh_locked(tenant_id)

    # -- consumers (scheduler, engine, introspection) ------------------------

    def weight_of(self, tenant_id: str) -> int:
        with self._lock:
            return self._weights.get(tenant_id, 1)

    def share_bytes(self, tenant_id: str, total_bytes: int) -> int:
        """This tenant's slice of a shared byte budget: weight over the
        sum of ACTIVE tenants' weights. A lone (or unknown) tenant gets
        the whole budget — partitions only bind under contention, so
        the single-job deployment keeps its exact admission. Runs
        per served chunk inside the engine's admission gate, so it
        reads the incrementally-maintained active-weight table —
        O(active tenants), never a walk of the (up to max_jobs) job
        table."""
        with self._lock:
            weights = self._weights
            if len(weights) <= 1 or tenant_id not in weights:
                return int(total_bytes)
            mine = weights[tenant_id]
            return max(1, int(total_bytes) * mine // sum(weights.values()))

    def active_tenants(self) -> List[str]:
        with self._lock:
            return sorted({tid for (tid, _), r in self._jobs.items()
                           if r.active})

    def snapshot(self) -> dict:
        """The MSG_STATS introspection block."""
        now = time.monotonic()
        with self._lock:
            jobs = [{"tenant": r.tenant_id, "job": r.job_id,
                     "epoch": r.epoch, "weight": r.weight,
                     "state": r.state,
                     "idle_s": round(now - r.last_seen_mono, 3)}
                    for r in self._jobs.values()]
        jobs.sort(key=lambda j: (j["tenant"], j["job"]))
        return {"jobs": jobs, "ttl_s": self.ttl_s,
                "auth": bool(self.secret)}
