"""Multi-tenant service plane: one long-lived shuffle daemon, many jobs.

The port's copy of ``uda_tpu/tenant/``: shuffle as a shared service
rather than a per-job plugin (the Exoshuffle thesis, arXiv:2203.05072):

- :class:`~uda_tpu_torch.tenant.registry.TenantRegistry`: the job/epoch
  registry with register/heartbeat/retire, epoch fencing and
  HMAC-authenticated wire registration (``MSG_JOB``);
- :class:`~uda_tpu_torch.tenant.sched.CreditScheduler`: weighted deficit
  round-robin over parked requests in place of the per-connection
  ``mapred.rdma.wqe.per.conn`` cap, with the tenant penalty box;
- per-tenant read-budget partitions in ``DataEngine`` admission and
  per-tenant ``MemoryBudget`` shares on the reduce side
  (``uda.tpu.tenant.budget.share``).

- :class:`~uda_tpu_torch.tenant.sli.SliBook`: the per-tenant SLI/SLO
  ledger over the time-series rollups (``utils/timeseries``).

``current_tenant()`` is the process-local tenant identity the reduce side
stamps onto its hot-path metric labels (set at bridge INIT from
``uda.tpu.tenant.id``). A client's ``MSG_JOB`` binding always comes from
its own ``Config``, never from this global.
"""

from __future__ import annotations

from uda_tpu_torch.tenant.registry import (DEFAULT_TENANT, TenantRecord,
                                           TenantRegistry, sign_job)
from uda_tpu_torch.tenant.sched import CreditScheduler

__all__ = ["TenantRegistry", "TenantRecord", "CreditScheduler",
           "DEFAULT_TENANT", "sign_job", "current_tenant",
           "set_current_tenant"]

_CURRENT_TENANT = ""


def set_current_tenant(tenant: str) -> None:
    """Install this process's tenant identity (empty = untenanted)."""
    global _CURRENT_TENANT
    _CURRENT_TENANT = str(tenant or "")


def current_tenant() -> str:
    return _CURRENT_TENANT
