"""Memory admission control: budgets, the device-bytes model, routing.

The port's copy of ``uda_tpu/utils/budget.py``. The reference validated
every buffer budget at INIT and failed into the vanilla path when the pool
could not fit (handle_init_msg, reference src/Merger/reducer.cc:56-133).
The engine's equivalent exposure is the device row matrix: each record
holds a row of key words + 3 on the device, and the merge holds both
operands and the output of a pair merge at once.

:class:`MemoryBudget` is the front door: the device and host budgets
(``uda.tpu.hbm.budget.mb`` / ``uda.tpu.host.budget.mb``), an estimator that
turns the transport's partition estimate into device bytes, and
:meth:`MemoryBudget.route`, the merge-approach decision of
``mapred.netmerger.merge.approach=0``: in-budget partitions keep hybrid or
streaming, partitions whose device estimate exceeds the device budget go
to streaming with no device runs, and partitions above the hard ceiling
(``uda.tpu.budget.hard.mb``) are rejected before anything is allocated.

The device budget read from the card: ``torch.cuda.mem_get_info``'s total
times :data:`HBM_RESERVE_FRACTION`; on the CPU the device rows live in
host memory, so it is the available host memory, as in the reference. The
reference's table of TPU memory sizes is not carried over. The INIT check
(``validate_init``) waits for its caller, the bridge.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.utils.errors import UdaError
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["MemoryBudget", "Admission", "device_bytes_estimate",
           "stage_inflight_cap", "ROW_OVERHEAD_WORDS", "WORKING_SET_FACTOR",
           "HBM_RESERVE_FRACTION", "STAGE_INFLIGHT_FLOOR_MB"]

log = get_logger()

MB = 1 << 20

# floor for the auto-derived staging-pipeline in-flight byte budget
STAGE_INFLIGHT_FLOOR_MB = 256


def stage_inflight_cap(cfg, window: int, chunk_size: int,
                       budget: Optional["MemoryBudget"] = None) -> int:
    """In-flight byte budget for the staging pipeline (bytes fed to the
    overlapped merger but not yet merged or spooled; the gauge is
    ``stage.inflight.bytes``).

    ``uda.tpu.stage.inflight.mb`` wins when set; the auto default is
    max(STAGE_INFLIGHT_FLOOR_MB, 2x the fetch window's wire bytes): enough
    that staging never throttles a healthy fetch window, small enough that
    a stalled device consumer cannot pile the whole shuffle into host
    memory. When a MemoryBudget has already been built (the auto
    merge-approach path), the cap also clamps to half its host budget; a
    budget is not built here, so explicitly chosen approaches never read
    the device's memory."""
    mb = int(cfg.get("uda.tpu.stage.inflight.mb"))
    if mb > 0:
        return mb * MB
    cap = max(STAGE_INFLIGHT_FLOOR_MB * MB,
              2 * max(1, int(window)) * max(1, int(chunk_size)))
    if budget is not None:
        cap = min(cap, max(MB, budget.host_budget_bytes // 2))
    return cap


# -- the device-bytes model ---------------------------------------------------
#
# Per record the merge holds one uint32 row of (key words, content length,
# segment index, row index) = key_width/4 + ROW_OVERHEAD_WORDS words. The
# model takes the larger of that row matrix and 1.08x the shuffle bytes
# (the sort ladder of the whole-partition re-sort), so it is conservative
# for both the forest merge and the re-sort.
ROW_OVERHEAD_WORDS = 3        # length, segment index, row index columns
SORT_LADDER_RATIO = 1.08      # device bytes / shuffle bytes, TeraSort shape
RECORD_BYTES_DEFAULT = 100    # TeraSort record (10 B key + 90 B value)

# Transient working set: a pairwise merge holds both operands plus the
# output at once, and binary-counter runs pad to a power of two: 2x the
# resident matrix bounds both.
WORKING_SET_FACTOR = 2.0

# Fraction of the device's memory the budget may claim by default (the
# rest is the allocator's slack, the kernels and other work on the card).
HBM_RESERVE_FRACTION = 0.9


def _host_available_mb() -> int:
    """Best-effort available host memory (MemAvailable, else MemTotal,
    else a conservative 4 GB)."""
    try:
        with open("/proc/meminfo") as f:
            text = f.read()
        for key in ("MemAvailable", "MemTotal"):
            m = re.search(rf"^{key}:\s+(\d+)\s*kB", text, re.M)
            if m:
                return int(m.group(1)) // 1024
    except OSError:
        pass
    return 4 * 1024


def _detect_hbm_mb(device: torch.device) -> int:
    """Memory of the merge's device in MB: the card's own total
    (``torch.cuda.mem_get_info``); for the CPU, where the device rows are
    host memory, the available host memory."""
    if device.type != "cuda":
        return _host_available_mb()
    return int(torch.cuda.mem_get_info(device)[1]) // MB


def device_bytes_estimate(partition_bytes: int, key_width: int,
                          record_bytes: int = RECORD_BYTES_DEFAULT) -> int:
    """Device-resident bytes the merge would hold for a partition of
    ``partition_bytes`` on-disk bytes: max(row matrix, sort ladder) x the
    transient working-set factor. Conservative by construction."""
    if partition_bytes <= 0:
        return 0
    row_bytes = 4 * (max(4, key_width) // 4 + ROW_OVERHEAD_WORDS)
    records = max(1, partition_bytes // max(1, record_bytes))
    row_matrix = records * row_bytes
    ladder = int(partition_bytes * SORT_LADDER_RATIO)
    return int(max(row_matrix, ladder) * WORKING_SET_FACTOR)


@dataclasses.dataclass(frozen=True)
class Admission:
    """One routing decision: which path the partition was admitted to and
    why."""

    decision: str                 # "in_memory" | "hybrid" | "streaming"
    #                             | "reject"
    reason: str                   # human-readable (logs only)
    estimate_bytes: Optional[int]   # transport estimate (None = unknown)
    device_bytes: Optional[int]     # modeled device working set
    hbm_budget_bytes: int
    host_budget_bytes: int
    # structured decision basis, what callers branch on: which budget
    # forced the decision ("hbm" | "host" | "hard" | "init", "ckpt" for
    # the checkpoint-steered streaming route, "" when none was binding)
    cause: str = ""
    rerouted: bool = False

    @property
    def rejected(self) -> bool:
        return self.decision == "reject"


class MemoryBudget:
    """Device and host budgets with lazy detection.

    Budgets resolve as: explicit config key > detected (the device's
    memory x HBM_RESERVE_FRACTION; available host memory x
    ``mapred.job.shuffle.input.buffer.percent``). Detection runs at most
    once per instance and only when a budget is read. ``device`` (``None``
    = the card) is the merge's device."""

    def __init__(self, hbm_budget_mb: int = 0, host_budget_mb: int = 0,
                 hard_ceiling_mb: int = 0, key_width: int = 16,
                 host_fraction: float = 0.7, enforce: str = "reroute",
                 tenant_share: float = 0.0, device=None):
        self._hbm_mb = int(hbm_budget_mb)
        self._host_mb = int(host_budget_mb)
        self.hard_ceiling_mb = int(hard_ceiling_mb)
        self.key_width = int(key_width)
        self.host_fraction = float(host_fraction)
        if enforce not in ("reroute", "reject"):
            raise UdaError(f"uda.tpu.budget.enforce must be 'reroute' or "
                           f"'reject', got {enforce!r}")
        self.enforce = enforce
        # the multi-tenant slice (uda.tpu.tenant.budget.share): every
        # budget read is scaled to it; 0/1 = the whole machine
        if tenant_share < 0.0 or tenant_share > 1.0:
            raise UdaError(f"uda.tpu.tenant.budget.share must be in "
                           f"[0, 1], got {tenant_share!r}")
        self.tenant_share = float(tenant_share) or 1.0
        self.device = resolve_device(device)

    @classmethod
    def from_config(cls, cfg, device=None) -> "MemoryBudget":
        return cls(
            hbm_budget_mb=cfg.get("uda.tpu.hbm.budget.mb"),
            host_budget_mb=cfg.get("uda.tpu.host.budget.mb"),
            hard_ceiling_mb=cfg.get("uda.tpu.budget.hard.mb"),
            key_width=cfg.get("uda.tpu.key.width"),
            host_fraction=cfg.get(
                "mapred.job.shuffle.input.buffer.percent"),
            enforce=cfg.get("uda.tpu.budget.enforce"),
            tenant_share=cfg.get("uda.tpu.tenant.budget.share"),
            device=device)

    def _share(self, nbytes: int) -> int:
        # never below 1 MB: a pathological share degrades to the
        # reroute/reject ladder, not to a zero budget
        return max(MB, int(nbytes * self.tenant_share))

    @property
    def hbm_budget_bytes(self) -> int:
        if self._hbm_mb <= 0:
            self._hbm_mb = max(
                1, int(_detect_hbm_mb(self.device) * HBM_RESERVE_FRACTION))
        return self._share(self._hbm_mb * MB)

    @property
    def host_budget_bytes(self) -> int:
        if self._host_mb <= 0:
            self._host_mb = max(
                1, int(_host_available_mb() * self.host_fraction))
        return self._share(self._host_mb * MB)

    @property
    def hard_ceiling_bytes(self) -> int:
        """Estimate above which even the degraded paths are refused (0 =
        no ceiling)."""
        return self.hard_ceiling_mb * MB

    def device_bytes(self, partition_bytes: int) -> int:
        return device_bytes_estimate(partition_bytes, self.key_width)

    def route(self, estimate_bytes: Optional[int], threshold_bytes: int,
              prefer_streaming: bool = False) -> Admission:
        """The budget-aware auto merge-approach decision.

        - unknown estimate -> streaming (bounded memory for unbounded
          input);
        - over the hard ceiling -> reject (the caller raises
          ``FallbackSignal`` before any allocation);
        - device estimate over the device budget, or the partition over
          the host budget -> streaming with bounded device runs;
        - at most ``threshold_bytes`` and in budget -> hybrid; in budget
          above it -> streaming.

        ``prefer_streaming`` (``uda.tpu.ckpt.dir`` set) steers the
        in-budget small case to streaming too (cause ``"ckpt"``): hybrid
        has no durable run spool to snapshot."""
        hbm = self.hbm_budget_bytes
        host = self.host_budget_bytes
        if estimate_bytes is None:
            adm = Admission("streaming", "unknown-estimate", None, None,
                            hbm, host)
            self._record(adm, "budget.admitted")
            return adm
        dev = self.device_bytes(estimate_bytes)
        hard = self.hard_ceiling_bytes
        if hard and estimate_bytes > hard:
            adm = Admission(
                "reject", f"over-hard-ceiling: estimate "
                f"{estimate_bytes} B > {hard} B", estimate_bytes, dev,
                hbm, host, cause="hard")
            self._record(adm, "budget.rejected")
            return adm
        if dev > hbm:
            adm = Admission(
                "streaming", f"over-hbm-budget: device working set "
                f"{dev} B > {hbm} B", estimate_bytes, dev, hbm, host,
                cause="hbm", rerouted=True)
            self._record(adm, "budget.rerouted")
            return adm
        # hybrid holds the fetched bytes in host memory through the LPQ
        # spill: gate it on the host budget
        if estimate_bytes > host:
            adm = Admission(
                "streaming", f"over-host-budget: partition "
                f"{estimate_bytes} B > {host} B", estimate_bytes, dev,
                hbm, host, cause="host", rerouted=True)
            self._record(adm, "budget.rerouted")
            return adm
        if estimate_bytes <= threshold_bytes and prefer_streaming:
            adm = Admission(
                "streaming", "in-budget-small-ckpt: checkpoint/resume "
                "needs the run-spool (streaming) path", estimate_bytes,
                dev, hbm, host, cause="ckpt")
        elif estimate_bytes <= threshold_bytes:
            adm = Admission("hybrid", "in-budget-small", estimate_bytes,
                            dev, hbm, host)
        else:
            adm = Admission("streaming", "in-budget-large",
                            estimate_bytes, dev, hbm, host)
        self._record(adm, "budget.admitted")
        return adm

    @staticmethod
    def _record(adm: Admission, counter: str) -> None:
        metrics.add(counter)
        line = (f"budget {adm.decision}: {adm.reason} "
                f"(estimate={adm.estimate_bytes}, "
                f"device={adm.device_bytes}, "
                f"hbm_budget={adm.hbm_budget_bytes}, "
                f"host_budget={adm.host_budget_bytes})")
        if counter == "budget.admitted":
            log.info(line)
        else:
            log.warn(line)
