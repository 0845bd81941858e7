"""The staging pipeline's in-flight byte budget.

The port's copy of the part of ``uda_tpu/utils/budget.py`` the overlapped
merger needs: the auto-derived cap on bytes fed to the merger but not yet
merged or spooled. The reference's ``MemoryBudget`` (HBM and host
budgets, admission routing for ``mapred.netmerger.merge.approach=0``) is
not ported yet, so the cap is never clamped to a host budget here, as in
the reference when no budget has been built.
"""

from __future__ import annotations

__all__ = ["stage_inflight_cap", "STAGE_INFLIGHT_FLOOR_MB"]

MB = 1 << 20

# floor for the auto-derived staging-pipeline in-flight byte budget
STAGE_INFLIGHT_FLOOR_MB = 256


def stage_inflight_cap(cfg, window: int, chunk_size: int) -> int:
    """In-flight byte budget for the staging pipeline (bytes fed to the
    overlapped merger but not yet merged or spooled; the gauge is
    ``stage.inflight.bytes``).

    ``uda.tpu.stage.inflight.mb`` wins when set; the auto default is
    max(STAGE_INFLIGHT_FLOOR_MB, 2x the fetch window's wire bytes):
    enough that staging never throttles a healthy fetch window, small
    enough that a stalled device consumer cannot pile the whole shuffle
    into host memory."""
    mb = int(cfg.get("uda.tpu.stage.inflight.mb"))
    if mb > 0:
        return mb * MB
    return max(STAGE_INFLIGHT_FLOOR_MB * MB,
               2 * max(1, int(window)) * max(1, int(chunk_size)))
