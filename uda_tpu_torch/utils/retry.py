"""Retry policy for the fetch path: backoff, attempt timeout, deadline.

The port's copy of ``uda_tpu/utils/retry.py``. ``RetryPolicy`` is built
from the ``mapred.rdma.fetch.*`` config knobs and applied by
``uda_tpu_torch.merger.segment.Segment``:

- ``retries``: whole-segment re-fetch attempts after a transport error
  (``uda.tpu.fetch.retries``);
- ``backoff_ms``/``backoff_max_ms``/``jitter``: exponential backoff
  between attempts, doubling from the base and capped, with a symmetric
  +/-``jitter`` fraction (0 base = immediate retry);
- ``attempt_timeout_ms``: per-attempt chunk fetch timeout (0 = wait
  forever);
- ``deadline_ms``: overall per-segment budget across every retry and
  backoff (0 = none).

``SpeculationPolicy`` holds the straggler detector's knobs
(``uda.tpu.fetch.speculate.pn`` and ``.floor.ms``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from uda_tpu_torch.utils.metrics import metrics

__all__ = ["RetryPolicy", "SpeculationPolicy"]

LATENCY = "fetch.latency_ms"   # the histogram the straggler threshold reads


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    retries: int = 3
    backoff_ms: float = 0.0
    backoff_max_ms: float = 2000.0
    jitter: float = 0.2
    attempt_timeout_ms: float = 0.0
    deadline_ms: float = 0.0
    seed: Optional[int] = None

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Seconds to wait before retry ``attempt`` (1-based):
        ``backoff_ms * 2^(attempt-1)`` capped at ``backoff_max_ms``, then
        jittered by a uniform +/-``jitter`` fraction from ``rng``."""
        if self.backoff_ms <= 0:
            return 0.0
        base = min(self.backoff_ms * (2.0 ** max(0, attempt - 1)),
                   self.backoff_max_ms)
        if self.jitter and rng is not None:
            base *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, base) / 1000.0

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        return cls(
            retries=max(0, cfg.get("uda.tpu.fetch.retries")),
            backoff_ms=float(cfg.get("mapred.rdma.fetch.retry.backoff.ms")),
            backoff_max_ms=float(
                cfg.get("mapred.rdma.fetch.retry.backoff.max.ms")),
            jitter=float(cfg.get("mapred.rdma.fetch.retry.jitter")),
            attempt_timeout_ms=float(
                cfg.get("mapred.rdma.fetch.attempt.timeout.ms")),
            deadline_ms=float(cfg.get("mapred.rdma.fetch.deadline.ms")),
        )


@dataclasses.dataclass(frozen=True)
class SpeculationPolicy:
    """The straggler detector's knobs (speculative dual-source fetch,
    ``merger/segment``): an in-flight chunk fetch that outlives
    ``max(floor_ms, pN of the observed fetch.latency_ms histogram)`` gets
    a duplicate issued to an alternate source. ``pn == 0`` (the default)
    disables speculation. The histogram records while stats are off too
    once a speculating segment has asked for it (:meth:`keep_latencies`),
    so the floor alone is the threshold only until the process has
    observed a chunk."""

    pn: int = 0           # latency percentile (e.g. 95); 0 = off
    floor_ms: float = 50.0

    @property
    def enabled(self) -> bool:
        return self.pn > 0

    def keep_latencies(self) -> None:
        """Have the hub record the latency histogram the threshold reads,
        stats on or off (a no-op while speculation is off)."""
        if self.enabled:
            metrics.keep_histogram(LATENCY)

    def threshold_ms(self) -> float:
        q = metrics.percentile(LATENCY, float(self.pn))
        return max(self.floor_ms, q or 0.0)

    @classmethod
    def from_config(cls, cfg) -> "SpeculationPolicy":
        return cls(
            pn=max(0, min(100, int(cfg.get("uda.tpu.fetch.speculate.pn")))),
            floor_ms=max(0.0, float(
                cfg.get("uda.tpu.fetch.speculate.floor.ms"))),
        )
