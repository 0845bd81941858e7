"""Retry policy for the fetch path: backoff, attempt timeout, deadline.

The port's copy of ``RetryPolicy`` from ``uda_tpu/utils/retry.py`` (the
speculation policy is not ported). Built from the ``mapred.rdma.fetch.*``
config knobs and applied by ``uda_tpu_torch.merger.segment.Segment``:

- ``retries``: whole-segment re-fetch attempts after a transport error
  (``uda.tpu.fetch.retries``);
- ``backoff_ms``/``backoff_max_ms``/``jitter``: exponential backoff
  between attempts, doubling from the base and capped, with a symmetric
  +/-``jitter`` fraction (0 base = immediate retry);
- ``attempt_timeout_ms``: per-attempt chunk fetch timeout (0 = wait
  forever);
- ``deadline_ms``: overall per-segment budget across every retry and
  backoff (0 = none).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

__all__ = ["RetryPolicy"]


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
