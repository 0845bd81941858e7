"""Process-wide counters, phase timers and spans.

The port's copy of the part of ``uda_tpu/utils/metrics.py`` its modules
call: labelled counters (``add``), phase timers that accumulate
``<name>_time`` seconds (``timer``) and spans, which are recorded only
while stats are on (``uda.tpu.stats.enable``). The reference's gauges,
histograms, span trees and exports are not ported yet.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

__all__ = ["Metrics", "metrics"]


def _series_key(name: str, labels: dict) -> str:
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Metrics:
    """Counters (always live) and spans (off until :meth:`enable_stats`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.spans: list[dict] = []
        self._spans_enabled = False

    def enable_stats(self) -> None:
        self._spans_enabled = True

    def add(self, name: str, value: float = 1.0, **labels) -> None:
        """Accumulate a counter. With labels, both the total ``name`` and
        the series ``name{k=v,...}`` advance."""
        with self._lock:
            self.counters[name] += value
            if labels:
                self.counters[_series_key(name, labels)] += value

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Phase timer: accumulates ``<name>_time`` seconds."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.counters[name + "_time"] += dt

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        """A named span: its duration and attributes are recorded in
        :attr:`spans` while stats are on."""
        if not self._spans_enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = {"name": name, "ts": t0, "dur": time.perf_counter() - t0,
                   "attrs": attrs}
            with self._lock:
                self.spans.append(rec)

    def get(self, name: str, **labels) -> float:
        key = _series_key(name, labels) if labels else name
        with self._lock:
            return self.counters.get(key, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.spans.clear()
            self._spans_enabled = False


metrics = Metrics()
