"""Process-wide counters, gauges, histograms, phase timers and spans.

The port's copy of the part of ``uda_tpu/utils/metrics.py`` its modules
call: labelled counters (``add``), gauges adjusted by deltas
(``gauge_add``), histograms that keep a count, sum and maximum per name
(``observe``), phase timers that accumulate ``<name>_time`` seconds
(``timer``) and spans, which are recorded only while stats are on
(``uda.tpu.stats.enable``). Histograms are always live here (the
reference's wait for stats to be enabled); the reference's histogram
buckets and percentiles, span trees and exports are not ported yet.
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
    """Counters, gauges and histograms (always live) and spans (off until
    :meth:`enable_stats`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = defaultdict(float)
        self.histograms: Dict[str, Dict[str, float]] = {}
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

    def gauge_add(self, name: str, delta: float) -> None:
        """Adjust a gauge by ``delta`` (an increment that a later
        decrement must meet, such as bytes in flight)."""
        with self._lock:
            self.gauges[name] += delta

    def get_gauge(self, name: str) -> float:
        with self._lock:
            return self.gauges.get(name, 0.0)

    def observe(self, name: str, value: float) -> None:
        """Record one histogram sample: its count, sum and maximum."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = {"count": 0, "sum": 0.0,
                                             "max": value}
            h["count"] += 1
            h["sum"] += value
            h["max"] = max(h["max"], value)

    def histogram(self, name: str) -> Dict[str, float]:
        """``{"count", "sum", "max"}`` of one histogram (count 0 when it
        has no sample)."""
        with self._lock:
            return dict(self.histograms.get(name)
                        or {"count": 0, "sum": 0.0, "max": 0.0})

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

    def gauges_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.gauges)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.spans.clear()
            self._spans_enabled = False


metrics = Metrics()
