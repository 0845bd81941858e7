"""Process-wide counters, gauges, histograms, phase timers and spans.

The port's copy of the part of ``uda_tpu/utils/metrics.py`` its modules
call: labelled counters (``add``), gauges adjusted by deltas
(``gauge_add``), histograms over the reference's fixed power-of-two
buckets with its bucket-interpolated percentile estimate (``observe``,
``percentile``), phase timers that accumulate ``<name>_time`` seconds
(``timer``) and spans. Histograms and spans are recorded only while stats
are on, as in the reference: ``UDA_TPU_STATS=1`` in the environment,
``uda.tpu.stats.enable`` or :meth:`Metrics.enable_stats`; ``reset()``
restores that default. The reference's span trees and exports are not
ported yet.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

__all__ = ["Metrics", "metrics", "stats_enabled_from_env"]

# Fixed histogram buckets: powers of two from 1/16 to 2^30, shared by every
# histogram (latencies in ms and sizes in bytes both fit).
_BUCKET_EDGES = tuple(float(2.0 ** e) for e in range(-4, 31))


def stats_enabled_from_env() -> bool:
    """UDA_TPU_STATS=1 (or true/yes/on) turns the optional layers on for
    the whole process."""
    return os.environ.get("UDA_TPU_STATS", "").strip().lower() in (
        "1", "true", "yes", "on")


class _Hist:
    """One fixed-bucket histogram series (caller holds the metrics
    lock)."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts = [0] * (len(_BUCKET_EDGES) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(_BUCKET_EDGES, value)] += 1
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)

    def percentile(self, p: float) -> float:
        """Bucket-interpolated percentile estimate (exact min/max at the
        tails; linear within the containing bucket)."""
        if self.count == 0:
            return 0.0
        target = self.count * p / 100.0
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = _BUCKET_EDGES[i - 1] if i > 0 else 0.0
                hi = (_BUCKET_EDGES[i] if i < len(_BUCKET_EDGES)
                      else self.vmax)
                frac = (target - seen) / c
                return min(max(lo + (hi - lo) * frac, self.vmin), self.vmax)
            seen += c
        return self.vmax


def _series_key(name: str, labels: dict) -> str:
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Metrics:
    """Counters and gauges (always live); histograms and spans (off until
    :meth:`enable_stats`, or on from the start with ``UDA_TPU_STATS``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = defaultdict(float)
        self.histograms: Dict[str, _Hist] = {}
        self.spans: list[dict] = []
        self._default_stats = stats_enabled_from_env()
        self._stats_enabled = self._default_stats

    def enable_stats(self) -> None:
        """Turn on histograms and spans. Idempotent."""
        self._stats_enabled = True

    def disable_stats(self) -> None:
        self._stats_enabled = False

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

    def gauge(self, name: str, value: float) -> None:
        """Set a gauge to ``value`` (a level, such as a queue's backlog)."""
        with self._lock:
            self.gauges[name] = value

    def get_gauge(self, name: str) -> float:
        with self._lock:
            return self.gauges.get(name, 0.0)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram sample in ``name`` (and, with labels, in
        the series ``name{k=v,...}`` too). A no-op while stats are
        off."""
        if not self._stats_enabled:
            return
        keys = [name]
        if labels:
            keys.append(_series_key(name, labels))
        with self._lock:
            for key in keys:
                h = self.histograms.get(key)
                if h is None:
                    h = self.histograms[key] = _Hist()
                h.observe(value)

    def histogram(self, name: str, **labels) -> Dict[str, float]:
        """``{"count", "sum", "max"}`` of one histogram series (count 0
        when it has no sample)."""
        key = _series_key(name, labels) if labels else name
        with self._lock:
            h = self.histograms.get(key)
            if h is None or h.count == 0:
                return {"count": 0, "sum": 0.0, "max": 0.0}
            return {"count": h.count, "sum": h.total, "max": h.vmax}

    def percentile(self, name: str, p: float,
                   **labels) -> "float | None":
        """A live percentile estimate of one histogram series, or None
        when the series has no samples (stats off, or nothing observed
        yet): callers degrade to their own floor
        (``retry.SpeculationPolicy.threshold_ms``)."""
        key = _series_key(name, labels) if labels else name
        with self._lock:
            h = self.histograms.get(key)
            if h is None or h.count == 0:
                return None
            return h.percentile(p)

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
        if not self._stats_enabled:
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
        """Clear every record and restore the construction-time stats
        default."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.spans.clear()
            self._stats_enabled = self._default_stats


metrics = Metrics()
