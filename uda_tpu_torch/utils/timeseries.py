"""In-process time-series rollups over the metrics hub.

The port's copy of ``uda_tpu/utils/timeseries.py``. One timer
(``uda.tpu.ts.interval.s``) snapshots the global
:class:`~uda_tpu_torch.utils.metrics.Metrics` hub each interval and
folds the deltas (counter increments, gauge levels, per-interval
histogram percentiles recomputed from bucket deltas) into a bounded ring
of ``uda.tpu.ts.window`` rollups. The ring answers by window
(:meth:`TimeSeries.window`) and by series (:meth:`counter_rate_series`,
:meth:`gauge_series`, :meth:`percentile_series`); listeners
(:meth:`add_listener`: the anomaly detectors and the SLI book) ride the
same timer thread. :func:`arm_observability_plane` wires ring,
detectors, SLI book and the optional OpenMetrics endpoint from one
config read; the bridge and the shuffle server both call it,
idempotently.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import (Metrics, metrics as global_metrics,
                                   percentile_from_summary)

__all__ = ["TimeSeries", "timeseries", "arm_observability_plane",
           "disarm_observability_plane"]

log = get_logger()

# ring defaults (the knob defaults in config.py mirror these)
DEFAULT_INTERVAL_S = 1.0
DEFAULT_WINDOW = 120


def _interval_hist(cur: Dict, prev: Optional[Dict]) -> Dict:
    """The per-interval histogram summary: cumulative bucket counts
    differenced against the previous snapshot (first sight of a series
    = the whole cumulative state). Returns ``{"count": 0}`` for an
    idle interval."""
    count = cur.get("count", 0) - (prev.get("count", 0) if prev else 0)
    if count <= 0:
        return {"count": 0}
    prev_buckets = {le: c for le, c in (prev.get("buckets") or [])} \
        if prev else {}
    buckets = []
    for le, c in cur.get("buckets") or []:
        d = c - prev_buckets.get(le, 0)
        if d > 0:
            buckets.append([le, d])
    return {"count": count,
            "sum": cur.get("sum", 0.0) - (prev.get("sum", 0.0)
                                          if prev else 0.0),
            # min/max are cumulative (the hub does not track them per
            # interval); they only clamp the interpolation
            "min": cur.get("min", 0.0), "max": cur.get("max", 0.0),
            "buckets": buckets}


class TimeSeries:
    """Bounded ring of per-interval metric rollups.

    One rollup per ``interval_s``::

        {"seq": n, "ts": <unix s>, "dt": <interval s>,
         "counters": {name: delta, ...},        # nonzero deltas only
         "gauges": {name: level, ...},
         "percentiles": {series: {"count","p50","p95","p99"}, ...}}

    ``clock`` is injectable (tests drive :meth:`sample` directly with a
    fake clock); the background thread is optional — :meth:`sample` is
    the single-step core either way."""

    def __init__(self, metrics_obj: Optional[Metrics] = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 window: int = DEFAULT_WINDOW,
                 clock: Callable[[], float] = time.monotonic):
        self.metrics = metrics_obj or global_metrics
        self.interval_s = max(0.05, float(interval_s))
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(2, int(window)))
        self._listeners: List[Callable[[Dict], None]] = []
        self._last_counters: Optional[Dict[str, float]] = None
        self._last_hists: Dict[str, Dict] = {}
        self._last_t = 0.0
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- configuration / lifecycle -------------------------------------------

    @property
    def window_len(self) -> int:
        return self._ring.maxlen or 0

    @property
    def running(self) -> bool:
        return self._thread is not None

    def configure(self, interval_s: Optional[float] = None,
                  window: Optional[int] = None) -> "TimeSeries":
        """Re-point the knobs. A window change re-bounds the ring,
        keeping the newest rollups."""
        with self._lock:
            if interval_s is not None:
                self.interval_s = max(0.05, float(interval_s))
            if window is not None and int(window) != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(2, int(window)))
        return self

    def start(self) -> "TimeSeries":
        """Start the sampling thread (idempotent). The first tick lands
        one interval from now; the baseline snapshot is taken here so
        interval #1 carries only post-start deltas."""
        if self._thread is not None:
            return self
        with self._lock:
            self._baseline_locked()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="uda-timeseries")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def reset(self) -> None:
        """Back to pristine: ring, baselines and listeners cleared
        (conftest hygiene — a test's listener must not see the next
        test's rollups)."""
        self.stop()
        with self._lock:
            self._ring.clear()
            self._listeners.clear()
            self._last_counters = None
            self._last_hists = {}
            self._seq = 0

    def _baseline_locked(self) -> None:
        self._last_counters = self.metrics.snapshot()
        self._last_hists = self.metrics.histogram_summaries()
        self._last_t = self.clock()

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.sample()
            except Exception as e:  # noqa: BLE001 - the recorder must
                # never take down the process it watches
                log.warn(f"timeseries sample failed: {e}")

    # -- the sampler core ----------------------------------------------------

    def sample(self) -> Dict:
        """One rollup step: snapshot, delta, append, notify listeners.
        Callable directly (fake-clock tests, bench harnesses)."""
        m = self.metrics
        counters = m.snapshot()
        gauges = m.gauges_snapshot()
        hists = m.histogram_summaries()
        with self._lock:
            now = self.clock()
            if self._last_counters is None:
                # first sample with no start(): self-baseline, emit an
                # all-zero rollup rather than a giant cumulative one
                self._last_counters = counters
                self._last_hists = hists
                self._last_t = now
                counters = dict(counters)
            # floor above the round(…, 6) quantum below: a same-tick
            # sample must still roll up with a dividable dt (rate
            # queries and detectors divide by it)
            dt = max(now - self._last_t, 1e-6)
            deltas = {}
            for name, v in counters.items():
                d = v - self._last_counters.get(name, 0.0)
                if d:
                    deltas[name] = d
            pcts = {}
            for key, s in hists.items():
                isum = _interval_hist(s, self._last_hists.get(key))
                if isum["count"]:
                    pcts[key] = {
                        "count": isum["count"],
                        "p50": percentile_from_summary(isum, 50),
                        "p95": percentile_from_summary(isum, 95),
                        "p99": percentile_from_summary(isum, 99)}
            self._seq += 1
            roll = {"seq": self._seq, "ts": round(time.time(), 3),
                    "dt": round(dt, 6), "counters": deltas,
                    "gauges": gauges, "percentiles": pcts}
            self._ring.append(roll)
            self._last_counters = counters
            self._last_hists = hists
            self._last_t = now
            listeners = tuple(self._listeners)
        for fn in listeners:
            try:
                fn(roll)
            except Exception as e:  # noqa: BLE001 - one consumer
                # (detector, SLI book) failing must not stop the clock
                # for the others
                global_metrics.add("ts.listener.errors")
                log.warn(f"timeseries listener failed: {e}")
        return roll

    # -- listeners (the one-timer contract) ----------------------------------

    def add_listener(self, fn: Callable[[Dict], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Dict], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- queries -------------------------------------------------------------

    def window(self, seconds: Optional[float] = None,
               count: Optional[int] = None) -> List[Dict]:
        """The newest rollups, oldest first: the last ``count``
        intervals, or every interval within the trailing ``seconds``
        (both unset = the whole ring)."""
        with self._lock:
            rolls = list(self._ring)
        if count is not None:
            rolls = rolls[-max(0, int(count)):]
        if seconds is not None:
            acc = 0.0
            kept: List[Dict] = []
            for roll in reversed(rolls):
                kept.append(roll)
                acc += roll["dt"]
                if acc >= seconds:
                    break
            rolls = list(reversed(kept))
        return rolls

    def counter_rate_series(self, name: str,
                            count: Optional[int] = None) -> List[float]:
        """Per-interval rate (delta/dt) of one counter, oldest first —
        the throughput feed the collapse detector watches."""
        return [r["counters"].get(name, 0.0) / r["dt"]
                for r in self.window(count=count)]

    def gauge_series(self, name: str,
                     count: Optional[int] = None) -> List[float]:
        return [r["gauges"].get(name, 0.0)
                for r in self.window(count=count)]

    def percentile_series(self, name: str, p: str = "p99",
                          count: Optional[int] = None) -> List[float]:
        """Per-interval percentile of one histogram series (intervals
        without samples are skipped — an idle fetch path is not a
        latency regression)."""
        out = []
        for r in self.window(count=count):
            s = r["percentiles"].get(name)
            if s is not None:
                out.append(s[p])
        return out

    # -- export (MSG_STATS / provider blocks) --------------------------------

    def summary(self) -> Dict:
        """The cheap always-on provider block: configuration + ring
        occupancy + the newest rollup's sequence/timestamp."""
        with self._lock:
            n = len(self._ring)
            last = self._ring[-1] if n else None
        return {"running": self.running,
                "interval_s": self.interval_s,
                "window": self.window_len, "samples": n,
                "last_seq": last["seq"] if last else 0,
                "last_ts": last["ts"] if last else 0.0}

    def wire_block(self, seconds: Optional[float] = None) -> Dict:
        """The on-demand MSG_STATS section (CAP_OBS peers only): the
        requested trailing window of rollups plus the summary."""
        block = self.summary()
        block["rollups"] = self.window(seconds=seconds)
        return block


timeseries = TimeSeries()

_ARM_LOCK = threading.Lock()
_ARMED = False


def arm_observability_plane(config) -> bool:
    """Wire the whole live-telemetry plane from config, idempotently:
    the rollup ring (``uda.tpu.ts.*``), the anomaly detectors
    (``uda.tpu.anomaly.*``), the per-tenant SLI book (``uda.tpu.slo.*``)
    and the optional OpenMetrics exposition
    (``uda.tpu.metrics.http.port``). Gated like the StatsReporter on
    the stats plane being on; returns whether the plane is armed.
    Callers: the bridge's ``_start_stats`` and ``ShuffleServer.start``
    — whichever runs first arms it for the process."""
    global _ARMED
    from uda_tpu_torch.utils.metrics import stats_enabled_from_env

    if not (stats_enabled_from_env()
            or config.get("uda.tpu.stats.enable")):
        return False
    if not config.get("uda.tpu.ts.enable"):
        return False
    with _ARM_LOCK:
        timeseries.configure(
            interval_s=float(config.get("uda.tpu.ts.interval.s")),
            window=int(config.get("uda.tpu.ts.window")))
        timeseries.start()
        from uda_tpu_torch.utils.anomaly import anomaly_engine
        anomaly_engine.arm_from_config(config, timeseries)
        from uda_tpu_torch.tenant.sli import sli_book
        sli_book.arm_from_config(config, timeseries)
        port = int(config.get("uda.tpu.metrics.http.port"))
        if port:
            from uda_tpu_torch.utils.openmetrics import metrics_http
            metrics_http.start(port)
        _ARMED = True
    return True


def disarm_observability_plane() -> None:
    """Tear the plane down (conftest hygiene, daemon stop): timer,
    detectors, SLI book and the exposition endpoint. Safe when never
    armed."""
    global _ARMED
    with _ARM_LOCK:
        try:
            from uda_tpu_torch.utils.anomaly import anomaly_engine
            anomaly_engine.reset()
        except Exception:  # udalint: disable=UDA006 - teardown must
            pass  # be total even mid-import-failure
        try:
            from uda_tpu_torch.tenant.sli import sli_book
            sli_book.reset()
        except Exception:  # udalint: disable=UDA006 - teardown total
            pass
        try:
            from uda_tpu_torch.utils.openmetrics import metrics_http
            metrics_http.stop()
        except Exception:  # udalint: disable=UDA006 - teardown total
            pass
        timeseries.reset()
        _ARMED = False
