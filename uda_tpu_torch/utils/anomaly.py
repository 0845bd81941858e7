"""Online anomaly detection over the time-series rollup ring.

The port's copy of ``uda_tpu/utils/anomaly.py``. Four EWMA/z-score
detectors run on every rollup of
:class:`~uda_tpu_torch.utils.timeseries.TimeSeries`, each with an
absolute guard so an idle process cannot alarm:

- **throughput collapse**: a counter's rate falls below
  ``uda.tpu.anomaly.collapse.frac`` of its EWMA while the EWMA shows the
  plane moving (``uda.tpu.anomaly.collapse.floor.mb_s``);
- **p99 inflation**: a latency histogram's per-interval p99 z-scores
  above ``uda.tpu.anomaly.zscore`` and clears
  ``uda.tpu.anomaly.p99.floor.ms``;
- **gauge leak-slope**: a watched gauge (``uda.tpu.anomaly.leak.gauges``)
  rises monotonically across the window by ``uda.tpu.anomaly.leak.rise``;
- **tenant starvation**: the SLI book reports a tenant with backlog and
  no scheduled bytes for ``uda.tpu.anomaly.starve.s``.

A firing advances ``anomaly.<kind>{key=...}`` and ``anomaly.fired`` and
records a flight-recorder event; the proactive dump (cause ``anomaly``)
is off by default (``uda.tpu.anomaly.dump`` / ``UDA_TPU_ANOMALY_DUMP=1``)
and rate-limited. Every detector needs ``uda.tpu.anomaly.consec``
breaching intervals in a row and ``uda.tpu.anomaly.warmup`` intervals of
history.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List

from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["AnomalyEngine", "anomaly_engine"]

log = get_logger()

# clean intervals after which an active anomaly is considered resolved
_CLEAR_AFTER = 3


class _Ewma:
    """Exponentially-weighted mean/variance (West's update) — the
    per-series baseline every detector scores against."""

    __slots__ = ("alpha", "n", "mean", "var")

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = x
            return
        d = x - self.mean
        incr = self.alpha * d
        self.mean += incr
        self.var = (1.0 - self.alpha) * (self.var + d * incr)

    def zscore(self, x: float) -> float:
        if self.n < 2:
            return 0.0
        return (x - self.mean) / math.sqrt(self.var + 1e-12)


class _Detector:
    """One detector = per-key baselines + a consecutive-breach counter
    (the hysteresis that keeps a single noisy interval silent)."""

    kind = "generic"

    def __init__(self, engine: "AnomalyEngine"):
        self.engine = engine
        self._ewma: Dict[str, _Ewma] = {}
        self._breach: Dict[str, int] = {}

    def baseline(self, key: str) -> _Ewma:
        b = self._ewma.get(key)
        if b is None:
            b = self._ewma[key] = _Ewma(self.engine.alpha)
        return b

    def judge(self, key: str, breaching: bool, detail: Dict) -> None:
        """Count consecutive breaches; hand a sustained one to the
        engine (which dedupes active anomalies and rate-limits dumps)."""
        n = self._breach.get(key, 0) + 1 if breaching else 0
        self._breach[key] = n
        if breaching and n >= self.engine.consec:
            self.engine.fire(self.kind, key, detail)
        elif not breaching:
            self.engine.clear_tick(self.kind, key)


class _ThroughputCollapse(_Detector):
    kind = "throughput"

    COUNTERS = ("fetch.bytes", "supplier.bytes", "emit.bytes")

    def observe(self, roll: Dict) -> None:
        eng = self.engine
        for name in self.COUNTERS:
            rate = roll["counters"].get(name, 0.0) / roll["dt"]
            b = self.baseline(name)
            moving = b.n >= eng.warmup and b.mean >= eng.collapse_floor
            breaching = moving and rate < eng.collapse_frac * b.mean
            self.judge(name, breaching, {
                "series": name, "rate": round(rate, 1),
                "ewma": round(b.mean, 1)})
            # a collapsed interval must not drag the baseline down to
            # the collapsed level (self-normalizing outage): only
            # healthy intervals teach the EWMA
            if not breaching:
                b.update(rate)


class _P99Inflation(_Detector):
    kind = "p99"

    HISTS = ("fetch.latency_ms", "supplier.read.latency_ms")

    def observe(self, roll: Dict) -> None:
        eng = self.engine
        for name in self.HISTS:
            s = roll["percentiles"].get(name)
            if s is None:
                continue  # idle interval: no latency evidence either way
            p99 = s["p99"]
            b = self.baseline(name)
            breaching = (b.n >= eng.warmup
                         and p99 >= eng.p99_floor_ms
                         and b.zscore(p99) >= eng.zscore)
            self.judge(name, breaching, {
                "series": name, "p99_ms": round(p99, 3),
                "ewma_ms": round(b.mean, 3),
                "z": round(b.zscore(p99), 2)})
            if not breaching:
                b.update(p99)


class _GaugeLeak(_Detector):
    kind = "leak"

    def observe(self, roll: Dict) -> None:
        eng = self.engine
        ts = eng.timeseries
        if ts is None:
            return
        for name in eng.leak_gauges:
            series = ts.gauge_series(name)
            if len(series) < max(eng.warmup, 4):
                self._breach[name] = 0
                continue
            rise = series[-1] - series[0]
            monotone = all(b >= a for a, b in zip(series, series[1:]))
            breaching = monotone and rise >= eng.leak_rise
            self.judge(name, breaching, {
                "gauge": name, "rise": round(rise, 1),
                "over_intervals": len(series)})


class _TenantStarvation(_Detector):
    kind = "starvation"

    def observe(self, roll: Dict) -> None:
        from uda_tpu_torch.tenant.sli import sli_book

        eng = self.engine
        starving = sli_book.starving_tenants(eng.starve_s)
        seen = set()
        for tenant, starved_s in starving.items():
            seen.add(tenant)
            self.judge(tenant, True, {
                "tenant": tenant, "starved_s": round(starved_s, 3)})
        for tenant in list(self._breach):
            if tenant not in seen:
                self.judge(tenant, False, {})


class AnomalyEngine:
    """The detector host: subscribes to the TimeSeries listener feed,
    keeps the active-anomaly table the wire/fleet layer exports, and
    owns the proactive-dump policy."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.timeseries = None
        self.armed = False
        # policy knobs (re-pointed by arm_from_config)
        self.alpha = 0.3
        self.zscore = 4.0
        self.warmup = 5
        self.consec = 3
        self.collapse_frac = 0.25
        self.collapse_floor = 1e6  # bytes/s the EWMA must show before
        # a collapse is judgeable (the absolute guard)
        self.p99_floor_ms = 50.0
        self.leak_gauges: tuple = ("fetch.on_air",)
        self.leak_rise = 64.0
        self.starve_s = 5.0
        self.dump_enabled = False
        self.dump_interval_s = 300.0
        self._detectors: List[_Detector] = []
        self._active: Dict[str, Dict] = {}   # (kind|key) -> anomaly
        self._clean: Dict[str, int] = {}     # (kind|key) -> clean ticks
        self.fired = 0
        self.dumps = 0
        self._last_dump_t = 0.0

    # -- lifecycle -----------------------------------------------------------

    def arm_from_config(self, config, ts) -> bool:
        """Configure + subscribe to ``ts``'s rollup feed. Idempotent;
        returns armed state. Detect-only unless ``uda.tpu.anomaly.dump``
        (or UDA_TPU_ANOMALY_DUMP=1) asks for proactive capture."""
        if not config.get("uda.tpu.anomaly.enable"):
            return False
        with self._lock:
            self.zscore = float(config.get("uda.tpu.anomaly.zscore"))
            self.warmup = int(config.get("uda.tpu.anomaly.warmup"))
            self.consec = int(config.get("uda.tpu.anomaly.consec"))
            self.collapse_frac = float(
                config.get("uda.tpu.anomaly.collapse.frac"))
            self.collapse_floor = 1e6 * float(
                config.get("uda.tpu.anomaly.collapse.floor.mb_s"))
            self.p99_floor_ms = float(
                config.get("uda.tpu.anomaly.p99.floor.ms"))
            self.leak_gauges = tuple(
                g.strip() for g in
                str(config.get("uda.tpu.anomaly.leak.gauges")).split(",")
                if g.strip())
            self.leak_rise = float(config.get("uda.tpu.anomaly.leak.rise"))
            self.starve_s = float(config.get("uda.tpu.anomaly.starve.s"))
            self.dump_enabled = (
                bool(config.get("uda.tpu.anomaly.dump"))
                or os.environ.get("UDA_TPU_ANOMALY_DUMP", "") == "1")
            self.dump_interval_s = float(
                config.get("uda.tpu.anomaly.dump.interval.s"))
            if not self.armed:
                self._detectors = [_ThroughputCollapse(self),
                                   _P99Inflation(self),
                                   _GaugeLeak(self),
                                   _TenantStarvation(self)]
                self.timeseries = ts
                ts.add_listener(self.on_rollup)
                self.armed = True
        return True

    def reset(self) -> None:
        """Disarm and clear all state (conftest hygiene)."""
        with self._lock:
            ts, self.timeseries = self.timeseries, None
            self.armed = False
            self._detectors = []
            self._active.clear()
            self._clean.clear()
            self.fired = 0
            self.dumps = 0
            self._last_dump_t = 0.0
            self.dump_enabled = False
        if ts is not None:
            ts.remove_listener(self.on_rollup)

    # -- the per-rollup pass -------------------------------------------------

    def on_rollup(self, roll: Dict) -> None:
        for det in list(self._detectors):
            det.observe(roll)

    # -- firing / clearing ---------------------------------------------------

    def fire(self, kind: str, key: str, detail: Dict) -> None:
        """A sustained breach. Transition-edge counting: an anomaly
        already active only refreshes its detail — counters and dumps
        fire on the inactive->active edge."""
        akey = f"{kind}|{key}"
        with self._lock:
            self._clean.pop(akey, None)
            known = self._active.get(akey)
            if known is not None:
                known.update(detail)
                known["last_ts"] = round(time.time(), 3)
                return
            self._active[akey] = dict(
                detail, kind=kind, key=key,
                since_ts=round(time.time(), 3),
                last_ts=round(time.time(), 3))
            self.fired += 1
        metrics.add(f"anomaly.{kind}", key=key)
        metrics.add("anomaly.fired")
        log.warn(f"anomaly detected: {kind} on {key!r} {detail}")
        from uda_tpu_torch.utils.flightrec import flightrec

        flightrec.record("anomaly", anomaly=kind, key=key, **detail)
        self._maybe_dump(kind, key, detail)

    def clear_tick(self, kind: str, key: str) -> None:
        """One clean interval for this (kind, key); after
        ``_CLEAR_AFTER`` of them the anomaly leaves the active table."""
        akey = f"{kind}|{key}"
        with self._lock:
            if akey not in self._active:
                return
            n = self._clean.get(akey, 0) + 1
            if n >= _CLEAR_AFTER:
                self._active.pop(akey, None)
                self._clean.pop(akey, None)
            else:
                self._clean[akey] = n

    def _maybe_dump(self, kind: str, key: str, detail: Dict) -> None:
        """The proactive capture: rate-limited flight-recorder dump
        BEFORE anything fails (cause=anomaly). Detect-only default."""
        if not self.dump_enabled:
            return
        now = time.monotonic()
        with self._lock:
            if self._last_dump_t and \
                    now - self._last_dump_t < self.dump_interval_s:
                return
            self._last_dump_t = now
            self.dumps += 1
        from uda_tpu_torch.utils.flightrec import flightrec

        metrics.add("anomaly.dumps")
        flightrec.dump("anomaly", extra={
            "anomaly": dict(detail, kind=kind, key=key),
            "active": self.active()})

    # -- export --------------------------------------------------------------

    def active(self) -> List[Dict]:
        with self._lock:
            return sorted((dict(a) for a in self._active.values()),
                          key=lambda a: (a["kind"], a["key"]))

    def snapshot(self) -> Dict:
        """The provider / MSG_STATS block."""
        with self._lock:
            active = sorted((dict(a) for a in self._active.values()),
                            key=lambda a: (a["kind"], a["key"]))
            return {"armed": self.armed, "fired": self.fired,
                    "dumps": self.dumps,
                    "dump_enabled": self.dump_enabled,
                    "active": active}


anomaly_engine = AnomalyEngine()
