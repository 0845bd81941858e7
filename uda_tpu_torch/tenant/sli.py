"""Per-tenant SLI/SLO accounting of the multi-tenant daemon.

The port's copy of ``uda_tpu/tenant/sli.py``. :class:`SliBook`
subscribes to the :class:`~uda_tpu_torch.utils.timeseries.TimeSeries`
rollup feed and keeps, per tenant: bytes fetched and served (the
tenant-labelled counter deltas), per-interval p99 of the tenant series
of ``fetch.latency_ms``, ``supplier.read.latency_ms`` and
``tenant.queue.wait_ms``, credit-starvation time (backlog with no
scheduled bytes: the starvation detector's feed) and the scheduled
against entitled share of the WDRR scheduler. SLO targets
(``uda.tpu.slo.*``) turn them into per-interval compliance bits;
attainment over the window and the burn rate ``(1 - attainment) / (1 -
objective)`` are exported in every snapshot, in the StatsReporter's
final ``slo`` block and over MSG_STATS (CAP_OBS).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from uda_tpu_torch.utils.metrics import metrics

__all__ = ["SliBook", "sli_book", "series_labels"]

# the SLI names with configurable targets (the slo_block schema)
_SLI_FETCH = "fetch_p99_ms"
_SLI_SERVE = "serve_p99_ms"
_SLI_SHARE = "share"


def series_labels(key: str) -> tuple:
    """Split a metrics series key ``name{k=v,...}`` into
    ``(name, labels)`` (plain names -> empty labels)."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for kv in inner[:-1].split(","):
        if "=" in kv:
            k, _, v = kv.partition("=")
            labels[k] = v
    return name, labels


def _tenant_counter_deltas(roll: Dict, counter: str) -> Dict[str, float]:
    """Sum one rollup's labeled deltas of ``counter`` by tenant."""
    out: Dict[str, float] = {}
    for key, delta in roll["counters"].items():
        name, labels = series_labels(key)
        t = labels.get("tenant")
        if name == counter and t:
            out[t] = out.get(t, 0.0) + delta
    return out


def _tenant_p99(roll: Dict, hist: str) -> Dict[str, float]:
    """Count-weighted per-tenant p99 of one histogram family in this
    interval (a tenant fetching from several suppliers has one series
    per supplier; the weighted fold is the tenant's tail)."""
    acc: Dict[str, list] = {}
    for key, s in roll["percentiles"].items():
        name, labels = series_labels(key)
        t = labels.get("tenant")
        if name == hist and t:
            pair = acc.setdefault(t, [0.0, 0])
            pair[0] += s["p99"] * s["count"]
            pair[1] += s["count"]
    return {t: v[0] / v[1] for t, v in acc.items() if v[1]}


class _TenantSli:
    """One tenant's accumulators + rolling compliance window."""

    __slots__ = ("bytes_fetched", "bytes_served", "sched_bytes",
                 "starved_s", "starve_streak_s", "window",
                 "last_p99", "last_share", "last_entitled")

    def __init__(self, window: int):
        self.bytes_fetched = 0.0
        self.bytes_served = 0.0
        self.sched_bytes = 0.0          # lifetime scheduled (granted)
        self.starved_s = 0.0
        self.starve_streak_s = 0.0
        # per-interval records: {"dt", "sched", "demand", "entitled",
        #  "ok": {sli: bool|None}} — share/attainment read from here
        self.window: deque = deque(maxlen=max(2, window))
        self.last_p99: Dict[str, Optional[float]] = {}
        self.last_share: Optional[float] = None
        self.last_entitled: Optional[float] = None


class SliBook:
    """The per-tenant SLI/SLO ledger (module singleton
    :data:`sli_book`; private instances for tests)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.armed = False
        self.timeseries = None
        self._sched = None
        self._registry = None
        self._tenants: Dict[str, _TenantSli] = {}
        self._last_granted: Dict[str, float] = {}
        self._window = 120
        # SLO targets: 0/None = SLI tracked, no target
        self.slo_fetch_p99_ms = 0.0
        self.slo_serve_p99_ms = 0.0
        self.slo_share_frac = 0.5
        self.objective = 0.99

    # -- lifecycle -----------------------------------------------------------

    def arm_from_config(self, config, ts) -> bool:
        """Read the ``uda.tpu.slo.*`` targets and subscribe to the
        rollup feed. Idempotent."""
        with self._lock:
            self.slo_fetch_p99_ms = float(
                config.get("uda.tpu.slo.fetch.p99.ms"))
            self.slo_serve_p99_ms = float(
                config.get("uda.tpu.slo.serve.p99.ms"))
            self.slo_share_frac = float(
                config.get("uda.tpu.slo.share.frac"))
            self.objective = min(0.999999, max(
                0.0, float(config.get("uda.tpu.slo.objective"))))
            self._window = ts.window_len
            if not self.armed:
                self.timeseries = ts
                ts.add_listener(self.on_rollup)
                self.armed = True
        return True

    def attach(self, scheduler=None, registry=None) -> None:
        """The daemon's scheduler/registry hookup (ShuffleServer.start);
        share/starvation SLIs need the CreditScheduler's view."""
        with self._lock:
            self._sched = scheduler
            self._registry = registry

    def detach(self, scheduler=None) -> None:
        """Drop the hookup — only if still ours (the replaced-provider
        discipline of unregister_stats_provider)."""
        with self._lock:
            if scheduler is None or self._sched is scheduler:
                self._sched = None
                self._registry = None

    def reset(self) -> None:
        with self._lock:
            ts, self.timeseries = self.timeseries, None
            self.armed = False
            self._sched = None
            self._registry = None
            self._tenants.clear()
            self._last_granted.clear()
        if ts is not None:
            ts.remove_listener(self.on_rollup)

    def _sli(self, tenant: str) -> _TenantSli:
        s = self._tenants.get(tenant)
        if s is None:
            s = self._tenants[tenant] = _TenantSli(self._window)
        return s

    # -- the per-rollup pass -------------------------------------------------

    def on_rollup(self, roll: Dict) -> None:
        dt = roll["dt"]
        fetched = _tenant_counter_deltas(roll, "fetch.bytes")
        served = _tenant_counter_deltas(roll, "supplier.bytes")
        fetch_p99 = _tenant_p99(roll, "fetch.latency_ms")
        serve_p99 = _tenant_p99(roll, "supplier.read.latency_ms")
        wait_p99 = _tenant_p99(roll, "tenant.queue.wait_ms")
        sched = self._sched
        sched_stats = None
        if sched is not None:
            try:
                sched_stats = sched.stats()
            except RuntimeError:
                sched_stats = None  # racing a structural mutation:
                # skip the scheduler SLIs this interval
        with self._lock:
            granted_delta: Dict[str, float] = {}
            demand: Dict[str, bool] = {}
            weights: Dict[str, float] = {}
            if sched_stats is not None:
                for t, st in sched_stats["tenants"].items():
                    g = st["granted_cost"]
                    granted_delta[t] = g - self._last_granted.get(t, 0.0)
                    self._last_granted[t] = g
                    # demand this interval = scheduled work or backlog
                    demand[t] = bool(granted_delta[t] > 0
                                     or st["parked"]
                                     or st["inflight"])
                    weights[t] = max(1, int(st["weight"]))
            total_granted = sum(granted_delta.values())
            demand_weight = sum(w for t, w in weights.items()
                                if demand.get(t))
            tenants = (set(fetched) | set(served) | set(fetch_p99)
                       | set(serve_p99) | set(granted_delta))
            for t in tenants:
                s = self._sli(t)
                s.bytes_fetched += fetched.get(t, 0.0)
                s.bytes_served += served.get(t, 0.0)
                s.sched_bytes += granted_delta.get(t, 0.0)
                share = entitled = None
                if t in granted_delta and demand.get(t):
                    if total_granted > 0:
                        share = granted_delta[t] / total_granted
                    if demand_weight > 0:
                        entitled = weights[t] / demand_weight
                    starving = (granted_delta[t] <= 0
                                and sched_stats["tenants"][t]["parked"])
                    if starving:
                        s.starved_s += dt
                        s.starve_streak_s += dt
                    else:
                        s.starve_streak_s = 0.0
                s.last_p99 = {"fetch": fetch_p99.get(t),
                              "serve": serve_p99.get(t),
                              "wait": wait_p99.get(t)}
                if share is not None:
                    s.last_share = share
                    s.last_entitled = entitled
                ok: Dict[str, Optional[bool]] = {}
                ok[_SLI_FETCH] = (
                    fetch_p99[t] <= self.slo_fetch_p99_ms
                    if self.slo_fetch_p99_ms and t in fetch_p99 else None)
                ok[_SLI_SERVE] = (
                    serve_p99[t] <= self.slo_serve_p99_ms
                    if self.slo_serve_p99_ms and t in serve_p99 else None)
                ok[_SLI_SHARE] = (
                    share >= self.slo_share_frac * entitled
                    if share is not None and entitled else None)
                for sli, good in ok.items():
                    if good is False:
                        metrics.add("sli.slo.breach", tenant=t, sli=sli)
                s.window.append({"dt": dt,
                                 "sched": granted_delta.get(t, 0.0),
                                 "demand": bool(demand.get(t)),
                                 "ok": ok})

    # -- the anomaly feed ----------------------------------------------------

    def starving_tenants(self, min_s: float) -> Dict[str, float]:
        """Tenants whose CURRENT starvation streak (backlog, zero
        scheduled bytes) is at least ``min_s`` seconds long."""
        with self._lock:
            return {t: s.starve_streak_s
                    for t, s in self._tenants.items()
                    if s.starve_streak_s >= min_s}

    # -- export --------------------------------------------------------------

    @staticmethod
    def _attainment(s: _TenantSli, sli: str) -> Optional[float]:
        judged = [rec["ok"][sli] for rec in s.window
                  if rec["ok"].get(sli) is not None]
        if not judged:
            return None
        return sum(1 for ok in judged if ok) / len(judged)

    def _burn(self, attainment: Optional[float]) -> Optional[float]:
        if attainment is None:
            return None
        return round((1.0 - attainment) / (1.0 - self.objective), 3)

    def _tenant_block(self, t: str, s: _TenantSli) -> Dict:
        wsched = sum(rec["sched"] for rec in s.window)
        wtotal = 0.0
        for other in self._tenants.values():
            wtotal += sum(rec["sched"] for rec in other.window)
        slo = {}
        for sli, target in ((_SLI_FETCH, self.slo_fetch_p99_ms),
                            (_SLI_SERVE, self.slo_serve_p99_ms),
                            (_SLI_SHARE, self.slo_share_frac)):
            att = self._attainment(s, sli)
            slo[sli] = {"target": target, "attainment":
                        round(att, 4) if att is not None else None,
                        "burn": self._burn(att)}
        return {
            "bytes_fetched": s.bytes_fetched,
            "bytes_served": s.bytes_served,
            "sched_bytes": s.sched_bytes,
            "window_share": round(wsched / wtotal, 4) if wtotal else None,
            "share": s.last_share, "entitled": s.last_entitled,
            "starved_s": round(s.starved_s, 3),
            "starve_streak_s": round(s.starve_streak_s, 3),
            "p99_ms": {k: (round(v, 3) if v is not None else None)
                       for k, v in s.last_p99.items()},
            "slo": slo,
        }

    def snapshot(self) -> Dict:
        """The provider / MSG_STATS ``sli`` block: every tenant's SLIs
        + the SLO configuration they are judged against."""
        with self._lock:
            return {
                "armed": self.armed,
                "objective": self.objective,
                "targets": {_SLI_FETCH: self.slo_fetch_p99_ms,
                            _SLI_SERVE: self.slo_serve_p99_ms,
                            _SLI_SHARE: self.slo_share_frac},
                "tenants": {t: self._tenant_block(t, s)
                            for t, s in sorted(self._tenants.items())},
            }

    def slo_block(self) -> Optional[Dict]:
        """The final-record attainment summary (None when the book
        never saw a tenant — the block is additive)."""
        with self._lock:
            if not self._tenants:
                return None
            worst: Optional[float] = None
            out: Dict = {"objective": self.objective, "tenants": {}}
            for t, s in sorted(self._tenants.items()):
                slos = {}
                for sli, target in (
                        (_SLI_FETCH, self.slo_fetch_p99_ms),
                        (_SLI_SERVE, self.slo_serve_p99_ms),
                        (_SLI_SHARE, self.slo_share_frac)):
                    att = self._attainment(s, sli)
                    if att is None:
                        continue
                    slos[sli] = {"target": target,
                                 "attainment": round(att, 4),
                                 "burn": self._burn(att)}
                    worst = att if worst is None else min(worst, att)
                out["tenants"][t] = slos
            out["worst_attainment"] = (round(worst, 4)
                                       if worst is not None else None)
            return out


sli_book = SliBook()
