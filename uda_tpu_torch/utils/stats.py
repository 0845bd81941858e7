"""Live stats reporting over the metrics hub, and the MSG_STATS registry.

The port's copy of ``uda_tpu/utils/stats.py``. :class:`StatsReporter` is
a background thread that snapshots counters and gauges every interval,
computes deltas and rates (fetch MB/s, emit MB/s, merge records/s,
retries/s) and emits one JSON-lines record per interval plus one
one-liner through the ``uda.stats`` logger. The final record
(``"final": true``, from ``stop()`` or the bridge's EXIT) also carries
the reference's per-task trio ``total_wait_mem_time`` /
``total_fetch_time`` / ``total_merge_time``, the ``recovery.*``
providers, the resource ledger's summary, the span-derived
``time_accounting`` block and the SLI book's ``slo`` block.

JSON-lines schema (one object per line)::

    {"ts", "uptime_s", "interval_s", "counters", "gauges",
     "rates": {"fetch_mb_s", "merge_records_s", "retry_per_s", "emit_mb_s"},
     "histograms": {name: {"count","sum","min","max","p50","p95","p99",
                           "buckets"}},
     "percentiles": {name: {"p50","p95","p99"}},
     "profile": {...},          # armed sampling profiler only
     "final": true, "recovery", "resledger", "time_accounting", "slo"}

This module is also the introspection registry: components with process
state register snapshot providers (:func:`register_stats_provider`) and
:func:`introspection_snapshot` folds them, with the counters, gauges,
percentiles and the ledger's summary, into the record a shuffle server
answers ``MSG_STATS`` with. ``uda.tpu.stats.enable`` / ``UDA_TPU_STATS=1``
switch the layer on, ``uda.tpu.stats.interval.ms`` paces the reporter and
``uda.tpu.stats.jsonl`` / ``UDA_TPU_STATS_JSONL`` name the JSON-lines
file (stderr when unset). :func:`telemetry_block` is what the bridge's
``GET_STATS`` answers with when no reporter runs.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import PARITY_ALIASES, Metrics
from uda_tpu_torch.utils.metrics import metrics as global_metrics
from uda_tpu_torch.utils.resledger import resledger

__all__ = ["PARITY_ALIASES", "StatsReporter", "telemetry_block",
           "introspection_snapshot", "register_stats_provider",
           "unregister_stats_provider", "percentiles_block",
           "resledger_block", "reporter_output_from_env"]

# (rate key, source counter, scale) — rate = delta(counter)/dt/scale
_RATES = (
    ("fetch_mb_s", "fetch.bytes", 1e6),
    ("emit_mb_s", "emit.bytes", 1e6),
    ("merge_records_s", "merge.records", 1.0),
    ("retry_per_s", "fetch.retries", 1.0),
)


def telemetry_block(m: Optional[Metrics] = None) -> Dict:
    """One comparable snapshot block: counters (with the parity trio),
    gauges, and histogram percentile summaries (the bridge's GET_STATS
    answer when no reporter runs)."""
    m = m or global_metrics
    counters = m.snapshot()
    for alias in PARITY_ALIASES:
        counters.setdefault(alias, 0.0)
    return {"counters": counters, "gauges": m.gauges_snapshot(),
            "histograms": m.histogram_summaries()}


def percentiles_block(m: Optional[Metrics] = None,
                      summaries: Optional[Dict] = None) -> Dict:
    """The Metrics.percentile() projection, one compact block per
    histogram series: ``{name: {"p50","p95","p99"}}`` — the same
    estimator the speculation threshold consumes internally, exposed
    in every interval/final record and over MSG_STATS so remote
    pollers read latency tails without shipping
    whole bucket arrays. Pass already-built ``summaries`` (a
    ``histogram_summaries()`` result) to avoid a second walk of every
    series per record/poll."""
    if summaries is None:
        summaries = (m or global_metrics).histogram_summaries()
    return {name: {"p50": s.get("p50", 0.0), "p95": s.get("p95", 0.0),
                   "p99": s.get("p99", 0.0)}
            for name, s in summaries.items()
            if s.get("count")}


def resledger_block() -> Dict:
    """The ResourceLedger obligation summary: open obligations grouped
    by pair (count + amount), plus the lifetime leak-report count.
    Stacks deliberately stay OFF the wire — they are the dump/log
    diagnostic; the summary is the scrape surface."""
    by_pair: Dict[str, Dict[str, float]] = {}
    outstanding = resledger.outstanding() if resledger.enabled else []
    for rec in outstanding:
        agg = by_pair.setdefault(rec["pair"], {"count": 0, "amount": 0.0})
        agg["count"] += 1
        agg["amount"] += rec["amount"]
    return {"armed": resledger.enabled,
            "outstanding": len(outstanding),
            "by_pair": by_pair,
            "leak_reports": len(resledger.leak_reports)}


# -- introspection providers (the MSG_STATS scrape surface) -------------------

# name -> zero-arg callable returning a JSON-able dict. Components with
# process-local state the metrics hub cannot see (a MergeManager's
# PenaltyBox/RecoveryLedger, a ShuffleServer's conn table) register
# here for the life of the component; introspection_snapshot() folds
# every provider into the remote-readable record. Providers must be
# cheap and non-blocking — they run on a server dispatcher thread per
# MSG_STATS poll.
_PROVIDERS: Dict[str, Callable[[], Dict]] = {}
_PROVIDERS_LOCK = threading.Lock()


def register_stats_provider(name: str, fn: Callable[[], Dict]) -> None:
    with _PROVIDERS_LOCK:
        _PROVIDERS[name] = fn


def unregister_stats_provider(name: str, fn: Optional[Callable] = None
                              ) -> None:
    """Remove ``name``; with ``fn`` given, only when it is still the
    registered callable (a replaced provider must not be yanked by its
    predecessor's teardown)."""
    with _PROVIDERS_LOCK:
        # == not `is`: bound methods are re-materialized per access,
        # but compare equal for the same (function, instance) pair
        if fn is None or _PROVIDERS.get(name) == fn:
            _PROVIDERS.pop(name, None)


def introspection_snapshot(m: Optional[Metrics] = None) -> Dict:
    """The live introspection record served over MSG_STATS (and usable
    locally): counters/gauges/histogram percentiles, the ResourceLedger
    obligation summary, and every registered provider's block
    (PenaltyBox/RecoveryLedger state, evloop conn tables). One
    provider failing must not take the whole snapshot down — its block
    degrades to an error marker."""
    m = m or global_metrics
    snap = telemetry_block(m)
    snap["ts"] = round(time.time(), 3)
    snap["pid"] = os.getpid()
    snap["percentiles"] = percentiles_block(
        summaries=snap["histograms"])
    snap["resledger"] = resledger_block()
    with _PROVIDERS_LOCK:
        providers = dict(_PROVIDERS)
    blocks = {}
    for name, fn in providers.items():
        try:
            blocks[name] = fn()
        except Exception as e:  # noqa: BLE001 - a dying component's
            # provider racing its own teardown is expected; the poll
            # must still answer
            blocks[name] = {"error": type(e).__name__}
    snap["providers"] = blocks
    return snap


def _profile_block() -> Optional[Dict]:
    """The armed sampling profiler's summary, or None (off / import
    failure) — lazy + total so reporting never depends on the
    profiler's health."""
    try:
        from uda_tpu_torch.utils.profiler import profiler

        if not profiler.armed:
            return None
        return profiler.summary()
    except Exception:  # udalint: disable=UDA006 - profiling is
        return None  # additive; a reporter record must still emit


def _time_accounting_block(m: Optional[Metrics]) -> Optional[Dict]:
    """The critpath block over the recorded span tree, or None —
    same additive contract as the profile block."""
    try:
        from uda_tpu_torch.utils.critpath import time_accounting_block

        return time_accounting_block(m)
    except Exception:  # udalint: disable=UDA006 - additive block
        return None


def _slo_block() -> Optional[Dict]:
    """Per-tenant SLO attainment/burn from the armed SLI book, or
    None — same additive contract as the profile block (the lazy
    import keeps stats.py free of a tenant-layer dependency for
    single-tenant runs)."""
    try:
        from uda_tpu_torch.tenant.sli import sli_book

        return sli_book.slo_block()
    except Exception:  # udalint: disable=UDA006 - additive block
        return None


class StatsReporter:
    """Periodic snapshot/delta/rate reporter over a :class:`Metrics`.

    ``clock`` is injectable for tests (defaults to ``time.monotonic``);
    ``out`` is a path (appended, line-buffered), a file-like object, or
    None for stderr. ``report_once()`` is the single-step core the
    background thread loops on — callable directly with a fake clock."""

    def __init__(self, metrics_obj: Optional[Metrics] = None,
                 interval_s: float = 1.0, out=None,
                 clock: Callable[[], float] = time.monotonic,
                 logger_name: str = "uda.stats"):
        self.metrics = metrics_obj or global_metrics
        self.interval_s = max(0.05, float(interval_s))
        self.clock = clock
        self.log = get_logger(logger_name)
        self._out = out
        self._own_file = None
        if isinstance(out, str):
            self._own_file = open(out, "a", buffering=1)
        self._t0 = clock()
        self._last_t = self._t0
        self._last_counters: Dict[str, float] = self.metrics.snapshot()
        self._latest: Dict = {}
        self._stop = threading.Event()
        self._stopped_final = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StatsReporter":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="uda-stats-reporter")
            self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        """Stop the loop; with ``final`` emit one last record flagged
        ``"final": true``. Idempotent: a second stop neither emits
        another final record nor writes past the closed JSONL file."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if final and not self._stopped_final:
            self._stopped_final = True
            self.report_once(final=True)
        if self._own_file is not None:
            self._own_file.close()
            self._own_file = None

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.report_once()
            except Exception as e:  # noqa: BLE001 - reporting must never
                # take down the job it watches
                self.log.warn(f"stats report failed: {e}")

    # -- the report itself --------------------------------------------------

    def report_once(self, final: bool = False) -> Dict:
        """Snapshot, diff against the previous snapshot, emit one JSONL
        record + one progress line. Returns the record (also kept as
        ``latest()`` for the bridge's GET_STATS)."""
        with self._lock:
            now = self.clock()
            dt = max(now - self._last_t, 1e-9)
            counters = self.metrics.snapshot()
            rates = {key: round((counters.get(src, 0.0)
                                 - self._last_counters.get(src, 0.0))
                                / dt / scale, 6)
                     for key, src, scale in _RATES}
            self._last_t = now
            self._last_counters = counters
            record: Dict = {
                "ts": round(time.time(), 3),
                "uptime_s": round(now - self._t0, 3),
                "interval_s": round(dt, 3),
                "counters": counters,
                "gauges": self.metrics.gauges_snapshot(),
                "rates": rates,
                "histograms": self.metrics.histogram_summaries(),
            }
            # the Metrics.percentile() projection (p50/p95/p99 per
            # series) in EVERY record — the tail-latency view the
            # speculation threshold already consumes internally —
            # derived from the summaries just built, not a second walk
            record["percentiles"] = percentiles_block(
                summaries=record["histograms"])
            prof = _profile_block()
            if prof is not None:
                record["profile"] = prof
            if final:
                record["final"] = True
                for alias in PARITY_ALIASES:
                    record["counters"].setdefault(alias, 0.0)
                # the task post-mortem blocks: what the survivable-
                # shuffle layer did (registered recovery.* providers —
                # PenaltyBox state, RecoveryLedger counts) and whether
                # the obligation books closed clean
                with _PROVIDERS_LOCK:
                    providers = dict(_PROVIDERS)
                recovery = {}
                for name, fn in providers.items():
                    if not name.startswith("recovery"):
                        continue
                    try:
                        recovery[name] = fn()
                    except Exception as e:  # noqa: BLE001 - teardown race
                        recovery[name] = {"error": type(e).__name__}
                record["recovery"] = recovery
                record["resledger"] = resledger_block()
                # the time-accounting post-mortem: where the task's
                # wall-clock went, bucketed over the recorded span
                # tree (None when spans were off — the block is
                # additive, never a failure)
                ta = _time_accounting_block(self.metrics)
                if ta is not None:
                    record["time_accounting"] = ta
                # the SLO post-mortem: per-tenant attainment + burn
                # rate over the run (None when the SLI book never
                # armed — additive, never a failure)
                slo = _slo_block()
                if slo is not None:
                    record["slo"] = slo
            self._latest = record
            self._write_jsonl(record)
        self._progress_line(record)
        return record

    def latest(self) -> Dict:
        """Most recent record (computed on demand when none exists yet —
        the GET_STATS pull path)."""
        with self._lock:
            latest = dict(self._latest)
        return latest or self.report_once()

    def _write_jsonl(self, record: Dict) -> None:
        line = json.dumps(record, sort_keys=True)
        out = self._own_file or self._out or sys.stderr
        try:
            out.write(line + "\n")
        except ValueError:  # closed stream (interpreter teardown)
            pass

    def _progress_line(self, record: Dict) -> None:
        r = record["rates"]
        g = record["gauges"]
        c = record["counters"]
        self.log.info(
            f"shuffle stats: fetch {r['fetch_mb_s']:.2f} MB/s, emit "
            f"{r['emit_mb_s']:.2f} MB/s, merge {r['merge_records_s']:.0f} "
            f"rec/s, retries {r['retry_per_s']:.2f}/s "
            f"(total {c.get('fetch.retries', 0):.0f}), on-air "
            f"{g.get('fetch.on_air', 0):.0f}")


def reporter_output_from_env(cfg_path: str = "") -> Optional[str]:
    """Resolve the JSONL destination: explicit config path wins, then
    UDA_TPU_STATS_JSONL, else None (stderr)."""
    return cfg_path or os.environ.get("UDA_TPU_STATS_JSONL") or None
