"""Span-attributed sampling profiler: where the host's wall clock goes.

The port's copy of ``uda_tpu/utils/profiler.py``. One daemon thread
walks ``sys._current_frames()`` at ``uda.tpu.profile.hz``
(``UDA_TPU_PROFILE=<hz>``; 0 = off) and charges every thread's stack
sample to that thread's active span, read from the tracer's thread-span
registry (:func:`uda_tpu_torch.utils.metrics.active_span_of_thread`,
filled only while the profiler is armed). Views: folded stacks
(:meth:`SamplingProfiler.folded`), per-span self/total samples
(:meth:`~SamplingProfiler.span_summary`), the block stats records and
MSG_STATS embed (:meth:`~SamplingProfiler.summary`), the last-N-seconds
slice stall and flight-recorder dumps embed
(:meth:`~SamplingProfiler.recent_summary`) and the ``kind: "profile"``
records span exports append (:meth:`~SamplingProfiler.export_records`).
Every tick flushes ``profile.ticks`` and ``profile.samples{span=...}``.

Off, no thread exists and every hook is one module-global check. A
sampling error counts ``errors.swallowed`` and the loop goes on. With
spans off, samples land under ``(unattributed)``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from uda_tpu_torch.utils.locks import TrackedLock
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import (active_span_of_thread,
                                   enable_thread_span_registry, metrics)

__all__ = ["SamplingProfiler", "profiler", "profile_hz_from_env",
           "DEFAULT_HZ", "UNATTRIBUTED"]

log = get_logger()

# default rate when armed without an explicit hz (UDA_TPU_PROFILE=1):
# a prime near 100 so the sampler cannot phase-lock with 10ms-grained
# pollers (the py-spy convention)
DEFAULT_HZ = 97.0
_MAX_STACK_DEPTH = 48
UNATTRIBUTED = "(unattributed)"


def profile_hz_from_env() -> float:
    """``UDA_TPU_PROFILE``: unset/0/false = off; a number = that
    sampling rate in Hz; bare truthy (1/true/yes/on) = DEFAULT_HZ. An
    unparsable value arms the default with a warning — an operator who
    asked for profiling should get it, not a silent no-op."""
    raw = os.environ.get("UDA_TPU_PROFILE", "").strip().lower()
    if raw in ("", "0", "false", "no", "off"):
        return 0.0
    if raw in ("1", "true", "yes", "on"):
        return DEFAULT_HZ
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.warn(f"UDA_TPU_PROFILE={raw!r} is not a rate; "
                 f"profiling at the default {DEFAULT_HZ:g} Hz")
        return DEFAULT_HZ


class SamplingProfiler:
    """The sampler + aggregation. One global instance (:data:`profiler`)
    serves the process; tests needing isolation construct private ones
    (a private instance never toggles the global thread-span registry
    unless started)."""

    def __init__(self) -> None:
        self._hz = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # leaf lock over the aggregates: only the sampler writes, and
        # the metrics flush happens OUTSIDE it
        self._mu = TrackedLock("profiler")
        self._agg: Dict[tuple, int] = {}        # (span, frames) -> n
        self._self: Dict[str, int] = {}         # span -> self samples
        self._total: Dict[str, int] = {}        # span -> self+descendant
        self._window: Dict[str, list] = {}      # span -> [first, last] wall ts
        self._ring: deque = deque(maxlen=8192)  # (wall_ts, span)
        self._samples = 0
        self._ticks = 0

    # -- lifecycle -----------------------------------------------------------

    @property
    def armed(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def hz(self) -> float:
        return self._hz if self.armed else 0.0

    def start(self, hz: float = DEFAULT_HZ) -> "SamplingProfiler":
        """Arm at ``hz`` samples/s. Idempotent: already armed at any
        rate keeps the running sampler (first arm wins — a second
        MergeManager must not restart mid-task aggregation)."""
        if hz <= 0 or self.armed:
            return self
        self._hz = float(hz)
        self._stop.clear()
        # keep roughly two minutes of attribution for recent_summary,
        # bounded both ways
        self._ring = deque(self._ring,
                           maxlen=int(min(65536, max(1024, hz * 120))))
        enable_thread_span_registry(True)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="uda-profiler")
        self._thread.start()
        metrics.gauge("profile.hz", self._hz)
        return self

    def stop(self) -> None:
        """Disarm (idempotent). Aggregates survive for post-run reads;
        ``reset()`` clears them."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        if threading.current_thread() is not t:
            t.join(timeout=2.0)
        self._thread = None
        enable_thread_span_registry(False)
        metrics.gauge("profile.hz", 0.0)

    def reset(self) -> None:
        with self._mu:
            self._agg.clear()
            self._self.clear()
            self._total.clear()
            self._window.clear()
            self._ring.clear()
            self._samples = 0
            self._ticks = 0

    # -- the sampling loop ---------------------------------------------------

    def _run(self) -> None:
        period = 1.0 / self._hz
        next_t = time.monotonic() + period
        while not self._stop.wait(max(0.0, next_t - time.monotonic())):
            try:
                self._sample()
            except Exception as e:  # noqa: BLE001 - a dying frame or a
                # half-torn-down interpreter must not kill the sampler
                metrics.add("errors.swallowed")
                log.debug(f"profiler: sample failed: {e}")
            now = time.monotonic()
            next_t += period
            if next_t < now:  # overran: skip missed ticks, don't burst
                next_t = now + period

    def _sample(self) -> None:
        now = time.time()
        me = threading.get_ident()
        frames = sys._current_frames()
        pending: Dict[str, int] = {}
        with self._mu:
            self._ticks += 1
            for tid, frame in frames.items():
                if tid == me:
                    continue
                stack: List[str] = []
                f = frame
                while f is not None and len(stack) < _MAX_STACK_DEPTH:
                    co = f.f_code
                    stack.append(f"{co.co_name} "
                                 f"({os.path.basename(co.co_filename)})")
                    f = f.f_back
                stack.reverse()  # folded convention: root first
                span = active_span_of_thread(tid)
                name = span.name if span is not None else UNATTRIBUTED
                key = (name, tuple(stack))
                self._agg[key] = self._agg.get(key, 0) + 1
                self._self[name] = self._self.get(name, 0) + 1
                for nm in (set(span.chain) if span is not None
                           else (UNATTRIBUTED,)):
                    self._total[nm] = self._total.get(nm, 0) + 1
                w = self._window.get(name)
                if w is None:
                    self._window[name] = [now, now]
                else:
                    w[1] = now
                self._ring.append((now, name))
                self._samples += 1
                pending[name] = pending.get(name, 0) + 1
        # counter flush OUTSIDE the aggregation lock (metrics holds its
        # own leaf lock; never nest the two)
        metrics.add("profile.ticks")
        for name, k in pending.items():
            metrics.add("profile.samples", k, span=name)

    # -- views ---------------------------------------------------------------

    def folded(self) -> str:
        """Flamegraph-ready folded-stack text: one
        ``span;frame;frame count`` line per distinct (span, stack)
        pair, heaviest first."""
        with self._mu:
            items = sorted(self._agg.items(), key=lambda kv: -kv[1])
        return "\n".join(
            ";".join((name,) + stack) + f" {n}"
            for (name, stack), n in items)

    def span_summary(self) -> Dict[str, Dict[str, int]]:
        """Per-span sample attribution: ``{span: {"self", "total"}}``."""
        with self._mu:
            names = set(self._self) | set(self._total)
            return {nm: {"self": self._self.get(nm, 0),
                         "total": max(self._total.get(nm, 0),
                                      self._self.get(nm, 0))}
                    for nm in sorted(names)}

    def summary(self, top_stacks: int = 10) -> Dict:
        """The one-block view stats records and MSG_STATS embed."""
        with self._mu:
            samples, ticks = self._samples, self._ticks
            top = sorted(self._agg.items(), key=lambda kv: -kv[1])
            top = top[:max(0, top_stacks)]
        return {"hz": self.hz, "samples": samples, "ticks": ticks,
                "spans": self.span_summary(),
                "top_stacks": [{"span": name,
                                "stack": list(stack)[-6:],
                                "samples": n}
                               for (name, stack), n in top]}

    def recent_summary(self, seconds: float = 30.0) -> Dict:
        """Per-span attribution of the last ``seconds`` only — the
        'what was it doing just before it wedged' slice watchdog stall
        dumps and flightrec post-mortems embed."""
        cutoff = time.time() - max(0.0, seconds)
        counts: Dict[str, int] = {}
        with self._mu:
            ring = list(self._ring)
        for ts, name in ring:
            if ts >= cutoff:
                counts[name] = counts.get(name, 0) + 1
        return {"window_s": seconds, "samples": sum(counts.values()),
                "spans": dict(sorted(counts.items(),
                                     key=lambda kv: -kv[1]))}

    def export_records(self, pid: Optional[int] = None) -> List[Dict]:
        """The ``kind: "profile"`` records appended to span JSONL
        exports (one per attributed span, carrying self/total counts,
        the observed wall window and the span's heaviest stacks) —
        the reference's scripts/trace_merge.py renders them as a profile
        lane."""
        if not self._samples:
            return []
        pid = os.getpid() if pid is None else pid
        with self._mu:
            windows = {nm: tuple(w) for nm, w in self._window.items()}
            agg = sorted(self._agg.items(), key=lambda kv: -kv[1])
        summary = self.span_summary()
        recs = []
        for nm, counts in summary.items():
            t0, t1 = windows.get(nm, (0.0, 0.0))
            stacks = [";".join(stack) + f" {n}"
                      for (span, stack), n in agg if span == nm][:5]
            recs.append({"kind": "profile", "span": nm, "pid": pid,
                         "self": counts["self"], "total": counts["total"],
                         "t0_unix": t0, "t1_unix": t1,
                         "hz": self.hz, "stacks": stacks})
        return recs


profiler = SamplingProfiler()
