"""Stall watchdog: no-progress detection with a diagnostic dump.

The port's copy of ``uda_tpu/utils/watchdog.py``. The reference could hang
forever when a supplier stopped answering: the completion never arrived
and the merge thread sat in a wait with nothing watching it. A
:class:`StallWatchdog` thread samples a *progress token* (any value that
changes while work moves); every sample is a flight-recorder event. When
the token stops changing for ``stall_s`` seconds it

1. dumps the live diagnosis to the log: every thread's current stack, the
   held-lock table and lockdep's cycles (``UDA_TPU_LOCKDEP=1``), the
   recorded span tree, the armed profiler's last 30 s, the span-derived
   time accounting and the non-zero counters and gauges, and dumps the
   flight recorder (cause ``stall``);
2. fires ``on_stall(StallError)`` once, the hook ``MergeManager`` uses to
   fail the in-flight segments so its waiters wake and the failure flows
   through the ``FallbackSignal`` contract instead of hanging.

Knobs: ``uda.tpu.watchdog.stall.s`` (0 = off) and
``uda.tpu.watchdog.fallback`` (dump only when false). The poll period is
``stall_s / 4`` clamped to [0.05 s, 5 s], so detection takes at most
``stall_s + poll``.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Optional

from uda_tpu_torch.utils.errors import UdaError
from uda_tpu_torch.utils.flightrec import flightrec
from uda_tpu_torch.utils.locks import lockdep
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["StallError", "StallWatchdog", "dump_diagnostics"]

log = get_logger()


class StallError(UdaError):
    """No observable progress for the configured stall deadline."""


def dump_diagnostics(reason: str = "") -> str:
    """The stall dump: all thread stacks + the recorded span tree +
    non-zero counters, as one log-ready string. Also usable standalone
    (e.g. from a signal handler or a debug command)."""
    lines = [f"=== stall diagnostics{': ' + reason if reason else ''} ==="]
    # thread stacks (the py-spy a wedged job can't run on itself)
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    lines.append(f"--- {len(frames)} thread stacks ---")
    for tid, frame in frames.items():
        lines.append(f"thread {names.get(tid, '?')} (ident {tid}):")
        lines.extend("  " + ln.rstrip("\n").replace("\n", "\n  ")
                     for ln in traceback.format_stack(frame))
    # the lockdep view (UDA_TPU_LOCKDEP=1): who holds which tracked
    # locks right now, and any order cycles seen so far — a wedged
    # thread's stack says WHERE it sits, the lock table says WHAT it
    # sits on
    if lockdep.enabled:
        held = lockdep.held_by_thread()
        lines.append(f"--- tracked locks held ({len(held)} threads) ---")
        lines.extend(f"  {who}: {' -> '.join(classes)}"
                     for who, classes in sorted(held.items()))
        if lockdep.cycles:
            lines.append(f"--- lockdep cycles "
                         f"({len(lockdep.cycles)} reported) ---")
            lines.extend(f"  [{c['kind']}] {c['note']}"
                         for c in lockdep.cycles)
    # the span tree: completed spans, rendered parent->child (the live
    # subtree is whatever has not ended yet — its absence under a parent
    # with children is itself the wedge signature)
    spans = list(metrics.spans)
    if spans:
        lines.append(f"--- span tree ({len(spans)} recorded spans) ---")
        children: dict = {}
        known = {s["id"] for s in spans}
        for s in spans:
            parent = s.get("parent")
            # a parent id this process never recorded is a REMOTE
            # parent (wire-carried trace context) or an un-ended span:
            # render the child as a local root rather than dropping the
            # whole subtree from the dump
            if parent is not None and parent not in known:
                parent = None
            children.setdefault(parent, []).append(s)

        def walk(parent_id, depth):
            for s in children.get(parent_id, []):
                attrs = s.get("attrs") or {}
                a = (" " + ",".join(f"{k}={v}" for k, v in attrs.items())
                     if attrs else "")
                lines.append(f"{'  ' * depth}{s['name']} "
                             f"dur={s['dur'] * 1e3:.1f}ms{a}")
                walk(s["id"], depth + 1)

        walk(None, 1)
    # the last-30-seconds span-attributed profile: WHAT the threads
    # were executing as progress flatlined, next to WHERE they sit now
    # (the stacks above). Armed profiler only — a dump never arms it —
    # and total: any profiler error degrades to omission, because this
    # renders inside a failure path
    try:
        from uda_tpu_torch.utils.profiler import profiler

        if profiler.armed:
            recent = profiler.recent_summary(30.0)
            lines.append(f"--- sampling profile (last "
                         f"{recent['window_s']:g}s, "
                         f"{recent['samples']} samples) ---")
            lines.extend(f"  {name}: {n}"
                         for name, n in recent["spans"].items())
    except Exception:  # udalint: disable=UDA006 - dump must stay total
        pass
    # where the wall went so far (span-derived; spans on only)
    try:
        from uda_tpu_torch.utils.critpath import time_accounting_block

        ta = time_accounting_block()
        if ta is not None:
            lines.append(f"--- time accounting (wall "
                         f"{ta['wall_s']:.3f}s, root "
                         f"{ta['root'] or 'none'}) ---")
            lines.extend(
                f"  {b}: critical {rec['critical_s']:.3f}s "
                f"({rec['share'] * 100:.1f}%), busy {rec['busy_s']:.3f}s"
                for b, rec in ta["buckets"].items() if rec["busy_s"])
            lines.append(f"  idle: {ta['idle_s']:.3f}s")
    except Exception:  # udalint: disable=UDA006 - dump must stay total
        pass
    counters = {k: v for k, v in metrics.snapshot().items() if v}
    if counters:
        lines.append("--- non-zero counters ---")
        lines.extend(f"  {k} = {v:g}" for k, v in sorted(counters.items()))
    gauges = {k: v for k, v in metrics.gauges_snapshot().items() if v}
    if gauges:
        lines.append("--- gauges ---")
        lines.extend(f"  {k} = {v:g}" for k, v in sorted(gauges.items()))
    return "\n".join(lines)


class StallWatchdog:
    """One watcher thread per guarded task. ``progress`` is called from
    the watchdog thread and must be cheap and non-blocking (counter
    reads); any value supporting ``==`` works as the token."""

    def __init__(self, stall_s: float, progress: Callable[[], object],
                 on_stall: Optional[Callable[[StallError], None]] = None,
                 name: str = "uda-watchdog"):
        if stall_s <= 0:
            raise UdaError("watchdog needs a positive stall deadline")
        self.stall_s = float(stall_s)
        self.progress = progress
        self.on_stall = on_stall
        self.poll_s = min(5.0, max(0.05, self.stall_s / 4.0))
        self.fired = False
        self.last_dump: Optional[str] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=name)

    def start(self) -> "StallWatchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # never join from the watchdog's own thread (an on_stall hook
        # that tears its manager down would deadlock on self-join)
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=2.0)

    def _watch(self) -> None:
        token = self.progress()
        last_change = time.monotonic()
        while not self._stop.wait(self.poll_s):
            try:
                now_token = self.progress()
            except Exception as e:  # noqa: BLE001 - a broken probe must
                log.warn(f"watchdog progress probe failed: {e}")  # not
                continue                                          # kill us
            now = time.monotonic()
            changed = now_token != token
            # every sample lands in the black box: a post-mortem dump
            # shows exactly when progress flatlined, not just that it
            # eventually did (bounded rate — poll_s >= 0.05 s)
            flightrec.record("watchdog", changed=changed,
                             idle_s=round(0.0 if changed
                                          else now - last_change, 3))
            if changed:
                token, last_change = now_token, now
                continue
            if now - last_change < self.stall_s:
                continue
            self._fire(now - last_change)
            return

    def _fire(self, stalled_for: float) -> None:
        metrics.add("watchdog.stalls")
        err = StallError(
            f"no fetch/merge progress for {stalled_for:.1f} s "
            f"(stall deadline {self.stall_s:g} s)")
        self.last_dump = dump_diagnostics(str(err))
        log.error(self.last_dump)
        # the stall IS a black-box trigger: the ring holds the
        # flatlining watchdog samples and whatever faults preceded them
        flightrec.dump("stall", extra={"stalled_s": round(stalled_for, 3),
                                       "deadline_s": self.stall_s})
        hook = self.on_stall
        if hook is not None:
            try:
                hook(err)
            except Exception as e:  # noqa: BLE001 - the hook is rescue
                log.error(f"watchdog on_stall hook failed: {e}")  # code
        # set LAST: an observer seeing fired=True may rely on the dump
        # being written and the rescue hook having run
        self.fired = True
