"""Stall watchdog: no-progress detection with a diagnostic dump.

The port's copy of ``uda_tpu/utils/watchdog.py``. The reference could hang
forever when a supplier stopped answering: the completion never arrived
and the merge thread sat in a wait with nothing watching it. A
:class:`StallWatchdog` thread samples a *progress token* (any value that
changes while work moves). When the token stops changing for ``stall_s``
seconds it

1. dumps the live diagnosis to the log: every thread's current stack and
   the non-zero counters and gauges;
2. fires ``on_stall(StallError)`` once, the hook ``MergeManager`` uses to
   fail the in-flight segments so its waiters wake and the failure flows
   through the ``FallbackSignal`` contract instead of hanging.

Knobs: ``uda.tpu.watchdog.stall.s`` (0 = off) and
``uda.tpu.watchdog.fallback`` (dump only when false). The poll period is
``stall_s / 4`` clamped to [0.05 s, 5 s], so detection takes at most
``stall_s + poll``.

Left out of the dump because the port has no such module yet: the span
tree, the lock table, the sampling profile and the time accounting; and
the flight recorder's record of each sample.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Optional

from uda_tpu_torch.utils.errors import UdaError
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["StallError", "StallWatchdog", "dump_diagnostics"]

log = get_logger()


class StallError(UdaError):
    """No observable progress for the configured stall deadline."""


def dump_diagnostics(reason: str = "") -> str:
    """The stall dump: every thread's stack and the non-zero counters and
    gauges, as one log-ready string."""
    lines = [f"=== stall diagnostics{': ' + reason if reason else ''} ==="]
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    lines.append(f"--- {len(frames)} thread stacks ---")
    for tid, frame in frames.items():
        lines.append(f"thread {names.get(tid, '?')} (ident {tid}):")
        lines.extend("  " + ln.rstrip("\n").replace("\n", "\n  ")
                     for ln in traceback.format_stack(frame))
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
    """One watcher thread per guarded task. ``progress`` is called from the
    watchdog thread and must be cheap and non-blocking; any value
    supporting ``==`` works as the token."""

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
        # never join from the watchdog's own thread (an on_stall hook that
        # tears its manager down would deadlock on a self-join)
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
            if now_token != token:
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
        hook = self.on_stall
        if hook is not None:
            try:
                hook(err)
            except Exception as e:  # noqa: BLE001 - the hook is rescue code
                log.error(f"watchdog on_stall hook failed: {e}")
        # set last: an observer seeing fired=True may rely on the dump
        # being written and the rescue hook having run
        self.fired = True
