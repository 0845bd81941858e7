"""Flight recorder: an always-on black box for post-mortem forensics.

The port's copy of ``uda_tpu/utils/flightrec.py``. A bounded ring of
structured events (segment transitions, admission and routing decisions
with their cause, recovery events, failpoint fires, watchdog samples),
one flag check and one ``deque.append`` per event, dumped when a task
goes wrong: on ``FallbackSignal`` (MergeManager.run), on a watchdog
stall, on a ResourceLedger leak and on an anomaly.

A dump is one JSON file, ``flightrec_<pid>_<seq>_<cause>.json`` under
``uda.tpu.flightrec.dir`` / ``UDA_TPU_FLIGHTREC_DIR``, holding the cause,
the events (oldest first), the non-zero counters and gauges and, when
armed, the profiler's last 30 s and the span-derived time accounting.
With no directory the report stays in :attr:`FlightRecorder.reports`
(bounded). ``UDA_TPU_FLIGHTREC=0`` / ``uda.tpu.flightrec.enable=false``
turns it off; ``uda.tpu.flightrec.events`` bounds the ring. Every dump
counts ``flightrec.dumps``. The module imports only the stdlib at module
scope, so every layer can hook it without cycles.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "flightrec", "flightrec_enabled_from_env"]

_DEFAULT_EVENTS = 4096
_MAX_REPORTS = 16  # in-memory dump reports kept (newest wins)


def flightrec_enabled_from_env() -> bool:
    """UDA_TPU_FLIGHTREC=0 (or false/no/off) disables the recorder;
    anything else — including unset — leaves it on (black boxes
    default to recording)."""
    return os.environ.get("UDA_TPU_FLIGHTREC", "").strip().lower() not in (
        "0", "false", "no", "off")


class FlightRecorder:
    """The ring + dump machinery. One global instance
    (:data:`flightrec`) serves every instrumented site; tests that
    need isolation construct private instances."""

    def __init__(self, capacity: int = _DEFAULT_EVENTS,
                 enabled: Optional[bool] = None,
                 dump_dir: str = "") -> None:
        self.enabled = (flightrec_enabled_from_env() if enabled is None
                        else bool(enabled))
        self._ring: deque = deque(maxlen=max(16, int(capacity)))
        self._dump_dir = dump_dir
        # dump bookkeeping only; record() never takes this lock
        self._mu = threading.Lock()
        self._seq = 0
        self.dump_paths: List[str] = []
        self.reports: List[dict] = []

    # -- configuration -------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  dump_dir: Optional[str] = None) -> None:
        """Apply the ``uda.tpu.flightrec.*`` knobs (bridge start /
        MergeManager construction). Growing/shrinking the ring keeps
        the newest events."""
        if enabled is not None:
            self.enabled = bool(enabled)
        if capacity is not None and int(capacity) != self._ring.maxlen:
            with self._mu:
                self._ring = deque(self._ring,
                                   maxlen=max(16, int(capacity)))
        if dump_dir is not None and dump_dir != "":
            self._dump_dir = dump_dir

    def _resolved_dir(self) -> str:
        return self._dump_dir or os.environ.get(
            "UDA_TPU_FLIGHTREC_DIR", "")

    # -- the hot hook --------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one structured event. The writer path is one flag
        check + one bounded ``deque.append`` — no lock, no I/O."""
        if not self.enabled:
            return
        self._ring.append((time.time(), kind, fields))

    # -- inspection / dump ---------------------------------------------------

    def events(self) -> List[dict]:
        """Snapshot of the ring, oldest first. The writer path is
        deliberately lock-free, so a concurrent append can roll the
        bounded deque mid-iteration (RuntimeError) — retry the copy; a
        torn snapshot under sustained mutation degrades to the newest
        consistent copy rather than an exception on a FAILURE path."""
        items: list = []
        for _ in range(8):
            try:
                items = list(self._ring)
                break
            except RuntimeError:  # deque mutated during iteration
                continue
        return [{"ts": ts, "kind": kind, **fields}
                for ts, kind, fields in items]

    def dump(self, cause: str, extra: Optional[Dict[str, Any]] = None
             ) -> Optional[str]:
        """Write one black-box report. Returns the file path (or None
        when no dump directory is configured — the report then lives
        only in :attr:`reports`). Dump failures are swallowed after
        logging: the recorder must never turn a failing job's unwind
        into a second failure."""
        if not self.enabled:
            return None
        try:
            return self._dump(cause, extra)
        except Exception as e:  # noqa: BLE001 - dump() runs inside
            # failure unwinds (the FallbackSignal re-raise, the
            # watchdog thread): a recorder bug must never replace the
            # real failure or kill its thread
            try:
                from uda_tpu_torch.utils.logging import get_logger
                get_logger().warn(f"flightrec: dump failed: {e}")
            except Exception:  # udalint: disable=UDA006 - teardown:
                pass  # deliberately silent, the job's unwind wins
            return None

    def _dump(self, cause: str, extra: Optional[Dict[str, Any]]
              ) -> Optional[str]:
        report: Dict[str, Any] = {
            "ts": time.time(),
            "pid": os.getpid(),
            "cause": cause,
            "extra": dict(extra or {}),
            "events": self.events(),
        }
        try:  # best-effort context; never a hard dependency
            from uda_tpu_torch.utils.metrics import metrics
            report["counters"] = {k: v for k, v in
                                  metrics.snapshot().items() if v}
            report["gauges"] = {k: v for k, v in
                                metrics.gauges_snapshot().items() if v}
            metrics.add("flightrec.dumps")
        except Exception:  # udalint: disable=UDA006 - half-imported
            pass  # metrics during interpreter teardown: deliberately
            # silent (logging may be half-dead too); the events
            # themselves still dump, which is the whole point
        try:  # the last-30s span-attributed profile slice — ARMED
            # profiler only (a post-mortem never arms sampling), and
            # any profiler error degrades to omission: this runs
            # inside failure unwinds where the dump must stay total
            from uda_tpu_torch.utils.profiler import profiler
            if profiler.armed:
                report["profile"] = profiler.recent_summary(30.0)
        except Exception:  # udalint: disable=UDA006 - omission, never
            pass  # a second failure inside the unwind
        try:  # where the wall went (span-derived; spans on only)
            from uda_tpu_torch.utils.critpath import time_accounting_block
            ta = time_accounting_block()
            if ta is not None:
                report["time_accounting"] = ta
        except Exception:  # udalint: disable=UDA006 - omission, never
            pass  # a second failure inside the unwind
        with self._mu:
            self._seq += 1
            seq = self._seq
            self.reports.append(report)
            del self.reports[:-_MAX_REPORTS]
        path = None
        out_dir = self._resolved_dir()
        if out_dir:
            fname = f"flightrec_{os.getpid()}_{seq}_" \
                    f"{_slug(cause)}.json"
            path = os.path.join(out_dir, fname)
            try:
                os.makedirs(out_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(report, f, default=repr)
            except OSError as e:
                path = None
                try:
                    from uda_tpu_torch.utils.logging import get_logger
                    get_logger().warn(
                        f"flightrec: cannot write dump under "
                        f"{out_dir!r}: {e}")
                except Exception:  # noqa: BLE001 - teardown
                    print(f"flightrec: cannot write dump: {e}")
        if path is not None:
            with self._mu:
                self.dump_paths.append(path)
        return path

    def reset(self) -> None:
        """Forget events, reports and dump bookkeeping (tests)."""
        with self._mu:
            self._ring.clear()
            self.dump_paths.clear()
            self.reports.clear()
            self._seq = 0


def _slug(cause: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in cause)[:48] or "dump"


flightrec = FlightRecorder()
