"""The recovery ledger: one shared record of what the fetch layer did for a
reduce task.

The port's copy of the journal half of ``uda_tpu/merger/recovery.py``: a
bounded list of structured events (kind, supplier, map_id, error class —
never reason strings). Its ``rank()`` view serves replicated and
reconstructed fetches, which are not ported yet.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

__all__ = ["RecoveryLedger"]

_MAX_EVENTS = 256


class RecoveryLedger:
    """Bounded per-task recovery journal."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=_MAX_EVENTS)
        self.version = 0  # monotone event counter

    def record(self, kind: str, supplier: str = "", map_id: str = "",
               error: Optional[BaseException] = None) -> None:
        """Append one structured event; ``error`` is recorded by class
        name only."""
        event = {"kind": kind, "supplier": supplier, "map_id": map_id,
                 "error": type(error).__name__ if error is not None
                 else None}
        with self._lock:
            self._events.append(event)
            self.version += 1

    def events(self, kind: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]
