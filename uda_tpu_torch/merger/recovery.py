"""The recovery ledger: one shared record of what the fetch layer did for a
reduce task.

The port's copy of ``uda_tpu/merger/recovery.py``: a bounded list of
structured events (kind, supplier, map_id, error class — never reason
strings), with the ``snapshot``/``restore`` a checkpoint manifest carries,
and a ``rank()`` view over the task's ``PenaltyBox``: the one source-choice
primitive of the fetch layer (a replicated segment's primary pick,
speculation's alternate, reconstruction's shard fan-out). The monotone
``version`` feeds the stall watchdog's progress token: a reconstruction
fetching shards is progress even while the segment's counters stand
still.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

from uda_tpu_torch.utils.flightrec import flightrec
from uda_tpu_torch.utils.locks import TrackedLock

__all__ = ["RecoveryLedger"]

_MAX_EVENTS = 256


class RecoveryLedger:
    """Bounded per-task recovery journal + supplier health ranking."""

    def __init__(self, box=None):
        self._box = box  # PenaltyBox (rank source); optional for tests
        self._lock = TrackedLock("recovery.ledger")
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
        # recovery events are what a post-mortem wants in sequence with
        # the faults that caused them: mirror them into the black box
        flightrec.record(f"recovery.{kind}", supplier=supplier,
                         map_id=map_id, error=event["error"])

    def rank(self, hosts: Sequence[str]) -> list:
        """``hosts`` healthiest-first by PenaltyBox state (unboxed before
        boxed, fewer faults before more; stable within a tier, so the
        caller's preference order breaks ties)."""
        box = self._box
        if box is None:
            return list(hosts)
        return box.rank(hosts)

    def events(self, kind: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]

    def restore(self, events: Sequence[dict]) -> None:
        """Re-seed the journal from a checkpoint manifest. Only the
        structured keys are taken (a manifest is outside input). Bumps
        ``version`` once, so the watchdog sees the load as progress."""
        with self._lock:
            for e in events:
                self._events.append(
                    {"kind": str(e.get("kind", "")),
                     "supplier": str(e.get("supplier", "")),
                     "map_id": str(e.get("map_id", "")),
                     "error": (str(e["error"])
                               if e.get("error") is not None else None)})
            self.version += 1

    def snapshot(self) -> dict:
        """The journal with its version and per-kind counts (the
        checkpoint manifest's ``journal`` is its ``events``)."""
        with self._lock:
            evs = list(self._events)
            version = self.version
        counts: dict = {}
        for e in evs:
            counts[e["kind"]] = counts.get(e["kind"], 0) + 1
        return {"version": version, "counts": counts, "events": evs}
