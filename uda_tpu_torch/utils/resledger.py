"""Runtime resource-obligation ledger.

The port's copy of ``uda_tpu/utils/resledger.py``, pair ids unchanged
(``pool.lease``, ``store.fd``, ``ctx.failpoints.scoped``, the paired
gauges' ``gauge.*``). Under ``UDA_TPU_RESLEDGER=1`` every registered
acquire (a row-buffer lease, a DataEngine fd pin, an admission-byte
charge, a paired-gauge increment, a scoped failpoint arming) records an
outstanding obligation with the stack that opened it, and the paired
release settles it. Drain points (the overlapped merger's finish/abort,
DataEngine stop, bridge EXIT) then report anything still open as a
leak, once, with its allocation stack; leaks count ``resledger.leaks``,
dump the flight recorder and append JSON lines to
``UDA_TPU_RESLEDGER_JSON`` when it is set.

Settlement is by ``(pair, owner, key)``: ``owner`` scopes one instance's
books so one engine's drain cannot confiscate a live peer's obligations.
Amount-bearing pairs (gauges, admission bytes) settle oldest-first; an
amount settle that finds nothing open becomes a transient deficit the
next acquire under the same key cancels (a decrement may reach the books
an instant before its increment), cleared at every drain. A unit settle
with no record is ignored, so arming mid-process invents no double
release. Off, every hook is one attribute check.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["ResourceLedger", "resledger", "PAIRED_GAUGES",
           "resledger_enabled_from_env"]


def resledger_enabled_from_env() -> bool:
    """UDA_TPU_RESLEDGER=1 (or true/yes/on) arms the ledger for the
    whole process."""
    return os.environ.get("UDA_TPU_RESLEDGER", "").strip().lower() in (
        "1", "true", "yes", "on")


# gauge name -> ledger pair id, the paired (increment must meet
# decrement) gauges. Pair ids are the reference's own, so a leak report
# names the same discipline in both packages.
PAIRED_GAUGES: Dict[str, str] = {
    "fetch.on_air": "gauge.fetch.on_air",
    "stage.inflight.bytes": "gauge.stage.inflight",
    "arena.slots_in_use": "gauge.arena.slots",
    "supplier.reads.on_air": "gauge.reads.on_air",
    "supplier.read.bytes.on_air": "gauge.read.bytes",
    "io.batch.inflight": "gauge.io.batch",
    "tenant.read.bytes.on_air": "gauge.tenant.read.bytes",
    "store.migrate.bytes.on_air": "gauge.store.migrate",
    "push.on_air": "gauge.push.on_air",
    "push.staged.bytes": "gauge.push.staged",
}


class _Rec:
    """One open obligation: how much, who opened it, where."""

    __slots__ = ("amount", "detail", "stack", "seq")

    def __init__(self, amount: float, detail: str, stack: str, seq: int):
        self.amount = amount
        self.detail = detail
        self.stack = stack
        self.seq = seq


class ResourceLedger:
    """The obligation books. One global instance (:data:`resledger`)
    serves every instrumented site by default; tests that SEED leaks
    use private instances so fixture leaks never pollute the real
    code's zero-outstanding invariant (the LockDep pattern)."""

    def __init__(self, enabled: Optional[bool] = None,
                 emit_metrics: bool = False, emit_json: bool = False):
        self.enabled = (resledger_enabled_from_env() if enabled is None
                        else bool(enabled))
        # only the process-global instance feeds the resledger.leaks
        # counter and the UDA_TPU_RESLEDGER_JSON report file: a private
        # fixture ledger SEEDING a leak on purpose must never fail the
        # chaos rung's zero-leaks-on-real-code gate (the LockDep rule)
        self.emit_metrics = emit_metrics
        self.emit_json = emit_json
        # a raw lock, not a TrackedLock: the ledger must not ledger
        # itself (and must stay importable before utils.locks)
        self._mu = threading.Lock()
        self._recs: Dict[Tuple[str, Any, Any], List[_Rec]] = {}
        # transient settle-before-acquire shortfalls (see module
        # docstring); consumed by the next acquire under the same key,
        # cleared at every drain point
        self._deficits: Dict[Tuple[str, Any, Any], float] = {}
        self._seq = 0
        self.leak_reports: List[dict] = []  # every drain's findings

    # -- events --------------------------------------------------------------

    def acquire(self, pair: str, key: Any = None, amount: float = 1,
                detail: str = "", owner: Any = None) -> None:
        """Open one obligation under ``(pair, owner, key)``. No-op
        when off."""
        if not self.enabled:
            return
        # [:-1] drops this frame; the acquire site is the tail
        stack = "".join(traceback.format_stack()[:-1])
        with self._mu:
            k = (pair, owner, key)
            deficit = self._deficits.get(k, 0.0)
            if deficit > 0:
                # a racing settle got here first (see module
                # docstring): this acquire is the one it paid for
                take = min(deficit, float(amount))
                if deficit - take <= 0:
                    self._deficits.pop(k, None)
                else:
                    self._deficits[k] = deficit - take
                amount = float(amount) - take
                if amount <= 0:
                    return
            self._seq += 1
            self._recs.setdefault(k, []).append(
                _Rec(float(amount), detail, stack, self._seq))

    def settle(self, pair: str, key: Any = None,
               amount: Optional[float] = None, owner: Any = None) -> None:
        """Close obligations under ``(pair, key)``: the newest single
        record when ``amount`` is None (the unit acquire/release idiom:
        fd pins, leases), else ``amount`` worth oldest-first (the
        byte-accounting idiom: gauges, admission charges — a release
        of N bytes retires the N longest-open bytes, splitting the
        last record). An unmatched unit settle is ignored (mid-process
        arming); an unmatched amount becomes a transient deficit the
        next acquire cancels (the settle-before-acquire inversion —
        see the module docstring)."""
        if not self.enabled:
            return
        with self._mu:
            k = (pair, owner, key)
            recs = self._recs.get(k)
            if amount is None:
                if recs:
                    recs.pop()
            else:
                left = float(amount)
                while recs and left > 0:
                    if recs[0].amount <= left:
                        left -= recs[0].amount
                        recs.pop(0)
                    else:
                        recs[0].amount -= left
                        left = 0
                if left > 0:
                    self._deficits[k] = self._deficits.get(k, 0.0) + left
            if not recs:
                self._recs.pop(k, None)

    def note_gauge(self, name: str, delta: float) -> None:
        """The central paired-gauge hook (called by
        :meth:`uda_tpu_torch.utils.metrics.Metrics.gauge_add`): a positive
        delta opens ``delta`` worth of obligation, a negative one
        settles it."""
        pair = PAIRED_GAUGES.get(name)
        if pair is None:
            return
        if delta > 0:
            self.acquire(pair, key=name, amount=delta)
        elif delta < 0:
            self.settle(pair, key=name, amount=-delta)

    # -- inspection / drains -------------------------------------------------

    _ANY = object()  # drain/outstanding: no owner filter

    def outstanding(self, pairs: Optional[Iterable[str]] = None,
                    owner: Any = _ANY) -> List[dict]:
        """Snapshot of open obligations (optionally only ``pairs`` /
        one ``owner``'s books)."""
        want = set(pairs) if pairs is not None else None
        out = []
        with self._mu:
            for (pair, own, key), recs in self._recs.items():
                if want is not None and pair not in want:
                    continue
                if owner is not self._ANY and own != owner:
                    continue
                for rec in recs:
                    out.append({"pair": pair, "owner": own, "key": key,
                                "amount": rec.amount,
                                "detail": rec.detail,
                                "stack": rec.stack, "seq": rec.seq})
        out.sort(key=lambda r: r["seq"])
        return out

    def drain(self, point: str, pairs: Optional[Iterable[str]] = None,
              owner: Any = _ANY) -> List[dict]:
        """Assert the books are empty at a lifecycle boundary:
        anything still open (optionally restricted to ``pairs`` and to
        one instance's ``owner`` scope) is a LEAK — popped from the
        books (so each obligation is reported exactly once, even
        across overlapping drain points), logged with its allocation
        stack, counted (``resledger.leaks``) and appended to
        ``UDA_TPU_RESLEDGER_JSON``. Returns the reports."""
        if not self.enabled:
            return []
        want = set(pairs) if pairs is not None else None
        leaked: List[Tuple[str, Any, _Rec]] = []
        with self._mu:
            for pk in list(self._recs):
                if want is not None and pk[0] not in want:
                    continue
                if owner is not self._ANY and pk[1] != owner:
                    continue
                for rec in self._recs.pop(pk):
                    leaked.append((pk[0], pk[2], rec))
            # deficits are transient by contract: at a quiescent
            # boundary a residual one is a plain gauge imbalance (the
            # gauge-balance teardown's class), never carried forward
            for pk in list(self._deficits):
                if want is not None and pk[0] not in want:
                    continue
                if owner is not self._ANY and pk[1] != owner:
                    continue
                del self._deficits[pk]
        if not leaked:
            return []
        leaked.sort(key=lambda t: t[2].seq)
        reports = []
        for pair, key, rec in leaked:
            reports.append({"point": point, "pair": pair,
                            "key": repr(key), "amount": rec.amount,
                            "detail": rec.detail, "stack": rec.stack})
        with self._mu:
            self.leak_reports.extend(reports)
        self._emit(point, reports)
        return reports

    def _emit(self, point: str, reports: List[dict]) -> None:
        lines = [f"RESLEDGER: {len(reports)} leaked obligation(s) at "
                 f"drain point {point!r}:"]
        for r in reports:
            lines.append(
                f"-- {r['pair']} key={r['key']} amount={r['amount']:g}"
                f"{' (' + r['detail'] + ')' if r['detail'] else ''}, "
                f"acquired at --\n{r['stack']}")
        text = "\n".join(lines)
        try:
            from uda_tpu_torch.utils.logging import get_logger
            get_logger().error(text)
        except Exception:  # noqa: BLE001 - the report must survive a
            print(text)    # half-imported logging module
        if self.emit_metrics:
            try:
                from uda_tpu_torch.utils.metrics import metrics
                metrics.add("resledger.leaks", len(reports))
            except Exception as e:  # noqa: BLE001
                print(f"resledger: metrics unavailable: {e}")
            # a leak on the PROCESS-GLOBAL books is a black-box trigger
            # (private fixture ledgers seeding leaks on purpose stay
            # out — the emit_metrics flag is the global-instance mark):
            # dump the event stream that surrounded the unmatched
            # acquire, with the leak summary as the cause
            try:
                from uda_tpu_torch.utils.flightrec import flightrec
                flightrec.dump("resledger_leak", extra={
                    "point": point, "leaks": len(reports),
                    "pairs": sorted({r["pair"] for r in reports})})
            except Exception as e:  # noqa: BLE001 - interpreter teardown
                print(f"resledger: flightrec unavailable: {e}")
        out = (os.environ.get("UDA_TPU_RESLEDGER_JSON")
               if self.emit_json else None)
        if out:
            try:
                with open(out, "a") as f:
                    for r in reports:
                        f.write(json.dumps(r) + "\n")
            except OSError as e:
                print(f"resledger: cannot append {out}: {e}")

    def reset(self) -> None:
        """Forget open obligations and past reports (tests)."""
        with self._mu:
            self._recs.clear()
            self._deficits.clear()
            self.leak_reports.clear()
            self._seq = 0


resledger = ResourceLedger(emit_metrics=True, emit_json=True)
