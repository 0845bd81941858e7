"""Runtime lock-order validation (lockdep) and the race detector.

The port's copy of ``uda_tpu/utils/locks.py``, class names, env switches
and report shapes unchanged. Locks are grouped into *classes* by name;
every acquisition while other locks are held records a directed edge
``held-class -> acquired-class`` in a process-global order graph, and an
acquisition that would close a cycle is reported at acquire time with
the stacks that established both orders, long before the scheduling that
would wedge. Re-acquiring the same non-reentrant instance is reported as
a self-deadlock; same-class nesting is not an edge.

Usage::

    self._lock = TrackedLock("segment.state")
    self._cv = TrackedCondition(self._lock)
    with self._lock: ...

Off (``UDA_TPU_LOCKDEP`` unset) each acquire costs one attribute check.
On (``UDA_TPU_LOCKDEP=1``), cycles count ``lockdep.cycles`` and append a
JSON line to ``UDA_TPU_LOCKDEP_JSON`` when it is set; the stall dump
(:func:`uda_tpu_torch.utils.watchdog.dump_diagnostics`) carries the held-
lock table. ``UDA_TPU_RACEDET=1`` arms the Eraser lockset machine over
the attributes :func:`race_instrument` hooks (``UDA_TPU_RACEDET_SAMPLE``,
``UDA_TPU_RACEDET_JSON``).
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["LockDep", "TrackedLock", "TrackedCondition", "lockdep",
           "lockdep_enabled_from_env", "RaceDetector", "racedet",
           "race_instrument", "racedet_enabled_from_env",
           "RACE_INSTRUMENTED"]


def _env_flag(var: str) -> bool:
    return os.environ.get(var, "").strip().lower() in (
        "1", "true", "yes", "on")


def lockdep_enabled_from_env() -> bool:
    """UDA_TPU_LOCKDEP=1 (or true/yes/on) arms the validator for the
    whole process."""
    return _env_flag("UDA_TPU_LOCKDEP")


def racedet_enabled_from_env() -> bool:
    """UDA_TPU_RACEDET=1 (or true/yes/on) arms the Eraser state machine
    for the whole process."""
    return _env_flag("UDA_TPU_RACEDET")


class LockDep:
    """The order graph + per-thread held stacks. One global instance
    (:data:`lockdep`) serves every TrackedLock by default; tests that
    SEED inversions use private instances so fixture cycles never
    pollute the real code's zero-cycle invariant (or its metrics)."""

    def __init__(self, enabled: Optional[bool] = None,
                 emit_metrics: bool = False):
        self.enabled = (lockdep_enabled_from_env() if enabled is None
                        else bool(enabled))
        self.emit_metrics = emit_metrics
        self._mu = threading.Lock()   # guards the graph (deliberately a
        # raw lock: the validator must not validate itself)
        self._tls = threading.local()
        # edge (held_class, acquired_class) -> stack where first seen,
        # plus the incremental adjacency the cycle DFS walks (a cycle
        # can only APPEAR when a new edge is inserted, so the check —
        # and the stack capture feeding it — run only then)
        self._edges: Dict[Tuple[str, str], str] = {}
        self._adj: Dict[str, List[str]] = {}
        self._reported: set = set()   # cycle keys already reported
        self.cycles: List[dict] = []  # cycle reports (see _report)
        # thread ident -> (thread name, held classes): the cross-thread
        # mirror of the per-thread held stacks (tls is invisible from
        # other threads, and the watchdog dumps from its own)
        self._held_all: Dict[int, Tuple[str, List[str]]] = {}

    # -- per-thread held stack ----------------------------------------------

    def _held(self) -> List["TrackedLock"]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_by_thread(self) -> Dict[str, List[str]]:
        """thread label -> held lock classes, every thread that holds
        anything (the watchdog dump's lock table). Best-effort: the
        table mutates concurrently, but a wedged thread's entry is
        static — which is exactly the one a stall dump needs."""
        with self._mu:
            snap = dict(self._held_all)
        return {f"{name} (ident {tid})": list(classes)
                for tid, (name, classes) in snap.items() if classes}

    def _publish_held(self, held: List["TrackedLock"]) -> None:
        """Mirror this thread's held stack into the global table the
        watchdog can read from another thread."""
        t = threading.current_thread()
        with self._mu:
            if held:
                self._held_all[t.ident] = (t.name,
                                           [lk.name for lk in held])
            else:
                self._held_all.pop(t.ident, None)

    # -- events --------------------------------------------------------------

    def before_acquire(self, lock: "TrackedLock") -> None:
        """Pre-acquire check: re-acquiring the same non-reentrant
        instance is a self-deadlock — report BEFORE blocking on it, or
        the report would never be written."""
        held = self._held()
        if any(lk is lock for lk in held):
            self._report(
                kind="self-deadlock", path=[lock.name, lock.name],
                stacks={"acquire": "".join(traceback.format_stack()[:-2])},
                note=f"thread re-acquires non-reentrant lock "
                     f"{lock.name!r} it already holds")

    def note_acquire(self, lock: "TrackedLock") -> None:
        held = self._held()
        if not getattr(self._tls, "reporting", False):
            cur_stack: Optional[str] = None
            for h in held:
                if h.name == lock.name:
                    continue  # same-class nesting: see module docstring
                edge = (h.name, lock.name)
                # unlocked membership probe: a steady-state nested
                # acquire (edge already recorded) must not pay stack
                # capture + DFS on every pass through a hot path; the
                # rare lost race just re-checks under _mu in _add_edge
                if edge in self._edges:
                    continue
                if cur_stack is None:
                    cur_stack = "".join(traceback.format_stack()[:-2])
                self._add_edge(edge, cur_stack)
        held.append(lock)
        self._publish_held(held)

    def note_release(self, lock: "TrackedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                break
        self._publish_held(held)

    # -- the graph -----------------------------------------------------------

    def _add_edge(self, edge: Tuple[str, str], stack: str) -> None:
        a, b = edge
        with self._mu:
            if edge in self._edges:
                return  # raced with another thread: already analyzed
            self._edges[edge] = stack
            self._adj.setdefault(a, []).append(b)
            # a cycle exists iff b already reaches a — and only a NEW
            # edge can create one, so this DFS runs once per edge ever
            path = self._find_path(b, a)
        if path is not None:
            stacks = {f"{x}->{y}": self._edges.get((x, y), "")
                      for x, y in zip(path, path[1:])}
            stacks[f"{a}->{b} (now)"] = stack
            self._report(kind="order-inversion",
                         path=[a, b] + path[1:],
                         stacks=stacks,
                         note=f"acquiring {b!r} while holding {a!r}, "
                              f"but {b!r} already reaches {a!r} via "
                              f"{' -> '.join(path)}")

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src -> dst over recorded edges (caller holds _mu)."""
        stack = [(src, [src])]
        seen = {src}
        adj = self._adj
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- reporting -----------------------------------------------------------

    def _report(self, kind: str, path: List[str], stacks: Dict[str, str],
                note: str) -> None:
        key = (kind, tuple(sorted(set(path))))
        with self._mu:
            if key in self._reported:
                return
            self._reported.add(key)
            rep = {"kind": kind, "path": path, "note": note,
                   "stacks": stacks}
            self.cycles.append(rep)
        # everything below may take tracked locks (metrics, the
        # logger): the reporting flag keeps the recursion out of the
        # graph without breaking held-stack symmetry
        self._tls.reporting = True
        try:
            lines = [f"LOCKDEP: potential deadlock ({kind}): {note}"]
            for label, stk in stacks.items():
                if stk:
                    lines.append(f"-- first seen {label} --\n{stk}")
            text = "\n".join(lines)
            try:
                from uda_tpu_torch.utils.logging import get_logger
                get_logger().error(text)
            except Exception:  # noqa: BLE001 - the report must survive
                print(text)    # a half-imported logging module
            if self.emit_metrics:
                try:
                    from uda_tpu_torch.utils.metrics import metrics
                    metrics.add("lockdep.cycles")
                except Exception as e:  # noqa: BLE001
                    print(f"lockdep: metrics unavailable: {e}")
                out = os.environ.get("UDA_TPU_LOCKDEP_JSON")
                if out:
                    try:
                        with open(out, "a") as f:
                            f.write(json.dumps(
                                {"kind": kind, "path": path,
                                 "note": note}) + "\n")
                    except OSError as e:
                        print(f"lockdep: cannot append {out}: {e}")
        finally:
            self._tls.reporting = False

    def reset(self) -> None:
        """Forget edges, cycles and dedup state (tests). Held stacks
        are per-thread and survive — they describe reality, not
        history."""
        with self._mu:
            self._edges.clear()
            self._adj.clear()
            self._reported.clear()
            self.cycles.clear()


lockdep = LockDep(emit_metrics=True)


class TrackedLock:
    """``threading.Lock`` with lockdep class tracking. The ``name`` is
    the lock CLASS (shared by every instance guarding the same kind of
    state — 'segment.state', 'net.conn', ...), exactly like lockdep
    keys classes, not instances."""

    __slots__ = ("_lock", "name", "_dep")

    def __init__(self, name: str, dep: Optional[LockDep] = None):
        self._lock = threading.Lock()
        self.name = name
        self._dep = dep if dep is not None else lockdep

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        dep = self._dep
        if dep.enabled and blocking:
            # self-deadlock pre-check only for acquires that would WAIT:
            # a non-blocking try-acquire of a held lock just returns
            # False — a legitimate pattern, not a wedge
            dep.before_acquire(self)
        got = self._lock.acquire(blocking, timeout)
        if got and dep.enabled:
            dep.note_acquire(self)
        if got and _race_tracking.on:
            _race_tracking.note_acquire(self)
        return got

    def release(self) -> None:
        self._lock.release()
        if self._dep.enabled:
            self._dep.note_release(self)
        if _race_tracking.on:
            _race_tracking.note_release(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r})"


class TrackedCondition:
    """``threading.Condition`` over a :class:`TrackedLock`. ``wait``
    really releases the lock, so the held stack drops the entry for the
    duration — a waiter parked in ``cv.wait`` does NOT order-constrain
    locks acquired by the threads that will wake it."""

    def __init__(self, lock: Optional[TrackedLock] = None,
                 name: str = "cond", dep: Optional[LockDep] = None):
        self._tlock = lock if lock is not None else TrackedLock(name, dep)
        self._cond = threading.Condition(self._tlock._lock)

    @property
    def name(self) -> str:
        return self._tlock.name

    def acquire(self, *args, **kwargs) -> bool:
        return self._tlock.acquire(*args, **kwargs)

    def release(self) -> None:
        self._tlock.release()

    def __enter__(self) -> "TrackedCondition":
        self._tlock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._tlock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        dep = self._tlock._dep
        if dep.enabled:
            dep.note_release(self._tlock)
        if _race_tracking.on:
            _race_tracking.note_release(self._tlock)
        try:
            return self._cond.wait(timeout)
        finally:
            if dep.enabled:
                dep.note_acquire(self._tlock)
            if _race_tracking.on:
                _race_tracking.note_acquire(self._tlock)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        dep = self._tlock._dep
        if dep.enabled:
            dep.note_release(self._tlock)
        if _race_tracking.on:
            _race_tracking.note_release(self._tlock)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            if dep.enabled:
                dep.note_acquire(self._tlock)
            if _race_tracking.on:
                _race_tracking.note_acquire(self._tlock)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"TrackedCondition({self._tlock.name!r})"


# ---------------------------------------------------------------------------
# The runtime race detector (udarace, the dynamic half of UDA201-203):
# a sampling Eraser lockset state machine over the attributes
# race_instrument() hooks. Per (object, attr) the machine walks
# virgin -> exclusive -> shared -> shared-modified exactly like Eraser
# (Savage et al.): the first thread owns the field without lockset
# constraints (init-then-publish is legal); the moment a SECOND thread
# touches it, the candidate lockset starts as the locks that thread
# holds and every later access intersects it; an empty candidate set on
# a shared-modified field is a data race, reported once per
# (class, attr) with BOTH stacks — the current access and the most
# recent access from the other thread — like lockdep's cycle reports.
# ---------------------------------------------------------------------------

_EXCLUSIVE, _SHARED, _SHARED_MOD = 0, 1, 2


class _RaceState:
    """Per-(object, attr) machine state. ``lockset`` is None while the
    field is still thread-exclusive (the Eraser 'universe' — no
    constraint yet) and a set of lock ids once shared."""

    __slots__ = ("state", "owner", "lockset", "prev", "prev_cross")

    def __init__(self, owner: int):
        self.state = _EXCLUSIVE
        self.owner = owner
        self.lockset: Optional[frozenset] = None
        # (thread ident, thread name, op, stack) of the last sampled
        # access, and of the last one from a DIFFERENT thread than the
        # current accessor — the "other side" of a race report
        self.prev: Optional[Tuple[int, str, str, str]] = None
        self.prev_cross: Optional[Tuple[int, str, str, str]] = None


class _RaceTracking:
    """Shared held-lock bookkeeping: per-thread held sets are a fact
    about THREADS, not about any one detector, so every RaceDetector
    (the global one and the private test instances) reads the same
    table. TrackedLock feeds it whenever any enabled detector exists —
    one attribute check (``_race_tracking.on``) on the disabled path."""

    def __init__(self):
        self.on = False
        self._tls = threading.local()

    def held(self) -> Dict[int, str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = {}
        return held

    def note_acquire(self, lock: "TrackedLock") -> None:
        self.held()[id(lock)] = lock.name

    def note_release(self, lock: "TrackedLock") -> None:
        self.held().pop(id(lock), None)


_race_tracking = _RaceTracking()


class RaceDetector:
    """The Eraser machine. One global instance (:data:`racedet`) serves
    every race_instrument() hook; tests that SEED races use private
    instances so fixture races never pollute the real code's zero-race
    invariant (mirroring LockDep's private-instance discipline). All
    instances share the per-thread held-lock table TrackedLock feeds
    (:class:`_RaceTracking`)."""

    def __init__(self, enabled: Optional[bool] = None,
                 emit_metrics: bool = False,
                 sample: Optional[int] = None):
        self.enabled = (racedet_enabled_from_env() if enabled is None
                        else bool(enabled))
        self.emit_metrics = emit_metrics
        if sample is None:
            sample = int(os.environ.get("UDA_TPU_RACEDET_SAMPLE", "1")
                         or "1")
        self.sample = max(1, sample)
        self._mu = threading.Lock()   # raw: must not validate itself
        self._tls = threading.local()
        self._state: Dict[Tuple[int, str], _RaceState] = {}
        self._reported: set = set()
        self.races: List[dict] = []
        if self.enabled:
            _race_tracking.on = True

    # -- per-thread held-lock set (fed by TrackedLock) -----------------------

    def _held(self) -> Dict[int, str]:
        return _race_tracking.held()

    def note_acquire(self, lock: "TrackedLock") -> None:
        _race_tracking.note_acquire(lock)

    def note_release(self, lock: "TrackedLock") -> None:
        _race_tracking.note_release(lock)

    # -- the machine ---------------------------------------------------------

    def access(self, obj, attr: str, is_write: bool) -> None:
        """One sampled access to an instrumented attribute. The caller
        (the race_instrument property) already checked ``enabled``."""
        if getattr(self._tls, "busy", False):
            return  # a report in progress touches instrumented state
        if self.sample > 1:
            n = getattr(self._tls, "n", 0) + 1
            self._tls.n = n
            if n % self.sample:
                return
        tid = threading.get_ident()
        held = frozenset(self._held())
        key = (id(obj), attr)
        race_note = None
        with self._mu:
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = _RaceState(tid)
                # record the birth access: it is the "other side" of
                # the first cross-thread race report (usually the
                # init-then-publish write in __init__)
                st.prev = (tid, threading.current_thread().name,
                           "write" if is_write else "read",
                           "".join(traceback.format_stack()[:-2]))
                return
            op = "write" if is_write else "read"
            stack = "".join(traceback.format_stack()[:-2])
            rec = (tid, threading.current_thread().name, op, stack)
            if st.prev is not None and st.prev[0] != tid:
                st.prev_cross = st.prev
            if st.state == _EXCLUSIVE and tid == st.owner:
                # still single-threaded: no lockset constraint, but
                # remember the stack — it is the "other side" the first
                # cross-thread race report needs
                st.prev = rec
                return
            # second thread (or already shared): intersect candidates
            st.lockset = (held if st.lockset is None
                          else st.lockset & held)
            if is_write or st.state == _SHARED_MOD:
                st.state = _SHARED_MOD
            else:
                st.state = _SHARED
            st.prev = rec
            if st.state == _SHARED_MOD and not st.lockset:
                race_note = (type(obj).__name__, rec, st.prev_cross)
        if race_note is not None:
            cls_name, rec, cross = race_note
            stacks = {f"{rec[2]} on {rec[1]} (now)": rec[3]}
            if cross is not None:
                stacks[f"{cross[2]} on {cross[1]}"] = cross[3]
            self._report(cls_name, attr, stacks)

    # -- reporting -----------------------------------------------------------

    def _report(self, cls_name: str, attr: str,
                stacks: Dict[str, str]) -> None:
        key = (cls_name, attr)
        with self._mu:
            if key in self._reported:
                return
            self._reported.add(key)
            note = (f"{cls_name}.{attr} is written from multiple "
                    f"threads with no consistently held lock")
            rep = {"class": cls_name, "attr": attr, "note": note,
                   "stacks": stacks}
            self.races.append(rep)
        self._tls.busy = True
        try:
            lines = [f"RACEDET: data race: {note}"]
            for label, stk in stacks.items():
                if stk:
                    lines.append(f"-- {label} --\n{stk}")
            text = "\n".join(lines)
            try:
                from uda_tpu_torch.utils.logging import get_logger
                get_logger().error(text)
            except Exception:  # noqa: BLE001 - the report must survive
                print(text)    # a half-imported logging module
            if self.emit_metrics:
                try:
                    from uda_tpu_torch.utils.metrics import metrics
                    metrics.add("racedet.races")
                except Exception as e:  # noqa: BLE001
                    print(f"racedet: metrics unavailable: {e}")
                out = os.environ.get("UDA_TPU_RACEDET_JSON")
                if out:
                    try:
                        # one compact line per race: the chaos ladder
                        # greps these; stacks stay in the log/report
                        with open(out, "a") as f:
                            f.write(json.dumps(
                                {"class": cls_name, "attr": attr,
                                 "note": note}) + "\n")
                    except OSError as e:
                        print(f"racedet: cannot append {out}: {e}")
        finally:
            self._tls.busy = False

    def reset(self) -> None:
        """Forget machine state, reports and dedup keys (tests). Held
        sets are per-thread reality and survive."""
        with self._mu:
            self._state.clear()
            self._reported.clear()
            self.races.clear()


racedet = RaceDetector(emit_metrics=True)


# module qualname -> instrumented attrs: ALWAYS recorded (armed or
# not) so the static<->runtime lockstep test can compare this registry
# against analysis/threads.py RUNTIME_INSTRUMENTED without re-importing
# the world under UDA_TPU_RACEDET=1
RACE_INSTRUMENTED: Dict[str, Tuple[str, ...]] = {}


def race_instrument(*attrs: str, det: Optional[RaceDetector] = None):
    """Class decorator hooking ``attrs`` into the race detector.

    Zero-overhead-when-off contract, stricter than lockdep's: with
    ``UDA_TPU_RACEDET`` unset the class is returned UNTOUCHED — plain
    attributes, no descriptor in the lookup path — so the hot tables
    (conn maps, staging ladders, credit ledgers) pay nothing. Armed,
    each attr becomes a property whose fast path is one ``enabled``
    check before the instance-dict access; every read/write feeds
    :meth:`RaceDetector.access`. Incompatible with ``__slots__`` on
    the decorated class (the hooks store through the instance dict)."""

    def deco(cls):
        d = det if det is not None else racedet
        RACE_INSTRUMENTED[f"{cls.__module__}.{cls.__qualname__}"] = attrs
        if not d.enabled:
            return cls
        if "__slots__" in cls.__dict__:
            raise TypeError(
                f"race_instrument: {cls.__name__} declares __slots__; "
                f"the hooks need an instance dict")
        for name in attrs:
            def _mk(name=name):
                def _get(self):
                    if d.enabled:
                        d.access(self, name, False)
                    return self.__dict__[name]

                def _set(self, value):
                    if d.enabled:
                        d.access(self, name, True)
                    self.__dict__[name] = value

                def _del(self):
                    if d.enabled:
                        d.access(self, name, True)
                    del self.__dict__[name]

                return property(_get, _set, _del)
            setattr(cls, name, _mk())
        return cls

    return deco
