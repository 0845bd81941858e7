"""The port's lockdep and race detector (``uda_tpu_torch.utils.locks``)
against the JAX package's ``uda_tpu.utils.locks``: the same acquisition
sequences give the same cycle reports by class name, the same race
reports by (class, attribute), and the tracked primitives keep
``threading`` semantics. Private ``LockDep``/``RaceDetector`` instances
keep seeded inversions out of the process-wide books, as the reference's
tests do."""

import threading
import time

import pytest

from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu.utils import locks as jlocks
from uda_tpu_torch.utils import locks as tlocks
from uda_tpu_torch.utils import watchdog as twatchdog

SIDES = (jlocks, tlocks)

# lock-order sequences: each is a list of acquisition paths (outer lock
# first), run one after another on one thread
SEQUENCES = {
    "two-order": [["a", "b"], ["b", "a"]],
    "chain-of-three": [["a", "b"], ["b", "c"], ["c", "a"]],
    "consistent": [["a", "b", "c"], ["a", "c"], ["b", "c"]],
    "same-class-nesting": [["a", "a2"], ["x", "y"]],
    "diamond": [["a", "b"], ["a", "c"], ["b", "d"], ["c", "d"], ["d", "a"]],
    "deep-inversion": [["p", "q", "r", "s"], ["s", "p"]],
}


def _run(mod, seq):
    """Run ``seq`` on a private armed LockDep; each name is a lock class
    (``a2`` is a second instance of class ``a``). Returns the reports
    without their stacks."""
    dep = mod.LockDep(enabled=True)
    locks = {}
    for path in seq:
        for name in path:
            if name not in locks:
                cls = "a" if name == "a2" else name
                locks[name] = mod.TrackedLock(cls, dep)
    for path in seq:
        held = []
        for name in path:
            locks[name].acquire()
            held.append(locks[name])
        for lk in reversed(held):
            lk.release()
    return [{k: v for k, v in c.items() if k != "stacks"}
            for c in dep.cycles], sorted(dep._edges)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_cycle_reports_match_reference(name):
    ref = _run(jlocks, SEQUENCES[name])
    port = _run(tlocks, SEQUENCES[name])
    assert port == ref
    if name in ("two-order", "chain-of-three", "diamond", "deep-inversion"):
        assert port[0] and port[0][0]["kind"] == "order-inversion"
    else:
        assert not port[0]


def test_self_deadlock_report_matches_reference():
    reports = []
    for mod in SIDES:
        dep = mod.LockDep(enabled=True)
        lk = mod.TrackedLock("solo", dep)
        lk.acquire()
        # the pre-acquire check reports before blocking; the bounded
        # acquire then times out instead of wedging the test
        assert lk.acquire(timeout=0.05) is False
        # a non-blocking try-acquire of a held lock is legal, not a wedge
        assert lk.acquire(blocking=False) is False
        lk.release()
        reports.append([(c["kind"], c["path"], c["note"])
                        for c in dep.cycles])
    assert reports[0] == reports[1]
    assert reports[1] == [("self-deadlock", ["solo", "solo"],
                           "thread re-acquires non-reentrant lock 'solo' "
                           "it already holds")]


def test_off_by_default_and_env_switch(monkeypatch):
    for mod in SIDES:
        monkeypatch.delenv("UDA_TPU_LOCKDEP", raising=False)
        monkeypatch.delenv("UDA_TPU_RACEDET", raising=False)
        assert not mod.LockDep().enabled
        assert not mod.RaceDetector().enabled
        monkeypatch.setenv("UDA_TPU_LOCKDEP", "on")
        monkeypatch.setenv("UDA_TPU_RACEDET", "1")
        assert mod.LockDep().enabled
        assert mod.lockdep_enabled_from_env()
        assert mod.racedet_enabled_from_env()


def test_cycle_json_lines_and_counter(tmp_path, monkeypatch):
    """The process-wide instance counts lockdep.cycles and appends one
    JSON line per report to UDA_TPU_LOCKDEP_JSON, in both packages."""
    import json

    from uda_tpu.utils.metrics import metrics as jmetrics
    from uda_tpu_torch.utils.metrics import metrics as tmetrics

    lines = []
    for mod, m in ((jlocks, jmetrics), (tlocks, tmetrics)):
        out = tmp_path / f"{mod.__name__}.jsonl"
        monkeypatch.setenv("UDA_TPU_LOCKDEP_JSON", str(out))
        dep = mod.LockDep(enabled=True, emit_metrics=True)
        a, b = mod.TrackedLock("ja", dep), mod.TrackedLock("jb", dep)
        with a, b:
            pass
        with b, a:
            pass
        assert m.get("lockdep.cycles") == 1
        lines.append([json.loads(x) for x in out.read_text().splitlines()])
    assert lines[0] == lines[1] and len(lines[1]) == 1


def test_condition_keeps_threading_semantics():
    """wait() drops the lock (and lockdep's held entry) and reacquires
    it; wait_for sees the predicate; notify wakes one waiter: the
    overlapped merger's in-flight budget waits on exactly this."""
    for mod in SIDES:
        dep = mod.LockDep(enabled=True)
        cv = mod.TrackedCondition(mod.TrackedLock("stage.inflight", dep))
        other = mod.TrackedLock("other", dep)
        state = {"n": 0}
        held_while_waiting = []

        def waiter():
            with cv:
                assert cv.wait_for(lambda: state["n"] >= 2, timeout=5)
                held_while_waiting.append(
                    [lk.name for lk in dep._held()])

        t = threading.Thread(target=waiter)
        t.start()
        for _ in range(2):
            time.sleep(0.02)
            # taking another class while the waiter is parked adds no
            # order edge: a parked waiter holds nothing
            with other, cv:
                state["n"] += 1
                cv.notify()
        t.join(5)
        assert not t.is_alive()
        assert held_while_waiting == [["stage.inflight"]]
        assert not dep.cycles
        assert ("other", "stage.inflight") in dep._edges
        with cv:
            assert cv.wait(timeout=0.01) is False
        assert cv.name == "stage.inflight"


def _race_run(mod, guarded: bool):
    det = mod.RaceDetector(enabled=True)

    @mod.race_instrument("table", det=det)
    class Shared:
        def __init__(self):
            self.table = {}

    lock = mod.TrackedLock("shared.guard")
    obj = Shared()

    def writer(k):
        for i in range(20):
            if guarded:
                with lock:
                    obj.table = dict(obj.table, **{f"{k}{i}": i})
            else:
                obj.table = dict(obj.table, **{f"{k}{i}": i})

    ts = [threading.Thread(target=writer, args=(k,)) for k in "xy"]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    det.enabled = False
    mod._race_tracking.on = False
    return [(r["class"], r["attr"], r["note"]) for r in det.races]


@pytest.mark.parametrize("guarded", [False, True])
def test_race_reports_match_reference(guarded):
    ref = _race_run(jlocks, guarded)
    port = _race_run(tlocks, guarded)
    assert port == ref
    assert bool(port) is (not guarded)


def test_race_instrumented_registry_matches_reference():
    """The attributes the race detector hooks are the reference's, class
    by class (recorded armed or not)."""
    import uda_tpu.mofserver.store  # noqa: F401
    import uda_tpu.net.push  # noqa: F401
    import uda_tpu.tenant.sched  # noqa: F401
    import uda_tpu_torch.mofserver.store  # noqa: F401
    import uda_tpu_torch.net.push  # noqa: F401
    import uda_tpu_torch.tenant.sched  # noqa: F401

    def table(reg, prefix):
        return {k[len(prefix):]: v for k, v in reg.items()
                if k.startswith(prefix)}

    ref = table(jlocks.RACE_INSTRUMENTED, "uda_tpu.")
    port = table(tlocks.RACE_INSTRUMENTED, "uda_tpu_torch.")
    assert port == ref
    assert set(port) == {"mofserver.store.StoreManager",
                         "net.push.PushStaging", "net.push.PushScheduler",
                         "tenant.sched.CreditScheduler"}


def test_lock_classes_at_the_reference_sites():
    """Every lock class the reference tracks is tracked in the port, and
    the port tracks no other (the 26 sites of both packages)."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent

    def classes(pkg):
        out = []
        for p in sorted((root / pkg).rglob("*.py")):
            if p.name == "locks.py" or "analysis" in p.parts:
                continue
            for node in ast.walk(ast.parse(p.read_text())):
                if isinstance(node, ast.Call) and getattr(
                        node.func, "id", "") in ("TrackedLock",
                                                 "TrackedCondition") \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant):
                    out.append(node.args[0].value)
        return sorted(out)

    assert classes("uda_tpu_torch") == classes("uda_tpu")


def test_watchdog_dump_carries_the_lock_table(monkeypatch):
    """The stall dump lists each thread's held lock classes and the
    cycles seen so far while lockdep is armed."""
    dep = tlocks.lockdep
    monkeypatch.setattr(dep, "enabled", True)
    a = tlocks.TrackedLock("dump.outer")
    b = tlocks.TrackedLock("dump.inner")
    with a, b:
        text = twatchdog.dump_diagnostics("test")
    assert "--- tracked locks held (1 threads) ---" in text
    assert "dump.outer -> dump.inner" in text
    with b, a:  # the inversion: reported, then listed
        text = twatchdog.dump_diagnostics("test")
    assert "lockdep cycles" in text and "order-inversion" in text
    dep.reset()
