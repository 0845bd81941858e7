"""The thread-root registry for the udarace lockset tier.

Eraser-style lockset inference (uda_tpu_torch/analysis/race.py) is only as
good as its model of WHICH code runs on which thread. This module is
that model, in one auditable place: every thread entry point the
package spawns — the event-loop/dispatcher pair, the MOF writer router,
the merge pool workers, the overlap stage pool, the push scheduler's
completion callbacks, the spill ladder, and the daemon herd (watchdog,
profiler, StatsReporter, time-series rollup, scrub, tuncache,
openmetrics) — is DECLARED here as a :class:`ThreadRoot`, keyed by the
defining file and function name, exactly like the reference annotated
its pthread entry points in RDMAComm.cc comment blocks (only here the
table is machine-read, not prose).

The static tier walks the intra-package call graph from these roots
(plus the roots it auto-detects: ``Thread(target=...)`` spawn sites,
``@loop_callback`` bodies, ``call_soon``/``submit``/
``add_done_callback`` marshalling) and marks every function with the
set of roots that reach it. A ``self.<attr>`` touched from two or more
distinct roots is cross-thread shared state and must carry a
consistent lockset — or a justified ``# udarace: lockfree=`` waiver.

The runtime half mirrors the static one: :data:`RUNTIME_INSTRUMENTED`
declares, per hot class, the attributes ``utils/locks.py`` hooks with
its sampling Eraser state machine under ``UDA_TPU_RACEDET=1``. The
static↔runtime lockstep test (the port's analysis tests) fails the build
when the runtime instruments a class this table does not declare — the
two inventories must never drift.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ThreadRoot", "THREAD_ROOTS", "LOOP_ROOT", "POOL_ROOT",
           "RUNTIME_INSTRUMENTED", "declared_root"]


@dataclasses.dataclass(frozen=True)
class ThreadRoot:
    """One declared thread entry point.

    ``root`` is the thread identity the race tier reasons about (two
    accesses race only when their reaching-root sets differ); ``file``
    is a repo-relative path suffix and ``func`` the entry function's
    name — together they pin the declaration to one def without
    hardcoding line numbers.
    """

    root: str   # thread identity, e.g. "net.loop"
    file: str   # path suffix of the defining module
    func: str   # entry function name (bare, no class qualifier)
    note: str   # what runs here (documentation, lint report context)


# The shared event-loop thread identity: `@loop_callback` bodies and
# everything marshalled onto the loop via `call_soon` runs here.
LOOP_ROOT = "net.loop"
# The engine/executor pool identity: `submit()` fns and
# `add_done_callback` completions run on some pool worker.
POOL_ROOT = "pool"

THREAD_ROOTS: Tuple[ThreadRoot, ...] = (
    # -- the data-plane event loop + its dispatcher -----------------------
    ThreadRoot(LOOP_ROOT, "net/evloop.py", "_run",
               "the selectors event-loop thread (all @loop_callback "
               "bodies and call_soon thunks run here)"),
    ThreadRoot("net.dispatcher", "net/evloop.py", "_dispatch_loop",
               "the completion dispatcher thread (potentially-blocking "
               "upcalls marshalled off the loop)"),
    ThreadRoot("net.drain", "net/server.py", "drain",
               "per-connection drain helper thread (warm handoff)"),
    # -- supplier storage / MOF plane ------------------------------------
    ThreadRoot("engine.router", "mofserver/data_engine.py", "_route",
               "the native-read completion router thread "
               "(_NativeReads: wakes submitters by tag)"),
    ThreadRoot("app.producer", "mofserver/writer.py", "write",
               "map-task producer thread(s): MOFWriter.write -> "
               "account_write -> spill ladder runs on each concurrent "
               "writer's own thread (bench/chaos drivers spawn several)"),
    ThreadRoot("app.control", "net/server.py", "announce_drain",
               "operator control-plane entry: the elastic drain API is "
               "invoked from the application main thread, concurrent "
               "with the data plane it drains"),
    # -- merge/overlap pools ---------------------------------------------
    ThreadRoot(POOL_ROOT, "ops/merge.py", "_part",
               "merge pool worker threads"),
    ThreadRoot("merge.overlap.worker", "merger/overlap.py",
               "_worker_loop", "overlap stage pool workers"),
    ThreadRoot("merge.overlap.consumer", "merger/overlap.py",
               "_consumer_loop", "overlap stage consumer thread"),
    ThreadRoot("merge.overlap.feeder", "merger/overlap.py", "_loop",
               "overlap feeder thread"),
    ThreadRoot("bridge.merge", "bridge/bridge.py", "_merge_main",
               "bridge-side merge thread"),
    ThreadRoot("bridge.merge", "tools/net_smoke.py", "run_reduce",
               "the net smoke's reduce-task threads: each drives its own "
               "MergeManager, the role of the bridge's merge thread"),
    # -- daemons ---------------------------------------------------------
    ThreadRoot("coding.scrub", "coding/scrub.py", "_run",
               "background parity scrub daemon"),
    ThreadRoot("watchdog", "utils/watchdog.py", "_watch",
               "stall watchdog daemon"),
    ThreadRoot("obs.timeseries", "utils/timeseries.py", "_loop",
               "time-series rollup daemon"),
    ThreadRoot("obs.stats", "utils/stats.py", "_loop",
               "StatsReporter daemon"),
    ThreadRoot("obs.openmetrics", "utils/openmetrics.py", "do_GET",
               "openmetrics exporter: ThreadingHTTPServer runs stdlib "
               "serve_forever; the in-tree code on those per-request "
               "threads is the handler's do_GET"),
    ThreadRoot("profiler", "utils/profiler.py", "_run",
               "sampling profiler daemon"),
    ThreadRoot("tuncache", "utils/tuncache.py", "_run",
               "tuning-cache writeback daemon"),
)


def declared_root(file_rel: str, func: str) -> Optional[ThreadRoot]:
    """The declared root whose (file suffix, function name) matches, or
    None. Path separators are normalized by the caller (the lint engine
    hands repo-relative forward-slash paths)."""
    for tr in THREAD_ROOTS:
        if func == tr.func and file_rel.endswith(tr.file):
            return tr
    return None


# -- the static <-> runtime lockstep inventory -------------------------------
#
# Per hot class (dotted module path -> class -> instrumented attrs):
# the EXACT attributes utils/locks.py race_instrument() hooks when
# UDA_TPU_RACEDET=1 is armed. The conn tables, staging ladders and
# credit ledgers here are the attributes the static tier convicted (or
# proved guarded) in this tree — the runtime machine re-checks the same
# state under chaos scheduling, and the lockstep test fails when
# the runtime hooks a class/attr this table does not declare.
RUNTIME_INSTRUMENTED: Dict[str, Tuple[str, ...]] = {
    # supplier push plane: subscription/commit/inflight tables mutated
    # by the loop thread, the MOFWriter thread and pool completions
    "uda_tpu_torch.net.push.PushScheduler": ("_subs", "_commits", "_inflight"),
    # reduce-side staging ladder: loop-thread offers vs merge-side takes
    "uda_tpu_torch.net.push.PushStaging": ("_maps",),
    # MOF store: migration log appended by the spill ladder (writer
    # thread) and drain/validate paths, read by snapshot/stats threads
    "uda_tpu_torch.mofserver.store.StoreManager": ("_migrations",),
    # WDRR credit ledger: loop-thread-confined BY DESIGN (no locks) —
    # instrumented so the runtime machine PROVES the confinement under
    # chaos instead of trusting the docstring
    "uda_tpu_torch.tenant.sched.CreditScheduler": ("_tenants",),
}
