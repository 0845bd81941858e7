"""Merge manager: fetch scheduling + merge orchestration.

The port's copy of ``uda_tpu/merger/merge_manager.py``'s ``run``: every
``mapred.netmerger.merge.approach`` and every form of the online merge:

- approach 1, the online merge, in three forms
  (``merge_manager.py:1003-1132`` of the reference):

  - the default, ``uda.tpu.merge.overlap=true``: ``fetch_all`` feeds every
    completed segment to the overlapped merger
    (``uda_tpu_torch/merger/overlap.py``), which stages runs to the device
    and merges them there with K1 while later fetches are in flight, then
    ``emit_stream`` frames the result slab by slab; with
    ``uda.tpu.stage.pipeline`` (on by default) through a stage pool and
    one merge consumer, else on serial stage threads;
  - ``uda.tpu.online.streaming=true``: the same merger spools each segment
    to a sorted run file (``merger/streaming.RunStore`` under
    ``uda.tpu.spill.dirs``) and ``finish_streaming`` interleaves the
    files; with ``uda.tpu.ckpt.dir`` the runs spool into a crash-consistent
    checkpoint (``merger/checkpoint.py``) and a restarted task resumes
    from it, adopting the spooled runs and refetching none of them;
  - ``uda.tpu.merge.overlap=false``: ``fetch_all`` -> ``merge_segments``
    (the two-phase merge tree on K1, or the whole re-sort) ->
    ``emit_framed``;

- approach 2, the hybrid LPQ/RPQ merge (``merger/hybrid.py``);
- approach 0, the budget-aware router (``utils/budget.MemoryBudget.route``):
  hybrid, streaming, streaming with no device runs (over the device
  budget), or a refusal (over ``uda.tpu.budget.hard.mb``) that ends in
  ``FallbackSignal`` before anything is fetched.

``uda.tpu.watchdog.stall.s`` > 0 guards ``run()`` with a stall watchdog
(``utils/watchdog.py``) that turns a wedged task into
``FallbackSignal(StallError)``; ``uda.tpu.failpoints`` arms the port's
failpoint registry (``utils/failpoints.py``).

The fetch survives a bad supplier as the reference's does: every segment
shares the task's recovery ledger and climbs its ladder
(``merger/segment.Segment``): ``uda.tpu.fetch.speculate.pn`` issues a
duplicate fetch against a straggler (to a replica where the map entry
lists several hosts), ``uda.tpu.fetch.resume`` keeps the offset ledger
across a transport retry, and ``uda.tpu.coding.scheme=rs:k:n`` rebuilds a
partition whose primary stays dead from any k of its stripe's n chunks
(``coding/recovery``).

Equivalent of the reference's MergeManager (reference
src/Merger/MergeManager.cc): the fetch phase issues per-map fetch requests
in a seeded random order with a bounded in-flight window (the reference
shuffles its fetch list, MergeManager.cc:58-63, and bounds in-flight
fetches with RDMA credits); the merge phase produces the globally sorted
stream on the device and hands it to the consumer in
staging-buffer-sized IFile-framed blocks (MergeManager.cc:155-182).

The push plane (``uda.tpu.push.enable``, ``net/push.py``): ``arm_push``
(lazily at the start of ``fetch_all`` when the caller did not arm it
before the map phase) subscribes the supplier fleet with a
``PushStaging``; each segment, right before it starts, adopts its map's
staged prefix through ``Segment.ckpt_preload``, so pushed bytes enter the
offset ledger as a resumed fetch would and the pull path fetches the
rest. ``notify_join``/``notify_drain`` carry elastic membership to the
routing client and widen in-flight segments; a checkpoint resume first
revalidates the partitions an attached ``StoreManager`` spilled to its
blob tier.

On the card a ``uda.tpu.key.width`` above 112 bytes is refused at
construction wherever K1 would merge (its rows hold at most 31 words),
and left to the whole re-sort where it would not.
"""

from __future__ import annotations

import contextlib
import functools
import random
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional, Sequence

from uda_tpu_torch.coding import parse_domains, parse_scheme
from uda_tpu_torch.coding.recovery import StripeContext
from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.merger import checkpoint
from uda_tpu_torch.merger.emitter import FramedEmitter
from uda_tpu_torch.merger.hybrid import run_hybrid
from uda_tpu_torch.merger.overlap import OverlappedMerger
from uda_tpu_torch.merger.recovery import RecoveryLedger
from uda_tpu_torch.merger.segment import InputClient, Segment
from uda_tpu_torch.merger.streaming import RunStore, spill_dirs
from uda_tpu_torch.ops import merge as merge_ops
from uda_tpu_torch.ops.pallas_merge import MAX_COLS
from uda_tpu_torch.tenant import current_tenant
from uda_tpu_torch.utils.budget import MemoryBudget, stage_inflight_cap
from uda_tpu_torch.utils.comparators import KeyType, get_key_type
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (ConfigError, FallbackSignal,
                                        MergeError, StorageError, UdaError)
from uda_tpu_torch.utils.critpath import install_stats_provider
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.flightrec import flightrec, flightrec_enabled_from_env
from uda_tpu_torch.utils.ifile import RecordBatch
from uda_tpu_torch.utils.locks import TrackedLock
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import OpenTimer, metrics
from uda_tpu_torch.utils.profiler import profile_hz_from_env, profiler
from uda_tpu_torch.utils.retry import RetryPolicy, SpeculationPolicy
from uda_tpu_torch.utils.stats import (register_stats_provider,
                                       unregister_stats_provider)
from uda_tpu_torch.utils.watchdog import StallError, StallWatchdog

__all__ = ["MergeManager", "PenaltyBox"]

log = get_logger()

PROGRESS_INTERVAL = 20  # segments per progress report (MergeManager.cc:44)


def _refuse_wide_rows(cfg: Config, device) -> None:
    """On the card every form of ``run()`` but the whole re-sort merges
    runs with K1, whose rows (key words + 3) hold at most
    ``pallas_merge.MAX_COLS`` words: wider keys are refused here, before
    anything is fetched, not by a failed merge."""
    width = int(cfg.get("uda.tpu.key.width"))
    cols = width // 4 + merge_ops.ROW_EXTRA_COLS
    if resolve_device(device).type != "cuda" or cols <= MAX_COLS:
        return
    k1 = (cfg.get("uda.tpu.online.streaming")
          or cfg.get("uda.tpu.merge.overlap")
          or merge_ops.resolve_merge_mode(
              str(cfg.get("uda.tpu.merge.two_phase")), 2, device)
          == "two_phase")
    if k1:
        raise ConfigError(
            f"uda.tpu.key.width={width} gives K1 rows of {cols} words; the "
            f"card's merge carries at most {MAX_COLS} (widths up to "
            f"{4 * (MAX_COLS - merge_ops.ROW_EXTRA_COLS)} B)")


@contextlib.contextmanager
def _k1_errors(device) -> Iterator[None]:
    """Where the two-phase merge runs on K1 (the card), any failure of its
    device half (a launch, a shape K1 refuses, the kernels' build, a CUDA
    error) becomes a MergeError, which ``run()`` turns into
    FallbackSignal, as the overlapped merger's device errors do: no merge
    switches engine or device."""
    if merge_ops.resolve_run_engine("auto", device) != "pallas":
        yield
        return
    try:
        yield
    except UdaError:
        raise
    except Exception as e:
        raise MergeError(f"device merge on {device} failed: "
                         f"{type(e).__name__}: {e}") from e


class PenaltyBox:
    """Per-supplier fault tracker: a supplier whose fetches keep failing
    is *deprioritized* — its remaining maps rotate to the back of the
    fetch schedule. Boxing is never exclusion: when every pending supplier
    is boxed the scheduler proceeds anyway.

    Forgiveness DECAYS rather than resets: one success takes one fault
    off the record; only ``reset_successes`` CONSECUTIVE successes clear
    it outright."""

    def __init__(self, threshold: int = 2, penalty_s: float = 1.0,
                 reset_successes: int = 3):
        self.threshold = max(1, threshold)
        self.penalty_s = penalty_s
        self.reset_successes = max(1, reset_successes)
        self._lock = TrackedLock("penalty_box")
        self._faults: dict[str, int] = {}
        self._until: dict[str, float] = {}
        self._streak: dict[str, int] = {}  # consecutive successes

    def punish(self, key: str) -> bool:
        """Record one fault; returns True when this fault boxed the
        supplier (crossing the threshold, or extending an active box)."""
        with self._lock:
            self._streak.pop(key, None)  # a fault breaks the streak
            n = self._faults.get(key, 0) + 1
            self._faults[key] = n
            if n < self.threshold:
                return False
            self._until[key] = time.monotonic() + self.penalty_s
        tenant = current_tenant()
        if tenant:
            metrics.add("fetch.penalties", supplier=key, tenant=tenant)
        else:
            metrics.add("fetch.penalties", supplier=key)
        return True

    def forgive(self, key: str) -> None:
        """One success decays the fault record one step (and unboxes a
        supplier that dropped below the threshold); the record clears
        entirely after ``reset_successes`` consecutive successes."""
        with self._lock:
            n = self._faults.get(key)
            if n is None:
                return
            streak = self._streak.get(key, 0) + 1
            n = max(0, n - 1)
            if streak >= self.reset_successes or n == 0:
                self._faults.pop(key, None)
                self._until.pop(key, None)
                self._streak.pop(key, None)
                return
            self._streak[key] = streak
            self._faults[key] = n
            if n < self.threshold:
                self._until.pop(key, None)

    def faults(self, key: str) -> int:
        with self._lock:
            return self._faults.get(key, 0)

    def rank(self, keys) -> list:
        """``keys`` healthiest-first: unboxed before boxed, fewer faults
        before more, stable otherwise (the caller's preference order
        breaks ties). Read-only: no parole side effects."""
        with self._lock:
            now = time.monotonic()

            def score(k):
                t = self._until.get(k)
                return (1 if (t is not None and t > now) else 0,
                        self._faults.get(k, 0))

            return sorted(keys, key=score)

    def penalized(self, key: str) -> bool:
        with self._lock:
            t = self._until.get(key)
            if t is None:
                return False
            if time.monotonic() >= t:
                # parole: out of the box, but one more fault re-boxes
                del self._until[key]
                self._faults[key] = self.threshold - 1
                return False
            return True

    @property
    def boxed(self) -> list[str]:
        """The suppliers boxed right now."""
        with self._lock:
            now = time.monotonic()
            return [k for k, t in self._until.items() if t > now]

    def snapshot(self) -> dict:
        """Fault counts, success streaks and who is boxed now (a
        checkpoint manifest's ``penalty``)."""
        with self._lock:
            now = time.monotonic()
            return {"faults": dict(self._faults),
                    "streaks": dict(self._streak),
                    "boxed": [k for k, t in self._until.items()
                              if t > now]}

    def restore(self, snap: dict) -> None:
        """Re-seed fault and streak records from a checkpoint manifest.
        Box timers are not restored (monotonic deadlines do not survive
        the process); a supplier at the threshold re-boxes on its next
        fault anyway."""
        with self._lock:
            for k, v in (snap.get("faults") or {}).items():
                self._faults[str(k)] = int(v)
            for k, v in (snap.get("streaks") or {}).items():
                self._streak[str(k)] = int(v)


class MergeManager:
    """Orchestrates fetch -> pack -> device merge -> framed emission for
    one reduce task. ``device`` (``None`` = the card) is where the merge
    runs; without a card pass ``device="cpu"``."""

    def __init__(self, client: InputClient, key_type: KeyType | str,
                 config: Optional[Config] = None,
                 progress: Optional[Callable[[int, int], None]] = None,
                 seed: int = 0, device=None):
        self.cfg = config or Config()
        self.device = resolve_device(device)
        self.client = client
        # fetch progress (done, total): every PROGRESS_INTERVAL fetched
        # segments and once when the fetch ends (MergeManager.cc:124-130)
        self.progress = progress
        self.key_type = (get_key_type(key_type) if isinstance(key_type, str)
                         else key_type)
        self.key_width = self.cfg.get("uda.tpu.key.width")
        _refuse_wide_rows(self.cfg, self.device)
        self.chunk_size = self.cfg.get("mapred.rdma.buf.size") * 1024
        self.window = max(1, self.cfg.get("mapred.rdma.wqe.per.conn"))
        self.seed = seed
        self.emitter = FramedEmitter(self.chunk_size)
        self.retry_policy = RetryPolicy.from_config(self.cfg)
        self.penalty_box = PenaltyBox(
            threshold=self.cfg.get("uda.tpu.fetch.penalty.threshold"),
            penalty_s=self.cfg.get("uda.tpu.fetch.penalty.ms") / 1e3)
        # the survivable-fetch rungs (speculation, resume, k-of-n
        # reconstruction) all share one recovery ledger
        self.ledger = RecoveryLedger(self.penalty_box)
        self.speculation = SpeculationPolicy.from_config(self.cfg)
        self.resume_fetch = bool(self.cfg.get("uda.tpu.fetch.resume"))
        self.coding_scheme = parse_scheme(
            self.cfg.get("uda.tpu.coding.scheme"))
        spec = self.cfg.get("uda.tpu.failpoints")
        if spec:
            failpoints.arm_spec(spec)
        if self.cfg.get("uda.tpu.stats.enable"):
            metrics.enable_stats()
        # the black box rides every task (utils/flightrec.py): the config
        # knob and the env kill switch must both say on
        flightrec.configure(
            enabled=(bool(self.cfg.get("uda.tpu.flightrec.enable"))
                     and flightrec_enabled_from_env()),
            capacity=int(self.cfg.get("uda.tpu.flightrec.events")),
            dump_dir=str(self.cfg.get("uda.tpu.flightrec.dir")))
        # the time-accounting plane (utils/profiler, utils/critpath): arm
        # the sampling profiler when asked (config wins, env otherwise;
        # arming is sticky: a later manager with the 0 default never
        # disarms it) and expose the where-time-goes block over MSG_STATS
        install_stats_provider()
        prof_hz = (float(self.cfg.get("uda.tpu.profile.hz"))
                   or profile_hz_from_env())
        if prof_hz > 0:
            profiler.start(prof_hz)
        self._stop = threading.Event()
        # admission control and liveness: the budget is built lazily (an
        # explicitly chosen approach never reads the device's memory), the
        # watchdog per run()
        self._budget_obj: Optional[MemoryBudget] = None
        self.last_admission = None     # the routing decision (tests, diag)
        self._live_segments: list[Optional[Segment]] = []
        self._active_overlap: Optional[OverlappedMerger] = None
        # live only while a run() with uda.tpu.ckpt.dir is in flight
        self._ckpt: Optional[checkpoint.TaskCheckpoint] = None
        self._watchdog: Optional[StallWatchdog] = None
        self._stall_error: Optional[StallError] = None
        self._setup: Optional[OpenTimer] = None  # live within run()
        self._emit_progress = 0
        # the push plane's reduce-side staging (arm_push)
        self._push_staging = None

    def budget(self) -> MemoryBudget:
        if self._budget_obj is None:
            self._budget_obj = MemoryBudget.from_config(self.cfg,
                                                         device=self.device)
        return self._budget_obj

    # -- the push plane -----------------------------------------------------

    def arm_push(self, job_id: str, reduce_id: int, hosts=None):
        """Arm reduce-side push staging for this task and subscribe the
        supplier fleet (``uda.tpu.push.enable``). Idempotent; returns the
        staging, or None when the plane stays pull only: the flag off, a
        transport without a push plane (LocalFetchClient, custom
        connects), or a byte-domain-transforming wrapper
        (DecompressingClient: pushed bytes are the compressed on-disk
        stream, the segment ledger's domain the decompressed one).

        Call it before the map phase ends to win overlap: pushes land
        while maps still run, and the fetch wave starts from the staged
        offsets instead of zero."""
        if self._push_staging is not None:
            return self._push_staging
        if not bool(self.cfg.get("uda.tpu.push.enable")):
            return None
        if getattr(self.client, "inner", None) is not None:
            return None
        reg = getattr(self.client, "push_register", None)
        if not callable(reg):
            return None
        from uda_tpu_torch.net.push import PushStaging

        staging = PushStaging(job_id, int(reduce_id), cfg=self.cfg,
                              budget=self.budget())
        reg(job_id, int(reduce_id), staging, hosts=hosts)
        self._push_staging = staging
        return staging

    def _release_push(self) -> None:
        """Unsubscribe and discard unclaimed staged bytes (idempotent;
        run()'s finally). Later pushes draw PUSH_NACK(UNKNOWN) and the
        supplier goes pull only: no frame is left unanswered."""
        staging, self._push_staging = self._push_staging, None
        if staging is None:
            return
        unreg = getattr(self.client, "push_unregister", None)
        if callable(unreg):
            unreg(staging.job_id, staging.reduce_id)
        staging.close()

    def _push_adopt(self, seg: Segment) -> None:
        """Right before a segment starts: claim its map in staging and arm
        the staged prefix as a resumed fetch (``Segment.ckpt_preload``).
        The claim stands even when nothing usable is staged: from here the
        fetch is in flight, and later pushes for the map are refused
        CLAIMED."""
        staging = self._push_staging
        if staging is None:
            return
        kw = staging.take(seg.map_id)
        if kw is None:
            return
        if seg._next_offset or seg.batches:
            return  # a checkpoint ledger is further along; keep it
        try:
            seg.ckpt_preload(**kw)
        except UdaError as e:
            metrics.add("push.invalidated")
            log.warn(f"pushed prefix of map {seg.map_id} rejected, "
                     f"fetching from zero: {e}")
            return
        metrics.add("push.adopted")
        metrics.add("push.adopted.bytes", int(kw["next_offset"]))

    # -- elastic membership -------------------------------------------------

    def notify_join(self, host: str) -> int:
        """A supplier joined mid-job: widen every in-flight segment's
        candidates (it becomes eligible at the next ledger-ranked
        decision) and fold the host into the routing client's membership.
        Returns the number of segments widened; live attempts are never
        re-routed."""
        notify = getattr(self.client, "notify_join", None)
        if callable(notify):
            notify(host)
        else:
            metrics.add("elastic.joins", supplier=host)
        widened = 0
        for seg in list(self._live_segments):
            if seg is not None and seg.add_host(host):
                widened += 1
        self.ledger.record("join", supplier=host)
        flightrec.record("elastic.join", supplier=host, widened=widened)
        log.info(f"elastic: supplier {host!r} joined mid-job; "
                 f"{widened} in-flight segment(s) widened")
        return widened

    def notify_drain(self, host: str) -> None:
        """The departure: demote the host in routing (in-flight fetches
        against it complete; its MOFs migrate to the blob tier through
        ``StoreManager.drain``, so later fetches resolve there)."""
        notify = getattr(self.client, "notify_drain", None)
        if callable(notify):
            notify(host)
        self.ledger.record("drain", supplier=host)
        flightrec.record("elastic.drain", supplier=host)

    def _revalidate_spilled(self, job_id: str) -> None:
        """Resume-side locator revalidation, reachable when the transport
        is in process (a LocalFetchClient, possibly behind a
        DecompressingClient, over an engine with an attached
        StoreManager); remote suppliers run the same check on their own
        resume path. Raises the store's typed error on damage."""
        client = self.client
        inner = getattr(client, "inner", None)
        if inner is not None:
            client = inner
        engine = getattr(client, "engine", None)
        store_mgr = getattr(engine, "store", None)
        if store_mgr is None:
            return
        n = store_mgr.validate_spilled(job_id)
        if n:
            log.info(f"ckpt: revalidated {n} spilled blob object(s) of "
                     f"job {job_id} before resume")

    # -- fetch phase --------------------------------------------------------

    def fetch_all(self, job_id: str, map_ids: Sequence, reduce_id: int,
                  on_segment: Optional[Callable] = None, skip=None,
                  preload: Optional[dict] = None) -> list:
        """Fetch every map's partition, randomized order, sliding window.

        Entries are ``"map_id"``, ``("host", "map_id")`` or
        ``(["host", ...], "map_id")``: a host list names replicas (every
        listed supplier holds the map output) and leads with the map
        writer's host (the stripe placement anchor); the fetch opens
        against the best PenaltyBox-ranked replica and speculation
        duplicates to the others. The window
        refills as individual segments complete (credit-flow semantics).
        Returns segments in the *original* map order (merge stability and
        reproducibility do not depend on fetch completion order).

        Resume hooks (``merger/checkpoint.py``): ``skip`` holds indexes
        whose run files an earlier attempt spooled: no segment is built
        (the returned list holds None there) and no byte is fetched again;
        ``preload`` maps index -> a checkpointed offset ledger, applied by
        ``Segment.ckpt_preload`` before start() so the fetch resumes
        mid-stream (an invalid ledger degrades to a fetch from zero).

        ``on_segment(index, segment)`` fires on each successful segment
        completion, from the transport's completion thread, after the
        segment's credit is released: the hook the overlapped merger uses
        to stage runs while later fetches are still in flight. Its errors
        are raised once every fetch has finished.

        ``stop()`` (the watchdog's rescue) breaks the credit wait and the
        wait for the completion callbacks: every started segment is then
        failed and drained before the error is raised.

        Fault feedback: every transport fault reports the segment's
        supplier to the penalty box; maps of a boxed supplier rotate to
        the back of the pending schedule (see :class:`PenaltyBox`)."""
        def _norm(m):
            if isinstance(m, tuple):
                host, mid = m
                hosts = (list(host) if isinstance(host, (list, tuple))
                         else [host])
            else:
                hosts, mid = [""], m
            return hosts or [""], mid

        entries = [_norm(m) for m in map_ids]
        # the push plane, armed lazily if the caller did not: no overlap
        # is won here, but pushes still beat pulls for maps that commit
        # during this fetch wave
        self.arm_push(job_id, reduce_id,
                      hosts={h for hosts, _ in entries for h in hosts
                             if h})
        stripe_ctx = None
        if self.coding_scheme is not None:
            # the placement domain: the job's canonically ordered supplier
            # universe (sorted unique hosts, the order writers derive).
            # Host-less local entries ("") are not suppliers; the
            # all-local degenerate keeps [""]
            universe = sorted({h for hosts, _ in entries
                               for h in hosts if h}) or [""]
            stripe_ctx = StripeContext(
                self.coding_scheme, universe, ledger=self.ledger,
                domains=parse_domains(
                    str(self.cfg.get("uda.tpu.coding.domains"))))
        skip = frozenset(skip or ())
        segs = [None if i in skip else
                Segment(self.client, job_id, mid, reduce_id,
                        self.chunk_size, host=hosts[0],
                        policy=self.retry_policy, hosts=hosts,
                        ledger=self.ledger, speculation=self.speculation,
                        resume=self.resume_fetch, stripe=stripe_ctx)
                for i, (hosts, mid) in enumerate(entries)]
        for i, kw in (preload or {}).items():
            if segs[i] is None:
                continue
            try:
                segs[i].ckpt_preload(**kw)
            except UdaError as e:
                # a ledger that fails revalidation degrades to a fetch
                # from zero: resume is an optimization, never a
                # correctness dependency
                metrics.add("ckpt.invalidated", cause="ledger")
                log.warn(f"checkpointed ledger of map "
                         f"{segs[i].map_id} rejected, refetching: {e}")
        index_of = {id(s): i for i, s in enumerate(segs) if s is not None}
        order = [i for i in range(len(segs)) if i not in skip]
        random.Random(self.seed).shuffle(order)  # MergeManager.cc:58-63
        live_total = len(order)
        nskip = len(segs) - live_total
        credits = threading.Semaphore(self.window)
        done_lock = TrackedLock("merge.fetch_done")
        done = 0
        all_notified = threading.Event()  # every on_done callback returned
        cb_errors: list[Exception] = []
        box = self.penalty_box
        started: list[Segment] = []

        def on_fault(seg, exc) -> None:
            # the structured cause wins over the segment's current source:
            # a speculation loser's fault punishes the host whose attempt
            # failed, not the source the segment switched to
            sup = getattr(exc, "supplier", None) or seg.supplier
            self.ledger.record("fault", supplier=sup, map_id=seg.map_id,
                               error=exc)
            if box.punish(sup):
                log.warn(f"supplier {sup!r} penalized "
                         f"after repeated fetch faults ({exc})")

        def on_done(seg) -> None:
            nonlocal done
            if seg.ready:
                box.forgive(seg.supplier)
            credits.release()
            try:
                if on_segment is not None and seg.ready:
                    on_segment(index_of[id(seg)], seg)
            except Exception as e:  # raised after the waits below
                cb_errors.append(e)
            finally:
                with done_lock:
                    done += 1
                    d = done
                    if d == live_total:
                        all_notified.set()
            if self.progress and (d + nskip) % PROGRESS_INTERVAL == 0:
                self.progress(d + nskip, len(segs))

        def drained() -> bool:
            with done_lock:
                return done >= len(started)

        def stop_drain() -> Exception:
            """The stop path must not abandon in-flight segments: abort
            the overlapped merger first (a completion thread blocked in
            its bounded feed would never deliver on_done), fail every
            started segment, then wait for their callbacks so the credits
            are accounted before the caller sees the error."""
            om = self._active_overlap if on_segment is not None else None
            if om is not None:
                om.abort()
            error = self._stall_error or MergeError(
                "merge manager stopped during fetch")
            for s in started:
                s.fail(error)
            deadline = time.monotonic() + 10.0
            while not drained() and time.monotonic() < deadline:
                time.sleep(0.01)
            if not drained():
                log.warn("stop drain: some fetch completions did not "
                         "deliver within 10 s; proceeding")
            return error

        self._live_segments = segs
        self._end_setup()
        with metrics.timer("fetch"):
            pending = deque(order)
            while pending:
                # a stop() must break a loop blocked on credits that
                # wedged segments hold
                while not credits.acquire(timeout=0.25):
                    if self._stop.is_set():
                        break
                if self._stop.is_set():
                    raise stop_drain()
                i = self._next_fetch_index(pending, segs)
                segs[i].on_done = on_done
                segs[i].on_fault = on_fault
                started.append(segs[i])
                # adopt the staged push prefix at start time, not at
                # construction: maps that committed while earlier
                # segments held the window get their pushed bytes in
                self._push_adopt(segs[i])
                segs[i].start()
            for s in segs:
                if s is not None:
                    s.wait()
            # a segment is done BEFORE its on_done callback runs: wait for
            # the callbacks too, or the caller could finish the on_segment
            # consumer (the overlapped merger) while the last completion
            # is still inside it. A completion can wedge inside that
            # consumer, so stop() breaks this wait too
            if live_total:
                while not all_notified.wait(timeout=0.25):
                    if self._stop.is_set():
                        raise stop_drain()
        if cb_errors:
            raise cb_errors[0]
        if self.progress:
            self.progress(len(segs), len(segs))
        return segs

    def _next_fetch_index(self, pending: deque, segs) -> int:
        """Penalty-box-aware pick: the first pending segment whose
        supplier is not boxed; boxed ones rotate to the back. When every
        pending supplier is boxed, take the head anyway."""
        for _ in range(len(pending) - 1):
            if not self.penalty_box.penalized(segs[pending[0]].supplier):
                break
            pending.rotate(-1)
            metrics.add("fetch.deprioritized")
        return pending.popleft()

    # -- merge phase --------------------------------------------------------

    def merge_segments(self, segments: Sequence[Segment]) -> RecordBatch:
        """Merge all fetched segments into one sorted batch on the device.
        Routed by ``uda.tpu.merge.two_phase``: the two-phase merge (K1's
        merge tree on the card) or the whole-shuffle re-sort —
        byte-identical either way."""
        batches = [s.record_batch() for s in segments]
        metrics.add("merge.records", sum(b.num_records for b in batches))
        mode = merge_ops.resolve_merge_mode(
            str(self.cfg.get("uda.tpu.merge.two_phase")), len(batches),
            self.device)
        with metrics.timer("merge"):
            if mode == "two_phase":
                with _k1_errors(self.device):
                    return merge_ops.merge_batches_two_phase(
                        batches, self.key_type, self.key_width,
                        device=self.device)
            return merge_ops.merge_batches(batches, self.key_type,
                                           self.key_width, self.device)

    def emit_framed(self, merged: RecordBatch,
                    consumer: Callable[[memoryview], None]) -> int:
        """Stream the sorted batch to ``consumer`` in IFile-framed blocks
        of at most the staging-buffer size (the dataFromUda contract: the
        block's memory is only valid during the call, reference
        UdaPlugin.java:368-402). Returns total bytes emitted."""
        return self.emitter.emit_batch(merged, consumer)

    def run(self, job_id: str, map_ids: Sequence, reduce_id: int,
            consumer: Callable[[memoryview], None]) -> int:
        """The reduce task: fetch every partition, merge on the device,
        emit (the online merge overlaps the merge with the fetch; see the
        module docstring for every approach). Returns the bytes emitted.

        Failure contract: a terminal engine error (retries exhausted,
        merge invariant violation, a failed device merge, a refusal by
        admission control — any ``UdaError``) is re-raised as
        :class:`FallbackSignal` carrying the root cause (the reference's
        ``failureInUda`` flip, UdaBridge.cc:506-530). A configured mode
        this port cannot run raises :class:`ConfigError` at construction.

        Liveness contract (``uda.tpu.watchdog.stall.s`` > 0): a stall
        watchdog samples this task's progress; when nothing advances for
        the deadline it dumps every thread's stack and (with
        ``uda.tpu.watchdog.fallback``, on by default) fails the in-flight
        segments, so this call ends in ``FallbackSignal(StallError)``
        instead of hanging."""
        # the task's set-up, up to the fetch phase (fetch_all ends it)
        self._setup = metrics.start_timer("task_setup")
        # task-local emit progress (the watchdog token must not read the
        # process-wide counters: another task's emission would mask this
        # one's wedge), counted after delivery, so a consumer that never
        # returns reads as a stall
        self._emit_progress = 0

        def tracked_consumer(block: memoryview) -> None:
            consumer(block)
            self._emit_progress += len(block)

        wd = self._start_watchdog(reduce_id)

        # the MSG_STATS / final-stats-record scrape surface of this task:
        # penalty box, recovery ledger and the last admission decision
        def _recovery_provider() -> dict:
            adm = self.last_admission
            return {"penalty_box": self.penalty_box.snapshot(),
                    "ledger": self.ledger.snapshot(),
                    "admission": ({"decision": adm.decision,
                                   "cause": adm.cause,
                                   "reason": adm.reason}
                                  if adm is not None else None)}

        provider_name = f"recovery.r{reduce_id}"
        register_stats_provider(provider_name, _recovery_provider)
        try:
            # the trace root: every phase timer and per-segment fetch span
            # below hangs off this span
            with metrics.span("reduce_task", job=job_id, reduce=reduce_id,
                              maps=len(map_ids)):
                return self._run(job_id, map_ids, reduce_id,
                                 tracked_consumer)
        except FallbackSignal as e:
            # a lower layer already chose fallback: run() is the one dump
            # point, so a failed task leaves exactly one dump
            flightrec.dump("fallback", extra={
                "job": job_id, "reduce": reduce_id,
                "error": type(e.cause).__name__})
            raise
        except UdaError as e:
            # a watchdog rescue surfaces through whichever waiter woke
            # first (a failed segment's wait, the stopped fetch loop):
            # report the stall as the root cause
            stall = self._stall_error
            if stall is not None and not isinstance(e, StallError):
                e = stall
            metrics.add("fallback.signals")
            log.error(f"merge failed terminally, requesting fallback: {e}")
            # the post-mortem: the event stream behind this fallback
            # (injected faults, segment transitions, recovery events)
            flightrec.dump("fallback", extra={
                "job": job_id, "reduce": reduce_id,
                "error": type(e).__name__,
                "supplier": getattr(e, "supplier", None)})
            raise FallbackSignal(e) from e
        finally:
            # the teardown: the overlapped merger's, started as its
            # emission returned, else from here
            self._end_setup()
            om, teardown = self._active_overlap, None
            if om is not None:
                teardown, om.teardown = om.teardown, None
            if teardown is None:
                teardown = metrics.start_timer("task_teardown")
            unregister_stats_provider(provider_name, _recovery_provider)
            self._release_push()
            if wd is not None:
                wd.stop()
                self._watchdog = None
            teardown.stop()

    def _end_setup(self) -> None:
        """End the task's ``task_setup`` timer (once; the fetch phase
        begins, or run() ends without one)."""
        setup, self._setup = self._setup, None
        if setup is not None:
            setup.stop()

    # -- liveness -----------------------------------------------------------

    def _progress_token(self) -> tuple:
        """This task's progress signature, sampled by the watchdog: built
        from this manager's own segments, overlapped merger, ledger,
        checkpoint and emit counter, never the process-wide metrics (a
        co-located task's counters must not mask this one's wedge)."""
        segs = self._live_segments
        ndone = nrec = noff = nret = 0
        for s in segs:
            if s is None:  # a checkpoint-adopted slot
                continue
            nrec += s.num_records
            noff += s._next_offset
            nret += s._retries_left
            if s._done.is_set():
                ndone += 1
        om = self._active_overlap
        om_sig = ((om.stats["staged_runs"], om.stats["device_merges"],
                   om.stats["pending"]) if om is not None else ())
        # each completed checkpoint save is progress too: a long fsync
        # quiesces every other component
        ckpt = self._ckpt
        return (len(segs), ndone, nrec, noff, nret, om_sig,
                self.ledger.version, self._emit_progress,
                ckpt.version if ckpt is not None else 0)

    def _start_watchdog(self, reduce_id: int) -> Optional[StallWatchdog]:
        stall_s = float(self.cfg.get("uda.tpu.watchdog.stall.s"))
        if stall_s <= 0:
            return None
        on_stall = (self._on_stall
                    if self.cfg.get("uda.tpu.watchdog.fallback") else None)
        wd = StallWatchdog(stall_s, self._progress_token,
                           on_stall=on_stall,
                           name=f"uda-watchdog-r{reduce_id}")
        self._watchdog = wd
        return wd.start()

    def _on_stall(self, err: StallError) -> None:
        """Watchdog rescue (on the watchdog thread): record the stall,
        stop the manager (breaks the fetch loop's waits), abort the
        overlapped merger (unblocks completion threads in its bounded
        feed) and fail every live segment so blocked waiters wake; the
        failure then flows through the FallbackSignal contract. A wedge
        inside the consumer callback itself cannot be interrupted."""
        self._stall_error = err
        self._stop.set()
        try:
            self.client.stop()
        except Exception as e:  # noqa: BLE001 - rescue must not die here
            log.warn(f"watchdog: client stop failed: {e}")
        om = self._active_overlap
        if om is not None:
            try:
                om.abort()
            except Exception as e:  # noqa: BLE001
                log.warn(f"watchdog: overlap abort failed: {e}")
        for seg in list(self._live_segments):
            if seg is None:
                continue
            try:
                seg.fail(err)
            except Exception as e:  # noqa: BLE001
                log.warn(f"watchdog: failing segment "
                         f"{seg.map_id} raised: {e}")

    def stop(self) -> None:
        self._stop.set()
        self._release_push()
        self.client.stop()

    # -- crash-consistent checkpointing (merger/checkpoint.py) ---------------

    def _ckpt_state(self, job_id: str, reduce_id: int, mids: list,
                    store: RunStore) -> tuple:
        """The snapshot collector handed to TaskCheckpoint: the spooled
        run files (recorded with length + CRC), the in-flight fetch
        offset ledgers (``Segment.ckpt_export``), the recovery journal,
        the penalty box and the merge-forest watermark. Returns
        ``(payload, parts)`` per the TaskCheckpoint.save contract."""
        runs: dict = {}
        for i, (n, nbytes, crc) in store.manifest().items():
            runs[str(i)] = {"map": mids[i], "records": int(n),
                            "bytes": int(nbytes),
                            "length": int(nbytes) + checkpoint.RUN_EOF_LEN,
                            "crc": int(crc)}
        ledgers: dict = {}
        parts: dict = {}
        for i, seg in enumerate(self._live_segments):
            if seg is None or str(i) in runs:
                continue
            ex = seg.ckpt_export()
            if ex is None:
                continue
            parts[i] = ex.pop("data")
            host = seg.supplier
            ex.update(map=seg.map_id, host=host,
                      generation=self.client.generation(host))
            ledgers[str(i)] = ex
        om = self._active_overlap
        payload = {"job": job_id, "reduce": int(reduce_id),
                   "maps": list(mids), "runs": runs, "ledgers": ledgers,
                   "journal": self.ledger.snapshot()["events"],
                   "penalty": self.penalty_box.snapshot(),
                   "forest": dict(om.stats) if om is not None else {}}
        return payload, parts

    def _resume_from_manifest(self, man: dict, mids: list, store: RunStore,
                              om, ckpt) -> tuple:
        """Revalidate a loaded manifest and adopt what survives the ladder
        (generation -> epoch [at load] -> length + CRC -> drop and fetch
        again). Returns ``(adopted, preload, adopted_records)``: the
        indexes whose run files rejoin the merge forest without a fetch,
        and per-index ``ckpt_preload`` arguments for mid-fetch resume.
        Anything that fails a check degrades to a fresh fetch of that
        segment, never an error."""
        if list(man.get("maps") or []) != list(mids):
            # a different map list is a different shuffle: nothing in
            # this manifest is addressable by index
            metrics.add("ckpt.invalidated", cause="maps")
            log.warn(f"checkpoint manifest for {ckpt.task} lists a "
                     f"different map set; starting fresh")
            return set(), {}, 0
        adopted: set = set()
        preload: dict = {}
        adopted_records = 0
        for key, rec in (man.get("runs") or {}).items():
            try:
                i = int(key)
                if not (0 <= i < len(mids)) or rec.get("map") != mids[i]:
                    raise StorageError(f"run index {key} does not map")
                run_path, off_path = store._paths(i)
                batch = checkpoint.read_run(run_path, off_path, rec)
            except (OSError, UdaError, ValueError, KeyError) as e:
                metrics.add("ckpt.invalidated", cause="crc")
                log.warn(f"checkpointed run {key} failed revalidation, "
                         f"refetching: {e}")
                try:
                    store.discard(int(key))
                except (ValueError, OSError):
                    pass
                continue
            store.adopt(i, int(rec["records"]), int(rec["bytes"]),
                        int(rec["crc"]))
            om.adopt_run(i, batch)
            adopted.add(i)
            adopted_records += batch.num_records
        for key, rec in (man.get("ledgers") or {}).items():
            try:
                i = int(key)
            except ValueError:
                continue
            if i in adopted or not (0 <= i < len(mids)) \
                    or rec.get("map") != mids[i]:
                continue
            host = str(rec.get("host") or "")
            gen_then = rec.get("generation")
            gen_now = self.client.generation(host)
            if (gen_then is not None and gen_now is not None
                    and int(gen_then) != int(gen_now)) \
                    or not self.client.resume_ok(host):
                # a cold supplier restart: its map output was rebuilt, so
                # mid-stream offsets no longer address the same bytes
                metrics.add("ckpt.invalidated", cause="generation")
                log.warn(f"supplier {host!r} restarted since the "
                         f"checkpoint; refetching map {rec.get('map')} "
                         f"from zero")
                continue
            try:
                data = ckpt.part_bytes(rec)
            except StorageError as e:
                metrics.add("ckpt.invalidated", cause="ledger")
                log.warn(f"checkpointed ledger part of map "
                         f"{rec.get('map')} rejected, refetching: {e}")
                continue
            preload[i] = {"data": data,
                          "carry_len": int(rec.get("carry_len", 0)),
                          "next_offset": int(rec.get("next_offset", 0)),
                          "raw_length": rec.get("raw_length"),
                          "num_records": int(rec.get("num_records", 0))}
        self.ledger.restore(man.get("journal") or [])
        self.penalty_box.restore(man.get("penalty") or {})
        metrics.add("ckpt.resumed")
        metrics.add("ckpt.runs.adopted", len(adopted))
        log.info(f"resuming {ckpt.task} from checkpoint seq "
                 f"{man.get('seq')}: {len(adopted)} run(s) adopted, "
                 f"{len(preload)} in-flight ledger(s), "
                 f"{len(mids) - len(adopted)} map(s) to fetch")
        flightrec.record("ckpt.resume", task=ckpt.task,
                         seq=man.get("seq"), adopted=len(adopted),
                         ledgers=len(preload))
        return adopted, preload, adopted_records

    # -- the task -----------------------------------------------------------

    def _route(self, job_id: str, map_ids: Sequence,
               reduce_id: int) -> tuple:
        """Approach 0: the transport's size estimate through
        ``MemoryBudget.route``. Returns ``(approach, streaming)``; a
        refusal raises UdaError before anything is fetched or allocated.

        - in budget and at most ``uda.tpu.auto.approach.threshold.mb``:
          hybrid (streaming when ``uda.tpu.ckpt.dir`` is set: hybrid has
          no durable run spool);
        - in budget and larger: streaming;
        - over the device or host budget: streaming, with no device runs
          when the device budget was the binding one;
        - over ``uda.tpu.budget.hard.mb``: refused;
        - unknown size: streaming, the only bounded default."""
        est = self.client.estimate_partition_bytes(job_id, map_ids,
                                                   reduce_id)
        threshold = (self.cfg.get("uda.tpu.auto.approach.threshold.mb")
                     * (1 << 20))
        adm = self.budget().route(
            est, threshold,
            prefer_streaming=bool(str(self.cfg.get("uda.tpu.ckpt.dir"))))
        self.last_admission = adm
        # the decision and its structured cause go into the black box: a
        # post-mortem reads why the task took the path it did
        flightrec.record("admission", decision=adm.decision,
                         cause=adm.cause, rejected=adm.rejected,
                         estimate=est)
        if adm.rejected:
            raise UdaError(
                f"partition refused by admission control: {adm.reason} — "
                f"falling back to the vanilla path (raise "
                f"uda.tpu.budget.hard.mb to admit)")
        hybrid = adm.decision == "hybrid"
        log.info(f"auto merge approach: estimate="
                 f"{'unknown' if est is None else est} bytes -> "
                 f"{'hybrid' if hybrid else 'streaming online'} "
                 f"({adm.reason})")
        return (2, False) if hybrid else (1, True)

    def _run(self, job_id: str, map_ids: Sequence, reduce_id: int,
             consumer: Callable[[memoryview], None]) -> int:
        approach = self.cfg.get("mapred.netmerger.merge.approach")
        streaming = bool(self.cfg.get("uda.tpu.online.streaming"))
        self.last_admission = None  # per-run routing record
        if approach == 0:
            approach, streaming = self._route(job_id, map_ids, reduce_id)
        if approach == 2:
            return run_hybrid(self, job_id, map_ids, reduce_id, consumer)
        if not streaming and not self.cfg.get("uda.tpu.merge.overlap"):
            segments = self.fetch_all(job_id, map_ids, reduce_id)
            merged = self.merge_segments(segments)
            return self.emit_framed(merged, consumer)
        store = ckpt = manifest = collect = None
        mids = [m[1] if isinstance(m, tuple) else m for m in map_ids]
        if streaming:
            # bounded-host-memory online mode: segments spool to sorted
            # runs and release their bytes; the bounded feed queue keeps
            # pending segments at O(window); emission interleaves the
            # runs (the reference's staging-loop memory model,
            # StreamRW.cc:151-225)
            ckpt_dir = str(self.cfg.get("uda.tpu.ckpt.dir"))
            if ckpt_dir:
                # the runs spool into the checkpoint's fixed directory
                # (they are the durable half of every snapshot) and each
                # spool boundary offers a manifest save
                ckpt = checkpoint.TaskCheckpoint(
                    ckpt_dir, job_id, reduce_id,
                    interval_s=float(self.cfg.get("uda.tpu.ckpt.interval.s")),
                    keep=int(self.cfg.get("uda.tpu.ckpt.keep")),
                    epoch=int(self.cfg.get("uda.tpu.tenant.epoch")))
                self._ckpt = ckpt
                manifest = ckpt.load()
                store = RunStore(tag=f"{job_id}.r{reduce_id}",
                                 fixed_dir=ckpt.runs_dir)
                collect = functools.partial(self._ckpt_state, job_id,
                                            reduce_id, mids, store)
            else:
                store = RunStore(spill_dirs(self.cfg),
                                 tag=f"{job_id}.r{reduce_id}")
        # admission may have routed here because the device forest would
        # exceed the device budget: then no run is staged to the device
        # (run files + the k-way merge over them)
        adm = self.last_admission
        bounded_device = (streaming and adm is not None
                          and adm.cause == "hbm")
        # staged pipeline (uda.tpu.stage.pipeline, default on): stage pool
        # + merge consumer; off = the serial stage loop. Pool width:
        # uda.tpu.stage.pool, else uda.tpu.online.stagers, else auto
        pipelined = bool(self.cfg.get("uda.tpu.stage.pipeline"))
        pool = int(self.cfg.get("uda.tpu.stage.pool"))
        stagers = int(self.cfg.get("uda.tpu.online.stagers"))
        om = OverlappedMerger(
            self.key_type, self.key_width, run_store=store,
            max_pending=self.window if streaming else 0,
            stagers=pool if (pipelined and pool > 0) else stagers,
            device_runs=not bounded_device,
            pipeline=pipelined,
            inflight_bytes=stage_inflight_cap(
                self.cfg, self.window, self.chunk_size,
                budget=self._budget_obj),
            device=self.device,
            on_spool=((lambda i: ckpt.maybe_save(collect))
                      if ckpt is not None else None))
        self._active_overlap = om  # observability (tests, diagnostics)
        adopted: set = set()
        preload: dict = {}
        adopted_records = 0
        self._live_segments = []
        try:
            if manifest is not None:
                # partitions spilled to the blob tier while this task was
                # down are re-verified before the manifest's run files and
                # ledgers are trusted: damage surfaces here as a typed
                # StoreError, not later as a CRC mismatch blamed on the
                # wire
                self._revalidate_spilled(job_id)
                adopted, preload, adopted_records = \
                    self._resume_from_manifest(manifest, mids, store, om,
                                               ckpt)
                # snapshot #0: the loaded manifest was consumed on load,
                # so the adopted state is saved again before fetching
                ckpt.maybe_save(collect, force=True)
            # feed the Segment itself: its record_batch() then runs on a
            # stage thread, not on the transport's completion thread
            segments = self.fetch_all(job_id, map_ids, reduce_id,
                                      on_segment=om.feed, skip=adopted,
                                      preload=preload)
        except Exception:
            # the abort must never mask the error that got us here. With
            # a checkpoint nothing here discards the manifest or the run
            # files: they are the next attempt's resume state
            try:
                om.abort()
            except Exception as cleanup_err:  # noqa: BLE001
                metrics.add("errors.swallowed")
                log.warn(f"overlap abort during failure unwind itself "
                         f"failed: {cleanup_err}")
            raise
        # the "merge" timer covers drain + leftover merges inside the
        # finish paths; emission runs under the emitter's "emit_phase"
        # timer (readback, gather, frame and deliver stages inside it,
        # the consumer's calls under "emit")
        if streaming:
            with metrics.timer("merge_collect"):
                expected = sum(s.num_records for s in segments
                               if s is not None) + adopted_records
            out = om.finish_streaming(self.emitter, consumer,
                                      expected_records=expected)
            if ckpt is not None:
                # the emitted output is the durable artifact now: a kept
                # checkpoint would resume a finished task
                ckpt.discard()
                self._ckpt = None
            return out
        with metrics.timer("merge_collect"):
            batches = [s.record_batch() for s in segments]
        return om.emit_stream(batches, self.emitter, consumer)
