"""Critical-path analyzer: partition a task's wall clock into stages.

The port's copy of ``uda_tpu/utils/critpath.py``, bucket table and
priority order unchanged, so the port's spans (which carry the
reference's names) map the same way: ``overlap_stage`` and
``merge.device_put`` (the port's host-to-card staging) are
``device_put``, ``overlap_device_merge`` (K1's forest) is ``merge``.
The port's own timers (:data:`PORT_SPAN_BUCKETS`, from
``metrics.PORT_TIMERS``): the emit's are ``serve``, the socket client's
and the fetch completion's ``fetch``, the task's set-up and teardown
``other``.

- **wall partition**: sweep the root span's timeline; at every instant
  the active spans map to buckets and exactly one bucket is charged, by
  :data:`BUCKET_PRIORITY`; instants nothing claims are idle. Buckets and
  idle sum exactly to the root's wall.
- **busy time**: per bucket, the plain sum of its spans' durations
  (may exceed the wall: that is the overlap); ``overlap`` = busy /
  critical.
- **critical path**: the root-to-leaf chain of longest children.

The trio (``fetch`` -> ``total_fetch_time``, ``wait`` ->
``total_wait_mem_time``, the rest -> ``total_merge_time``) reconciles
onto the reference's per-task counters. :func:`buckets_from_counters` is
the coarse busy-seconds fallback where no span tree exists. Consumers:
the StatsReporter's final record, MSG_STATS through
:func:`install_stats_provider`, watchdog stall dumps and flight-recorder
dumps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from uda_tpu_torch.utils.metrics import PORT_TIMERS, Metrics
from uda_tpu_torch.utils.metrics import metrics as global_metrics

__all__ = ["analyze", "time_accounting_block", "buckets_from_counters",
           "install_stats_provider", "SPAN_BUCKETS", "BUCKET_PRIORITY",
           "TRIO_MAP", "PORT_SPAN_BUCKETS"]

# span name -> stage bucket. Timer spans carry their timer name
# (metrics.timer); names absent here land in "other". Kept in lockstep
# with the timer call sites and SPAN_REGISTRY by tests/test_timeacct.
SPAN_BUCKETS: Dict[str, str] = {
    # fetch: getting bytes from suppliers (RPC + wire + scheduling;
    # the MSG_JOB tenant registration is fetch-plane control traffic)
    "fetch": "fetch", "fetch.segment": "fetch", "net.fetch": "fetch",
    "net.size_probe": "fetch", "net.job_bind": "fetch",
    # wait: blocked-on-memory / blocked-on-staging idle
    "wait_mem": "wait", "merge.wait": "wait",
    # decompress+pack: host staging compute (materialize, vint-decode,
    # pack, row build, run spooling)
    "overlap_pack": "decompress_pack", "pack": "decompress_pack",
    "run_spool": "decompress_pack",
    # device-put: host->device transfer + buffer-recycle wait
    "overlap_stage": "device_put", "merge.device_put": "device_put",
    # merge: device/host merge + sort compute
    "merge": "merge", "overlap_device_merge": "merge",
    "device_sort": "merge", "lpq_spill": "merge", "lpq_phase": "merge",
    "rpq_phase": "merge",
    # serve: supplier-side reads + emission to the consumer
    "net.serve": "serve", "engine.pread": "serve",
    "engine.read_batch": "serve",
    "supplier_read": "serve", "emit": "serve",
}

# who gets charged when several buckets are active at one instant:
# earlier = the stage gating completion. "wait" is LAST on purpose — a
# merge.wait overlapping a live fetch is caused by the fetch, so the
# instant charges fetch; wait wins only when nothing else runs.
BUCKET_PRIORITY = ("merge", "device_put", "decompress_pack", "serve",
                   "fetch", "other", "wait")

# timer spans only the port has -> stage bucket, consulted after
# SPAN_BUCKETS (disjoint from it); derived from metrics.PORT_TIMERS, which
# gives each its bucket
PORT_SPAN_BUCKETS: Dict[str, str] = {name: t.bucket
                                     for name, t in PORT_TIMERS.items()}

# bucket -> the reference trio alias it reconciles onto (reducer.h:80-90)
TRIO_MAP: Dict[str, str] = {
    "fetch": "total_fetch_time",
    "wait": "total_wait_mem_time",
    "merge": "total_merge_time",
    "device_put": "total_merge_time",
    "decompress_pack": "total_merge_time",
}

_MAX_CHAIN = 32


def _bucket_of(name: str) -> str:
    return SPAN_BUCKETS.get(name) or PORT_SPAN_BUCKETS.get(name, "other")


def _pick_root(spans: Sequence[Dict], root_name: str) -> Optional[Dict]:
    roots = [s for s in spans if s.get("name") == root_name]
    if not roots:
        return None
    # the LAST completed task wins (ties: the longest)
    return max(roots, key=lambda s: (s.get("ts", 0.0) + s.get("dur", 0.0),
                                     s.get("dur", 0.0)))


def analyze(spans: Sequence[Dict], root_name: str = "reduce_task"
            ) -> Optional[Dict]:
    """Compute the time-accounting block over recorded span dicts
    (the ``Metrics.spans`` / ``export_spans_jsonl`` shape: name, ts,
    dur, id, parent, trace). Scope: the last completed ``root_name``
    span and every span sharing its trace id; with no such root (e.g.
    a supplier-side process that only serves), the whole recorded set
    over its own [min, max] window. Returns None when there are no
    spans at all."""
    spans = [s for s in spans
             if s.get("kind") is None and s.get("dur") is not None]
    if not spans:
        return None
    root = _pick_root(spans, root_name)
    if root is not None:
        t0 = root["ts"]
        t1 = t0 + root["dur"]
        scope = [s for s in spans if s.get("trace") == root.get("trace")]
    else:
        t0 = min(s["ts"] for s in spans)
        t1 = max(s["ts"] + s["dur"] for s in spans)
        scope = list(spans)
    wall = max(t1 - t0, 0.0)
    buckets = {b: {"busy_s": 0.0, "critical_s": 0.0}
               for b in BUCKET_PRIORITY}

    # busy: plain per-bucket duration sums, clipped to the window
    events = []  # (time, +1 open / -1 close, bucket)
    for s in scope:
        if root is not None and s is root:
            continue  # the root frames the window, it is not a stage
        lo = max(s["ts"], t0)
        hi = min(s["ts"] + s["dur"], t1)
        if hi <= lo:
            continue
        b = _bucket_of(s["name"])
        buckets[b]["busy_s"] += hi - lo
        events.append((lo, 1, b))
        events.append((hi, -1, b))

    # critical: sweep elementary intervals, charge the highest-priority
    # active bucket; nothing active = idle. Sums to wall EXACTLY.
    idle = 0.0
    if events:
        events.sort(key=lambda e: (e[0], -e[1]))
        active = {b: 0 for b in BUCKET_PRIORITY}
        prev = t0
        i = 0
        while i < len(events):
            t = events[i][0]
            if t > prev:
                charged = next((b for b in BUCKET_PRIORITY if active[b]),
                               None)
                if charged is None:
                    idle += t - prev
                else:
                    buckets[charged]["critical_s"] += t - prev
                prev = t
            while i < len(events) and events[i][0] == t:
                active[events[i][2]] += events[i][1]
                i += 1
        if t1 > prev:
            charged = next((b for b in BUCKET_PRIORITY if active[b]), None)
            if charged is None:
                idle += t1 - prev
            else:
                buckets[charged]["critical_s"] += t1 - prev
    else:
        idle = wall

    for b, rec in buckets.items():
        rec["share"] = (rec["critical_s"] / wall) if wall > 0 else 0.0
        rec["overlap"] = (rec["busy_s"] / rec["critical_s"]
                          if rec["critical_s"] > 0 else 0.0)

    # the longest dependency chain root->leaf (greedy by child duration
    # at each level — the chain a latency fix must shorten)
    children: Dict = {}
    known = {s.get("id") for s in scope}
    for s in scope:
        parent = s.get("parent")
        if parent is not None and parent not in known:
            parent = None  # remote/un-ended parent: local root
        children.setdefault(parent, []).append(s)
    chain: List[Dict] = []
    node = root if root is not None else None
    node_id = node.get("id") if node is not None else None
    if node is not None:
        chain.append({"name": node["name"],
                      "dur_s": round(node["dur"], 6)})
    for _ in range(_MAX_CHAIN):
        kids = children.get(node_id, [])
        if node is None and not kids:
            break
        if not kids:
            break
        nxt = max(kids, key=lambda s: s.get("dur", 0.0))
        chain.append({"name": nxt["name"],
                      "dur_s": round(nxt["dur"], 6)})
        node, node_id = nxt, nxt.get("id")

    trio: Dict[str, float] = {}
    for b, alias in TRIO_MAP.items():
        trio[alias] = round(trio.get(alias, 0.0)
                            + buckets[b]["critical_s"], 6)
    return {
        "root": root["name"] if root is not None else None,
        "wall_s": round(wall, 6),
        "spans": len(scope),
        "buckets": {b: {k: round(v, 6) if isinstance(v, float) else v
                        for k, v in rec.items()}
                    for b, rec in buckets.items()},
        "idle_s": round(idle, 6),
        "critical_path": chain,
        # reconciliation onto the reference trio (critical seconds;
        # the counter aliases in Metrics.snapshot stay busy-seconds)
        "trio": trio,
    }


def time_accounting_block(m: Optional[Metrics] = None,
                          root_name: str = "reduce_task"
                          ) -> Optional[Dict]:
    """The live-process view: analyze the metrics hub's recorded spans
    (None when span recording is off or nothing recorded yet)."""
    m = m or global_metrics
    spans = list(m.spans)  # GIL-atomic copy; contents are immutable dicts
    block = analyze(spans, root_name=root_name)
    if block is not None:
        global_metrics.add("critpath.analyses")
    return block


# the reference's rows of buckets_from_counters: bucket -> its timers'
# counters (the port's busy timers are appended to each, in table order)
_COUNTER_ROWS = (("fetch", ("fetch_time",)),
                 ("wait", ("wait_mem_time",)),
                 ("decompress_pack", ("overlap_pack_time", "pack_time",
                                      "run_spool_time")),
                 ("device_put", ("overlap_stage_time",)),
                 ("merge", ("merge_time", "overlap_device_merge_time",
                            "device_sort_time", "lpq_spill_time",
                            "lpq_phase_time", "rpq_phase_time")),
                 ("serve", ("supplier_read_time", "emit_time")))


def buckets_from_counters(counters: Dict[str, float]) -> Dict:
    """Coarse busy-seconds bucketing from the ``<timer>_time`` counters
    alone — the fallback where no span tree exists (chaos-rung session
    telemetry, stats-off runs). These are BUSY sums (overlap not
    removed), so they do not sum to wall; the block says so. The port's
    own timers join their bucket's row where ``metrics.PORT_TIMERS``
    marks them ``busy`` (outermost); one whose time another counter
    already holds does not: ``emit_phase`` (it holds the emit's stages
    and ``emit_time``), the coding timers (``coding_recover_time`` is
    the rung's wall, waits included; ``coding_decode_time`` is busy
    inside a completion upcall), the fetch completion's and the socket
    read's splits (inside ``net_deliver_time`` and ``net_read_time``).
    A bucket with no row here (``other``: the task's set-up and
    teardown) stays out, as in the reference."""
    table = tuple(
        (bucket, keys + tuple(f"{name}_time"
                              for name, t in PORT_TIMERS.items()
                              if t.busy and t.bucket == bucket))
        for bucket, keys in _COUNTER_ROWS)
    out = {b: round(sum(counters.get(k, 0.0) for k in keys), 6)
           for b, keys in table}
    return {"kind": "busy_seconds_from_counters", "buckets": out,
            "trio": {"total_fetch_time": out["fetch"],
                     "total_wait_mem_time": out["wait"],
                     "total_merge_time": round(out["merge"]
                                               + out["device_put"]
                                               + out["decompress_pack"],
                                               6)}}


# providers run on the server dispatcher thread per MSG_STATS poll and
# must be cheap; the analysis is O(n log n) over an ever-growing span
# list, so the block is cached and recomputed only when spans were
# appended since (the list is append-only between resets). [count,
# block]; GIL-atomic list mutation, a racy off-by-a-few recompute is
# harmless.
_provider_cache: list = [-1, None]


def _provider() -> Dict:
    n = len(global_metrics.spans)
    if n == _provider_cache[0]:
        block = _provider_cache[1]
    else:
        block = time_accounting_block()
        _provider_cache[0] = n
        _provider_cache[1] = block
    return block if block is not None else {"available": False}


def install_stats_provider() -> None:
    """Register the ``time_accounting`` MSG_STATS provider (idempotent;
    process-scoped, never unregistered) — how udatop gets its
    where-time-goes column. Called by MergeManager construction and
    ShuffleServer start, so both roles answer."""
    from uda_tpu_torch.utils.stats import register_stats_provider

    register_stats_provider("time_accounting", _provider)
