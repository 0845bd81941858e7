"""Labelled metrics and the span-tree tracer.

The port's copy of ``uda_tpu/utils/metrics.py``: the reference's per-task
counters (``total_wait_mem_time``, ``total_fetch_time``,
``total_merge_time``, reference src/Merger/reducer.h:80-90) grown into an
observability layer:

- **counters** (``metrics.add``): monotone sums, optionally labelled;
  ``metrics.add("fetch.bytes", n, supplier=sid)`` advances both the total
  ``fetch.bytes`` and the series ``fetch.bytes{supplier=sid}``;
- **gauges** (``metrics.gauge`` / ``metrics.gauge_add``): levels such as
  fetches on air; the paired gauges (:data:`~uda_tpu_torch.utils.
  resledger.PAIRED_GAUGES`) also flow through the armed resource ledger;
- **histograms** (``metrics.observe``): fixed power-of-two buckets with
  p50/p95/p99 estimates, recorded only while stats are on
  (``UDA_TPU_STATS=1``, ``uda.tpu.stats.enable`` or
  :meth:`Metrics.enable_stats`);
- **spans**: a tree tracer. Each span carries trace/span/parent ids and
  attributes, propagates through threads implicitly (a contextvar) or
  explicitly (``start_span(parent=...)``, ``use_span``), crosses the
  wire as the REQ frame's trace tail (:meth:`Metrics.remote_parent`) and
  exports as a Chrome trace or as JSON lines. Off with stats.

Names use the dotted ``domain.metric`` namespace and must appear in
:data:`METRICS_REGISTRY` or start with a :data:`REGISTRY_PREFIXES`
prefix; literal span names must appear in :data:`SPAN_REGISTRY`.
:func:`device_trace` wraps a block in ``torch.profiler`` and writes its
Chrome trace (host and card) into ``UDA_TPU_XPROF`` or ``log_dir``.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, NamedTuple, Optional

from uda_tpu_torch.utils.locks import TrackedLock
from uda_tpu_torch.utils.resledger import resledger as _resledger

__all__ = ["Metrics", "Span", "OpenTimer", "metrics", "device_trace",
           "METRICS_REGISTRY", "REGISTRY_PREFIXES", "NAME_RE",
           "SPAN_REGISTRY", "PortTimer", "PORT_TIMERS", "PORT_METRICS",
           "PARITY_ALIASES",
           "stats_enabled_from_env", "percentile_from_summary",
           "active_span_of_thread", "enable_thread_span_registry"]

# Dotted namespace every metrics.add/gauge/observe name must match
# (tests/test_torch_observability.py enforces this over uda_tpu_torch/).
NAME_RE = r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+"

# The metrics registry: every statically-named counter/gauge/histogram
# call site in uda_tpu_torch/ must be listed here (kind, what it
# measures, labels if any); the key set is the reference's.
METRICS_REGISTRY: Dict[str, tuple] = {
    # -- counters: fetch path (reduce side) ------------------------------
    "fetch.bytes": ("counter", "record bytes fetched [labels: supplier]"),
    "fetch.chunks": ("counter", "chunks fetched [labels: supplier]"),
    "fetch.retries": ("counter", "whole-segment re-fetches after a "
                                 "transport fault [labels: supplier]"),
    "fetch.timeouts": ("counter", "per-attempt fetch timeouts "
                                  "[labels: supplier]"),
    "fetch.stale_completions": ("counter", "completions dropped as stale "
                                           "(superseded attempt epoch)"),
    "fetch.backoff_seconds": ("counter", "seconds spent in retry backoff"),
    "fetch.deadline_exceeded": ("counter", "segments abandoned at the "
                                           "per-segment deadline"),
    "fetch.failed_admin": ("counter", "segments administratively failed "
                                      "(watchdog rescue / stop drain)"),
    "fetch.crc_mismatch": ("counter", "chunk CRC validation failures"),
    "fetch.crc_refetch": ("counter", "single-chunk CRC re-fetches"),
    "fetch.penalties": ("counter", "suppliers boxed after repeated "
                                   "faults [labels: supplier]"),
    "fetch.deprioritized": ("counter", "schedule rotations past a boxed "
                                       "supplier"),
    # -- counters: survivable shuffle (speculation / resume / coding) ----
    "fetch.speculated": ("counter", "straggler chunks that got a "
                                    "speculative duplicate fetch "
                                    "[labels: supplier (the alternate "
                                    "source)]"),
    "fetch.speculation.won": ("counter", "speculative duplicates that "
                                         "completed first (the segment "
                                         "switches to the faster "
                                         "source) [labels: supplier]"),
    "fetch.speculation.lost": ("counter", "speculative duplicates the "
                                          "primary beat (the loser's "
                                          "completion is discarded as "
                                          "stale)"),
    "fetch.hedged.bytes": ("counter", "record bytes ingested from the "
                                      "source that won a speculation "
                                      "race, from the winning chunk to "
                                      "the end of its segment (a port-"
                                      "only name) [labels: supplier]"),
    "fetch.resumed": ("counter", "transport retries that kept the "
                                 "offset ledger and resumed "
                                 "mid-partition (uda.tpu.fetch.resume) "
                                 "[labels: supplier]"),
    "fetch.resumed.bytes": ("counter", "already-served bytes a resumed "
                                       "retry did NOT refetch"),
    "fetch.resume.invalidated": ("counter", "resumed fetches whose "
                                            "first chunk failed the "
                                            "partition-identity check "
                                            "(full restart from zero)"),
    "coding.recover.attempts": ("counter", "segments that entered the "
                                           "k-of-n reconstruction rung "
                                           "after exhausting retries "
                                           "[labels: supplier (the "
                                           "failed primary)]"),
    "coding.recover.failures": ("counter", "reconstructions that failed "
                                           "(fewer than k chunks "
                                           "reachable, or decode "
                                           "error)"),
    "coding.reconstructed.partitions": ("counter", "partitions rebuilt "
                                        "from stripe chunks instead of "
                                        "the dead/penalized primary"),
    "coding.reconstructed.bytes": ("counter", "on-disk partition bytes "
                                              "produced by the RS "
                                              "decoder"),
    "coding.shard.fetches": ("counter", "stripe shard streams fetched "
                                        "to completion [labels: "
                                        "supplier]"),
    "coding.shard.failures": ("counter", "stripe shard streams that "
                                         "failed (next candidate is "
                                         "promoted) [labels: "
                                         "supplier]"),
    "fallback.signals": ("counter", "terminal engine failures converted "
                                    "to FallbackSignal"),
    # -- counters: memory admission / pressure response ------------------
    "budget.admitted": ("counter", "admission decisions that kept the "
                                   "requested path (utils/budget.py)"),
    "budget.rerouted": ("counter", "over-budget tasks rerouted to a "
                                   "bounded path (streaming / shrunken "
                                   "window)"),
    "budget.rejected": ("counter", "tasks refused before allocation "
                                   "(hard ceiling / unfittable INIT)"),
    "watchdog.stalls": ("counter", "stall-watchdog firings (diagnostic "
                                   "dump + optional fallback)"),
    "arena.pressure_events": ("counter", "arena acquires that waited "
                                         "past the soft-pressure "
                                         "threshold"),
    "supplier.admission.rejections": ("counter", "ShuffleRequests "
                                      "rejected by the read-pool "
                                      "admission budget"),
    # -- counters: error accounting / lock discipline --------------------
    "errors.swallowed": ("counter", "exceptions intentionally absorbed "
                                    "by a best-effort path (every such "
                                    "site logs too; udalint UDA006 "
                                    "forbids silent swallows)"),
    "lockdep.cycles": ("counter", "lock-order cycles (potential "
                                  "deadlocks) detected by the runtime "
                                  "validator (utils/locks.py, "
                                  "UDA_TPU_LOCKDEP=1)"),
    "racedet.races": ("counter", "data races (shared-modified field "
                                 "with an empty candidate lockset) "
                                 "detected by the runtime Eraser "
                                 "machine (utils/locks.py, "
                                 "UDA_TPU_RACEDET=1)"),
    "resledger.leaks": ("counter", "obligations (leases, fd pins, "
                                   "admission charges, paired-gauge "
                                   "increments) still open at a drain "
                                   "point (utils/resledger.py, "
                                   "UDA_TPU_RESLEDGER=1)"),
    # -- counters: supplier / emit / merge / exchange --------------------
    "supplier.bytes": ("counter", "bytes served by the DataEngine"),
    "supplier.reads.dropped": ("counter", "DataEngine reads dropped "
                                          "unread because their requester "
                                          "was gone when the pool took "
                                          "them up (a closed connection; "
                                          "a port-only name)"),
    "emit.bytes": ("counter", "framed bytes handed to the consumer"),
    "merge.records": ("counter", "records through the merge "
                                 "(staged or device-merged)"),
    "spool.bytes": ("counter", "bytes spooled to sorted run files "
                               "(streaming online mode)"),
    # -- counters: staging pipeline (merger/overlap stage pool) ----------
    "stage.bytes": ("counter", "record content bytes through the "
                               "staging path (pack + row build)"),
    "stage.backpressure_events": ("counter", "feed() calls that blocked "
                                            "on the in-flight staging "
                                            "byte budget "
                                            "(uda.tpu.stage.inflight.mb)"),
    "stage.buffer.reuses": ("counter", "row-matrix builds served from "
                                       "the pre-allocated host buffer "
                                       "pool instead of a fresh "
                                       "allocation"),
    "merge.pipeline.runs": ("counter", "staged runs consumed by the "
                                       "pipeline's merge consumer "
                                       "(device_put overlapped with "
                                       "the previous run's merges)"),
    "merge.pipeline.two_phase": ("counter", "non-overlapped merges "
                                            "routed to the two-phase "
                                            "device sort (partial "
                                            "sort + HBM merge tree) "
                                            "instead of the "
                                            "concatenation re-sort"),
    "exchange.rounds": ("counter", "all-to-all exchange rounds executed"),
    "exchange.rounds.skipped": ("counter", "planned exchange windows the "
                                           "host round planner dropped "
                                           "because no device had "
                                           "in-window records"),
    "exchange.ici.bytes": ("counter", "record bytes the round planner "
                                      "routed over intra-pod ICI links "
                                      "(off-device rows; hierarchical "
                                      "mode includes the egress/"
                                      "delivery staging hops)"),
    "exchange.dcn.bytes": ("counter", "record bytes crossing a pod "
                                      "boundary over DCN [labels: pod "
                                      "(source pod)]"),
    "exchange.dcn.messages": ("counter", "per-round DCN transfers: "
                                         "cross-pod (src, dst) device "
                                         "pairs with traffic (flat "
                                         "exchange) vs coalesced pod "
                                         "pairs (hierarchical) [labels: "
                                         "pod (source pod)]"),
    "exchange.dcn.coded.bytes": ("counter", "multicast-model DCN charge "
                                            "of coded windows: one "
                                            "L-row coded packet per "
                                            "pod pair serving every "
                                            "member reducer (equals "
                                            "the window's exchange."
                                            "dcn.bytes when coded) "
                                            "[labels: pod (source "
                                            "pod)]"),
    "exchange.dcn.saved.bytes": ("counter", "DCN payload bytes the "
                                            "coded stage B removed vs "
                                            "the plain coalesced tile "
                                            "(invariant: coded + "
                                            "saved == the uncoded "
                                            "payload) [labels: pod "
                                            "(source pod)]"),
    "exchange.decode.fallbacks": ("counter", "coded windows whose "
                                             "decode failed (failpoint "
                                             "exchange.decode) and "
                                             "completed byte-correct "
                                             "on the plain coalesced "
                                             "tile"),
    "coding.scrub.stripes": ("counter", "map-output stripes whose "
                                        "parity section was verified "
                                        "against the data region by "
                                        "the background scrub"),
    "coding.scrub.repairs": ("counter", "lost/corrupt stripe shards "
                                        "the scrub rebuilt (repair "
                                        "mode) or reported (dump-only "
                                        "default)"),
    "decompress.bytes": ("counter", "uncompressed bytes produced by the "
                                    "decompressing fetch client"),
    # -- counters: network data plane (uda_tpu/net/) ---------------------
    "net.accepts": ("counter", "connections accepted by the shuffle "
                               "server"),
    "net.requests": ("counter", "REQ frames handed to the engine by "
                                "the server"),
    "net.errors": ("counter", "typed ERR frames completed to clients"),
    "net.bytes.in": ("counter", "wire bytes received [labels: role="
                                "server|client]"),
    "net.bytes.out": ("counter", "wire bytes sent [labels: role="
                                 "server|client]"),
    "net.connects": ("counter", "client connections established "
                                "[labels: host]"),
    "net.connect.failures": ("counter", "client dials that failed "
                                        "[labels: host]"),
    "net.disconnects": ("counter", "connections torn down on error/"
                                   "EOF/torn frame [labels: role]"),
    "net.frames.orphaned": ("counter", "frames for no-longer-pending "
                                       "request ids (stale epoch)"),
    "net.serve.fd": ("counter", "DATA responses served zero-copy from "
                                "the fd cache via os.sendfile (event-"
                                "loop core)"),
    "net.serve.copy": ("counter", "DATA responses served through the "
                                  "byte path (CRC on, pread failpoint "
                                  "armed, zerocopy off, or sendfile "
                                  "fallback)"),
    "net.sendfile.bytes": ("counter", "chunk bytes that went disk->"
                                      "socket via os.sendfile without "
                                      "transiting the Python heap"),
    "net.mmap.bytes": ("counter", "chunk bytes that went page-cache->"
                                  "socket via sendmsg over the MOF's "
                                  "mmap (the zerocopy mmap mode) "
                                  "without transiting the Python "
                                  "heap"),
    "net.generation.changes": ("counter", "reconnects that observed a "
                                          "DIFFERENT server generation "
                                          "in the accept banner (a "
                                          "supplier restart) [labels: "
                                          "host, warm]"),
    "net.handoff.persisted": ("counter", "handoff records written by "
                                         "stop(drain=True)"),
    "net.handoff.loaded": ("counter", "warm restarts that resumed a "
                                      "persisted handoff record "
                                      "(generation continuity)"),
    "net.stats.requests": ("counter", "MSG_STATS introspection "
                                      "snapshots served to remote "
                                      "peers (uncredited, like the "
                                      "HELLO banner)"),
    "flightrec.dumps": ("counter", "flight-recorder black-box dumps "
                                   "written (FallbackSignal, stall, "
                                   "resledger leak — "
                                   "utils/flightrec.py)"),
    # -- counters: batched host-I/O plane (mofserver/data_engine.py) -----
    "io.batch.submits": ("counter", "request batches handed to the "
                                    "DataEngine batch worker (one pool "
                                    "handoff each, however many chunks "
                                    "ride it)"),
    "io.batch.requests": ("counter", "ShuffleRequests served through "
                                     "the batched read plane"),
    "io.batch.reads": ("counter", "kernel read operations the batch "
                                  "plane issued (coalesced vectored "
                                  "reads / native batch submits) — "
                                  "the O(files)-not-O(chunks) figure "
                                  "[labels: backend]"),
    "io.coalesce.runs": ("counter", "coalesced runs built from "
                                    "adjacent/near-adjacent request "
                                    "ranges (each is one vectored "
                                    "read)"),
    "io.coalesce.gap.bytes": ("counter", "gap bytes read into scratch "
                                         "and discarded to merge "
                                         "near-adjacent ranges "
                                         "(uda.tpu.read.coalesce."
                                         "gap.kb)"),
    "io.backend": ("counter", "batch-read backend rung selected at "
                              "engine construction (the io_uring -> "
                              "preadv -> pread fallback ladder) "
                              "[labels: backend]"),
    "io.native.unavailable": ("counter", "DataEngine constructions "
                                         "that wanted the native "
                                         "reader but fell back to "
                                         "os.pread (warned once per "
                                         "process, counted every "
                                         "time)"),
    # -- counters: online tuning cache (utils/tuncache.py) ---------------
    "tune.cache.hits": ("counter", "routing decisions served from a "
                                   "persisted fly-off winner "
                                   "[labels: domain]"),
    "tune.cache.misses": ("counter", "routing decisions that found no "
                                     "cached winner (built-in "
                                     "defaults used) [labels: domain]"),
    "tune.cache.invalid": ("counter", "tuning-cache files ignored as "
                                      "corrupt/truncated/version-"
                                      "bumped (never fatal)"),
    "tune.cache.writes": ("counter", "winner records persisted to the "
                                     "tuning cache"),
    "tune.probes": ("counter", "fly-off probes executed "
                               "(python -m "
                               "uda_tpu_torch.tools.tune_probe) "
                               "[labels: domain]"),
    "tune.reprobes": ("counter", "stale winners re-measured by the "
                                 "background re-probe rung"),
    # -- counters: multi-tenant service plane (uda_tpu/tenant/) ----------
    "tenant.registered": ("counter", "jobs registered in the tenant "
                                     "registry (MSG_JOB) [labels: "
                                     "tenant]"),
    "tenant.retired": ("counter", "jobs retired [labels: tenant]"),
    "tenant.heartbeats": ("counter", "registry heartbeats (repeat "
                                     "MSG_JOB at the same epoch)"),
    "tenant.epoch.fenced": ("counter", "registrations that superseded "
                                       "a lower epoch (the restarted-"
                                       "job fence)"),
    "tenant.expired": ("counter", "idle jobs dropped by the TTL sweep "
                                  "(uda.tpu.tenant.ttl.s)"),
    "tenant.rejected": ("counter", "registry refusals -> typed "
                                   "TenantError [labels: cause="
                                   "unknown|retired|stale_epoch|auth|"
                                   "capacity]"),
    "tenant.bind.errors": ("counter", "client-side MSG_JOB refusals "
                                      "(fire-and-forget binds whose "
                                      "reply was a typed ERR)"),
    "tenant.sched.grants": ("counter", "credits granted by the "
                                       "weighted-fair scheduler "
                                       "[labels: tenant]"),
    "tenant.sched.parked": ("counter", "requests parked in a tenant's "
                                       "WDRR queue (no credit at "
                                       "arrival)"),
    "tenant.penalties": ("counter", "tenants penalty-boxed by the "
                                    "scheduler (repeated faults) "
                                    "[labels: tenant]"),
    "tenant.admission.rejections": ("counter", "ShuffleRequests "
                                    "rejected by a TENANT's read-"
                                    "budget share (the global "
                                    "supplier.admission.rejections "
                                    "also advances) [labels: tenant]"),
    # -- counters: crash-consistent checkpoints (merger/checkpoint.py) ---
    "ckpt.snapshots": ("counter", "checkpoint manifests durably "
                                  "written (one per successful save)"),
    "ckpt.bytes": ("counter", "bytes written by checkpoint saves "
                              "(manifest + ledger part files; run "
                              "files are spooled by the RunStore and "
                              "charged to stage.bytes, not here)"),
    "ckpt.save.errors": ("counter", "checkpoint saves that failed and "
                                    "were absorbed (best-effort "
                                    "contract: the task continues on "
                                    "its previous resume point)"),
    "ckpt.resumed": ("counter", "reduce tasks that resumed from a "
                                "checkpoint manifest instead of "
                                "starting fresh"),
    "ckpt.runs.adopted": ("counter", "checkpointed run files adopted "
                                     "on resume (CRC-verified, re-"
                                     "joined the merge forest with "
                                     "zero refetch)"),
    "ckpt.invalidated": ("counter", "checkpoint state dropped by the "
                                    "revalidation ladder [labels: "
                                    "cause=load|torn|epoch|maps|crc|"
                                    "generation|ledger]"),
    # -- counters: time-accounting plane (profiler + critpath) -----------
    "profile.samples": ("counter", "sampling-profiler stack samples, "
                                   "attributed to the sampled thread's "
                                   "active span (utils/profiler.py) "
                                   "[labels: span]"),
    "profile.ticks": ("counter", "sampling-profiler wakeups (one walk "
                                 "of sys._current_frames per tick)"),
    "critpath.analyses": ("counter", "critical-path/time-accounting "
                                     "analyses computed over the span "
                                     "tree (utils/critpath.py)"),
    # -- gauges ----------------------------------------------------------
    "fetch.on_air": ("gauge", "fetch attempts currently in flight "
                              "(reference AIO on-air counter)"),
    "supplier.reads.on_air": ("gauge", "DataEngine reads currently "
                                       "queued or executing"),
    "arena.slots_in_use": ("gauge", "staging-arena slots currently "
                                    "acquired"),
    "supplier.read.bytes.on_air": ("gauge", "ShuffleRequest bytes "
                                           "queued or being read "
                                           "(the admission level)"),
    "net.server.connections": ("gauge", "shuffle-server connections "
                                        "currently open"),
    "net.client.connections": ("gauge", "RemoteFetchClient connections "
                                        "currently open"),
    "net.server.inflight": ("gauge", "requests inside the server "
                                     "pipeline (engine + outbound "
                                     "queue; bounded per conn by "
                                     "mapred.rdma.wqe.per.conn)"),
    "net.server.generation": ("gauge", "this process's shuffle-server "
                                       "generation (advertised in the "
                                       "accept banner; warm restarts "
                                       "increment the persisted one)"),
    "stage.inflight.bytes": ("gauge", "bytes fed to the overlap merger "
                                      "but not yet merged/spooled (the "
                                      "staging-pipeline admission "
                                      "level; bounded by "
                                      "uda.tpu.stage.inflight.mb)"),
    "io.batch.inflight": ("gauge", "requests inside the batched read "
                                   "plane (submitted to a batch "
                                   "worker, future not yet resolved); "
                                   "paired — every +1 must meet its "
                                   "-1 at settlement"),
    "tenant.read.bytes.on_air": ("gauge", "tenant-stamped admission "
                                          "bytes queued or being read "
                                          "(the per-tenant partition "
                                          "level; paired — the "
                                          "unlabeled total rides the "
                                          "ledger, the tenant series "
                                          "is observability) [labels: "
                                          "tenant]"),
    "tenant.jobs.active": ("gauge", "active jobs in the tenant "
                                    "registry (absolute, set at "
                                    "register/retire — not paired)"),
    "tenant.sched.backlog": ("gauge", "requests parked across every "
                                      "tenant's WDRR queue (absolute, "
                                      "set at each grant sweep — not "
                                      "paired)"),
    "profile.hz": ("gauge", "sampling-profiler rate currently armed "
                            "(0 = off; set absolutely at start/stop, "
                            "deliberately NOT a paired gauge — the "
                            "profiler is process-scoped, not an "
                            "obligation)"),
    # -- histograms (recorded only while stats are enabled) --------------
    "fetch.latency_ms": ("histogram", "per-chunk fetch latency "
                                      "[labels: supplier, tenant — "
                                      "tenant stamped when the "
                                      "process carries an identity]"),
    "fetch.chunk.bytes": ("histogram", "fetched chunk sizes [labels: "
                                       "tenant when stamped]"),
    "supplier.read.latency_ms": ("histogram", "DataEngine chunk read+"
                                              "resolve latency [labels:"
                                              " tenant when the "
                                              "request is tenant-"
                                              "stamped]"),
    "merge.wait_ms": ("histogram", "how long the merge waited for a "
                                   "run to become mergeable after its "
                                   "segment was fed (queue wait + "
                                   "decompress tail + pack + spool) — "
                                   "the device-starvation signal; its "
                                   "complement is the feed() "
                                   "backpressure block "
                                   "(stage.backpressure_events)"),
    "merge.pipeline.put_ms": ("histogram", "merge-consumer wait for a "
                                           "host-to-device transfer to "
                                           "release its leased host "
                                           "buffer (the pipeline's one "
                                           "per-run accounting block)"),
    "net.frame.latency_ms": ("histogram", "request->response frame "
                                          "latency, server side: REQ "
                                          "read to reply written "
                                          "[labels: role=server]"),
    "ckpt.save_ms": ("histogram", "wall time of one checkpoint save "
                                  "(collect + part files + manifest "
                                  "write + fsync + prune) — the "
                                  "snapshot-overhead signal perfwatch "
                                  "gates on"),
    # -- the live telemetry plane (timeseries, anomaly, tenant/sli) ------
    "ts.listener.errors": ("counter", "rollup-listener callbacks "
                                      "(anomaly detectors, SLI book) "
                                      "that raised — the one timer "
                                      "keeps ticking for the others"),
    "anomaly.fired": ("counter", "anomalies fired (inactive->active "
                                 "edges across every detector; the "
                                 "per-kind anomaly.<kind> family "
                                 "carries the labeled breakdown)"),
    "anomaly.throughput": ("counter", "throughput-collapse detections "
                                      "[labels: key — the collapsed "
                                      "counter]"),
    "anomaly.p99": ("counter", "p99-inflation detections [labels: key "
                               "— the inflated histogram]"),
    "anomaly.leak": ("counter", "gauge leak-slope detections [labels: "
                                "key — the rising gauge]"),
    "anomaly.starvation": ("counter", "tenant-starvation detections "
                                      "(the WDRR fairness audit's "
                                      "alarm) [labels: key — the "
                                      "starved tenant]"),
    "anomaly.dumps": ("counter", "proactive flight-recorder dumps "
                                 "(cause=anomaly, rate-limited by "
                                 "uda.tpu.anomaly.dump.interval.s)"),
    "sli.slo.breach": ("counter", "per-interval SLO compliance misses "
                                  "[labels: tenant, sli]"),
    "tenant.queue.wait_ms": ("histogram", "parked time of a WDRR-"
                                          "queued request, enqueue to "
                                          "grant (the queue-wait SLI) "
                                          "[labels: tenant]"),
    # -- the elastic disaggregated MOF store (mofserver/store.py) --------
    "store.read.bytes": ("counter", "bytes served through the store "
                                    "router [labels: backend]"),
    "store.blob.reads": ("counter", "blob-tier vectored read syscalls "
                                    "(the batched plane's coalescer riding the "
                                    "blob range-GET path)"),
    "store.errors": ("counter", "store-tier read/put faults (typed "
                                "StoreError; the failover router's "
                                "input) [labels: backend]"),
    "store.failover": ("counter", "reads served by the SURVIVING tier "
                                  "after the partition's primary tier "
                                  "faulted or was boxed [labels: "
                                  "backend — the tier that served]"),
    "store.rerouted": ("counter", "reads proactively routed around a "
                                  "penalty-boxed tier (no failed "
                                  "attempt burned) [labels: backend — "
                                  "the boxed tier]"),
    "store.penalties": ("counter", "store backends penalty-boxed after "
                                   "repeated faults (BackendHealth) "
                                   "[labels: backend]"),
    "store.migrations": ("counter", "whole-partition tier migrations "
                                    "completed [labels: reason="
                                    "spill|drain|replicate]"),
    "store.migrated.bytes": ("counter", "MOF bytes moved between tiers "
                                        "(CRC-verified streamed "
                                        "copies)"),
    "store.spilled.bytes": ("counter", "migrated bytes attributed to "
                                       "the retention-watermark spill "
                                       "ladder (the bounded-RSS "
                                       "contract's ledger)"),
    "store.drained.partitions": ("counter", "partitions migrated off a "
                                            "departing supplier by the "
                                            "drain handoff"),
    "store.revalidated": ("counter", "spilled blob objects CRC-"
                                     "re-verified by the checkpoint-"
                                     "resume locator revalidation"),
    "elastic.joins": ("counter", "suppliers that joined mid-job "
                                 "(CAP_ELASTIC HELLO; in-flight "
                                 "segments adopt them as speculation/"
                                 "replica candidates) [labels: "
                                 "supplier]"),
    "elastic.drains": ("counter", "suppliers that announced departure "
                                  "(CAP_DRAINING HELLO / server "
                                  "announce_drain)"),
    "store.local.retained.bytes": ("gauge", "MOF bytes retained on the "
                                           "local tier and counted "
                                           "against the spill "
                                           "watermark (absolute "
                                           "level, not paired)"),
    "store.migrate.bytes.on_air": ("gauge", "bytes mid-migration "
                                           "between store tiers; "
                                           "paired — every +N must "
                                           "meet its -N at migration "
                                           "settle (resledger "
                                           "gauge.store.migrate)"),
    "store.read.latency_ms": ("histogram", "store-router range-read "
                                           "latency per tier attempt "
                                           "[labels: backend]"),
    # -- push plane (net/push.py) ---------------------------------------
    "push.commits": ("counter", "map commits announced to the push "
                                "scheduler (MOFWriter on_commit)"),
    "push.subs": ("counter", "MSG_PUSH_SUB subscriptions accepted"),
    "push.chunks": ("counter", "MSG_PUSH chunks sent (supplier side)"),
    "push.bytes": ("counter", "MSG_PUSH payload bytes sent"),
    "push.acks": ("counter", "pushes the receiver accepted (PUSH_ACK)"),
    "push.nacks": ("counter", "pushes the receiver refused "
                              "[labels: reason]"),
    "push.errors": ("counter", "push chunk reads/encodes that failed "
                               "supplier-side (partition -> pull-only)"),
    "push.accepted": ("counter", "pushed chunks admitted into staging "
                                 "[labels: tier]"),
    "push.accepted.bytes": ("counter", "pushed bytes admitted into "
                                       "staging"),
    "push.refused": ("counter", "pushed chunks refused by the staging "
                                "admission ladder [labels: reason]"),
    "push.spilled.bytes": ("counter", "staged push bytes diverted to "
                                      "the spill tier"),
    "push.adopted": ("counter", "segments that started from a staged "
                                "push prefix (ckpt_preload adoption)"),
    "push.adopted.bytes": ("counter", "staged bytes adopted into "
                                      "segment offset ledgers"),
    "push.invalidated": ("counter", "staged push prefixes that failed "
                                    "re-crack/preload validation "
                                    "(degraded to a fresh fetch)"),
    "push.dial.failures": ("counter", "eager push-subscription dials "
                                      "that failed [labels: supplier]"),
    "push.on_air": ("gauge", "un-ACKed MSG_PUSH chunks in flight; "
                             "paired — every +1 must meet its -1 at "
                             "ACK/NACK/error/conn-drop (resledger "
                             "gauge.push.on_air)"),
    "push.staged.bytes": ("gauge", "bytes staged reduce-side awaiting "
                                   "adoption; paired — every +N must "
                                   "meet its -N at take()/close() "
                                   "(resledger gauge.push.staged)"),
}

# Dynamically-named families (f-string call sites): the static prefix
# must be listed here.
REGISTRY_PREFIXES = ("failpoint.", "anomaly.")

# The span-name registry: every literal name passed to
# ``metrics.start_span``/``metrics.span`` must be listed here. Span ids
# cross the wire on REQ/SIZE_REQ frames, so a supplier's serve span joins
# the reduce side's fetch span in one tree across processes (and across
# the two packages). Timer spans (``metrics.timer``) are named by their
# timer counter and are not part of this literal-name inventory.
SPAN_REGISTRY: Dict[str, str] = {
    "reduce_task": "root of one reduce task's trace tree "
                   "(merger/merge_manager.py)",
    "fetch.segment": "one partition's whole fetch, child of "
                     "reduce_task (merger/segment.py)",
    "net.fetch": "one chunk request on the wire, reduce side "
                 "(net/client.py); its (trace, span) ids ride the REQ "
                 "frame",
    "net.size_probe": "partition size probe over the wire "
                      "(net/client.py)",
    "net.serve": "one REQ served, supplier side (net/server.py); "
                 "adopts the wire-carried trace context so it is a "
                 "child of the remote net.fetch",
    "net.stats": "one MSG_STATS introspection poll, client side "
                 "(net/client.py)",
    "net.job_bind": "one MSG_JOB tenant registration round trip, "
                    "client side (net/client.py)",
    "engine.pread": "one DataEngine chunk read/plan, child of the "
                    "serve (or local fetch) span "
                    "(mofserver/data_engine.py)",
    "engine.read_batch": "one batched read submission: per-fd "
                         "grouping + coalescing + vectored reads for "
                         "a whole request burst on one pool worker "
                         "(mofserver/data_engine.py submit_batch); "
                         "per-request engine.pread children adopt "
                         "each request's own serve span",
    "merge.wait": "the overlap merge consumer blocked waiting for the "
                  "next staged run (merger/overlap.py); the span twin "
                  "of the merge.wait_ms histogram — critpath's 'wait' "
                  "bucket",
    "merge.device_put": "host->device transfer of one staged run plus "
                        "the buffer-recycle completion wait "
                        "(merger/overlap.py); critpath's 'device_put' "
                        "bucket",
}

class PortTimer(NamedTuple):
    """One port-only timer: what it times, the critical-path stage bucket
    its spans and counter count towards (``utils/critpath``), and whether
    its counter joins critpath's busy sums from counters. ``busy`` is
    False where another timer's counter already holds the time: the timer
    nests inside another port timer (named in ``doc``), or holds other
    timers (``emit_phase``), or is a wall with waits in it
    (``coding_recover``)."""

    doc: str
    bucket: str
    busy: bool = True


# The port's own timers (names the reference does not have), each keeping
# a ``<name>_time`` counter (``metrics.timer``, ``start_timer``,
# ``add_time``) and, for the first two with spans on, a span of its name.
# The one table of them: utils/critpath derives PORT_SPAN_BUCKETS and the
# port rows of buckets_from_counters from it. SPAN_REGISTRY stays the
# reference's; METRICS_REGISTRY is the reference's and PORT_METRICS.
PORT_TIMERS: Dict[str, PortTimer] = {
    # the emit (merger/emitter.py, merger/streaming.py): emission, the
    # reference's bucket for "emit"
    "emit_phase": PortTimer(
        "a whole delivery loop of the FramedEmitter, the piece generator's "
        "pulls included (merger/emitter.py); holds the emit stages below "
        "and the reference's emit", "serve", busy=False),
    "emit_readback": PortTimer(
        "one slab's card-to-host read (merger/streaming.py "
        "iter_row_slabs)", "serve"),
    "emit_gather": PortTimer(
        "one slab's grouping by segment and gather of its records "
        "(merger/streaming.py frame_slabs, interleave_runs)", "serve"),
    "emit_frame": PortTimer(
        "framing one slab or chunk (native.frame_batch)", "serve"),
    "emit_tiefix": PortTimer(
        "one slab's re-sort of its blocks of equal-prefix keys past the "
        "carried width, by their whole content (merger/streaming.py "
        "tiefix_slabs)", "serve"),
    "emit_deliver": PortTimer(
        "copying framed bytes into an arena slot, with the slot's acquire "
        "and release (merger/emitter.py)", "serve"),
    # the socket client (net/client.py): busy on its loop and dispatcher
    # threads beside the task's fetch phase
    "net_read": PortTimer(
        "the client loop thread's read of one ready supplier socket: "
        "recv_into, header decode and frame completion up to the "
        "dispatcher hand-off (net/client.py _do_read)", "fetch"),
    "net_recv": PortTimer(
        "the recv_into calls of one net_read, summed and added once per "
        "read (net/client.py _do_read, add_time); nests in net_read",
        "fetch", busy=False),
    "net_deliver": PortTimer(
        "the dispatcher thread's completion upcall of one request, a "
        "Segment's on_complete (net/client.py _deliver)", "fetch"),
    # a fetch completion (merger/segment.py), on whichever thread
    # delivers it: on the wire all three nest in net_deliver
    "fetch_crack": PortTimer(
        "one chunk's carry concat, crack_partial and carry slice "
        "(merger/segment.py _ingest); nests in net_deliver on the wire",
        "fetch", busy=False),
    "fetch_handoff": PortTimer(
        "a finished segment's on_done upcall: the overlapped merger's "
        "feed with its budget and queue waits, the fetch's backpressure "
        "(merger/segment.py _notify_done); nests in net_deliver on the "
        "wire", "fetch", busy=False),
    "fetch_issue": PortTimer(
        "the next chunk's request, issued by a completion's fetch loop "
        "(merger/segment.py _drive -> _try_issue); nests in net_deliver "
        "on the wire", "fetch", busy=False),
    # a dead supplier's partitions rebuilt from shards (coding/)
    "coding_recover": PortTimer(
        "one partition's k-of-n reconstruction, from the Segment's "
        "reconstruction rung to the decoded partition reaching it: shard "
        "streams and decode (merger/segment.py _try_recover, a "
        "start_timer); a wall, waits included", "fetch", busy=False),
    # a speculated chunk's race (merger/segment.py)
    "fetch_hedge": PortTimer(
        "one speculated chunk's race, from its primary attempt's issue to "
        "the completion that settles it: the straggler threshold's wait "
        "and the winner's fetch (merger/segment.py _maybe_speculate, a "
        "start_timer backdated to the issue); a wall, waits included",
        "fetch", busy=False),
    "coding_decode": PortTimer(
        "one stripe's Reed-Solomon decode on the host (coding/recovery.py, "
        "coding.rs.decode); nests in net_deliver or the fetch phase",
        "fetch", busy=False),
    # the reduce task's thread (merger/merge_manager.py) and the
    # transport's stop: with fetch, merge and emit_phase they cover run()
    # and the client's stop
    "task_setup": PortTimer(
        "MergeManager.run's entry to the fetch phase: watchdog, stats "
        "provider, routing, the OverlappedMerger's construction, the "
        "segments' (a start_timer)", "other"),
    "merge_collect": PortTimer(
        "the fetched segments' record batches (or their record count) "
        "collected for the finish (merger/merge_manager.py _run)",
        "merge"),
    "task_teardown": PortTimer(
        "the emit's return to MergeManager.run's return: the merger's "
        "finish cleanup and run's own (a start_timer)", "other"),
    "client_stop": PortTimer(
        "a transport's stop (merger/segment.py HostRoutingClient.stop, "
        "net/client.py RemoteFetchClient.stop); the routing client's "
        "ends before its connections' own begin", "fetch"),
}

# The port's own entries of METRICS_REGISTRY (names the reference does
# not have).
PORT_METRICS = ("fetch.hedged.bytes", "supplier.reads.dropped")

# snapshot() aliases for the reference's per-reduce-task aggregate trio
# (reducer.h:80-90): alias name -> source timer counter.
PARITY_ALIASES = {
    "total_wait_mem_time": "wait_mem_time",
    "total_fetch_time": "fetch_time",
    "total_merge_time": "merge_time",
}

# Fixed histogram buckets: powers of two from 1/16 to 2^30, shared by
# every histogram (latencies in ms and sizes in bytes both fit; fixed
# buckets keep observe() O(log buckets) with no per-histogram config).
_BUCKET_EDGES = tuple(float(2.0 ** e) for e in range(-4, 31))


class _Hist:
    """One fixed-bucket histogram series (caller holds the metrics
    lock)."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts = [0] * (len(_BUCKET_EDGES) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(_BUCKET_EDGES, value)] += 1
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)

    def percentile(self, p: float) -> float:
        """Bucket-interpolated percentile estimate (exact min/max at the
        tails; linear within the containing bucket)."""
        if self.count == 0:
            return 0.0
        target = self.count * p / 100.0
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = _BUCKET_EDGES[i - 1] if i > 0 else 0.0
                hi = (_BUCKET_EDGES[i] if i < len(_BUCKET_EDGES)
                      else self.vmax)
                frac = (target - seen) / c
                return min(max(lo + (hi - lo) * frac, self.vmin), self.vmax)
            seen += c
        return self.vmax

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        # "buckets": the non-empty bucket boundaries+counts as
        # [upper_edge, count] pairs (upper_edge None = the overflow
        # bucket past 2^30), so exported summaries carry enough to
        # recompute ARBITRARY percentiles offline
        # (percentile_from_summary — perfwatch/critpath consume it);
        # p50/p95/p99 stay inline for existing consumers
        buckets = [[(_BUCKET_EDGES[i] if i < len(_BUCKET_EDGES)
                     else None), c]
                   for i, c in enumerate(self.counts) if c]
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "buckets": buckets}


def percentile_from_summary(summary: Dict, p: float) -> float:
    """Recompute an arbitrary percentile OFFLINE from an exported
    histogram summary's ``buckets`` boundaries+counts — the exact
    estimator :meth:`_Hist.percentile` runs live, so perfwatch and
    critpath read the same numbers from a BENCH_*.json telemetry block
    that a live poll would have returned. Returns 0.0 for an empty or
    bucket-less summary (a pre-bucket export degrades to its inline
    p50/p95/p99 only)."""
    count = summary.get("count", 0)
    buckets = summary.get("buckets")
    if not count or not buckets:
        return 0.0
    vmin = summary.get("min", 0.0)
    vmax = summary.get("max", 0.0)
    target = count * p / 100.0
    seen = 0
    for le, c in buckets:
        if seen + c >= target:
            if le is None:  # the overflow bucket past the last edge
                lo, hi = _BUCKET_EDGES[-1], vmax
            else:
                i = bisect.bisect_left(_BUCKET_EDGES, le)
                lo = _BUCKET_EDGES[i - 1] if i > 0 else 0.0
                hi = le
            frac = (target - seen) / c
            return min(max(lo + (hi - lo) * frac, vmin), vmax)
        seen += c
    return vmax


def _series_key(name: str, labels: dict) -> str:
    """Stable series key: ``name{k=v,...}`` with sorted label keys."""
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


# -- thread -> active span registry (the sampling profiler's view) -----------
# The contextvar above is readable only from its own thread; the
# sampling profiler (utils/profiler.py) attributes another thread's
# stack samples, so span()/use_span() ALSO mirror the current span into
# this plain dict — but only while a profiler has asked for it
# (enable_thread_span_registry), keeping the unprofiled span path at
# one module-global check. Dict get/set/del are GIL-atomic; the sampler
# reads racily by design (a sample landing one span early/late is
# sampling noise, not corruption).
_THREAD_SPANS: Dict[int, "Span"] = {}
_THREAD_REG_ON = False


def enable_thread_span_registry(on: bool) -> None:
    global _THREAD_REG_ON
    _THREAD_REG_ON = bool(on)
    if not on:
        _THREAD_SPANS.clear()


def active_span_of_thread(tid: int) -> Optional["Span"]:
    """The span currently adopted by thread ``tid`` (None when the
    thread runs outside any span, or the registry is off)."""
    return _THREAD_SPANS.get(tid)


_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("uda_tpu_current_span", default=None)


class Span:
    """One span of the trace tree. ``end()`` records it (idempotent);
    attributes may be added at end time (e.g. error status). A span is
    safe to end from a different thread than the one that started it —
    the recorded ``tid`` is the *starting* thread (that's the lane the
    work queued on)."""

    __slots__ = ("_metrics", "name", "trace_id", "span_id", "parent_id",
                 "t0", "attrs", "tid", "_ended", "chain")

    def __init__(self, metrics_obj: "Metrics", name: str,
                 trace_id: int, span_id: int, parent_id: Optional[int],
                 attrs: dict, chain: tuple = ()):
        self._metrics = metrics_obj
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.attrs = attrs
        self.tid = threading.get_ident()
        self._ended = False
        # root->self name chain: lets the profiler charge a sample to
        # every enclosing span ("total" attribution) without needing
        # live parent object references
        self.chain = chain or (name,)

    def end(self, **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        dur = time.perf_counter() - self.t0
        if attrs:
            self.attrs.update(attrs)
        self._metrics._record_span(self, dur)


class OpenTimer:
    """A running :meth:`Metrics.start_timer`; ``stop()`` is idempotent
    and safe from any thread."""

    __slots__ = ("_metrics", "name", "span", "_t0", "_stopped")

    def __init__(self, metrics_obj: "Metrics", name: str, span,
                 t0: Optional[float] = None) -> None:
        self._metrics = metrics_obj
        self.name = name
        self.span = span
        self._t0 = time.perf_counter() if t0 is None else t0
        self._stopped = False

    def stop(self, **attrs) -> None:
        dt = time.perf_counter() - self._t0
        m = self._metrics
        with m._lock:
            if self._stopped:
                return
            self._stopped = True
            m.counters[self.name + "_time"] += dt
        self.span.end(**attrs)


class _NoopSpan:
    """Returned by start_span while spans are disabled: absorbing
    end()/attrs at zero recording cost."""

    __slots__ = ()
    name = ""
    trace_id = span_id = parent_id = None
    attrs: dict = {}
    chain: tuple = ()

    def end(self, **attrs) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class _RemoteParent:
    """A parent that lives in ANOTHER process: the (trace_id,
    parent_span_id) pair a REQ/SIZE_REQ frame carried over the wire
    (net/wire.py). Quacks enough like a Span for
    ``start_span(parent=...)`` — the supplier-side serve span then
    joins the reduce-side fetch span's tree, and
    the reference's ``scripts/trace_merge.py`` stitches the two processes' span files
    on exactly these ids."""

    __slots__ = ("trace_id", "span_id")
    parent_id = None
    attrs: dict = {}

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class Metrics:
    """Process-wide metrics hub. Counters and gauges are always live
    (two dict writes under one lock); histograms and spans cost nothing
    until enabled."""

    def __init__(self, stats: Optional[bool] = None,
                 ledger=None) -> None:
        # lockdep-tracked (utils/locks.py): the metrics hub is a LEAF
        # lock — every layer counts under its own locks, so an edge
        # OUT of "metrics" would itself be a design smell
        self._lock = TrackedLock("metrics")
        # the ResourceLedger mirroring paired gauges (utils/resledger):
        # only the global hub carries one — private Metrics() fixtures
        # must never feed the process-wide obligation books
        self._ledger = ledger
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, _Hist] = {}
        # histograms recorded with stats off too (keep_histogram)
        self._kept: set = set()
        self.spans: list[dict] = []
        # construction-time default, restored by reset(): the global
        # instance takes it from UDA_TPU_STATS so a whole process can be
        # switched on from the environment
        self._default_stats = (stats_enabled_from_env() if stats is None
                               else bool(stats))
        self._hist_enabled = self._default_stats
        self._spans_enabled = self._default_stats
        self._next_id = 0
        # span/trace ids must be unique ACROSS processes (they cross
        # the wire and are merged by scripts/trace_merge.py): ids are
        # base + counter with a random per-process 32-bit base in the
        # high half of a u64 — collisions between two processes of one
        # job are 2^-32-grade, and ids still fit the wire's u64 fields
        self._id_base = int.from_bytes(os.urandom(4), "big") << 32
        # wall-clock anchor: spans record perf_counter() timestamps
        # (monotonic, process-local); exports convert through this
        # (wall, perf) pair so two processes' spans land on one
        # comparable timeline
        self._anchor = (time.time(), time.perf_counter())

    # -- enablement ---------------------------------------------------------

    def enable_stats(self) -> None:
        """Turn on the optional layers (histograms + spans). Idempotent."""
        self._hist_enabled = True
        self._spans_enabled = True

    def disable_stats(self) -> None:
        self._hist_enabled = False
        self._spans_enabled = False

    def enable_spans(self) -> None:
        """Idempotent: span recording on (histograms untouched)."""
        self._spans_enabled = True

    def disable_spans(self) -> None:
        self._spans_enabled = False

    @property
    def stats_enabled(self) -> bool:
        return self._hist_enabled

    @property
    def record_spans(self) -> bool:
        """Attribute-style span toggle (``m.record_spans = True``)."""
        return self._spans_enabled

    @record_spans.setter
    def record_spans(self, on: bool) -> None:
        self._spans_enabled = bool(on)

    # -- counters -----------------------------------------------------------

    def add(self, name: str, value: float = 1.0, **labels) -> None:
        """Accumulate a counter. With labels, BOTH the unlabeled total
        ``name`` and the series ``name{k=v,...}`` advance, so existing
        total-based assertions and dashboards keep working."""
        if labels:
            skey = _series_key(name, labels)
            with self._lock:
                self.counters[name] += value
                self.counters[skey] += value
        else:
            with self._lock:
                self.counters[name] += value

    # -- gauges -------------------------------------------------------------

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a gauge to an absolute level."""
        key = _series_key(name, labels) if labels else name
        with self._lock:
            self.gauges[key] = value

    def gauge_add(self, name: str, delta: float, **labels) -> None:
        """Adjust a gauge by ``delta`` (the on-air increment/decrement
        idiom of the reference's AIO counters). Paired gauges (the
        increment-must-meet-decrement set, resledger.PAIRED_GAUGES)
        additionally flow through the armed ResourceLedger, so a +1
        whose -1 never lands is reported with the +1's stack at the
        next drain point."""
        key = _series_key(name, labels) if labels else name
        with self._lock:
            self.gauges[key] = self.gauges.get(key, 0.0) + delta
        led = self._ledger
        if led is not None and led.enabled and not labels:
            led.note_gauge(name, delta)

    # -- histograms ---------------------------------------------------------

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram sample. No-op until stats are enabled —
        the disabled fast path is a single attribute check — except for
        a kept histogram (:meth:`keep_histogram`), whose unlabelled
        series records either way."""
        if not self._hist_enabled:
            if name not in self._kept:
                return
            labels = {}
        keys = [name]
        if labels:
            keys.append(_series_key(name, labels))
        with self._lock:
            for key in keys:
                h = self.histograms.get(key)
                if h is None:
                    h = self.histograms[key] = _Hist()
                h.observe(value)

    def keep_histogram(self, name: str) -> None:
        """Record histogram ``name`` (its unlabelled series) while stats
        are off too, until :meth:`reset`: for a reader that decides on
        it, as the fetch straggler threshold decides on
        ``fetch.latency_ms`` (``SpeculationPolicy.threshold_ms``)."""
        with self._lock:
            self._kept.add(name)

    def histogram(self, name: str, **labels) -> Dict[str, float]:
        """``{"count", "sum", "max"}`` of one histogram series (count 0
        when it has no sample)."""
        key = _series_key(name, labels) if labels else name
        with self._lock:
            h = self.histograms.get(key)
            if h is None or h.count == 0:
                return {"count": 0, "sum": 0.0, "max": 0.0}
            return {"count": h.count, "sum": h.total, "max": h.vmax}

    def histogram_summaries(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: h.summary() for k, h in self.histograms.items()}

    def percentile(self, name: str, p: float,
                   **labels) -> Optional[float]:
        """A live percentile estimate of one histogram series, or None
        when the series has no samples (stats disabled and the series not
        kept, or nothing observed yet) — callers degrade to their own
        floor. Used by the fetch straggler detector
        (SpeculationPolicy.threshold_ms)."""
        key = _series_key(name, labels) if labels else name
        with self._lock:
            h = self.histograms.get(key)
            if h is None or h.count == 0:
                return None
            return h.percentile(p)

    # -- spans --------------------------------------------------------------

    def _new_ids(self, parent: Optional[Span]) -> tuple[int, int, Optional[int]]:
        with self._lock:
            self._next_id += 1
            sid = self._id_base + self._next_id
        if parent is not None and parent.span_id is not None:
            return parent.trace_id, sid, parent.span_id
        return sid, sid, None  # root: trace id = own span id

    @staticmethod
    def remote_parent(trace_id: int, span_id: int):
        """Wrap a wire-carried (trace_id, parent_span_id) pair as a
        ``start_span(parent=...)`` argument — the supplier side of
        cross-process trace propagation. (The CLIENT side stamps its
        own request span's ids onto the frame, gated by the peer's
        CAP_TRACE — EvLoopFetchClient._trace_of — so there is
        deliberately no context-var convenience here that could bypass
        the capability gate.)"""
        return _RemoteParent(trace_id, span_id)

    def start_span(self, name: str, parent: Optional[Span] = None,
                   **attrs) -> Span:
        """Begin a span. ``parent`` defaults to the calling thread's
        current span (contextvar); pass an explicit parent to propagate
        the tree across threads (e.g. a transport completion thread
        ending work that a merge-thread span fathered). Returns a no-op
        span while recording is disabled."""
        if not self._spans_enabled:
            return _NOOP_SPAN
        if parent is None:
            parent = _current_span.get()
        trace_id, span_id, parent_id = self._new_ids(parent)
        chain = (parent.chain + (name,)
                 if isinstance(parent, Span) else (name,))
        return Span(self, name, trace_id, span_id, parent_id, attrs,
                    chain=chain)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> Iterator[Span]:
        """Context-managed span that also becomes the thread's current
        span for the duration, so nested spans/timers parent under it."""
        s = self.start_span(name, parent=parent, **attrs)
        if s is _NOOP_SPAN:
            yield s
            return
        token = _current_span.set(s)
        tid = prev = None
        if _THREAD_REG_ON:
            tid = threading.get_ident()
            prev = _THREAD_SPANS.get(tid)
            _THREAD_SPANS[tid] = s
        try:
            yield s
        finally:
            if tid is not None:
                if prev is not None:
                    _THREAD_SPANS[tid] = prev
                else:
                    _THREAD_SPANS.pop(tid, None)
            _current_span.reset(token)
            s.end()

    @contextlib.contextmanager
    def use_span(self, span: Optional[Span]) -> Iterator[None]:
        """Make an existing span the current one on THIS thread (without
        ending it on exit) — the cross-thread propagation shim: a worker
        adopts the span its work item was fathered under."""
        if span is None or isinstance(span, _NoopSpan) \
                or not self._spans_enabled:
            yield
            return
        token = _current_span.set(span)
        tid = prev = None
        if _THREAD_REG_ON:
            tid = threading.get_ident()
            prev = _THREAD_SPANS.get(tid)
            _THREAD_SPANS[tid] = span
        try:
            yield
        finally:
            if tid is not None:
                if prev is not None:
                    _THREAD_SPANS[tid] = prev
                else:
                    _THREAD_SPANS.pop(tid, None)
            _current_span.reset(token)

    def current_span(self) -> Optional[Span]:
        """The calling thread's innermost open span (None outside any)."""
        if not self._spans_enabled:
            return None
        return _current_span.get()

    def _record_span(self, span: Span, dur: float) -> None:
        rec = {"name": span.name, "ts": span.t0, "dur": dur,
               "tid": span.tid, "trace": span.trace_id, "id": span.span_id,
               "parent": span.parent_id}
        if span.attrs:
            rec["attrs"] = dict(span.attrs)
        with self._lock:
            if self._spans_enabled:  # disabled mid-flight: drop
                self.spans.append(rec)

    @contextlib.contextmanager
    def timer(self, name: str, *,
              parent: Optional[Span] = None) -> Iterator[None]:
        """Phase timer: accumulates ``<name>_time`` seconds and (when
        spans are on) records a span parented under ``parent``, by
        default the thread's current span."""
        if self._spans_enabled:
            with self.span(name, parent=parent):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    dt = time.perf_counter() - t0
                    with self._lock:
                        self.counters[name + "_time"] += dt
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.counters[name + "_time"] += dt

    def start_timer(self, name: str, *, parent: Optional[Span] = None,
                    t0: Optional[float] = None) -> "OpenTimer":
        """The phase timer of work that ends on another thread than the
        one that starts it (a completion-driven chain): ``stop()`` on the
        returned handle accumulates ``<name>_time`` and ends its span
        (when spans are on), started here under ``parent``, by default
        the thread's current span. The span is not made current; adopt
        it with ``use_span(handle.span)``. ``t0``, an earlier
        ``time.perf_counter()`` reading, starts the timer and its span
        there: work whose start is known only once it is under way."""
        span = self.start_span(name, parent=parent)
        if t0 is not None and isinstance(span, Span):
            span.t0 = t0
        return OpenTimer(self, name, span, t0)

    def add_time(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to the ``<name>_time`` counter a timer keeps,
        with no span: the sum of many short calls timed by the caller
        (a span for each would cost more than the call)."""
        with self._lock:
            self.counters[name + "_time"] += seconds

    # -- reads --------------------------------------------------------------

    def get(self, name: str, **labels) -> float:
        """One counter's current value (0.0 when never incremented);
        with labels, the labeled series' value."""
        key = _series_key(name, labels) if labels else name
        with self._lock:
            return self.counters.get(key, 0.0)

    def get_gauge(self, name: str, **labels) -> float:
        key = _series_key(name, labels) if labels else name
        with self._lock:
            return self.gauges.get(key, 0.0)

    def snapshot(self) -> Dict[str, float]:
        """Counters (labeled series included), plus the reference-parity
        per-task aggregate aliases (PARITY_ALIASES) whenever their
        source timers have fired."""
        with self._lock:
            snap = dict(self.counters)
        for alias, source in PARITY_ALIASES.items():
            if source in snap:
                snap[alias] = snap[source]
        return snap

    def gauges_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.gauges)

    def reset(self) -> None:
        """Restore a fully pristine state: counters, gauges, histograms
        and spans cleared; histogram/span enablement back to the
        construction-time default (so a test that called enable_spans()
        cannot leak recording into the next test)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self._kept.clear()
            self.spans.clear()
            self._hist_enabled = self._default_stats
            self._spans_enabled = self._default_stats

    # -- export -------------------------------------------------------------

    def export_chrome_trace(self, path: str) -> None:
        """Write spans in Chrome trace-event format (load in Perfetto).
        Span attributes plus trace/span/parent ids ride in ``args`` so
        host lanes can be correlated with ``device_trace`` captures and
        the tree reconstructed."""
        with self._lock:
            spans = list(self.spans)
        events = [{"name": s["name"], "ph": "X", "pid": 0,
                   "tid": s["tid"], "ts": s["ts"] * 1e6,
                   "dur": s["dur"] * 1e6, "args": _span_args(s)}
                  for s in spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    def export_spans_jsonl(self, path: str, append: bool = False) -> int:
        """Write the recorded spans as JSON lines — the PER-PROCESS
        half of cross-process tracing. Each line carries the span
        record plus ``pid`` and ``ts_unix`` (the perf_counter start
        converted through this process's wall-clock anchor), so
        the reference's ``scripts/trace_merge.py`` can stitch several processes' files
        into one Perfetto-loadable timeline keyed by trace id. Returns
        the number of spans written."""
        anchor_wall, anchor_perf = self._anchor
        with self._lock:
            spans = list(self.spans)
        pid = os.getpid()
        with open(path, "a" if append else "w") as f:
            for s in spans:
                rec = dict(s)
                rec["pid"] = pid
                rec["ts_unix"] = anchor_wall + (s["ts"] - anchor_perf)
                f.write(json.dumps(rec) + "\n")
            # the profiler's per-span sample summaries ride the same
            # file as `kind: "profile"` records (scripts/trace_merge.py
            # renders them as a profile lane next to the span lanes);
            # lazy import + total: an unprofiled or half-torn-down
            # process still exports its spans
            try:
                from uda_tpu_torch.utils.profiler import profiler
                for rec in profiler.export_records(pid=pid):
                    f.write(json.dumps(rec) + "\n")
            except Exception:  # udalint: disable=UDA006 - profile
                pass  # lanes are additive; span export must not fail
        return len(spans)


def stats_enabled_from_env() -> bool:
    """UDA_TPU_STATS=1 (or true/yes/on) turns the optional layers on for
    the whole process."""
    return os.environ.get("UDA_TPU_STATS", "").strip().lower() in (
        "1", "true", "yes", "on")


_TRACE_SEQ = [0]


def _span_args(span: dict) -> dict:
    """A span record's Chrome-trace ``args``: its attributes plus the
    trace, span and parent ids, so the tree can be rebuilt."""
    args = dict(span.get("attrs") or {})
    for k, arg in (("trace", "trace_id"), ("id", "span_id"),
                   ("parent", "parent_id")):
        if span.get(k) is not None:
            args[arg] = span[k]
    return args


# the two zero-length profiler ranges that tie the program's spans
# (perf_counter seconds) to the profiler's clock in a device_trace file
TRACE_ANCHOR = "uda.trace_anchor"
TRACE_ANCHOR_END = "uda.trace_anchor_end"


def _spans_onto_trace(path: str, spans: list, anchor_ns: int,
                      anchor_end_ns: int) -> None:
    """Add ``spans`` (the hub's records) to the Chrome trace at ``path``
    as complete events of a process lane of their own, on the profiler's
    clock: the two anchor ranges' starts in the file against the
    ``perf_counter_ns`` read just before each was entered give the
    offset and the rate (the clocks' rates differ by about a part in a
    thousand)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    marks = {e["name"]: float(e["ts"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in (TRACE_ANCHOR, TRACE_ANCHOR_END)}
    if len(marks) != 2 or anchor_end_ns <= anchor_ns:
        return
    # profiler microseconds per perf_counter nanosecond
    rate = (marks[TRACE_ANCHOR_END] - marks[TRACE_ANCHOR]) \
        / (anchor_end_ns - anchor_ns)
    pid = 1 + max([e["pid"] for e in events
                   if isinstance(e.get("pid"), int)], default=0)
    events.append({"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": "uda_tpu_torch spans"}})
    events.extend({"name": sp["name"], "ph": "X", "cat": "uda_span",
                   "pid": pid, "tid": sp["tid"],
                   "ts": marks[TRACE_ANCHOR]
                   + (sp["ts"] * 1e9 - anchor_ns) * rate,
                   "dur": sp["dur"] * 1e9 * rate, "args": _span_args(sp)}
                  for sp in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def device_trace(log_dir: str | None = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host ops and, with a card, its
    kernels and copies) around a block and write it as a Chrome trace,
    ``uda_trace_<pid>_<seq>.json``, into ``log_dir`` or
    ``UDA_TPU_XPROF=<dir>``; a no-op when neither is set. The spans the
    hub records during the block (spans on: stats enabled) join the
    trace on the profiler's clock, in a lane of their own, through the
    ``TRACE_ANCHOR`` and ``TRACE_ANCHOR_END`` ranges. Stacks and shapes
    are not recorded. A profiler that cannot start or stop is logged,
    never raised: profiling must not take down the job."""
    d = log_dir or os.environ.get("UDA_TPU_XPROF")
    if not d:
        yield
        return
    from uda_tpu_torch.utils.logging import get_logger

    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, record_shapes=False,
                       with_stack=False, profile_memory=False)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 - profiling is best-effort
        get_logger().warn(f"device trace unavailable: {e}")
        yield
        return
    first = len(metrics.spans)
    # a range's start is stamped as it is entered: read the clock just
    # before
    anchor_ns = time.perf_counter_ns()
    with record_function(TRACE_ANCHOR):
        pass
    try:
        yield
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            anchor_end_ns = time.perf_counter_ns()
            with record_function(TRACE_ANCHOR_END):
                pass
            prof.__exit__(None, None, None)
            _TRACE_SEQ[0] += 1
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"uda_trace_{os.getpid()}_{_TRACE_SEQ[0]}.json")
            prof.export_chrome_trace(path)
            with metrics._lock:
                # a reset inside the block leaves only the block's spans
                spans = list(metrics.spans[first:]
                             if len(metrics.spans) >= first
                             else metrics.spans)
            if spans:
                _spans_onto_trace(path, spans, anchor_ns, anchor_end_ns)
        except Exception as e:  # noqa: BLE001
            get_logger().warn(f"device trace stop failed: {e}")


metrics = Metrics(ledger=_resledger)
