"""Unified configuration registry.

The port's copy of ``uda_tpu/utils/config.py``: every key, type and
default of the reference, so both packages read the same configs. Keys
that name a module the port does not have yet are declared all the
same; the modules that read them refuse values they cannot honour
(``uda_tpu_torch/merger/merge_manager.py``).

The reference spreads configuration across three channels (SURVEY §5):
argv options parsed by getopt_long (``-w/-r/-a/-m/-g/-t/-s``, reference
src/CommUtils/C2JNexus.cc:43-137), positional INIT-message params
(reference src/Merger/reducer.cc:56-99), and a pull-based ``getConfData``
up-call for late-bound keys (reference src/UdaBridge.cc:419-438). The
registry unifies them: every known flag is declared once with its
reference key, type and default (the full inventory from the reference is
reproduced below), with the reference's getopt short option where it has
one; ``Config.from_argv`` accepts the same short options the reference's
``parse_options`` does, and a ``conf_source`` callable serves late-bound
lookups (the getConfData channel).

TPU-specific knobs (mesh shape, HBM arena sizes, device record widths)
live in the same registry so there is exactly one way to configure the
framework.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from uda_tpu_torch.utils.errors import ConfigError

__all__ = ["Flag", "Config", "FLAGS"]


@dataclasses.dataclass(frozen=True)
class Flag:
    key: str                 # dotted config key (reference JobConf key where one exists)
    default: Any
    type: type
    help: str
    short: Optional[str] = None  # reference getopt short option, if any


# Full flag inventory. Reference keys keep their original names for
# compatibility with Hadoop-side configs; uda.tpu.* keys are new.
_FLAG_LIST = [
    # --- reference argv channel (C2JNexus.cc:43-137) ---
    Flag("mapred.rdma.wqe.per.conn", 256, int,
         "in-flight fetch window per peer (reference WQEs per connection)", "w"),
    Flag("mapred.rdma.cma.port", 9011, int,
         "control-plane port (reference rdma_cm port)", "r"),
    Flag("mapred.netmerger.merge.approach", 1, int,
         "1=online in-memory merge, 2=hybrid LPQ/RPQ merge, 0=auto "
         "(hybrid when the transport's size estimate is under "
         "uda.tpu.auto.approach.threshold.mb, bounded-memory streaming "
         "online otherwise or when the size is unknown)", "a"),
    Flag("uda.log.dir", "", str, "private log directory", "g"),
    Flag("uda.log.level", 4, int, "log severity 0..6 (lsNONE..lsTRACE)", "t"),
    Flag("mapred.rdma.buf.size", 1024, int,
         "staging buffer size in KB (reference RDMA buffer size)", "s"),
    # --- reference INIT/getConfData channel (reducer.cc, UdaPlugin.java) ---
    Flag("mapred.rdma.buf.size.min", 16, int, "minimum staging buffer KB"),
    Flag("mapred.rdma.shuffle.total.size", 0, int,
         "total shuffle memory budget in bytes (0 = derive from percent)"),
    Flag("mapred.job.shuffle.input.buffer.percent", 0.7, float,
         "fraction of available memory for shuffle when total.size unset"),
    Flag("mapred.netmerger.hybrid.lpq.size", 0, int,
         "segments per LPQ in hybrid merge (0 = sqrt(num_maps))"),
    Flag("mapred.rdma.num.parallel.lpqs", 0, int,
         "concurrent LPQs in hybrid merge (0 -> 3)"),
    Flag("mapred.rdma.compression.buffer.ratio", 0.20, float,
         "fraction of each buffer pair used for compressed data"),
    Flag("mapred.uda.log.to.unique.file", "", str,
         "when set, log to a private file instead of the up-call sink"),
    Flag("mapred.uda.provider.blocked.threads.per.disk", 1, int,
         "reader threads per local dir in the supplier data engine"),
    Flag("mapred.local.dir", "", str,
         "comma-separated task-local dirs (the Hadoop key); the bridge "
         "resolves spill directories from it when uda.tpu.spill.dirs "
         "is unset (reference LocalDirAllocator rotation)"),
    Flag("mapred.rdma.developer.mode", False, bool,
         "abort on failure instead of falling back to vanilla"),
    Flag("mapred.compress.map.output", False, bool, "map outputs are compressed"),
    Flag("mapred.map.output.compression.codec", "", str,
         "codec class name (Lzo/Snappy accepted, like reference createInputClient)"),
    Flag("io.compression.codec.snappy.buffersize", 256 * 1024, int,
         "snappy block size"),
    Flag("io.compression.codec.lzo.buffersize", 256 * 1024, int,
         "lzo block size"),
    # --- TPU-native knobs (new in this framework) ---
    Flag("uda.tpu.mesh.shape", "", str,
         "device mesh as 'dp:N,sh:M' axis list; empty = 1D over all devices"),
    Flag("uda.tpu.key.width", 16, int,
         "normalized key bytes carried in device sort columns (multiple of 4)"),
    Flag("uda.tpu.run.records", 1 << 20, int,
         "records per HBM-resident sorted run before spilling"),
    Flag("uda.tpu.fetch.retries", 3, int,
         "whole-segment re-fetch attempts after a transport error (the "
         "reference retries its RDMA connect dance 5x, RDMAClient.cc:41)"),
    Flag("uda.tpu.arena.slots", 16, int,
         "buffer-pair slots in the HBM staging arena"),
    Flag("uda.tpu.exchange.chunk.records", 1 << 18, int,
         "records per all-to-all exchange round (windowing, replaces the "
         "reference's 1000-chunk server pool)"),
    Flag("uda.tpu.use.native", True, bool,
         "use the C++ native codec/reader library when built"),
    Flag("uda.tpu.merge.overlap", True, bool,
         "overlap device merge with fetching (the network-levitated "
         "property); off = merge once after all fetches complete"),
    Flag("uda.tpu.spill.dirs", "", str,
         "comma-separated local dirs for LPQ spill files (round-robin, "
         "like the reference's local-dir rotation); empty = system tmp"),
    Flag("uda.tpu.online.streaming", False, bool,
         "online merge spools per-segment sorted runs to local disk and "
         "streams a permutation-driven interleave at emit, bounding host "
         "memory to the fetch window (the reference's 1 MB staging-loop "
         "memory model, StreamRW.cc:151-225); off = keep every segment "
         "host-resident through emission"),
    Flag("uda.tpu.online.stagers", 0, int,
         "overlap staging worker threads (pack+sort+spool per segment); "
         "0 = single merge thread (serial mode; with "
         "uda.tpu.stage.pipeline this is superseded by uda.tpu.stage.pool)"),
    # --- staged fetch->decompress->pack->stage pipeline (merger/overlap) ---
    Flag("uda.tpu.stage.pipeline", True, bool,
         "pipelined staging: a bounded stage-worker pool (decompress + "
         "vint-decode/pack + row build + spool, concurrent across "
         "segments, reusable pre-allocated host buffers) feeds ONE "
         "merge consumer that overlaps jax.device_put of the next run "
         "with the device merge of the current one. off = the serial "
         "stage-one-segment-at-a-time loop (the byte-identical "
         "correctness twin, scripts/bench_pipeline.py A/Bs the two)"),
    Flag("uda.tpu.stage.pool", 0, int,
         "stage-pipeline worker count; 0 = auto (a few workers, "
         "~min(4, cores) — staging is numpy-heavy and releases the "
         "GIL). Ignored when uda.tpu.stage.pipeline is off"),
    Flag("uda.tpu.stage.inflight.mb", 0, int,
         "in-flight staging budget in MB: bytes fed to the overlap "
         "merger but not yet merged/spooled; feed() blocks past it "
         "(transport backpressure, counted in "
         "stage.backpressure_events). 0 = auto: max(256 MB, 2x the "
         "fetch window), capped to half the host budget when one is "
         "already built (utils.budget.stage_inflight_cap)"),
    Flag("uda.tpu.merge.two_phase", "auto", str,
         "non-overlapped merge routing: 'on' = two-phase device sort "
         "(per-run partial sort + device-resident pairwise merge tree, "
         "ops.merge.merge_batches_two_phase), 'off' = whole-shuffle "
         "re-sort of the concatenation, 'auto' = two-phase on the "
         "accelerator (the merge tree on K1 in uda_tpu_torch) / re-sort "
         "on the CPU. Byte-identical either way"),
    # --- failure-domain knobs (failpoints + retrying fetch path) ---
    Flag("mapred.rdma.fetch.retry.backoff.ms", 0, int,
         "base exponential backoff between fetch retries in ms, doubling "
         "per attempt (0 = immediate retry, the reference's behavior)"),
    Flag("mapred.rdma.fetch.retry.backoff.max.ms", 2000, int,
         "exponential backoff cap in ms"),
    Flag("mapred.rdma.fetch.retry.jitter", 0.2, float,
         "+/- fraction of jitter applied to each backoff so failed "
         "segments do not re-issue in lockstep"),
    Flag("mapred.rdma.fetch.attempt.timeout.ms", 0, int,
         "per-attempt chunk fetch timeout in ms; a fetch the transport "
         "never completes is failed and retried (0 = wait forever)"),
    Flag("mapred.rdma.fetch.deadline.ms", 0, int,
         "overall per-segment fetch deadline in ms across all retries "
         "and backoffs (0 = none)"),
    Flag("uda.tpu.fetch.crc", False, bool,
         "supplier stamps each chunk with a CRC32 computed before any "
         "fault can mangle it; Segment validates and re-fetches a "
         "mismatched chunk once per offset before failing (compressed "
         "fetches validate the wire chunk inside DecompressingClient "
         "and recover via whole-segment retry)"),
    Flag("uda.tpu.fetch.penalty.threshold", 2, int,
         "transport faults before a supplier enters the penalty box "
         "(its remaining fetches are deprioritized in the schedule)"),
    Flag("uda.tpu.fetch.penalty.ms", 1000, int,
         "how long a penalized supplier stays deprioritized before it "
         "gets another chance"),
    Flag("uda.tpu.failpoints", "", str,
         "failpoint arming spec, same syntax as UDA_FAILPOINTS: "
         "comma-separated site=action[:arg][:trigger...] entries "
         "(uda_tpu.utils.failpoints)"),
    # --- survivable shuffle: speculation / resume / erasure coding ---
    Flag("uda.tpu.fetch.speculate.pn", 0, int,
         "straggler-detector percentile (pN) of the observed "
         "fetch.latency_ms histogram: an in-flight chunk fetch older "
         "than max(floor, pN) gets a speculative duplicate issued to "
         "the best PenaltyBox-ranked alternate source; first "
         "completion wins, the loser is discarded as a stale epoch "
         "(0 = speculation off)"),
    Flag("uda.tpu.fetch.speculate.floor.ms", 50, int,
         "minimum in-flight milliseconds before a fetch may be "
         "speculated, and the whole threshold while the latency "
         "histogram is empty (cold start; it records with stats off "
         "too while speculation is on)"),
    Flag("uda.tpu.fetch.resume", False, bool,
         "warm-resume on transport retry: keep the segment's offset "
         "ledger (fetched batches + carry) across a connection loss "
         "and continue mid-partition instead of refetching from zero, "
         "when the transport reports the source resumable "
         "(InputClient.resume_ok — warm supplier restart, immutable "
         "MOF); the first resumed chunk revalidates the partition's "
         "identity (raw_length) and falls back to a full restart on "
         "mismatch. off = the seed behavior (whole-segment re-fetch)"),
    Flag("uda.tpu.coding.scheme", "", str,
         "k-of-n erasure coding of map outputs as 'rs:k:n' "
         "(systematic Reed-Solomon over GF(2^8), uda_tpu.coding): "
         "map-side emit writes n-k parity chunks per partition stripe "
         "(parity section + v2 index) and the reduce side rebuilds a "
         "partition from ANY k of the n stripe chunks when its "
         "primary supplier is dead or penalized. empty = coding off; "
         "rs:k:k = chunked layout with zero parity (byte-identical "
         "data path)"),
    Flag("uda.tpu.coding.domains", "", str,
         "failure-domain map for stripe shard placement, "
         "'host=domain,host=domain,...'. The reduce side keys by "
         "canonical supplier HOST names and the writer by supplier "
         "ROOTS — declare BOTH namespaces in this one spec (extra "
         "keys are harmless; a spec matching neither side warns "
         "loudly and degrades to rotation). Declared domains spread "
         "each stripe's n shards "
         "round-robin ACROSS domains (no rack/power domain "
         "accumulates enough shards to make a stripe unrecoverable); "
         "undeclared hosts count as their own singleton domain; empty "
         "= the positional rotation over the sorted supplier list "
         "(the positional placement)"),
    Flag("uda.tpu.coding.scrub.s", 0, int,
         "background stripe-scrub interval in seconds: a low-priority "
         "daemon pass (one in flight per process, the "
         "tuncache.ensure_fresh idiom) re-verifies each coded map "
         "output's parity section against its data region and checks "
         "peer shard MOFs, counting coding.scrub.stripes / "
         "coding.scrub.repairs. 0 = scrub off (explicit scrub_roots "
         "calls still work)"),
    Flag("uda.tpu.coding.scrub.repair", False, bool,
         "let the scrub REBUILD lost or corrupt peer stripe shards "
         "from the primary's data+parity (proactive repair). Default "
         "off = dump-only: mismatches are counted and logged, bytes "
         "on disk are never touched"),
    Flag("uda.tpu.net.handoff.path", "", str,
         "supplier warm-restart handoff record: stop(drain=True) "
         "persists {generation, served-offset watermarks} to this "
         "path and the next start() advertises generation+1 with the "
         "warm flag in its accept banner, so reduce-side fetches "
         "resume from their own offset ledgers instead of refetching "
         "(uda.tpu.fetch.resume). empty = no persistence (every start "
         "mints a fresh cold generation)"),
    # --- network shuffle data plane (uda_tpu/net/) ---
    Flag("uda.tpu.net.listen", False, bool,
         "start a ShuffleServer (the TCP shuffle data plane, the "
         "reference's RDMAServer role) next to the role's DataEngine at "
         "INIT; stopped with the engine at EXIT/teardown"),
    Flag("uda.tpu.net.port", 9012, int,
         "shuffle data-plane TCP port: the server's bind port (0 = "
         "ephemeral) and the default port the socket fetch factory "
         "dials when a supplier host carries no ':port' suffix (one "
         "above the reference's 9011 control-plane rdma_cm port)"),
    Flag("uda.tpu.net.bind", "0.0.0.0", str,
         "listen address for the shuffle server"),
    Flag("uda.tpu.net.fetch", False, bool,
         "route reduce-side fetches over the socket data plane: INIT "
         "builds a HostRoutingClient whose default factory dials each "
         "supplier host's ShuffleServer (host[:port], one multiplexed "
         "connection per host) instead of a local in-process client"),
    Flag("uda.tpu.net.connect.timeout.s", 10.0, float,
         "TCP connect timeout per dial; a failed/timed-out dial "
         "completes the fetch with TransportError and the Segment's "
         "RetryPolicy paces the reconnect attempts"),
    Flag("uda.tpu.net.drain.s", 5.0, float,
         "graceful server stop: how long stop() lets in-flight "
         "responses flush before closing connections"),
    Flag("uda.tpu.net.sockbuf.kb", 0, int,
         "SO_SNDBUF/SO_RCVBUF for every data-plane socket in KB "
         "(server and client); 0 = leave the OS autotuned "
         "defaults. TCP_NODELAY is always set regardless — small "
         "REQ/SIZE frames must not eat Nagle delays"),
    Flag("uda.tpu.net.zerocopy", True, bool,
         "serve fd-cache-backed DATA chunks zero-copy so chunk bytes "
         "never transit the Python heap (event-loop core only); the "
         "byte path (sendmsg scatter-gather) is taken per-chunk "
         "whenever the chunk is not fd-backed: CRC stamping on, "
         "data_engine.pread failpoint armed, or a sendfile-refusing "
         "fd. off = always serve bytes"),
    Flag("uda.tpu.net.zerocopy.mode", "auto", str,
         "zero-copy mechanism: 'sendfile' (splice from the MOF fd), "
         "'mmap' (sendmsg memoryviews of the MOF's page-cache "
         "mapping — faster on kernels that emulate sendfile, e.g. "
         "sandboxed runtimes), or 'auto' (one-time per-process probe "
         "picks the faster; sendfile wins ties)"),
    # --- batched host-I/O plane (mofserver/data_engine.py) --------------
    Flag("uda.tpu.read.batch", "auto", str,
         "batched supplier reads: 'on'/'auto' = the event-loop serve "
         "path feeds byte-path request bursts to DataEngine."
         "submit_batch (per-fd grouping, range coalescing, one vectored "
         "read + one completion dispatch per batch — the RDMAbox "
         "batched-submission lesson); 'off' = today's one-pool-handoff-"
         "one-pread-per-chunk path, kept as the byte-identity "
         "correctness oracle (scripts/io_bench.py A/Bs the two). "
         "'auto' additionally lets the tuning cache "
         "(uda.tpu.tune.cache.path) refine the batch parameters"),
    Flag("uda.tpu.read.coalesce.gap.kb", 64, int,
         "coalescing gap threshold in KB: two queued reads of the same "
         "MOF whose ranges are closer than this merge into ONE "
         "vectored read (the gap bytes are read into scratch and "
         "discarded — a small waste that buys a syscall; "
         "io.coalesce.gap.bytes counts the waste). 0 = only strictly "
         "adjacent ranges coalesce"),
    Flag("uda.tpu.read.batch.max", 256, int,
         "max requests per submitted batch (the server flushes a "
         "burst at this bound); also caps one coalesced run at "
         "max*64 KB so scratch buffers stay bounded"),
    Flag("uda.tpu.read.backend", "auto", str,
         "batch read mechanism: 'io_uring' (native reader pool with "
         "the kernel ring, when compiled in AND the running kernel "
         "supports it), 'preadv' (one os.preadv per coalesced run), "
         "'pread' (per-request os.pread on the batch worker — still "
         "one pool handoff per batch). 'auto' walks that ladder "
         "downward; the selected rung is recorded as the io.backend "
         "metric label"),
    # --- online tuning cache (utils/tuncache.py) ------------------------
    Flag("uda.tpu.tune.cache.path", "", str,
         "persisted per-(key-shape, platform, backend) fly-off winner "
         "table (JSON) consulted by ops.sort.route_engine and the "
         "batched-I/O plane's parameters; populated by "
         "python -m uda_tpu_torch.tools.tune_probe. "
         "Corrupt/truncated/version-bumped "
         "files are ignored (tune.cache.invalid), never fatal; "
         "env-var winners (UDA_TPU_SORT_PATH) still override the "
         "cache. Setting this explicitly also installs the path as "
         "the PROCESS-default cache (tuncache.set_default_cache) so "
         "config-less consumers like route_engine consult the same "
         "table — unless UDA_TPU_TUNE_CACHE is set, which always "
         "wins. empty = UDA_TPU_TUNE_CACHE env, else no cache "
         "(today's built-in defaults)"),
    Flag("uda.tpu.tune.reprobe.s", 0.0, float,
         "tuning-cache staleness horizon in seconds: an entry older "
         "than this is re-measured by the background re-probe rung "
         "(python -m uda_tpu_torch.tools.tune_probe --reprobe-age, "
         "or a registered in-process "
         "probe via tuncache.ensure_fresh). 0 = winners never expire"),
    # --- multi-tenant service plane (uda_tpu/tenant/) -------------------
    Flag("uda.tpu.tenant.enable", False, bool,
         "run the ShuffleServer as a multi-job daemon: HELLO "
         "advertises CAP_TENANT, MSG_JOB registrations land in a "
         "TenantRegistry, every bound REQ is epoch-validated, and the "
         "per-conn credit cap is replaced by the weighted-fair "
         "CreditScheduler (uda.tpu.tenant.wqe.total). Off = the "
         "single-job data plane, bit for bit"),
    Flag("uda.tpu.tenant.id", "", str,
         "this process's tenant identity (reduce side): clients send "
         "MSG_JOB binding (tenant, job, epoch) before each job's "
         "first fetch, and hot-path metrics gain tenant labels. "
         "Empty = untenanted"),
    Flag("uda.tpu.tenant.epoch", 1, int,
         "this job attempt's epoch: a restarted attempt registers "
         "epoch+1, fencing the predecessor — its connections draw "
         "typed TenantError instead of reading the successor's "
         "chunks"),
    Flag("uda.tpu.tenant.weight", 1, int,
         "this tenant's weighted-fair share: scheduler grants and "
         "supplier read-budget partitions are proportional to weight "
         "over the sum of active tenants' weights"),
    Flag("uda.tpu.tenant.secret", "", str,
         "shared HMAC-SHA256 secret authenticating MSG_JOB frames "
         "(tenant/registry.sign_job); empty = unauthenticated (the "
         "trusted-fabric default, like the reference's rdma_cm "
         "plane). Both sides must agree"),
    Flag("uda.tpu.tenant.quantum.kb", 64, int,
         "byte quantum of the weighted-deficit round robin: each "
         "tenant's deficit EARNS quantum.kb x weight KB per turn and "
         "is CHARGED each granted request's requested bytes "
         "(chunk_size), so mixed chunk sizes stay byte-fair — a "
         "tenant fetching 1 MB chunks no longer out-draws one "
         "fetching 64 KB chunks at equal weight. A head request "
         "larger than one turn's earning accumulates deficit across "
         "turns (and the sweep force-serves the most-indebted head "
         "rather than idle credits). 0 = request-count quanta"),
    Flag("uda.tpu.tenant.wqe.total", 0, int,
         "the daemon-wide credit pool the CreditScheduler grants by "
         "weighted deficit round-robin (requests in flight across ALL "
         "connections and tenants); 0 = mapred.rdma.wqe.per.conn — "
         "the bound the single-job knob provided, now weighted-fair"),
    Flag("uda.tpu.tenant.strict", False, bool,
         "refuse REQs for jobs never registered via MSG_JOB (typed "
         "TenantError); off = unbound jobs ride the default tenant "
         "(old clients stay compatible)"),
    Flag("uda.tpu.tenant.ttl.s", 0.0, float,
         "idle-job expiry horizon: a registered job with no "
         "register/validate/heartbeat activity for this long is "
         "dropped from the registry (retired tombstones are collected "
         "on the same clock). 0 = jobs never expire"),
    Flag("uda.tpu.tenant.penalty.threshold", 4, int,
         "abusive-tenant events (admission rejections, faulted "
         "requests) before the tenant enters the scheduler's penalty "
         "box — its parked requests yield to unboxed tenants (never "
         "starved: served when nothing competes)"),
    Flag("uda.tpu.tenant.penalty.ms", 1000, int,
         "how long a penalty-boxed tenant stays deprioritized"),
    Flag("uda.tpu.tenant.budget.share", 0.0, float,
         "reduce-side MemoryBudget partition: scale this job's host + "
         "HBM budgets to the fraction of the machine its tenant owns "
         "(several reducers of different tenants sharing one host "
         "must not each claim the whole MemAvailable). 0 = whole-"
         "machine budgets (the single-job default)"),
    # --- memory admission / pressure-response knobs (utils/budget.py) ---
    Flag("uda.tpu.hbm.budget.mb", 0, int,
         "per-chip HBM budget for the device row matrix + merge working "
         "set in MB; 0 = detect the platform (v5e 16 GB, v5p 95 GB, ...) "
         "and reserve 90% of it (CPU backends use the host budget — the "
         "'device' rows are host RSS there)"),
    Flag("uda.tpu.host.budget.mb", 0, int,
         "host-RSS budget for fetch-window + staging working sets in MB; "
         "0 = MemAvailable x mapred.job.shuffle.input.buffer.percent"),
    Flag("uda.tpu.budget.hard.mb", 0, int,
         "hard admission ceiling on the partition estimate in MB: above "
         "it the merge refuses the task with FallbackSignal before any "
         "allocation (0 = no ceiling; the degraded streaming path is "
         "bounded-memory at any size)"),
    Flag("uda.tpu.budget.enforce", "reroute", str,
         "INIT over-budget behavior: 'reroute' shrinks the fetch window "
         "to fit the host budget with a warning (the reference's buffer-"
         "shrink, reducer.cc:100-119); 'reject' raises -> fallback"),
    Flag("uda.tpu.supplier.read.budget.mb", 0, int,
         "supplier read-pool admission budget in MB: ShuffleRequests "
         "whose queued+in-flight bytes would exceed it are rejected "
         "(non-blocking; the reduce side's retry/backoff absorbs the "
         "push-back — the occupy_chunk pool bound, IndexInfo.cc:276-292)."
         " 0 = 256 MB floor scaled by the reader thread count"),
    Flag("uda.tpu.watchdog.stall.s", 0.0, float,
         "stall watchdog deadline in seconds: no fetch/merge/emit "
         "progress for this long dumps all thread stacks + the span "
         "tree and fails the task into the fallback path (0 = off)"),
    Flag("uda.tpu.watchdog.fallback", True, bool,
         "when the watchdog fires, fail in-flight segments so the task "
         "terminates via FallbackSignal (true) or only dump diagnostics "
         "and keep waiting (false)"),
    Flag("uda.tpu.arena.pressure.s", 1.0, float,
         "staging-arena soft-pressure threshold: an acquire that waits "
         "longer than this fires the arena's pressure callback and "
         "counts arena.pressure_events"),
    # --- observability knobs (metrics / tracing / stats reporter) ---
    Flag("uda.tpu.stats.enable", False, bool,
         "turn on the optional observability layers (histograms, span "
         "tracing, the StatsReporter thread); UDA_TPU_STATS=1 is the "
         "env equivalent"),
    Flag("uda.tpu.stats.interval.ms", 1000, int,
         "StatsReporter snapshot/report interval in ms"),
    Flag("uda.tpu.stats.jsonl", "", str,
         "path for the JSON-lines stats stream (appended); empty = "
         "UDA_TPU_STATS_JSONL env, else stderr"),
    Flag("uda.tpu.flightrec.enable", True, bool,
         "the flight recorder (utils/flightrec.py): an always-on "
         "bounded ring of structured events (segment transitions, "
         "admission causes, recovery events, failpoint fires, watchdog "
         "samples) dumped automatically on FallbackSignal, stall or "
         "resledger leak. UDA_TPU_FLIGHTREC=0 is the env kill switch "
         "(both must say on)"),
    Flag("uda.tpu.flightrec.events", 4096, int,
         "flight-recorder ring capacity in events (the black box's "
         "whole memory bound; oldest events roll off)"),
    Flag("uda.tpu.profile.hz", 0, int,
         "span-attributed sampling profiler rate in Hz "
         "(utils/profiler.py): a daemon thread walks every thread's "
         "stack at this rate and attributes samples to the thread's "
         "active span; summaries land in Metrics.snapshot counters "
         "(profile.samples), stats records, MSG_STATS, span exports "
         "and stall/flightrec dumps. 0 = off (no sampling thread, one "
         "enabled-check elsewhere); UDA_TPU_PROFILE=<hz> is the env "
         "equivalent (bare '1' = the 97 Hz default). Span attribution "
         "needs the span layer on (UDA_TPU_STATS=1)"),
    Flag("uda.tpu.flightrec.dir", "", str,
         "directory for flight-recorder dump files "
         "(flightrec_<pid>_<seq>_<cause>.json); empty = "
         "UDA_TPU_FLIGHTREC_DIR env, else dumps stay in-memory only "
         "(FlightRecorder.reports)"),
    # --- the live telemetry plane (rollups / SLO / anomaly) ---
    Flag("uda.tpu.ts.enable", True, bool,
         "the in-process time-series rollup ring (utils/timeseries.py):"
         " one timer folds per-interval counter deltas, gauge levels "
         "and histogram percentiles into a bounded recent-history ring "
         "— armed only when the stats plane is on (uda.tpu.stats."
         "enable / UDA_TPU_STATS=1); false keeps even an armed stats "
         "plane ring-less"),
    Flag("uda.tpu.ts.interval.s", 1.0, float,
         "rollup sampling interval in seconds (the one timer the "
         "anomaly detectors and the per-tenant SLI book also ride)"),
    Flag("uda.tpu.ts.window", 120, int,
         "rollup ring capacity in intervals (oldest roll off); also "
         "the SLO attainment / fairness-audit window"),
    Flag("uda.tpu.anomaly.enable", True, bool,
         "online anomaly detectors over the rollup ring (utils/"
         "anomaly.py): throughput collapse, p99 inflation, gauge "
         "leak-slope, tenant starvation — each fires anomaly.* "
         "counters and flight-recorder events (armed with the ring)"),
    Flag("uda.tpu.anomaly.dump", False, bool,
         "proactive flight-recorder dumps on detection (cause="
         "anomaly, BEFORE anything fails); false = detect-only (the "
         "default: counters + events, no files). UDA_TPU_ANOMALY_DUMP"
         "=1 is the env equivalent"),
    Flag("uda.tpu.anomaly.dump.interval.s", 300.0, float,
         "minimum seconds between proactive anomaly dumps (a flapping "
         "detector must not fill a disk)"),
    Flag("uda.tpu.anomaly.warmup", 5, int,
         "intervals of baseline history a detector needs before it may "
         "judge (EWMA warm-up)"),
    Flag("uda.tpu.anomaly.zscore", 4.0, float,
         "z-score threshold for the p99-inflation detector"),
    Flag("uda.tpu.anomaly.consec", 3, int,
         "consecutive breaching intervals before an anomaly fires "
         "(hysteresis against single-interval noise)"),
    Flag("uda.tpu.anomaly.collapse.frac", 0.25, float,
         "throughput-collapse threshold: per-interval rate below this "
         "fraction of its EWMA while the plane was moving"),
    Flag("uda.tpu.anomaly.collapse.floor.mb_s", 1.0, float,
         "absolute guard for the collapse detector: the EWMA rate in "
         "MB/s a counter must sustain before a collapse is judgeable "
         "(an idle process is not an outage)"),
    Flag("uda.tpu.anomaly.p99.floor.ms", 50.0, float,
         "absolute guard for the p99-inflation detector: interval p99 "
         "below this never alarms regardless of z-score"),
    Flag("uda.tpu.anomaly.leak.gauges", "fetch.on_air", str,
         "comma-separated gauges watched by the leak-slope detector "
         "(monotone rise across the whole window = leak shape)"),
    Flag("uda.tpu.anomaly.leak.rise", 64.0, float,
         "minimum whole-window rise of a watched gauge before the "
         "leak-slope detector fires"),
    Flag("uda.tpu.anomaly.starve.s", 5.0, float,
         "continuous seconds a tenant may sit with backlog and zero "
         "scheduled bytes before the starvation detector fires"),
    Flag("uda.tpu.slo.fetch.p99.ms", 0.0, float,
         "per-tenant SLO target on interval fetch p99 latency in ms "
         "(0 = SLI tracked, no target/burn accounting)"),
    Flag("uda.tpu.slo.serve.p99.ms", 0.0, float,
         "per-tenant SLO target on interval supplier-read p99 latency "
         "in ms (0 = no target)"),
    Flag("uda.tpu.slo.share.frac", 0.5, float,
         "fairness SLO: an interval complies when a tenant with demand "
         "received at least this fraction of its weight-entitled "
         "scheduled-byte share (the WDRR audit threshold)"),
    Flag("uda.tpu.slo.objective", 0.99, float,
         "the SLO objective (fraction of intervals that must comply); "
         "burn rate = (1-attainment)/(1-objective)"),
    Flag("uda.tpu.metrics.http.port", 0, int,
         "OpenMetrics/Prometheus text exposition port (utils/"
         "openmetrics.py GET /metrics) for standard scrapers; 0 = off"),
    Flag("uda.tpu.auto.approach.threshold.mb", 2048, int,
         "auto merge-approach crossover: partitions at most this many "
         "MB take the hybrid LPQ/RPQ path (fastest at small/mid scale), "
         "larger or unknown sizes take bounded-memory streaming online "
         "(the reference's crossover between its 1 GB and 10 GB "
         "regression rungs on the CPU)"),
    Flag("uda.tpu.ckpt.dir", "", str,
         "crash-consistent checkpoint root (merger/checkpoint.py): "
         "non-empty arms periodic snapshots of each running reduce — "
         "sorted run files spool under <dir>/<job>.r<reduce>/runs/ and "
         "an atomic versioned UCKP manifest records run CRCs, in-flight "
         "fetch offset ledgers, the recovery journal and penalty-box "
         "state; a restarted attempt resumes instead of refetching. "
         "Also steers the auto merge approach to the streaming path "
         "(hybrid has no durable run spool). Empty = off (the seed "
         "behavior: a reducer death loses all fetched bytes)"),
    Flag("uda.tpu.ckpt.interval.s", 30.0, float,
         "minimum seconds between checkpoint snapshots; saves trigger "
         "at run-spool boundaries and are rate-limited by this "
         "interval (0 = snapshot at every spool boundary — the chaos "
         "and resume tests run there)"),
    Flag("uda.tpu.ckpt.keep", 2, int,
         "checkpoint manifest generations retained after a save: a "
         "torn newest manifest (kill mid-snapshot) falls back to the "
         "previous one, and consumed-on-load walks backward across "
         "crash-retry loops (min 1)"),
    Flag("uda.tpu.store.blob.root", "", str,
         "blob-tier root directory of the elastic disaggregated MOF "
         "store (mofserver/store.py): non-empty arms the StoreManager "
         "— spilled/migrated partitions live here and the path joins "
         "the DirIndexResolver search roots. Empty = off (the seed "
         "behavior: supplier-local storage only)"),
    Flag("uda.tpu.store.spill.watermark.mb", 0, int,
         "supplier local-retention watermark in MB: retained MOF "
         "bytes above it migrate oldest-first to the blob tier "
         "(CRC-verified, store.spilled.bytes ledgered). 0 = derive "
         "from uda.tpu.store.spill.frac of the host memory budget"),
    Flag("uda.tpu.store.spill.frac", 0.0, float,
         "watermark as a fraction of the MemoryBudget host budget "
         "when the explicit MB knob is 0 (0 = spill ladder off)"),
    Flag("uda.tpu.store.shadow", False, bool,
         "keep the local file.out as a failover twin after a spill "
         "cut-over (blob primary, local shadow): a dying blob "
         "backend then re-routes reads to the surviving local copy "
         "instead of the k-of-n reconstruction rung"),
    Flag("uda.tpu.store.health.threshold", 2, int,
         "store-backend faults before the tier is penalty-boxed and "
         "twin-holding reads proactively re-route (BackendHealth)"),
    Flag("uda.tpu.store.health.penalty.ms", 1000.0, float,
         "how long a boxed store backend stays deprioritized before "
         "parole (one more fault re-boxes it)"),
    Flag("uda.tpu.push.enable", False, bool,
         "push-based pipelined shuffle (uda_tpu/net/push.py): the "
         "server advertises CAP_PUSH and pushes committed partitions "
         "to subscribed reduce connections; the MergeManager arms "
         "reduce-side staging and adopts pushed prefixes as resumed "
         "fetches. Off = the pull-only plane, frame for frame"),
    Flag("uda.tpu.push.window", 8, int,
         "per-connection cap of un-ACKed MSG_PUSH chunks (the push "
         "plane's credit discipline — receivers pace suppliers via "
         "PUSH_ACK; the effective window is the min of both peers')"),
    Flag("uda.tpu.push.eager.mb", 0.0, float,
         "reduce-side staging bytes held IN MEMORY before pushes "
         "spill to a staging run file (0 = an eighth of the "
         "MemoryBudget host budget — pushes must not crowd out the "
         "fetch pipeline's own admission)"),
    Flag("uda.tpu.push.staged.mb", 0.0, float,
         "total reduce-side staged bytes (memory + spill) per task "
         "before further pushes draw PUSH_NACK(BUDGET) and convert "
         "to ordinary pull (0 = 4x the eager cap)"),
    Flag("uda.tpu.push.spill", True, bool,
         "allow the staging spill tier (uda.tpu.spill.dirs): pushes "
         "over the eager cap land in a run file instead of being "
         "refused; off = memory-only staging, earlier NACKs"),
]

FLAGS: Dict[str, Flag] = {f.key: f for f in _FLAG_LIST}
_SHORT: Dict[str, Flag] = {f.short: f for f in _FLAG_LIST if f.short}


def _coerce(flag: Flag, value: Any) -> Any:
    if isinstance(value, flag.type):
        return value
    if flag.type is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    try:
        return flag.type(value)
    except (TypeError, ValueError) as e:
        raise ConfigError(f"bad value {value!r} for {flag.key}: {e}") from e


class Config:
    """Layered config: explicit overrides > conf_source pulls > defaults."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None,
                 conf_source: Optional[Callable[[str, str], str]] = None):
        self._values: Dict[str, Any] = {}
        self.conf_source = conf_source
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> None:
        flag = FLAGS.get(key)
        self._values[key] = _coerce(flag, value) if flag else value

    def is_set(self, key: str) -> bool:
        """True when the key was set explicitly (override or pull), as
        opposed to falling through to its declared default."""
        return key in self._values

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._values:
            return self._values[key]
        if self.conf_source is not None:
            flag = FLAGS.get(key)
            fallback = default if default is not None else (
                flag.default if flag else "")
            pulled = self.conf_source(key, str(fallback))
            if pulled is not None and pulled != "":
                value = _coerce(flag, pulled) if flag else pulled
                self._values[key] = value
                return value
        if default is not None:
            return default
        flag = FLAGS.get(key)
        if flag is None:
            raise ConfigError(f"unknown config key {key!r} and no default given")
        return flag.default

    def as_dict(self) -> Dict[str, Any]:
        """Every declared key with its value: the defaults, overridden by
        what was set or pulled."""
        out = {f.key: f.default for f in _FLAG_LIST}
        out.update(self._values)
        return out

    @classmethod
    def from_argv(cls, argv: list[str]) -> "Config":
        """Parse the reference's short-option argv (C2JNexus.cc:43-137):
        ``["-w", "256", "-r", "9011", "-a", "1", "-m", "0", "-g", dir,
        "-t", "4", "-s", "1024"]`` style lists. ``-m`` (standalone mode)
        is accepted and ignored, like the reference's mostly vestigial
        mode flag."""
        cfg = cls()
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("-") or len(tok) != 2:
                raise ConfigError(f"bad option token {tok!r}")
            opt = tok[1]
            if i + 1 >= len(argv):
                raise ConfigError(f"option -{opt} missing value")
            val = argv[i + 1]
            i += 2
            if opt == "m":
                continue
            flag = _SHORT.get(opt)
            if flag is None:
                raise ConfigError(f"unknown option -{opt}")
            cfg.set(flag.key, val)
        return cfg
