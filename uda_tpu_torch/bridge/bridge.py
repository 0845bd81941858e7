"""The UdaBridge control surface.

The port's copy of ``uda_tpu/bridge/bridge.py``: the reference's JNI
bridge contract (reference src/UdaBridge.cc) as an embeddable Python API
of the same shape:

- down-calls: ``start(is_net_merger, argv, callable)`` (startNative,
  UdaBridge.cc:187-263), ``do_command(cmd)`` (doCommandNative :266-295),
  ``reduce_exit()`` (reduceExitMsgNative :299-314), ``set_log_level``
  (:318-333);
- up-calls on the registered ``UdaCallable``: ``fetch_over_message``,
  ``data_from_uda``, ``get_path_uda``, ``get_conf_data``, ``log_to`` and
  ``failure_in_uda``, the 6 cached callback methods of
  UdaBridge.cc:138-170, 516-522;
- role dispatch: NetMerger (the reduce side, reference
  src/Merger/NetMergerMain.cc:44-88) or MOFSupplier (the server side,
  reference src/MOFServer/MOFSupplierMain.cc:37-143), chosen by the
  ``is_net_merger`` flag as in UdaBridge.cc:217-238;
- the fallback contract: any engine failure is reported through
  ``failure_in_uda`` and the bridge goes inert, unless
  ``mapred.rdma.developer.mode`` is set, in which case it re-raises
  (reference UdaBridge.cc:506-530, UdaShuffleConsumerPluginShared.java:
  205-242).

``UdaBridge(device=None)`` runs the reduce task's merge on the card (K1's
merge tree through ``MergeManager``); pass ``device="cpu"`` where there is
none. ``uda.tpu.stats.enable`` or ``UDA_TPU_STATS=1`` runs a
``StatsReporter`` for the life of the role (JSON lines to
``uda.tpu.stats.jsonl`` / ``UDA_TPU_STATS_JSONL``, stderr otherwise) and
arms the observability plane; ``GET_STATS`` answers with the reporter's
latest record, or with a one-shot ``telemetry_block`` when none runs. The
flight recorder is configured at start, and each role's EXIT is the
resource ledger's process-end drain (``bridge.exit``).
``csrc/bridge_shim.cc`` is the C ABI over this class.
"""

from __future__ import annotations

import json
import threading
from typing import Optional, Protocol, Sequence

from uda_tpu_torch.bridge.protocol import Cmd, parse_cmd
from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.merger.segment import InputClient
from uda_tpu_torch.mofserver import DataEngine, IndexRecord, IndexResolver
from uda_tpu_torch.utils.budget import MemoryBudget
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (FallbackSignal,
                                        ProtocolError, UdaError)
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.flightrec import flightrec, flightrec_enabled_from_env
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics, stats_enabled_from_env
from uda_tpu_torch.utils.resledger import resledger
from uda_tpu_torch.utils.stats import (StatsReporter, reporter_output_from_env,
                                       telemetry_block)
from uda_tpu_torch.utils.timeseries import arm_observability_plane

__all__ = ["UdaCallable", "UdaBridge"]

log = get_logger()


class UdaCallable(Protocol):
    """The up-call interface the embedder registers (the reference's
    UdaCallable/UdaPluginRT/UdaPluginSH surface, UdaBridge.java:85-145).
    Every method is optional; a missing one is a no-op (get_path_uda is
    needed on the supplier side, and on the reduce side when INIT names no
    local dir)."""

    def fetch_over_message(self) -> None: ...

    def data_from_uda(self, data: memoryview, length: int) -> None: ...

    def get_path_uda(self, job_id: str, map_id: str,
                     reduce_id: int) -> IndexRecord: ...

    def get_conf_data(self, name: str, default: str) -> str: ...

    def log_to(self, level: int, message: str) -> None: ...

    def failure_in_uda(self, error: Exception) -> None: ...


class _UpcallIndexResolver(IndexResolver):
    """Index resolution through the get_path_uda up-call: the reference's
    first-fetch Java IndexCache round trip (IndexInfo.cc:237-251,
    UdaPluginSH.java:107-144), cached per (job, map, reduce)."""

    def __init__(self, callable_obj):
        self._callable = callable_obj
        self._cache: dict[tuple, IndexRecord] = {}
        self._lock = threading.Lock()

    def resolve(self, job_id: str, map_id: str, reduce_id: int) -> IndexRecord:
        key = (job_id, map_id, reduce_id)
        with self._lock:
            rec = self._cache.get(key)
        if rec is None:
            rec = self._callable.get_path_uda(job_id, map_id, reduce_id)
            with self._lock:
                self._cache[key] = rec
        return rec

    def resolve_cached(self, job_id: str, map_id: str,
                       reduce_id: int) -> Optional[IndexRecord]:
        """Cache hit only (no up-call): the network server's loop thread
        resolves inline with it; a miss returns None and the engine's
        pool pays the up-call off the loop thread."""
        with self._lock:
            return self._cache.get((job_id, map_id, reduce_id))

    def invalidate(self, job_id: str) -> None:
        with self._lock:
            for key in [k for k in self._cache if k[0] == job_id]:
                del self._cache[key]


class UdaBridge:
    """One bridge per role process (the reference allows one reduce task
    per NetMerger process, reducer.h:137). ``device`` (``None`` = the
    card) is where the reduce task merges."""

    PAGE = 4096  # buffer page alignment (reference getpagesize())

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.callable: Optional[UdaCallable] = None
        self.is_net_merger = False
        self.cfg = Config()
        self.started = False
        self._argv: list[str] = []
        self._failed = False
        self._dev_error: Optional[Exception] = None
        # reduce side
        self._mm: Optional[MergeManager] = None
        self._client: Optional[InputClient] = None
        self._job_id: Optional[str] = None
        self._reduce_id: Optional[int] = None
        self._key_class = "uda.tpu.RawBytes"
        self._pending_maps: list[tuple[str, str]] = []  # (host, attempt)
        self._attempt_by_task: dict[str, str] = {}
        self._merge_started = False
        self._merge_thread: Optional[threading.Thread] = None
        # supplier side
        self._engine: Optional[DataEngine] = None
        self._resolver: Optional[IndexResolver] = None
        self._owned_engine: Optional[DataEngine] = None
        # the data plane (uda.tpu.net.listen): the ShuffleServer serving
        # this role's engine to remote reduce clients
        self._net_server = None
        # uda.tpu.tenant.enable: one registry per bridge lifetime, shared
        # across re-INITs
        self._tenant_registry = None
        # uda.tpu.stats.enable / UDA_TPU_STATS=1: the role's reporter
        self._stats: Optional[StatsReporter] = None

    # -- down-calls ---------------------------------------------------------

    def start(self, is_net_merger: bool, argv: Sequence[str],
              callable_obj: Optional[UdaCallable] = None) -> None:
        """startNative: parse argv (the reference's getopt channel), wire
        the conf pull channel, pick the role (UdaBridge.cc:187-263)."""
        self.callable = callable_obj
        self.is_net_merger = is_net_merger
        self._argv = list(argv)
        self.cfg = self._fresh_cfg()
        if callable_obj is not None and hasattr(callable_obj, "log_to"):
            get_logger().set_sink(callable_obj.log_to)
        get_logger().set_level(self.cfg.get("uda.log.level"))
        # the flight recorder rides both roles from process start
        # (uda.tpu.flightrec.*; the env kill switch still wins)
        flightrec.configure(
            enabled=(bool(self.cfg.get("uda.tpu.flightrec.enable"))
                     and flightrec_enabled_from_env()),
            capacity=int(self.cfg.get("uda.tpu.flightrec.events")),
            dump_dir=str(self.cfg.get("uda.tpu.flightrec.dir")))
        if not is_net_merger:
            # MOFSupplier_main: the data engine serves fetches; paths
            # resolve through the up-call (the IndexCache round trip).
            # Reader threads scale with the configured disk count
            # (reference AsyncReaderManager.cc:16-50)
            self._resolver = _UpcallIndexResolver(self.callable)
            dirs = [d for d in str(
                self.cfg.get("mapred.local.dir", default="")).split(",")
                if d.strip()]
            self._engine = DataEngine(self._resolver, self.cfg,
                                      num_disks=max(1, len(dirs)))
        self._start_stats()
        self.started = True
        log.info(f"uda_tpu_torch bridge started as "
                 f"{'NetMerger' if is_net_merger else 'MOFSupplier'} "
                 f"on {self.device}")

    def _start_stats(self) -> None:
        """The observability wiring (``UDA_TPU_STATS=1`` /
        ``uda.tpu.stats.enable``): switch the optional metrics layers on,
        run a StatsReporter for the life of the role and arm the live
        telemetry plane (rollup ring, anomaly detectors, SLI book,
        optional OpenMetrics endpoint). Off by default: no thread."""
        if self._stats is not None:  # re-start(): recycle the reporter
            self._stats.stop(final=False)
            self._stats = None
        if not (stats_enabled_from_env()
                or self.cfg.get("uda.tpu.stats.enable")):
            return
        metrics.enable_stats()
        self._stats = StatsReporter(
            interval_s=self.cfg.get("uda.tpu.stats.interval.ms") / 1e3,
            out=reporter_output_from_env(
                str(self.cfg.get("uda.tpu.stats.jsonl", default="")))
        ).start()
        arm_observability_plane(self.cfg)

    def _fresh_cfg(self) -> Config:
        """The config rebuilt from the start-time argv and the conf
        up-call. Each INIT gets a fresh one: INIT-derived settings (codec
        class, shrunken buffer, lpq size) belong to one job and must not
        leak into the next INIT on the same bridge (a stale compress flag
        would wrap an uncompressed job's fetches in a
        DecompressingClient)."""
        cfg = Config.from_argv(list(self._argv))
        if self.callable is not None and hasattr(self.callable,
                                                 "get_conf_data"):
            cfg.conf_source = self.callable.get_conf_data
        return cfg

    def data_engine(self) -> DataEngine:
        """The supplier's engine (for in-process reduce-side clients, the
        single-host wiring where both roles share a process)."""
        if self._engine is None:
            raise UdaError("bridge not started as MOFSupplier")
        return self._engine

    def do_command(self, cmd: str) -> Optional[str]:
        """doCommandNative: dispatch by role (UdaBridge.cc:266-295). Most
        commands return None; GET_STATS returns the stats record as a
        JSON string."""
        if not self.started:
            raise UdaError("bridge not started")
        if self._dev_error is not None:
            raise self._dev_error  # developer mode: the stored background
            # failure surfaces on the next synchronous call
        if self._failed:
            return None  # inert after failure (Java fell back to vanilla)
        try:
            header, params = parse_cmd(cmd)
            if header == Cmd.GET_STATS:
                return json.dumps(self.get_stats())
            if self.is_net_merger:
                self._reduce_downcall(header, params)
            else:
                self._mof_downcall(header, params)
        except Exception as e:  # noqa: BLE001 - any engine failure flows
            # through the fallback contract (a ValueError from a malformed
            # INIT param too), never into the embedder
            self._fail(e)
        return None

    def get_stats(self) -> dict:
        """The GET_STATS body: the reporter's latest record when one
        runs, else a one-shot telemetry block of the metrics hub."""
        if self._stats is not None:
            return self._stats.latest()
        return telemetry_block()

    def _maybe_start_net_server(self, engine: Optional[DataEngine]) -> None:
        """Start the shuffle data plane next to the role's engine when
        ``uda.tpu.net.listen`` is set (the RDMAServer-next-to-DataEngine
        shape, reference MOFSupplierMain.cc:84-143). Once per bridge
        lifetime; stopped with the engine."""
        if self._net_server is not None or engine is None:
            return
        if not self.cfg.get("uda.tpu.net.listen"):
            return
        from uda_tpu_torch.net import ShuffleServer
        registry = None
        if self.cfg.get("uda.tpu.tenant.enable"):
            # the multi-tenant daemon shape: re-INITs on the same bridge
            # keep serving the same tenant books
            from uda_tpu_torch.tenant import TenantRegistry
            if self._tenant_registry is None:
                self._tenant_registry = TenantRegistry.from_config(
                    self.cfg)
            registry = self._tenant_registry
        self._net_server = ShuffleServer(engine, self.cfg,
                                         registry=registry).start()

    def _stop_net_server(self) -> None:
        srv, self._net_server = self._net_server, None
        if srv is not None:
            srv.stop()

    def net_server(self):
        """The running ShuffleServer (None unless uda.tpu.net.listen):
        embedders read its bound port for service registration."""
        return self._net_server

    def reduce_exit(self) -> None:
        """reduceExitMsgNative: synchronous teardown of the reduce task
        (UdaBridge.cc:299-314, finalize_reduce_task reducer.cc:354-410)."""
        t = self._merge_thread
        if t is not None:
            t.join()
        if self._mm is not None:
            self._mm.stop()
            self._mm = None
        self._stop_net_server()  # before its engine goes away
        if self._owned_engine is not None:
            self._owned_engine.stop()
            self._owned_engine = None
        self._merge_thread = None
        if self._stats is not None:
            # the per-reduce-task aggregate record (the reference's
            # teardown-time counter trio, StreamRW.cc:555-569): one
            # final-flagged record; the reporter keeps running for a
            # re-INIT on the same bridge
            self._stats.report_once(final=True)
        if self._dev_error is not None:
            # developer mode: a failure on the merge thread must not
            # vanish with the thread; teardown re-raises it
            err, self._dev_error = self._dev_error, None
            raise err

    def set_log_level(self, level: int) -> None:
        """setLogLevelNative (UdaBridge.cc:318-333)."""
        get_logger().set_level(level)

    # -- reduce side (reduce_downcall_handler, reducer.cc:144-217) ----------

    def _reduce_downcall(self, header: Cmd, params: list[str]) -> None:
        if header == Cmd.INIT:
            if self._mm is not None or self._owned_engine is not None:
                # re-INIT (a second reduce attempt on the same bridge):
                # the previous task's engine must not leak
                self.reduce_exit()
            self._pending_maps = []
            self._attempt_by_task = {}
            self._merge_started = False
            self.cfg = self._fresh_cfg()  # per-job settings must not leak
            if (len(params) >= 10 and params[0].isdigit()
                    and params[3].isdigit()):
                # reference layout: [0]=num_maps and [3]=lpq_size are
                # numeric; in the short form [0] is the job id and [3] the
                # key class name, never all digits
                local_dirs = self._init_reference_layout(params)
            elif len(params) >= 4:
                # short form: job_id, reduce_id, num_maps, key_class, then
                # optional local dirs
                self._job_id, rid, _num_maps, self._key_class = params[:4]
                self._reduce_id = int(rid)
                local_dirs = params[4:]
            else:
                raise ProtocolError(
                    f"INIT needs >= 4 params, got {len(params)}")
            # the reduce task's tenant (uda.tpu.tenant.id): the metric
            # labels and diagnostics read this process-wide install
            from uda_tpu_torch.tenant import set_current_tenant
            set_current_tenant(str(self.cfg.get("uda.tpu.tenant.id")))
            # INIT-time admission (the reducer.cc:56-133 buffer check):
            # over the host budget the window shrinks in cfg with a
            # warning (enforce=reroute) or INIT fails into the fallback
            # (enforce=reject); an unfittable chunk always fails. Before
            # the MergeManager reads the window
            MemoryBudget.from_config(self.cfg, device=self.device
                                     ).validate_init(self.cfg)
            client = self._make_client(local_dirs)
            # uda.tpu.net.listen: serve this host's map outputs to remote
            # reduce clients next to the owned engine
            self._maybe_start_net_server(self._owned_engine)

            # fetch progress -> fetchOverMessage at the reference cadence:
            # one up-call per PROGRESS_INTERVAL fetched segments and one
            # when the fetch ends (MergeManager.cc:124-130). The end of
            # the merged stream is in-band: the IFile EOF marker
            def _fetch_progress(done: int, total: int) -> None:
                cb = getattr(self.callable, "fetch_over_message", None)
                if cb is not None:
                    cb()

            self._mm = MergeManager(client, self._key_class, self.cfg,
                                    device=self.device,
                                    progress=_fetch_progress)
            ckpt_dir = str(self.cfg.get("uda.tpu.ckpt.dir"))
            if ckpt_dir:
                # a restarted attempt of this reduce resumes from the
                # newest valid manifest there; EXIT leaves it alone (EXIT
                # also follows failed attempts), the manager removes it
                # when the task completes
                log.info(f"bridge INIT: crash-consistent checkpointing "
                         f"armed under {ckpt_dir} (interval "
                         f"{self.cfg.get('uda.tpu.ckpt.interval.s')} s)")
        elif header == Cmd.FETCH:
            # reference FETCH: host:jobid:attemptid:partition
            # (UdaPlugin.java:322-334); the host rides with the attempt
            # so a HostRoutingClient can route per supplier
            if len(params) < 4:
                raise ProtocolError("FETCH needs 4 params")
            host, _job_id, map_attempt, _partition = params[:4]
            self._fetch_attempt(host, map_attempt)
        elif header == Cmd.FINAL:
            if self._mm is None:
                raise UdaError("FINAL before INIT")
            self._merge_started = True
            maps = list(self._pending_maps)
            self._merge_thread = threading.Thread(
                target=self._merge_main, args=(maps,), daemon=True,
                name="uda-merge-thread")
            self._merge_thread.start()
        elif header == Cmd.EXIT:
            self.reduce_exit()  # emits the final-flagged stats record
            if self._stats is not None:
                self._stats.stop(final=False)
                self._stats = None
            # the reduce task is over: every obligation (leases, fd pins,
            # paired-gauge increments, scoped failpoints) must be settled
            resledger.drain("bridge.exit")
        else:
            raise ProtocolError(f"unexpected command {header.name} for "
                                "NetMerger role")

    def _init_reference_layout(self, params: list[str]) -> list[str]:
        """Parse the reference's 10-param INIT and size the buffer
        (handle_init_msg, reducer.cc:56-133):

          0 num_maps, 1 job_id, 2 reduce_task_id, 3 lpq_size,
          4 rdma_buf_size(B), 5 min_buf(B), 6 key class, 7 codec class,
          8 comp block size(B), 9 shuffle memory size(B),
          [10 num_dirs, 11.. dirs]

        As the reference does: shrink the buffer when the double-buffered
        pool would exceed shuffleMemorySize, page-align it, and fail (->
        fallback) when the result drops under the minimum."""
        num_maps = int(params[0])
        self._job_id = params[1]
        self._reduce_id = int(params[2])
        lpq_size = int(params[3])
        max_buf = int(params[4])
        min_buf = int(params[5])
        self._key_class = params[6]
        comp_alg = params[7]
        comp_block = int(params[8])
        shuffle_mem = int(params[9])

        # buffer pairs in the pool: 2 per in-flight segment plus the extra
        # staging buffers (RDMA_BUFFERS_PER_SEGMENT=2, EXTRA_RDMA_BUFFERS=
        # 10, reducer.cc:49-50 -> pairs = maps + 5)
        kv_bufs = max(1, num_maps + 5)
        if shuffle_mem < kv_bufs * max_buf * 2:  # 2: double buffering
            max_buf = shuffle_mem // (kv_bufs * 2)
            if max_buf < min_buf:
                raise UdaError(
                    f"Not enough memory for rdma buffers: "
                    f"shuffleMemorySize={shuffle_mem}B with {kv_bufs} "
                    f"double-buffered pairs needs >= "
                    f"{kv_bufs * min_buf * 2}B")
            log.warn(f"shrinking buffer to {max_buf}B to fit "
                     f"shuffleMemorySize={shuffle_mem}B")
        buffer_size = max_buf - max_buf % self.PAGE  # page alignment
        if buffer_size <= 0 or buffer_size < min_buf:
            raise UdaError(
                f"RDMA Buffer is too small: {max_buf}B aligns to "
                f"{buffer_size}B < min {min_buf}B")
        self.cfg.set("mapred.rdma.buf.size", max(1, buffer_size // 1024))
        if lpq_size:
            self.cfg.set("mapred.netmerger.hybrid.lpq.size", lpq_size)
        if comp_alg and comp_alg not in ("0", "null", "None"):
            self.cfg.set("mapred.compress.map.output", True)
            self.cfg.set("mapred.map.output.compression.codec", comp_alg)
            if comp_block:
                self.cfg.set("io.compression.codec.lzo.buffersize",
                             comp_block)
        num_dirs = int(params[10]) if len(params) > 10 else 0
        return params[11:11 + num_dirs]

    @staticmethod
    def _attempt_task(attempt: str) -> str:
        """The map task of an attempt id: attempt_X_m_NNNNNN_A -> task
        X_m_NNNNNN (the dedupe key of the reference's
        GetMapEventsThread, UdaShuffleConsumerPluginShared.java:434-602).
        Ids not shaped like attempts dedupe by the whole string."""
        parts = attempt.rsplit("_", 1)
        if (len(parts) == 2 and attempt.startswith("attempt_")
                and parts[1].isdigit()):
            return parts[0]
        return attempt

    def _fetch_attempt(self, host: str, map_attempt: str) -> None:
        """Fetch-attempt hygiene (reference UdaShuffleConsumerPluginShared
        .java:568-589): an exact duplicate attempt is dropped; a new
        attempt of a map task whose earlier attempt is merged (or
        merging) cannot be unmerged -> failure_in_uda; before the merge
        starts the newer attempt replaces the stale one. ``host`` rides
        with the attempt so the transport can route per supplier
        (HostRoutingClient; reference RDMAClient.cc:498-527)."""
        task = self._attempt_task(map_attempt)
        existing = self._attempt_by_task.get(task)
        if existing == map_attempt:
            log.debug(f"duplicate fetch for {map_attempt}, ignored")
            return
        if self._merge_started:
            raise UdaError(
                f"map attempt {map_attempt} arrived after the merge "
                f"started"
                + (f" (obsoletes already-merged {existing})"
                   if existing else ""))
        if existing is not None:
            log.warn(f"map attempt {existing} obsoleted by {map_attempt}")
            idx = next(i for i, (_, a) in enumerate(self._pending_maps)
                       if a == existing)
            self._pending_maps[idx] = (host, map_attempt)
        else:
            self._pending_maps.append((host, map_attempt))
        self._attempt_by_task[task] = map_attempt

    def _make_client(self, local_dirs: list[str]) -> InputClient:
        """createInputClient: a plain or decompressing transport by codec
        class (reference reducer.cc:412-450); with ``uda.tpu.net.fetch``
        a host-routing client over the socket data plane instead of an
        in-process engine client."""
        if self._client is not None:
            return self._client
        if self.cfg.get("uda.tpu.net.fetch"):
            from uda_tpu_torch.merger import HostRoutingClient
            # fetches dial each FETCH-carried supplier host's server; a
            # local engine is still built (from the local dirs) when this
            # host also listens, to serve its own map outputs
            if local_dirs and self.cfg.get("uda.tpu.net.listen"):
                from uda_tpu_torch.mofserver import DirIndexResolver
                self._owned_engine = DataEngine(
                    DirIndexResolver(local_dirs), self.cfg,
                    num_disks=len(local_dirs))
            return self._wrap_codec(HostRoutingClient(config=self.cfg))
        if local_dirs:
            from uda_tpu_torch.mofserver import DirIndexResolver
            # reader threads scale with the disk count, the reference's
            # per-disk AIO pools (AsyncReaderManager.cc:16-50)
            engine = DataEngine(DirIndexResolver(local_dirs), self.cfg,
                                num_disks=len(local_dirs))
        else:
            engine = DataEngine(_UpcallIndexResolver(self.callable), self.cfg)
        self._owned_engine = engine
        return self._wrap_codec(LocalFetchClient(engine))

    def _wrap_codec(self, client: InputClient) -> InputClient:
        """The decompressing wrap by codec class (reducer.cc:412-450)."""
        if self.cfg.get("mapred.compress.map.output"):
            from uda_tpu_torch.compress import (BLOCK_HEADER,
                                                DecompressingClient,
                                                get_codec)
            codec = get_codec(
                self.cfg.get("mapred.map.output.compression.codec") or "zlib")
            # calculateMemPool's buffer split (reducer.cc:453-496): the
            # compressed (wire) side gets `ratio` of each buffer pair
            ratio = float(
                self.cfg.get("mapred.rdma.compression.buffer.ratio"))
            buf_bytes = self.cfg.get("mapred.rdma.buf.size") * 1024
            comp_chunk = max(BLOCK_HEADER.size + 1, int(buf_bytes * ratio))
            client = DecompressingClient(client, codec,
                                         comp_chunk_size=comp_chunk)
        return client

    def set_input_client(self, client: InputClient) -> None:
        """Inject a transport: the createInputClient factory seam
        (reducer.cc:412-450)."""
        self._client = client

    def _merge_main(self, maps: list) -> None:
        """The merge thread: fetch (progress -> fetchOverMessage) ->
        merge on the device -> stream dataFromUda blocks, the last one
        carrying the IFile EOF marker as the in-band end of stream
        (merge_thread_main, MergeManager.cc:291-314)."""
        try:
            def consumer(block: memoryview) -> None:
                failpoint("bridge.upcall", key="data_from_uda")
                cb = getattr(self.callable, "data_from_uda", None)
                if cb is not None:
                    cb(block, len(block))

            self._mm.run(self._job_id, maps, self._reduce_id, consumer)
        except Exception as e:  # noqa: BLE001 - the fallback boundary
            self._fail(e, in_thread=True)

    # -- supplier side (mof_downcall_handler, MOFSupplierMain.cc:37-81) -----

    def _mof_downcall(self, header: Cmd, params: list[str]) -> None:
        if header == Cmd.NEW_MAP:
            pass  # map registration is implicit (resolution is pull-based)
        elif header == Cmd.JOB_OVER:
            if params and self._resolver is not None:
                self._resolver.invalidate(params[0])
        elif header == Cmd.INIT:
            # uda.tpu.net.listen: serve this supplier's engine to remote
            # reduce clients (the RDMAServer bound next to the DataEngine)
            self._maybe_start_net_server(self._engine)
        elif header == Cmd.EXIT:
            self._stop_net_server()  # drain before the engine stops
            if self._engine is not None:
                self._engine.stop()
                self._engine = None
            if self._stats is not None:
                self._stats.stop(final=True)
                self._stats = None
            # the supplier side of the process-end drain: with the server
            # stopped and the engine shut down, the books must be empty
            resledger.drain("bridge.exit")
        else:
            raise ProtocolError(f"unexpected command {header.name} for "
                                "MOFSupplier role")

    # -- failure contract ---------------------------------------------------

    def _fail(self, error: Exception, in_thread: bool = False) -> None:
        """exceptionInNativeThread -> failureInUda -> inert bridge
        (UdaBridge.cc:506-530); developer mode fails loudly instead of
        falling back (UdaShuffleConsumerPluginShared.java:210-217).

        Developer mode on the merge thread cannot usefully re-raise (the
        error would die in Thread.run and an embedder waiting on
        fetch_over would block forever): the error is stored and raised
        by the next synchronous call (do_command, reduce_exit), and
        failure_in_uda still fires so waiters wake.

        The embedder is given the root cause: a FallbackSignal is
        unwrapped to its ``cause``, whose backtrace rides along on the
        exception object."""
        root = error.cause if isinstance(error, FallbackSignal) else error
        if self.cfg.get("mapred.rdma.developer.mode"):
            if not in_thread:
                raise error
            self._failed = True
            self._dev_error = error
            log.error(f"merge-thread failure (developer mode, will "
                      f"re-raise on next call): {error}")
        else:
            self._failed = True
            log.error(f"engine failure, requesting fallback: {root}")
            bt = getattr(root, "backtrace", "")
            if bt:
                log.debug(f"failure origin backtrace:\n{bt}")
        cb = getattr(self.callable, "failure_in_uda", None)
        if cb is not None:
            cb(root)

    @property
    def failed(self) -> bool:
        return self._failed
