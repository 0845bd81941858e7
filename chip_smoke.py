#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``uda_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
``sm_90a``)::

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``uda_tpu_torch/csrc`` compiled with ``nvcc``;
3. kernels: K2/K1 (with the partition kernel) through ``sort_lanes`` at 8
   and 32 rows (``two_phase`` off and on) and K3/K4 (with the partition
   kernel at K4's width) through ``sort_lanes_folded4``, at 2^20 records
   with tiles 1024 and 4096, on keys with duplicates, words >= 2^31 and
   all-0xFFFFFFFF keys; K2/K1 at the edges of their design (tile 128,
   n == tile, 1, 7 and 30 key words at 4, 8 and 32 rows, all-equal,
   all-0xFFFFFFFF and high keys, tiles wider than one K2 block takes);
   K3/K4 at theirs (tile 256, n == tile, 1, 2 and 3 key words, the same
   kinds of keys, tiles 8192 and 16384, past one K3 block) and K4 on runs
   that hold equal records; K5 (``take_lanes``) at the probe's three
   shapes and at 3, 26 and 33 rows, each of its two designs launched on
   its own too; every launch held byte for byte against its plain
   PyTorch version on the same input, and each cascade against PyTorch's
   stable sort;
4. main path: ``single_chip_sort`` of 100,000,000 TeraSort records
   (BASELINE.md config 2, 10.4 GB of ``uint32[n, 26]``, padded to 2^27
   inside) with ``path="auto"``, which resolves to ``keys8`` (K2, K1 and
   the partition kernel), then the same records through ``keys8f`` (K3,
   K4 and the partition kernel); each checked for order, multiset
   checksum and byte identity with the stable-sort yardstick, with the
   launches of every kernel counted; 4b: a temporary tune cache
   (``UDA_TPU_TUNE_CACHE``, written by the port's ``TuneCache``) names
   ``keys8f`` for the 10^8-row bucket (``gpu|rows27|lanes1``): "auto"
   routes to it, one "auto" call equals the yardstick with K3 and K4
   launched and K2 not, timed beside phase 4's calls; the cache is
   cleared after;
5. engines: all eight engines on 2^22 records give the same bytes, and
   ``bench_step`` runs 2 rounds of ``keys8``; the small-batch steering:
   at 2^16 rows a cold cache's "auto" resolves to ``carrychunk``, timed
   against ``keys8`` and ``keys8f`` at 2^16 and 2^19 rows (equal bytes);
6. times, with CUDA events at the main path's shapes: each kernel (K1, K4
   and the partition kernel at each one's width per pass and summed over
   the cascade; K5 on the keys8 matrix by the main path's permutation and
   by a merge permutation, its own device time in turns with torch
   indexing and its other design, the whole wrapper call, its scratch
   and peak memory), its plain version, PyTorch's call computing the same
   function, its bound, the cascades and the whole-sort yardstick; A/Bs,
   in turns, of K3/K4 against K2/K1's run-time-row form on the same 4-row
   input and of K4's block width (2048 against 4096 records); and K5's
   two designs from 16 KB to 1 GB of ``x`` (the small-shape rule);
7. profile: device time by kernel and the device's idle share over one
   ``keys8`` ("auto") and one ``keys8f`` call (``torch.profiler``);
8. merge: one TeraSort reduce task through ``MergeManager.run``
   (``uda.tpu.merge.overlap=false``): 64 map outputs of 16 MiB of sorted
   TeraSort records (Text keys of 10 bytes, Text values of 90), written
   by ``MOFWriter``, fetched through ``LocalFetchClient``/``DataEngine``,
   merged by K1's two-phase merge tree and emitted as IFile blocks, with
   the launch counts reset just before and read just after, under
   ``torch.profiler``; the stream is cracked, checked for key order and
   multiset checksum and held byte for byte against the whole-partition
   re-sort (``merge_batches``) on the card; then K1 at each capacity
   class of the merge tree against its plain version, timed beside its
   bound;
9. overlap: the default reduce path on phase 8's MOF tree, each run
   through ``MergeManager.run`` with ``metrics`` and the launch counts
   reset just before and read just after: (a) the default ``Config()``
   (the overlapped merger: pipelined staging, auto stage pool, auto
   in-flight cap; runs copied from pinned leases on a copy stream and
   merged by K1 on a merge stream while later fetches are in flight),
   under ``torch.profiler``; (b) ``uda.tpu.online.streaming=true`` on the
   first 8 maps, spilling sorted runs under a temporary directory; (c)
   ``uda.tpu.stage.pipeline=false`` on the first 16 maps (run c's);
   (d) the default and (e) streaming on a second tree, 64 maps
   of 1 MiB of Text records with values of 1 to 1000 bytes, beside one
   emission slab of them gathered by ``streaming._gather_spans`` and by a
   per-byte index (equal bytes, host ms of each). Each stream is hashed
   as it is emitted and must equal phase 8's stream (runs b, c: the
   card's re-sort of their 8 and 16 maps; d, e: of their tree, framed) in
   sha256 and length; K1 must launch one merge and one
   partition kernel per forest merge (63 for 64 maps); the in-flight gauge
   must end at 0 and every pinned lease go back, some reused;
10. admission: the rest of ``MergeManager.run`` on run c's 16 maps, each
   run with ``metrics`` and the launch counts reset just before and read
   just after, its stream hashed and held to run c's: (a) approach 2,
   the hybrid merge (4 LPQs of 4 maps, 3 at a time, each merged by K1's
   merge tree, 12 + 12 launches; the RPQ on the host; no spill file
   left); (b) approach 0 three times: on the first 8 maps (held to their
   re-sort) the defaults route to hybrid (3 LPQs, 5 + 5 launches) and a 256 MB
   device budget to streaming with no device run (0 launches); on the
   16, a 100 MB hard ceiling to ``FallbackSignal`` with no fetch; (c) streaming
   with a checkpoint (interval 0): attempt 1 dies on its last map
   (``segment.fetch=error:match:<map>``, no retry), attempt 2 resumes,
   adopts every run the manifest holds into K1's forest, fetches none of
   them and removes the checkpoint; (d) 2 maps at 1 KB chunks with every
   fourth fetch issue delayed 3 s: the 0.5 s watchdog ends the task in
   ``FallbackSignal(StallError)`` within 3 s;
11. survivable fetch: run c's 16 maps written again by
   ``write_striped_map_output`` with ``rs:2:4`` over four supplier roots
   h0-h3 (4 maps each, map m's primary on h(m % 4); the data region of
   each ``file.out`` is the uncoded layout), each root behind its own
   ``DataEngine`` and ``HostRoutingClient(lambda h: LocalFetchClient(...))``,
   with ``metrics`` and the launch counts reset just before each run and
   read just after: (a) h2 fails every fetch from the start, under
   ``uda.tpu.coding.scheme=rs:2:4`` and ``uda.tpu.fetch.retries=1``: its 4
   partitions are rebuilt from 2 shards each on the survivors, the
   stream equals run c's, K1 launches 15 pairs, nothing falls back
   (under ``torch.profiler``: idle share); (b) h0's 4 maps listed on the
   replicas h0 and h1 (two engines over h0's root), h0's transport
   holding every chunk 300 ms, ``uda.tpu.fetch.speculate.pn=95`` (floor
   50 ms): speculation wins, beside the same 4 maps with speculation
   off; (c) the same 4 maps with ``uda.tpu.fetch.resume=true``, one fetch
   in flight and one ``data_engine.pread`` transport fault injected by
   the failpoint registry mid-partition in each map: 4 resumes, no map's
   offset 0 read twice (reads counted per map and offset). Runs b and c
   equal the card's re-sort of those 4 maps;
12. networked shuffle: a port ``ShuffleServer`` on 127.0.0.1 (any free
   port) serves a tree through its own ``DataEngine``, and the reduce task
   is ``MergeManager.run`` on the card over ``HostRoutingClient(config=)``
   with its socket default (``uda.tpu.net.fetch=true``), each run with
   ``metrics`` and the launch counts reset just before and read just
   after, its stream hashed and held to a digest: (a) the default
   ``Config()`` (zero-copy, ``zerocopy.mode=auto``) on run c's 16 maps,
   equal to run c's stream, K1 15 pairs, under ``torch.profiler``; (b) run
   c's 16 maps with ``uda.tpu.net.zerocopy=false`` and
   ``uda.tpu.fetch.crc=true``: every chunk through ``submit_batch``, none
   zero-copy, equal to run c's; (c) run c's maps written again with
   ``DefaultCodec`` (zlib) and fetched through ``DecompressingClient``,
   equal to run c's; (d) 4 maps x 1 MiB with LZO through the port's
   ladder (the rung printed), equal to their re-sort; (e) 4 maps, one
   fetch in flight, the server stopped while a fetch at half a map is held
   and restarted on its port: warm (a handoff record) the segment
   resumes and no offset 0 is read twice; cold (no record) ``resume_ok``
   goes False and the partition restarts from 0; both equal the 4 maps'
   re-sort;
13. the supplier planes, each run with ``metrics`` and the launch counts
   reset just before and read just after, under ``torch.profiler``: (a)
   push: a port ``ShuffleServer`` with ``uda.tpu.push.enable`` serves
   phase 8's 64 maps; the reduce task (the default ``Config()`` plus
   push, over the socket default) calls ``arm_push`` first, a thread
   plays the map phase (``notify_commit`` for one map every 100 ms) and
   ``run()`` starts after the last commit: the stream equals 9a's, K1 63
   pairs, at least one pushed prefix adopted (chunks, bytes, adoptions,
   NACKs by reason, errors, the staging caps and ``run()``'s wall beside
   9a's printed); (b) the elastic store: run c's 16 maps written again
   through ``MOFWriter(store=StoreManager)`` into a fresh root, the
   watermark a tenth of the partition's on-disk bytes, so 15 maps spill
   to the blob tier oldest first as they are written (peak retained
   bytes at or below the watermark); the default task over the wire
   (spilled maps through the store's copy path, the retained one
   zero-copy) equals run c's stream; then 4 maps retained locally,
   ``announce_drain(store=)`` migrates them and a task started after it
   reads them all from the blob tier, equal to their re-sort; (c)
   tenants: run c's maps as two jobs of 8, one ``ShuffleServer`` with
   ``uda.tpu.tenant.enable`` and 4 shared credits, two reduce tasks at
   once on two threads (tenant t1 weight 1, t3 weight 3, each bound by
   MSG_JOB from its own ``Config``): each stream equals its maps'
   re-sort, K1 7 + 7 pairs; then t1's job is retired and a fetch of it
   draws the typed TenantError (walls, granted bytes per tenant, the
   fairness figure and admission rejections printed).

Each phase's seconds are printed on a line of their own. The last two
lines are one JSON object with a record per kernel and the
contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from uda_tpu_torch import interop
from uda_tpu_torch.device import generator
from uda_tpu_torch.coding import parse_scheme
from uda_tpu_torch.compress import (BLOCK_HEADER, Codec, DecompressingClient,
                                    get_codec)
from uda_tpu_torch.compress.lzo import native_lzo_source
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                  MergeManager, checkpoint)
from uda_tpu_torch.merger import streaming as stream_mod
from uda_tpu_torch.merger.hybrid import num_lpqs_for
from uda_tpu_torch.merger.emitter import frame_batch
from uda_tpu_torch.models import terasort
from uda_tpu_torch.net import RemoteFetchClient, ShuffleServer
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver, MOFWriter,
                                     ShuffleRequest, StoreManager,
                                     write_striped_map_output)
from uda_tpu_torch.ops import _build, lane_gather, pallas_fold, pallas_merge
from uda_tpu_torch.ops import merge as merge_ops
from uda_tpu_torch.ops import packing, pallas_sort
from uda_tpu_torch.ops import sort as sort_ops
from uda_tpu_torch.ops.sort import _as_i64, fill_words, i32, u32, words_of
from uda_tpu_torch.utils.comparators import get_key_type
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils import vint
from uda_tpu_torch.utils.errors import (FallbackSignal, TenantError,
                                        TransportError)
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.ifile import EOF_MARKER, RecordBatch, crack
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils import tuncache

SEED = 0
N_MAIN = 100_000_000       # BASELINE.md config 2: TeraSort 10 GB
N_ENGINES = 1 << 22
N_KERNEL = 1 << 20
KERNEL_TILES = (1024, 4096)
MAIN_TILE = 1024           # single_chip_sort's default tile
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
OPS_PER_S = 67e12          # H100 SXM 32-bit rate outside the tensor cores
TIMED_REPS = 5
# device_ms's sleep: about 50 ms of a card's clock, longer than the host
# takes to queue the timed launches
HOST_HIDE_CYCLES = 100_000_000

KERNELS = {
    "merge_pass": dict(
        id="K1", route="cuda", source="uda_tpu_torch/csrc/lanes_sort.cu",
        replaces="uda_tpu/ops/pallas_sort.py:310"),
    # K1's partition kernel: the window table of K1's launcher; its time
    # is also inside K1's, which is timed through the wrapper
    "merge_partition": dict(
        id="K1", route="cuda", source="uda_tpu_torch/csrc/lanes_sort.cu",
        replaces="uda_tpu/ops/pallas_sort.py:210"),
    "tile_sort": dict(
        id="K2", route="cuda", source="uda_tpu_torch/csrc/lanes_sort.cu",
        replaces="uda_tpu/ops/pallas_sort.py:133"),
    "tile_sort_folded": dict(
        id="K3", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:90"),
    "merge_pass_folded": dict(
        id="K4", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:135"),
    "take_lanes": dict(
        id="K5", route="cuda", source="uda_tpu_torch/csrc/lane_gather.cu",
        replaces="scripts/probe_gather.py:62"),
}
MAIN_PATH = ("tile_sort", "merge_pass", "merge_partition")
# K2/K1 at the edges of their design: rows, key words, tie-break row, n,
# tile and the kind of keys (lanes_words)
EDGE_CASES = [
    (8, 3, 7, 1 << 12, 128, "mixed"),      # first pass: width clamps to 256
    (8, 3, 7, 1024, 1024, "mixed"),        # n == tile: no merge pass
    (4, 1, 3, 1 << 13, 256, "mixed"),
    (8, 1, 7, 1 << 13, 128, "mixed"),
    (8, 7, 7, 1 << 13, 512, "mixed"),
    (32, 7, 31, 1 << 12, 256, "mixed"),
    (32, 30, 31, 1 << 12, 128, "mixed"),
    (8, 3, 7, 1 << 13, 128, "equal"),      # order from the arrival index
    (4, 3, 3, 1 << 13, 1024, "ones"),      # all-0xFFFFFFFF keys
    (32, 30, 31, 1 << 11, 128, "equal"),
    (8, 2, 7, 1 << 14, 8192, "high"),      # words >= 2^31
    # tiles wider than one K2 block takes: sub-tiles merged by K1
    (8, 2, 7, 1 << 15, 16384, "high"),
    (8, 6, 7, 1 << 14, 8192, "mixed"),
]
# K3/K4 at the edges of theirs: key words, n, tile and the kind of keys
SLIM_EDGE_CASES = [
    (3, 1 << 12, 256, "mixed"),      # first pass: width 512
    (2, 1024, 1024, "mixed"),        # n == tile: no merge pass
    (1, 1 << 13, 256, "mixed"),
    (2, 1 << 13, 512, "equal"),      # order from the arrival index
    (3, 1 << 13, 1024, "ones"),      # all-0xFFFFFFFF keys
    (1, 1 << 13, 256, "high"),       # words >= 2^31
    # tiles past one K3 block at 2-3 key words: sub-tiles merged by K4
    (2, 1 << 14, 8192, "high"),
    (3, 1 << 15, 16384, "mixed"),
    (1, 1 << 15, 16384, "equal"),    # one K3 block at 1 key word
]
# K4 on runs whose records have equal twins in the other run: key words,
# n, run_len
EQUAL_RUN_CASES = [(1, 1 << 13, 1024), (3, 1 << 13, 256)]
PROBE_SHAPES = ((32, 2048), (8, 2048), (8, 512))  # scripts/probe_gather.py
# K5 in phase 3: the probe's shapes, then records of 3, 26 and 33 words
# (26: n not a multiple of 4, so rows are moved a word a thread)
TAKE_SHAPES = PROBE_SHAPES + ((3, 1 << 20), (26, 100_003), (33, 1029))
# K5's designs in turns at [8, n] (phase 6): n from 2^9 to 2^25, finer
# around lane_gather.SMALL_BYTES (2^15 columns of 8 rows)
TAKE_SWEEP_NS = tuple(1 << k for k in (9, 11, 13, 15, 16, 17, 19, 21, 23,
                                       25))
_ALL_ONES = 0xFFFFFFFF
# phase 8: one reduce partition of TeraSort. The reference's deployment
# shape is 64 maps of 64 MiB (scripts/bench_pipeline.py:182-183); the maps
# are cut to 16 MiB so the pure-Python host side fits the time budget.
MERGE_MAPS = 64
MERGE_MAP_BYTES = 16 << 20
MERGE_KEY_CLASS = "org.apache.hadoop.io.Text"
MERGE_JOB = "terasort"
MERGE_TILE = 512           # merge_sorted_pair's default tile
# one framed record: VInt(11) VInt(91), the Text key (VInt(10) + 10 bytes),
# the Text value (VInt(90) + 90 bytes)
TERA_RECORD = 104
# phase 9's run c (the serial stage loop) merges the first 16 maps only
OVERLAP_C_MAPS = 16
# phase 9's runs d and e: Text values of 1 to 1000 bytes, the mix of
# lengths that the emission's span gather takes by size class
VARLEN_MAPS = 64
VARLEN_MAP_BYTES = 1 << 20
VARLEN_MAX_VALUE = 1000
# phase 10's hybrid merge: LPQs of 4 maps, 3 at a time
HYBRID_LPQ_MAPS = 4
HYBRID_PARALLEL = 3
B_MAPS = 8                 # runs 9b, 10b1, 10b2: the first 8 maps
# phase 5's steering check (ops/sort.SMALL_BATCH_ROWS is 2^20)
STEER_ROWS = (1 << 16, 1 << 19)
# phase 11: run c's maps striped over four suppliers
CODED_HOSTS = ("h0", "h1", "h2", "h3")
CODED_SCHEME = "rs:2:4"
CODED_DEAD = "h2"
SPEC_HOLD_S = 0.3          # h0's hold on every chunk in run 11b
RESTART_MAPS = 4           # phase 12e
LZO_MAPS = 4               # phase 12d
LZO_MAP_BYTES = 1 << 20
NET_CONF = {"uda.tpu.net.fetch": True}
PUSH_COMMIT_S = 0.1        # phase 13a: the map phase commits a map each
STORE_WATERMARK_DIV = 10   # phase 13b: the watermark, a tenth of the tree
TENANT_WQE = 4             # phase 13c: uda.tpu.tenant.wqe.total
TENANTS = (("t1", 1), ("t3", 3))  # phase 13c: (tenant, weight)
SPEC_CONF = {"uda.tpu.fetch.speculate.pn": 95,
             "uda.tpu.fetch.speculate.floor.ms": 50}


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over uint32 words (0: byte-identical)."""
    return int((_as_i64(a) - _as_i64(b)).abs().max())


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(i32(a), i32(b))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = TIMED_REPS, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = TIMED_REPS, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()``, which must not synchronise:
    the launches are queued behind a sleeping kernel, so the events
    around them time the card's work and not the host's launch cost."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_HIDE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int) -> tuple:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the 32-bit vector rate.
    Returns (ms, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ---------------------------------------------------------------- phase 1
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind}; count {torch.cuda.device_count()}")
    return {"smi": smi, "kind": kind, "count": torch.cuda.device_count()}


# ---------------------------------------------------------------- phase 2
def phase_build() -> float:
    secs = _build.build_all()
    log(f"[build] nvcc sm_90a, {len(list(_build.CSRC.glob('*.cu')))} "
        f"sources: {secs:.1f} s")
    return secs


# ---------------------------------------------------------------- phase 3
def lanes_words(seed: int, rows: int, n: int, num_keys: int,
                kind: str = "mixed") -> np.ndarray:
    """uint32[rows, n] records in the lanes layout: random payload, key rows
    mixing random words with a small alphabet (duplicates, words >= 2^31,
    all-0xFFFFFFFF keys). Another ``kind`` sets every key word: "equal" (one
    value, so the arrival index orders them), "ones" (all-0xFFFFFFFF) or
    "high" (top bit set). The port's tests draw their inputs here too."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=(rows, n), dtype=np.uint32)
    alphabet = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    small = rng.random(n) < 0.6
    x[:num_keys, small] = rng.choice(alphabet, size=(num_keys, small.sum()))
    x[:num_keys, rng.random(n) < 0.05] = np.uint32(_ALL_ONES)
    if kind == "equal":
        x[:num_keys] = np.uint32(0x80000001)
    elif kind == "ones":
        x[:num_keys] = np.uint32(_ALL_ONES)
    elif kind == "high":
        x[:num_keys] |= np.uint32(0x80000000)
    elif kind != "mixed":
        raise ValueError(kind)
    return x


def equal_runs(seed: int, n: int, run_len: int,
               num_keys: int) -> np.ndarray:
    """uint32[4, n] slim records in ascending runs of ``run_len``, where
    every second run copies the key words and tie-break of the run before
    it (its payload rows differ): each record has an equal twin in the
    other run of its pair, so a merge must send ties to the first run."""
    x = lanes_words(seed, 4, n, num_keys)
    for a0 in range(0, n, 2 * run_len):
        a = x[:, a0:a0 + run_len]
        a[:] = a[:, np.lexsort(a[num_keys - 1::-1])]
        a[3] = np.arange(run_len, dtype=np.uint32)
        x[:num_keys, a0 + run_len:a0 + 2 * run_len] = a[:num_keys]
        x[3, a0 + run_len:a0 + 2 * run_len] = a[3]
    return x


def stable_reference(x: torch.Tensor, num_keys: int,
                     tb_row: int) -> torch.Tensor:
    """The sorted lanes array by PyTorch's stable sort."""
    perm = sort_ops.stable_lex_argsort(list(x[:num_keys]))
    out = sort_ops.take_cols(x, perm)
    i32(out)[tb_row] = i32(words_of(perm))
    return out


def cascade(folded: bool, num_keys: int, tb_row: int) -> tuple:
    """One cascade's kernel wrappers and plain versions, the launch-counter
    names of its tile sort and merge pass and the arguments after
    (x, [run_len,] tile): (tile sort, its plain version, merge pass, its
    plain version, names, args). Both merge passes launch the partition
    kernel too."""
    if folded:
        return (pallas_fold.tile_sort_folded,
                pallas_fold.tile_sort_folded_plain,
                pallas_fold.merge_pass_folded,
                pallas_fold.merge_pass_folded_plain,
                ("tile_sort_folded", "merge_pass_folded"), (num_keys,))
    return (pallas_sort.tile_sort, pallas_sort.tile_sort_plain,
            pallas_sort.merge_pass, pallas_sort.merge_pass_plain,
            ("tile_sort", "merge_pass"), (num_keys, tb_row))


def check_cascade(x: torch.Tensor, num_keys: int, tb_row: int, tile: int,
                  folded: bool) -> dict:
    """Run the cascade kernel by kernel, holding each launch against its
    plain version on the same input; returns the largest error of each."""
    first, first_plain, step, step_plain, names, args = cascade(
        folded, num_keys, tb_row)
    errs = dict.fromkeys(names, 0)
    y = first(x, tile, *args)
    errs[names[0]] = max_abs_err(y, first_plain(x, tile, *args))
    for lvl in range((x.shape[1] // tile).bit_length() - 1):
        errs["merge_partition"] = max(errs.get("merge_partition", 0),
                                      check_partition(y, tile << lvl,
                                                      num_keys, tb_row,
                                                      folded))
        z = step(y, tile << lvl, tile, *args)
        errs[names[1]] = max(errs[names[1]],
                             max_abs_err(z, step_plain(y, tile << lvl, tile,
                                                       *args)))
        y = z
    require(same(y, stable_reference(x, num_keys, tb_row)),
            f"{names} cascade differs from the stable sort")
    torch.cuda.synchronize()
    return errs


def merge_width(rows: int, num_keys: int, n: int, run_len: int,
                folded: bool) -> int:
    """The block width K4 (``folded``) or K1 takes on one pass."""
    if folded:
        return pallas_fold.merge_pass_folded_width(num_keys, n, run_len)
    return pallas_sort.merge_pass_width(rows, num_keys, n, run_len)


def check_partition(y: torch.Tensor, run_len: int, num_keys: int,
                    tb_row: int, folded: bool) -> int:
    """The partition kernel against its plain version (merge_splits) at
    the block width the merge kernel (K4 or K1) takes; the largest
    error."""
    rows, n = y.shape
    width = merge_width(rows, num_keys, n, run_len, folded)
    require(n % width == 0 and width <= 2 * run_len,
            f"merge width {width} at n={n} run_len={run_len}")
    got = pallas_sort.merge_partition(y, run_len, width, num_keys, tb_row)
    want = pallas_sort.merge_partition_plain(y, run_len, width, num_keys,
                                             tb_row)
    return max_abs_err(got, want)


def check_take_lanes(gen: torch.Generator, rows: int, n: int) -> int:
    """K5 against ``x[:, perm]`` on random words and a permutation, through
    the wrapper and through each design launched on its own; the largest
    error of the wrapper against its plain version."""
    dev = gen.device
    x = torch.randint(-(1 << 31), 1 << 31, (rows, n), dtype=torch.int32,
                      generator=gen, device=dev).view(torch.uint32)
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    want = sort_ops.take_cols(x, perm.long())
    got = lane_gather.take_lanes(x, perm)
    require(same(got, want),
            f"take_lanes [{rows}, {n}] differs from x[:, perm]")
    for how in ("direct", "records"):
        out = torch.empty_like(x)
        lane_gather._launch(x, perm, out, how)
        require(same(out, want),
                f"K5 {how} [{rows}, {n}] differs from x[:, perm]")
    return max_abs_err(got, lane_gather.take_lanes_plain(x, perm))


def phase_kernels(dev: torch.device, n: int = N_KERNEL,
                  tiles=KERNEL_TILES, edges=EDGE_CASES,
                  slim_edges=SLIM_EDGE_CASES, equal_cases=EQUAL_RUN_CASES,
                  take_shapes=TAKE_SHAPES) -> dict:
    gen = generator(SEED + 1, dev)
    seeds = itertools.count(SEED + 1)
    worst: dict = {}
    for tile in tiles:
        cases = [(8, 3, 7, False), (32, 3, 31, False), (4, 3, 3, True)]
        for rows, nk, tb, folded in cases:
            x = interop.words_from_numpy(
                lanes_words(next(seeds), rows, n, nk), dev)
            errs = check_cascade(x, nk, tb, tile, folded)
            for name, err in errs.items():
                worst[name] = max(worst.get(name, 0), err)
            if folded:
                public = pallas_fold.sort_lanes_folded4(x, nk, tile=tile)
                require(same(public, stable_reference(x, nk, tb)),
                        "sort_lanes_folded4 differs from the stable sort")
            else:
                ref = stable_reference(x, nk, tb)
                for two_phase in (False, True):
                    got = pallas_sort.sort_lanes(x, nk, tb, tile=tile,
                                                 two_phase=two_phase)
                    require(same(got, ref),
                            f"sort_lanes rows={rows} two_phase={two_phase}"
                            f" differs from the stable sort")
            torch.cuda.synchronize()
            log(f"[kernels] rows={rows} keys={nk} tile={tile} n={n}: "
                f"max_abs_err against the plain versions {errs} "
                f"(tolerance 0); public cascade equal to the stable sort")
    edge_runs = [(rows, nk, tb, n_edge, tile, kind, False)
                 for rows, nk, tb, n_edge, tile, kind in edges]
    edge_runs += [(4, nk, 3, n_edge, tile, kind, True)
                  for nk, n_edge, tile, kind in slim_edges]
    for rows, nk, tb, n_edge, tile, kind, folded in edge_runs:
        x = interop.words_from_numpy(
            lanes_words(next(seeds), rows, n_edge, nk, kind), dev)
        errs = check_cascade(x, nk, tb, tile, folded)
        for name, err in errs.items():
            worst[name] = max(worst.get(name, 0), err)
        log(f"[kernels] edge rows={rows} keys={nk} tile={tile} n={n_edge} "
            f"{kind} keys: max_abs_err {errs} (tolerance 0); cascade equal "
            f"to the stable sort")
    for nk, n_eq, run_len in equal_cases:
        x = interop.words_from_numpy(
            equal_runs(next(seeds), n_eq, run_len, nk), dev)
        err = max_abs_err(
            pallas_fold.merge_pass_folded(x, run_len, run_len, nk),
            pallas_fold.merge_pass_folded_plain(x, run_len, run_len, nk))
        worst["merge_pass_folded"] = max(worst.get("merge_pass_folded", 0),
                                         err)
        log(f"[kernels] K4 on runs with equal records, keys={nk} "
            f"run_len={run_len} n={n_eq}: max_abs_err {err} (tolerance 0)")
    for rows, n_take in take_shapes:
        err = check_take_lanes(gen, rows, n_take)
        worst["take_lanes"] = max(worst.get("take_lanes", 0), err)
        log(f"[kernels] K5 take_lanes [{rows}, {n_take}] "
            f"({lane_gather.design(rows, n_take)}): max_abs_err {err} "
            f"(tolerance 0); both designs equal to x[:, perm]")
    torch.cuda.synchronize()
    require(all(v == 0 for v in worst.values()),
            f"kernel differs from its plain version: {worst}")
    return worst


# ---------------------------------------------------------------- phase 4
def run_path(words: torch.Tensor, path: str, own: tuple,
             reference: torch.Tensor) -> dict:
    """One drive of single_chip_sort with the launch counts reset just
    before and read just after, for every kernel; each of the path's
    ``own`` kernels must have launched. Checks order, checksum and
    bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = terasort.single_chip_sort(words, path=path, device=words.device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: _build.launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    require(all(counts[k] for k in own), f"{path}: a kernel of {own} never "
                                         f"launched {counts}")
    require(out.shape == words.shape and out.dtype == torch.uint32,
            f"{path}: output {out.dtype} {tuple(out.shape)}")
    terasort.validate_sorted(out, words)
    require(same(out, reference),
            f"{path}: output differs from the stable-sort yardstick")
    log(f"[main] {path}: n={words.shape[0]} {secs:.3f} s (first call, host "
        f"clock), launches {counts}, peak {peak / 2**30:.2f} GiB; sorted, "
        f"checksum equal, equal to the yardstick")
    return {"path": path, "own": own, "seconds": secs, "launches": counts,
            "peak_bytes": peak}


def yardstick(words: torch.Tensor) -> torch.Tensor:
    """The whole sort by PyTorch's stable sort: never on the port's path."""
    perm = sort_ops.stable_lex_argsort(list(words.T[:terasort.KEY_WORDS]))
    return u32(i32(words)[perm])


def phase_main(dev: torch.device, n: int = N_MAIN) -> tuple:
    words = terasort.teragen(generator(SEED, dev), n)
    auto = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev)
    require(auto == "keys8", f'"auto" resolved to {auto!r}, not keys8')
    reference = yardstick(words)
    runs = [run_path(words, "auto", MAIN_PATH, reference),
            run_path(words, "keys8f", ("tile_sort_folded",
                                       "merge_pass_folded",
                                       "merge_partition"), reference)]
    return words, runs


@contextlib.contextmanager
def tune_cache_naming(engine: str, n: int, dev: torch.device):
    """A temporary tune cache, the process default for the block
    (``UDA_TPU_TUNE_CACHE``), whose winner for ``n`` rows of lanes-capable
    callers on ``dev`` is ``engine``; the cold default is back after."""
    key = (f"{sort_ops.cache_backend(dev)}|rows{tuncache.rows_bucket(n)}"
           f"|lanes1")
    saved_cache = tuncache.tune_cache
    saved_env = os.environ.get("UDA_TPU_TUNE_CACHE")
    with tempfile.TemporaryDirectory(prefix="uda_tune_") as d:
        path = os.path.join(d, "tune.json")
        tuncache.TuneCache(path).record("sort.engine", key,
                                        {"engine": engine},
                                        probe="chip_smoke phase 4b")
        os.environ["UDA_TPU_TUNE_CACHE"] = path
        tuncache.tune_cache = tuncache.TuneCache(
            tuncache.cache_path_from_env())
        try:
            yield key
        finally:
            tuncache.tune_cache = saved_cache
            if saved_env is None:
                os.environ.pop("UDA_TPU_TUNE_CACHE", None)
            else:
                os.environ["UDA_TPU_TUNE_CACHE"] = saved_env


def phase_tune_cache(words: torch.Tensor, runs: list) -> dict:
    """Phase 4b: "auto" routed by a cached winner (keys8f) on the main
    path's records, held to the yardstick; K3 and K4 launch and K2 does
    not. Timed (CUDA events, in turns) against phase 4's explicit
    engines."""
    dev, n = words.device, int(words.shape[0])
    reference = yardstick(words)
    with tune_cache_naming("keys8f", n, dev) as key:
        auto = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev)
        require(auto == "keys8f",
                f'"auto" under the cache {key} resolved to {auto!r}')
        res = run_path(words, "auto", ("tile_sort_folded",
                                       "merge_pass_folded",
                                       "merge_partition"), reference)
        require(res["launches"]["tile_sort"] == 0,
                f"K2 launched under the cached keys8f: {res['launches']}")
        hits = metrics.get("tune.cache.hits", domain="sort.engine")
        call = {p: (lambda p=p: terasort.single_chip_sort(
            words, path=p, device=dev)) for p in ("auto", "keys8f", "keys8")}
        auto_ms, keys8f_ms, keys8_ms = in_turns(
            call["auto"], call["keys8f"], call["keys8"], reps=2)
    del reference
    cold = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev)
    require(cold == "keys8", f'"auto" after the cache resolved to {cold!r}')
    out = {"key": key, "engine": auto, "launches": res["launches"],
           "first_call_s": res["seconds"], "cache_hits": hits,
           "auto_ms": auto_ms, "keys8f_ms": keys8f_ms, "keys8_ms": keys8_ms,
           "phase4_first_call_s": {r["path"]: r["seconds"] for r in runs}}
    log("[tune cache] " + json.dumps(out))
    return out


# ---------------------------------------------------------------- phase 5
def phase_steering(dev: torch.device) -> dict:
    """At 2^16 rows a cold cache's "auto" is carrychunk on the card (the
    reference's small-batch rule); the steered route is timed in turns
    against keys8 and keys8f at each of STEER_ROWS, with equal bytes."""
    out = {}
    for n in STEER_ROWS:
        words = terasort.teragen(generator(SEED + 7, dev), n)
        auto = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev)
        require(auto == "carrychunk",
                f'"auto" at {n} rows resolved to {auto!r}, not carrychunk')
        reference = yardstick(words)
        call = {p: (lambda p=p: terasort.single_chip_sort(
            words, path=p, device=dev)) for p in ("auto", "keys8",
                                                  "keys8f")}
        for p, fn in call.items():
            require(same(fn(), reference), f"{p} at {n} rows differs")
        ms = in_turns(call["auto"], call["keys8"], call["keys8f"], reps=10)
        out[n] = {"auto": auto, "auto_ms": ms[0], "keys8_ms": ms[1],
                  "keys8f_ms": ms[2]}
    log("[steering] " + json.dumps(out))
    return out


def phase_engines(dev: torch.device, n: int = N_ENGINES) -> dict:
    words = terasort.teragen(generator(SEED + 2, dev), n)
    reference = yardstick(words)
    _build.reset_launches()
    for path in sort_ops.ALL_SORT_PATHS:
        out = terasort.single_chip_sort(words, path=path, device=dev)
        require(same(out, reference), f"engine {path} differs")
    counts = dict(_build.launches)
    viol, ck_in, ck_out = terasort.bench_step(SEED, n, 2, "keys8",
                                               device=dev)
    require(int(viol) == 0 and int(ck_in) == int(ck_out),
            f"bench_step keys8: {int(viol)} violations, checksums "
            f"{int(ck_in)} / {int(ck_out)}")
    torch.cuda.synchronize()
    log(f"[engines] {len(sort_ops.ALL_SORT_PATHS)} engines at n={n}: "
        f"identical; launches {counts}; bench_step keys8 k=2: 0 "
        f"violations, checksums equal")
    return counts


# ---------------------------------------------------------------- phase 6
def library_sort(x: torch.Tensor, seg: int, num_keys: int,
                 tb_row: "int | None") -> torch.Tensor:
    """What a kernel computes, by PyTorch's stable sort (``torch.sort``
    over int64-packed key words; no single PyTorch call sorts by an 80-bit
    key): every segment of ``seg`` columns sorted by its key rows, then
    every row moved by the permutation. With ``tb_row`` it is K2/K3 (the
    tie-break row set to the arrival index); without, one K1/K4 pass,
    whose run pairs are the segments and whose tie-break row orders
    equal keys. Never on the port's path: the ``library_ms`` yardstick."""
    rows, m = x.shape
    key_rows = list(range(num_keys)) + ([] if tb_row is not None
                                        else [rows - 1])
    order = sort_ops.stable_lex_argsort(
        [x[r].view(-1, seg) for r in key_rows], dim=1)
    src = (order + torch.arange(0, m, seg, device=x.device)[:, None]
           ).flatten()
    out = sort_ops.take_cols(x, src)
    if tb_row is not None:
        i32(out)[tb_row] = i32(words_of(src))
    return out


def partition_work(m: int, run_len: int, width: int) -> tuple:
    """Bytes and compares the partition kernel needs on one pass: per
    block boundary a binary search over the diagonal's range, each step
    reading one word of two records (more only on equal words), and one
    4-byte split written. Returns (bytes, compares)."""
    steps = sum((min(d, run_len) - max(0, d - run_len)).bit_length()
                for d in range(0, 2 * run_len, width))
    steps *= m // (2 * run_len)
    return 4 * (m // width) + 2 * 4 * steps, steps


def time_cascade(mat: torch.Tensor, tile: int, folded: bool,
                 reps: int) -> dict:
    """Time each kernel of one cascade at ``mat``'s shape, its plain
    version and PyTorch's stable sort on the same input, and compare
    them."""
    rows, m = mat.shape
    nk = terasort.KEY_WORDS
    tb = rows - 1
    first, first_plain, step, step_plain, names, args = cascade(folded, nk,
                                                                tb)
    word = 4
    words_compared = nk + 1   # key words and the tie-break
    y = first(mat, tile, *args)
    require(same(library_sort(mat, tile, nk, tb), y),
            f"{names[0]}: PyTorch's per-tile sort differs")
    res = {names[0]: {
        "ms": time_ms(lambda: first(mat, tile, *args), reps),
        "plain_ms": time_ms(lambda: first_plain(mat, tile, *args), 1,
                            warmup=0),
        "library_ms": time_ms(lambda: library_sort(mat, tile, nk, tb), 1),
        # reads every row but the tie-break, writes every row
        "bytes": (2 * rows - 1) * m * word,
        # a merge sort of each tile: log2(tile) compares per record
        "ops": m * (tile.bit_length() - 1) * words_compared,
        "max_abs_err": max_abs_err(y, first_plain(mat, tile, *args)),
    }}
    spare = torch.empty_like(y)
    per_pass = []
    errs = 0
    plain_total = library_total = 0.0
    part = {"ms": 0.0, "per_pass_ms": [], "plain_ms": 0.0, "bytes": 0,
            "ops": 0, "max_abs_err": 0, "library_ms": None}
    for lvl in range((m // tile).bit_length() - 1):
        L = tile << lvl
        width = merge_width(rows, nk, m, L, folded)
        part["per_pass_ms"].append(time_ms(
            lambda: pallas_sort.merge_partition(y, L, width, nk, tb), reps))
        part["plain_ms"] += time_ms(
            lambda: pallas_sort.merge_partition_plain(y, L, width, nk, tb),
            1, warmup=0)
        part["max_abs_err"] = max(part["max_abs_err"],
                                  check_partition(y, L, nk, tb, folded))
        nbytes, steps = partition_work(m, L, width)
        part["bytes"] += nbytes
        part["ops"] += steps
        per_pass.append(time_ms(lambda: step(y, L, tile, *args, out=spare),
                                reps))
        plain_total += time_ms(lambda: step_plain(y, L, tile, *args), 1,
                               warmup=0)
        library_total += time_ms(lambda: library_sort(y, 2 * L, nk, None),
                                 1, warmup=0)
        z = step(y, L, tile, *args, out=spare)
        errs = max(errs, max_abs_err(z, step_plain(y, L, tile, *args)))
        require(same(library_sort(y, 2 * L, nk, None), z),
                f"{names[1]}: PyTorch's sort of each run pair differs")
        y, spare = z, y
    part["ms"] = sum(part["per_pass_ms"])
    res[names[1]] = {
        "ms": sum(per_pass), "per_pass_ms": per_pass,
        "plain_ms": plain_total, "library_ms": library_total,
        "bytes": len(per_pass) * 2 * rows * m * word,
        # a merge: one compare per record and pass
        "ops": len(per_pass) * m * words_compared,
        "max_abs_err": max(errs, part["max_abs_err"]),
    }
    # the partition kernel, at each merge kernel's own width; its time is
    # also inside the merge pass's, which is timed through the wrapper
    if folded:
        res[names[1]]["partition"] = part
    else:
        res["merge_partition"] = part
    torch.cuda.synchronize()
    return res


def in_turns(*fns, reps: int, timer=time_ms) -> tuple:
    """Mean ms of each of ``fns`` by ``timer``, timed in order and then in
    reverse (a, b, b, a; a, b, c, c, b, a) so that the card's drift falls
    on all."""
    order = list(fns) + list(reversed(fns))
    ms = [timer(f, reps) for f in order]
    return tuple((ms[i] + ms[-1 - i]) / 2 for i in range(len(fns)))


def ab_slim(mat4: torch.Tensor, tile: int, reps: int) -> dict:
    """A/Bs on the slim [4, m] matrix, in turns within this run: K3 and K4
    (the layout fixed at compile time) against K2 and K1 on the same
    input (rows, key count and tie-break row read at run time; K1's own
    width rule), and K4 at 2048 against 4096 records a block (passes with
    2 * run_len >= 4096). Every output is checked against K4's."""
    nk, tb = terasort.KEY_WORDS, 3
    m = mat4.shape[1]
    ab = {"k3_ms": 0.0, "k2_4rows_ms": 0.0, "k4_ms": 0.0, "k1_4rows_ms": 0.0,
          "k1_4rows_widths": [], "k4_w2048_ms": 0.0, "k4_w4096_ms": 0.0,
          "width_ab_passes": 0}
    ab["k3_ms"], ab["k2_4rows_ms"] = in_turns(
        lambda: pallas_fold.tile_sort_folded(mat4, tile, nk),
        lambda: pallas_sort.tile_sort(mat4, tile, nk, tb), reps=reps)
    y = pallas_fold.tile_sort_folded(mat4, tile, nk)
    require(same(y, pallas_sort.tile_sort(mat4, tile, nk, tb)),
            "K3 differs from K2 at 4 rows")
    spare = torch.empty_like(y)
    for lvl in range((m // tile).bit_length() - 1):
        L = tile << lvl
        k4, k1 = in_turns(
            lambda: pallas_fold.merge_pass_folded(y, L, tile, nk, out=spare),
            lambda: pallas_sort.merge_pass(y, L, tile, nk, tb, out=spare),
            reps=reps)
        ab["k4_ms"] += k4
        ab["k1_4rows_ms"] += k1
        ab["k1_4rows_widths"].append(
            pallas_sort.merge_pass_width(4, nk, m, L))
        z = pallas_fold.merge_pass_folded(y, L, tile, nk)
        require(same(z, pallas_sort.merge_pass(y, L, tile, nk, tb)),
                "K4 differs from K1 at 4 rows")
        if 2 * L >= 4096:
            w2, w4 = in_turns(
                lambda: pallas_fold._merge_pass_folded_at(y, L, nk, 2048,
                                                          spare),
                lambda: pallas_fold._merge_pass_folded_at(y, L, nk, 4096,
                                                          spare), reps=reps)
            ab["k4_w2048_ms"] += w2
            ab["k4_w4096_ms"] += w4
            ab["width_ab_passes"] += 1
            require(same(z, pallas_fold._merge_pass_folded_at(
                y, L, nk, 4096, None)), "K4 at width 4096 differs")
        y = z
    torch.cuda.synchronize()
    log("[ab] slim layout at m={} tile={}: {}".format(m, tile,
                                                        json.dumps(ab)))
    return ab


def merge_perm(keys: torch.Tensor) -> torch.Tensor:
    """The stable order of ``keys`` (int64) with each half sorted first:
    two increasing runs interleaved, the permutation a two-phase merge
    applies."""
    h = keys.shape[0] // 2
    runs = torch.cat([keys[:h].sort().values, keys[h:].sort().values])
    return torch.sort(runs, stable=True).indices.to(torch.int32)


def time_take_lanes(mat: torch.Tensor, perm: torch.Tensor,
                    merge: torch.Tensor, reps: int) -> dict:
    """K5 on the keys8 matrix by the main path's sort permutation and by a
    merge permutation. Per permutation: K5's own time (``device_ms``
    around its launches, after one checked call) in turns with torch
    indexing ``x[:, perm]`` and the other design; the whole wrapper call,
    its range check included; the peak memory of one call and the scratch
    (the most one launch into a given ``out`` allocates). The plain
    version's time on the sort permutation."""
    rows, m = mat.shape
    how = lane_gather.design(rows, m)
    other = "direct" if how == "records" else "records"
    out = torch.empty_like(mat)
    res = {
        "design": how,
        # every input word and perm read once, every output word written
        "bytes": (2 * rows * m + m) * 4,
        "ops": 0,
        "max_abs_err": 0,
    }
    for name, p in (("sort", perm), ("merge", merge)):
        p64 = p.long()
        want = i32(mat)[:, p64]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = lane_gather.take_lanes(mat, p)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lane_gather._launch(mat, p, out, how)
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - base
        require(same(got, u32(want)),
                f"take_lanes differs from x[:, perm] ({name} permutation)")
        res["max_abs_err"] = max(res["max_abs_err"], max_abs_err(
            got, lane_gather.take_lanes_plain(mat, p)))
        del got, want
        own, lib, alt = in_turns(
            lambda: lane_gather._launch(mat, p, out, how),
            lambda: i32(mat)[:, p64],
            lambda: lane_gather._launch(mat, p, out, other),
            reps=reps, timer=device_ms)
        t = {"ms": own, "library_ms": lib, f"{other}_ms": alt,
             "call_ms": time_ms(lambda: lane_gather.take_lanes(mat, p),
                                reps),
             "peak_bytes": peak, "scratch_bytes": scratch}
        if name == "sort":
            res.update(t)
        else:
            res["merge"] = t
        log(f"[times] K5 take_lanes [{rows}, {m}] {name} permutation: "
            f"{how} {own:.3f} ms, torch indexing {lib:.3f} ms, {other} "
            f"{alt:.3f} ms (device, in turns); wrapper call "
            f"{t['call_ms']:.3f} ms; scratch {scratch} B, "
            f"peak {peak} B")
    res["plain_ms"] = time_ms(lambda: lane_gather.take_lanes_plain(mat, perm),
                              1)
    # the card's streaming rate in this run: x copied, read once, written
    res["copy_ms"] = device_ms(lambda: out.copy_(mat), reps)
    torch.cuda.synchronize()
    return res


def sweep_take_lanes(dev: torch.device, ns=TAKE_SWEEP_NS,
                     probe_shapes=PROBE_SHAPES) -> list:
    """K5's two designs in turns (device time) on random words by a random
    permutation at [8, n] for each n of ``ns`` and at the probe's shapes:
    the evidence for the small-shape rule (``lane_gather.SMALL_BYTES``)."""
    gen = generator(SEED + 7, dev)
    shapes = [(8, n) for n in ns]
    shapes += [s for s in probe_shapes if s not in shapes]
    res = []
    for rows, n in shapes:
        x = torch.randint(-(1 << 31), 1 << 31, (rows, n), dtype=torch.int32,
                          generator=gen, device=dev).view(torch.uint32)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        out = torch.empty_like(x)
        direct, records = in_turns(
            lambda: lane_gather._launch(x, perm, out, "direct"),
            lambda: lane_gather._launch(x, perm, out, "records"),
            reps=max(5, min(200, (1 << 24) // n)), timer=device_ms)
        res.append({"rows": rows, "n": n, "x_bytes": rows * n * 4,
                    "direct_ms": direct, "records_ms": records,
                    "design": lane_gather.design(rows, n)})
        log(f"[times] K5 sweep [{rows}, {n}] ({rows * n * 4} B of x): "
            f"direct {direct:.4f} ms, records {records:.4f} ms; the rule "
            f"takes {res[-1]['design']}")
    return res


def phase_times(words: torch.Tensor, tile: int = MAIN_TILE,
                reps: int = TIMED_REPS) -> dict:
    n = words.shape[0]
    m, tile = pallas_sort.pad_pow2(n, tile)
    keyr = fill_words((terasort.KEY_WORDS, m), words.device, _ALL_ONES)
    i32(keyr)[:, :n] = i32(words)[:, :terasort.KEY_WORDS].T
    mat8 = u32(torch.cat([i32(keyr), i32(keyr).new_zeros((5, m))]))
    mat4 = u32(torch.cat([i32(keyr), i32(keyr).new_zeros((1, m))]))
    times = time_cascade(mat8, tile, False, reps)
    times.update(time_cascade(mat4, tile, True, reps))
    ab = ab_slim(mat4, tile, reps)
    _, perm = pallas_sort.keys8_sort_perm(keyr, tile=tile)
    merge = merge_perm(sort_ops._packed_keys(list(keyr[:2]))[0])
    times["take_lanes"] = time_take_lanes(mat8, perm, merge, reps)
    del mat8, mat4, perm, merge
    sweep = sweep_take_lanes(words.device)
    require(all(t["max_abs_err"] == 0 for t in times.values()),
            "a kernel differs from its plain version at the main path's "
            "shapes")
    for name, t in times.items():
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"])
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.3f} ms")
        log(f"[times] {KERNELS[name]['id']} {name} at m={m} tile={tile}: "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, library "
            f"{lib}, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes']} B, {t['ops']} ops), "
            f"max_abs_err {t['max_abs_err']} (tolerance 0)")
        if "per_pass_ms" in t:
            log(f"[times] {name} per pass (ms): "
                + " ".join(f"{v:.3f}" for v in t["per_pass_ms"]))
        if "partition" in t:
            p = t["partition"]
            log(f"[times] {name}'s partition: {p['ms']:.3f} ms, plain "
                f"{p['plain_ms']:.3f} ms, max_abs_err {p['max_abs_err']}; "
                f"per pass (ms): "
                + " ".join(f"{v:.3f}" for v in p["per_pass_ms"]))
    keys = list(keyr)
    casc = {
        "keys8_cascade_ms": time_ms(
            lambda: pallas_sort.keys8_sort_perm(keyr, tile=tile), 3),
        "keys8f_cascade_ms": time_ms(
            lambda: pallas_sort.keys8_sort_perm(keyr, tile=tile,
                                                folded=True), 3),
        "yardstick_perm_ms": time_ms(
            lambda: sort_ops.stable_lex_argsort(keys), 3),
        "single_chip_sort_keys8_ms": time_ms(
            lambda: terasort.single_chip_sort(words, device=words.device),
            2),
        "single_chip_sort_keys8f_ms": time_ms(
            lambda: terasort.single_chip_sort(words, path="keys8f",
                                              device=words.device), 2),
        "yardstick_sort_ms": time_ms(lambda: yardstick(words), 2),
        "records": n,
        "padded_records": m,
        "tile": tile,
    }
    log("[times] cascades " + json.dumps(casc))
    return {"kernels": times, "cascades": casc, "ab": ab,
            "take_lanes_sweep": sweep}


def phase_profile(words: torch.Tensor, path: str) -> dict:
    """Where a path's time goes: ``torch.profiler`` over one
    ``single_chip_sort`` call, device time summed by kernel name, and the
    device's busy share of the call (the union of device intervals over
    the host clock around the call, profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        terasort.single_chip_sort(words, path=path, device=words.device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("[profile] the profiler saw no device activity: not measured")
        return {}
    by_name: dict = {}
    busy = 0.0
    reach = spans[0][0]
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    prof_out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                "idle_share": 1.0 - busy / wall_us,
                "device_ms_by_kernel": {k[:80]: v / 1e3 for k, v in top}}
    log(f"[profile] {path} single_chip_sort " + json.dumps(prof_out))
    return prof_out


def device_time(prof) -> tuple:
    """(device ms by kernel name, device busy ms) of a profile: the busy
    time is the union of the device's intervals."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    by_name: dict = {}
    busy = 0.0
    reach = spans[0][0] if spans else 0.0
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
        busy += max(0.0, end - max(start, reach)) / 1e3
        reach = max(reach, end)
    return by_name, busy


# ---------------------------------------------------------------- phase 8
def tera_partitions(seed: int, maps: int, map_bytes: int) -> list:
    """Each map's reduce partition of TeraSort records, sorted by key as a
    map-side sort leaves it: uint8[n, 104] framed IFile records (n =
    map_bytes // 104 less the EOF marker), random keys and values from
    ``seed``."""
    rng = np.random.default_rng(seed)
    n = (map_bytes - 2) // TERA_RECORD
    parts = []
    for _ in range(maps):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
        rec = np.empty((n, TERA_RECORD), np.uint8)
        rec[:, :3] = (11, 91, 10)
        rec[:, 3:13] = keys[np.lexsort(keys.T[::-1])]
        rec[:, 13] = 90
        rec[:, 14:] = rng.integers(0, 256, (n, 90), dtype=np.uint8)
        parts.append(rec)
    return parts


def write_mof_tree(root: str, parts: list, pairs: bool = False) -> list:
    """One map output per partition under ``root`` by ``MOFWriter`` (one
    reduce partition each): framed TeraSort records, or (key, value)
    pairs when ``pairs``; returns the map ids."""
    writer = MOFWriter(root, MERGE_JOB)
    mids = []
    for m, rec in enumerate(parts):
        mid = map_id(m)
        writer.write(mid, [rec if pairs else record_pairs(rec)])
        mids.append(mid)
    return mids


def map_id(m: int) -> str:
    return f"attempt_{MERGE_JOB}_m_{m:06d}_0"


def record_pairs(rec: np.ndarray):
    """The (key, value) pairs, in their Text form, of framed TeraSort
    records."""
    flat = rec.tobytes()
    return ((flat[o + 2:o + 13], flat[o + 13:o + 104])
            for o in range(0, len(flat), TERA_RECORD))


def tera_batch(rec: np.ndarray) -> RecordBatch:
    """The RecordBatch of one partition's framed records."""
    start = np.arange(rec.shape[0], dtype=np.int64) * TERA_RECORD
    return RecordBatch(rec.reshape(-1), start + 2,
                       np.full_like(start, 11), start + 13,
                       np.full_like(start, 91))


def record_checksum(rec: np.ndarray) -> int:
    """Order-free checksum of framed records (uint8[n, 104]): the sum,
    mod 2^64, of a 64-bit mix of each record's 13 words."""
    words = np.ascontiguousarray(rec).view(np.uint64)
    mult = (np.arange(1, words.shape[1] + 1, dtype=np.uint64)
            * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    return int((words * mult).sum(axis=1, dtype=np.uint64).sum(
        dtype=np.uint64))


def check_merged_stream(stream: bytes, parts: list, dev: torch.device
                        ) -> dict:
    """The emitted stream cracks into every input record, its keys are in
    Text order (bytewise on the 10-byte content), its record multiset
    equals the input's, and it equals, byte for byte, the same partition
    merged by the whole-partition stable re-sort on the card."""
    total = sum(p.shape[0] for p in parts)
    t0 = time.perf_counter()
    batch = crack(stream)
    crack_s = time.perf_counter() - t0
    require(batch.num_records == total,
            f"stream cracks to {batch.num_records} records, not {total}")
    require(stream[-2:] == b"\xff\xff" and
            len(stream) == total * TERA_RECORD + 2, "stream length")
    out = np.frombuffer(stream, np.uint8)[:-2].reshape(total, TERA_RECORD)
    keys = out[:, 3:13]
    hi = keys[:, :8].copy().view(">u8").ravel()
    lo = keys[:, 8:].copy().view(">u2").ravel()
    require(bool(np.all((hi[:-1] < hi[1:])
                        | ((hi[:-1] == hi[1:]) & (lo[:-1] <= lo[1:])))),
            "emitted keys are out of Text order")
    require(record_checksum(out) == sum(record_checksum(p) for p in parts)
            % (1 << 64), "emitted records differ from the input multiset")
    t0 = time.perf_counter()
    resort = merge_ops.merge_batches([tera_batch(p) for p in parts],
                                     get_key_type(MERGE_KEY_CLASS), 16, dev)
    want = resort.data[(resort.key_off - 2)[:, None]
                       + np.arange(TERA_RECORD)]
    resort_s = time.perf_counter() - t0
    require(np.array_equal(out, want),
            "the merge differs from the whole-partition re-sort")
    return {"records": total, "crack_s": crack_s, "resort_s": resort_s}


def merge_classes(parts: list, dev: torch.device, reps: int) -> list:
    """K1 at each capacity class of the reduce task's merge tree: the
    partitions' run rows built as ``merge_batches_two_phase`` builds them,
    merged pairwise level by level (64 runs fold as the path folds them),
    and at each level the first pair packed as the path packs it, K1 held
    against its plain version and timed beside its bound and PyTorch's
    stable sort of the pair."""
    kt = get_key_type(MERGE_KEY_CLASS)
    level = []
    for seg, rec in enumerate(parts):
        pk = packing.pack_keys(tera_batch(rec), kt, 16)
        rows = np.empty((merge_ops.next_run_capacity(pk.num_records),
                         4 + merge_ops.ROW_EXTRA_COLS), np.uint32)
        merge_ops.fill_run_rows(rows, pk, merge_ops.run_row_order(pk), seg)
        level.append(interop.words_from_numpy(rows, dev))
    classes = []
    while len(level) > 1:
        a, b = level[0], level[1]
        w = a.shape[1]
        L = pallas_merge.pair_run_len(a.shape[0], b.shape[0], MERGE_TILE)
        x = pallas_merge.pack_pair(a, b, L)
        spare = torch.empty_like(x)
        got = pallas_sort.merge_pass(x, L, MERGE_TILE, w, w)
        err = max_abs_err(got, pallas_sort.merge_pass_plain(
            x, L, MERGE_TILE, w, w))
        require(err == 0, f"K1 at run_len {L} differs from its plain "
                          f"version")
        require(same(got, library_sort(x, 2 * L, w, None)),
                f"K1 at run_len {L} differs from PyTorch's stable sort")
        nbytes = 2 * x.numel() * 4     # every word read once, written once
        ms_bound, bound_by = bound(nbytes, 2 * L * (w + 1))
        rec = {"run_len": L, "shape": list(x.shape),
               "ms": time_ms(lambda: pallas_sort.merge_pass(
                   x, L, MERGE_TILE, w, w, out=spare), reps),
               "plain_ms": time_ms(lambda: pallas_sort.merge_pass_plain(
                   x, L, MERGE_TILE, w, w), 1, warmup=0),
               "library_ms": time_ms(lambda: library_sort(x, 2 * L, w, None),
                                     1),
               "bound_ms": ms_bound, "bound_by": bound_by,
               "width": pallas_sort.merge_pass_width(w + 1, w, 2 * L, L),
               "max_abs_err": err}
        classes.append(rec)
        log(f"[merge] K1 class run_len={L} x={rec['shape']}: "
            f"{rec['ms']:.3f} ms, bound {ms_bound:.3f} ms ({bound_by}), "
            f"plain {rec['plain_ms']:.3f} ms, library "
            f"{rec['library_ms']:.3f} ms, width {rec['width']}, "
            f"max_abs_err {err} (tolerance 0)")
        del x, spare, got
        level = [pallas_merge.merge_sorted_pair(level[i], level[i + 1], w)
                 for i in range(0, len(level) - 1, 2)] \
            + level[len(level) - len(level) % 2:]
    torch.cuda.synchronize()
    return classes


def phase_merge(dev: torch.device, root: str, mids: list, parts: list,
                map_bytes: int, setup_s: float,
                reps: int = TIMED_REPS) -> dict:
    from torch.profiler import ProfilerActivity, profile

    maps = len(parts)
    part_bytes = sum(p.nbytes + 2 for p in parts)
    cfg = Config({"uda.tpu.merge.overlap": False})
    engine = DataEngine(DirIndexResolver(root), cfg)
    stream = bytearray()
    try:
        mm = MergeManager(LocalFetchClient(engine), MERGE_KEY_CLASS, cfg,
                          device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        _build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            emitted = mm.run(MERGE_JOB, mids, 0, stream.extend)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        counts = {k: _build.launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
    finally:
        engine.stop()
    pairs = maps - 1
    require(counts["merge_pass"] == pairs and
            counts["merge_partition"] == pairs,
            f"the merge launched {counts}, not K1 once per each of its "
            f"{pairs} pair merges")
    require(emitted == len(stream) == part_bytes - 2 * (maps - 1),
            f"run() emitted {emitted} B")
    snap = metrics.snapshot()
    split = {"fetch_s": snap.get("fetch_time", 0.0),
             "rows_upload_s": snap.get("merge.rows_time", 0.0),
             "k1_fold_s": snap.get("merge.fold_time", 0.0),
             "k1_fold_device_ms": snap.get("merge.fold.device_ms", 0.0),
             "readback_gather_s": snap.get("merge.gather_time", 0.0)}
    split["emit_and_rest_s"] = wall - split["fetch_s"] - snap.get(
        "merge_time", 0.0)
    require(split["k1_fold_device_ms"] > 0, "the fold's device time was "
                                            "not measured")
    by_name, busy = device_time(prof)
    checks = check_merged_stream(bytes(stream), parts, dev)
    digest = hashlib.sha256(stream).hexdigest()
    del stream
    classes = merge_classes(parts, dev, reps)
    res = {"maps": maps, "map_bytes": map_bytes,
           "partition_bytes": part_bytes, "records": checks["records"],
           "wall_s": wall, "mb_per_s": part_bytes / wall / 1e6,
           "split": split, "launches": counts,
           "k1_device_ms": k1_device_ms(by_name), "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3) if by_name else None,
           "peak_bytes": peak, "setup_s": setup_s, "checks": checks,
           "sha256": digest, "stream_bytes": emitted,
           "top_device_ms": {k[:80]: v for k, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:6]},
           "classes": classes}
    log("[merge] " + json.dumps({k: v for k, v in res.items()
                                 if k != "classes"}))
    return res


def k1_device_ms(by_name: dict) -> dict:
    """K1's device ms in a profile, by its two kernels."""
    return {name: sum(v for k, v in by_name.items() if name in k)
            for name in ("merge_pass_kernel", "merge_partition_kernel")}


# ---------------------------------------------------------------- phase 9
def resort_digest(parts: list, dev: torch.device) -> tuple:
    """(sha256, length) of the stream a reduce task over ``parts`` must
    emit: the records in the order of the card's whole-partition stable
    re-sort, framed, and the EOF marker."""
    resort = merge_ops.merge_batches([tera_batch(p) for p in parts],
                                     get_key_type(MERGE_KEY_CLASS), 16, dev)
    want = resort.data[(resort.key_off - 2)[:, None]
                       + np.arange(TERA_RECORD)]
    digest = hashlib.sha256(want.tobytes())
    digest.update(b"\xff\xff")
    return digest.hexdigest(), want.size + 2


def hist(name: str) -> dict:
    """count, mean and max of one of the run's histograms (ms)."""
    h = metrics.histogram(name)
    return {"count": h["count"], "max": h["max"],
            "mean": h["sum"] / h["count"] if h["count"] else 0.0}


def overlap_run(dev: torch.device, root: str, mids: list, part_bytes: int,
                conf: dict, want: tuple, name: str,
                profiled: bool = False) -> dict:
    """One ``MergeManager.run`` of the overlapped merger over ``mids``,
    with the counts, metrics and launch counts reset just before and read
    just after; the stream is hashed as it is emitted and must equal
    ``want`` (sha256, length). K1 must have launched one merge and one
    partition kernel per forest merge (maps - 1); the in-flight gauge must
    be back at 0 and every pinned lease returned and some reused."""
    from torch.profiler import ProfilerActivity, profile

    cfg = Config(conf)
    engine = DataEngine(DirIndexResolver(root), cfg)
    digest = hashlib.sha256()
    length = 0

    def consumer(block: memoryview) -> None:
        nonlocal length
        digest.update(block)
        length += len(block)

    try:
        mm = MergeManager(LocalFetchClient(engine), MERGE_KEY_CLASS, cfg,
                          device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        metrics.enable_stats()   # the run's histograms below
        _build.reset_launches()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            emitted = mm.run(MERGE_JOB, mids, 0, consumer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: _build.launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
    finally:
        engine.stop()
    om = mm._active_overlap
    snap = metrics.snapshot()
    merges = len(mids) - 1
    require((digest.hexdigest(), length) == want and emitted == length,
            f"[overlap {name}] the stream differs from phase 8's: "
            f"{length} B, sha256 {digest.hexdigest()}")
    require(counts["merge_pass"] == counts["merge_partition"] == merges
            == om.stats["device_merges"],
            f"[overlap {name}] K1 launched {counts}, forest merges "
            f"{om.stats['device_merges']}, not {merges}")
    require(metrics.get_gauge("stage.inflight.bytes") == 0
            and om.stats["inflight_bytes"] == 0,
            f"[overlap {name}] in-flight bytes left charged")
    pool = om._buf_pool
    require(pool.pinned and pool.leased == 0,
            f"[overlap {name}] {pool.leased} leases not returned "
            f"(pinned: {pool.pinned})")
    require(snap.get("stage.buffer.reuses", 0) > 0,
            f"[overlap {name}] the pinned pool reused no buffer")
    require(metrics.histogram("merge.pipeline.put_ms")["count"]
            == len(mids), f"[overlap {name}] not one copy per run")
    split = {k: snap.get(k, 0.0) for k in (
        "fetch_time", "overlap_pack_time", "overlap_stage_time",
        "overlap_device_merge_time", "run_spool_time", "merge_time",
        "emit_time")}
    split["emit_and_rest_s"] = wall - split["fetch_time"] - split[
        "merge_time"]
    res = {"run": name, "maps": len(mids), "partition_bytes": part_bytes,
           "wall_s": wall, "mb_per_s": part_bytes / wall / 1e6,
           "split": split, "launches": counts,
           "merge_wait_ms": hist("merge.wait_ms"),
           "put_ms": hist("merge.pipeline.put_ms"),
           "pipeline_runs": snap.get("merge.pipeline.runs", 0),
           "backpressure_events": snap.get("stage.backpressure_events", 0),
           "buffer_reuses": snap.get("stage.buffer.reuses", 0),
           "peak_bytes": peak, "sha256": digest.hexdigest(),
           "stream_bytes": length}
    if profiled:
        by_name, busy = device_time(prof)
        res.update(k1_device_ms=k1_device_ms(by_name), device_busy_ms=busy,
                   idle_share=(1.0 - busy / (wall * 1e3) if by_name
                               else None),
                   top_device_ms={k[:80]: v for k, v in sorted(
                       by_name.items(), key=lambda kv: -kv[1])[:6]})
    log(f"[overlap {name}] " + json.dumps(res))
    return res


def varlen_partitions(seed: int, maps: int, map_bytes: int) -> list:
    """Each map's reduce partition of Text records, sorted by key as a
    map-side sort leaves it: (key, value) pairs in their Text form, keys
    of 10 random bytes, values of 1 to VARLEN_MAX_VALUE random bytes,
    about ``map_bytes`` a map, from ``seed``."""
    rng = np.random.default_rng(seed)
    n = map_bytes // (14 + VARLEN_MAX_VALUE // 2)
    key_head = vint.encode_vlong(10)
    parts = []
    for _ in range(maps):
        keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
        keys = keys[np.lexsort(keys.T[::-1])].tobytes()
        lens = rng.integers(1, VARLEN_MAX_VALUE + 1, n).tolist()
        body = rng.integers(0, 256, sum(lens), dtype=np.uint8).tobytes()
        pairs, at = [], 0
        for i, ln in enumerate(lens):
            pairs.append((key_head + keys[10 * i:10 * i + 10],
                          vint.encode_vlong(ln) + body[at:at + ln]))
            at += ln
        parts.append(pairs)
    return parts


def varlen_batches(parts: list) -> list:
    """The RecordBatch of each partition's framed records."""
    return [crack(b"".join(vint.encode_vlong(len(k)) + vint.encode_vlong(
        len(v)) + k + v for k, v in pairs) + EOF_MARKER) for pairs in parts]


def gather_times(cat: RecordBatch, reps: int = 3) -> dict:
    """One emission slab of variable-length records (SLAB_RECORDS spans of
    key and value, in a random order) gathered by the port's
    ``_gather_spans`` (by size class) and by an int64 index per byte (the
    reference's numpy form), on the same spans: equal bytes, host ms of
    each, best of ``reps``."""
    rng = np.random.default_rng(SEED + 9)
    pick = rng.choice(cat.num_records,
                      min(stream_mod.SLAB_RECORDS, cat.num_records),
                      replace=False)
    lens = (cat.key_len + cat.val_len)[pick]
    src_off = cat.key_off[pick]
    dst_off = np.cumsum(lens) - lens

    def by_class():
        out = np.empty(int(lens.sum()), np.uint8)
        stream_mod._gather_spans(cat.data, src_off, lens, out, dst_off)
        return out

    def index(off):
        return np.repeat(off - dst_off, lens) + np.arange(
            int(lens.sum()), dtype=np.int64)

    def by_byte():
        out = np.empty(int(lens.sum()), np.uint8)
        out[index(dst_off)] = cat.data[index(src_off)]
        return out

    require(np.array_equal(by_class(), by_byte()),
            "the span gather differs from the per-byte index")
    times = {}
    for name, fn in (("size_class_ms", by_class), ("byte_index_ms", by_byte)):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        times[name] = best
    times.update(spans=int(lens.size), bytes=int(lens.sum()),
                 distinct_lengths=int(np.unique(lens).size))
    return times


def phase_varlen(dev: torch.device, spill: str) -> dict:
    """Runs d (default Config) and e (streaming) on a tree of Text records
    with values of 1 to 1000 bytes, each held to the card's whole-partition
    re-sort of the same records, framed; and the span gather on one slab
    of them."""
    parts = varlen_partitions(SEED + 5, VARLEN_MAPS, VARLEN_MAP_BYTES)
    batches = varlen_batches(parts)
    part_bytes = sum(len(b.data) for b in batches)
    resort = merge_ops.merge_batches(batches, get_key_type(MERGE_KEY_CLASS),
                                     16, dev)
    framed = frame_batch(resort)
    want = (hashlib.sha256(framed).hexdigest(), len(framed))
    del framed, resort
    runs = {"gather": gather_times(RecordBatch.concat(batches))}
    log("[overlap varlen] span gather on one slab: "
        + json.dumps(runs["gather"]))
    with tempfile.TemporaryDirectory(prefix="uda_varlen_") as root:
        mids = write_mof_tree(root, parts, pairs=True)
        runs["d"] = overlap_run(dev, root, mids, part_bytes, {}, want,
                                "d varlen default")
        runs["e"] = overlap_run(dev, root, mids, part_bytes,
                                {"uda.tpu.online.streaming": True,
                                 "uda.tpu.spill.dirs": spill}, want,
                                "e varlen streaming")
    return runs


def phase_overlap(dev: torch.device, root: str, mids: list, parts: list,
                  merged: dict, c_maps: int = OVERLAP_C_MAPS) -> dict:
    """Runs a (64 maps, held to phase 8's stream), b (the first
    ``B_MAPS`` maps) and c (run c's first 16 maps), each held to the
    card's re-sort of its maps, and the variable-length runs d, e."""
    part_bytes = sum(p.nbytes + 2 for p in parts)
    want = (merged["sha256"], merged["stream_bytes"])
    sub = parts[:c_maps]
    sub_bytes = sum(p.nbytes + 2 for p in sub)
    want_c = resort_digest(sub, dev)
    with tempfile.TemporaryDirectory(prefix="uda_spill_") as spill:
        runs = {
            "a": overlap_run(dev, root, mids, part_bytes, {}, want,
                             "a default", profiled=True),
            "b": overlap_run(dev, root, mids[:B_MAPS],
                             sum(p.nbytes + 2 for p in parts[:B_MAPS]),
                             {"uda.tpu.online.streaming": True,
                              "uda.tpu.spill.dirs": spill},
                             resort_digest(parts[:B_MAPS], dev),
                             "b streaming"),
        }
        runs.update(phase_varlen(dev, spill))
        require(not os.listdir(spill), "the run store left files behind")
    runs["c"] = overlap_run(dev, root, mids[:c_maps], sub_bytes,
                            {"uda.tpu.stage.pipeline": False}, want_c,
                            "c pipeline off")
    return runs


# --------------------------------------------------------------- phase 10
class CountingEngine(DataEngine):
    """A DataEngine that counts its reads per (map, offset): the probe of
    the zero-fetch checks (the hard ceiling, the checkpoint's resume) and
    of the mid-partition resume (no offset 0 read twice)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reads: dict = {}
        self._reads_lock = threading.Lock()

    def submit(self, req):
        with self._reads_lock:
            key = (req.map_id, req.offset)
            self.reads[key] = self.reads.get(key, 0) + 1
        return super().submit(req)

    @property
    def fetches(self) -> dict:
        """Reads per map."""
        out: dict = {}
        with self._reads_lock:
            for (mid, _), n in self.reads.items():
                out[mid] = out.get(mid, 0) + n
        return out


def drive_task(dev: torch.device, client, engines: list, entries: list,
               conf: dict, name: str, fault: str = "",
               profiled: bool = False, before_run=None) -> dict:
    """One ``MergeManager.run`` over ``entries`` through ``client`` with
    ``fault`` armed in the port's failpoint registry, ``metrics`` and the
    launch counts reset just before and read just after; the stream is
    hashed as it is emitted; ``engines`` are stopped after. Returns the
    run's record: its stream (sha256, length) or the FallbackSignal it
    ended in, wall, launches, peak memory, the metrics snapshot and the
    manager; with ``profiled`` (``torch.profiler``) the device's busy ms
    and idle share too. ``before_run(manager)`` runs after the resets and
    before the timed ``run()`` (13a's map phase)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = Config(conf)
    digest = hashlib.sha256()
    length = 0

    def consumer(block: memoryview) -> None:
        nonlocal length
        digest.update(block)
        length += len(block)

    error = None
    try:
        mm = MergeManager(client, MERGE_KEY_CLASS, cfg, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        _build.reset_launches()
        if before_run is not None:
            before_run(mm)
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with failpoints.scoped(fault), ctx as prof:
            t0 = time.perf_counter()
            try:
                mm.run(MERGE_JOB, entries, 0, consumer)
            except FallbackSignal as e:
                error = e
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: _build.launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
    finally:
        for e in engines:
            e.stop()
    res = {"run": name, "wall_s": wall, "launches": counts,
           "peak_bytes": peak, "sha256": digest.hexdigest(),
           "stream_bytes": length, "error": error, "mm": mm,
           "metrics": metrics.snapshot()}
    if profiled:
        by_name, busy = device_time(prof)
        res.update(device_busy_ms=busy, idle_share=(
            1.0 - busy / (wall * 1e3) if by_name else None))
    return res


def task_run(dev: torch.device, root: str, mids: list, conf: dict,
             name: str, fault: str = "") -> dict:
    """``drive_task`` over ``mids`` through a LocalFetchClient of a
    CountingEngine over ``root`` (the record's ``engine``)."""
    engine = CountingEngine(DirIndexResolver(root), Config(conf))
    res = drive_task(dev, LocalFetchClient(engine), [engine], mids, conf,
                     name, fault)
    res["engine"] = engine
    return res


def _report(res: dict, part_bytes: int, keys=()) -> dict:
    """The printable part of a task_run record: wall, MB/s, launches, peak
    memory, stream or cause, and the named metrics."""
    out = {k: res[k] for k in ("run", "wall_s", "launches", "peak_bytes",
                               "sha256", "stream_bytes")}
    out["mb_per_s"] = part_bytes / res["wall_s"] / 1e6
    if res["error"] is not None:
        out["cause"] = type(res["error"].cause).__name__
    out.update({k: res["metrics"].get(k, 0.0) for k in keys})
    adm = res["mm"].last_admission
    if adm is not None:
        out["admission"] = {"decision": adm.decision, "cause": adm.cause,
                            "reason": adm.reason,
                            "estimate_bytes": adm.estimate_bytes,
                            "device_bytes": adm.device_bytes,
                            "hbm_budget_bytes": adm.hbm_budget_bytes,
                            "host_budget_bytes": adm.host_budget_bytes}
    log(f"[admission {res['run']}] " + json.dumps(out))
    return out


def _require_stream(res: dict, want: tuple) -> None:
    require(res["error"] is None,
            f"[admission {res['run']}] ended in {res['error']!r}")
    require((res["sha256"], res["stream_bytes"]) == want,
            f"[admission {res['run']}] the stream differs from run c's: "
            f"{res['stream_bytes']} B, sha256 {res['sha256']}")


def phase_admission(dev: torch.device, root: str, mids: list,
                    part_bytes: int, want: tuple, want_b: tuple) -> dict:
    """Phase 10 on the maps of run c (``mids``, whose stream must equal
    ``want``, run c's (sha256, length)): (a) the hybrid merge; (b) the
    three routes of approach 0, the first two on the first
    ``B_MAPS`` maps (stream ``want_b``); (c) a checkpointed task
    killed by a lost map and resumed; (d) a wedged fetch ended by the
    watchdog."""
    k1 = ("merge_pass", "merge_partition")
    b_mids = mids[:B_MAPS]
    b_bytes = part_bytes * len(b_mids) // len(mids)  # maps of one size
    runs: dict = {}
    with tempfile.TemporaryDirectory(prefix="uda_lpq_") as spill:
        # (a) 4 LPQs of 4 maps, 3 at a time: 3 K1 pair merges an LPQ
        hybrid = {"mapred.netmerger.merge.approach": 2,
                  "mapred.netmerger.hybrid.lpq.size": HYBRID_LPQ_MAPS,
                  "mapred.rdma.num.parallel.lpqs": HYBRID_PARALLEL,
                  "uda.tpu.spill.dirs": spill}
        res = task_run(dev, root, mids, hybrid, "a hybrid")
        _require_stream(res, want)
        lpqs = -(-len(mids) // HYBRID_LPQ_MAPS)
        pairs = len(mids) - lpqs
        require(all(res["launches"][k] == pairs for k in k1),
                f"[admission a] K1 launched {res['launches']}, not "
                f"{pairs} + {pairs}")
        require(not os.listdir(spill), "the hybrid merge left spill files")
        runs["a"] = _report(res, part_bytes,
                            ("lpq_phase_time", "lpq_spill_time",
                             "rpq_phase_time", "fetch_time", "merge_time"))
        # (b) approach 0: the defaults route the first 8 maps (134 MB) to
        # hybrid
        auto = {"mapred.netmerger.merge.approach": 0,
                "mapred.rdma.num.parallel.lpqs": HYBRID_PARALLEL,
                "uda.tpu.spill.dirs": spill}
        res = task_run(dev, root, b_mids, auto, "b1 auto")
        _require_stream(res, want_b)
        adm = res["mm"].last_admission
        require(adm.decision == "hybrid" and not adm.cause,
                f"[admission b1] routed {adm}")
        # the defaults' LPQ count: round(sqrt(maps)), 3 for 8 maps
        b_pairs = len(b_mids) - num_lpqs_for(len(b_mids), 0)
        require(all(res["launches"][k] == b_pairs for k in k1),
                f"[admission b1] K1 launched {res['launches']}")
        runs["b1"] = _report(res, b_bytes, ("rpq_phase_time",))
        runs["b1"]["card_hbm_bytes"] = torch.cuda.mem_get_info(dev)[1]
        # a 256 MB device budget (below the 8 maps' modelled device
        # working set): streaming with no device run
        res = task_run(dev, root, b_mids,
                       dict(auto, **{"uda.tpu.hbm.budget.mb": 256}),
                       "b2 auto over the device budget")
        _require_stream(res, want_b)
        adm = res["mm"].last_admission
        require(adm.decision == "streaming" and adm.cause == "hbm"
                and not res["mm"]._active_overlap.device_runs,
                f"[admission b2] routed {adm}")
        require(not any(res["launches"][k] for k in k1),
                f"[admission b2] K1 launched {res['launches']}")
        runs["b2"] = _report(res, b_bytes, ("run_spool_time",
                                            "merge_time"))
        # a 100 MB hard ceiling: refused before any fetch
        res = task_run(dev, root, mids,
                       dict(auto, **{"uda.tpu.budget.hard.mb": 100}),
                       "b3 auto over the hard ceiling")
        adm = res["mm"].last_admission
        require(res["error"] is not None and adm.rejected
                and adm.cause == "hard" and not res["engine"].fetches,
                f"[admission b3] {res['error']!r}, {adm}, fetches "
                f"{res['engine'].fetches}")
        runs["b3"] = _report(res, part_bytes)
        require(not os.listdir(spill), "the run store left files behind")
    # (c) a checkpointed streaming task dies on its last map; the retry
    # resumes from the checkpoint
    with tempfile.TemporaryDirectory(prefix="uda_ckpt_") as ck:
        conf = {"uda.tpu.online.streaming": True, "uda.tpu.ckpt.dir": ck,
                "uda.tpu.ckpt.interval.s": 0.0, "uda.tpu.fetch.retries": 0}
        res = task_run(dev, root, mids, conf, "c1 checkpoint, killed",
                       fault=f"segment.fetch=error:match:{mids[-1]}")
        require(res["error"] is not None and
                type(res["error"].cause).__name__ == "TransportError",
                f"[admission c1] ended in {res['error']!r}")
        runs["c1"] = _report(res, part_bytes, ("ckpt.snapshots",
                                               "ckpt.bytes"))
        task = os.path.join(ck, f"{MERGE_JOB}.r0")
        newest = max(f for f in os.listdir(task) if f.endswith(".uckp"))
        manifest = checkpoint.TaskCheckpoint._read_manifest(
            os.path.join(task, newest))
        saved = {rec["map"] for rec in manifest["runs"].values()}
        res = task_run(dev, root, mids, conf, "c2 checkpoint, resumed")
        _require_stream(res, want)
        snap = res["metrics"]
        adopted = int(snap.get("ckpt.runs.adopted", 0))
        fetched = res["engine"].fetches
        require(snap.get("ckpt.resumed", 0) == 1
                and adopted == len(saved) >= 1,
                f"[admission c2] resumed {snap.get('ckpt.resumed', 0)}, "
                f"adopted {adopted} of the manifest's {len(saved)} runs")
        require(not saved & set(fetched)
                and len(fetched) == len(mids) - adopted,
                f"[admission c2] fetched {sorted(fetched)}, adopted "
                f"{sorted(saved)}")
        require(all(res["launches"][k] == len(mids) - 1 for k in k1),
                f"[admission c2] K1 launched {res['launches']}, not once "
                f"per forest merge")
        require(not os.path.exists(task), "the checkpoint outlived the task")
        runs["c2"] = _report(res, part_bytes, ("ckpt.runs.adopted",
                                               "ckpt.snapshots",
                                               "fetch_time", "merge_time"))
        runs["c2"]["maps_fetched"] = len(fetched)
    # (d) every fourth fetch issue sleeps 3 s: the 0.5 s watchdog ends it
    res = task_run(dev, root, mids[:2],
                   {"mapred.rdma.buf.size": 1,
                    "uda.tpu.watchdog.stall.s": 0.5},
                   "d watchdog", fault="segment.fetch=delay:3000:every:4")
    require(res["error"] is not None
            and type(res["error"].cause).__name__ == "StallError"
            and res["wall_s"] < 3.0,
            f"[admission d] ended in {res['error']!r} after "
            f"{res['wall_s']:.3f} s")
    runs["d"] = _report(res, part_bytes, ("watchdog.stalls",))
    return runs


# --------------------------------------------------------------- phase 11
def write_striped_tree(roots: list, parts: list) -> list:
    """Map m's records written by ``write_striped_map_output`` with
    CODED_SCHEME, its primary on ``roots[m % len(roots)]`` (one reduce
    partition each); returns the ``(host, map id)`` entries."""
    scheme = parse_scheme(CODED_SCHEME)
    entries = []
    for m, rec in enumerate(parts):
        write_striped_map_output(roots, m % len(roots), MERGE_JOB, map_id(m),
                                 [record_pairs(rec)], scheme)
        entries.append((CODED_HOSTS[m % len(roots)], map_id(m)))
    return entries


class DeadClient(LocalFetchClient):
    """A supplier that answers every fetch with a transport fault,
    delivered late as a dead host's dial failure is."""

    def start_fetch(self, req, on_complete):
        t = threading.Timer(0.002, on_complete, args=(
            TransportError(f"supplier {req.host} down ({req.map_id})"),))
        t.daemon = True
        t.start()


class HeldClient(LocalFetchClient):
    """A straggling supplier: every completion is held ``hold_s``."""

    def __init__(self, engine, hold_s: float):
        super().__init__(engine)
        self.hold_s = hold_s

    def start_fetch(self, req, on_complete):
        def held(res):
            t = threading.Timer(self.hold_s, on_complete, args=(res,))
            t.daemon = True
            t.start()

        super().start_fetch(req, held)


def _coded_report(res: dict, part_bytes: int, keys: tuple, want: tuple,
                  extra: dict) -> dict:
    require(res["error"] is None,
            f"[coded {res['run']}] ended in {res['error']!r}")
    require((res["sha256"], res["stream_bytes"]) == want,
            f"[coded {res['run']}] the stream differs from its digest: "
            f"{res['stream_bytes']} B, sha256 {res['sha256']}")
    out = {k: res[k] for k in ("run", "wall_s", "launches", "peak_bytes",
                               "sha256", "stream_bytes")}
    out["mb_per_s"] = part_bytes / res["wall_s"] / 1e6
    out.update({k: res["metrics"].get(k, 0.0) for k in keys})
    for k in ("idle_share", "device_busy_ms"):
        if k in res:
            out[k] = res[k]
    out.update(extra)
    log(f"[coded {res['run']}] " + json.dumps(out))
    return out


def phase_coded(dev: torch.device, parts: list, want: tuple,
                run_c_wall: float) -> dict:
    """Phase 11 on run c's maps (``parts``, whose stream must equal
    ``want``, run c's (sha256, length)): (a) a dead supplier under rs:2:4;
    (b) speculation against a straggling replica, beside the same maps
    with speculation off; (c) a resumed fetch in every map."""
    k1 = ("merge_pass", "merge_partition")
    runs: dict = {}
    part_bytes = sum(p.nbytes + 2 for p in parts)
    # the maps whose primary is h0 (b, c): their own digest
    own = list(range(0, len(parts), len(CODED_HOSTS)))
    sub = [parts[i] for i in own]
    sub_bytes = sum(p.nbytes + 2 for p in sub)
    want_sub = resort_digest(sub, dev)
    with tempfile.TemporaryDirectory(prefix="uda_coded_") as tree:
        roots = [os.path.join(tree, h) for h in CODED_HOSTS]
        t0 = time.perf_counter()
        entries = write_striped_tree(roots, parts)
        log(f"[coded] {len(parts)} maps written by write_striped_map_output"
            f" ({CODED_SCHEME}, {len(roots)} roots) in "
            f"{time.perf_counter() - t0:.1f} s")

        # (a) one supplier dead from the start
        conf = {"uda.tpu.coding.scheme": CODED_SCHEME,
                "uda.tpu.fetch.retries": 1}
        engines = [DataEngine(DirIndexResolver(r), Config(conf))
                   for r in roots]
        clients = {h: (DeadClient if h == CODED_DEAD else LocalFetchClient)(e)
                   for h, e in zip(CODED_HOSTS, engines)}
        res = drive_task(dev, HostRoutingClient(clients.__getitem__),
                         engines, entries, conf, "a dead h2", profiled=True)
        lost = sum(1 for h, _ in entries if h == CODED_DEAD)
        snap = res["metrics"]
        require(snap.get("coding.reconstructed.partitions", 0) == lost
                and snap.get("coding.shard.fetches", 0) >= 2 * lost
                and snap.get("fallback.signals", 0) == 0,
                f"[coded a] reconstructed "
                f"{snap.get('coding.reconstructed.partitions', 0)} of "
                f"{lost}, {snap.get('coding.shard.fetches', 0)} shard "
                f"fetches, {snap.get('fallback.signals', 0)} fallbacks")
        require(all(res["launches"][k] == len(parts) - 1 for k in k1),
                f"[coded a] K1 launched {res['launches']}")
        runs["a"] = _coded_report(
            res, part_bytes, ("coding.reconstructed.partitions",
                              "coding.reconstructed.bytes",
                              "coding.shard.fetches", "fetch.retries",
                              "fallback.signals", "fetch_time",
                              "merge_time"), want,
            {"run_c_wall_s": run_c_wall})

        # (b) speculation against h0 holding every chunk, then the same
        # maps with speculation off (the slow run, capped at these maps)
        replicas = [([CODED_HOSTS[0], CODED_HOSTS[1]], entries[i][1])
                    for i in own]
        walls = {}
        for name, conf in (("b speculation", SPEC_CONF),
                           ("b speculation off", {})):
            engines = [DataEngine(DirIndexResolver(roots[0]), Config(conf))
                       for _ in range(2)]
            clients = {CODED_HOSTS[0]: HeldClient(engines[0], SPEC_HOLD_S),
                       CODED_HOSTS[1]: LocalFetchClient(engines[1])}
            res = drive_task(dev, HostRoutingClient(clients.__getitem__),
                             engines, replicas, conf, name)
            walls[name] = res["wall_s"]
            snap = res["metrics"]
            if conf:
                require(snap.get("fetch.speculated", 0) >= 1
                        and snap.get("fetch.speculation.won", 0) >= 1,
                        f"[coded b] speculated "
                        f"{snap.get('fetch.speculated', 0)}, won "
                        f"{snap.get('fetch.speculation.won', 0)}")
            runs[name] = _coded_report(
                res, sub_bytes, ("fetch.speculated", "fetch.speculation.won",
                                 "fetch.speculation.lost",
                                 "fetch.stale_completions", "fetch_time"),
                want_sub, {})
        runs["b speculation"]["off_wall_s"] = walls["b speculation off"]

        # (c) resume: one fetch in flight, so the every-N-th read of the
        # task falls mid-partition once in each map (N = a map's chunks)
        conf = {"uda.tpu.fetch.resume": True, "mapred.rdma.wqe.per.conn": 1}
        engine = CountingEngine(DirIndexResolver(roots[0]), Config(conf))
        rec = engine.resolver.resolve(MERGE_JOB, entries[own[0]][1], 0)
        chunk = int(Config(conf).get("mapred.rdma.buf.size")) * 1024
        chunks = -(-rec.part_length // chunk)
        # map i's fault falls on its (chunks - i + 1)-th read: mid-partition
        # for every map while the maps are fewer than a map's chunks
        require(chunks > len(own), f"[coded c] {chunks} chunks a map is "
                                   f"too few for {len(own)} maps")
        res = drive_task(dev, HostRoutingClient(
            {CODED_HOSTS[0]: LocalFetchClient(engine)}.__getitem__),
            [engine], [entries[i] for i in own], conf, "c resume",
            fault=f"data_engine.pread=error:transport:every:{chunks}")
        snap = res["metrics"]
        again = {m: n for (m, off), n in engine.reads.items()
                 if off == 0 and n != 1}
        require(snap.get("fetch.resumed", 0) == len(own)
                and snap.get("fetch.resumed.bytes", 0) > 0 and not again,
                f"[coded c] resumed {snap.get('fetch.resumed', 0)} times "
                f"({snap.get('fetch.resumed.bytes', 0)} B); offset 0 read "
                f"again in {again}")
        runs["c"] = _coded_report(
            res, sub_bytes, ("fetch.resumed", "fetch.resumed.bytes",
                             "fetch.retries", "failpoint.data_engine.pread"),
            want_sub, {"chunks_per_map": chunks,
                       "reads": sum(engine.reads.values())})
    return runs


# --------------------------------------------------------------- phase 12
class RecordingClient:
    """An InputClient in front of ``inner`` that counts its fetches per
    (map, offset) and can hold one: the first fetch at or past ``hold_at``
    bytes is held (``reached`` is set) until ``release`` is set, then
    fails with TransportError, as a fetch in flight when its supplier went
    down does. The held fetch never reaches a supplier and is not
    counted."""

    def __init__(self, inner, hold_at=None):
        self.inner = inner
        self.hold_at = hold_at
        self.reads: dict = {}
        self.held = None
        self.reached = threading.Event()
        self.release = threading.Event()
        self._lock = threading.Lock()

    def start_fetch(self, req, on_complete):
        with self._lock:
            key = (req.map_id, req.offset)
            hold = (self.hold_at is not None and self.held is None
                    and req.offset >= self.hold_at)
            if hold:
                self.held = key
            else:
                self.reads[key] = self.reads.get(key, 0) + 1
        if not hold:
            self.inner.start_fetch(req, on_complete)
            return

        def fail_later() -> None:
            self.release.wait(600)
            on_complete(TransportError(
                f"supplier went down mid-fetch ({req.map_id}@{req.offset})"))

        threading.Thread(target=fail_later, daemon=True).start()
        self.reached.set()

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Servers(list):
    """The servers one run started (a bounce adds one); stop() stops
    every one of them."""

    def stop(self) -> None:
        for server in self:
            server.stop()


class TimedCodec(Codec):
    """A codec whose decompress time is summed (``seconds``)."""

    def __init__(self, base: Codec):
        self.seconds = 0.0
        self._lock = threading.Lock()

        def decompress(data, n):
            t0 = time.perf_counter()
            out = base.decompress(data, n)
            with self._lock:
                self.seconds += time.perf_counter() - t0
            return out

        super().__init__(base.name, base.compress, decompress)


def comp_chunk_bytes(cfg: Config) -> int:
    """The compressed-domain fetch size a reduce task asks for: the
    ``mapred.rdma.compression.buffer.ratio`` share of each buffer
    (calculateMemPool's split, the reference's bridge wiring)."""
    buf = int(cfg.get("mapred.rdma.buf.size")) * 1024
    ratio = float(cfg.get("mapred.rdma.compression.buffer.ratio"))
    return max(BLOCK_HEADER.size + 1, int(buf * ratio))


def serve(root: str, conf: dict, port: int = 0) -> tuple:
    """A DataEngine over ``root`` behind a port ShuffleServer on
    127.0.0.1 (``port`` 0: any free port)."""
    engine = DataEngine(DirIndexResolver(root), Config(conf))
    server = ShuffleServer(engine, Config(conf), host="127.0.0.1",
                           port=port).start()
    return engine, server


def net_task(dev: torch.device, root: str, mids: list, conf: dict,
             name: str, codec=None, hold_at=None, bounce=None,
             profiled: bool = False) -> dict:
    """``drive_task`` over the wire: a port ShuffleServer serves ``root``
    and the reduce task fetches through ``HostRoutingClient``'s socket
    default (through ``DecompressingClient`` when ``codec`` is given).
    With ``hold_at`` one fetch is held and, once ``bounce(servers,
    router, host)`` has run on a thread of its own, failed."""
    cfg = Config(conf)
    engine, server = serve(root, conf)
    servers = Servers([server])
    host = f"127.0.0.1:{server.port}"
    router = HostRoutingClient(config=cfg)
    rec = RecordingClient(router, hold_at)
    top = (DecompressingClient(rec, codec, comp_chunk_size=comp_chunk_bytes(
        cfg)) if codec is not None else rec)
    bouncer = None
    if bounce is not None:
        def run_bounce() -> None:
            if rec.reached.wait(300):
                try:
                    bounce(servers, router, host)
                finally:
                    rec.release.set()

        bouncer = threading.Thread(target=run_bounce, daemon=True)
        bouncer.start()
    try:
        res = drive_task(dev, top, [top, servers, engine],
                         [(host, m) for m in mids], conf, name,
                         profiled=profiled)
    finally:
        rec.release.set()
        servers.stop()
    if bouncer is not None:
        bouncer.join(timeout=60)
    res.update(servers=servers, engine=engine, client=rec)
    return res


def _net_report(res: dict, part_bytes: int, want: tuple, pairs: int,
                keys: tuple, extra: dict) -> dict:
    """Require the run's stream to equal ``want`` with ``pairs`` K1
    launch pairs; print and return its record."""
    require(res["error"] is None,
            f"[net {res['run']}] ended in {res['error']!r}")
    require((res["sha256"], res["stream_bytes"]) == want,
            f"[net {res['run']}] the stream differs from its digest: "
            f"{res['stream_bytes']} B, sha256 {res['sha256']}")
    require(res["launches"]["merge_pass"] == pairs
            == res["launches"]["merge_partition"],
            f"[net {res['run']}] K1 launched {res['launches']}, not "
            f"{pairs} pairs")
    out = {k: res[k] for k in ("run", "wall_s", "launches", "peak_bytes",
                               "sha256", "stream_bytes")}
    out["mb_per_s"] = part_bytes / res["wall_s"] / 1e6
    out["zerocopy_mode"] = res["servers"][0].zc_mode
    out.update({k: res["metrics"].get(k, 0.0) for k in keys})
    for k in ("idle_share", "device_busy_ms"):
        if k in res:
            out[k] = res[k]
    out.update(extra)
    log(f"[net {res['run']}] " + json.dumps(out))
    return out


NET_KEYS = ("fetch_time", "merge_time", "net.serve.fd", "net.serve.copy",
            "net.sendfile.bytes", "net.mmap.bytes", "net.requests",
            "net.bytes.in", "io.batch.requests", "io.batch.reads")


def phase_net_tree(dev: torch.device, root: str, mids: list, parts: list,
                   want_c: tuple, wall_c: float,
                   c_maps: int = OVERLAP_C_MAPS) -> dict:
    """Phase 12a, 12b and 12e on phase 8's tree: (a) the default
    ``Config()`` over the wire on run c's maps (held to run c's stream,
    under ``torch.profiler``); (b) run c's maps with zero-copy off and CRC
    stamping on (every chunk through ``submit_batch``); (e) a supplier
    bounced mid-fetch, warm then cold."""
    runs: dict = {}
    sub_bytes = sum(p.nbytes + 2 for p in parts[:c_maps])
    res = net_task(dev, root, mids[:c_maps], dict(NET_CONF), "a default",
                   profiled=True)
    snap = res["metrics"]
    require(snap.get("net.serve.fd", 0) > 0,
            "[net a] no chunk went out zero-copy")
    runs["a"] = _net_report(res, sub_bytes, want_c, c_maps - 1,
                            NET_KEYS, {"run_c_wall_s": wall_c})

    conf = dict(NET_CONF, **{"uda.tpu.net.zerocopy": False,
                             "uda.tpu.fetch.crc": True})
    res = net_task(dev, root, mids[:c_maps], conf, "b bytes+crc")
    snap = res["metrics"]
    copies = snap.get("net.serve.copy", 0)
    require(copies > 0 and snap.get("net.serve.fd", 0) == 0
            and snap.get("io.batch.requests", 0) == copies,
            f"[net b] {snap.get('net.serve.fd', 0)} chunks zero-copy, "
            f"{copies} by bytes, {snap.get('io.batch.requests', 0)} "
            f"through submit_batch")
    runs["b"] = _net_report(res, sub_bytes, want_c, c_maps - 1, NET_KEYS,
                            {"io_backend": res["engine"].io_backend})

    sub = parts[:RESTART_MAPS]
    runs.update(phase_restart(dev, root, mids[:RESTART_MAPS],
                              sum(p.nbytes + 2 for p in sub),
                              resort_digest(sub, dev)))
    return runs


def phase_restart(dev: torch.device, root: str, mids: list,
                  part_bytes: int, want: tuple) -> dict:
    """Phase 12e: one fetch in flight and one held at half a map; the
    server is stopped and restarted on its port meanwhile. Warm (a
    handoff record): the segment resumes, no offset 0 is read twice.
    Cold (no record): resume_ok goes False and the partition restarts
    from 0."""
    runs: dict = {}
    half = MERGE_MAP_BYTES // 2
    for name, warm in (("e warm", True), ("e cold", False)):
        with tempfile.TemporaryDirectory(prefix="uda_handoff_") as hd:
            conf = dict(NET_CONF, **{
                "uda.tpu.fetch.resume": True,
                "mapred.rdma.wqe.per.conn": 1,
                "uda.tpu.fetch.retries": 8,
                "mapred.rdma.fetch.retry.backoff.ms": 20,
                "uda.tpu.net.handoff.path":
                    os.path.join(hd, "handoff.json") if warm else ""})
            seen: dict = {}

            def bounce(servers, router, host, conf=conf, seen=seen):
                old = servers[0]
                old.stop(drain=True)
                new = ShuffleServer(old.engine, Config(conf),
                                    host="127.0.0.1",
                                    port=int(host.rsplit(":", 1)[1])
                                    ).start()
                servers.append(new)
                for _ in range(3):  # the first probe may ride the dead
                    # connection; the next dials the new server
                    if router.estimate_partition_bytes(
                            MERGE_JOB, [(host, mids[0])], 0) is not None:
                        break
                seen.update(old_gen=old.generation, new_gen=new.generation,
                            warm=new.warm_restart,
                            seen_gen=router.generation(host),
                            resume_ok=router.resume_ok(host))

            res = net_task(dev, root, mids, conf, name, hold_at=half,
                           bounce=bounce)
        snap = res["metrics"]
        reads = res["client"].reads
        held = res["client"].held
        zero_again = {m: n for (m, off), n in reads.items()
                      if off == 0 and n != 1}
        require(held is not None and seen.get("seen_gen")
                == seen.get("new_gen") and seen.get("warm") == warm
                and seen.get("resume_ok") == warm,
                f"[net {name}] bounce {seen}, held {held}")
        if warm:
            require(seen["new_gen"] == (seen["old_gen"] + 1) & 0x7FFFFFFF
                    and snap.get("fetch.resumed", 0) >= 1
                    and snap.get("fetch.resumed.bytes", 0) >= half
                    and not zero_again
                    and snap.get("net.handoff.loaded", 0) == 1,
                    f"[net {name}] resumed {snap.get('fetch.resumed', 0)} "
                    f"({snap.get('fetch.resumed.bytes', 0)} B), offset 0 "
                    f"read again in {zero_again}")
        else:
            require(snap.get("fetch.resumed", 0) == 0
                    and zero_again == {held[0]: 2},
                    f"[net {name}] resumed {snap.get('fetch.resumed', 0)}"
                    f"; offset 0 read again in {zero_again}, held {held}")
        runs[name] = _net_report(
            res, part_bytes, want, len(mids) - 1,
            ("fetch.resumed", "fetch.resumed.bytes", "fetch.retries",
             "net.handoff.persisted", "net.handoff.loaded",
             "net.generation.changes", "net.disconnects"),
            {"held": list(held), "generations": [seen["old_gen"],
                                                 seen["new_gen"]],
             "warm": seen["warm"], "resume_ok": seen["resume_ok"],
             "offset0_reads": {m: n for (m, off), n in reads.items()
                               if off == 0},
             "reads": sum(reads.values())})
    return runs


def write_codec_tree(root: str, parts: list, codec) -> tuple:
    """``parts`` written again by ``MOFWriter(codec=)``; returns the map
    ids and the partition's (compressed, raw) bytes."""
    writer = MOFWriter(root, MERGE_JOB, codec=codec)
    for m, rec in enumerate(parts):
        writer.write(map_id(m), [record_pairs(rec)])
    resolver = DirIndexResolver(root)
    recs = [resolver.resolve(MERGE_JOB, mid, 0) for mid in writer.map_ids]
    return (writer.map_ids, sum(r.part_length for r in recs),
            sum(r.raw_length for r in recs))


def phase_net_codecs(dev: torch.device, parts: list, want_c: tuple) -> dict:
    """Phase 12c and 12d: run c's maps written again with zlib
    (``DefaultCodec``), and 4 maps x 1 MiB with LZO through the port's
    ladder, each fetched over the wire through ``DecompressingClient``."""
    runs: dict = {}
    lzo_parts = tera_partitions(SEED + 7, LZO_MAPS, LZO_MAP_BYTES)
    for name, sub, codec_name, want in (
            ("c zlib", parts, "org.apache.hadoop.io.compress.DefaultCodec",
             want_c),
            ("d lzo", lzo_parts, "com.hadoop.compression.lzo.LzoCodec",
             resort_digest(lzo_parts, dev))):
        codec = TimedCodec(get_codec(codec_name))
        with tempfile.TemporaryDirectory(prefix="uda_codec_") as root:
            t0 = time.perf_counter()
            mids, comp, raw = write_codec_tree(root, sub, codec)
            write_s = time.perf_counter() - t0
            res = net_task(dev, root, mids, dict(NET_CONF), name,
                           codec=codec)
        snap = res["metrics"]
        require(snap.get("decompress.bytes", 0) == raw,
                f"[net {name}] decompressed "
                f"{snap.get('decompress.bytes', 0)} of {raw} B")
        runs[name] = _net_report(
            res, sum(p.nbytes + 2 for p in sub), want, len(sub) - 1,
            NET_KEYS + ("decompress.bytes",),
            {"codec": codec.name, "compressed_bytes": comp,
             "raw_bytes": raw, "ratio": comp / raw,
             "decompress_s": codec.seconds, "write_s": write_s,
             "lzo_rung": native_lzo_source() or "python"})
    return runs



# --------------------------------------------------------------- phase 13
PUSH_KEYS = ("push.commits", "push.subs", "push.chunks", "push.bytes",
             "push.accepted", "push.accepted.bytes", "push.spilled.bytes",
             "push.acks", "push.adopted", "push.adopted.bytes",
             "push.invalidated", "push.errors", "fetch.resumed",
             "net.serve.fd", "net.serve.copy", "fetch_time", "merge_time")
STORE_KEYS = ("store.read.bytes", "store.failover", "store.errors",
              "net.serve.fd", "net.serve.copy", "net.sendfile.bytes",
              "net.requests", "fetch_time", "merge_time")


def _series(snap: dict, name: str, label: str) -> dict:
    """One labelled counter's series in a metrics snapshot: value ->
    count (``push.nacks{reason=budget}`` -> ``{"budget": n}``)."""
    pre = f"{name}{{{label}="
    return {k[len(pre):-1]: v for k, v in snap.items()
            if k.startswith(pre)}


def phase_push(dev: torch.device, root: str, mids: list, part_bytes: int,
               want: tuple, wall_9a: float) -> dict:
    """Phase 13a: a port ShuffleServer with ``uda.tpu.push.enable`` serves
    phase 8's tree; the reduce task (the default ``Config()`` plus push,
    over ``HostRoutingClient``'s socket default) arms push first, then a
    thread plays the map phase, ``notify_commit`` for one map every
    ``PUSH_COMMIT_S``, and ``run()`` starts after the last commit.
    ``metrics`` and the launch counts are reset before the arm; the wall
    is ``run()``'s. The stream must equal 9a's with a K1 launch pair per
    forest merge and at least one pushed prefix adopted."""
    conf = dict(NET_CONF, **{"uda.tpu.push.enable": True})
    engine, server = serve(root, conf)
    servers = Servers([server])
    host = f"127.0.0.1:{server.port}"
    router = HostRoutingClient(config=Config(conf))
    seen: dict = {}

    def map_phase(mm) -> None:
        staging = mm.arm_push(MERGE_JOB, 0, hosts={host})
        require(staging is not None, "[push] arm_push left the task pull "
                "only")
        seen.update(eager_cap=staging.eager_cap,
                    staged_cap=staging.staged_cap, spill=staging.spill_ok)
        t0 = time.perf_counter()

        def commit_all() -> None:
            for i, mid in enumerate(mids):
                wait = t0 + i * PUSH_COMMIT_S - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                server.notify_commit(MERGE_JOB, mid)

        committer = threading.Thread(target=commit_all,
                                     name="uda-map-phase")
        committer.start()
        committer.join()
        seen.update(map_phase_s=time.perf_counter() - t0,
                    staged_at_run=staging.staged_bytes())

    res = drive_task(dev, router, [router, servers, engine],
                     [(host, m) for m in mids], conf, "13a push",
                     profiled=True, before_run=map_phase)
    res.update(servers=servers, engine=engine)
    snap = res["metrics"]
    refused = _series(snap, "push.refused", "reason")
    require(snap.get("push.adopted", 0) >= 1,
            f"[push] no pushed prefix adopted: {snap.get('push.chunks', 0)}"
            f" chunks pushed, refused {refused}")
    return _net_report(res, part_bytes, want, len(mids) - 1, PUSH_KEYS, {
        "phase_9a_wall_s": wall_9a, "caps": {
            k: seen[k] for k in ("eager_cap", "staged_cap", "spill")},
        "map_phase_s": seen["map_phase_s"],
        "staged_at_run_bytes": seen["staged_at_run"],
        "nacks": _series(snap, "push.nacks", "reason"),
        "refused": refused})


def _store_task(dev: torch.device, resolver, mgr, mids: list, name: str,
                before_run=None) -> dict:
    """``drive_task`` over the wire against a port ShuffleServer whose
    engine has ``mgr`` attached (under ``torch.profiler``)."""
    conf = dict(NET_CONF)
    engine = DataEngine(resolver, Config(conf))
    engine.attach_store(mgr)
    server = ShuffleServer(engine, Config(conf), host="127.0.0.1",
                           port=0).start()
    servers = Servers([server])
    host = f"127.0.0.1:{server.port}"
    router = HostRoutingClient(config=Config(conf))
    extra: dict = {}
    if before_run is not None:
        extra = before_run(server) or {}
    res = drive_task(dev, router, [router, servers, engine],
                     [(host, m) for m in mids], conf, name, profiled=True)
    res.update(servers=servers, engine=engine, extra=extra)
    return res


def phase_store(dev: torch.device, parts: list, want: tuple,
                wall_c: float, drain_maps: int = RESTART_MAPS) -> dict:
    """Phase 13b: run c's maps written again through
    ``MOFWriter(store=StoreManager)`` into a fresh served root, the
    watermark a tenth of the partition's on-disk bytes (the reference's
    "10x over budget" shape), so the spill ladder migrates whole maps to
    the blob tier, oldest first, as later maps commit; then the default
    task over the wire, the engine routing spilled maps through the store
    (the copy path) and the rest by zero-copy. The drain: ``drain_maps``
    maps retained locally, ``announce_drain(store=)`` migrates them all,
    and a task started after it reads every one from the blob tier."""
    runs: dict = {}
    part_bytes = sum(p.nbytes + 2 for p in parts)
    with tempfile.TemporaryDirectory(prefix="uda_store_") as top:
        local = os.path.join(top, "local")
        resolver = DirIndexResolver(local)
        mgr = StoreManager(resolver, os.path.join(top, "blob"),
                           watermark_bytes=part_bytes // STORE_WATERMARK_DIV)
        writer = MOFWriter(local, MERGE_JOB, store=mgr)
        t0 = time.perf_counter()
        peak = 0
        for m, rec in enumerate(parts):
            writer.write(map_id(m), [record_pairs(rec)])
            peak = max(peak, mgr.retained_bytes())
        write_s = time.perf_counter() - t0
        moved = mgr.migrations()
        spilled = sum(e["bytes"] for e in moved if e["reason"] == "spill")
        require(peak <= mgr.watermark_bytes and spilled > 0,
                f"[store] retained {peak} B at peak against a watermark of "
                f"{mgr.watermark_bytes} B, {spilled} B spilled")
        res = _store_task(dev, resolver, mgr, writer.map_ids, "13b store")
        snap = res["metrics"]
        require(snap.get("net.serve.copy", 0) > 0
                and snap.get("store.read.bytes", 0) > 0,
                f"[store] {snap.get('net.serve.copy', 0)} chunks by copy, "
                f"{snap.get('store.read.bytes', 0)} B through the store")
        runs["b"] = _net_report(res, part_bytes, want, len(parts) - 1,
                                STORE_KEYS, {
            "run_c_wall_s": wall_c, "write_s": write_s,
            "watermark_bytes": mgr.watermark_bytes,
            "peak_retained_bytes": peak,
            "store.migrations": len(moved),
            "store.spilled.bytes": spilled,
            "retained_bytes": mgr.retained_bytes()})
        mgr.close()

        sub = parts[:drain_maps]
        local = os.path.join(top, "drain")
        resolver = DirIndexResolver(local)
        mgr = StoreManager(resolver, os.path.join(top, "drain_blob"))
        writer = MOFWriter(local, MERGE_JOB, store=mgr)
        for m, rec in enumerate(sub):
            writer.write(map_id(m), [record_pairs(rec)])
        require(not mgr.migrations(), "[store drain] a map spilled")

        def drain(server) -> dict:
            t0 = time.perf_counter()
            moved = server.announce_drain(store=mgr, job_id=MERGE_JOB)
            require(len(moved) == drain_maps and mgr.retained_bytes() == 0
                    and not any(os.path.exists(e["src"]) for e in moved),
                    f"[store drain] {len(moved)} maps moved, "
                    f"{mgr.retained_bytes()} B retained")
            return {"drain_s": time.perf_counter() - t0,
                    "moved": len(moved),
                    "moved_bytes": sum(e["bytes"] for e in moved)}

        res = _store_task(dev, resolver, mgr, writer.map_ids, "13b drain",
                          before_run=drain)
        snap = res["metrics"]
        require(snap.get("net.serve.fd", 0) == 0
                and snap.get("store.read.bytes", 0) > 0,
                f"[store drain] {snap.get('net.serve.fd', 0)} chunks "
                f"zero-copy after the drain")
        runs["b drain"] = _net_report(
            res, sum(p.nbytes + 2 for p in sub), resort_digest(sub, dev),
            drain_maps - 1, STORE_KEYS, res["extra"])
        mgr.close()
    return runs


def phase_tenants(dev: torch.device, root: str, mids: list,
                  parts: list) -> dict:
    """Phase 13c: run c's maps as two jobs of half the maps each (their
    map directories linked under a job of their own), served by one port
    ShuffleServer with ``uda.tpu.tenant.enable`` and
    ``uda.tpu.tenant.wqe.total`` = ``TENANT_WQE``; two reduce tasks run at
    once on two threads, each bound by MSG_JOB from its own ``Config``
    (``TENANTS``: tenant, weight). ``metrics`` and the launch counts are
    reset before both start and read after both end, under
    ``torch.profiler``. Each stream must equal the re-sort of its maps;
    then ``retire_job`` on t1's job, after which a fetch of it draws the
    typed TenantError."""
    from torch.profiler import ProfilerActivity, profile

    half = len(mids) // 2
    jobs = {}
    for (tenant_id, weight), lo, hi in zip(TENANTS, (0, half),
                                           (half, len(mids))):
        job = f"{MERGE_JOB}_{tenant_id}"
        os.makedirs(os.path.join(root, job))
        for mid in mids[lo:hi]:
            os.symlink(os.path.join(root, MERGE_JOB, mid),
                       os.path.join(root, job, mid))
        jobs[tenant_id] = (job, weight, mids[lo:hi],
                           resort_digest(parts[lo:hi], dev),
                           sum(p.nbytes + 2 for p in parts[lo:hi]))
    conf = dict(NET_CONF, **{"uda.tpu.tenant.enable": True,
                             "uda.tpu.tenant.wqe.total": TENANT_WQE})
    engine, server = serve(root, conf)
    host = f"127.0.0.1:{server.port}"
    results: dict = {}

    def task(tenant_id: str) -> None:
        job, weight, jmids, _, _ = jobs[tenant_id]
        cfg = Config(dict(NET_CONF, **{"uda.tpu.tenant.id": tenant_id,
                                       "uda.tpu.tenant.weight": weight}))
        router = HostRoutingClient(config=cfg)
        digest = hashlib.sha256()
        length = [0]

        def consumer(block: memoryview) -> None:
            digest.update(block)
            length[0] += len(block)

        t0 = time.perf_counter()
        error = None
        try:
            MergeManager(router, MERGE_KEY_CLASS, cfg, device=dev).run(
                job, [(host, m) for m in jmids], 0, consumer)
        except FallbackSignal as e:
            error = e
        finally:
            router.stop()
        results[tenant_id] = {"wall_s": time.perf_counter() - t0,
                              "sha256": digest.hexdigest(),
                              "stream_bytes": length[0], "error": error}

    try:
        torch.cuda.synchronize()
        metrics.reset()
        _build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=task, args=(t,),
                                        name=f"uda-tenant-{t}")
                       for t, _ in TENANTS]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: _build.launches[k] for k in KERNELS}
        snap = metrics.snapshot()
        granted = dict(server._sched.granted_cost)
        for tenant_id, (job, _, _, want, _) in jobs.items():
            r = results.get(tenant_id, {})
            require(r.get("error") is None and (
                r.get("sha256"), r.get("stream_bytes")) == want,
                f"[tenants {tenant_id}] {r.get('error')!r}, stream "
                f"{r.get('stream_bytes')} B against {want}")
        pairs = len(mids) - len(TENANTS)
        require(counts["merge_pass"] == pairs
                == counts["merge_partition"],
                f"[tenants] K1 launched {counts}, not {pairs} pairs")
        job1 = jobs[TENANTS[0][0]][0]
        client = RemoteFetchClient("127.0.0.1", server.port, Config({
            "uda.tpu.tenant.id": TENANTS[0][0],
            "uda.tpu.tenant.weight": TENANTS[0][1]}))
        try:
            client.bind_job(job1)
            client.retire_job(job1)
            box, done = [], threading.Event()
            client.start_fetch(ShuffleRequest(job1, mids[0], 0, 0, 1 << 20),
                               lambda r: (box.append(r), done.set()))
            require(done.wait(30) and isinstance(box[0], TenantError),
                    f"[tenants] a fetch of the retired job gave "
                    f"{box[:1]!r}")
        finally:
            client.stop()
    finally:
        server.stop()
        engine.stop()
    by_name, busy = device_time(prof)
    w = dict(TENANTS)
    out = {"run": "13c tenants", "wall_s": wall, "launches": counts,
           "tasks": {t: {"wall_s": r["wall_s"], "sha256": r["sha256"],
                         "stream_bytes": r["stream_bytes"],
                         "mb_per_s": jobs[t][4] / r["wall_s"] / 1e6}
                     for t, r in results.items()},
           "granted_cost": granted, "wqe_total": TENANT_WQE,
           # granted bytes a unit of weight, t3's over t1's (1.0: the
           # weighted fair share; recorded, not required)
           "fairness": ((granted.get("t3", 0) / w["t3"])
                        / max(1e-9, granted.get("t1", 0) / w["t1"])),
           "tenant.admission.rejections": snap.get(
               "tenant.admission.rejections", 0.0),
           "tenant.sched.parked": snap.get("tenant.sched.parked", 0.0),
           "retired_fetch": type(box[0]).__name__,
           "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3) if by_name else None}
    log("[net 13c tenants] " + json.dumps(out))
    return out


def wire_ab(dev: torch.device, maps: int = MERGE_MAPS,
            map_bytes: int = MERGE_MAP_BYTES, pairs: int = 3) -> dict:
    """Not part of ``main``: the default reduce task on one tree in
    process (``LocalFetchClient``, 9a's transport) and over the wire
    (12a's), both through ``drive_task``, in turns (local first in even
    pairs, the wire first in odd ones); every stream must be the same.
    Returns and prints the walls and fetch times of each side."""
    parts = tera_partitions(SEED + 3, maps, map_bytes)
    runs: dict = {"local": [], "wire": []}
    want = None
    with tempfile.TemporaryDirectory(prefix="uda_ab_") as root:
        mids = write_mof_tree(root, parts)
        for i in range(pairs):
            for side in (("local", "wire") if i % 2 == 0
                         else ("wire", "local")):
                if side == "local":
                    engine = DataEngine(DirIndexResolver(root), Config())
                    res = drive_task(dev, LocalFetchClient(engine),
                                     [engine], mids, {}, "ab local")
                else:
                    res = net_task(dev, root, mids, dict(NET_CONF),
                                   "ab wire")
                stream = (res["sha256"], res["stream_bytes"])
                want = want or stream
                require(res["error"] is None and stream == want,
                        f"[wire ab] {side} pair {i}: {res['error']!r}, "
                        f"{stream} against {want}")
                runs[side].append({
                    "pair": i, "wall_s": res["wall_s"],
                    "fetch_time": res["metrics"].get("fetch_time", 0.0)})
    log("[wire ab] " + json.dumps(runs))
    return runs


def phase_planes_alone(dev: torch.device, maps: int = MERGE_MAPS,
                       map_bytes: int = MERGE_MAP_BYTES,
                       c_maps: int = OVERLAP_C_MAPS) -> dict:
    """Phase 13 on its own: phase 8's tree written again, each digest the
    card's re-sort (9a's wall not measured: 0)."""
    parts = tera_partitions(SEED + 3, maps, map_bytes)
    want_c = resort_digest(parts[:c_maps], dev)
    with tempfile.TemporaryDirectory(prefix="uda_merge_") as root:
        mids = write_mof_tree(root, parts)
        with phase_seconds("13a push"):
            planes = {"push": phase_push(
                dev, root, mids, sum(p.nbytes + 2 for p in parts),
                resort_digest(parts, dev), 0.0)}
        with phase_seconds("13c tenants"):
            planes["tenants"] = phase_tenants(dev, root, mids[:c_maps],
                                              parts[:c_maps])
    with phase_seconds("13b store"):
        planes["store"] = phase_store(dev, parts[:c_maps], want_c, 0.0)
    return planes


def phase_admission_alone(dev: torch.device, maps: int = OVERLAP_C_MAPS,
                          map_bytes: int = MERGE_MAP_BYTES) -> dict:
    """Phase 10 on its own: the first ``maps`` maps of phase 8's tree,
    held to the card's whole-partition re-sort of them (run c's stream)."""
    parts = tera_partitions(SEED + 3, MERGE_MAPS, map_bytes)[:maps]
    with tempfile.TemporaryDirectory(prefix="uda_merge_") as root:
        mids = write_mof_tree(root, parts)
        return phase_admission(dev, root, mids,
                               sum(p.nbytes + 2 for p in parts),
                               resort_digest(parts, dev),
                               resort_digest(parts[:B_MAPS], dev))


def phase_reduce(dev: torch.device, maps: int = MERGE_MAPS,
                 map_bytes: int = MERGE_MAP_BYTES, reps: int = TIMED_REPS,
                 c_maps: int = OVERLAP_C_MAPS) -> tuple:
    """Phases 8, 9, 10, 12a, 12b, 12e, 13a and 13c on one MOF tree (the
    tree is written once), then phase 11 on run c's maps striped over four
    roots, 12c, 12d on compressed trees and 13b on run c's maps written
    again through the store."""
    t0 = time.perf_counter()
    parts = tera_partitions(SEED + 3, maps, map_bytes)
    with tempfile.TemporaryDirectory(prefix="uda_merge_") as root:
        mids = write_mof_tree(root, parts)
        setup_s = time.perf_counter() - t0
        log(f"[merge] {maps} maps x {map_bytes} B of TeraSort records "
            f"({sum(p.nbytes + 2 for p in parts)} B, "
            f"{sum(p.shape[0] for p in parts)} records) written by "
            f"MOFWriter in {setup_s:.1f} s")
        merged = phase_merge(dev, root, mids, parts, map_bytes, setup_s,
                             reps)
        overlap = phase_overlap(dev, root, mids, parts, merged, c_maps)
        want_c = (overlap["c"]["sha256"], overlap["c"]["stream_bytes"])
        admission = phase_admission(
            dev, root, mids[:c_maps],
            sum(p.nbytes + 2 for p in parts[:c_maps]), want_c,
            (overlap["b"]["sha256"], overlap["b"]["stream_bytes"]))
        log(f"[phase 10] {time.perf_counter() - t0:.1f} s since phase 8 "
            f"began")
        with phase_seconds("12a 12b 12e wire"):
            net = phase_net_tree(dev, root, mids, parts, want_c,
                                 overlap["c"]["wall_s"], c_maps)
        with phase_seconds("13a push"):
            planes = {"push": phase_push(
                dev, root, mids, sum(p.nbytes + 2 for p in parts),
                (merged["sha256"], merged["stream_bytes"]),
                overlap["a"]["wall_s"])}
        with phase_seconds("13c tenants"):
            planes["tenants"] = phase_tenants(dev, root, mids[:c_maps],
                                              parts[:c_maps])
    with phase_seconds("11 coded"):
        coded = phase_coded(dev, parts[:c_maps], want_c,
                            overlap["c"]["wall_s"])
    with phase_seconds("12c 12d codecs"):
        net.update(phase_net_codecs(dev, parts[:c_maps], want_c))
    with phase_seconds("13b store"):
        planes["store"] = phase_store(dev, parts[:c_maps], want_c,
                                      overlap["c"]["wall_s"])
    return merged, overlap, admission, coded, net, planes


@contextlib.contextmanager
def phase_seconds(name: str):
    """Prints the seconds a phase took, on a line of its own."""
    t0 = time.perf_counter()
    yield
    log(f"[seconds] phase {name}: {time.perf_counter() - t0:.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with phase_seconds("1 device"):
        info = phase_device()
    with phase_seconds("2 build"):
        phase_build()
    with phase_seconds("3 kernels"):
        phase_kernels(dev)
    with phase_seconds("4 main path"):
        words, runs = phase_main(dev)
    with phase_seconds("4b tune cache"):
        phase_tune_cache(words, runs)
    with phase_seconds("5 engines and steering"):
        phase_engines(dev)
        phase_steering(dev)
    with phase_seconds("6 times"):
        timed = phase_times(words)
    with phase_seconds("7 profile"):
        for path in ("auto", "keys8f"):
            phase_profile(words, path)
    del words
    torch.cuda.empty_cache()
    with phase_seconds("8-12 reduce"):
        merged, overlap, admission, coded, net, planes = phase_reduce(dev)
    kernels = []
    for name, meta in KERNELS.items():
        t = timed["kernels"][name]
        # the count from the run of the path the kernel belongs to; a kernel
        # on no path (K5) reads its count from the main path's run
        run = next((r for r in runs if name in r["own"]), runs[0])
        kernels.append({
            "name": f"{meta['id']} {name}", "route": meta["route"],
            "source": meta["source"], "replaces": meta["replaces"],
            "launches": run["launches"][name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        if name == "take_lanes":
            kernels[-1].update({k: t[k] for k in (
                "design", "call_ms", "direct_ms", "records_ms",
                "scratch_bytes", "peak_bytes", "copy_ms", "merge")
                if k in t})
        if name in ("merge_pass", "merge_partition"):
            kernels[-1]["merge_path_launches"] = merged["launches"][name]
            kernels[-1]["overlap_path_launches"] = \
                overlap["a"]["launches"][name]
            kernels[-1]["hybrid_path_launches"] = \
                admission["a"]["launches"][name]
            kernels[-1]["resume_path_launches"] = \
                admission["c2"]["launches"][name]
            kernels[-1]["coded_path_launches"] = {
                k: coded[k]["launches"][name]
                for k in ("a", "b speculation", "c")}
            kernels[-1]["net_path_launches"] = {
                k: v["launches"][name] for k, v in net.items()}
            kernels[-1]["push_path_launches"] = \
                planes["push"]["launches"][name]
            kernels[-1]["store_path_launches"] = {
                k: v["launches"][name] for k, v in planes["store"].items()}
            kernels[-1]["tenant_path_launches"] = \
                planes["tenants"]["launches"][name]
    log(f"[main] peak memory: " + ", ".join(
        f"{r['path']} {r['peak_bytes']} B" for r in runs))
    log(f"[seconds] whole run: {time.perf_counter() - t0:.1f}")
    log(info["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
