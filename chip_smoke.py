#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``uda_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
``sm_90a``)::

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``uda_tpu_torch/csrc`` compiled with ``nvcc``
   and, at the same time, the native host runtime with ``g++`` (18a);
3. kernels: K2/K1 (with the partition kernel) through ``sort_lanes`` at 8
   and 32 rows (``two_phase`` off and on) and K3/K4 (with the partition
   kernel at K4's width) through ``sort_lanes_folded4``, at 2^20 records
   with tiles 1024 and 4096, on keys with duplicates, words >= 2^31 and
   all-0xFFFFFFFF keys; K2/K1 at the edges of their design (tile 128,
   n == tile, 1, 7 and 30 key words at 4, 8 and 32 rows, all-equal,
   all-0xFFFFFFFF and high keys, tiles wider than one K2 block takes);
   K3/K4 at theirs (tile 256, n == tile, 1, 2 and 3 key words, the same
   kinds of keys, tiles 8192 and 16384, past one K3 block; K4's passes
   as ``merge_plan`` gives them: the fewest passes, eight-way, one of
   them four-way where they leave room for it, first) and K4 on runs that
   hold equal records (two-way pairs, four-way groups, also held to two
   two-way passes, and eight-way groups, whole, of four runs and of one
   short run, held to three, the eight-way partition to its plain
   version); the partition kernels on two sorted runs of 2^20 records
   (their deepest searches) at K1's width and K4's, and the four-way and
   eight-way ones on four and eight such runs, with first
   key words all equal, every key word equal and mixed keys; K5
   (``take_lanes``) at the probe's three
   shapes and at 3, 26 and 33 rows, each of its two designs launched on
   its own too; K6, the row gather (``take_rows``), at 26 words a row
   (8-byte words), 27 (4-byte words), 26 on a view only 4-byte aligned
   and rows wider than a block, by a permutation, by indices with
   repeats and by the tie-break row of a longer [4, m] tensor; K3
   reading the key words of row-major records in place
   (``tile_sort_folded_rows``, the sort cell's K3) at [2^20, 26],
   [10^6+37, 26] and [10^6+37, 27] with real all-0xFFFFFFFF keys, [5000,
   3] with all-equal keys and past one K3 block, also held to K3 on the
   padded [4, m] matrix of those keys, and the slim cascade on the records
   (``sort_records_folded4``) to the stable sort, and on whole blocks
   (``records_cascade_columns``, each pass's last group or pair short or
   alone) kernel by kernel, held to the two-way cascade's bytes, its first
   n columns to the power-of-two cascade's; every
   launch held byte for byte against its plain
   PyTorch version on the same input, and each cascade against PyTorch's
   stable sort;
4. main path: ``single_chip_sort`` of 100,000,000 TeraSort records
   (BASELINE.md config 2, 10.4 GB of ``uint32[n, 26]``; keys8f sorts
   them in 100,003,840 columns, whole blocks of 4096, keys8 in 2^27)
   with ``path="auto"``, which resolves to ``keys8f`` (K3, K4
   and the partition kernel: the 3 key words fit its 4 rows; one K3
   launch a call, reading the key words from the records in place), then
   the
   same records through ``keys8`` (K2, K1 and the partition kernel), each
   moving its records by one launch of K6; each
   checked for order, multiset
   checksum and byte identity with the stable-sort yardstick, with the
   launches of every kernel counted; 4b: a temporary tune cache
   (``UDA_TPU_TUNE_CACHE``, written by the port's ``TuneCache``) names
   ``keys8f`` for the 10^8-row bucket (``gpu|rows27|lanes1``): "auto"
   routes to it, one "auto" call equals the yardstick with K3 and K4
   launched and K2 not, timed beside phase 4's calls; the cache is
   cleared after, and "auto" is the built-in keys8f again;
5. engines: all eight engines on 2^22 records give the same bytes, and
   ``bench_step`` runs 2 rounds of ``keys8``; the small-batch steering:
   at 2^16 rows a cold cache's "auto" resolves to ``carrychunk``, timed
   against ``keys8`` and ``keys8f`` at 2^16 and 2^19 rows (equal bytes);
6. times, with CUDA events at the main path's shapes (K2 and K1 on keys8's
   [8, 2^27] matrix; K3, K4 and their partition on the slim [4, m]
   matrix at the keys8f engine's 100,003,840 columns, each pass's last
   group or pair short or alone; K4's passes as ``merge_plan`` gives
   them, a four-way and five eight-way there): each kernel (K1, K4
   and the partition kernels at each one's width per pass and summed over
   the cascade, the eight-way pass and its partition also alone; the
   partition also in device time, queued behind a sleep,
   beside the floor its dependent round trips set: the deepest search's
   steps times one step's round trip to device memory, plus one launch,
   both measured after an L2 flush on the first pair of the deepest pass
   whose first pair is whole; K5 on the keys8 matrix by the main path's permutation and
   by a merge permutation, its own device time in turns with torch
   indexing and its other design, the whole wrapper call, its scratch
   and peak memory; K6 on the 10^8 records by the main path's permutation,
   its own device time in turns with torch indexing, the wrapper call and
   the peak memory of one call beside indexing's, against its bound and
   the sector-granular bound its random rows allow; K3 on the 10^8
   records in place, held to its plain version, its device time in turns
   with K3 on the materialised [4, m] matrix, beside the matrix's build
   and its sector-granular bound; the records cascade on whole blocks
   beside the one on 2^27 columns, in turns, with K3, each K4 pass and the
   partition, each against its bound on the columns it moves, the
   cascade under merge_plan's 6 passes in turns with two other plans of 6
   passes, the four-way rule's 9 and two-way passes alone (17) at
   100,003,840 columns, their bytes equal, and one keys8f call's
   ``sort.cascade_*`` counters and K4 passes), its plain
   version,
   PyTorch's call computing the same function, its bound, the cascades and the whole-sort yardstick; A/Bs,
   in turns, of K3/K4 against K2/K1's run-time-row form on the same 4-row
   input and of K4's block width (2048 against 4096 records); and K5's
   two designs from 16 KB to 1 GB of ``x`` (the small-shape rule);
7. profile: device time by kernel and the device's idle share over one
   ``keys8f`` ("auto") and one ``keys8`` call (``torch.profiler``);
8. merge: the tree of 64 map outputs of 16 MiB of sorted TeraSort
   records (Text keys of 10 bytes, Text values of 90) written by
   ``MOFWriter``, then one TeraSort reduce task through
   ``MergeManager.run`` (``uda.tpu.merge.overlap=false``) over its first
   16 maps (run c's), fetched through ``LocalFetchClient``/``DataEngine``,
   merged by K1's two-phase merge tree and emitted as IFile blocks, with
   the launch counts reset just before and read just after, under
   ``torch.profiler``; the stream is cracked, checked for key order and
   multiset checksum and held byte for byte against the whole-partition
   re-sort (``merge_batches``) on the card; then K1 at each size class
   of the 64 maps' merge tree (the forest 9a launches, on runs cut to
   their records as ``merge_row_pair`` cuts them, run_len the larger run
   rounded up to the 512-record tile) against its plain version at
   tolerance 0, timed beside its bound;
9. overlap: the default reduce path on the 64-map tree, each run
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
   as it is emitted and must equal the card's whole-partition re-sort of
   its maps (a: the 64; b, c: their 8 and 16, c also phase 8's stream;
   d, e: of their tree, framed) in
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
   run c's 16 maps; the reduce task (the default ``Config()`` plus
   push, over the socket default) calls ``arm_push`` first, a thread
   plays the map phase (``notify_commit`` for one map every 100 ms) and
   ``run()`` starts after the last commit: the stream equals run c's, K1
   15 pairs, at least one pushed prefix adopted (chunks, bytes,
   adoptions, NACKs by reason, errors, the staging caps and ``run()``'s
   wall beside 12a's, the pull of the same maps, printed); (b) the
   elastic store: run c's 16 maps written again
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
   fairness figure and admission rejections printed);
14. the job layer and the Hadoop entry (``uda_tpu_torch.models``,
   ``uda_tpu_torch.bridge``), each run with ``metrics`` and the launch
   counts reset just before and read just after: (a) WordCount
   (BASELINE config 1) on 4 MiB of seeded text (Zipf a = 1.2 over a
   50,000-word vocabulary, in place of enwik8) through ``run_wordcount``
   on the card, 8 maps, 4 reducers, the default ``Config()``, under
   ``torch.profiler``: the counts equal a direct ``collections.Counter``,
   K1 7 pairs a reducer (map and reduce phase seconds, idle share, peak
   memory printed); (b) Sort (64k records, 10 B keys, 90 B values),
   SecondarySort (200 groups x 200), InvertedIndex (400 docs x 200 words),
   Grep on 14a's text, Pi (8 maps x 20,000 points) and DFSIO (4 x 16 MiB),
   each held by its validity gate, K1 launched in each but DFSIO; (c) the
   bridge as Hadoop drives it: a MOFSupplier ``UdaBridge`` serves the
   first 8 maps of the 64-map tree from its ShuffleServer on 127.0.0.1,
   and a NetMerger ``UdaBridge(device=None)`` (INIT in the reference
   10-parameter layout, a FETCH per map, FINAL, reduceExit, GET_STATS,
   EXIT) hands up a stream equal to run b's, K1 7 pairs, one
   ``fetch_over_message``, GET_STATS's ``emit.bytes`` the stream's length;
   (d) the C-ABI shim and its C++ embedder built with ``g++`` and run as a
   subprocess per reducer of a 3-map, 2-reducer tree, its embedded
   interpreter merging on the card (K1 2 pairs each, records as written);
15. the multi-chip path (``uda_tpu_torch.parallel``) on an 8-slot mesh
   over the one card (``make_mesh(8, devices=[cuda] * 8)``), each run
   with ``metrics``, the launch counts and the peak memory reset just
   before and read just after: (a) after phase 7, ``distributed_terasort``
   of phase 4's 10^8 records (BASELINE.md config 5's shape on one card:
   uniform splitters, the default capacity 2n/64, "auto" = keys8 for the
   3 key words and the invalid flag, K2 and K1 in each slot's local
   sort), under ``torch.profiler``: slot by slot the valid rows equal
   the matching rows of the single-chip stable sort (kept on the
   device), no overflow, each slot in order (wall, idle share, peak
   memory, launches); (b) 2^22 records, every other one in
   the first destination range: the fused attempt overflows the default
   capacity and the windowed multi-round re-run drains every bucket,
   equal to the single-chip sort, ``exchange.rounds`` and
   ``.rounds.skipped`` equal to the port's run on 8 CPU slots; (c) 2^20
   uniform records on ``dcn:2,ici:4`` (``mesh_from_config``) with
   ``exchange_mode`` flat, hierarchical and coded, ``multiround="always"``:
   the three outputs equal, ``exchange.dcn.messages``, ``.dcn.coded.bytes``
   and ``.dcn.saved.bytes`` equal to the CPU slots' runs; (d) 14b's Sort
   job with ``mesh=`` the 8 slots (``run_reduces_mesh`` ->
   ``exchange_blobs`` -> ``ExchangeFetchClient`` -> ``MergeManager`` ->
   K1): outputs equal to the same job without ``mesh=`` (K1 launches and
   the ``mesh_shuffle`` time printed); (e) a world-size-1 NCCL group on
   127.0.0.1 with 8 local slots runs 15b's words through
   ``distributed_sort_step``: each slot equal to 15b's;
16. the runtime observability plane armed on phase 12a's path (run c's 16
   maps served by a port ShuffleServer on 127.0.0.1, ``MergeManager.run``
   on the card over ``HostRoutingClient``), ``metrics``, the launch counts
   and the peak memory reset just before and read just after:
   ``uda.tpu.stats.enable``, a ``StatsReporter`` at 250 ms writing JSON
   lines, the sampling profiler at 97 Hz, the flight recorder's dump
   directory, the rollup ring at 250 ms with the anomaly engine, the
   OpenMetrics endpoint on a free port, one tenant (so the SLI book
   attaches), the resource ledger and lockdep armed and ``device_trace``
   (``UDA_TPU_XPROF``) around the run. Held to run c's digest with K1 15
   pairs; the trace names K1's two kernels as often as the counters
   say; ``critpath.analyze`` of the task's exported spans sums to the
   root's wall within 5%; the reporter's final record carries the trio
   and ``fetch.latency_ms``'s p50/p95/p99; a windowed MSG_STATS poll finds
   the ring running with samples; one scrape's ``uda_fetch_bytes`` is
   ``fetch.bytes`` as the exposition prints it; every ledger drain is empty and lockdep saw no cycle;
   a forced flight-recorder dump parses with the run's events; the
   profiler charged samples to ``reduce_task`` (wall, idle share, the
   partition and the overhead against 12a printed);
17. (a) ``graft_entry.dryrun_multichip`` on the card at 8, 16, 32 and 64
   slots, 128 records a slot (the reference's multichip_scale sizes), its
   four cases (uniform through ``distributed_terasort``; 75% skew on the
   multi-round path; every fly-off engine, lanes/lanes2/keys8 running K2,
   K1 and the partition kernel in every slot; a ``(dcn, shuffle)`` 2 x n/2
   mesh): each size with the launch counts and the peak memory reset just
   before and read just after, every case's slots equal row for row to
   the same dry run on CPU slots, the accounting equal (each size's
   seconds and K2/K1/partition launches printed); (b)
   ``pallas_merge.merge_sorted_pair`` with ``keys8=True``,
   ``two_phase=True`` and the default at phase 8's largest K1 class
   (8,388,608 rows a side, its 7-word rows, 5 key words with many ties):
   the three give the same bytes, equal to K1's plain version and to a
   stable re-sort (each call's launches and device ms printed);
18. the native host runtime (``uda_tpu_torch/native`` over
   ``csrc/{codec,reader,merge,lzo}.cc``), on which every reduce phase
   above runs (``uda.tpu.use.native`` is on by default; each of their
   runs must show native calls, ``native_calls`` in its record): (a) its
   ``g++`` build, in phase 2 beside the kernels', and a second build in
   the process that must be a no-op; (b) on the card's host, against the
   port's pure-Python forms: crack, ``write_records`` and ``frame_batch``
   over run c's 16 MOF partitions (host seconds of each), the k-way
   loser tree against the heap merge for each of the 11 key types of its
   table on small spill files, ``merge_rows_split_into`` with 1 to 4
   parts against ``merge_rows_native`` and the lexsort engine (2^20 rows
   a side), the span gather against the numpy gather on one slab; (c)
   phase 12a's task (run c's 16 maps over the wire, the default Config)
   with ``uda.tpu.use.native`` on and off in turns, 2 pairs, each held to
   run c's stream, with wall, fetch and emit seconds, K1 launches, idle
   share and native calls (> 0 on, 0 off); (d) phase 10a's hybrid task
   (4 LPQs of 4 maps) on and off: the same stream, spill framing and
   RPQ seconds, the loser tree's calls; (e) the read pool's backend on
   the card's kernel, a batched read of the 16 maps under
   ``uda.tpu.read.backend=io_uring`` against ``preadv`` (the same
   bytes), and one 1 MiB MOF partition through the LZO ladder's
   ``builtin`` rung (ratio printed), decoded by ``lzo1x_decompress_py``;
   (f) one of run c's MOF partitions written again with the IFile CRC
   trailer and cracked natively with ``verify_crc`` (trailer bytes
   printed; a flipped byte and a missing trailer raise the reference's
   messages).
19. the operator tools (``uda_tpu_torch/tools``), the launch counts
   reset just before each and read just after: (a) ``tune_probe`` at full
   size (both domains, 2^16 and 2^20 rows) into a temporary cache: K1-K4
   and the partition kernel launched, the four ``gpu|rows{17,21}|lanes{0,1}``
   keys and ``io.read|linux`` written, all eight engines timed with no
   error for the lanes-capable keys, a second run probes nothing; under
   the cache "auto" at 2^20 rows routes to the crowned engine and equals
   the yardstick; at 2^16 rows whether the small-batch rule overrode the
   crowned engine is printed (the rule stays); one fly-off call broken
   down (the whole ``bench_step``, teragen, one checksum, the order check,
   the sort by carry and by keys8; ms as issued and device ms); (b)
   ``net_smoke --spans`` on the card: exit 0, K1 launched, and
   ``scripts/trace_merge.py`` stitches the span file; (c) one reduce over
   the wire from a port ShuffleServer with the stats plane armed, then
   ``udatop --once --json`` carries its served bytes and ``udafleet
   --once --json`` renders it ``ok`` and an unused port ``down``.

Each phase's seconds are printed on a line of their own. The last two
lines are one JSON object with a record per kernel (K2's, K1's and the
partition kernel's with their launches in each run of phase 15,
``distributed_path_launches``, and of phase 17a, ``dryrun_path_launches``;
K1's and the partition kernel's in phase 17b's keys8 call,
``pair_keys8_launches``; every kernel's in phase 19a's probe,
``tune_probe_path_launches``, and 19b's smoke,
``net_smoke_path_launches``) and the contract line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from uda_tpu_torch import graft_entry, interop, native
from uda_tpu_torch.bridge import Cmd, UdaBridge, form_cmd
from uda_tpu_torch.device import generator
from uda_tpu_torch.coding import parse_scheme
from uda_tpu_torch.compress import (BLOCK_HEADER, Codec, DecompressingClient,
                                    get_codec)
from uda_tpu_torch.compress.lzo import (lzo1x_decompress_py,
                                        native_lzo_source)
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                  MergeManager, checkpoint)
from uda_tpu_torch.merger import streaming as stream_mod
from uda_tpu_torch.merger.hybrid import num_lpqs_for
from uda_tpu_torch.merger.merge_manager import PROGRESS_INTERVAL
from uda_tpu_torch.merger.emitter import frame_batch
from uda_tpu_torch.models import (dfsio, grep, inverted_index, pi,
                                  secondary_sort, sort_job, terasort,
                                  wordcount)
from uda_tpu_torch.net import RemoteFetchClient, ShuffleServer
from uda_tpu_torch.mofserver import (DataEngine, DirIndexResolver, MOFWriter,
                                     ShuffleRequest, StoreManager,
                                     write_striped_map_output)
from uda_tpu_torch.ops import (_build, _build_host, lane_gather, pallas_fold,
                               pallas_merge)
from uda_tpu_torch.ops import merge as merge_ops
from uda_tpu_torch.ops import packing, pallas_sort
from uda_tpu_torch.ops import sort as sort_ops
from uda_tpu_torch.ops.sort import _as_i64, fill_words, i32, u32, words_of
from uda_tpu_torch.parallel import (distributed_sort_step, make_mesh,
                                    mesh_from_config, uniform_splitters)
from uda_tpu_torch.parallel import multihost
from uda_tpu_torch.tools import net_smoke, tune_probe, udafleet, udatop
from uda_tpu_torch.models.pipeline import MapReduceJob
from uda_tpu_torch.utils.comparators import get_key_type
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils import vint
from uda_tpu_torch.utils.errors import (FallbackSignal, StorageError,
                                        TenantError, TransportError)
from uda_tpu_torch.utils.failpoints import failpoints
from uda_tpu_torch.utils.ifile import (EOF_MARKER, IFileWriter, RecordBatch,
                                       crack, iter_file_records,
                                       native_enabled, set_native_enabled,
                                       write_records)
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
    # its launches include the records entry's (below): the benchmark's
    # sort cell counts every K3 launch under this name
    "tile_sort_folded": dict(
        id="K3", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:90"),
    # K3 reading the key words of row-major records in place: the keys8f
    # engine's K3, so the sort cell's
    "tile_sort_folded_rows": dict(
        id="K3", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:90"),
    "merge_pass_folded": dict(
        id="K4", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:135"),
    # K4's eight-way pass and its partition: their launches are also
    # counted under merge_pass_folded and merge_partition
    "merge_pass_folded8": dict(
        id="K4", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:135"),
    "merge_partition8": dict(
        id="K4", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_sort.py:210"),
    "take_lanes": dict(
        id="K5", route="cuda", source="uda_tpu_torch/csrc/lane_gather.cu",
        replaces="scripts/probe_gather.py:62"),
    # the row gather: the reference moves the sorted records with XLA's
    # jnp.take, no Pallas kernel
    "take_rows": dict(
        id="K6", route="cuda", source="uda_tpu_torch/csrc/lane_gather.cu",
        replaces="none (uda_tpu/models/terasort.py:135 is jnp.take)"),
}
MAIN_PATH = ("tile_sort", "merge_pass", "merge_partition")
FOLDED_PATH = ("tile_sort_folded", "tile_sort_folded_rows",
               "merge_pass_folded", "merge_partition", "merge_pass_folded8",
               "merge_partition8")
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
    # the keys8 layout of the distributed sort: 3 key words + the flag
    (8, 4, 7, 1 << 14, 1024, "equal"),
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
# K3 on records in place: records, words a record, tile, key words and the
# kind of keys
RECORD_K3_CASES = [
    (1 << 20, 26, 1024, 3, "mixed"),      # no padding column
    (10**6 + 37, 26, 1024, 3, "mixed"),   # padding columns past n
    (10**6 + 37, 27, 1024, 2, "ones"),    # rows only 4-byte aligned
    (5000, 3, 1024, 1, "equal"),          # order from the arrival index
    (70_001, 26, 16384, 3, "high"),       # past one K3 block: K4 merges
]
# K4 on runs whose records have equal twins in the other run: key words,
# n, run_len
EQUAL_RUN_CASES = [(1, 1 << 13, 1024), (3, 1 << 13, 256)]
# K4's four-way pass on groups whose four runs hold equal twins: key words,
# n, run_len (the last: a group of three runs)
EQUAL_RUN4_CASES = [(1, 1 << 14, 1024), (3, 1 << 14, 256),
                    (2, 3 << 12, 1024)]
# and the eight-way pass: the last two, a group of four runs and a group
# of one short run
EQUAL_RUN8_CASES = [(1, 1 << 14, 1024), (3, 1 << 14, 256),
                    (2, 3 << 12, 1024), (3, 2 * 2048 + 128, 256)]
# the partition kernel on one pass over two sorted runs of this many
# records (its deepest searches: 2^20 candidates), at K1's width and K4's,
# with first key words all equal, every key word equal, and mixed keys
DEEP_PARTITION_RUN = 1 << 20
DEEP_PARTITION_KINDS = ("first", "equal", "mixed")
PROBE_SHAPES = ((32, 2048), (8, 2048), (8, 512))  # scripts/probe_gather.py
# K5 in phase 3: the probe's shapes, then records of 3, 26 and 33 words
# (26: n not a multiple of 4, so rows are moved a word a thread)
TAKE_SHAPES = PROBE_SHAPES + ((3, 1 << 20), (26, 100_003), (33, 1029))
# K5's designs in turns at [8, n] (phase 6): n from 2^9 to 2^25, finer
# around lane_gather.SMALL_BYTES (2^15 columns of 8 rows)
TAKE_SWEEP_NS = tuple(1 << k for k in (9, 11, 13, 15, 16, 17, 19, 21, 23,
                                       25))
# K6 in phase 3: (rows, words a row, base offset in words, perm kind); the
# block's rows are 157 at 26 words, 75 at 27, one at 3000
TAKE_ROWS_CASES = ((100_003, 26, 0, "random"), (100_003, 27, 0, "random"),
                   (4099, 26, 1, "repeated"), (4099, 27, 0, "row3"),
                   (158, 26, 0, "row3"), (7, 3000, 0, "random"))
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
OBS_TENANT = "t16"         # phase 16: the one tenant the SLI book sees
SPEC_CONF = {"uda.tpu.fetch.speculate.pn": 95,
             "uda.tpu.fetch.speculate.floor.ms": 50}
# phase 14a: WordCount (BASELINE config 1) on a seeded Zipf text in place
# of enwik8 (not in the repository; the job's host side takes about 20 us
# a token, so 100 MB would take most of an hour)
WC_BYTES = 4 << 20
WC_VOCAB = 50_000
WC_ZIPF_A = 1.2
WC_MAPS = 8
WC_REDUCERS = 4
SORT_RECORDS = 1 << 16     # phase 14b's Sort: 10 B keys, 90 B values
GREP_PATTERN = rb"qu[a-z]*"  # phase 14b's Grep, on 14a's text
SHIM_JOB = "job_shim"      # phase 14d: tests/test_bridge_shim.py's shape
SHIM_MAPS = 3
SHIM_REDUCERS = 2
SHIM_RECORDS = 30
MESH_SLOTS = 8             # phase 15: the 8-slot mesh over the one card
MESH_N = 1 << 22           # phase 15b, 15d, 15e's records
MESH_POD_N = 1 << 20       # phase 15c's records (card and CPU slots)
MESH_POD_SHAPE = "dcn:2,ici:4"
MESH_MODES = ("flat", "hierarchical", "coded")
MESH_KERNELS = ("tile_sort", "merge_pass", "merge_partition")
DRYRUN_SIZES = (8, 16, 32, 64)  # phase 17a: the reference's scale sizes
PAIR_RUN_LEN = 1 << 23     # phase 17b: phase 8's largest K1 class, a side
PAIR_KEYS = 5              # phase 17b: 4 key words + the length word
PAIR_FORMS = (("default", {}), ("keys8", {"keys8": True}),
              ("two_phase", {"two_phase": True}))


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


def native_calls(what: str, emitted: bool = True) -> dict:
    """The native host runtime's calls since ``native.reset_calls()``.
    With ``uda.tpu.use.native`` on, a run that emitted records must have
    made some; with it off, none."""
    calls = dict(native.calls)
    if not native_enabled():
        require(not calls, f"[{what}] native calls {calls} with "
                           f"uda.tpu.use.native off")
    elif emitted:
        require(sum(calls.values()) > 0,
                f"[{what}] no native call with uda.tpu.use.native on")
    return calls


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
def phase_build() -> dict:
    """The kernels (``nvcc``, one process a source) and, at the same time,
    the native host runtime (``g++``, phase 18a). Returns the seconds of
    each."""
    host: dict = {}

    def build_host() -> None:
        try:
            host["path"], host["s"] = _build_host.build_native()
        except Exception as e:  # noqa: BLE001 - raised below
            host["error"] = e

    t = threading.Thread(target=build_host, name="uda-native-build")
    t.start()
    secs = _build.build_all()
    t.join()
    if "error" in host:
        raise host["error"]
    log(f"[build] nvcc sm_90a, {len(list(_build.CSRC.glob('*.cu')))} "
        f"sources: {secs:.1f} s; g++ native host runtime "
        f"{host['path']}: {host['s']:.1f} s")
    return {"kernels_s": secs, "native_s": host["s"],
            "native_path": host["path"]}


# ---------------------------------------------------------------- phase 3
def lanes_words(seed: int, rows: int, n: int, num_keys: int,
                kind: str = "mixed") -> np.ndarray:
    """uint32[rows, n] records in the lanes layout: random payload, key rows
    mixing random words with a small alphabet (duplicates, words >= 2^31,
    all-0xFFFFFFFF keys). Another ``kind`` sets every key word: "equal" (one
    value, so the arrival index orders them), "ones" (all-0xFFFFFFFF) or
    "high" (top bit set); "first" sets only the first key word to one value
    (the other words decide). The port's tests draw their inputs here
    too."""
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
    elif kind == "first":
        x[0] = np.uint32(0x80000001)
    elif kind != "mixed":
        raise ValueError(kind)
    return x


def equal_runs(seed: int, n: int, run_len: int, num_keys: int,
               ways: int = 2) -> np.ndarray:
    """uint32[4, n] slim records in ascending runs of ``run_len``, where
    in every group of ``ways`` runs (a pair by default) each run after the
    first copies the first's key words and tie-break (its payload rows
    differ): each record has an equal twin in every other run of its
    group, so a merge must send ties to the earliest run. Where n ends
    inside a group, its last runs are short (a prefix of the first's) or
    missing."""
    x = lanes_words(seed, 4, n, num_keys)
    for a0 in range(0, n, ways * run_len):
        a = x[:, a0:a0 + run_len]
        a[:] = a[:, np.lexsort(a[num_keys - 1::-1])]
        a[3] = np.arange(a.shape[1], dtype=np.uint32)
        for r in range(1, ways):
            t0 = a0 + r * run_len
            t1 = min(t0 + run_len, n)
            if t0 >= n:
                break
            x[:num_keys, t0:t1] = a[:num_keys, :t1 - t0]
            x[3, t0:t1] = a[3, :t1 - t0]
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


def cascade_passes(n: int, tile: int, folded: bool) -> list:
    """A cascade's merge passes over ``n`` columns of sorted tiles, as
    ``(run_len, ways)``: K4's (``merge_plan``: the fewest passes,
    eight-way, one of them four-way where they leave room for it, first)
    or K1's, two-way, one a level."""
    if folded:
        return pallas_fold.merge_plan(n, tile)
    return [(tile << lvl, 2) for lvl in range((n // tile - 1).bit_length())]


def folded_step(ways: int) -> tuple:
    """K4's pass of ``ways`` (2, 4 or 8) runs a group and its plain
    version, both taking (x4, run_len, tile, num_keys)."""
    return {2: (pallas_fold.merge_pass_folded,
                pallas_fold.merge_pass_folded_plain),
            4: (pallas_fold.merge_pass4_folded,
                pallas_fold.merge_pass4_folded_plain),
            8: (pallas_fold.merge_pass8_folded,
                pallas_fold.merge_pass8_folded_plain)}[ways]


def check_cascade(x: torch.Tensor, num_keys: int, tb_row: int, tile: int,
                  folded: bool) -> dict:
    """Run the cascade kernel by kernel, holding each launch against its
    plain version on the same input; returns the largest error of each
    (K4's passes of every number of ways under K4's name, the eight-way
    ones and their partition also under their own)."""
    first, first_plain, step, step_plain, names, args = cascade(
        folded, num_keys, tb_row)
    errs = dict.fromkeys(names, 0)
    y = first(x, tile, *args)
    errs[names[0]] = max_abs_err(y, first_plain(x, tile, *args))
    for L, ways in cascade_passes(x.shape[1], tile, folded):
        part_err = check_partition(y, L, num_keys, tb_row, folded, ways)
        if folded:
            step, step_plain = folded_step(ways)
        z = step(y, L, tile, *args)
        note_merge_errs(errs, names[1], ways,
                        max_abs_err(z, step_plain(y, L, tile, *args)),
                        part_err)
        y = z
    require(same(y, stable_reference(x, num_keys, tb_row)),
            f"{names} cascade differs from the stable sort")
    torch.cuda.synchronize()
    return errs


def note_merge_errs(errs: dict, pass_name: str, ways: int, err: int,
                    part_err: int) -> None:
    """Fold one merge pass's largest errors into ``errs``: the pass's under
    ``pass_name``, its partition's under ``merge_partition``, and an
    eight-way pass's also under its own launch names."""
    found = [(pass_name, err), ("merge_partition", part_err)]
    if ways == 8:
        found += [("merge_pass_folded8", err), ("merge_partition8", part_err)]
    for name, e in found:
        errs[name] = max(errs.get(name, 0), e)


def merge_width(rows: int, num_keys: int, n: int, run_len: int,
                folded: bool, ways: int = 2) -> int:
    """The block width K4 (``folded``; its four-way or eight-way pass with
    ``ways`` 4 or 8) or K1 takes on one pass."""
    if folded and ways == 4:
        return pallas_fold.merge_pass4_folded_width(num_keys, n, run_len)
    if folded and ways == 8:
        return pallas_fold.merge_pass8_folded_width(num_keys, n, run_len)
    if folded:
        return pallas_fold.merge_pass_folded_width(num_keys, n, run_len)
    return pallas_sort.merge_pass_width(rows, num_keys, n, run_len)


def partition_of(ways: int, plain: bool = False):
    """The partition kernel of a pass of ``ways`` runs a group (or its
    plain version), taking (y, run_len, width, num_keys, tb_row): the
    two-way one (merge_splits' splits, K1's and K4's two-way passes) or
    the four-way or eight-way one (the slim layout's, tie-break row 3)."""
    if ways > 2:
        fn = {4: (pallas_fold.merge_partition4,
                  pallas_fold.merge_partition4_plain),
              8: (pallas_fold.merge_partition8,
                  pallas_fold.merge_partition8_plain)}[ways][plain]
        return lambda y, L, w, nk, tb: fn(y, L, w, nk)
    return (pallas_sort.merge_partition_plain if plain
            else pallas_sort.merge_partition)


def check_partition(y: torch.Tensor, run_len: int, num_keys: int,
                    tb_row: int, folded: bool, ways: int = 2) -> int:
    """The partition kernel of a pass of ``ways`` runs a group against its
    plain version at the block width the merge kernel (K4 or K1) takes;
    the largest error."""
    rows, n = y.shape
    width = merge_width(rows, num_keys, n, run_len, folded, ways)
    require(n % width == 0 and width <= ways * run_len,
            f"merge width {width} at n={n} run_len={run_len}")
    got = partition_of(ways)(y, run_len, width, num_keys, tb_row)
    want = partition_of(ways, plain=True)(y, run_len, width, num_keys,
                                          tb_row)
    return max_abs_err(got, want)


def deep_runs(seed: int, rows: int, run_len: int, num_keys: int, kind: str,
              dev: torch.device, ways: int = 2) -> torch.Tensor:
    """uint32[rows, ways * run_len]: ``ways`` ascending runs of ``run_len``
    records (each stably sorted), the tie-break row the arrival index over
    all."""
    x = interop.words_from_numpy(
        lanes_words(seed, rows, ways * run_len, num_keys, kind), dev)
    tb = rows - 1
    runs = [stable_reference(u32(i32(x)[:, h:h + run_len].contiguous()),
                             num_keys, tb)
            for h in range(0, ways * run_len, run_len)]
    for r, run in enumerate(runs):
        i32(run)[tb] += r * run_len
    return u32(torch.cat([i32(h) for h in runs], dim=1))


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


def check_take_rows(gen: torch.Generator, n: int, w: int, offset: int,
                    kind: str) -> int:
    """K6 against ``words[perm]`` by torch indexing on random words, the
    rows starting ``offset`` words past an aligned base; ``kind`` is a
    permutation ("random"), indices with repeats ("repeated") or the
    tie-break row of a longer [4, m] tensor ("row3"). The largest error
    against the plain version."""
    dev = gen.device
    flat = torch.randint(-(1 << 31), 1 << 31, (n * w + offset,),
                         dtype=torch.int32, generator=gen, device=dev)
    x = u32(flat[offset:].view(n, w))
    if kind == "repeated":
        perm = torch.randint(0, n, (n,), dtype=torch.int32, generator=gen,
                             device=dev)
    else:
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    if kind == "row3":
        full = torch.randint(0, 1 << 30, (4, 2 * n + 1), dtype=torch.int32,
                             generator=gen, device=dev)
        full[3, :n] = perm
        perm = full[3]
    got = lane_gather.take_rows(x, perm)
    require(same(got, u32(i32(x)[perm[:n].long()])),
            f"take_rows [{n}, {w}] +{offset} {kind} differs from "
            f"words[perm]")
    return max_abs_err(got, lane_gather.take_rows_plain(x, perm))


def check_records_k3(words: torch.Tensor, num_keys: int, tile: int) -> int:
    """K3 reading the key words of the row-major records ``words`` in place
    against K3 on the padded [4, m] matrix of those keys
    (``record_key_rows``), and the slim cascade on the records against the
    stable sort of that matrix; the largest error of K3 on the records
    against its plain version (K3's on the matrix)."""
    n, w = words.shape
    m, tile = pallas_sort.pad_pow2(n, tile)
    mat4 = pallas_sort.record_key_rows(words, num_keys, m, rows=4)
    got = pallas_fold.tile_sort_folded_rows(words, num_keys, m, tile)
    require(same(got, pallas_fold.tile_sort_folded(mat4, tile, num_keys)),
            f"K3 on records [{n}, {w}] differs from K3 on the matrix")
    require(same(pallas_fold.sort_records_folded4(words, num_keys, m, tile),
                 stable_reference(mat4, num_keys, 3)),
            f"sort_records_folded4 [{n}, {w}] differs from the stable sort")
    return max_abs_err(got, pallas_fold.tile_sort_folded_plain(mat4, tile,
                                                               num_keys))


def two_way_cascade(words: torch.Tensor, num_keys: int, m: int,
                    tile: int) -> torch.Tensor:
    """The records cascade on ``m`` columns by two-way K4 passes alone, one
    a level (ceil(log2(tiles)) of them): the form before the four-way
    pass, whose output the cascade keeps byte for byte."""
    y = pallas_fold.tile_sort_folded_rows(words, num_keys, m, tile)
    spare = torch.empty_like(y)
    for lvl in range((m // tile - 1).bit_length()):
        y, spare = pallas_fold.merge_pass_folded(y, tile << lvl, tile,
                                                 num_keys, out=spare), y
    return y


def check_whole_blocks(words: torch.Tensor, num_keys: int,
                       tile: int) -> dict:
    """The records cascade on whole blocks (``records_cascade_columns``:
    where those columns are no power-of-two multiple of the tile, each
    pass's last group or pair has short runs or none), K3 and every K4
    pass (``merge_plan``'s) held against their plain versions and the
    partitions against their own, the whole against the two-way cascade's
    bytes, and its first n columns against the power-of-two cascade's: the
    same sorted keys and permutation, then the padding in arrival order.
    Returns the largest error of each kernel and the columns."""
    n = words.shape[0]
    m2, tile = pallas_sort.pad_pow2(n, tile)
    m = pallas_fold.records_cascade_columns(n, tile)
    y = pallas_fold.tile_sort_folded_rows(words, num_keys, m, tile)
    errs = {"tile_sort_folded_rows": max_abs_err(
        y, pallas_fold.tile_sort_folded_plain(
            pallas_sort.record_key_rows(words, num_keys, m, rows=4), tile,
            num_keys)), "merge_pass_folded": 0, "merge_partition": 0}
    two = two_way_cascade(words, num_keys, m, tile)
    for L, ways in pallas_fold.merge_plan(m, tile):
        part_err = check_partition(y, L, num_keys, 3, True, ways)
        step, plain = folded_step(ways)
        z = step(y, L, tile, num_keys)
        note_merge_errs(errs, "merge_pass_folded", ways,
                        max_abs_err(z, plain(y, L, tile, num_keys)),
                        part_err)
        y = z
    require(same(y, pallas_fold.sort_records_folded4(words, num_keys, m,
                                                     tile)),
            f"sort_records_folded4 at m={m} differs from its passes")
    require(same(y, two), f"the multiway cascade at m={m} differs from the "
                          f"two-way one")
    pow2 = pallas_fold.sort_records_folded4(words, num_keys, m2, tile)
    require(same(y[:num_keys, :n], pow2[:num_keys, :n])
            and same(y[3, :n], pow2[3, :n]),
            f"the cascade on {m} columns differs from the one on {m2} in "
            f"its first {n}")
    require(same(y[3, n:], u32(torch.arange(n, m, dtype=torch.int32,
                                            device=y.device))),
            f"the padding of the cascade on {m} columns is not last, in "
            f"arrival order")
    errs["columns"] = m
    return errs


def phase_kernels(dev: torch.device, n: int = N_KERNEL,
                  tiles=KERNEL_TILES, edges=EDGE_CASES,
                  slim_edges=SLIM_EDGE_CASES, equal_cases=EQUAL_RUN_CASES,
                  equal4_cases=EQUAL_RUN4_CASES,
                  equal8_cases=EQUAL_RUN8_CASES,
                  take_shapes=TAKE_SHAPES, take_rows_cases=TAKE_ROWS_CASES,
                  deep_run=DEEP_PARTITION_RUN,
                  deep_kinds=DEEP_PARTITION_KINDS,
                  record_cases=RECORD_K3_CASES) -> dict:
    gen = generator(SEED + 1, dev)
    seeds = itertools.count(SEED + 1)
    worst: dict = {}
    for tile in tiles:
        cases = [(8, 3, 7, False), (8, 4, 7, False), (32, 3, 31, False),
                 (4, 3, 3, True)]
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
    for nk, n_eq, run_len in equal4_cases:
        x = interop.words_from_numpy(
            equal_runs(next(seeds), n_eq, run_len, nk, ways=4), dev)
        got = pallas_fold.merge_pass4_folded(x, run_len, run_len, nk)
        err = max_abs_err(got, pallas_fold.merge_pass4_folded_plain(
            x, run_len, run_len, nk))
        require(same(got, pallas_fold.merge_pass_folded(
            pallas_fold.merge_pass_folded(x, run_len, run_len, nk),
            2 * run_len, run_len, nk)),
            f"K4's four-way pass on equal runs differs from two two-way "
            f"passes (keys={nk}, run_len={run_len})")
        worst["merge_pass_folded"] = max(worst.get("merge_pass_folded", 0),
                                         err)
        log(f"[kernels] K4 four-way on groups of runs with equal records, "
            f"keys={nk} run_len={run_len} n={n_eq}: max_abs_err {err} "
            f"(tolerance 0); equal to two two-way passes")
    for nk, n_eq, run_len in equal8_cases:
        x = interop.words_from_numpy(
            equal_runs(next(seeds), n_eq, run_len, nk, ways=8), dev)
        part_err = check_partition(x, run_len, nk, 3, True, 8)
        got = pallas_fold.merge_pass8_folded(x, run_len, run_len, nk)
        err = max_abs_err(got, pallas_fold.merge_pass8_folded_plain(
            x, run_len, run_len, nk))
        two = x
        for lvl in range(3):
            two = pallas_fold.merge_pass_folded(two, run_len << lvl, run_len,
                                                nk)
        require(same(got, two),
                f"K4's eight-way pass on equal runs differs from three "
                f"two-way passes (keys={nk}, run_len={run_len})")
        note_merge_errs(worst, "merge_pass_folded", 8, err, part_err)
        log(f"[kernels] K4 eight-way on groups of runs with equal records, "
            f"keys={nk} run_len={run_len} n={n_eq}: max_abs_err {err}, "
            f"partition {part_err} (tolerance 0); equal to three two-way "
            f"passes")
    for n_rec, w, tile, nk, kind in record_cases:
        x = interop.words_from_numpy(np.ascontiguousarray(
            lanes_words(next(seeds), w, n_rec, nk, kind).T), dev)
        err = check_records_k3(x, nk, tile)
        worst["tile_sort_folded_rows"] = max(
            worst.get("tile_sort_folded_rows", 0), err)
        log(f"[kernels] K3 on records [{n_rec}, {w}] in place, keys={nk} "
            f"tile={tile} {kind} keys: max_abs_err {err} (tolerance 0); "
            f"equal to K3 on the [4, m] matrix, cascade equal to the "
            f"stable sort")
        errs = check_whole_blocks(x, nk, tile)
        cols = errs.pop("columns")
        for name, err in errs.items():
            worst[name] = max(worst.get(name, 0), err)
        log(f"[kernels] the records cascade on whole blocks [{n_rec}, {w}] "
            f"at m={cols}, keys={nk} tile={tile} {kind} keys: max_abs_err "
            f"{errs} (tolerance 0); its first {n_rec} columns equal to the "
            f"power-of-two cascade's")
    for kind in deep_kinds:
        for rows, folded, ways in ((8, False, 2), (4, True, 2),
                                   (4, True, 4), (4, True, 8)):
            nk, tb = terasort.KEY_WORDS, rows - 1
            y = deep_runs(next(seeds), rows, deep_run, nk, kind, dev, ways)
            err = check_partition(y, deep_run, nk, tb, folded, ways)
            for name in ("merge_partition",) + (("merge_partition8",)
                                                if ways == 8 else ()):
                worst[name] = max(worst.get(name, 0), err)
            width = merge_width(rows, nk, ways * deep_run, deep_run, folded,
                                ways)
            log(f"[kernels] {ways}-way partition on {ways} runs of "
                f"{deep_run} at {'K4' if folded else 'K1'}'s width {width}, "
                f"{kind} keys: max_abs_err {err} against its plain version "
                f"(tolerance 0)")
    for rows, n_take in take_shapes:
        err = check_take_lanes(gen, rows, n_take)
        worst["take_lanes"] = max(worst.get("take_lanes", 0), err)
        log(f"[kernels] K5 take_lanes [{rows}, {n_take}] "
            f"({lane_gather.design(rows, n_take)}): max_abs_err {err} "
            f"(tolerance 0); both designs equal to x[:, perm]")
    for n_rows, w, offset, kind in take_rows_cases:
        err = check_take_rows(gen, n_rows, w, offset, kind)
        worst["take_rows"] = max(worst.get("take_rows", 0), err)
        log(f"[kernels] K6 take_rows [{n_rows}, {w}] base +{4 * offset} B, "
            f"{kind} perm: max_abs_err {err} (tolerance 0); equal to "
            f"words[perm]")
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
    auto = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev,
                                 key_rows=terasort.KEY_WORDS)
    require(auto == "keys8f", f'"auto" resolved to {auto!r}, not keys8f')
    reference = yardstick(words)
    runs = [run_path(words, "auto", FOLDED_PATH, reference),
            run_path(words, "keys8", MAIN_PATH, reference)]
    require(runs[0]["launches"]["tile_sort"] == 0
            and runs[0]["launches"]["merge_pass"] == 0,
            f'"auto" launched K2 or K1: {runs[0]["launches"]}')
    require(runs[0]["launches"]["tile_sort_folded"] == 1
            and runs[0]["launches"]["tile_sort_folded_rows"] == 1,
            f'"auto": not one K3 launch, on the records in place: '
            f'{runs[0]["launches"]}')
    for r in runs:
        require(r["launches"]["take_rows"] == 1,
                f'{r["path"]}: {r["launches"]["take_rows"]} launches of '
                f'K6, not one')
    return words, runs


@contextlib.contextmanager
def process_tune_cache(path: str):
    """The tune cache at ``path`` as the process default for the block
    (``UDA_TPU_TUNE_CACHE``); the cold default is back after."""
    saved_cache = tuncache.tune_cache
    saved_env = os.environ.get("UDA_TPU_TUNE_CACHE")
    os.environ["UDA_TPU_TUNE_CACHE"] = path
    tuncache.tune_cache = tuncache.TuneCache(tuncache.cache_path_from_env())
    try:
        yield
    finally:
        tuncache.tune_cache = saved_cache
        if saved_env is None:
            os.environ.pop("UDA_TPU_TUNE_CACHE", None)
        else:
            os.environ["UDA_TPU_TUNE_CACHE"] = saved_env


def sort_key(n: int, lanes: int, dev: torch.device) -> str:
    """The tune-cache key of ``n`` rows on ``dev`` (domain sort.engine)."""
    return (f"{sort_ops.cache_backend(dev)}|rows{tuncache.rows_bucket(n)}"
            f"|lanes{lanes}")


@contextlib.contextmanager
def tune_cache_naming(engine: str, n: int, dev: torch.device):
    """A temporary tune cache, the process default for the block, whose
    winner for ``n`` rows of lanes-capable callers on ``dev`` is
    ``engine``."""
    key = sort_key(n, 1, dev)
    with tempfile.TemporaryDirectory(prefix="uda_tune_") as d:
        path = os.path.join(d, "tune.json")
        tuncache.TuneCache(path).record("sort.engine", key,
                                        {"engine": engine},
                                        probe="chip_smoke phase 4b")
        with process_tune_cache(path):
            yield key


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
        res = run_path(words, "auto", FOLDED_PATH, reference)
        require(res["launches"]["tile_sort"] == 0,
                f"K2 launched under the cached keys8f: {res['launches']}")
        hits = metrics.get("tune.cache.hits", domain="sort.engine")
        call = {p: (lambda p=p: terasort.single_chip_sort(
            words, path=p, device=dev)) for p in ("auto", "keys8f", "keys8")}
        auto_ms, keys8f_ms, keys8_ms = in_turns(
            call["auto"], call["keys8f"], call["keys8"], reps=2)
    del reference
    cold = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev)
    require(cold == "keys8f", f'"auto" after the cache resolved to {cold!r}')
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
    equal keys; where ``seg`` does not divide the columns, the last
    segment is short (a pass's last pair on whole blocks). Never on the
    port's path: the ``library_ms`` yardstick."""
    rows, m = x.shape
    key_rows = list(range(num_keys)) + ([] if tb_row is not None
                                        else [rows - 1])
    full = m - m % seg
    src = []
    for lo, hi, width in ((0, full, seg), (full, m, m - full)):
        if hi > lo:
            order = sort_ops.stable_lex_argsort(
                [x[r, lo:hi].view(-1, width) for r in key_rows], dim=1)
            src.append((order + torch.arange(lo, hi, width,
                                             device=x.device)[:, None]
                        ).flatten())
    src = torch.cat(src)
    out = sort_ops.take_cols(x, src)
    if tb_row is not None:
        i32(out)[tb_row] = i32(words_of(src))
    return out


def partition_latency(y: torch.Tensor, run_len: int, num_keys: int,
                      tb_row: int, reps: int = 20) -> dict:
    """One launch of the partition kernel and one dependent step of its
    search, on the card, over two runs of ``run_len`` (``y`` holds just
    them: the first pair of the deepest pass whose first pair is whole,
    copied out where the columns run on past it): the device time of a launch whose one boundary needs no search
    (width 2 * run_len: d = 0), and of one whose second boundary (width
    run_len: d = run_len) runs the deepest search of the pass alone, each
    after the L2 cache is flushed, so every step waits for device memory;
    their difference over that search's steps is one step's round trip."""
    require(y.shape[1] == 2 * run_len, "partition_latency takes one run pair")
    flush = torch.empty(1 << 26, dtype=torch.int32, device=y.device)

    def median_ms(width: int) -> float:
        times = []
        for _ in range(reps):
            flush.zero_()  # 256 MB: the 50 MB L2 holds none of y after it
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pallas_sort.merge_partition(y, run_len, width, num_keys, tb_row)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    launch = median_ms(2 * run_len)
    deep = median_ms(run_len)
    steps = run_len.bit_length()
    return {"launch_ms": launch, "deep_ms": deep, "steps": steps,
            "step_us": max(0.0, deep - launch) / steps * 1e3}


def partition_work(m: int, run_len: int, width: int,
                   ways: int = 2) -> tuple:
    """Bytes and compares a partition kernel needs on one pass over m
    columns. Two-way: per block boundary a binary search over the
    diagonal's range (the last pair's with its short runs,
    ``pallas_sort.pair_runs``), each step reading one word of two records
    (more only on equal words), and one 4-byte split written. Four-way
    (``ways`` 4): per block boundary past a group's start, one level of the
    multiway selection per power of two up to run_len, each reading at
    least one word of each run that has a new sample there (all four in a
    whole group) and comparing it with the largest sample taken, and four
    4-byte splits written. Eight-way (``ways`` 8) likewise over eight runs,
    eight splits written. Returns (bytes, compares)."""
    if ways > 2:
        group = ways * run_len
        steps = 0
        for g0 in range(0, m, group):
            runs = sum(min(max(m - g0 - r * run_len, 0), run_len) > 0
                       for r in range(ways))
            boundaries = (min(group, m - g0) - 1) // width
            steps += boundaries * run_len.bit_length() * runs
        return 4 * ways * (m // width) + 4 * steps, steps

    def pair_steps(la: int, lb: int) -> int:
        return sum((min(d, la) - max(0, d - lb)).bit_length()
                   for d in range(0, la + lb, width))

    full, left = divmod(m, 2 * run_len)
    steps = full * pair_steps(run_len, run_len)
    if left:
        la = min(left, run_len)
        steps += pair_steps(la, left - la)
    return 4 * (m // width) + 2 * 4 * steps, steps


def time_cascade(mat: torch.Tensor, tile: int, folded: bool,
                 reps: int) -> dict:
    """Time each kernel of one cascade at ``mat``'s shape, its plain
    version and PyTorch's stable sort on the same input, and compare
    them. The columns are a power-of-two multiple of ``tile`` or, for the
    records cascade's whole blocks, not: then each pass's last group or
    pair is short or alone, as on the main path. K1's passes are two-way,
    one a level; K4's as ``merge_plan`` gives them (eight-way, then a
    four-way or two-way pass), each moving 32 B a column; its eight-way
    passes and their partition are also reported alone, under their
    launch names."""
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
        "m": m,
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
            "ops": 0, "max_abs_err": 0, "library_ms": None,
            "per_pass_device_ms": [], "steps": []}
    passes = cascade_passes(m, tile, folded)
    compares = 0
    eight: dict = {}  # the eight-way passes and their partition alone
    for i, (L, ways) in enumerate(passes):
        width = merge_width(rows, nk, m, L, folded, ways)
        partition = partition_of(ways)
        if folded:
            step, step_plain = folded_step(ways)
        part["per_pass_ms"].append(time_ms(
            lambda: partition(y, L, width, nk, tb), reps))
        part["per_pass_device_ms"].append(device_ms(
            lambda: partition(y, L, width, nk, tb), reps))
        # the deepest boundary's dependent steps: a two-way search's span
        # is L, or the short B run's length where the pass's one pair is
        # short; the multiway selection reads at least once a level
        if ways > 2:
            part["steps"].append(L.bit_length()
                                 if width < ways * L else 0)
        else:
            part["steps"].append(min(L, m - L).bit_length()
                                 if width < 2 * L else 0)
        # one step's round trip, on the first pair of runs of the deepest
        # pass whose first pair is whole
        next_run = passes[i + 1][0] if i + 1 < len(passes) else m
        if 2 * L <= m < 2 * next_run:
            part["latency"] = partition_latency(
                y if 2 * L == m else y[:, :2 * L].contiguous(), L, nk, tb)
        part_plain = time_ms(
            lambda: partition_of(ways, plain=True)(y, L, width, nk, tb),
            1, warmup=0)
        part_err = check_partition(y, L, nk, tb, folded, ways)
        part["plain_ms"] += part_plain
        part["max_abs_err"] = max(part["max_abs_err"], part_err)
        nbytes, steps = partition_work(m, L, width, ways)
        part["bytes"] += nbytes
        part["ops"] += steps
        per_pass.append(time_ms(lambda: step(y, L, tile, *args, out=spare),
                                reps))
        plain = time_ms(lambda: step_plain(y, L, tile, *args), 1, warmup=0)
        library = time_ms(lambda: library_sort(y, ways * L, nk, None), 1,
                          warmup=0)
        plain_total += plain
        library_total += library
        z = step(y, L, tile, *args, out=spare)
        err = max_abs_err(z, step_plain(y, L, tile, *args))
        errs = max(errs, err)
        require(same(library_sort(y, ways * L, nk, None), z),
                f"{names[1]}: PyTorch's sort of each run group differs")
        # a merge of `ways` runs: log2(ways) compares a record (a tree of
        # two-way merges)
        compares += (ways.bit_length() - 1) * m * words_compared
        if ways == 8:
            for name, reading in (
                    ("merge_pass_folded8", (per_pass[-1], plain, library,
                                            2 * rows * m * word,
                                            3 * m * words_compared, err)),
                    ("merge_partition8", (part["per_pass_ms"][-1],
                                          part_plain, None, nbytes, steps,
                                          part_err))):
                e = eight.setdefault(name, {
                    "m": m, "ms": 0.0, "per_pass_ms": [], "plain_ms": 0.0,
                    "library_ms": None, "bytes": 0, "ops": 0,
                    "max_abs_err": 0})
                ms, plain_ms, library_ms, nbytes8, ops8, err8 = reading
                e["ms"] += ms
                e["per_pass_ms"].append(ms)
                e["plain_ms"] += plain_ms
                if library_ms is not None:
                    e["library_ms"] = (e["library_ms"] or 0.0) + library_ms
                e["bytes"] += nbytes8
                e["ops"] += ops8
                e["max_abs_err"] = max(e["max_abs_err"], err8)
        y, spare = z, y
    part["ms"] = sum(part["per_pass_ms"])
    part["device_ms"] = sum(part["per_pass_device_ms"])
    lat = part["latency"]
    # the floor the search's dependent round trips set: its steps, each
    # one round trip to device memory, and one launch, per pass
    part["floor_per_pass_ms"] = [s * lat["step_us"] / 1e3 + lat["launch_ms"]
                                 for s in part["steps"]]
    part["floor_ms"] = sum(part["floor_per_pass_ms"])
    res[names[1]] = {
        "m": m, "ms": sum(per_pass), "per_pass_ms": per_pass,
        "plain_ms": plain_total, "library_ms": library_total,
        "bytes": len(per_pass) * 2 * rows * m * word,
        "ops": compares, "passes": [ways for _, ways in passes],
        "max_abs_err": max(errs, part["max_abs_err"]),
    }
    # the partition kernel, at each merge kernel's own width; its time is
    # also inside the merge pass's, which is timed through the wrapper
    if folded:
        res[names[1]]["partition"] = part
        res.update(eight)
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
    for lvl in range((m // tile - 1).bit_length()):
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


def row_sectors(w: int, first: "int | None" = None) -> float:
    """32-byte sectors one source row of ``w`` words spans (or its
    ``first`` words), averaged over the row starts of a contiguous [n, w]
    (they repeat every 8 rows)."""
    span = 4 * (w if first is None else first)
    return sum((4 * w * i % 32 + span + 31) // 32 for i in range(8)) / 8


def time_take_rows(words: torch.Tensor, perm: torch.Tensor,
                   reps: int) -> dict:
    """K6 on the main path's records by its sort permutation (the first n
    of the cascade's tie-break row, read in place): its own device time in
    turns with torch indexing ``words[perm[:n].long()]`` (the int64 copy
    included, as the path had it), the wrapper call, the peak memory of
    one call beside indexing's, the plain version, and the sector-granular
    bound (each source row's whole sectors read)."""
    n, w = words.shape
    ref = u32(i32(words)[perm[:n].long()])

    def peak_of(fn) -> int:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    got = lane_gather.take_rows(words, perm)
    require(same(got, ref), "take_rows differs from words[perm] at the "
                            "main path's shape")
    del ref
    plain = lane_gather.take_rows_plain(words, perm)
    # the error over the differing rows alone: int64 copies of the whole
    # 10.4 GB would not fit beside it
    bad = (i32(got) != i32(plain)).any(dim=1)
    err = max_abs_err(got[bad], plain[bad]) if bool(bad.any()) else 0
    del got, plain, bad
    peak = peak_of(lambda: lane_gather.take_rows(words, perm))
    lib_peak = peak_of(lambda: i32(words)[perm[:n].long()])
    own, lib = in_turns(lambda: lane_gather.take_rows(words, perm),
                        lambda: i32(words)[perm[:n].long()],
                        reps=reps, timer=device_ms)
    sector_bytes = int(n * (32 * row_sectors(w) + 4 * w + 4))
    res = {
        "ms": own, "library_ms": lib,
        "plain_ms": time_ms(lambda: lane_gather.take_rows_plain(words,
                                                               perm), 1),
        "call_ms": time_ms(lambda: lane_gather.take_rows(words, perm), reps),
        # every row read once, written once, and perm's n entries
        "bytes": (2 * w + 1) * n * 4, "ops": 0, "max_abs_err": err,
        "sector_bytes": sector_bytes,
        "sector_bound_ms": bound(sector_bytes, 0)[0],
        "vector_words": lane_gather.row_vector_words(words),
        "peak_bytes": peak, "library_peak_bytes": lib_peak,
    }
    log(f"[times] K6 take_rows [{n}, {w}]: {own:.3f} ms, torch indexing "
        f"{lib:.3f} ms (device, in turns); wrapper call "
        f"{res['call_ms']:.3f} ms; sector bound "
        f"{res['sector_bound_ms']:.3f} ms ({sector_bytes} B); peak {peak} B"
        f", indexing's {lib_peak} B")
    torch.cuda.synchronize()
    return res


def time_k3_records(words: torch.Tensor, mat4: torch.Tensor, tile: int,
                    reps: int) -> dict:
    """K3 as the sort cell runs it, reading the key words of the main
    path's records in place: held at tolerance 0 to its plain version
    (K3's on ``mat4``, the padded [4, m] matrix of those keys) and to K3
    on ``mat4``; its device time in turns with K3 on ``mat4``, beside the
    device time of building ``mat4`` from the records (the layout copy
    the records entry does without) and its sector-granular bound: the
    32-byte sectors of each record's key words read, 16 B a column
    written."""
    n, w = words.shape
    m = mat4.shape[1]
    nk = terasort.KEY_WORDS
    got = pallas_fold.tile_sort_folded_rows(words, nk, m, tile)
    require(same(got, pallas_fold.tile_sort_folded(mat4, tile, nk)),
            "K3 on the records differs from K3 on the matrix at the main "
            "path's shape")
    err = max_abs_err(got, pallas_fold.tile_sort_folded_plain(mat4, tile,
                                                              nk))
    del got
    own, on_matrix = in_turns(
        lambda: pallas_fold.tile_sort_folded_rows(words, nk, m, tile),
        lambda: pallas_fold.tile_sort_folded(mat4, tile, nk),
        reps=reps, timer=device_ms)
    layout = device_ms(
        lambda: pallas_sort.record_key_rows(words, nk, m, rows=4), reps)
    sector_bytes = int(n * 32 * row_sectors(w, nk) + 16 * m)
    res = {
        "m": m, "ms": own, "matrix_ms": on_matrix, "layout_ms": layout,
        "plain_ms": time_ms(lambda: pallas_fold.tile_sort_folded_plain(
            pallas_sort.record_key_rows(words, nk, m, rows=4), tile, nk), 1,
            warmup=0),
        "library_ms": None,
        "bytes": sector_bytes,
        # a merge sort of each tile, as K3 on the matrix
        "ops": m * (tile.bit_length() - 1) * (nk + 1),
        "max_abs_err": err,
        "sector_bound_ms": bound(sector_bytes, 0)[0],
    }
    log(f"[times] K3 on records [{n}, {w}] in place: {own:.3f} ms, on the "
        f"[4, {m}] matrix {on_matrix:.3f} ms (device, in turns); the "
        f"matrix's build {layout:.3f} ms; sector bound "
        f"{res['sector_bound_ms']:.3f} ms ({sector_bytes} B)")
    torch.cuda.synchronize()
    return res


def cascade_plans(m: int, tile: int) -> dict:
    """K4 plans over ``m`` columns of sorted tiles, each a list of
    ``(run_len, ways)``: ``merge_plan``'s; the others of as many passes
    (eight-way passes while five or more runs are left, then a four-way or
    two-way one; eight-way passes alone); the four-way rule's (four-way
    while three or more runs are left, then a two-way pass); and two-way
    passes alone."""
    def by_rule(rule):
        plan, runs, run_len = [], -(-m // tile), tile
        while runs > 1:
            ways = rule(runs)
            plan.append((run_len, ways))
            runs, run_len = -(-runs // ways), run_len * ways
        return plan

    return {"merge_plan": pallas_fold.merge_plan(m, tile),
            "four-way last": by_rule(
                lambda r: 8 if r > 4 else 4 if r > 2 else 2),
            "eight-way alone": by_rule(lambda r: 8 if r > 2 else 2),
            "four-way rule": by_rule(lambda r: 4 if r > 2 else 2),
            "two-way": by_rule(lambda r: 2)}


def plan_cascade(words: torch.Tensor, num_keys: int, m: int, tile: int,
                 plan: list) -> torch.Tensor:
    """The records cascade on ``m`` columns: K3 on the records in place,
    then K4's passes as ``plan`` gives them."""
    y = pallas_fold.tile_sort_folded_rows(words, num_keys, m, tile)
    spare = torch.empty_like(y)
    for L, ways in plan:
        y, spare = folded_step(ways)[0](y, L, tile, num_keys, out=spare), y
    return y


def time_whole_blocks(words: torch.Tensor, tile: int, reps: int) -> dict:
    """The records cascade as the sort cell runs it, on whole blocks
    (``records_cascade_columns``), beside the same cascade on the
    power-of-two columns it took before, by CUDA events (device time): the
    whole cascade and K3 on the records, each in turns, then each K4 pass
    (``merge_plan``: eight-way, then a four-way or two-way pass; its
    partition inside) and the partition alone; on whole blocks the
    cascade under each plan of ``cascade_plans`` (merge_plan's, two other
    plans of as many passes, the four-way rule's 9 passes at 10^8 records
    and two-way passes alone, 17) in turns, their bytes held equal; each
    eight-way pass against its byte bound; and the occupancy of K4's three
    merge kernels. Each kernel's bound is reckoned on the columns it
    moves: K4 32 B a column a pass, whatever its ways, the partition its
    searches (``partition_work``), K3 its sector-granular bytes (as
    ``time_k3_records``). The two cascades' first n columns are held
    equal, and one keys8f call's counters and K4 launches (its passes,
    four-way and eight-way ones counted apart) to the columns and the
    plan. Returns the readings by column count and by plan."""
    n, w = words.shape
    nk = terasort.KEY_WORDS
    m2, tile = pallas_sort.pad_pow2(n, tile)
    m = pallas_fold.records_cascade_columns(n, tile)
    wide = pallas_fold.sort_records_folded4(words, nk, m2, tile)
    got = pallas_fold.sort_records_folded4(words, nk, m, tile)
    require(same(got[:nk, :n], wide[:nk, :n]) and same(got[3, :n],
                                                       wide[3, :n]),
            f"the cascade on {m} columns differs from the one on {m2}")
    del wide, got
    cascades = in_turns(
        lambda: pallas_fold.sort_records_folded4(words, nk, m2, tile),
        lambda: pallas_fold.sort_records_folded4(words, nk, m, tile),
        reps=3, timer=device_ms)
    k3 = in_turns(
        lambda: pallas_fold.tile_sort_folded_rows(words, nk, m2, tile),
        lambda: pallas_fold.tile_sort_folded_rows(words, nk, m, tile),
        reps=reps, timer=device_ms)
    res = {}
    for cols, cascade_ms, k3_ms in zip((m2, m), cascades, k3):
        y = pallas_fold.tile_sort_folded_rows(words, nk, cols, tile)
        spare = torch.empty_like(y)
        k4, part, part_bytes, plan = [], [], 0, []
        for L, ways in pallas_fold.merge_plan(cols, tile):
            width = merge_width(4, nk, cols, L, True, ways)
            step = folded_step(ways)[0]
            partition = partition_of(ways)
            k4.append(device_ms(lambda: step(y, L, tile, nk, out=spare),
                                reps))
            part.append(device_ms(lambda: partition(y, L, width, nk, 3),
                                  reps))
            part_bytes += partition_work(cols, L, width, ways)[0]
            plan.append(ways)
            y, spare = step(y, L, tile, nk, out=spare), y
        del y, spare
        k3_bytes = int(n * 32 * row_sectors(w, nk) + 16 * cols)
        res[cols] = {
            "cascade_ms": cascade_ms, "passes": len(k4), "ways": plan,
            "k3_ms": k3_ms, "k3_bound_ms": bound(k3_bytes, 0)[0],
            "k4_ms": sum(k4), "k4_per_pass_ms": k4,
            "k4_bound_ms": bound(32 * cols * len(k4), 0)[0],
            "k4_pass_bound_ms": bound(32 * cols, 0)[0],
            "partition_ms": sum(part), "partition_per_pass_ms": part,
            "partition_bound_ms": bound(part_bytes, 0)[0]}
        r = res[cols]
        log(f"[times] records cascade at m={cols} ({n} records, tile "
            f"{tile}, {r['passes']} passes, ways {plan}): {cascade_ms:.3f} "
            f"ms (device, in turns); K3 {k3_ms:.3f} ms, bound "
            f"{r['k3_bound_ms']:.3f}; K4 {r['k4_ms']:.3f} ms, bound "
            f"{r['k4_bound_ms']:.3f} ({r['k4_pass_bound_ms']:.3f} a pass); "
            f"partition {r['partition_ms']:.3f} ms, bound "
            f"{r['partition_bound_ms']:.4f}")
        log(f"[times] records cascade at m={cols}: K4 per pass (ms): "
            + " ".join(f"{v:.3f}" for v in k4))
        log(f"[times] records cascade at m={cols}: partition per pass "
            f"(ms): " + " ".join(f"{v:.4f}" for v in part))
    plans = cascade_plans(m, tile)
    want = pallas_fold.sort_records_folded4(words, nk, m, tile)
    for name, plan in plans.items():
        require(same(plan_cascade(words, nk, m, tile, plan), want),
                f"the cascade by the {name} plan at m={m} differs from "
                f"merge_plan's")
    del want
    plan_ms = dict(zip(plans, in_turns(
        *(lambda plan=plan: plan_cascade(words, nk, m, tile, plan)
          for plan in plans.values()), reps=reps, timer=device_ms)))
    eight = [v for v, w in zip(res[m]["k4_per_pass_ms"], res[m]["ways"])
             if w == 8]
    ways = {"plans": {name: {"ways": [w for _, w in plan],
                             "ms": plan_ms[name]}
                      for name, plan in plans.items()},
            "eight_way_pass_ms": eight,
            "eight_way_pass_bound_ms": res[m]["k4_pass_bound_ms"],
            "six_against_nine_pct": 100.0 * (
                1.0 - plan_ms["merge_plan"] / plan_ms["four-way rule"])}
    for name, plan in plans.items():
        log(f"[times] records cascade at m={m} by the {name} plan "
            f"({len(plan)} passes, ways {[w for _, w in plan]}): "
            f"{plan_ms[name]:.3f} ms (device, in turns); bytes equal")
    log(f"[times] eight-way K4 pass at m={m} (ms): "
        + " ".join(f"{v:.3f}" for v in eight)
        + f" against its bound {res[m]['k4_pass_bound_ms']:.3f}; the "
        f"merge_plan cascade {ways['six_against_nine_pct']:.2f}% shorter "
        f"than the four-way rule's")
    for w in (2, 4, 8):
        width = merge_width(4, nk, m, tile, True, w)
        regs, blocks = pallas_fold.merge_pass_folded_occupancy(nk, w, width)
        ways[f"{w}_way_occupancy"] = {"width": width, "registers": regs,
                                      "blocks_per_sm": blocks}
        log(f"[times] K4's {w}-way merge kernel at width {width}: {regs} "
            f"registers a thread, {blocks} blocks a multiprocessor")
    before = {k: metrics.counters.get(k, 0.0)
              for k in terasort.CASCADE_COUNTERS}
    k4_names = ("merge_pass_folded", "merge_pass_folded4",
                "merge_pass_folded8")
    k4_before = {k: _build.launches[k] for k in k4_names}
    terasort.single_chip_sort(words, path="keys8f", device=words.device)
    torch.cuda.synchronize()
    counted = {k: metrics.counters.get(k, 0.0) - before[k]
               for k in terasort.CASCADE_COUNTERS}
    passes, fours, eights = (_build.launches[k] - v
                             for k, v in k4_before.items())
    require(counted == {"sort.cascade_records": n,
                        "sort.cascade_columns": m,
                        "sort.cascade_passes": res[m]["passes"]}
            and passes == res[m]["passes"]
            and fours == res[m]["ways"].count(4)
            and eights == res[m]["ways"].count(8),
            f"a keys8f call counted {counted} and {passes} K4 passes "
            f"({eights} eight-way, {fours} four-way), not {n} records in "
            f"{m} columns and the plan {res[m]['ways']}")
    log(f"[times] one keys8f call: {counted}, {passes} K4 passes, {eights} "
        f"of them eight-way, {fours} four-way; the real share of the "
        f"cascade's columns {n / m:.5f} (at m={m2}: {n / m2:.5f})")
    torch.cuda.synchronize()
    return {"columns": m, "pow2_columns": m2, "counters": counted,
            "by_columns": res, "plans": ways}


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
    """Phase 6 at the main path's shapes: keys8's [8, m8] matrix (m8 the
    power-of-two padding, as that engine pads) and the slim [4, m] matrix
    at the records cascade's whole blocks (``records_cascade_columns``,
    as the keys8f engine sorts them), each kernel against its plain
    version and PyTorch's sort, with bounds on the columns it moves."""
    n = words.shape[0]
    nk = terasort.KEY_WORDS
    m8, tile = pallas_sort.pad_pow2(n, tile)
    m = pallas_fold.records_cascade_columns(n, tile)
    keyr = pallas_sort.record_key_rows(words, nk, m8)
    mat8 = pallas_sort.record_key_rows(words, nk, m8, rows=8)
    mat4 = pallas_sort.record_key_rows(words, nk, m, rows=4)
    times = time_cascade(mat8, tile, False, reps)
    times.update(time_cascade(mat4, tile, True, reps))
    ab = ab_slim(mat4, tile, reps)
    times["tile_sort_folded_rows"] = time_k3_records(words, mat4, tile, reps)
    _, perm = pallas_sort.keys8_sort_perm(keyr, tile=tile)
    merge = merge_perm(sort_ops._packed_keys(list(keyr[:2]))[0])
    times["take_lanes"] = time_take_lanes(mat8, perm, merge, reps)
    del mat8, mat4, merge
    times["take_rows"] = time_take_rows(words, perm, reps)
    del perm
    whole = time_whole_blocks(words, tile, reps)
    sweep = sweep_take_lanes(words.device)
    require(all(t["max_abs_err"] == 0 for t in times.values()),
            "a kernel differs from its plain version at the main path's "
            "shapes")
    for name, t in times.items():
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"])
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.3f} ms")
        log(f"[times] {KERNELS[name]['id']} {name} at m={t.get('m', m8)} "
            f"tile={tile}: "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, library "
            f"{lib}, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes']} B, {t['ops']} ops), "
            f"max_abs_err {t['max_abs_err']} (tolerance 0)")
        if "per_pass_ms" in t:
            log(f"[times] {name} per pass (ms"
                + (f", ways {t['passes']}" if "passes" in t else "") + "): "
                + " ".join(f"{v:.3f}" for v in t["per_pass_ms"]))
        if "partition" in t:
            p = t["partition"]
            log(f"[times] {name}'s partition: {p['ms']:.3f} ms, plain "
                f"{p['plain_ms']:.3f} ms, max_abs_err {p['max_abs_err']}; "
                f"per pass (ms): "
                + " ".join(f"{v:.3f}" for v in p["per_pass_ms"]))
        if "floor_ms" in t or "partition" in t:
            log_partition_floor(f"{name}'s partition" if "partition" in t
                                else name, t.get("partition", t))
    keys = list(keyr)
    casc = {
        "keys8_cascade_ms": time_ms(
            lambda: pallas_sort.keys8_sort_perm(keyr, tile=tile), 3),
        "keys8f_cascade_ms": time_ms(
            lambda: pallas_sort.keys8_sort_perm(keyr, tile=tile,
                                                folded=True), 3),
        "keys8f_records_cascade_ms": time_ms(
            lambda: pallas_fold.sort_records_folded4(words, nk, m, tile), 3),
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
        "padded_records": m8,
        "whole_block_records": m,
        "tile": tile,
    }
    log("[times] cascades " + json.dumps(casc))
    return {"kernels": times, "cascades": casc, "ab": ab,
            "take_lanes_sweep": sweep, "whole_blocks": whole}


def log_partition_floor(what: str, p: dict) -> None:
    """The partition's device time per pass (queued behind a sleep, so the
    host's launch cost is hidden) beside the floor its dependent round trips
    set (steps x one round trip + one launch, measured by
    partition_latency)."""
    lat = p["latency"]
    log(f"[times] {what} device per pass (ms): "
        + " ".join(f"{v:.4f}" for v in p["per_pass_device_ms"])
        + f"; summed {p['device_ms']:.4f}")
    log(f"[times] {what} round-trip floor per pass (ms): "
        + " ".join(f"{v:.4f}" for v in p["floor_per_pass_ms"])
        + f"; summed {p['floor_ms']:.4f} (one dependent step "
        f"{lat['step_us']:.3f} us after an L2 flush, one launch "
        f"{lat['launch_ms'] * 1e3:.3f} us, {lat['steps']} steps at the "
        f"deepest pass in {lat['deep_ms'] * 1e3:.3f} us)")


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
    """K1 at each size class of the reduce task's merge tree, on the
    shapes the path gives it: each partition's run rows built as the
    merge paths build them and cut to its records (``merge_row_pair``
    hands K1 the valid prefixes of both runs), merged pairwise level by
    level into runs of exact size (64 runs of one size class fold as the
    path's binary counter folds them), and at each level the first pair
    packed as ``merge_sorted_pair`` packs it (``L`` the larger run
    rounded up to the tile), K1 held against its plain version and timed
    beside its bound and PyTorch's stable sort of the pair."""
    kt = get_key_type(MERGE_KEY_CLASS)
    level = []
    for seg, rec in enumerate(parts):
        pk = packing.pack_keys(tera_batch(rec), kt, 16)
        rows = np.empty((merge_ops.next_run_capacity(pk.num_records),
                         4 + merge_ops.ROW_EXTRA_COLS), np.uint32)
        merge_ops.fill_run_rows(rows, pk, merge_ops.run_row_order(pk), seg)
        level.append(interop.words_from_numpy(rows[:pk.num_records], dev))
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
        rec = {"run_len": L, "runs": [int(a.shape[0]), int(b.shape[0])],
               "shape": list(x.shape),
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
        log(f"[merge] K1 class run_len={L} runs={rec['runs']} "
            f"x={rec['shape']}: "
            f"{rec['ms']:.3f} ms, bound {ms_bound:.3f} ms ({bound_by}), "
            f"plain {rec['plain_ms']:.3f} ms, library "
            f"{rec['library_ms']:.3f} ms, width {rec['width']}, "
            f"max_abs_err {err} (tolerance 0)")
        del x, spare, got
        level = [merge_ops.merge_row_pair(
                     level[i], level[i + 1], int(level[i].shape[0]),
                     int(level[i + 1].shape[0]), "pallas")
                 for i in range(0, len(level) - 1, 2)] \
            + level[len(level) - len(level) % 2:]
    torch.cuda.synchronize()
    return classes


def phase_merge(dev: torch.device, root: str, mids: list, parts: list,
                map_bytes: int, setup_s: float) -> dict:
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
        native.reset_calls()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            emitted = mm.run(MERGE_JOB, mids, 0, stream.extend)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        counts = {k: _build.launches[k] for k in KERNELS}
        ncalls = native_calls("merge")
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
    res = {"maps": maps, "map_bytes": map_bytes,
           "partition_bytes": part_bytes, "records": checks["records"],
           "wall_s": wall, "mb_per_s": part_bytes / wall / 1e6,
           "split": split, "launches": counts, "native_calls": ncalls,
           "k1_device_ms": k1_device_ms(by_name), "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3) if by_name else None,
           "peak_bytes": peak, "setup_s": setup_s, "checks": checks,
           "sha256": digest, "stream_bytes": emitted,
           "top_device_ms": {k[:80]: v for k, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:6]}}
    log("[merge] " + json.dumps(res))
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
        native.reset_calls()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            emitted = mm.run(MERGE_JOB, mids, 0, consumer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: _build.launches[k] for k in KERNELS}
        ncalls = native_calls(f"overlap {name}")
        peak = torch.cuda.max_memory_allocated()
    finally:
        engine.stop()
    om = mm._active_overlap
    snap = metrics.snapshot()
    merges = len(mids) - 1
    require((digest.hexdigest(), length) == want and emitted == length,
            f"[overlap {name}] the stream differs from the re-sort's: "
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
           "split": split, "launches": counts, "native_calls": ncalls,
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
    key and value, in a random order) gathered by the native host
    runtime, by the port's numpy gather by size class (the switch off)
    and by an int64 index per byte (the reference's numpy form), on the
    same spans: equal bytes, host ms of each, best of ``reps``."""
    rng = np.random.default_rng(SEED + 9)
    pick = rng.choice(cat.num_records,
                      min(stream_mod.SLAB_RECORDS, cat.num_records),
                      replace=False)
    lens = (cat.key_len + cat.val_len)[pick]
    src_off = cat.key_off[pick]
    dst_off = np.cumsum(lens) - lens

    def by_class():
        out = np.empty(int(lens.sum()), np.uint8)
        stream_mod._gather_spans_numpy(cat.data, src_off, lens, out,
                                       dst_off)
        return out

    def by_native():
        out = np.empty(int(lens.sum()), np.uint8)
        native.gather_spans_native(cat.data, src_off, lens, out, dst_off)
        return out

    def index(off):
        return np.repeat(off - dst_off, lens) + np.arange(
            int(lens.sum()), dtype=np.int64)

    def by_byte():
        out = np.empty(int(lens.sum()), np.uint8)
        out[index(dst_off)] = cat.data[index(src_off)]
        return out

    require(np.array_equal(by_class(), by_byte())
            and np.array_equal(by_native(), by_byte()),
            "the span gathers differ from the per-byte index")
    times = {}
    for name, fn in (("size_class_ms", by_class), ("byte_index_ms", by_byte),
                     ("native_ms", by_native)):
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
                  want: tuple, c_maps: int = OVERLAP_C_MAPS) -> dict:
    """Runs a (64 maps, held to ``want``, the card's whole-partition
    re-sort of them), b (the first ``B_MAPS`` maps) and c (run c's first
    16 maps), each held to the card's re-sort of its maps, and the
    variable-length runs d, e."""
    part_bytes = sum(p.nbytes + 2 for p in parts)
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
               profiled: bool = False, before_run=None, wrap=None,
               after_run=None) -> dict:
    """One ``MergeManager.run`` over ``entries`` through ``client`` with
    ``fault`` armed in the port's failpoint registry, ``metrics`` and the
    launch counts reset just before and read just after; the stream is
    hashed as it is emitted; ``engines`` are stopped after. Returns the
    run's record: its stream (sha256, length) or the FallbackSignal it
    ended in, wall, launches, peak memory, the metrics snapshot and the
    manager; with ``profiled`` (``torch.profiler``) the device's busy ms
    and idle share too. ``before_run(manager)`` runs after the resets and
    before the timed ``run()`` (13a's map phase); ``wrap()``, when given,
    is the context the run is timed in instead of the profiler (phase
    16's ``device_trace``); ``after_run(manager)`` runs after the timed
    run, before the engines stop (phase 16's polls)."""
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
        native.reset_calls()
        if before_run is not None:
            before_run(mm)
        ctx = (wrap() if wrap is not None else
               profile(activities=[ProfilerActivity.CPU,
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
        ncalls = native_calls(name, emitted=length > 0)
        peak = torch.cuda.max_memory_allocated()
        if after_run is not None:
            after_run(mm)
    finally:
        for e in engines:
            e.stop()
    res = {"run": name, "wall_s": wall, "launches": counts,
           "native_calls": ncalls,
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
    out = {k: res[k] for k in ("run", "wall_s", "launches", "native_calls",
                               "peak_bytes", "sha256", "stream_bytes")}
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
             profiled: bool = False, **drive) -> dict:
    """``drive_task`` over the wire: a port ShuffleServer serves ``root``
    and the reduce task fetches through ``HostRoutingClient``'s socket
    default (through ``DecompressingClient`` when ``codec`` is given).
    With ``hold_at`` one fetch is held and, once ``bounce(servers,
    router, host)`` has run on a thread of its own, failed. ``drive`` goes
    to ``drive_task`` (``before_run``, ``wrap``, ``after_run``; here
    ``after_run(manager, host)`` also gets the server's ``host:port``)."""
    cfg = Config(conf)
    engine, server = serve(root, conf)
    servers = Servers([server])
    host = f"127.0.0.1:{server.port}"
    router = HostRoutingClient(config=cfg)
    rec = RecordingClient(router, hold_at)
    top = (DecompressingClient(rec, codec, comp_chunk_size=comp_chunk_bytes(
        cfg)) if codec is not None else rec)
    after = drive.pop("after_run", None)
    if after is not None:
        drive["after_run"] = lambda mm: after(mm, host)
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
                         profiled=profiled, **drive)
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
    out = {k: res[k] for k in ("run", "wall_s", "launches", "native_calls",
                               "peak_bytes", "sha256", "stream_bytes")}
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
               want: tuple, wall_pull: float) -> dict:
    """Phase 13a: a port ShuffleServer with ``uda.tpu.push.enable`` serves
    run c's 16 maps; the reduce task (the default ``Config()`` plus push,
    over ``HostRoutingClient``'s socket default) arms push first, then a
    thread plays the map phase, ``notify_commit`` for one map every
    ``PUSH_COMMIT_S``, and ``run()`` starts after the last commit.
    ``metrics`` and the launch counts are reset before the arm; the wall
    is ``run()``'s, printed beside 12a's, the pull of the same maps over
    the same wire. The stream must equal run c's with a K1 launch pair per
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
        "pull_12a_wall_s": wall_pull, "caps": {
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
        native.reset_calls()
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
        ncalls = native_calls("tenants")
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


# --------------------------------------------------------------- phase 14
def zipf_text(seed: int, nbytes: int = WC_BYTES, vocab: int = WC_VOCAB,
              a: float = WC_ZIPF_A) -> bytes:
    """About ``nbytes`` of text (cut at a word boundary): ``vocab``
    distinct words of 2 to 10 lowercase letters, each token drawn by
    Zipf's law with exponent ``a`` over the vocabulary's ranks (draws past
    the last rank are drawn again), 12 tokens to a line."""
    rng = np.random.default_rng(seed)
    words: dict = {}
    while len(words) < vocab:
        lens = rng.integers(2, 11, vocab)
        flat = rng.integers(97, 123, int(lens.sum()), dtype=np.uint8).tobytes()
        ends = np.cumsum(lens).tolist()
        for start, end in zip([0] + ends[:-1], ends):
            words.setdefault(flat[start:end], None)
    table = list(words)[:vocab]
    ranks: list = []
    need = nbytes // 6
    while len(ranks) < need:
        draw = rng.zipf(a, need)
        ranks.extend((draw[draw <= vocab] - 1).tolist())
    lines = [b" ".join(table[r] for r in ranks[i:i + 12])
             for i in range(0, len(ranks), 12)]
    text = b"\n".join(lines)[:nbytes]
    return text[:max(text.rfind(b" "), text.rfind(b"\n"))]


def job_run(dev: torch.device, name: str, fn, profiled: bool = False
            ) -> tuple:
    """``fn(work_dir)`` (one workload of ``uda_tpu_torch.models`` on the
    card) in a fresh directory, with ``metrics`` and the launch counts
    reset just before and read just after. Returns (its result, the
    record: wall, the job's phase timers, launches, peak memory, and with
    ``profiled`` the device's busy ms and idle share)."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory(prefix="uda_job_") as work:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        _build.reset_launches()
        native.reset_calls()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            out = fn(work)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: _build.launches[k] for k in KERNELS}
        ncalls = native_calls(name)
        peak = torch.cuda.max_memory_allocated()
    rec = {"job": name, "wall_s": wall,
           "map_phase_s": metrics.get("map_phase_time"),
           "reduce_phase_s": metrics.get("reduce_phase_time"),
           "fetch_s": metrics.get("fetch_time"),
           "merge_s": metrics.get("merge_time"),
           "launches": counts, "native_calls": ncalls, "peak_bytes": peak}
    if profiled:
        by_name, busy = device_time(prof)
        rec.update(device_busy_ms=busy, idle_share=(
            1.0 - busy / (wall * 1e3) if by_name else None),
            k1_device_ms=k1_device_ms(by_name))
    return out, rec


def require_k1(rec: dict, pairs: int = None) -> None:
    """K1 launched on the job's path (one merge and one partition kernel
    per pair merge; exactly ``pairs`` of them when given)."""
    k1 = rec["launches"]
    require(k1["merge_pass"] == k1["merge_partition"] > 0
            and pairs in (None, k1["merge_pass"]),
            f"[{rec['job']}] K1 launched {k1}, not "
            f"{pairs if pairs is not None else 'at least one'} pairs")


def phase_wordcount(dev: torch.device, text: bytes) -> dict:
    """Phase 14a: WordCount (BASELINE config 1) on ``text`` through
    ``run_wordcount`` on the card, ``WC_MAPS`` maps, ``WC_REDUCERS``
    reducers, Text keys and the default ``Config()``: the counts must be a
    direct ``collections.Counter`` of the same tokens, and K1 must merge
    each reducer's forest (maps - 1 pairs each)."""
    want = collections.Counter(m.group(0).lower() for m in
                               re.finditer(rb"[A-Za-z0-9]+", text))
    got, rec = job_run(dev, "14a wordcount", lambda work:
                       wordcount.run_wordcount(
                           text, num_maps=WC_MAPS, num_reducers=WC_REDUCERS,
                           config=Config(), work_dir=work, device=dev),
                       profiled=True)
    require(got == dict(want), f"[14a wordcount] {len(got)} words counted, "
            f"{sum(got.values())} tokens, not the direct count's "
            f"{len(want)} and {sum(want.values())}")
    require_k1(rec, WC_REDUCERS * (WC_MAPS - 1))
    rec.update(text_bytes=len(text), tokens=sum(want.values()),
               distinct=len(want), maps=WC_MAPS, reducers=WC_REDUCERS)
    log("[14a wordcount] " + json.dumps(rec))
    return rec


def phase_workloads(dev: torch.device, text: bytes) -> dict:
    """Phase 14b: the other workloads of ``uda_tpu_torch.models`` on the
    card, each held by its own validity gate (the workloads' own checks
    and the ones below); DFSIO merges nothing and launches no kernel."""
    rng = np.random.default_rng(SEED + 12)
    records = [(rng.bytes(10), rng.bytes(90)) for _ in range(SORT_RECORDS)]
    runs = {}

    out, rec = job_run(dev, "14b sort", lambda work: sort_job.run_sort(
        records, num_maps=WC_MAPS, num_reducers=WC_REDUCERS, work_dir=work,
        device=dev))
    got = [kv for r in sorted(out) for kv in out[r]]
    require(all(all(a[0] <= b[0] for a, b in zip(recs, recs[1:]))
                for recs in out.values()) and sorted(got) == sorted(records),
            "[14b sort] a reducer's keys are out of order or records differ")
    runs["sort"] = rec

    out, rec = job_run(dev, "14b secondary_sort", lambda work:
                       secondary_sort.run_secondary_sort(
                           num_groups=200, per_group=200, num_maps=WC_MAPS,
                           num_reducers=WC_REDUCERS, seed=SEED + 13,
                           work_dir=work, device=dev))
    require(sum(len(v) for v in out.values()) == 200 * 200,
            "[14b secondary_sort] records lost")
    runs["secondary_sort"] = rec

    out, rec = job_run(dev, "14b inverted_index", lambda work:
                       inverted_index.run_inverted_index(
                           num_docs=400, words_per_doc=200, num_maps=WC_MAPS,
                           num_reducers=WC_REDUCERS, seed=1, work_dir=work,
                           device=dev))
    require(sum(len(v) for v in out.values()) == 400 * 200,
            "[14b inverted_index] postings lost")
    runs["inverted_index"] = rec

    out, rec = job_run(dev, "14b grep", lambda work: grep.run_grep(
        text, GREP_PATTERN, num_maps=WC_MAPS, num_reducers=WC_REDUCERS,
        work_dir=work, device=dev))
    want = collections.Counter(m.group(0) for line in text.splitlines()
                               for m in re.finditer(GREP_PATTERN, line))
    counts = [c for _, c in out]
    require(dict(out) == dict(want) and len(out) == len(want)
            and counts == sorted(counts, reverse=True),
            "[14b grep] matches differ from a direct count or are not by "
            "count descending")
    runs["grep"] = rec

    out, rec = job_run(dev, "14b pi", lambda work: pi.run_pi(
        num_maps=WC_MAPS, points_per_map=20_000, work_dir=work, device=dev))
    require(abs(out["estimate"] - np.pi) < 1e-3,
            f"[14b pi] estimate {out['estimate']}")
    rec["estimate"] = out["estimate"]
    runs["pi"] = rec

    out, rec = job_run(dev, "14b dfsio", lambda work: dfsio.run_dfsio(
        num_files=4, bytes_per_file=16 << 20, work_dir=work))
    require(out["files"] == 4 and not any(rec["launches"].values()),
            f"[14b dfsio] {out}, launches {rec['launches']}")
    rec.update({k: out[k] for k in ("write_mb_s", "read_mb_s", "bytes",
                                    "chunks")})
    runs["dfsio"] = rec

    for name, rec in runs.items():
        if name != "dfsio":
            require_k1(rec)
        log(f"[14b {name}] " + json.dumps(rec))
    return runs


class Embedder:
    """The Hadoop side of a bridge (UdaPluginRT/UdaPluginSH): serves conf
    pulls from ``conf`` and index lookups from ``resolver``; hashes the
    ``data_from_uda`` blocks as they arrive and counts the
    ``fetch_over_message`` up-calls."""

    def __init__(self, conf: dict, resolver=None):
        self.conf = conf
        self.resolver = resolver
        self.digest = hashlib.sha256()
        self.length = 0
        self.fetch_overs = 0
        self.failures: list = []
        self.done = threading.Event()

    def get_conf_data(self, name: str, default: str) -> str:
        return str(self.conf.get(name, ""))

    def get_path_uda(self, job_id: str, map_id: str, reduce_id: int):
        return self.resolver.resolve(job_id, map_id, reduce_id)

    def fetch_over_message(self) -> None:
        self.fetch_overs += 1
        self.done.set()

    def data_from_uda(self, data, length: int) -> None:
        self.digest.update(data[:length])
        self.length += length

    def failure_in_uda(self, error: Exception) -> None:
        self.failures.append(error)
        self.done.set()


def phase_bridge(dev: torch.device, root: str, want: tuple,
                 wall_b: float) -> dict:
    """Phase 14c: the first ``B_MAPS`` maps of the 64-map tree under
    ``root`` shuffled as Hadoop drives the bridge. A MOFSupplier
    ``UdaBridge`` (``start(False, ...)``, paths through ``get_path_uda``)
    serves them from its ShuffleServer on 127.0.0.1 (``uda.tpu.net.listen``
    pulled through ``get_conf_data``, started by its INIT); a NetMerger
    ``UdaBridge(device=None)`` takes INIT in the reference 10-parameter
    layout, one FETCH per map naming that server's host (its port from
    ``uda.tpu.net.port``, pulled), FINAL, hands its blocks
    up through ``data_from_uda``, and ends with reduceExit, GET_STATS and
    EXIT. The stream must equal run b's (``want``), K1 must merge the
    forest (maps - 1 pairs), ``fetch_over_message`` must come at the
    reference cadence and GET_STATS's ``emit.bytes`` be the stream."""
    from torch.profiler import ProfilerActivity, profile

    supplier = UdaBridge(device=dev)
    side = Embedder({"uda.tpu.net.listen": "true",
                     "uda.tpu.net.bind": "127.0.0.1",
                     "uda.tpu.net.port": "0"}, DirIndexResolver(root))
    supplier.start(False, [], side)
    supplier.do_command(form_cmd(Cmd.INIT, []))
    require(supplier.net_server() is not None and not supplier.failed,
            f"[14c bridge] the supplier serves nothing: {side.failures}")
    # as in a cluster, every supplier listens on the configured port and a
    # FETCH names the host alone (the protocol's delimiter is ":")
    merger = UdaBridge(device=dev)
    emb = Embedder({"uda.tpu.net.fetch": "true",
                    "uda.tpu.net.port": str(supplier.net_server().port)})
    init = [str(B_MAPS), MERGE_JOB, "0", "0", str(1 << 20), "4096",
            MERGE_KEY_CLASS, "0", "0", str(8 << 30), "0"]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        _build.reset_launches()
        native.reset_calls()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            merger.start(True, [], emb)
            merger.do_command(form_cmd(Cmd.INIT, init))
            for m in range(B_MAPS):
                merger.do_command(form_cmd(Cmd.FETCH, [
                    "127.0.0.1", MERGE_JOB, map_id(m), "0"]))
            merger.do_command(form_cmd(Cmd.FINAL, []))
            require(emb.done.wait(600), "[14c bridge] no fetch_over")
            merger.reduce_exit()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: _build.launches[k] for k in KERNELS}
        ncalls = native_calls("14c bridge")
        peak = torch.cuda.max_memory_allocated()
        stats = json.loads(merger.do_command(form_cmd(Cmd.GET_STATS, [])))
        merger.do_command(form_cmd(Cmd.EXIT, []))
    finally:
        supplier.do_command(form_cmd(Cmd.EXIT, []))
    require(not emb.failures and not merger.failed and not side.failures,
            f"[14c bridge] fell back: {emb.failures or side.failures}")
    require((emb.digest.hexdigest(), emb.length) == want,
            f"[14c bridge] the stream differs from run b's: {emb.length} "
            f"B, sha256 {emb.digest.hexdigest()}")
    require_k1({"job": "14c bridge", "launches": counts}, B_MAPS - 1)
    cadence = B_MAPS // PROGRESS_INTERVAL + 1
    require(emb.fetch_overs == cadence,
            f"[14c bridge] {emb.fetch_overs} fetch_over_message up-calls, "
            f"not {cadence}")
    counters = stats["counters"]
    require(counters.get("emit.bytes") == emb.length
            and counters.get("fetch.bytes", 0) > 0,
            f"[14c bridge] GET_STATS emit.bytes {counters.get('emit.bytes')}"
            f", fetch.bytes {counters.get('fetch.bytes')}")
    by_name, busy = device_time(prof)
    res = {"maps": B_MAPS, "wall_s": wall, "run_b_wall_s": wall_b,
           "fetch_over_messages": emb.fetch_overs, "launches": counts,
           "native_calls": ncalls,
           "get_stats": {k: counters.get(k, 0.0) for k in (
               "fetch.bytes", "emit.bytes", "total_fetch_time",
               "total_merge_time")},
           "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3) if by_name else None,
           "peak_bytes": peak, "sha256": emb.digest.hexdigest(),
           "stream_bytes": emb.length}
    log("[14c bridge] " + json.dumps(res))
    return res


# the bootstrap snippet of phase 14d's embedded interpreter: report the
# task's kernel launches (stderr) when the embedder calls reduce_exit
SHIM_BOOTSTRAP = (
    "import json, sys, torch, uda_tpu_torch.bridge as b\n"
    "from uda_tpu_torch import native\n"
    "from uda_tpu_torch.ops import _build\n"
    "class Counted(b.UdaBridge):\n"
    "    def reduce_exit(self):\n"
    "        super().reduce_exit()\n"
    "        torch.cuda.synchronize()\n"
    "        sys.stderr.write('LAUNCHES ' + json.dumps(dict(_build.launches))"
    " + '\\n')\n"
    "        sys.stderr.write('NATIVE ' + json.dumps(dict(native.calls))"
    " + '\\n')\n"
    "b.UdaBridge = Counted\n")


def phase_shim(dev: torch.device) -> dict:
    """Phase 14d: the bridge's C-ABI shim (``csrc/bridge_shim.cc``) and its
    embedder (``csrc/bridge_shim_test.cc``) built with ``g++``, the build
    timed; the embedder run as a subprocess on a tree of ``SHIM_MAPS`` maps
    and ``SHIM_REDUCERS`` reducers, once per reducer: its embedded
    interpreter runs ``UdaBridge()`` (the card) through INIT, FETCH, FINAL
    and reduceExit. The records it reports must be the tree's, and K1 must
    merge each reducer's forest (maps - 1 pairs)."""
    exe, build_s = _build_host.build_shim()
    rng = np.random.default_rng(SEED + 14)
    want = [0] * SHIM_REDUCERS
    runs = []
    with tempfile.TemporaryDirectory(prefix="uda_shim_") as root:
        writer = MOFWriter(root, SHIM_JOB)
        for m in range(SHIM_MAPS):
            parts: list = [[] for _ in range(SHIM_REDUCERS)]
            for _ in range(SHIM_RECORDS):
                k, v = rng.bytes(10), rng.bytes(30)
                parts[zlib.crc32(k) % SHIM_REDUCERS].append((k, v))
            for r, p in enumerate(parts):
                p.sort()
                want[r] += len(p)
            writer.write(f"attempt_{SHIM_JOB}_m_{m:06d}_0", parts)
        env = dict(os.environ)
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join([here] + [p for p in sys.path
                                                      if p])
        env["UDA_TPU_PY_BOOTSTRAP"] = SHIM_BOOTSTRAP
        for r in range(SHIM_REDUCERS):
            t0 = time.perf_counter()
            proc = subprocess.run([exe, root, SHIM_JOB, str(SHIM_MAPS),
                                   str(r)], capture_output=True, text=True,
                                  env=env, timeout=300, check=False)
            wall = time.perf_counter() - t0
            require(proc.returncode == 0,
                    f"[14d shim] reducer {r}: exit {proc.returncode}: "
                    f"{proc.stdout} {proc.stderr[-2000:]}")
            out = proc.stdout.split()
            require(out[:1] == ["MERGED"] and int(out[3]) == want[r],
                    f"[14d shim] reducer {r}: {proc.stdout.strip()!r}, not "
                    f"{want[r]} records")
            line = next(ln for ln in proc.stderr.splitlines()
                        if ln.startswith("LAUNCHES "))
            launches = json.loads(line[len("LAUNCHES "):])
            require_k1({"job": f"14d shim reducer {r}",
                        "launches": {k: launches.get(k, 0)
                                     for k in KERNELS}}, SHIM_MAPS - 1)
            line = next(ln for ln in proc.stderr.splitlines()
                        if ln.startswith("NATIVE "))
            ncalls = json.loads(line[len("NATIVE "):])
            require(sum(ncalls.values()) > 0,
                    f"[14d shim] reducer {r}: no native call")
            runs.append({"reducer": r, "wall_s": wall,
                         "merged_bytes": int(out[1]), "records": want[r],
                         "launches": launches, "native_calls": ncalls})
    res = {"build_s": build_s, "maps": SHIM_MAPS,
           "reducers": SHIM_REDUCERS, "runs": runs}
    log("[14d shim] " + json.dumps(res))
    return res


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
    card's re-sort (12a's wall not measured: 0)."""
    parts = tera_partitions(SEED + 3, maps, map_bytes)
    want_c = resort_digest(parts[:c_maps], dev)
    with tempfile.TemporaryDirectory(prefix="uda_merge_") as root:
        mids = write_mof_tree(root, parts)
        with phase_seconds("13a push"):
            planes = {"push": phase_push(
                dev, root, mids[:c_maps],
                sum(p.nbytes + 2 for p in parts[:c_maps]), want_c, 0.0)}
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


def phase_reduce(dev: torch.device, root: str, maps: int = MERGE_MAPS,
                 map_bytes: int = MERGE_MAP_BYTES, reps: int = TIMED_REPS,
                 c_maps: int = OVERLAP_C_MAPS) -> tuple:
    """Phases 8 (its run on run c's maps, K1's size classes on all
    ``maps``), 9, 10, 12a, 12b, 12e, 13a, 13c and 16 on one MOF tree
    written once under ``root`` (which outlives the call), then phase 11 on run
    c's maps striped over four roots, 12c, 12d on compressed trees and
    13b on run c's maps written again through the store."""
    t0 = time.perf_counter()
    parts = tera_partitions(SEED + 3, maps, map_bytes)
    mids = write_mof_tree(root, parts)
    setup_s = time.perf_counter() - t0
    log(f"[merge] {maps} maps x {map_bytes} B of TeraSort records "
        f"({sum(p.nbytes + 2 for p in parts)} B, "
        f"{sum(p.shape[0] for p in parts)} records) written by "
        f"MOFWriter in {setup_s:.1f} s")
    # 9a: the 64 maps' stream, the card's whole-partition
    # stable re-sort of them (phase 8 runs on run c's maps)
    want_all = resort_digest(parts, dev)
    merged = phase_merge(dev, root, mids[:c_maps], parts[:c_maps],
                         map_bytes, setup_s)
    # K1 at every size class the 64-map forest of 9a launches,
    # on the exact-size runs the path merges
    with phase_seconds("8 K1 classes"):
        merged["classes"] = merge_classes(parts, dev, reps)
    overlap = phase_overlap(dev, root, mids, parts, want_all, c_maps)
    want_c = (overlap["c"]["sha256"], overlap["c"]["stream_bytes"])
    require(want_c == (merged["sha256"], merged["stream_bytes"]),
            "phase 8's stream differs from run c's")
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
            dev, root, mids[:c_maps],
            sum(p.nbytes + 2 for p in parts[:c_maps]), want_c,
            net["a"]["wall_s"])}
    with phase_seconds("13c tenants"):
        planes["tenants"] = phase_tenants(dev, root, mids[:c_maps],
                                          parts[:c_maps])
    with phase_seconds("16 observability"):
        planes["observability"] = phase_observability(
            dev, root, mids[:c_maps], want_c, net["a"]["wall_s"])
    with phase_seconds("11 coded"):
        coded = phase_coded(dev, parts[:c_maps], want_c,
                            overlap["c"]["wall_s"])
    with phase_seconds("12c 12d codecs"):
        net.update(phase_net_codecs(dev, parts[:c_maps], want_c))
    with phase_seconds("13b store"):
        planes["store"] = phase_store(dev, parts[:c_maps], want_c,
                                      overlap["c"]["wall_s"])
    return merged, overlap, admission, coded, net, planes


# --------------------------------------------------------------- phase 16
def free_port() -> int:
    """A port no one listens on at the moment (127.0.0.1)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def trace_device_busy(events: list, t0_us: float, t1_us: float) -> float:
    """The union of the card's intervals (kernels, copies, sets) of a
    Chrome trace inside [t0, t1], in microseconds."""
    spans = sorted((max(e["ts"], t0_us), min(e["ts"] + e.get("dur", 0),
                                             t1_us))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e.get("ph") == "X")
    busy, reach = 0.0, t0_us
    for lo, hi in spans:
        if hi > max(lo, reach):
            busy += hi - max(lo, reach)
            reach = hi
    return busy


def phase_observability(dev: torch.device, root: str, mids: list,
                        want_c: tuple, wall_12a: float) -> dict:
    """Phase 16: phase 12a's task with the whole runtime observability
    plane armed (see the module docstring), held to run c's stream; each
    check fails the script."""
    import glob
    import urllib.request

    from uda_tpu_torch.net import fetch_remote_stats
    from uda_tpu_torch.tenant import set_current_tenant
    from uda_tpu_torch.utils import critpath
    from uda_tpu_torch.utils.flightrec import flightrec
    from uda_tpu_torch.utils.locks import lockdep
    from uda_tpu_torch.utils.metrics import device_trace
    from uda_tpu_torch.utils.profiler import profiler
    from uda_tpu_torch.utils.resledger import resledger
    from uda_tpu_torch.utils.stats import (StatsReporter,
                                           reporter_output_from_env)
    from uda_tpu_torch.utils.timeseries import disarm_observability_plane

    pairs = len(mids) - 1
    tmp = tempfile.mkdtemp(prefix="uda_obs_")
    jsonl = os.path.join(tmp, "stats.jsonl")
    xprof = os.path.join(tmp, "xprof")
    http_port = free_port()
    conf = dict(NET_CONF, **{
        "uda.tpu.stats.enable": True,
        "uda.tpu.stats.interval.ms": 250,
        "uda.tpu.stats.jsonl": jsonl,
        "uda.tpu.profile.hz": 97,
        "uda.tpu.flightrec.dir": os.path.join(tmp, "flightrec"),
        "uda.tpu.ts.interval.s": 0.25,
        "uda.tpu.anomaly.enable": True,
        "uda.tpu.metrics.http.port": http_port,
        "uda.tpu.tenant.enable": True,
        "uda.tpu.tenant.id": OBS_TENANT})
    env = {"UDA_TPU_RESLEDGER": "1", "UDA_TPU_LOCKDEP": "1",
           "UDA_TPU_XPROF": xprof}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    # the process-wide books read their switches at import: arm them here
    resledger.enabled = lockdep.enabled = True
    resledger.reset()
    lockdep.reset()
    set_current_tenant(OBS_TENANT)
    reporter: list = []
    polls: dict = {}

    def before_run(mm) -> None:
        metrics.enable_stats()  # drive_task's reset restored the default
        profiler.reset()
        flightrec.reset()
        reporter.append(StatsReporter(
            interval_s=Config(conf).get("uda.tpu.stats.interval.ms") / 1e3,
            out=reporter_output_from_env(jsonl)).start())

    def after_run(mm, host: str) -> None:
        # while the server still serves: the final record, the exported
        # spans, a windowed MSG_STATS poll and one scrape
        reporter[0].stop(final=True)
        polls["fetch_bytes"] = metrics.get("fetch.bytes")
        polls["spans"] = os.path.join(tmp, "spans.jsonl")
        metrics.export_spans_jsonl(polls["spans"])
        polls["stats"] = fetch_remote_stats(
            "127.0.0.1", int(host.rsplit(":", 1)[1]), window_s=30)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/metrics", timeout=30) as r:
            polls["scrape"] = r.read().decode()
        polls["profile"] = profiler.span_summary()
        polls["dump"] = flightrec.dump("phase16", extra={"phase": 16})

    try:
        res = net_task(dev, root, mids, conf, "16 observability",
                       before_run=before_run, after_run=after_run,
                       wrap=device_trace)
        leaks_end = resledger.drain("phase16.end")
    finally:
        profiler.stop()
        disarm_observability_plane()
        for r in reporter:
            r.stop(final=False)
        set_current_tenant("")
        resledger.enabled = lockdep.enabled = False
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    name = res["run"]
    require(res["error"] is None, f"[{name}] ended in {res['error']!r}")
    require((res["sha256"], res["stream_bytes"]) == want_c,
            f"[{name}] the stream differs from run c's: "
            f"{res['stream_bytes']} B, sha256 {res['sha256']}")
    launches = res["launches"]
    require(launches["merge_pass"] == pairs == launches["merge_partition"],
            f"[{name}] K1 launched {launches}, not {pairs} pairs")
    # the trace names K1's kernels as often as the counters say
    traces = sorted(glob.glob(os.path.join(xprof, "uda_trace_*.json")))
    require(len(traces) == 1, f"[{name}] device_trace wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    in_trace = {"merge_pass": sum("merge_pass_kernel" in k for k in kernels),
                "merge_partition": sum("merge_partition_kernel" in k
                                       for k in kernels)}
    require(in_trace == {k: launches[k] for k in in_trace},
            f"[{name}] the trace names {in_trace}, the counters say "
            f"{launches}")
    # the time partition of the task's spans
    with open(polls["spans"]) as f:
        spans = [json.loads(line) for line in f]
    ta = critpath.analyze(spans, root_name="reduce_task")
    require(ta is not None and ta["root"] == "reduce_task",
            f"[{name}] no reduce_task span among {len(spans)}")
    parted = sum(b["critical_s"] for b in ta["buckets"].values()) \
        + ta["idle_s"]
    require(abs(parted - ta["wall_s"]) <= 0.05 * ta["wall_s"],
            f"[{name}] buckets + idle {parted} s against the wall "
            f"{ta['wall_s']} s")
    # the reporter's final record
    with open(jsonl) as f:
        records = [json.loads(line) for line in f]
    final = records[-1] if records else {}
    lat = final.get("percentiles", {}).get("fetch.latency_ms", {})
    trio = ("total_wait_mem_time", "total_fetch_time", "total_merge_time")
    require(final.get("final") is True
            and all(k in final["counters"] for k in trio)
            and all(k in lat for k in ("p50", "p95", "p99")),
            f"[{name}] final record keys {sorted(final)}, "
            f"fetch.latency_ms {lat}")
    ring = (polls["stats"] or {}).get("timeseries", {})
    require(ring.get("running") is True and ring.get("samples", 0) > 0
            and "sli" in polls["stats"] and "anomalies" in polls["stats"],
            f"[{name}] MSG_STATS sections: ring {ring}")
    m = re.search(r"^uda_fetch_bytes_total (\S+)$", polls["scrape"], re.M)
    # the exposition prints values as the reference does ("%g": six
    # significant digits), so the scrape is held to fetch.bytes so printed
    require(m is not None and m.group(1) == f"{polls['fetch_bytes']:g}"
            and polls["fetch_bytes"] > 0,
            f"[{name}] the scrape's uda_fetch_bytes "
            f"{m and m.group(1)} against {polls['fetch_bytes']}")
    require(not resledger.leak_reports and not leaks_end,
            f"[{name}] resource ledger leaks: "
            f"{[(r['point'], r['pair']) for r in resledger.leak_reports]}")
    require(not lockdep.cycles,
            f"[{name}] lockdep cycles: {[c['note'] for c in lockdep.cycles]}")
    require(polls["dump"] is not None, f"[{name}] no flight-recorder dump")
    with open(polls["dump"]) as f:
        dump = json.load(f)
    require(dump["cause"] == "phase16" and any(
        e["kind"] == "segment.start" for e in dump["events"]),
        f"[{name}] dump events {[e['kind'] for e in dump['events']][:8]}")
    prof = polls["profile"].get("reduce_task", {})
    require(prof.get("total", 0) > 0,
            f"[{name}] no profiler samples under reduce_task: "
            f"{polls['profile']}")
    # the card's busy share of the run, from the trace's own clock
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0_us = min(e["ts"] for e in host) if host else 0.0
    t1_us = t0_us + res["wall_s"] * 1e6
    busy_us = trace_device_busy(events, t0_us, t1_us)
    out = {"run": name, "wall_s": res["wall_s"],
           "idle_share": 1.0 - busy_us / (res["wall_s"] * 1e6),
           "device_busy_ms": busy_us / 1e3, "launches": launches,
           "trace_kernels": in_trace, "peak_bytes": res["peak_bytes"],
           "wall_12a_s": wall_12a,
           "overhead_vs_12a": res["wall_s"] / wall_12a - 1.0,
           "reporter_records": len(records), "ring_samples":
               ring.get("samples"), "flightrec_events": len(dump["events"]),
           "profile_samples": prof, "spans": len(spans),
           "trace_bytes": os.path.getsize(traces[0])}
    log(f"[16 observability] wall {res['wall_s']:.3f} s, idle share "
        f"{out['idle_share']:.6f}")
    log("[16 critpath] " + json.dumps(
        {"wall_s": ta["wall_s"], "idle_s": ta["idle_s"],
         "critical_s": {b: v["critical_s"] for b, v in ta["buckets"].items()},
         "busy_s": {b: v["busy_s"] for b, v in ta["buckets"].items()},
         "critical_path": [c["name"] for c in ta["critical_path"]],
         "trio": ta["trio"]}))
    log(f"[16 overhead] {res['wall_s']:.3f} s against 12a's "
        f"{wall_12a:.3f} s in this call: {out['overhead_vs_12a']:+.3f}")
    log("[16 observability] " + json.dumps(out))
    return out


# --------------------------------------------------------------- phase 15
def card_mesh(dev: torch.device, slots: int = MESH_SLOTS):
    """The 8-slot mesh over the one card: ``devices`` names it once a
    slot (never a default of ``make_mesh``)."""
    return make_mesh(slots, devices=[dev] * slots)


def mesh_run(name: str, fn, profiled: bool = False) -> tuple:
    """``fn()`` with ``metrics``, the launch counts and the peak memory
    reset just before and read just after (a synchronise at the end),
    under ``torch.profiler`` with ``profiled``. Returns (its result, the
    record: wall, launches, peak bytes, exchange counters, and with
    ``profiled`` the device's busy ms and idle share)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics.reset()
    _build.reset_launches()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = {"run": name, "wall_s": wall,
           "launches": {k: _build.launches[k] for k in KERNELS},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "exchange": {k: v for k, v in metrics.snapshot().items()
                        if k.startswith("exchange.")}}
    if profiled:
        by_name, busy = device_time(prof)
        top: dict = {}
        for k, v in by_name.items():        # names cut to 60 characters
            top[k[:60]] = top.get(k[:60], 0.0) + v
        rec.update(device_busy_ms=busy, idle_share=(
            1.0 - busy / (wall * 1e3) if by_name else None),
            device_ms_by_kernel=dict(sorted(top.items(),
                                            key=lambda kv: -kv[1])[:6]))
    return out, rec


def require_mesh_kernels(rec: dict) -> None:
    """K2, K1 and the partition kernel launched in the run (each slot's
    local sort under keys8)."""
    require(all(rec["launches"][k] > 0 for k in MESH_KERNELS),
            f"[{rec['run']}] a kernel of {MESH_KERNELS} never launched "
            f"{rec['launches']}")


def hold_to_single_chip(res, want: torch.Tensor, what: str) -> None:
    """Slot by slot, the valid rows equal the matching rows of the
    single-chip stable sort ``want`` (on the device), no bucket
    overflowed, and every slot's rows are in order."""
    require(res.overflow() == 0, f"[{what}] overflow {res.overflow()}")
    off = 0
    for k in range(len(res.words)):
        rows = res.valid_rows(k)
        require(rows.device == want.device,
                f"[{what}] slot {k} landed on {rows.device}")
        terasort.validate_sorted(rows)
        require(same(rows, want[off:off + rows.shape[0]]),
                f"[{what}] slot {k}'s rows differ from the single-chip "
                f"sort's rows {off}..{off + rows.shape[0]}")
        off += rows.shape[0]
    require(off == want.shape[0], f"[{what}] {off} valid rows of "
            f"{want.shape[0]}")


def phase_mesh_terasort(words: torch.Tensor) -> dict:
    """Phase 15a: ``distributed_terasort`` of phase 4's 10^8 records over
    the 8-slot mesh on the card (uniform splitters, the default capacity
    2n/64), "auto" resolving to keys8 (3 keys and the invalid flag are 4
    key rows), under ``torch.profiler``; held slot
    by slot to the single-chip stable sort, kept on the device (it is
    computed first, so the peak holds the input, it and the mesh's
    buffers). Slot 0's keys8 input (3 key words and the flag over 2^25
    lanes) is kept as the run hands it to ``keys8_sort_perm``; after the
    run K2, K1 and the partition kernel are held on it, launch by launch,
    against their plain versions."""
    dev = words.device
    mesh = card_mesh(dev)
    n = int(words.shape[0])
    auto = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev,
                                 key_rows=terasort.KEY_WORDS + 1)
    require(auto == "keys8", f'"auto" resolved to {auto!r}, not keys8')
    slot_keys: list = []
    keys8_sort_perm = pallas_sort.keys8_sort_perm

    def keeping_slot0(keyrows, *args, **kwargs):
        if not slot_keys:
            slot_keys.append(keyrows)       # never written after this call
        return keys8_sort_perm(keyrows, *args, **kwargs)

    want = yardstick(words)
    pallas_sort.keys8_sort_perm = keeping_slot0
    try:
        res, rec = mesh_run("15a terasort", lambda: terasort.
                            distributed_terasort(words, mesh),
                            profiled=True)
    finally:
        pallas_sort.keys8_sort_perm = keys8_sort_perm
    require_mesh_kernels(rec)
    hold_to_single_chip(res, want, "15a")
    rec.update(n=n, slots=MESH_SLOTS, engine=auto,
               capacity=max(1, 2 * n // MESH_SLOTS ** 2),
               valid_rows=[int(v[0]) for v in res.valid_counts],
               yardstick="on the device")
    del res, want
    rec["max_abs_err"] = check_slot_cascade(slot_keys.pop())
    log("[15a terasort] " + json.dumps(rec))
    return rec


def check_slot_cascade(keyrows: torch.Tensor) -> dict:
    """K2, K1 and the partition kernel on one slot's keys8 input, laid
    out as ``keys8_sort_perm`` lays it (8 rows, the arrival index in row
    7, tile 1024), each launch held against its plain version; the
    largest error of each (tolerance 0)."""
    k, m = keyrows.shape
    mat8 = u32(torch.cat([i32(keyrows),
                          i32(fill_words((8 - k, m), keyrows.device))]))
    errs = check_cascade(mat8, k, 7, MAIN_TILE, False)
    require(all(v == 0 for v in errs.values()),
            f"[15a] a kernel differs from its plain version on slot 0's "
            f"keys8 input: {errs}")
    log(f"[15a] slot 0's keys8 input [8, {m}], {k} key rows, tile "
        f"{MAIN_TILE}: max_abs_err against the plain versions {errs} "
        f"(tolerance 0); cascade equal to the stable sort")
    return errs


def skewed_words(dev: torch.device) -> torch.Tensor:
    """``MESH_N`` TeraSort records whose first key word sends every other
    one into the first destination range of 8 uniform splitters ([0,
    2^29))."""
    words = terasort.teragen(generator(SEED + 15, dev), MESH_N)
    i32(words)[::2, 0] &= (1 << 29) - 1
    return words


def cpu_counters(words: torch.Tensor, mesh_cpu, fn) -> tuple:
    """The port's CPU run of ``fn(words, mesh)`` on 8 CPU slots: its
    valid rows (numpy) and exchange counters."""
    cpu = u32(i32(words).cpu())
    metrics.reset()
    res = fn(cpu, mesh_cpu)
    counters = {k: v for k, v in metrics.snapshot().items()
                if k.startswith("exchange.")}
    rows = np.concatenate([interop.words_to_numpy(res.valid_rows(k))
                           for k in range(len(res.words))])
    return rows, counters


def phase_mesh_paths(dev: torch.device) -> dict:
    """Phases 15b-15e on the 8-slot mesh over the card, each run with the
    counts reset just before and read just after."""
    runs: dict = {}
    cpu8 = make_mesh(MESH_SLOTS, device="cpu")
    # 15b: skew through the multiround path
    with phase_seconds("15b skew"):
        words = skewed_words(dev)
        want = yardstick(words)
        mesh = card_mesh(dev)
        res, rec = mesh_run("15b skew", lambda: terasort.
                            distributed_terasort(words, mesh))
        require_mesh_kernels(rec)
        hold_to_single_chip(res, want, "15b")
        ex = rec["exchange"]
        require(ex.get("exchange.rounds", 0) >= 2,
                f"[15b] the fused attempt did not overflow into the "
                f"windowed rounds: {ex}")
        cpu_rows, cpu_ex = cpu_counters(
            words, cpu8, lambda w, m: terasort.distributed_terasort(w, m))
        for k in ("exchange.rounds", "exchange.rounds.skipped"):
            require(ex.get(k, 0) == cpu_ex.get(k, 0),
                    f"[15b] {k}: card {ex.get(k, 0)}, CPU {cpu_ex.get(k, 0)}")
        require(np.array_equal(cpu_rows, interop.words_to_numpy(want)),
                "[15b] the CPU slots' rows differ from the card's sort")
        skew_out = [res.valid_rows(k).clone() for k in range(len(res.words))]
        rec.update(n=MESH_N, capacity=max(1, 2 * MESH_N // 64),
                   valid_rows=[int(v[0]) for v in res.valid_counts],
                   cpu_exchange=cpu_ex)
        log("[15b skew] " + json.dumps(rec))
        runs["15b"] = rec
        del res, want
    # 15c: flat, hierarchical and coded on dcn:2,ici:4
    with phase_seconds("15c pod exchange"):
        pod = mesh_from_config(Config({"uda.tpu.mesh.shape":
                                       MESH_POD_SHAPE}),
                               devices=[dev] * MESH_SLOTS)
        pod_cpu = mesh_from_config(Config({"uda.tpu.mesh.shape":
                                           MESH_POD_SHAPE}),
                                   devices=["cpu"] * MESH_SLOTS)
        uni = terasort.teragen(generator(SEED + 16, dev), MESH_POD_N)
        want = yardstick(uni)
        cap = max(1, 2 * MESH_POD_N // MESH_SLOTS ** 2)
        outs = {}
        for mode in MESH_MODES:
            def run(w, m, mode=mode):
                return distributed_sort_step(
                    w, uniform_splitters(MESH_SLOTS), m, ("dcn", "ici"),
                    cap, terasort.KEY_WORDS, multiround="always",
                    exchange_mode=mode)

            res, rec = mesh_run(f"15c {mode}", lambda: run(uni, pod))
            require_mesh_kernels(rec)
            hold_to_single_chip(res, want, f"15c {mode}")
            outs[mode] = [res.valid_rows(k) for k in range(len(res.words))]
            _, cpu_ex = cpu_counters(uni, pod_cpu, run)
            for k in ("exchange.dcn.messages", "exchange.dcn.coded.bytes",
                      "exchange.dcn.saved.bytes"):
                require(rec["exchange"].get(k, 0) == cpu_ex.get(k, 0),
                        f"[15c {mode}] {k}: card "
                        f"{rec['exchange'].get(k, 0)}, CPU "
                        f"{cpu_ex.get(k, 0)}")
            rec.update(n=MESH_POD_N, capacity=cap, mesh=MESH_POD_SHAPE)
            log(f"[15c {mode}] " + json.dumps(rec))
            runs[f"15c {mode}"] = rec
        require(all(same(a, b) for mode in MESH_MODES[1:]
                    for a, b in zip(outs["flat"], outs[mode])),
                "[15c] the three modes' outputs differ")
        require(runs["15c coded"]["exchange"].get(
            "exchange.dcn.coded.bytes", 0) > 0, "[15c] no window coded")
        del outs, want, uni
    # 15d: a job across the mesh
    with phase_seconds("15d job"):
        runs["15d"] = phase_mesh_job(dev)
    # 15e: the multi-process backend on the card, world size 1
    with phase_seconds("15e nccl"):
        runs["15e"] = phase_mesh_nccl(dev, words, skew_out)
    return runs


def phase_mesh_job(dev: torch.device) -> dict:
    """Phase 15d: 14b's Sort job (64k records of 10 B keys and 90 B
    values, 8 maps, 4 reducers) with ``mesh=`` the 8-slot mesh:
    ``run_reduces_mesh`` -> ``exchange_blobs`` -> ``ExchangeFetchClient``
    -> ``MergeManager`` -> K1; its outputs equal the same job without
    ``mesh=``, byte for byte."""
    rng = np.random.default_rng(SEED + 12)
    records = [(rng.bytes(10), rng.bytes(90)) for _ in range(SORT_RECORDS)]
    splits = [records[m::WC_MAPS] for m in range(WC_MAPS)]
    mesh = card_mesh(dev)

    def job(work, m):
        return MapReduceJob(
            "sortjob", sort_job._mapper, sort_job._reducer,
            key_type="org.apache.hadoop.io.BytesWritable",
            num_reducers=WC_REDUCERS, work_dir=work, device=dev
        ).run(splits, mesh=m)

    with tempfile.TemporaryDirectory(prefix="uda_job_") as work:
        local = job(work, None)
    with tempfile.TemporaryDirectory(prefix="uda_job_") as work:
        got, rec = mesh_run("15d sort job", lambda: job(work, mesh))
        rec["mesh_shuffle_s"] = metrics.get("mesh_shuffle_time")
    require(got == local, "[15d] the job across the mesh differs from the "
            "same job without mesh=")
    require_k1(dict(rec, job="15d sort job"), WC_REDUCERS * (WC_MAPS - 1))
    rec.update(records=SORT_RECORDS, maps=WC_MAPS, reducers=WC_REDUCERS)
    log("[15d job] " + json.dumps(rec))
    return rec


def phase_mesh_nccl(dev: torch.device, words: torch.Tensor,
                    want: list) -> dict:
    """Phase 15e: a world-size-1 NCCL group (127.0.0.1, any free port)
    with 8 local slots runs 15b's words through ``distributed_sort_step``
    (every all-to-all and gather through ``torch.distributed``); each
    slot's rows equal 15b's. The group is destroyed after."""
    import torch.distributed as dist

    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=dev,
                         timeout_s=120)
    try:
        mesh = multihost.global_mesh(devices=[dev] * MESH_SLOTS)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        require(mesh.distributed and dist.get_backend() == backend,
                f"[15e] backend {dist.get_backend()}, not {backend}")
        n = int(words.shape[0])
        res, rec = mesh_run("15e nccl", lambda: distributed_sort_step(
            words, uniform_splitters(MESH_SLOTS), mesh, "shuffle",
            max(1, 2 * n // MESH_SLOTS ** 2), terasort.KEY_WORDS))
        require_mesh_kernels(rec)
        require(all(same(res.valid_rows(k), want[k])
                    for k in range(MESH_SLOTS)),
                "[15e] the NCCL group's rows differ from 15b's")
    finally:
        dist.destroy_process_group()
    rec.update(backend=backend, world_size=1, slots=MESH_SLOTS, n=n)
    log("[15e nccl] " + json.dumps(rec))
    return rec


# --------------------------------------------------------------- phase 17
def phase_dryrun(dev: torch.device, sizes=DRYRUN_SIZES) -> dict:
    """Phase 17a: the dry run on the card at each slot count, held case by
    case and slot by slot to the dry run on CPU slots. K2 launches at
    every size (the lanes engines' slots); K1 and its partition kernel
    once a slot's p x 128 rows pass one tile (16 slots and up, or where a
    tile is sorted as sub-tiles), so the phase requires each kernel over
    its sizes."""
    out = {}
    for n in sizes:
        card, cpu = {}, {}
        acct, rec = mesh_run(f"17a {n}", lambda: graft_entry.dryrun_multichip(
            n, device=dev, slots_out=card))
        require(rec["launches"]["tile_sort"] > 0,
                f"[17a {n}] K2 never launched {rec['launches']}")
        t0 = time.perf_counter()
        cpu_acct = graft_entry.dryrun_multichip(n, device="cpu",
                                                slots_out=cpu)
        rec["cpu_s"] = time.perf_counter() - t0
        require(acct == cpu_acct, f"[17a {n}] accounting {acct} differs "
                                  f"from the CPU slots' {cpu_acct}")
        require(sorted(card) == sorted(cpu), f"[17a {n}] cases differ")
        for label, slots in card.items():
            require(len(slots) == n == len(cpu[label]),
                    f"[17a {n}] {label}: {len(slots)} slots")
            for k, rows in enumerate(slots):
                require(np.array_equal(rows, cpu[label][k]),
                        f"[17a {n}] {label}: slot {k} differs from the "
                        f"CPU slots' run")
        rec["accounting"] = acct
        out[n] = rec
        log(f"[17a dryrun {n} slots] card {rec['wall_s']:.3f} s, CPU slots "
            f"{rec['cpu_s']:.3f} s, launches K2 {rec['launches']['tile_sort']}"
            f" K1 {rec['launches']['merge_pass']} partition "
            f"{rec['launches']['merge_partition']}, peak "
            f"{rec['peak_bytes']} B, {len(card)} cases equal slot by slot")
    require_mesh_kernels({"run": "17a", "launches": {
        k: sum(r["launches"][k] for r in out.values()) for k in KERNELS}})
    return out


def pair_runs(dev: torch.device, n: int = PAIR_RUN_LEN) -> tuple:
    """Two sorted runs shaped as phase 8's merge-tree rows (4 key words,
    the length, the segment, the row index: 7 words), keys drawn from 16
    values a word so equal keys meet across the runs."""
    gen = generator(SEED + 17, dev)
    runs = []
    for seg in range(2):
        keys = torch.randint(0, 16, (n, 4), dtype=torch.int32,
                             generator=gen, device=dev)
        order = sort_ops.stable_lex_argsort(
            [u32(keys[:, c].contiguous()) for c in range(4)])
        rows = torch.empty((n, 7), dtype=torch.int32, device=dev)
        rows[:, :4] = keys[order]
        rows[:, 4] = 10
        rows[:, 5] = seg
        rows[:, 6] = order.to(torch.int32)
        runs.append(u32(rows))
    return tuple(runs)


def phase_pair_forms(dev: torch.device, n: int = PAIR_RUN_LEN) -> dict:
    """Phase 17b: merge_sorted_pair's keys8, two_phase and default forms
    at phase 8's largest K1 class, against K1's plain version and a
    stable re-sort."""
    a, b = pair_runs(dev, n)
    w = a.shape[1]
    cat = torch.cat([i32(a), i32(b)])
    want = u32(cat[sort_ops.stable_lex_argsort(
        [u32(cat[:, c].contiguous()) for c in range(PAIR_KEYS)])])
    L = pallas_merge.pair_run_len(n, n, MERGE_TILE)
    plain = u32(i32(pallas_sort.merge_pass_plain(
        pallas_merge.pack_pair(a, b, L), L, MERGE_TILE, PAIR_KEYS, w)
    )[:w, :2 * n].T.contiguous())
    require(same(plain, want), "[17b] K1's plain version differs from the "
                               "stable re-sort")
    del cat
    out = {}
    for form, kw in PAIR_FORMS:
        torch.cuda.synchronize()
        _build.reset_launches()
        got = pallas_merge.merge_sorted_pair(a, b, PAIR_KEYS, **kw)
        torch.cuda.synchronize()
        launches = {k: _build.launches[k]
                    for k in ("merge_pass", "merge_partition")}
        require(launches["merge_pass"] == 1
                and launches["merge_partition"] >= 1,
                f"[17b {form}] K1 launches {launches}")
        err = max_abs_err(got, plain)
        require(err == 0 and same(got, want),
                f"[17b {form}] differs from the plain version "
                f"(max_abs_err {err})")
        del got
        out[form] = {"launches": launches, "max_abs_err": err,
                     "device_ms": device_ms(
                         lambda: pallas_merge.merge_sorted_pair(
                             a, b, PAIR_KEYS, **kw), reps=3)}
    base = out["default"]["device_ms"]
    for form, rec in out.items():
        log(f"[17b pair {form}] {n} + {n} rows x {w} words, "
            f"{PAIR_KEYS} keys: {rec['device_ms']:.3f} device ms "
            f"(default {base:.3f}), launches {rec['launches']}, "
            f"max_abs_err {rec['max_abs_err']} (tolerance 0)")
    return out


# --------------------------------------------------------------- phase 18
NATIVE_PAIRS = 2            # 18c: native on / off, in turns
NATIVE_ROWS = 1 << 20       # 18b: rows a side of the row merge
NATIVE_ROW_COLS = 7         # 18b: phase 8's rows (4 key words + 3)
KWAY_CLASSES = {            # 18b: the 11 key types of the loser tree's table
    "raw": "uda.tpu.RawBytes",
    "boolean": "org.apache.hadoop.io.BooleanWritable",
    "byte": "org.apache.hadoop.io.ByteWritable",
    "short": "org.apache.hadoop.io.ShortWritable",
    "int": "org.apache.hadoop.io.IntWritable",
    "long": "org.apache.hadoop.io.LongWritable",
    "text": "org.apache.hadoop.io.Text",
    "bytes": "org.apache.hadoop.io.BytesWritable",
    "ibytes": "org.apache.hadoop.hbase.io.ImmutableBytesWritable",
    "int_numeric": "uda.tpu.IntNumeric",
    "long_numeric": "uda.tpu.LongNumeric",
}


def kway_keys(name: str, rng, n: int) -> list:
    """``n`` serialized keys of key type ``name``, with repeats."""
    keys = []
    for i in range(n):
        r = int(rng.integers(0, 40))
        if name in ("boolean", "byte"):
            k = bytes([r])
        elif name == "short":
            k = int(rng.integers(0, 1 << 16)).to_bytes(2, "big")
        elif name in ("int", "int_numeric"):
            k = int(rng.integers(0, 1 << 32)).to_bytes(4, "big")
        elif name in ("long", "long_numeric"):
            k = int(rng.integers(0, 1 << 63)).to_bytes(8, "big")
        elif name == "text":
            body = rng.bytes(r % 12)
            k = vint.encode_vlong(len(body)) + body
        elif name in ("bytes", "ibytes"):
            body = rng.bytes(r % 12)
            k = len(body).to_bytes(4, "big") + body
        else:
            k = rng.bytes(r % 12)
        keys.append(keys[0] if keys and r < 6 else k)
    return keys


def host_s(fn):
    """(fn's result, its host seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def python_form(fn):
    """``fn()`` with ``uda.tpu.use.native`` off (the pure-Python forms)."""
    set_native_enabled(False)
    try:
        return fn()
    finally:
        set_native_enabled(True)


def partition_bytes_of(root: str, mid: str) -> bytes:
    rec = DirIndexResolver(root).resolve(MERGE_JOB, mid, 0)
    with open(rec.path, "rb") as f:
        f.seek(rec.start_offset)
        return f.read(rec.part_length)


def phase_crc_trailer(root: str, mid: str) -> dict:
    """Phase 18f: one of run c's MOF partitions written again with the IFile
    CRC trailer (``IFileWriter(with_crc=True)``) and cracked by the native
    crack with ``verify_crc``: the same records, the trailer the CRC32 of
    everything before it; a flipped value byte and a missing trailer raise
    the reference's ``StorageError`` messages. Host work only."""
    require(native_enabled(), "[18f] uda.tpu.use.native is off")
    batch = crack(partition_bytes_of(root, mid))
    out = io.BytesIO()
    w = IFileWriter(out, with_crc=True)
    for k, v in batch.iter_records():
        w.append(k, v)
    w.close()
    raw = out.getvalue()
    trailer = raw[-4:]
    require(w.bytes_written == len(raw)
            and int.from_bytes(trailer, "big") == zlib.crc32(raw[:-4]),
            "[18f] the trailer is not the CRC32 of the segment")
    native.reset_calls()
    got = crack(raw, verify_crc=True)
    calls = dict(native.calls)
    require(calls.get("crack", 0) >= 1, f"[18f] no native crack: {calls}")
    require(got.num_records == batch.num_records
            and all(np.array_equal(getattr(got, c), getattr(batch, c))
                    for c in ("key_off", "key_len", "val_off", "val_len")),
            "[18f] the trailed segment cracks to other records")
    flipped = bytearray(raw)
    flipped[-8] ^= 1  # a value byte of the last record
    raised = {}
    for what, buf in (("flipped", bytes(flipped)),
                      ("missing", raw[:-4])):
        try:
            crack(buf, verify_crc=True)
        except StorageError as e:
            raised[what] = str(e)
    require("CRC mismatch" in raised.get("flipped", "")
            and "missing CRC trailer" in raised.get("missing", ""),
            f"[18f] the CRC checks did not raise as the reference's: {raised}")
    res = {"map": mid, "bytes": len(raw), "records": got.num_records,
           "trailer": trailer.hex(), "native_calls": calls,
           "raised": raised}
    log("[18f crc trailer] " + json.dumps(res))
    return res


def phase_native_codec(root: str, mids: list) -> dict:
    """Phase 18b: each native entry point against the port's Python form
    on the card's host."""
    out = collections.Counter()
    records = 0
    cat = None
    for mid in mids:
        data = partition_bytes_of(root, mid)
        nb, t = host_s(lambda: native.crack_native(data))
        out["crack_native_s"] += t
        pb, t = host_s(lambda: python_form(lambda: crack(data)))
        out["crack_python_s"] += t
        require(all(np.array_equal(getattr(nb, c), getattr(pb, c))
                    for c in ("key_off", "key_len", "val_off", "val_len")),
                f"[18b] {mid}: the native crack differs from Python's")
        framed, t = host_s(lambda: native.write_records_native(nb))
        out["write_records_native_s"] += t
        framed_py, t = host_s(lambda: frame_batch(pb))
        out["frame_batch_python_s"] += t
        require(framed == framed_py == data and
                native.frame_batch(nb) == data,
                f"[18b] {mid}: the framers differ from the MOF's bytes")
        records += nb.num_records
        if cat is None:
            cat = nb
    res = {k: float(v) for k, v in out.items()}
    res.update(maps=len(mids), records=records,
               crack_us_a_record={
                   "native": res["crack_native_s"] / records * 1e6,
                   "python": res["crack_python_s"] / records * 1e6},
               frame_us_a_record={
                   "native": res["write_records_native_s"] / records * 1e6,
                   "python": res["frame_batch_python_s"] / records * 1e6})
    kway = {}
    rng = np.random.default_rng(SEED + 18)
    with tempfile.TemporaryDirectory(prefix="uda_kway_") as spill:
        for name, cls in KWAY_CLASSES.items():
            kt = get_key_type(cls)
            require(kt.name == name and native.kway_supported(kt),
                    f"[18b] {cls} is not the loser tree's {name}")
            paths = []
            for r in range(4):
                recs = [(k, rng.bytes(int(rng.integers(0, 60))))
                        for k in kway_keys(name, rng, 0 if r == 0 else 500)]
                recs.sort(key=lambda kv: kt.content(kv[0]))
                path = os.path.join(spill, f"{name}-{r}")
                with open(path, "wb") as f:
                    f.write(write_records(recs))
                paths.append(path)
            got, t_native = host_s(lambda: b"".join(
                native.kway_merge_paths(paths, kt, block_bytes=4096)))
            heap, t_heap = host_s(lambda: write_records(
                merge_ops.merge_record_streams(
                    [iter_file_records(p) for p in paths], kt)))
            require(got == heap, f"[18b] the loser tree differs from the "
                                 f"heap merge on {name}")
            kway[name] = {"bytes": len(got), "native_ms": t_native * 1e3,
                          "heap_ms": t_heap * 1e3}
    res["kway"] = kway
    a = row_run(rng, NATIVE_ROWS)
    b = row_run(rng, NATIVE_ROWS)
    want, t = host_s(lambda: native.merge_rows_native(a, b))
    lex, t_lex = host_s(lambda: merge_ops.merge_row_pair(
        a, b, len(a), len(b), "host"))
    require(np.array_equal(want, lex),
            "[18b] the native row merge differs from the lexsort engine")
    split = {"merge_rows_native_ms": t * 1e3, "lexsort_ms": t_lex * 1e3}
    for parts in (1, 2, 3, 4):
        got = np.empty_like(want)
        _, t = host_s(lambda: merge_ops.merge_rows_split_into(a, b, got,
                                                              parts))
        require(np.array_equal(got, want),
                f"[18b] merge_rows_split_into with {parts} parts differs")
        split[f"parts_{parts}_ms"] = t * 1e3
    res["merge_rows"] = split
    res["gather"] = gather_times(cat)
    log("[18b native codec] " + json.dumps(res))
    return res


def row_run(rng, n: int) -> np.ndarray:
    """A sorted uint32[n, NATIVE_ROW_COLS] run with many equal rows."""
    rows = rng.integers(0, 4, (n, NATIVE_ROW_COLS)).astype(np.uint32)
    rows[:, 0] = rng.integers(0, 1 << 16, n)
    order = np.lexsort(tuple(rows[:, c] for c in range(NATIVE_ROW_COLS - 1,
                                                       -1, -1)))
    return np.ascontiguousarray(rows[order])


def phase_native_pairs(dev: torch.device, root: str, mids: list,
                       part_bytes: int, want_c: tuple) -> list:
    """Phase 18c: phase 12a's task with the native host runtime on and off,
    in turns."""
    runs = []
    try:
        for i in range(NATIVE_PAIRS):
            for flag in (True, False):
                name = f"18c {'on' if flag else 'off'} {i}"
                conf = dict(NET_CONF, **{"uda.tpu.use.native": flag})
                res = net_task(dev, root, mids, conf, name, profiled=True)
                snap = res["metrics"]
                rec = _net_report(res, part_bytes, want_c, len(mids) - 1,
                                  ("fetch_time", "merge_time"), {
                                      "native": flag,
                                      "emit_and_rest_s": res["wall_s"]
                                      - snap.get("fetch_time", 0.0)
                                      - snap.get("merge_time", 0.0)})
                runs.append(rec)
    finally:
        set_native_enabled(True)
    return runs


def phase_native_hybrid(dev: torch.device, root: str, mids: list,
                        part_bytes: int, want_c: tuple) -> dict:
    """Phase 18d: phase 10a's hybrid task with the native host runtime on
    (spill framing and the RPQ's loser tree in C++) and off."""
    runs = {}
    try:
        for flag in (True, False):
            with tempfile.TemporaryDirectory(prefix="uda_lpq_") as spill:
                conf = {"mapred.netmerger.merge.approach": 2,
                        "mapred.netmerger.hybrid.lpq.size": HYBRID_LPQ_MAPS,
                        "mapred.rdma.num.parallel.lpqs": HYBRID_PARALLEL,
                        "uda.tpu.spill.dirs": spill,
                        "uda.tpu.use.native": flag}
                name = f"18d hybrid {'on' if flag else 'off'}"
                res = task_run(dev, root, mids, conf, name)
                _require_stream(res, want_c)
                if flag:
                    require(res["native_calls"].get("kway_create", 0) == 1,
                            f"[{name}] the RPQ did not run the loser tree")
                runs["on" if flag else "off"] = _report(
                    res, part_bytes, ("lpq_phase_time", "lpq_spill_time",
                                      "rpq_phase_time", "fetch_time",
                                      "merge_time"))
    finally:
        set_native_enabled(True)
    return runs


def phase_native_io(root: str, mids: list) -> dict:
    """Phase 18e: the read pool's backend, a batched read on the io_uring
    rung against preadv, and the LZO ladder's builtin rung."""
    with native.ReadPool(2) as pool:
        backend = pool.backend()
    chunk = 1 << 20
    served = {}
    for want in ("io_uring", "preadv"):
        engine = DataEngine(DirIndexResolver(root),
                            Config({"uda.tpu.read.backend": want}))
        try:
            native.reset_calls()
            reqs = [ShuffleRequest(MERGE_JOB, mid, 0, off, chunk)
                    for mid in mids for off in range(0, min(
                        4 * chunk, engine.resolver.resolve(
                            MERGE_JOB, mid, 0).part_length), chunk)]
            (data, t) = host_s(lambda: [f.result(timeout=120).data
                                        for f in engine.submit_batch(reqs)])
            served[want] = {"rung": engine.io_backend, "requests": len(reqs),
                            "bytes": sum(len(d) for d in data),
                            "sha256": hashlib.sha256(b"".join(
                                bytes(d) for d in data)).hexdigest(),
                            "host_s": t,
                            "native_calls": dict(native.calls)}
        finally:
            engine.stop()
    require(served["io_uring"]["sha256"] == served["preadv"]["sha256"],
            "[18e] the io_uring rung served other bytes than preadv")
    require(served["io_uring"]["rung"] == ("io_uring"
                                           if backend == "io_uring"
                                           else "preadv"),
            f"[18e] the ladder took {served['io_uring']['rung']} with the "
            f"pool on {backend}")
    if backend == "io_uring":
        require(served["io_uring"]["native_calls"].get(
            "pool_submit_batch", 0) > 0, "[18e] no batch entered the ring")
    part = tera_partitions(SEED + 18, 1, LZO_MAP_BYTES)[0]
    raw = part.tobytes() + EOF_MARKER
    source = native_lzo_source()
    codec = get_codec("lzo")
    comp, t_comp = host_s(lambda: codec.compress(raw))
    back, t_py = host_s(lambda: lzo1x_decompress_py(comp, len(raw)))
    require(back == raw, "[18e] the builtin LZO stream does not decode")
    res = {"pool_backend": backend, "batched_read": served,
           "lzo": {"rung": source, "raw_bytes": len(raw),
                   "compressed_bytes": len(comp),
                   "ratio": len(comp) / len(raw),
                   "compress_s": t_comp, "decode_python_s": t_py}}
    require(source in ("liblzo2", "builtin"),
            f"[18e] the LZO ladder is on {source!r}, not a native rung")
    log("[18e native io] " + json.dumps(res))
    return res


def phase_native(dev: torch.device, root: str, build: dict,
                 want_c: tuple, c_maps: int = OVERLAP_C_MAPS) -> dict:
    """Phase 18 on phase 8's tree (run c's maps, stream ``want_c``)."""
    path, secs = _build_host.build_native()
    require(path == build["native_path"] and secs < 1.0,
            f"[18a] a second build took {secs:.2f} s ({path})")
    res = {"build": {"first_s": build["native_s"], "second_s": secs}}
    log("[18a native build] " + json.dumps(res["build"]))
    mids = [map_id(m) for m in range(c_maps)]
    resolver = DirIndexResolver(root)
    part_bytes = sum(resolver.resolve(MERGE_JOB, m, 0).part_length
                     for m in mids)
    with phase_seconds("18b native codec"):
        res["codec"] = phase_native_codec(root, mids)
    with phase_seconds("18c native pairs"):
        res["pairs"] = phase_native_pairs(dev, root, mids, part_bytes,
                                          want_c)
    with phase_seconds("18d native hybrid"):
        res["hybrid"] = phase_native_hybrid(dev, root, mids, part_bytes,
                                            want_c)
    with phase_seconds("18e native io"):
        res["io"] = phase_native_io(root, mids)
    with phase_seconds("18f crc trailer"):
        res["crc"] = phase_crc_trailer(root, mids[0])
    return res


# ---------------------------------------------------------------- phase 19
PROBE_KERNELS = ("tile_sort", "merge_pass", "merge_partition",
                 "tile_sort_folded", "merge_pass_folded")   # K1-K4
CONSOLE_CONF = {"uda.tpu.stats.enable": True, "uda.tpu.ts.interval.s": 0.1}
REPO = os.path.dirname(os.path.abspath(__file__))


def tool_run(main, argv: list, echo: bool = True) -> tuple:
    """(exit code, standard output) of a tool's ``main(argv)``; with
    ``echo`` its lines are logged."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        for line in buf.getvalue().splitlines() if echo else ():
            log(f"  {line}")
    return rc, buf.getvalue()


def phase_probe(dev: torch.device, smi: str) -> dict:
    """Phase 19a: ``tools.tune_probe`` at full size, both domains, into a
    temporary cache, the launch counts reset just before and read just
    after; every key measured, all eight engines timed for lanes-capable
    callers; a second run probes nothing; "auto" under the cache routes to
    the crowned engine and equals the yardstick at 2^20 rows; at 2^16 rows
    whether the small-batch rule overrode a faster winner is reported
    (the rule is not changed)."""
    small_n, big_n = tune_probe.SIZES
    with tempfile.TemporaryDirectory(prefix="uda_probe_") as d:
        path = os.path.join(d, "tune.json")
        _build.reset_launches()
        t0 = time.perf_counter()
        rc, _ = tool_run(tune_probe.main, ["--cache", path])
        probe_s = time.perf_counter() - t0
        launches = dict(_build.launches)
        require(rc == 0, f"[19a] tune_probe exited {rc}")
        missing = [k for k in PROBE_KERNELS if not launches.get(k)]
        require(not missing, f"[19a] tune_probe launched no {missing}: "
                             f"{launches}")
        entries = tuncache.TuneCache(path).entries()
        keys = [sort_key(n, lanes, dev) for n in tune_probe.SIZES
                for lanes in (0, 1)]
        want = [f"sort.engine|{k}" for k in keys] + [f"io.read|{sys.platform}"]
        require(sorted(entries) == sorted(want),
                f"[19a] cache keys {sorted(entries)}, want {sorted(want)}")
        table = {}
        for key in keys:
            rec = entries[f"sort.engine|{key}"]
            times = rec["winner"]["times_s"]
            if key.endswith("lanes1"):
                require(set(times) == set(sort_ops.ALL_SORT_PATHS),
                        f"[19a] {key} timed {sorted(times)}")
            bad = {p: t for p, t in times.items() if not isinstance(t, float)}
            require(not bad, f"[19a] {key}: {bad}")
            table[key] = {"engine": rec["winner"]["engine"],
                          "gb_s": rec["metric"], "times_s": times}
            log(f"[probe] {key}: winner {rec['winner']['engine']} "
                f"({rec['metric']} GB/s); times_s {json.dumps(times)}; "
                f"{smi}")
        io_rec = entries[f"io.read|{sys.platform}"]
        log(f"[probe] io.read|{sys.platform}: {json.dumps(io_rec['winner'])}"
            f" ({io_rec['metric']} MiB/s); {smi}")
        rc, text = tool_run(tune_probe.main, ["--cache", path])
        require(rc == 0 and text.splitlines()[-1].startswith(
            "tune_probe: 0 probe(s) run"), f"[19a] second run: {text!r}")
        big, small = sort_key(big_n, 1, dev), sort_key(small_n, 1, dev)
        with process_tune_cache(path):
            auto = sort_ops.route_engine(big_n, "auto", lanes_ok=True,
                                         device=dev)
            require(auto == table[big]["engine"],
                    f'[19a] "auto" at 2^20 rows resolved to {auto!r}, the '
                    f'cache crowned {table[big]["engine"]!r}')
            words = terasort.teragen(generator(SEED + 19, dev), big_n)
            require(same(terasort.single_chip_sort(words, path="auto",
                                                   device=dev),
                         yardstick(words)),
                    f"[19a] auto ({auto}) at 2^20 rows differs from the "
                    f"yardstick")
            routed = sort_ops.route_engine(small_n, "auto", lanes_ok=True,
                                           device=dev)
    times = table[small]["times_s"]
    winner = table[small]["engine"]
    steer = {"winner": winner, "routed": routed,
             "overrode": routed != winner,
             "winner_s": times[winner], "routed_s": times[routed],
             "routed_over_winner": times[routed] / times[winner]}
    out = {"probe_s": probe_s, "launches": launches, "table": table,
           "io_read": io_rec, "auto_2^20": auto, "steer_2^16": steer}
    log("[probe] 2^16 small-batch rule: " + json.dumps(steer))
    log(f"[probe] tune_probe {probe_s:.1f} s; launches {launches}")
    out["breakdown"] = probe_breakdown(dev)
    return out


def probe_breakdown(dev: torch.device, engines=("carry", "keys8")) -> dict:
    """What one fly-off call spends, at each of tune_probe's sizes: the
    whole ``bench_step`` and its parts (teragen, one multiset checksum,
    the order check, the sort by each of ``engines``), each by CUDA events
    around the calls as they are issued (``time_ms``: the host's launch
    cost included) and queued behind a sleep (``device_ms``: the card's
    work alone)."""
    out = {}
    for n in tune_probe.SIZES:
        words = terasort.teragen(generator(SEED + 19, dev), n)
        parts = {
            "bench_step keys8": lambda: terasort.bench_step(
                SEED, n, 1, path="keys8", tile=min(MAIN_TILE, n),
                device=dev),
            "teragen": lambda: terasort.teragen(generator(SEED, dev), n),
            "checksum": lambda: terasort._checksum_cols(words.T),
            "order check": lambda: terasort._violations_cols(
                *words.T[:terasort.KEY_WORDS]),
            **{f"sort {p}": (lambda p=p: terasort.single_chip_sort(
                words, path=p, device=dev)) for p in engines}}
        out[n] = {name: {"ms": time_ms(fn), "device_ms": device_ms(fn)}
                  for name, fn in parts.items()}
    log("[probe] one fly-off call, broken down: " + json.dumps(out))
    return out


def phase_net_smoke() -> dict:
    """Phase 19b: ``tools.net_smoke`` on the card with ``--spans``, the
    launch counts reset just before and read just after: exit 0, K1
    launched, and ``scripts/trace_merge.py`` stitches the span file."""
    with tempfile.TemporaryDirectory(prefix="uda_net_smoke_") as d:
        spans = os.path.join(d, "spans.jsonl")
        _build.reset_launches()
        try:
            rc, _ = tool_run(net_smoke.main, ["--spans", spans])
        finally:
            metrics.disable_spans()
        launches = dict(_build.launches)
        require(rc == 0, f"[19b] net_smoke exited {rc}")
        require(launches.get("merge_pass", 0) > 0,
                f"[19b] net_smoke launched no K1: {launches}")
        res = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "trace_merge.py"),
             spans, "--out", os.path.join(d, "trace.json")],
            capture_output=True, text=True, timeout=120)
        require(res.returncode == 0,
                f"[19b] trace_merge exited {res.returncode}: {res.stderr}")
    log(f"[net smoke] launches {launches}; {res.stdout.strip()}")
    return {"launches": launches}


def phase_consoles(dev: torch.device) -> dict:
    """Phase 19c: one reduce over the wire from a port ShuffleServer with
    the stats plane armed, then ``tools.udatop --once --json`` carries the
    server's counters and ``tools.udafleet --once --json`` renders it
    ``ok`` and an unused port ``down``."""
    from uda_tpu_torch.utils.timeseries import disarm_observability_plane

    with tempfile.TemporaryDirectory(prefix="uda_consoles_") as root:
        net_smoke.write_tree(root)
        engine = DataEngine(DirIndexResolver(root), Config(CONSOLE_CONF))
        server = ShuffleServer(engine, Config(CONSOLE_CONF),
                               host="127.0.0.1", port=0)
        server.start()
        try:
            spec = f"127.0.0.1:{server.port}"
            router = HostRoutingClient(config=Config())
            try:
                MergeManager(router, net_smoke.KEY_TYPE, Config(),
                             device=dev).run(
                    net_smoke.JOB,
                    [(spec, m) for m in net_smoke.map_ids(
                        net_smoke.JOB, net_smoke.NUM_MAPS)],
                    0, lambda b: None)
            finally:
                router.stop()
            rc, text = tool_run(udatop.main, [spec, "--once", "--json"],
                                echo=False)
            require(rc == 0, f"[19c] udatop exited {rc}")
            snap = json.loads(text.strip().splitlines()[-1])[spec]
            served = snap["counters"].get("net.bytes.out{role=server}", 0)
            require(served > 0, f"[19c] udatop: no bytes served in "
                                f"{sorted(snap['counters'])[:20]}")
            dead = f"127.0.0.1:{free_port()}"
            rc, text = tool_run(udafleet.main, [
                spec, dead, "--once", "--json", "--window", "30",
                "--timeout", "5"], echo=False)
            require(rc == 0, f"[19c] udafleet exited {rc}")
            fleet = json.loads(text.strip().splitlines()[-1])
            require(fleet["daemons"] == {spec: "ok", dead: "down"},
                    f"[19c] udafleet daemons {fleet['daemons']}")
        finally:
            server.stop()
            engine.stop()
            disarm_observability_plane()
            metrics.disable_stats()
    out = {"served_bytes": served, "daemons": fleet["daemons"],
           "throughput": fleet["throughput"]}
    log("[consoles] " + json.dumps(out))
    return out


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
        build = phase_build()
    with phase_seconds("3 kernels"):
        kernel_errs = phase_kernels(dev)
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
        for path in ("auto", "keys8"):
            phase_profile(words, path)
    with phase_seconds("15a mesh terasort"):
        mesh_runs = {"15a": phase_mesh_terasort(words)}
    del words
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="uda_merge_") as root:
        with phase_seconds("8-13 reduce"):
            merged, overlap, admission, coded, net, planes = phase_reduce(
                dev, root)
        with phase_seconds("14a wordcount"):
            text = zipf_text(SEED + 11)
            wc = phase_wordcount(dev, text)
        with phase_seconds("14b workloads"):
            jobs = phase_workloads(dev, text)
        with phase_seconds("14c bridge"):
            bridge = phase_bridge(
                dev, root, (overlap["b"]["sha256"],
                            overlap["b"]["stream_bytes"]),
                overlap["b"]["wall_s"])
        with phase_seconds("18 native host runtime"):
            phase_native(dev, root, build, (overlap["c"]["sha256"],
                                            overlap["c"]["stream_bytes"]))
    with phase_seconds("14d shim"):
        shim = phase_shim(dev)
    with phase_seconds("15b-15e mesh"):
        mesh_runs.update(phase_mesh_paths(dev))
    with phase_seconds("17a dry run"):
        dryrun = phase_dryrun(dev)
    with phase_seconds("17b pair forms"):
        pair = phase_pair_forms(dev)
    with phase_seconds("19 operator tools"):
        tools = {"19a": phase_probe(dev, info["smi"]),
                 "19b": phase_net_smoke(), "19c": phase_consoles(dev)}
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
            "max_abs_err": max(t["max_abs_err"], kernel_errs.get(name, 0),
                               mesh_runs["15a"]["max_abs_err"].get(name, 0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        kernels[-1]["tune_probe_path_launches"] = \
            tools["19a"]["launches"].get(name, 0)
        kernels[-1]["net_smoke_path_launches"] = \
            tools["19b"]["launches"].get(name, 0)
        if name in MESH_KERNELS:
            kernels[-1]["distributed_path_launches"] = {
                k: v["launches"][name] for k, v in mesh_runs.items()}
            kernels[-1]["dryrun_path_launches"] = {
                str(k): v["launches"][name] for k, v in dryrun.items()}
        if name == "take_lanes":
            kernels[-1].update({k: t[k] for k in (
                "design", "call_ms", "direct_ms", "records_ms",
                "scratch_bytes", "peak_bytes", "copy_ms", "merge")
                if k in t})
        if name == "take_rows":
            kernels[-1].update({k: t[k] for k in (
                "call_ms", "sector_bound_ms", "vector_words", "peak_bytes",
                "library_peak_bytes")})
        if name == "tile_sort_folded":
            # the matrix entry's own launches: the count holds the records
            # entry's too
            kernels[-1]["launches"] -= run["launches"][
                "tile_sort_folded_rows"]
        if name == "tile_sort_folded_rows":
            kernels[-1].update({k: t[k] for k in (
                "matrix_ms", "layout_ms", "sector_bound_ms")})
        if "m" in t:
            kernels[-1]["columns"] = t["m"]
        if name in ("merge_pass", "merge_partition"):
            kernels[-1]["merge_path_launches"] = merged["launches"][name]
            kernels[-1]["pair_keys8_launches"] = \
                pair["keys8"]["launches"][name]
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
            kernels[-1]["observability_path_launches"] = \
                planes["observability"]["launches"][name]
            kernels[-1]["job_path_launches"] = {
                "14a wordcount": wc["launches"][name],
                **{f"14b {k}": v["launches"][name]
                   for k, v in jobs.items()}}
            kernels[-1]["bridge_path_launches"] = {
                "14c": bridge["launches"][name],
                "14d": [r["launches"].get(name, 0) for r in shim["runs"]]}
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
