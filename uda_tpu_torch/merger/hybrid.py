"""Hybrid LPQ/RPQ merge: bounded-memory hierarchical merge.

The port's copy of ``uda_tpu/merger/hybrid.py``, the reference's
merge_hybrid (reference src/Merger/MergeManager.cc:202-288): the fetch
list is split into LPQs (local priority queues) of ``num_maps/num_lpqs``
segments, ``num_lpqs`` defaulting to sqrt(num_maps) (reference
src/Merger/reducer.cc:270-279); each LPQ is fetched, merged and spilled to
a file ``<dir>/uda.<job>.r<reduce>.lpq-NNN`` in round-robin local dirs,
and a final RPQ (residual priority queue) streams the merge of the spill
files (``SuperSegment``s, reference src/Merger/StreamRW.cc:813-861) to the
consumer. At most ``mapred.rdma.num.parallel.lpqs`` LPQs (at least 3) run
at once.

Each LPQ merge is ``MergeManager.merge_segments``: on the card the
two-phase merge tree on K1, launched from the LPQ's pool thread on its
current stream (each pair merge allocates its own buffers). The RPQ is
host-side by contract, as the reference's final merge feeding Java: a
heap merge of one buffered cursor per spill file
(``ops/merge.merge_record_streams``, the reference's fallback when its
native loser tree is not built; the bytes are the same). The spill is
framed by the port's ``emitter.iter_framed_chunks`` in bounded chunks.
Every spill path is registered before its file is opened, and every spill
file is deleted when the task fails or the RPQ has read it.
"""

from __future__ import annotations

import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

from uda_tpu_torch.merger.emitter import iter_framed_chunks
from uda_tpu_torch.merger.streaming import spill_dirs as _spill_dirs
from uda_tpu_torch.ops import merge as merge_ops
from uda_tpu_torch.utils.ifile import iter_file_records
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["run_hybrid", "num_lpqs_for", "SuperSegment"]

log = get_logger()


def num_lpqs_for(num_maps: int, lpq_size: int) -> int:
    """LPQ count: num_maps/lpq_size when configured, else sqrt(num_maps)
    (reference reducer.cc:270-279)."""
    if lpq_size > 0:
        return max(1, math.ceil(num_maps / lpq_size))
    return max(1, round(math.sqrt(num_maps)))


class SuperSegment:
    """File-backed sorted run; deletes its spill file when consumed
    (reference ~SuperSegment, StreamRW.cc:824-830)."""

    def __init__(self, path: str, buffer_size: int = 1 << 20):
        self.path = path
        self.buffer_size = buffer_size

    def stream(self):
        """Bounded-memory record cursor over the spill file."""
        return iter_file_records(self.path, self.buffer_size)

    def delete(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


def run_hybrid(mm, job_id: str, map_ids: Sequence, reduce_id: int,
               consumer: Callable[[memoryview], None]) -> int:
    """Fetch in LPQ-sized groups, spill the device-merged runs, stream the
    final RPQ merge. ``mm`` is the owning MergeManager."""
    cfg = mm.cfg
    num_maps = len(map_ids)
    lpqs = num_lpqs_for(num_maps, cfg.get("mapred.netmerger.hybrid.lpq.size"))
    group = math.ceil(num_maps / lpqs)
    parallel = cfg.get("mapred.rdma.num.parallel.lpqs") or 3
    dirs = _spill_dirs(cfg)
    groups = [list(map_ids[i:i + group]) for i in range(0, num_maps, group)]
    log.info(f"hybrid merge: {num_maps} maps -> {len(groups)} LPQs of <= "
             f"{group}, {parallel} parallel")

    # every spill path is registered before its file is opened, so a
    # failing LPQ cannot orphan the spill files of the groups that
    # completed
    spill_paths: list[str] = []
    paths_lock = threading.Lock()

    def spill_one(idx_group) -> SuperSegment:
        idx, g = idx_group
        segments = mm.fetch_all(job_id, g, reduce_id)
        merged = mm.merge_segments(segments)
        d = dirs[idx % len(dirs)]
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"uda.{job_id}.r{reduce_id}.lpq-{idx:03d}")
        with paths_lock:
            spill_paths.append(path)
        with metrics.timer("lpq_spill"):
            with open(path, "wb") as f:
                # framed in bounded chunks: peak memory is one chunk, not
                # the spill
                for piece in iter_framed_chunks(merged):
                    f.write(piece)
        return SuperSegment(path)

    try:
        with metrics.timer("lpq_phase"):
            with ThreadPoolExecutor(max_workers=parallel,
                                    thread_name_prefix="uda-lpq") as pool:
                supers = list(pool.map(spill_one, enumerate(groups)))
    except BaseException:
        for p in spill_paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        raise

    # RPQ: one buffered cursor per spill file, so peak memory is one read
    # buffer per file, never the shuffle (compression off by contract,
    # MergeManager.cc:240-288)
    try:
        with metrics.timer("rpq_phase"):
            streams = [s.stream() for s in supers]
            merged = merge_ops.merge_record_streams(streams, mm.key_type)
            return mm.emitter.emit(merged, consumer)
    finally:
        for s in supers:
            s.delete()
