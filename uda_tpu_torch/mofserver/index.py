"""Index records and map-output path resolution.

The port's copy of ``uda_tpu/mofserver/index.py`` for uncoded map outputs.
Equivalent of the reference's supplier-side index layer (reference
src/MOFServer/IndexInfo.h:98-121 ``index_record_t`` {offset, rawLength,
partLength, path}; resolution via the ``getPathUda`` up-call into Java's
IndexCache, IndexInfo.cc:237-251).

File formats:

- a *MOF* (map output file, ``file.out``) is the concatenation of one
  IFile segment per reduce partition;
- its *index* (``file.out.index``) is one (start_offset, raw_length,
  part_length) triple of 8-byte big-endian longs per partition — the
  Hadoop spill-index record layout (the reference's v1 index).

The reference's erasure-coded v2 index (``UDIX`` magic, parity section)
and its stripe shards belong to ``uda_tpu/coding``, which the port does
not have yet: reading a v2 index raises.

``DirIndexResolver`` reads ``<root>/<job>/<map_id>/file.out[.index]``
like the reference's LocalDirAllocator layout.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
from typing import Callable, Dict, Sequence

from uda_tpu_torch.utils.errors import StorageError

__all__ = ["IndexRecord", "write_index_file", "read_index_file",
           "IndexResolver", "DirIndexResolver", "INDEX_MAGIC"]

INDEX_MAGIC = b"UDIX"   # the reference's v2 (erasure-coded) sentinel
_TRIPLE = struct.Struct(">qqq")


@dataclasses.dataclass(frozen=True)
class IndexRecord:
    """One reduce partition of one map output (reference index_record_t,
    IndexInfo.h:98-104)."""

    start_offset: int
    raw_length: int
    part_length: int
    path: str  # MOF data file path


def write_index_file(path: str,
                     triples: Sequence[tuple[int, int, int]]) -> None:
    """Write a spill index: (start, raw_len, part_len) 8-byte BE
    triples."""
    with open(path, "wb") as f:
        for start, raw, part in triples:
            f.write(_TRIPLE.pack(start, raw, part))


def read_index_file(path: str, mof_path: str) -> list[IndexRecord]:
    """Read a spill index into IndexRecords pointing at ``mof_path``."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(INDEX_MAGIC):
        raise StorageError(
            f"index {path} is an erasure-coded (v2) index; the coding "
            f"layer (uda_tpu/coding) is not ported to uda_tpu_torch yet")
    size = len(data)
    if size % _TRIPLE.size != 0:
        raise StorageError(f"index file {path} length {size} not a "
                           "multiple of 24")
    out = []
    for i in range(size // _TRIPLE.size):
        start, raw, part = _TRIPLE.unpack_from(data, i * _TRIPLE.size)
        if start < 0 or raw < 0 or part < 0:
            raise StorageError(f"negative field in index record {i} of {path}")
        out.append(IndexRecord(start, raw, part, mof_path))
    return out


class IndexResolver:
    """(job_id, map_id, reduce_id) -> IndexRecord, with a per-(job,map)
    cache like the reference's first-fetch-only up-call (IndexInfo.cc:
    237-251: the path is resolved once and cached in the partition
    table)."""

    def __init__(self, lookup: Callable[[str, str], list[IndexRecord]]):
        self._lookup = lookup
        self._cache: Dict[tuple[str, str], list[IndexRecord]] = {}
        self._lock = threading.Lock()

    def resolve(self, job_id: str, map_id: str, reduce_id: int) -> IndexRecord:
        key = (job_id, map_id)
        with self._lock:
            records = self._cache.get(key)
        if records is None:
            records = self._lookup(job_id, map_id)
            with self._lock:
                self._cache[key] = records
        if not 0 <= reduce_id < len(records):
            raise StorageError(
                f"reduce {reduce_id} out of range for {map_id} "
                f"({len(records)} partitions)")
        return records[reduce_id]


class DirIndexResolver(IndexResolver):
    """Default layout resolver: ``<root>/<job>/<map_id>/file.out[.index]``
    (the reference's usercache/appcache layout shape, UdaPluginSH.java:
    107-144). Accepts one root or a list of roots — map outputs spread
    across local dirs resolve like the reference's LocalDirAllocator
    search over mapred.local.dir."""

    def __init__(self, root):
        self.roots = [root] if isinstance(root, str) else list(root)
        if not self.roots:
            raise StorageError("DirIndexResolver needs at least one root")
        self.root = self.roots[0]  # primary root (writer default)
        super().__init__(self._from_dir)

    def map_dir(self, job_id: str, map_id: str) -> str:
        """First root holding the map output; the primary root when
        none does (the write-side location)."""
        for r in self.roots:
            d = os.path.join(r, job_id, map_id)
            if os.path.exists(os.path.join(d, "file.out.index")):
                return d
        return os.path.join(self.root, job_id, map_id)

    def _from_dir(self, job_id: str, map_id: str) -> list[IndexRecord]:
        d = self.map_dir(job_id, map_id)
        idx = os.path.join(d, "file.out.index")
        if not os.path.exists(idx):
            raise StorageError(f"no index file for {job_id}/{map_id} "
                               f"under {self.roots}")
        return read_index_file(idx, os.path.join(d, "file.out"))
