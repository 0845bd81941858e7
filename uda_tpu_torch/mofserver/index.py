"""Index records and map-output path resolution.

The port's copy of ``uda_tpu/mofserver/index.py``. Equivalent of the
reference's supplier-side index layer (reference
src/MOFServer/IndexInfo.h:98-121 ``index_record_t`` {offset, rawLength,
partLength, path}; resolution via the ``getPathUda`` up-call into Java's
IndexCache, IndexInfo.cc:237-251).

File formats:

- a *MOF* (map output file, ``file.out``) is the concatenation of one
  IFile segment per reduce partition;
- its *index* (``file.out.index``) is one (start_offset, raw_length,
  part_length) triple of 8-byte big-endian longs per partition — the
  Hadoop spill-index record layout (v1).

Erasure-coded layout (``uda.tpu.coding.scheme``, ``uda_tpu_torch.coding``):
a v2 index opens with the ``UDIX`` magic and a stripe header (k, n) and
grows a *parity section* after the triples: per partition, (start, length)
locators of its n-k parity chunks, which the writer appends to
``file.out`` after all data segments, so the data region stays
byte-identical to the uncoded layout. A v1 index keeps its meaning.

Stripe shards: chunk ``i`` of a partition's k-of-n stripe is addressable
as the pseudo-map ``<map_id>~s<i>``. On a peer supplier that is a real
directory holding a tiny MOF (one segment per reduce partition: the chunk
bytes, written by ``writer.write_striped_map_output``); on the primary the
resolver synthesizes the shard's records as byte ranges of the base map's
``file.out`` (data chunks from the data region, parity chunks from the
parity section). A shard record's ``part_length`` is the stored chunk
bytes while its ``raw_length`` carries the full partition's part_length,
the total the decoded stripe trims to.

``DirIndexResolver`` reads ``<root>/<job>/<map_id>/file.out[.index]``
like the reference's LocalDirAllocator layout.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
from typing import Callable, Dict, Optional, Sequence

from uda_tpu_torch.utils.errors import StorageError

__all__ = ["IndexRecord", "PartitionStripe", "write_index_file",
           "read_index_file", "IndexResolver", "DirIndexResolver",
           "shard_map_id", "parse_shard_id", "synthesize_shard_records",
           "INDEX_MAGIC", "INDEX_VERSION"]

INDEX_MAGIC = b"UDIX"   # v2+ sentinel; v1 files are bare triples
INDEX_VERSION = 2
_V2_HEADER = struct.Struct(">4sHHHI")  # magic, version, k, n, npart
_TRIPLE = struct.Struct(">qqq")
_PARITY_LOC = struct.Struct(">qq")     # (start, length) in file.out

_SHARD_SEP = "~s"  # <map_id>~s<i>: stripe chunk i's pseudo-map id


def shard_map_id(map_id: str, chunk: int) -> str:
    """The pseudo-map id addressing stripe chunk ``chunk`` of
    ``map_id``'s partitions."""
    return f"{map_id}{_SHARD_SEP}{chunk}"


def parse_shard_id(map_id: str):
    """``(base_map_id, chunk_index)`` for a shard pseudo-map id, None
    for an ordinary map id."""
    base, sep, tail = map_id.rpartition(_SHARD_SEP)
    if not sep or not base or not tail.isdigit():
        return None
    return base, int(tail)


@dataclasses.dataclass(frozen=True)
class PartitionStripe:
    """One partition's k-of-n stripe geometry as recorded by a v2
    index on the full-stripe (primary) holder: the parity section
    locators for THIS partition. Data chunks need no locators — they
    are ``chunk_len``-sized slices of the partition's data range."""

    k: int
    n: int
    parity: tuple  # ((start, length), ...) per parity chunk, len n-k

    def chunk_len(self, part_length: int) -> int:
        return (part_length + self.k - 1) // self.k if part_length else 0


@dataclasses.dataclass(frozen=True)
class IndexRecord:
    """One reduce partition of one map output (reference index_record_t,
    IndexInfo.h:98-104). ``stripe`` is the partition's erasure-coding
    geometry when the index is v2 (full-stripe holder), else None."""

    start_offset: int
    raw_length: int
    part_length: int
    path: str  # MOF data file path
    stripe: Optional[PartitionStripe] = None


def write_index_file(path: str, triples: Sequence[tuple[int, int, int]],
                     stripe: Optional[tuple] = None) -> None:
    """Write a spill index: (start, raw_len, part_len) 8-byte BE
    triples. With ``stripe = (k, n, parity_locators)`` — where
    ``parity_locators[r]`` is the list of (start, length) pairs of
    partition r's n-k parity chunks in file.out — the file is written
    in the versioned v2 layout with the parity section appended."""
    with open(path, "wb") as f:
        if stripe is not None:
            k, n, locators = stripe
            if len(locators) != len(triples):
                raise StorageError(
                    f"parity locators for {len(locators)} partitions, "
                    f"{len(triples)} triples")
            f.write(_V2_HEADER.pack(INDEX_MAGIC, INDEX_VERSION, k, n,
                                    len(triples)))
        for start, raw, part in triples:
            f.write(_TRIPLE.pack(start, raw, part))
        if stripe is not None:
            k, n, locators = stripe
            for r, locs in enumerate(locators):
                if len(locs) != n - k:
                    raise StorageError(
                        f"partition {r}: {len(locs)} parity locators, "
                        f"stripe needs {n - k}")
                for start, length in locs:
                    f.write(_PARITY_LOC.pack(start, length))


def read_index_file(path: str, mof_path: str) -> list[IndexRecord]:
    """Read a spill index into IndexRecords pointing at ``mof_path``.
    Both layouts are accepted: v1 (bare triples) and v2 (``UDIX``
    header + triples + parity section); v2 records carry their
    partition's :class:`PartitionStripe`."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(INDEX_MAGIC):
        return _read_v1(data, path, mof_path)
    if len(data) < _V2_HEADER.size:
        raise StorageError(f"truncated v2 index header in {path}")
    magic, version, k, n, npart = _V2_HEADER.unpack_from(data, 0)
    if version != INDEX_VERSION:
        raise StorageError(f"index {path}: unsupported version {version} "
                           f"(this build reads v1 and v{INDEX_VERSION})")
    if not (1 <= k <= n <= 255):
        raise StorageError(f"index {path}: bad stripe geometry "
                           f"k={k}, n={n}")
    want = (_V2_HEADER.size + npart * _TRIPLE.size
            + npart * (n - k) * _PARITY_LOC.size)
    if len(data) != want:
        raise StorageError(f"index {path}: v2 length {len(data)} != "
                           f"expected {want} for {npart} partitions")
    out = []
    off = _V2_HEADER.size
    ploff = off + npart * _TRIPLE.size
    for i in range(npart):
        start, raw, part = _TRIPLE.unpack_from(data, off + i * _TRIPLE.size)
        if start < 0 or raw < 0 or part < 0:
            raise StorageError(f"negative field in index record {i} of "
                               f"{path}")
        locs = []
        for j in range(n - k):
            pstart, plen = _PARITY_LOC.unpack_from(
                data, ploff + (i * (n - k) + j) * _PARITY_LOC.size)
            if pstart < 0 or plen < 0:
                raise StorageError(f"negative parity locator {i}/{j} "
                                   f"in {path}")
            locs.append((pstart, plen))
        out.append(IndexRecord(start, raw, part, mof_path,
                               stripe=PartitionStripe(k, n, tuple(locs))))
    return out


def _read_v1(data: bytes, path: str, mof_path: str) -> list[IndexRecord]:
    size = len(data)
    if size % 24 != 0:
        raise StorageError(f"index file {path} length {size} not a "
                           "multiple of 24")
    out = []
    for i in range(size // 24):
        start, raw, part = _TRIPLE.unpack_from(data, i * 24)
        if start < 0 or raw < 0 or part < 0:
            raise StorageError(f"negative field in index record {i} of {path}")
        out.append(IndexRecord(start, raw, part, mof_path))
    return out


def synthesize_shard_records(base: Sequence[IndexRecord],
                             chunk: int) -> list[IndexRecord]:
    """Shard records for stripe chunk ``chunk`` as byte ranges of the
    full-stripe holder's file.out — data chunks from the (unchanged)
    data region, parity chunks from the parity section. Each record's
    ``part_length`` is the stored chunk bytes and ``raw_length`` the
    full partition's part_length (the decode-trim total; see the
    module docstring)."""
    out = []
    for rec in base:
        st = rec.stripe
        if st is None:
            raise StorageError(
                f"{rec.path}: stripe chunk {chunk} requested but the "
                f"index carries no stripe section (not an erasure-coded "
                f"map output)")
        if not 0 <= chunk < st.n:
            raise StorageError(f"stripe chunk {chunk} out of range "
                               f"(n={st.n}) for {rec.path}")
        cl = st.chunk_len(rec.part_length)
        if chunk < st.k:  # data chunk: a slice of the partition range
            start = rec.start_offset + chunk * cl
            length = max(0, min(cl, rec.part_length - chunk * cl))
        else:
            start, length = st.parity[chunk - st.k]
        out.append(IndexRecord(start, rec.part_length, length, rec.path))
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

    def resolve_cached(self, job_id: str, map_id: str, reduce_id: int):
        """Cache-hit-only resolve: the record when the (job, map)
        partition table is cached already, None on a miss. Never does IO,
        so the network server's loop thread may call it inline."""
        with self._lock:
            records = self._cache.get((job_id, map_id))
        if records is None:
            return None
        if not 0 <= reduce_id < len(records):
            raise StorageError(
                f"reduce {reduce_id} out of range for {map_id} "
                f"({len(records)} partitions)")
        return records[reduce_id]

    def invalidate(self, job_id: str) -> None:
        """Drop every cached partition table of ``job_id``: the next
        resolve walks the roots again (the store calls this right after a
        migration's cut-over, so a moved partition resolves to its blob
        copy, not the unlinked local file)."""
        with self._lock:
            for key in [k for k in self._cache if k[0] == job_id]:
                del self._cache[key]


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
        if os.path.exists(idx):
            return read_index_file(idx, os.path.join(d, "file.out"))
        # a stripe shard with no directory of its own: on the full-stripe
        # (primary) holder the chunk is a byte range of the base map's
        # file.out, synthesized from its v2 index
        shard = parse_shard_id(map_id)
        if shard is not None:
            base_id, chunk = shard
            base_dir = self.map_dir(job_id, base_id)
            base_idx = os.path.join(base_dir, "file.out.index")
            if os.path.exists(base_idx):
                return synthesize_shard_records(
                    read_index_file(base_idx,
                                    os.path.join(base_dir, "file.out")),
                    chunk)
        raise StorageError(f"no index file for {job_id}/{map_id} "
                           f"under {self.roots}")
