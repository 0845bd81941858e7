"""The MapReduce pipeline: the workload harness over the framework.

The port's copy of ``uda_tpu/models/pipeline.py``. A job runs map ->
shuffle -> merge -> reduce through the components a Hadoop deployment
uses: ``MOFWriter``'s supplier layout, ``DataEngine``'s chunk serving,
``MergeManager``'s merge on the card (K1's merge tree) and framed
emission, so every workload in ``uda_tpu_torch.models`` exercises the
engine end to end, the role the reference's cluster regression workloads
played (reference scripts/regression/namesConf.sh:20-35).

The map side is host Python (mapper, partitioner, a comparator sort per
partition); the reduce side consumes the merged stream through
``grouped_reduce``, Hadoop's grouping contract: consecutive equal keys
form one reduce call. ``MapReduceJob(device=None)`` merges on the card;
pass ``device="cpu"`` where there is none. With ``mesh=`` the shuffle
crosses the slot mesh (``run_reduces_mesh``, ``parallel/bytes_exchange``).
"""

from __future__ import annotations

import functools
import io
import os
import tempfile
import zlib
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver, MOFWriter
from uda_tpu_torch.utils.comparators import KeyType, get_key_type
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import ConfigError
from uda_tpu_torch.utils.ifile import IFileReader
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["MapReduceJob", "grouped_reduce", "hash_partitioner"]

Record = Tuple[bytes, bytes]


def hash_partitioner(key: bytes, num_reducers: int) -> int:
    """Default partitioner (Hadoop HashPartitioner shape)."""
    return zlib.crc32(key) % num_reducers


def grouped_reduce(records: Iterable[Record],
                   reducer: Callable[[bytes, list[bytes]], Iterable[Record]],
                   key_content: Callable[[bytes], bytes] = lambda k: k
                   ) -> Iterator[Record]:
    """Group consecutive equal keys (by comparator content) and apply the
    reducer: Hadoop's reduce() contract over a sorted stream."""
    cur_key: Optional[bytes] = None
    cur_content: Optional[bytes] = None
    values: list[bytes] = []
    for k, v in records:
        c = key_content(k)
        if cur_content is not None and c != cur_content:
            yield from reducer(cur_key, values)
            values = []
        cur_key, cur_content = k, c
        values.append(v)
    if cur_content is not None:
        yield from reducer(cur_key, values)


class MapReduceJob:
    """One job: map inputs to records, shuffle+merge, reduce.

    ``mapper(input) -> iterable of (key, value)`` serialized records;
    ``reducer(key, values) -> iterable of (key, value)`` outputs;
    ``device`` (``None`` = the card) is where each reducer's merge runs.
    """

    def __init__(self, job_id: str,
                 mapper: Callable[[object], Iterable[Record]],
                 reducer: Callable[[bytes, list[bytes]], Iterable[Record]],
                 key_type: KeyType | str = "uda.tpu.RawBytes",
                 num_reducers: int = 2,
                 partitioner: Callable[[bytes, int], int] = hash_partitioner,
                 config: Optional[Config] = None,
                 work_dir: Optional[str] = None,
                 supplier_roots: Optional[Sequence[str]] = None,
                 device=None):
        self.job_id = job_id
        self.mapper = mapper
        self.reducer = reducer
        self.key_type = (get_key_type(key_type) if isinstance(key_type, str)
                         else key_type)
        self.num_reducers = num_reducers
        self.partitioner = partitioner
        self.cfg = config or Config()
        self.device = resolve_device(device)
        self.work_dir = work_dir or tempfile.mkdtemp(prefix=f"uda_{job_id}_")
        # erasure-coded deployments: the job's supplier roots, in the
        # canonical (sorted unique) order from which writer and reducer
        # each derive the stripe placement. The reduce side reads
        # work_dir, so the primary must be among them
        self.supplier_roots = sorted(set(supplier_roots or []))
        if self.supplier_roots and self.work_dir not in self.supplier_roots:
            raise ConfigError(
                f"supplier_roots must include work_dir "
                f"{self.work_dir!r} (the primary MOF root the reduce "
                f"side reads); got {sorted(supplier_roots)}")

    # -- map phase ----------------------------------------------------------

    def _codec(self):
        if not self.cfg.get("mapred.compress.map.output"):
            return None
        from uda_tpu_torch.compress import get_codec
        return get_codec(self.cfg.get("mapred.map.output.compression.codec")
                         or "zlib")

    def run_maps(self, inputs: Sequence[object]) -> MOFWriter:
        """Run the mapper over each input split and write sorted,
        partitioned MOFs (what Hadoop's map-side sort and spill produce).
        With ``uda.tpu.coding.scheme`` set the map phase writes the coded
        layout: parity section and v2 index always, and the stripe
        fan-out across the supplier roots when the job has more than one
        (placement per ``uda.tpu.coding.domains``)."""
        from uda_tpu_torch.coding import parse_domains, parse_scheme

        scheme = parse_scheme(str(self.cfg.get("uda.tpu.coding.scheme")))
        writer = MOFWriter(
            self.work_dir, self.job_id, codec=self._codec(),
            scheme=scheme, supplier_roots=self.supplier_roots,
            supplier_index=(self.supplier_roots.index(self.work_dir)
                            if self.supplier_roots else 0),
            domains=parse_domains(
                str(self.cfg.get("uda.tpu.coding.domains"))))
        sort_key = functools.cmp_to_key(self.key_type.compare)
        with metrics.timer("map_phase"):
            for m, split in enumerate(inputs):
                parts: list[list[Record]] = [
                    [] for _ in range(self.num_reducers)]
                for k, v in self.mapper(split):
                    parts[self.partitioner(k, self.num_reducers)].append(
                        (k, v))
                for p in parts:
                    p.sort(key=lambda kv: sort_key(kv[0]))
                writer.write(f"attempt_{self.job_id}_m_{m:06d}_0", parts)
        if scheme is not None:
            # the background stripe scrub, when its interval arms it
            # (non-blocking, one in flight per process)
            from uda_tpu_torch.coding.scrub import maybe_scrub

            maybe_scrub(self.cfg, self.supplier_roots or [self.work_dir])
        return writer

    # -- reduce phase -------------------------------------------------------

    def _reduce_all(self, writer: MOFWriter,
                    make_client: Callable[[int], object]
                    ) -> dict[int, list[Record]]:
        """The per-reducer loop: ``make_client(r)`` builds reducer r's
        InputClient; the codec wrap, ``MergeManager.run``, the framed
        blocks' reassembly and the grouped reduce follow."""
        codec = self._codec()
        outputs: dict[int, list[Record]] = {}
        for r in range(self.num_reducers):
            client = make_client(r)
            if codec is not None:
                from uda_tpu_torch.compress import DecompressingClient
                client = DecompressingClient(client, codec)
            mm = MergeManager(client, self.key_type, self.cfg,
                              device=self.device)
            blocks: list[bytes] = []
            mm.run(self.job_id, writer.map_ids, r,
                   lambda b: blocks.append(bytes(b)))
            merged = IFileReader(io.BytesIO(b"".join(blocks)))
            with metrics.timer("reduce_phase"):
                outputs[r] = list(grouped_reduce(
                    merged, self.reducer, self.key_type.content))
        return outputs

    def run_reduces(self, writer: MOFWriter) -> dict[int, list[Record]]:
        """Shuffle and merge each partition through the engine and apply
        the reducer over the grouped sorted stream."""
        engine = DataEngine(DirIndexResolver(self.work_dir), self.cfg)
        try:
            return self._reduce_all(writer,
                                    lambda r: LocalFetchClient(engine))
        finally:
            engine.stop()

    def run_reduces_mesh(self, writer: MOFWriter, mesh,
                         axis: str = "shuffle") -> dict[int, list[Record]]:
        """Shuffle the map-output partitions ACROSS THE SLOT MESH and merge
        per reducer: map m's outputs live on supplier slot ``m % P``,
        reducer r is served on slot ``r % P``, and the on-disk partition
        bytes (compressed or not) cross through
        ``parallel/bytes_exchange``. Per-(src, dst) blob order is the
        deterministic (map, reducer) send order, so delivered blobs map
        back to their (map, reducer) pair positionally. The output is
        byte-identical to run_reduces."""
        from uda_tpu_torch.mofserver.index import read_index_file
        from uda_tpu_torch.parallel.bytes_exchange import (
            ExchangeFetchClient, exchange_blobs, exchange_group_size)

        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            raise ValueError(
                f"mesh has axes {tuple(mesh.shape)}, not {missing}; pass "
                f"axis= matching the mesh (e.g. run(..., axis="
                f"{next(iter(mesh.shape))!r}))")
        p = exchange_group_size(mesh, axis)
        blobs: list[list] = [[] for _ in range(p)]
        meta: list[list] = [[] for _ in range(p)]  # (map_id, r, raw_len)
        for m, map_id in enumerate(writer.map_ids):
            d = writer.map_dir(map_id)
            recs = read_index_file(os.path.join(d, "file.out.index"),
                                   os.path.join(d, "file.out"))
            with open(os.path.join(d, "file.out"), "rb") as f:
                mof = f.read()
            src = m % p
            for r in range(self.num_reducers):
                ir = recs[r]
                blobs[src].append((r % p,
                                   mof[ir.start_offset:ir.start_offset
                                       + ir.part_length]))
                meta[src].append((map_id, r, ir.raw_length))
        with metrics.timer("mesh_shuffle"):
            delivered = exchange_blobs(blobs, mesh, axis)
        # regroup positionally: delivered[dst][src][k] is the k-th blob
        # that src addressed to dst, in send order
        per_reduce: dict[int, dict[str, bytes]] = {
            r: {} for r in range(self.num_reducers)}
        raw_lens: dict[int, dict[str, int]] = {
            r: {} for r in range(self.num_reducers)}
        for src in range(p):
            cursors = {d: 0 for d in range(p)}
            for (map_id, r, raw), (dstdev, _) in zip(meta[src],
                                                     blobs[src]):
                k = cursors[dstdev]
                cursors[dstdev] += 1
                per_reduce[r][map_id] = delivered[dstdev][src][k]
                raw_lens[r][map_id] = raw
        return self._reduce_all(
            writer, lambda r: ExchangeFetchClient(per_reduce[r],
                                                  raw_lengths=raw_lens[r]))

    def run(self, inputs: Sequence[object], mesh=None,
            axis: str = "shuffle") -> dict[int, list[Record]]:
        """Full job. With ``mesh``, the shuffle crosses the slot mesh
        (run_reduces_mesh, over ``axis``); otherwise it stays on the
        local DataEngine."""
        writer = self.run_maps(inputs)
        if mesh is not None:
            return self.run_reduces_mesh(writer, mesh, axis=axis)
        return self.run_reduces(writer)
