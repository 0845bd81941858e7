"""Map-output writing: the producer side of the MOF contract.

The port's copy of ``uda_tpu/mofserver/writer.py``: one IFile segment per
reduce partition, concatenated into ``file.out``, with the (start,
raw_length, part_length) index triples in ``file.out.index``. With a codec
(``uda_tpu_torch.compress.Codec``) each partition's IFile bytes are
block-compressed and the triple carries (start, raw_length = uncompressed,
part_length = on disk), like Hadoop's spill index for compressed map
outputs.

Erasure coding (``uda.tpu.coding.scheme=rs:k:n``, ``coding``): the writer
grows two outputs, both derived from the same per-partition blobs:

- the primary MOF gains a *parity section*: each partition's n-k parity
  chunks appended after all data segments, so the data region stays
  byte-identical to the uncoded layout, recorded by the v2 index
  (:func:`uda_tpu_torch.mofserver.index.write_index_file`);
- :func:`write_striped_map_output` also fans the stripe out: chunk i of
  every partition goes to the supplier ``stripe_order`` names (the
  positional rotation ``(p + i) % H`` by default, the failure-domain
  interleave when ``uda.tpu.coding.domains`` declares domains) as a tiny
  shard MOF ``<map_id>~s<i>`` on that supplier's root. Chunks that land
  back on the primary are not duplicated: the resolver synthesizes them
  from the primary's file.out byte ranges.

Shard index triples carry ``raw_length = the full partition's
part_length`` (the decode-trim total) and ``part_length = the stored chunk
bytes``; see the index module docstring.
"""

from __future__ import annotations

import io
import os
from typing import Iterable, Optional, Sequence, Tuple

from uda_tpu_torch.mofserver.index import shard_map_id, write_index_file
from uda_tpu_torch.utils.ifile import IFileWriter

__all__ = ["MOFWriter", "write_map_output", "write_striped_map_output",
           "partition_blobs"]


def partition_blobs(partitions: Sequence[Iterable[Tuple[bytes, bytes]]],
                    codec=None) -> list[tuple[bytes, int]]:
    """Each partition as ``(on-disk bytes, raw record-byte length)``: the
    sorted records IFile-framed, then block-compressed when ``codec`` is
    given (raw == len(bytes) for uncompressed jobs)."""
    blobs = []
    for records in partitions:
        seg = io.BytesIO()
        w = IFileWriter(seg)
        for k, v in records:
            w.append(k, v)
        w.close()
        raw = seg.getvalue()
        if codec is not None:
            from uda_tpu_torch.compress import compress_block_stream
            blobs.append((compress_block_stream(raw, codec), len(raw)))
        else:
            blobs.append((raw, len(raw)))
    return blobs


def _encode_parities(blobs: list, scheme) -> list[list[bytes]]:
    """Each partition's n-k parity chunks, computed once (both the
    primary's parity section and the peer shard fan-out index into
    this)."""
    from uda_tpu_torch.coding import rs

    return [rs.encode_parity(blob, scheme.k, scheme.n)
            for blob, _ in blobs]


def _write_primary(map_dir: str, blobs: list, scheme=None,
                   parities=None) -> list[tuple[int, int, int]]:
    """Write one map dir's file.out (+ parity section when coded) and its
    index; returns the data triples."""
    os.makedirs(map_dir, exist_ok=True)
    mof = io.BytesIO()
    triples = []
    for blob, raw_len in blobs:
        start = mof.tell()
        mof.write(blob)
        triples.append((start, raw_len, len(blob)))
    stripe = None
    if scheme is not None:
        if parities is None:
            parities = _encode_parities(blobs, scheme)
        locators = []
        for pchunks in parities:
            locs = []
            for pchunk in pchunks:
                locs.append((mof.tell(), len(pchunk)))
                mof.write(pchunk)
            # rs:k:k (and the empty partition) has no parity chunks; the
            # locator row must still exist per partition
            locs += [(0, 0)] * (scheme.parity - len(locs))
            locators.append(locs)
        stripe = (scheme.k, scheme.n, locators)
    with open(os.path.join(map_dir, "file.out"), "wb") as f:
        f.write(mof.getvalue())
    write_index_file(os.path.join(map_dir, "file.out.index"), triples,
                     stripe=stripe)
    return triples


def _write_shard(shard_dir: str, chunk_bytes: list[bytes],
                 full_parts: list[int]) -> None:
    """One stripe chunk's shard MOF: partition r's segment is the chunk
    bytes; the triple's raw field carries the full partition's
    part_length (decode-trim total)."""
    os.makedirs(shard_dir, exist_ok=True)
    mof = io.BytesIO()
    triples = []
    for ch, full in zip(chunk_bytes, full_parts):
        start = mof.tell()
        mof.write(ch)
        triples.append((start, full, len(ch)))
    with open(os.path.join(shard_dir, "file.out"), "wb") as f:
        f.write(mof.getvalue())
    write_index_file(os.path.join(shard_dir, "file.out.index"), triples)


def write_map_output(map_dir: str,
                     partitions: Sequence[Iterable[Tuple[bytes, bytes]]],
                     codec=None, scheme=None) -> list[tuple[int, int, int]]:
    """Write one map attempt's output: ``partitions[r]`` is the (already
    sorted) record stream for reducer r. Returns the index triples. With
    ``codec`` each partition is block-compressed; with ``scheme`` (a
    ``coding.CodingScheme``) the parity section and v2 index are written
    too (data region byte-identical either way)."""
    return _write_primary(map_dir, partition_blobs(partitions, codec),
                          scheme)


def write_striped_map_output(
        supplier_roots: Sequence[str], primary_index: int, job_id: str,
        map_id: str, partitions: Sequence[Iterable[Tuple[bytes, bytes]]],
        scheme, codec=None,
        domains: Optional[dict] = None) -> list[tuple[int, int, int]]:
    """The coded write with cross-supplier fan-out: the primary
    (``supplier_roots[primary_index]``) gets the full MOF + parity
    section; every stripe chunk whose placement lands on a peer supplier
    gets a shard MOF under that peer's root. ``supplier_roots`` must be
    ordered like the reduce side's canonical supplier list (sorted unique
    hosts) for the placement rules to agree, and ``domains`` (a
    {supplier-root: failure domain} map, the writer-side spelling of
    ``uda.tpu.coding.domains``) must name the same domains the reduce side
    declares. With ``codec`` the partitions are compressed before they
    are coded: the stripes code the on-disk bytes."""
    from uda_tpu_torch.coding import domain_labels, rs, stripe_order

    blobs = partition_blobs(partitions, codec)
    h = len(supplier_roots)
    # encode each partition's stripe once; the primary's parity section
    # and the placement loop below both index into it
    parities = _encode_parities(blobs, scheme)
    triples = _write_primary(
        os.path.join(supplier_roots[primary_index], job_id, map_id),
        blobs, scheme, parities=parities)
    full_parts = [len(blob) for blob, _ in blobs]
    stripes = [rs.split_data(blob, scheme.k) + parity
               for (blob, _), parity in zip(blobs, parities)]
    order = stripe_order(h, primary_index,
                         domain_labels(supplier_roots, domains))
    for i in range(scheme.n):
        target = order[i % h]
        if target == primary_index:
            continue  # served off the primary's file.out by synthesis
        _write_shard(os.path.join(supplier_roots[target], job_id,
                                  shard_map_id(map_id, i)),
                     [stripe[i] for stripe in stripes], full_parts)
    return triples


class MOFWriter:
    """Job-scoped writer over the DirIndexResolver layout
    (``<root>/<job>/<map_id>/file.out[.index]``). With a coding scheme and
    the job's supplier-root table it writes the striped layout
    (``supplier_index`` names this writer's position in the canonical
    supplier order); with a scheme alone, the primary's parity section
    and v2 index. ``codec`` (a ``uda_tpu_torch.compress.Codec``)
    block-compresses every partition.

    Two seams run after each map output is on disk: ``store`` (a
    :class:`~uda_tpu_torch.mofserver.store.StoreManager`) accounts the
    written bytes against its retention watermark, so an over-budget
    supplier spills as it produces; ``on_commit(job_id, map_id)`` then
    announces the map (wire it to ``ShuffleServer.notify_commit`` and
    subscribed reduce connections receive it as MSG_PUSH chunks while the
    map phase is still running)."""

    def __init__(self, root: str, job_id: str, codec=None, scheme=None,
                 supplier_roots: Optional[Sequence[str]] = None,
                 supplier_index: int = 0,
                 domains: Optional[dict] = None, store=None,
                 on_commit=None):
        self.root = root
        self.job_id = job_id
        self.codec = codec
        self.scheme = scheme
        self.supplier_roots = list(supplier_roots or [])
        self.supplier_index = supplier_index
        self.domains = dict(domains or {})
        self.store = store
        self.on_commit = on_commit
        self.map_ids: list[str] = []

    def map_dir(self, map_id: str) -> str:
        return os.path.join(self.root, self.job_id, map_id)

    def add_supplier_root(self, root: str, domain: Optional[str] = None,
                          supplier_index: Optional[int] = None) -> None:
        """A supplier that joined mid-job enters the stripe-placement
        universe for maps not yet written (written stripes keep their
        placement: their indexes are immutable). ``supplier_index``
        re-anchors this writer when the canonical (sorted) supplier order
        shifted."""
        if root in self.supplier_roots:
            return
        self.supplier_roots.append(root)
        if domain is not None:
            self.domains[root] = domain
        if supplier_index is not None:
            self.supplier_index = supplier_index

    def write(self, map_id: str,
              partitions: Sequence[Iterable[Tuple[bytes, bytes]]]) -> None:
        if self.scheme is not None and len(self.supplier_roots) > 1:
            write_striped_map_output(self.supplier_roots,
                                     self.supplier_index, self.job_id,
                                     map_id, partitions, self.scheme,
                                     self.codec, domains=self.domains)
        else:
            write_map_output(self.map_dir(map_id), partitions, self.codec,
                             scheme=self.scheme)
        self.map_ids.append(map_id)
        if self.store is not None:
            try:
                nbytes = os.path.getsize(
                    os.path.join(self.map_dir(map_id), "file.out"))
            except OSError:
                # a striped writer may anchor the primary on a peer root;
                # retention covers only bytes under this writer's root
                nbytes = 0
            if nbytes:
                self.store.account_write(self.job_id, map_id, nbytes)
        if self.on_commit is not None:
            self.on_commit(self.job_id, map_id)
