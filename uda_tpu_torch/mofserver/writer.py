"""Map-output writing: the producer side of the MOF contract.

The port's copy of ``uda_tpu/mofserver/writer.py`` for uncompressed,
uncoded map outputs: one IFile segment per reduce partition, concatenated
into ``file.out``, with the (start, raw_length, part_length) index triples
in ``file.out.index`` (``raw_length == part_length``). The reference's
block compression (``uda_tpu/compress``) and erasure-coded stripes
(``uda_tpu/coding``) are not ported yet.
"""

from __future__ import annotations

import io
import os
from typing import Iterable, Sequence, Tuple

from uda_tpu_torch.mofserver.index import write_index_file
from uda_tpu_torch.utils.ifile import IFileWriter

__all__ = ["MOFWriter", "write_map_output", "partition_blobs"]


def partition_blobs(partitions: Sequence[Iterable[Tuple[bytes, bytes]]]
                    ) -> list[tuple[bytes, int]]:
    """Each partition as ``(on-disk bytes, raw record-byte length)``: the
    sorted records IFile-framed."""
    blobs = []
    for records in partitions:
        seg = io.BytesIO()
        w = IFileWriter(seg)
        for k, v in records:
            w.append(k, v)
        w.close()
        raw = seg.getvalue()
        blobs.append((raw, len(raw)))
    return blobs


def write_map_output(map_dir: str,
                     partitions: Sequence[Iterable[Tuple[bytes, bytes]]]
                     ) -> list[tuple[int, int, int]]:
    """Write one map attempt's output: ``partitions[r]`` is the (already
    sorted) record stream for reducer r. Returns the index triples."""
    os.makedirs(map_dir, exist_ok=True)
    mof = io.BytesIO()
    triples = []
    for blob, raw_len in partition_blobs(partitions):
        start = mof.tell()
        mof.write(blob)
        triples.append((start, raw_len, len(blob)))
    with open(os.path.join(map_dir, "file.out"), "wb") as f:
        f.write(mof.getvalue())
    write_index_file(os.path.join(map_dir, "file.out.index"), triples)
    return triples


class MOFWriter:
    """Job-scoped writer over the DirIndexResolver layout
    (``<root>/<job>/<map_id>/file.out[.index]``)."""

    def __init__(self, root: str, job_id: str):
        self.root = root
        self.job_id = job_id
        self.map_ids: list[str] = []

    def map_dir(self, map_id: str) -> str:
        return os.path.join(self.root, self.job_id, map_id)

    def write(self, map_id: str,
              partitions: Sequence[Iterable[Tuple[bytes, bytes]]]) -> None:
        write_map_output(self.map_dir(map_id), partitions)
        self.map_ids.append(map_id)
