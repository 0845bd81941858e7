"""The benchmark's own map-output writer: whole partitions of framed
records written with one call each, in the layout ``uda_tpu_torch``'s
``DirIndexResolver`` reads (``<root>/<job>/<map_id>/file.out`` and
``file.out.index``).

A partition's IFile segment is its framed records followed by the EOF
marker (vint -1, vint -1); ``file.out`` is the segments one after the
other, and ``file.out.index`` one (start, raw_length, part_length) triple
of big-endian 64-bit integers a partition (Hadoop's spill index, no
compression, no checksum trailer). The bytes equal what the port's
``MOFWriter`` writes record by record.
"""

from __future__ import annotations

import os
import struct

import numpy as np

EOF_MARKER = b"\xff\xff"
_TRIPLE = struct.Struct(">qqq")


def map_id(job: str, m: int) -> str:
    """Hadoop's map attempt id of map ``m``."""
    return f"attempt_{job}_m_{m:06d}_0"


def write_map_output(map_dir: str, partitions: list) -> list:
    """Write one map's output: ``partitions[r]`` is reducer r's framed
    records, uint8[n, width], already sorted. Returns the index
    triples."""
    os.makedirs(map_dir, exist_ok=True)
    triples = []
    start = 0
    with open(os.path.join(map_dir, "file.out"), "wb") as f:
        for rec in partitions:
            body = np.ascontiguousarray(rec, dtype=np.uint8)
            f.write(memoryview(body).cast("B"))
            f.write(EOF_MARKER)
            length = body.size + len(EOF_MARKER)
            triples.append((start, length, length))
            start += length
    with open(os.path.join(map_dir, "file.out.index"), "wb") as f:
        f.write(b"".join(_TRIPLE.pack(*t) for t in triples))
    return triples


def write_tree(root: str, job: str, parts: list) -> list:
    """One map output under ``root`` per partition in ``parts``, each map
    holding that one partition (reduce 0). Returns the map ids."""
    mids = []
    for m, rec in enumerate(parts):
        mid = map_id(job, m)
        write_map_output(os.path.join(root, job, mid), [rec])
        mids.append(mid)
    return mids
