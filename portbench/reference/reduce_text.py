"""The plain reference of the Text reduce cell, in Python and NumPy.

A reduce task's output is one IFile stream: every record of its map
partitions, framed as on the map side (vint key length, vint value
length, the serialized Text key and value), in the stable order of the
keys' content, Text order being the content bytes, unsigned, the shorter
first on a tie; equal keys keep map order, then their order within the
map. One EOF marker (vint -1, vint -1) ends it. The reference parses the
partitions the benchmark made with its own vint reader, sorts their
records with Python's stable sort and judges the program's stream record
by record. The control merges by the key's first 16 content bytes,
zero-padded, and its length alone: the device merge's order without the
tie-fix of keys longer than 16 bytes.
"""

from __future__ import annotations

import numpy as np

EOF_MARKER = b"\xff\xff"
CONTROL_BLOCK = 1 << 20
CONTROL_PREFIX = 16


def read_vint(buf, pos: int) -> tuple:
    """Hadoop's ``WritableUtils.readVLong`` at ``pos``: (value, the
    position after it)."""
    first = buf[pos]
    first = first - 256 if first > 127 else first
    if first >= -112:
        return first, pos + 1
    negative = first < -120
    size = (-119 - first) if negative else (-111 - first)
    if pos + size > len(buf):
        raise ValueError("a vint runs past the end")
    value = int.from_bytes(buf[pos + 1:pos + size], "big")
    return (~value if negative else value), pos + size


def records(buf) -> tuple:
    """The records of framed IFile bytes (no EOF marker needed): a list
    of (key content, whole framed record) and the position where parsing
    stopped, at an EOF marker or the end. A record that runs past the
    end ends the list there."""
    buf = bytes(buf)
    out = []
    pos = 0
    while pos < len(buf):
        try:
            klen, p = read_vint(buf, pos)
            vlen, p = read_vint(buf, p)
            if klen == -1 and vlen == -1:
                break
            if klen < 1 or vlen < 0 or p + klen + vlen > len(buf):
                break
            tlen, q = read_vint(buf, p)
        except ValueError:
            break
        if q + tlen != p + klen:
            break
        out.append((buf[q:q + tlen], buf[pos:p + klen + vlen]))
        pos = p + klen + vlen
    return out, pos


def partition_records(parts: list) -> list:
    """Every partition's records in map order, then row order."""
    out = []
    for part in parts:
        recs, end = records(np.asarray(part, np.uint8).tobytes())
        if end != np.asarray(part).size:
            raise ValueError("a partition is not whole IFile records")
        out.extend(recs)
    return out


def merged_records(parts: list) -> list:
    """The task's framed records in their merged order."""
    recs = partition_records(parts)
    return [r for _, r in sorted(recs, key=lambda kr: kr[0])]


def control_records(parts: list) -> list:
    """The control's records: merged by the first 16 content bytes,
    zero-padded, and the length alone."""
    recs = partition_records(parts)
    return [r for _, r in sorted(recs, key=lambda kr: (
        kr[0][:CONTROL_PREFIX].ljust(CONTROL_PREFIX, b"\0"), len(kr[0])))]


def stream_of(recs: list) -> bytes:
    """The IFile stream of merged records."""
    return b"".join(recs) + EOF_MARKER


def records_out_of_place(want: list, got) -> int:
    """How many of the reference's records ``want`` the program's stream
    ``got`` (bytes-like) does not hold in their place, missing ones
    included, plus one where the stream does not end in the EOF marker
    right after the last record (a wrong length counts there too)."""
    got = bytes(got)
    if got == stream_of(want):
        return 0
    recs, end = records(got)
    bad = sum(g[1] != w for g, w in zip(recs, want)) \
        + max(0, len(want) - len(recs))
    if len(recs) != len(want) or got[end:] != EOF_MARKER:
        bad += 1
    return bad


def control(state, run) -> None:
    """Put the control in the program's place in the driver's state: each
    task hands the control's stream to the consumer in 1 MiB blocks."""
    stream = stream_of(control_records(state.parts))

    def call(consumer) -> None:
        view = memoryview(stream)
        for off in range(0, len(stream), CONTROL_BLOCK):
            consumer(view[off:off + CONTROL_BLOCK])

    state.call = call
