"""The plain reference of the reduce cell beside a straggling supplier, in
NumPy.

Which copy of a map output served a chunk does not change what the task
owes: every map output lives on two nodes, one of them slow, and a chunk
may be fetched twice, from both, with one answer dropped. The stream must
be the one a task with one copy of every map and no slow node emits. That
is one IFile stream holding every record of all the map partitions the
benchmark made from the seed, framed as on the map side (vint key length,
vint value length, the Text key, the Text value), in the stable order of
the keys' bytes (Text order: unsigned bytes; every key here has one
length), equal keys in map order, then in their order within the map, and
one EOF marker (vint -1, vint -1) at the end. The reference works it out
from the partitions themselves, in map order, with NumPy's stable
``lexsort``, and knows nothing of replicas or speculation: a chunk
ingested twice, or one lost in a switch of source, puts records out of
place. The control merges by the key's first 4 bytes alone.
"""

from __future__ import annotations

import numpy as np

EOF_MARKER = b"\xff\xff"
_LEN_AT = 3         # the Text key's content starts after 3 vint bytes
CONTROL_BLOCK = 1 << 20


def _records_and_keys(parts: list) -> tuple:
    """Every partition's records in map order, uint8[n, width], and their
    keys' content; every record must have the one Text framing."""
    rec = np.concatenate(parts)
    key_len = int(rec[0, 2])
    want = np.array([key_len + 1, rec[0, 1], key_len], np.uint8)
    if key_len > 127 or not (rec[:, :_LEN_AT] == want).all():
        raise ValueError("records are not of one Text framing")
    return rec, rec[:, _LEN_AT:_LEN_AT + key_len]


def _stable_order(keys: np.ndarray) -> np.ndarray:
    """The stable order of equal-length byte keys, the first byte most
    significant (``lexsort`` sorts by its last row first)."""
    return np.lexsort(keys.T[::-1])


def merged_records(parts: list) -> np.ndarray:
    """The task's records in their merged order, uint8[n, width]."""
    rec, keys = _records_and_keys(parts)
    return rec[_stable_order(keys)]


def control_records(parts: list) -> np.ndarray:
    """The control's records: merged by the key's first 4 bytes alone."""
    rec, keys = _records_and_keys(parts)
    return rec[_stable_order(keys[:, :4])]


def records_out_of_place(want: np.ndarray, got) -> int:
    """How many of the reference's records ``want`` the program's stream
    ``got`` (bytes-like) does not hold in their place, missing ones
    included, plus one where the stream does not end in the EOF marker
    right after the last record (a wrong length counts there too)."""
    n, width = want.shape
    buf = np.frombuffer(got, np.uint8)
    whole = min(n, buf.size // width)
    body = buf[:whole * width].reshape(whole, width)
    bad = int((body != want[:whole]).any(axis=1).sum()) + (n - whole)
    if buf.size != n * width + len(EOF_MARKER) \
            or bytes(buf[-2:]) != EOF_MARKER:
        bad += 1
    return bad


def control(state, run) -> None:
    """Put the control in the program's place in a wire driver's state:
    each task hands the control's stream to the consumer in 1 MiB
    blocks."""
    stream = control_records(state.parts).tobytes() + EOF_MARKER

    def call(consumer) -> None:
        view = memoryview(stream)
        for off in range(0, len(stream), CONTROL_BLOCK):
            consumer(view[off:off + CONTROL_BLOCK])

    state.call = call
