"""The plain reference of the reduce cells, in NumPy.

A reduce task's output is one IFile stream: every record of its map
partitions, framed as on the map side (vint key length, vint value
length, the Text key, the Text value), in the stable order of the
records' keys, Text order being the bytes of the key, unsigned, the
shorter first on a tie; equal keys keep map order, then their order
within the map. One EOF marker (vint -1, vint -1) ends it. The reference
works the stream out from the partitions the benchmark made and judges
the program's stream against it. The control merges by the key's first 4
bytes alone.
"""

from __future__ import annotations

import numpy as np

EOF_MARKER = b"\xff\xff"
_LEN_AT = 3         # the Text key's content starts after 3 vint bytes


def _frame(parts: list) -> tuple:
    """The records of every partition, uint8[n, width], in map order, and
    their keys' content, uint8[n, key bytes]. Every record must have the
    one framing the configuration states."""
    rec = np.concatenate(parts)
    head = rec[0, :_LEN_AT]
    if not (rec[:, :_LEN_AT] == head).all():
        raise ValueError("records of more than one framing")
    key_len = int(head[2])
    if head[0] != key_len + 1 or key_len > 127:
        raise ValueError(f"framing {head.tolist()} is not a Text key")
    return rec, rec[:, _LEN_AT:_LEN_AT + key_len]


def _stable_bytewise(keys: np.ndarray) -> np.ndarray:
    """The stable order of equal-length byte keys, least significant byte
    first."""
    order = np.arange(keys.shape[0])
    for col in range(keys.shape[1] - 1, -1, -1):
        order = order[np.argsort(keys[order, col], kind="stable")]
    return order


def merged_records(parts: list) -> np.ndarray:
    """The task's records in their merged order, uint8[n, width]."""
    rec, keys = _frame(parts)
    return rec[_stable_bytewise(keys)]


def control_records(parts: list) -> np.ndarray:
    """The control's records: merged by the key's first 4 bytes alone."""
    rec, keys = _frame(parts)
    return rec[_stable_bytewise(keys[:, :4])]


def stream_of(records: np.ndarray) -> bytes:
    """The IFile stream of merged records."""
    return records.tobytes() + EOF_MARKER


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


CONTROL_BLOCK = 1 << 20


def control(state, run) -> None:
    """Put the control in the program's place in a reduce driver's state:
    each task hands the control's stream to the consumer in 1 MiB
    blocks."""
    stream = stream_of(control_records(state.parts))

    def call(consumer) -> None:
        view = memoryview(stream)
        for off in range(0, len(stream), CONTROL_BLOCK):
            consumer(view[off:off + CONTROL_BLOCK])

    state.call = call
