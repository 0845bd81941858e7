"""Host-side packing: variable-length records -> fixed-stride device columns.

The port's copy of ``uda_tpu/ops/packing.py`` (numpy; the columns go to
the card in ``uda_tpu_torch/ops/sort.py`` and ``ops/merge.py``).

The reference's merge engine walks variable-length VInt-framed records
with a comparator called per heap adjustment (reference
src/Merger/MergeQueue.h:151-270, StreamRW.cc:334-449). That shape does
not map onto an accelerator's vector units. The device representation is:

- ``key_words``: uint32[n, W/4] — the normalized key prefix, packed
  big-endian so uint32 numeric order == memcmp byte order;
- ``key_lens``: int32[n] — content length (shorter-is-smaller tiebreak);
- ``ranks``: int32[n] — overflow tiebreak for keys longer than the
  carried width whose prefixes collide (computed on host; rare);
- optional fixed-stride payload words for fully device-resident sorts
  (e.g. TeraSort's 10-byte keys / 90-byte values).

Everything here is vectorized numpy (one pass over the batch, no
per-record Python in the common key types). Comparator *semantics* come
from uda_tpu_torch.utils.comparators; this module only vectorizes them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from uda_tpu_torch.utils.comparators import KeyType
from uda_tpu_torch.utils.errors import MergeError
from uda_tpu_torch.utils.ifile import RecordBatch

__all__ = ["PackedKeys", "content_spans", "pack_keys", "overflow_ranks",
           "pack_fixed_payload", "unpack_fixed_payload"]


@dataclasses.dataclass
class PackedKeys:
    """Device-ready sort columns for one batch of records."""

    key_words: np.ndarray   # uint32 [n, W/4]
    key_lens: np.ndarray    # int32 [n]
    ranks: Optional[np.ndarray]  # int32 [n]; None where not computed

    @property
    def num_records(self) -> int:
        return int(self.key_words.shape[0])

    @property
    def width(self) -> int:
        return int(self.key_words.shape[1]) * 4


def content_spans(batch: RecordBatch, kt: KeyType) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``KeyType.content``: (offset, length) of the comparable
    bytes of every key, without touching per-record Python.

    Strategies mirror reference CompareFunc.cc:70-91: Text skips its VInt
    length prefix, BytesWritable skips a fixed 4-byte length, everything
    else compares the serialized bytes directly.
    """
    off = batch.key_off
    ln = batch.key_len
    if kt.name == "text":
        if np.any(ln < 1):
            raise MergeError("empty serialized Text key")
        first = batch.data[off].astype(np.int16)
        first = np.where(first > 127, first - 256, first)
        vsize = np.where(first >= -112, 1,
                         np.where(first >= -120, -111 - first, -119 - first))
        vsize = vsize.astype(np.int64)
        return off + vsize, ln - vsize
    if kt.name in ("bytes", "ibytes"):
        if np.any(ln < 4):
            raise MergeError("BytesWritable key shorter than its length field")
        return off + 4, ln - 4
    # identity / sign-flip types: content == serialized bytes
    return off, ln


def _gather_padded(data: np.ndarray, off: np.ndarray, take: np.ndarray,
                   width: int) -> np.ndarray:
    """Vectorized gather of [n, width] bytes: data[off+j] for j < take,
    zero-padded past each row's take."""
    j = np.arange(width, dtype=np.int64)
    w = int(take[0]) if take.shape[0] else 0
    if 0 < w <= width and np.all(take == w):
        # constant content width (TeraSort shape, fixed-width numerics):
        # one unmasked gather + zero columns — skips the index/value
        # where-mask passes, the staging hot path's biggest constant
        out = np.zeros((take.shape[0], width), np.uint8)
        out[:, :w] = data[off[:, None] + j[None, :w]]
        return out
    idx = off[:, None] + j[None, :]
    mask = j[None, :] < take[:, None]
    idx = np.where(mask, idx, 0)
    return np.where(mask, data[idx], 0).astype(np.uint8)


def _bytes_to_words(raw: np.ndarray) -> np.ndarray:
    """[n, 4k] uint8 -> big-endian uint32 [n, k]: the ONE place the lane
    layout is defined (memcmp byte order == ascending word order)."""
    n, nbytes = raw.shape
    w = raw.reshape(n, nbytes // 4, 4)
    return ((w[:, :, 0].astype(np.uint32) << 24)
            | (w[:, :, 1].astype(np.uint32) << 16)
            | (w[:, :, 2].astype(np.uint32) << 8)
            | w[:, :, 3].astype(np.uint32))


def _words_to_bytes(words: np.ndarray) -> np.ndarray:
    """Inverse of _bytes_to_words: uint32 [n, k] -> uint8 [n, 4k]."""
    n, k = words.shape
    raw = np.empty((n, k * 4), np.uint8)
    raw[:, 0::4] = (words >> 24) & 0xFF
    raw[:, 1::4] = (words >> 16) & 0xFF
    raw[:, 2::4] = (words >> 8) & 0xFF
    raw[:, 3::4] = words & 0xFF
    return raw


def pack_keys(batch: RecordBatch, kt: KeyType, width: int, *,
              ranks: bool = True) -> PackedKeys:
    """Pack normalized key prefixes into big-endian uint32 lane columns.
    ``ranks=False`` leaves the overflow ranks out (``PackedKeys.ranks``
    None): the overlapped merger's runs never read them (it orders keys
    past the width by their bytes after the device merge)."""
    if width % 4 != 0 or width <= 0:
        raise MergeError(f"key width must be a positive multiple of 4, got {width}")
    n = batch.num_records
    if n == 0:
        return PackedKeys(np.zeros((0, width // 4), np.uint32),
                          np.zeros(0, np.int32),
                          np.zeros(0, np.int32) if ranks else None)
    off, ln = content_spans(batch, kt)
    raw = _gather_padded(batch.data, off, np.minimum(ln, width), width)
    if kt.name in ("int_numeric", "long_numeric"):
        raw[:, 0] ^= 0x80  # sign-bit flip: memcmp order == numeric order
    words = _bytes_to_words(raw)
    return PackedKeys(words, ln.astype(np.int32),
                      overflow_ranks(batch, raw, off, ln, width)
                      if ranks else None)


def overflow_ranks(batch: RecordBatch, prefixes: np.ndarray,
                   content_off: np.ndarray, content_len: np.ndarray,
                   width: int) -> np.ndarray:
    """Third sort column: orders keys whose content exceeds ``width`` and
    whose carried prefixes collide.

    Host-side: group the (rare) overflowing keys by prefix, order each
    group by its full *content* bytes — NOT the serialized key, whose
    length prefix (Text VInt / BytesWritable length field) would
    dominate the comparison — and assign dense ranks. Keys that fit the
    width keep rank 0 — the (prefix, length) pair already orders them
    exactly (see comparators.KeyType.normalize).
    """
    n = batch.num_records
    ranks = np.zeros(n, np.int32)
    over = np.nonzero(content_len > width)[0]
    if over.size == 0:
        return ranks

    def content(i: int) -> bytes:
        o, l = int(content_off[i]), int(content_len[i])
        return batch.data[o:o + l].tobytes()

    groups: dict[bytes, list[int]] = {}
    for i in over.tolist():
        groups.setdefault(prefixes[i].tobytes(), []).append(i)
    for members in groups.values():
        if len(members) < 2:
            continue
        full = sorted(members, key=lambda i: (content(i), i))
        # dense rank by full content bytes (equal contents share a rank
        # so the stable sort preserves arrival order among them)
        r = 0
        prev = None
        for i in full:
            kb = content(i)
            if prev is not None and kb != prev:
                r += 1
            ranks[i] = r
            prev = kb
    return ranks


def pack_fixed_payload(batch: RecordBatch, stride: int) -> np.ndarray:
    """Pack fixed-width values into uint32[n, ceil(stride/4)] for fully
    device-resident sorts (TeraSort: 90-byte values -> 23 words).

    Raises if any value exceeds ``stride``; shorter values are zero-padded
    (their true length travels in the batch's ``val_len`` column).
    """
    if np.any(batch.val_len > stride):
        raise MergeError(f"value exceeds fixed stride {stride}")
    wstride = (stride + 3) // 4 * 4
    raw = _gather_padded(batch.data, batch.val_off, batch.val_len, wstride)
    return _bytes_to_words(raw)


def unpack_fixed_payload(words: np.ndarray, lengths: Optional[np.ndarray],
                         stride: int) -> list[bytes]:
    """Inverse of pack_fixed_payload (host side, for emission)."""
    words = np.asarray(words, dtype=np.uint32)
    raw = _words_to_bytes(words)
    n = raw.shape[0]
    if lengths is None:
        return [raw[i, :stride].tobytes() for i in range(n)]
    return [raw[i, : int(lengths[i])].tobytes() for i in range(n)]
