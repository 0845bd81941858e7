"""Hadoop zero-compressed VInt/VLong codec (the port's copy of
``uda_tpu/utils/vint.py``).

Byte-exact reimplementation of the Hadoop ``WritableUtils.writeVLong`` /
``readVLong`` wire format, which the reference implements natively in
``StreamUtility::serialize/deserializeLong`` (reference
src/CommUtils/IOUtility.cc:167-332, getVIntSize :367-382, decodeVIntSize
:389-397). Every IFile record is framed with two VInts (key length, value
length) in this encoding, and the EOF marker is the pair (-1, -1), so this
codec is the byte-level contract the whole framework shares.

Wire format recap:

- values in [-112, 127] are encoded as a single byte (the value itself);
- otherwise the first byte encodes sign and byte-count:
  ``-113..-120`` => positive value of (``-b - 112``) big-endian bytes,
  ``-121..-128`` => negative value, stored as ``~v`` in (``-b - 120``)
  big-endian bytes;
- multi-byte bodies never have a leading zero byte (minimal length).

The reference's bulk numpy codec (``encode_vlong_array``,
``decode_vlong_stream``) is not copied: nothing in the port calls it.
"""

from __future__ import annotations

__all__ = [
    "encode_vlong",
    "decode_vlong",
    "vlong_size",
    "decode_vint_size",
]


def vlong_size(value: int) -> int:
    """Number of bytes ``encode_vlong(value)`` produces.

    Mirror of ``StreamUtility::getVIntSize`` (reference
    src/CommUtils/IOUtility.cc:367-382).
    """
    if -112 <= value <= 127:
        return 1
    if value < 0:
        value = ~value
    # body bytes needed for the magnitude, plus the tag byte
    n = 0
    while value:
        value >>= 8
        n += 1
    return n + 1


def decode_vint_size(first_byte: int) -> int:
    """Total encoded length given the (signed) first byte.

    Mirror of ``StreamUtility::decodeVIntSize`` (reference
    src/CommUtils/IOUtility.cc:389-397).
    """
    if first_byte >= -112:
        return 1
    if first_byte >= -120:
        return -111 - first_byte
    return -119 - first_byte


def encode_vlong(value: int) -> bytes:
    """Encode one integer in Hadoop zero-compressed VLong format."""
    if -112 <= value <= 127:
        return bytes([value & 0xFF])
    tag = -112
    if value < 0:
        value = ~value
        tag = -120
    body = []
    tmp = value
    while tmp:
        body.append(tmp & 0xFF)
        tmp >>= 8
    tag -= len(body)
    return bytes([tag & 0xFF]) + bytes(reversed(body))


def decode_vlong(buf, offset: int = 0) -> tuple[int, int]:
    """Decode one VLong from ``buf`` at ``offset``.

    Returns ``(value, new_offset)``. Raises ``IndexError`` on a truncated
    buffer (the caller implements rewind-on-partial, matching the
    reference's deserialize rewind semantics, IOUtility.cc:228-332).
    """
    first = buf[offset]
    if first > 127:
        first -= 256
    size = decode_vint_size(first)
    if size == 1:
        return first, offset + 1
    end = offset + size
    if end > len(buf):
        raise IndexError("truncated VLong")
    value = 0
    for i in range(offset + 1, end):
        value = (value << 8) | buf[i]
    if first < -120:
        value = ~value
    return value, end
