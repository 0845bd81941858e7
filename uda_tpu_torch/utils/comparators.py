"""Key comparators: Hadoop RawComparator semantics + device normalization.

The port's copy of ``uda_tpu/utils/comparators.py``: the same registry of
key classes, the same content, compare and normalize rules.

The reference maps a Java key *class name* to a native compare function
(reference src/Merger/CompareFunc.cc:70-113):

- ``org.apache.hadoop.io.Text``: skip the VInt length-prefix bytes, then
  bytewise compare (CompareFunc.cc:82-86);
- fixed-width byte-comparables (Boolean/Byte/Short/Int/Long Writable):
  plain memcmp over the serialized bytes (CompareFunc.cc:70-78);
- ``BytesWritable`` / ``ImmutableBytesWritable``: skip the 4-byte length,
  then bytewise (CompareFunc.cc:89-91);
- anything else raises (-> Java falls back to vanilla shuffle,
  CompareFunc.cc:95-113).

TPU-first design: instead of calling a comparator per heap adjustment
(the reference's hot loop, src/Merger/MergeQueue.h:151-270), we
*normalize* every key once at staging time into a fixed-width big-endian
byte string plus a content-length column; the pair (prefix bytes, length)
memcmp-orders exactly like the comparator for keys that fit the carried
width, and ties beyond the width are broken by a full-key overflow rank
computed on host for the rare long-key case. Normalized keys pack into
uint32 words and sort on the device by a stable lexicographic sort (see
uda_tpu_torch.ops.sort).

Note on memcmp vs numeric order: the reference deliberately uses memcmp
for Int/Long writables, which orders negative keys after positive ones
(two's-complement high bit). We reproduce that exactly for parity; the
additional ``*_numeric`` key types flip the sign bit during
normalization for users who want true numeric order on device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from uda_tpu_torch.utils import vint
from uda_tpu_torch.utils.errors import UdaError

__all__ = ["KeyType", "get_key_type", "register_key_type", "memcmp",
           "uses_default_bytewise"]


def memcmp(a: bytes, b: bytes) -> int:
    """Bytewise compare with shorter-is-smaller tiebreak (memcmp + length)."""
    if a == b:
        return 0
    return -1 if a < b else 1


@dataclasses.dataclass(frozen=True)
class KeyType:
    """Per-key-class behavior.

    ``content(serialized)`` extracts the comparable content bytes from the
    serialized key (e.g. strips Text's VInt prefix). ``compare`` is the
    host-side comparator over *serialized* keys. ``normalize(serialized,
    width)`` returns exactly ``width`` bytes whose memcmp order equals
    ``compare`` order for keys whose content fits in ``width`` bytes
    (longer keys additionally need the overflow tiebreak, see
    uda_tpu_torch.ops.packing.overflow_ranks).
    """

    name: str
    content: Callable[[bytes], bytes]
    fixed_width: int = 0  # >0 when every key has this serialized width

    def compare(self, a: bytes, b: bytes) -> int:
        return memcmp(self.content(a), self.content(b))

    def normalize(self, serialized: bytes, width: int) -> tuple[bytes, int]:
        """Returns ``(padded_prefix, content_length)``.

        The full device sort key is (prefix bytes, overflow rank,
        content length) — see uda_tpu_torch.ops.sort._key_columns for why rank
        precedes length. For keys whose content fits in ``width`` the
        (prefix, length) columns order exactly like ``compare``
        (zero-padding alone would collapse e.g. b"a" and b"a\\x00"; the
        length column restores the shorter-is-smaller memcmp rule); keys
        longer than ``width`` with equal prefixes are ordered by the rank
        column (uda_tpu_torch.ops.packing.overflow_ranks).
        """
        c = self.content(serialized)
        if len(c) >= width:
            return c[:width], len(c)
        return c + b"\x00" * (width - len(c)), len(c)


def uses_default_bytewise(kt: KeyType) -> bool:
    """True when ``kt.compare`` is the stock bytewise order — memcmp
    over ``content()`` with the shorter-is-smaller tiebreak — i.e. the
    method was not overridden by a subclass. For such key types the
    comparator order equals a (zero-padded content bytes, content
    length) lexicographic order, so hot paths may replace per-record
    ``cmp_to_key`` Python comparisons with one vectorized
    ``np.lexsort`` (uda_tpu_torch.merger.overlap's oversize-key spool
    path). A subclass with a custom ``compare`` always gets the
    comparator-faithful slow path."""
    return type(kt).compare is KeyType.compare


def _text_content(serialized: bytes) -> bytes:
    # Text serializes as VInt(len) + utf8 bytes; comparator skips the VInt
    # (reference CompareFunc.cc:82-86).
    n, off = vint.decode_vlong(serialized, 0)
    return bytes(serialized[off:off + n])


def _bytes_writable_content(serialized: bytes) -> bytes:
    # BytesWritable serializes as 4-byte big-endian length + bytes;
    # comparator skips the length (reference CompareFunc.cc:89-91).
    return bytes(serialized[4:])


def _identity(serialized: bytes) -> bytes:
    return bytes(serialized)


def _flip_sign_bit(width: int) -> Callable[[bytes], bytes]:
    def content(serialized: bytes) -> bytes:
        b = bytearray(serialized[:width])
        b[0] ^= 0x80
        return bytes(b)
    return content


_REGISTRY: Dict[str, KeyType] = {}


def register_key_type(java_class: str, kt: KeyType) -> None:
    _REGISTRY[java_class] = kt


def get_key_type(java_class: str) -> KeyType:
    """Key class name -> KeyType; raises UdaError for unsupported classes
    (matching reference get_compare_func -> UdaException -> fallback,
    CompareFunc.cc:95-113)."""
    kt = _REGISTRY.get(java_class)
    if kt is None:
        raise UdaError(f"unsupported key class for native merge: {java_class}")
    return kt


# Reference-supported classes (CompareFunc.cc:70-91):
register_key_type("org.apache.hadoop.io.Text",
                  KeyType("text", _text_content))
register_key_type("org.apache.hadoop.io.BooleanWritable",
                  KeyType("boolean", _identity, fixed_width=1))
register_key_type("org.apache.hadoop.io.ByteWritable",
                  KeyType("byte", _identity, fixed_width=1))
register_key_type("org.apache.hadoop.io.ShortWritable",
                  KeyType("short", _identity, fixed_width=2))
register_key_type("org.apache.hadoop.io.IntWritable",
                  KeyType("int", _identity, fixed_width=4))
register_key_type("org.apache.hadoop.io.LongWritable",
                  KeyType("long", _identity, fixed_width=8))
register_key_type("org.apache.hadoop.io.BytesWritable",
                  KeyType("bytes", _bytes_writable_content))
register_key_type("org.apache.hadoop.hbase.io.ImmutableBytesWritable",
                  KeyType("ibytes", _bytes_writable_content))

# New in this framework: numeric-order variants (sign-bit flip makes
# memcmp order == numeric order on device).
register_key_type("uda.tpu.IntNumeric",
                  KeyType("int_numeric", _flip_sign_bit(4), fixed_width=4))
register_key_type("uda.tpu.LongNumeric",
                  KeyType("long_numeric", _flip_sign_bit(8), fixed_width=8))
# Raw bytes with no framing (TeraSort-style fixed 10-byte keys etc).
register_key_type("uda.tpu.RawBytes", KeyType("raw", _identity))
