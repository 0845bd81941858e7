"""The benchmark's inputs, made from ``--seed``: the same seed gives the
same bytes, and every seed gives the same sizes.

``teragen`` makes TeraSort records on the card in the port's
``uint32[n, 26]`` form (a copy of ``uda_tpu_torch.models.terasort.
teragen``'s layout); ``tera_partitions`` makes a reduce task's sorted map
partitions as framed IFile records on the host (after ``chip_smoke.
tera_partitions``, with the key range of one reducer's partition).
"""

from __future__ import annotations

import numpy as np
import torch

KEY_WORDS = 3          # 10 key bytes, big-endian, then 2 zero pad bytes
RECORD_WORDS = 26      # + 23 value words (90 value bytes, 2 pad bytes)
KEY_BYTES = 10
VALUE_BYTES = 90
# one framed IFile record: vint 11, vint 91, the Text key (vint 10, 10 B)
# and the Text value (vint 90, 90 B)
FRAMED_BYTES = 104
FRAME_HEAD = (11, 91, 10)
_KEY_AT = 3
_VALUE_HEAD_AT = 13

_KEY_PAD_MASK = -65536  # 0xFFFF0000 as int32: word 2 keeps 2 key bytes


def seed64(seed: int) -> int:
    """A seed of any size as a 64-bit unsigned value."""
    return int(seed) % (1 << 64)


def card_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed``."""
    return torch.Generator(device=device).manual_seed(seed64(seed))


def teragen(gen: torch.Generator, n: int) -> torch.Tensor:
    """n TeraSort records, uint32[n, 26], drawn on ``gen``'s device in one
    call: uniform keys with the 2 pad bytes of word 2 zeroed, random
    value bits."""
    w = torch.randint(-(1 << 31), 1 << 31, (n, RECORD_WORDS),
                      dtype=torch.int32, generator=gen, device=gen.device)
    w[:, KEY_WORDS - 1] &= _KEY_PAD_MASK
    return w.view(torch.uint32)


def partition_keys(rng: np.random.Generator, n: int, reducers: int,
                   partition: int) -> np.ndarray:
    """n uniform 10-byte keys (uint8[n, 10]) inside ``partition``'s share
    of the key space under a total-order partitioner over ``reducers``
    (a power of two up to 2^32): the key's top log2(reducers) bits are
    the partition's number."""
    bits = int(reducers).bit_length() - 1
    if reducers < 1 or 1 << bits != reducers or bits > 32:
        raise ValueError(f"reducers={reducers} is not a power of two "
                         f"up to 2^32")
    if not 0 <= partition < reducers:
        raise ValueError(f"partition {partition} not in [0, {reducers})")
    keys = rng.integers(0, 256, (n, KEY_BYTES), dtype=np.uint8)
    if bits:
        head = keys[:, :4].copy().view(">u4").ravel()
        head = (head & np.uint32((1 << (32 - bits)) - 1)) \
            | np.uint32(partition << (32 - bits) if bits < 32 else partition)
        keys[:, :4] = head.astype(">u4").view(np.uint8).reshape(n, 4)
    return keys


def key_order(keys: np.ndarray) -> np.ndarray:
    """The stable order of 10-byte keys (uint8[n, 10]), bytewise."""
    hi = keys[:, :8].copy().view(">u8").ravel()
    lo = keys[:, 8:].copy().view(">u2").ravel()
    order = np.argsort(lo, kind="stable")
    return order[np.argsort(hi[order], kind="stable")]


def tera_partitions(seed: int, maps: int, records: int, reducers: int = 1,
                    partition: int = 0) -> list:
    """Each map's partition for one reducer, as a map-side sort leaves it:
    uint8[records, 104] framed IFile records sorted by key, keys inside
    the reducer's key range, random values."""
    rng = np.random.default_rng(seed64(seed))
    parts = []
    for _ in range(maps):
        keys = partition_keys(rng, records, reducers, partition)
        rec = np.empty((records, FRAMED_BYTES), np.uint8)
        rec[:, :_KEY_AT] = FRAME_HEAD
        rec[:, _KEY_AT:_VALUE_HEAD_AT] = keys[key_order(keys)]
        rec[:, _VALUE_HEAD_AT] = VALUE_BYTES
        rec[:, _VALUE_HEAD_AT + 1:] = rng.integers(
            0, 256, (records, VALUE_BYTES), dtype=np.uint8)
        parts.append(rec)
    return parts
