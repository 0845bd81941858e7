"""TeraSort on one card: the flagship workload (BASELINE.md config 2).

Counterpart of the single-chip half of ``uda_tpu/models/terasort.py``.
Records are ``uint32[n, 26]`` rows: words 0-2 the big-endian packed key
(10 bytes and 2 zero pad bytes), words 3-25 the 90-byte value (2 pad
bytes). The shuffle+merge is one stable lexicographic sort of whole
records by their 3 key words, on the card.

Engines (``ops/sort.py``): ``keys8`` (the card's default) sorts the keys
with the tile-sort and merge-pass kernels K2/K1 and moves each record once
by the permutation; ``keys8f`` does the same with the slim cascade K3/K4;
``lanes``/``lanes2`` sort the full 32-row lanes layout with K2/K1;
``carry``/``gather``/``gather2``/``carrychunk`` take the permutation from
PyTorch's stable sort and move the records by it (whole rows, per column,
the stacked value columns, or chunks of ``UDA_TPU_CHUNK_COLS`` columns).
Every engine gives the same bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from uda_tpu_torch.device import generator, resolve_device
from uda_tpu_torch.interop import words_from_numpy
from uda_tpu_torch.ops import pallas_sort
from uda_tpu_torch.ops.sort import (ALL_SORT_PATHS, LANES_ENGINES, _as_i64,
                                    apply_perm_chunked, fill_words, i32,
                                    route_engine, stable_lex_argsort,
                                    take_cols, u32)

__all__ = ["KEY_WORDS", "VALUE_WORDS", "RECORD_WORDS", "RECORD_BYTES",
           "teragen", "teragen_lanes", "single_chip_sort",
           "sort_lanes_keys8", "bench_step", "validate_sorted"]

KEY_WORDS = 3        # 10 key bytes -> 3 BE words (2 pad bytes, constant 0)
VALUE_WORDS = 23     # 90 value bytes -> 23 words (2 pad bytes)
RECORD_WORDS = KEY_WORDS + VALUE_WORDS
RECORD_BYTES = 100   # logical TeraSort record size

_KEY_PAD_MASK = -65536   # 0xFFFF0000 as int32: zero the key's 2 pad bytes
_ALL_ONES = 0xFFFFFFFF


def _random_words(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform random 32-bit words (as int32, for in-place masking)."""
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         generator=gen, device=gen.device)


def teragen(gen: torch.Generator, n: int) -> torch.Tensor:
    """n TeraSort-shaped records, uint32[n, 26], drawn on ``gen``'s device:
    uniform keys with the 2 pad bytes of word 2 zeroed (so fixed-width
    memcmp order is 3-word lexicographic order) and random value bits."""
    w = _random_words(gen, (n, RECORD_WORDS))
    w[:, KEY_WORDS - 1] &= _KEY_PAD_MASK
    return u32(w)


def teragen_lanes(gen: torch.Generator, n: int) -> torch.Tensor:
    """n TeraSort-shaped records directly in the lanes layout,
    uint32[32, n]: rows 0-2 the key words (row 2's pad bytes zeroed), rows
    3-25 the value words, rows 26-31 zero."""
    w = torch.zeros((pallas_sort.ROWS, n), dtype=torch.int32,
                    device=gen.device)
    w[:RECORD_WORDS] = _random_words(gen, (RECORD_WORDS, n))
    w[KEY_WORDS - 1] &= _KEY_PAD_MASK
    return u32(w)


def _as_words(words, device) -> torch.Tensor:
    if isinstance(words, torch.Tensor):
        if words.dtype != torch.uint32:
            raise TypeError(f"records are uint32 words, got {words.dtype}")
        return u32(i32(words).to(device).contiguous())
    return words_from_numpy(words, device)


def _single_chip_sort_lanes(words: torch.Tensor, path: str,
                            tile: int) -> torch.Tensor:
    """Lanes-engine body: pad the record count to a power-of-two multiple
    of ``tile`` with all-0xFFFFFFFF-key columns and run the kernel cascade.
    Padding holds the highest columns, so even a real record whose keys
    are all 0xFFFFFFFF sorts before it (the arrival tie-break); cutting to
    n drops exactly the padding."""
    n, w = words.shape
    m, tile = pallas_sort.pad_pow2(n, tile)
    if path in ("keys8", "keys8f"):
        keyr = fill_words((KEY_WORDS, m), words.device, _ALL_ONES)
        i32(keyr)[:, :n] = i32(words)[:, :KEY_WORDS].T
        _, perm = pallas_sort.keys8_sort_perm(keyr, tile=tile,
                                              folded=path == "keys8f")
        # the sorted keys come back with the records: move each row once
        return u32(i32(words)[perm[:n]])
    mat = fill_words((pallas_sort.ROWS, m), words.device, _ALL_ONES)
    i32(mat)[:w, :n] = i32(words).T
    out = pallas_sort.sort_lanes(mat, num_keys=KEY_WORDS, tile=tile,
                                 two_phase=path == "lanes2")
    return pallas_sort.lanes_to_rows(out[:, :n], w)


def _single_chip_sort_cols(words: torch.Tensor, path: str,
                           chunk_cols: "int | None" = None) -> torch.Tensor:
    """The permutation engines: PyTorch's stable sort gives the
    permutation (the counterpart of the reference's ``lax.sort``), and the
    records move by it as whole rows ("carry"), one column at a time
    ("gather"), as the stacked value columns ("gather2"), or in chunks of
    columns ("carrychunk")."""
    w = i32(words)
    cols = list(w.T)
    perm = stable_lex_argsort(cols[:KEY_WORDS])
    if path == "carry":
        return u32(w[perm])
    if path == "gather":
        return u32(torch.stack([c[perm] for c in cols], dim=1))
    keys = torch.stack(cols[:KEY_WORDS])[:, perm]
    if path == "gather2":
        vals = w[:, KEY_WORDS:].T.contiguous()[:, perm]
    else:
        vals = torch.stack(apply_perm_chunked(perm, cols[KEY_WORDS:],
                                              chunk_cols))
    return u32(torch.cat([keys, vals]).T.contiguous())


def single_chip_sort(words, path: str = "auto", tile: int = 1024,
                     device=None) -> torch.Tensor:
    """The single-chip shuffle+merge: stable lexicographic sort of whole
    ``uint32[n, 26]`` records (a tensor or numpy array) by their 3 key
    words, on ``device`` (``None`` = the card). ``path`` names the engine;
    ``"auto"`` resolves through ``ops/sort.route_engine``: a deployed
    ``UDA_TPU_SORT_PATH``, else the tune cache's winner for this device
    and batch-size class (``utils/tuncache``), else the built-in default,
    ``keys8`` on the card and ``carry`` on the CPU; on the card a batch
    below ``SMALL_BATCH_ROWS`` (2^20) that resolved to a gather-bound
    engine is steered to ``carrychunk``."""
    dev = resolve_device(device)
    words = _as_words(words, dev)
    path = route_engine(int(words.shape[0]), path, lanes_ok=True, device=dev)
    if words.shape[0] == 0:
        return words
    if path in LANES_ENGINES:
        return _single_chip_sort_lanes(words, path, tile)
    return _single_chip_sort_cols(words, path)


def sort_lanes_keys8(x: torch.Tensor, tile: int = 1024,
                     folded: bool = False) -> torch.Tensor:
    """Stable TeraSort record sort in the lanes layout via the keys8
    cascade: equal to ``sort_lanes(x, num_keys=KEY_WORDS, tile=tile)`` on
    teragen_lanes-shaped input (layout pad rows zero), arrival-index row
    included, with the value rows moved once by the permutation.
    ``folded`` takes the slim cascade (the keys8f engine)."""
    sk, perm = pallas_sort.keys8_sort_perm(x[:KEY_WORDS], tile=tile,
                                           folded=folded)
    n = x.shape[1]
    pad = fill_words((pallas_sort.ROWS - RECORD_WORDS - 1, n), x.device)
    parts = [sk, take_cols(x[KEY_WORDS:RECORD_WORDS], perm), pad, perm[None]]
    return u32(torch.cat([i32(p) for p in parts]))


def _mul_lo32(col: torch.Tensor, mult: int) -> torch.Tensor:
    """(col * mult) mod 2^32 for int64 col in [0, 2^32) and a 32-bit
    ``mult``, in int64 without overflow (two 16-bit halves of mult)."""
    lo = col * (mult & 0xFFFF)
    hi = ((col * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _checksum_cols(cols) -> torch.Tensor:
    """Order-independent multiset fingerprint over record columns, the
    reference's formula with its uint32 wrap-around
    (uda_tpu/models/terasort.py:241-250): a distinct odd multiplier per
    column couples a word to its column, the outer sum over records is
    permutation-invariant. Returns an int64 scalar in [0, 2^32)."""
    rec = None
    for c, col in enumerate(cols):
        m = _mul_lo32(_as_i64(col),
                      (2 * c + 1) * 2654435761 & 0xFFFFFFFF)
        rec = m if rec is None else rec + m
    return ((rec & 0xFFFFFFFF) ^ 0x9E3779B9).sum() & 0xFFFFFFFF


def _violations_cols(k0, k1, k2) -> torch.Tensor:
    a = [_as_i64(k) for k in (k0, k1, k2)]
    gt = ((a[0][:-1] > a[0][1:])
          | ((a[0][:-1] == a[0][1:]) & (a[1][:-1] > a[1][1:]))
          | ((a[0][:-1] == a[0][1:]) & (a[1][:-1] == a[1][1:])
             & (a[2][:-1] > a[2][1:])))
    return gt.sum()


def bench_step(seed: int, n: int, k: int, path: str = "lanes",
               tile: int = 1024, chunk_cols: "int | None" = None,
               device=None):
    """k rounds of teragen -> sort -> validate on ``device`` (``None`` =
    the card), the records of round i drawn from one generator seeded with
    ``seed``. Returns ``(violations, ck_in, ck_out)`` as device scalars:
    total adjacent order violations, and the input and output multiset
    checksums summed over rounds (mod 2^32); the caller checks
    violations == 0 and ck_in == ck_out. ``chunk_cols`` applies to the
    "carrychunk" engine."""
    if path not in ALL_SORT_PATHS:
        raise ValueError(f"unknown bench path {path!r}")
    dev = resolve_device(device)
    gen = generator(seed, dev)
    viol = torch.zeros((), dtype=torch.int64, device=dev)
    ck_in = torch.zeros_like(viol)
    ck_out = torch.zeros_like(viol)
    for _ in range(k):
        words = teragen(gen, n)
        ck_in = (ck_in + _checksum_cols(words.T)) & 0xFFFFFFFF
        if path in LANES_ENGINES:
            out = _single_chip_sort_lanes(words, path, tile)
        else:
            out = _single_chip_sort_cols(words, path, chunk_cols)
        ck_out = (ck_out + _checksum_cols(out.T)) & 0xFFFFFFFF
        viol = viol + _violations_cols(*out.T[:KEY_WORDS])
    return viol, ck_in, ck_out


def validate_sorted(sorted_words: torch.Tensor,
                    input_words: Optional[torch.Tensor] = None,
                    valid_count: Optional[int] = None) -> None:
    """Sort-validity gate: zero adjacent order violations and, when the
    input is given, the same record multiset (checksum)."""
    sw = sorted_words if valid_count is None else sorted_words[:valid_count]
    violations = int(_violations_cols(*sw.T[:KEY_WORDS]))
    if violations:
        raise AssertionError(f"{violations} adjacent order violations")
    if input_words is not None:
        if int(_checksum_cols(sw.T)) != int(_checksum_cols(input_words.T)):
            raise AssertionError("record multiset changed during sort")
