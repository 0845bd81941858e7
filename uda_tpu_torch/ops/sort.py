"""Engine names, engine routing and the plain sort operations of the port.

Counterpart of ``uda_tpu/ops/sort.py``. This slice carries the engine-name
tuples, ``resolve_sort_path`` / ``route_engine`` with a device argument,
``apply_perm_chunked`` and ``stable_lex_argsort``, the port's stable
lexicographic sort permutation over uint32 key words (the counterpart of
``lax.sort(..., is_stable=True)``, behind the ``carry``, ``gather``,
``gather2`` and ``carrychunk`` engines).

Torch's ``uint32`` support is thin (on the CPU it has no ``<``, ``gather``
or ``index_select`` for it, and the card is not assumed to have more), so
the port compares int64 copies of the words and fills, copies, joins and
moves uint32 data through ``int32`` views, which keep the bits
(:func:`i32`, :func:`u32`).
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

from uda_tpu_torch.device import resolve_device

__all__ = ["resolve_sort_path", "route_engine", "apply_perm_chunked",
           "stable_lex_argsort", "take_cols", "i32", "u32", "words_of",
           "fill_words", "LANES_ENGINES", "FLYOFF_ENGINES", "BENCH_FLYOFF",
           "ALL_SORT_PATHS", "DEFAULT_CHUNK_COLS", "DEPLOYED_SORT_PATH"]

# The engine knobs, under the reference's names, read once at import.
DEFAULT_CHUNK_COLS = int(os.environ.get("UDA_TPU_CHUNK_COLS", "6"))
DEPLOYED_SORT_PATH = os.environ.get("UDA_TPU_SORT_PATH", "")

# The engine names (uda_tpu/ops/sort.py:81-84). LANES_ENGINES run the
# kernel cascade (ops/pallas_sort.py, ops/pallas_fold.py); the rest compute
# a stable sort permutation and move the records by it.
LANES_ENGINES = ("lanes", "lanes2", "keys8", "keys8f")
FLYOFF_ENGINES = ("lanes", "lanes2", "keys8", "gather2", "carrychunk")
BENCH_FLYOFF = FLYOFF_ENGINES + ("keys8f",)
ALL_SORT_PATHS = ("carry", "gather") + BENCH_FLYOFF

_I32_BIAS = 1 << 31


def resolve_sort_path(path: str, lanes_ok: bool = False,
                      device=None) -> str:
    """Resolve an engine name. ``"auto"`` takes a deployed
    ``UDA_TPU_SORT_PATH`` the caller can run, else the device's default:
    ``carry`` on the CPU (as the reference), ``keys8`` on the card, so the
    main path goes through the tile-sort and merge-pass kernels (``gather``
    for a caller that runs no lanes engine). ``lanes_ok`` admits
    LANES_ENGINES for callers that implement them."""
    valid = (ALL_SORT_PATHS if lanes_ok
             else tuple(p for p in ALL_SORT_PATHS if p not in LANES_ENGINES))
    if path == "auto":
        if DEPLOYED_SORT_PATH:
            if DEPLOYED_SORT_PATH not in ALL_SORT_PATHS:
                raise ValueError(
                    f"UDA_TPU_SORT_PATH={DEPLOYED_SORT_PATH!r} is not a "
                    f"known sort path {ALL_SORT_PATHS}")
            if DEPLOYED_SORT_PATH in valid:
                return DEPLOYED_SORT_PATH
        if resolve_device(device).type == "cpu":
            path = "carry"
        else:
            path = "keys8" if lanes_ok else "gather"
    if path not in valid:
        raise ValueError(f"unknown sort path {path!r}")
    return path


def route_engine(n_rows: int, path: str = "auto", lanes_ok: bool = False,
                 device=None) -> str:
    """The resolution entry of the production sort surfaces
    (``models/terasort.single_chip_sort``). In this slice it is
    :func:`resolve_sort_path`; the reference's tune-cache consult and its
    small-batch steering by ``n_rows`` (uda_tpu/ops/sort.py:145-198) are
    not ported yet. An explicit path is always honoured."""
    del n_rows  # the small-batch steering that reads it is not ported
    return resolve_sort_path(path, lanes_ok, device)


def i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 view of 32-bit words (same bits)."""
    return x.view(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 view of 32-bit words (same bits)."""
    return x.view(torch.uint32)


def words_of(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 words, exactly."""
    return u32(torch.where(values >= _I32_BIAS, values - (1 << 32),
                           values).to(torch.int32))


def fill_words(shape, device, value: int = 0) -> torch.Tensor:
    """A uint32 tensor of ``shape`` filled with ``value`` (< 2^32)."""
    fill = value - (1 << 32) if value >= _I32_BIAS else value
    return u32(torch.full(shape, fill, dtype=torch.int32, device=device))


def take_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` for 32-bit words, through an int32 view."""
    return i32(x)[..., idx].view(x.dtype)


def _as_i64(word: torch.Tensor) -> torch.Tensor:
    """32-bit words (or int64 values in [0, 2^32)) as int64 values in
    [0, 2^32)."""
    if word.dtype in (torch.uint32, torch.int32):
        word = i32(word)
    return word.to(torch.int64) & 0xFFFFFFFF


def _packed_keys(words: Sequence[torch.Tensor]) -> list:
    """Pack uint32 words (most significant first) two to an int64 whose
    signed order is their lexicographic order: (hi - 2^31) * 2^32 + lo."""
    keys = []
    for i in range(0, len(words), 2):
        hi = _as_i64(words[i])
        if i + 1 == len(words):
            keys.append(hi)
        else:
            keys.append((hi - _I32_BIAS) * (1 << 32) + _as_i64(words[i + 1]))
    return keys


def stable_lex_argsort(words: Sequence[torch.Tensor],
                       dim: int = -1) -> torch.Tensor:
    """Stable sort permutation of records by their key words, lexicographic
    and unsigned, most significant word first: equal keys keep arrival
    order. ``words``: uint32 tensors of one shape; the sort runs along
    ``dim`` (batched over the other dimensions). Returns int64 indices."""
    order = None
    for key in reversed(_packed_keys(words)):
        if order is not None:
            key = torch.gather(key, dim, order)
        _, idx = torch.sort(key, dim=dim, stable=True)
        order = idx if order is None else torch.gather(order, dim, idx)
    return order


def apply_perm_chunked(perm: torch.Tensor, cols: Sequence[torch.Tensor],
                       chunk_cols: "int | None" = None) -> list:
    """``out[c][j] == cols[c][perm[j]]``, moving ``chunk_cols`` columns
    (default ``UDA_TPU_CHUNK_COLS``) per gather. The reference inverts the
    permutation and re-sorts chunks because XLA's variadic-sort compile
    time forbids wide sorts on the TPU; on the card a gather is the
    port."""
    if chunk_cols is None:
        chunk_cols = DEFAULT_CHUNK_COLS
    out: list = []
    for base in range(0, len(cols), chunk_cols):
        chunk = torch.stack([i32(c) for c in cols[base:base + chunk_cols]])
        out.extend(c.view(cols[0].dtype) for c in chunk[:, perm].unbind(0))
    return out
