"""The lane gather ``out[:, j] = x[:, perm[j]]`` on ``uint32[rows, n]``,
and the row gather ``out[j, :] = words[perm[j], :]`` on ``uint32[n, w]``.

Counterpart of the one ``pl.pallas_call`` of ``scripts/probe_gather.py``
(kernel K5): a Mosaic lowering probe whose four kernel bodies compute this
function, the in-kernel payload gather of the reference's two-phase merge.
The kernel is CUDA C++ (``uda_tpu_torch/csrc/lane_gather.cu``) in two
designs, chosen by the size of ``x`` alone (:func:`design`): "records"
transposes ``x`` into a scratch of one 16-byte-aligned record a column and
gathers whole records; "direct" gathers one word a thread, for an ``x``
small enough to sit in L2. The wrapper launches the kernel on a CUDA tensor
and runs the plain PyTorch version on a CPU tensor.

The row gather (:func:`take_rows`, in the same source) moves TeraSort's
records by the sort cascade's int32 permutation, read in place: one
thread block a few hundred whole rows, 8-byte words where the rows allow
them (:func:`row_vector_words`). It replaces no TPU kernel: the reference
moves those records with XLA's ``jnp.take``.
"""

from __future__ import annotations

import ctypes

import torch

from uda_tpu_torch.ops import _build
from uda_tpu_torch.ops.sort import i32, u32

__all__ = ["take_lanes", "take_lanes_plain", "design", "record_words",
           "take_rows", "take_rows_plain", "row_vector_words",
           "SMALL_BYTES", "TILE_COLS", "MAX_ROWS", "ROW_SPAN"]

# Columns one block of either pass of the records design takes (kTile).
TILE_COLS = 256
# The most rows a launch takes: the direct kernel has a block row per row.
MAX_ROWS = 65535
# The largest x (rows * n * 4 bytes) the direct kernel gathers: up to here
# it beats the two passes on the card, whose x then sits in L2
# (chip_smoke.sweep_take_lanes times both designs on either side).
SMALL_BYTES = 1 << 20
# Vector words one block of the row gather writes at most, as whole rows
# (kRowSpan): a block takes ROW_SPAN // (w // vec) rows, or one row when
# a row is wider (vec from :func:`row_vector_words`).
ROW_SPAN = 2048

_C = ctypes
_SIGNATURES = {
    "uda_lane_gather": ([_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
                         _C.c_size_t, _C.c_void_p], _C.c_int),
    "uda_lane_gather_records": ([_C.c_void_p, _C.c_void_p, _C.c_void_p,
                                 _C.c_void_p, _C.c_int, _C.c_int,
                                 _C.c_size_t, _C.c_void_p], _C.c_int),
    "uda_row_gather": ([_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_size_t,
                        _C.c_int, _C.c_int, _C.c_void_p], _C.c_int),
}


def record_words(rows: int) -> int:
    """Words of one record of the scratch: ``rows`` rounded up to 4, so
    every record starts on a 16-byte boundary. The kernel takes this width
    from :func:`_launch`, which sizes the scratch by it."""
    return (rows + 3) // 4 * 4


def design(rows: int, n: int) -> str:
    """The kernel design for ``uint32[rows, n]``: "direct" while ``x`` is
    at most :data:`SMALL_BYTES`, else "records"."""
    return "direct" if rows * n * 4 <= SMALL_BYTES else "records"


def _check(x: torch.Tensor, perm: torch.Tensor) -> None:
    if perm.dtype != torch.int32 or perm.dim() != 1 \
            or perm.shape[0] != x.shape[-1]:
        raise ValueError(f"perm must be int32[{x.shape[-1]}], got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if perm.device != x.device:
        raise ValueError(f"perm on {perm.device}, x on {x.device}")
    # the kernel reads x where perm points, unchecked: refuse an index
    # outside [0, n) on either device (one reduction, one host sync)
    n = x.shape[-1]
    if n:
        lo, hi = torch.stack(torch.aminmax(perm)).tolist()
        if lo < 0 or hi >= n:
            raise IndexError(f"perm values must lie in [0, {n})")


def take_lanes_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version of K5's records design, on ``int32`` views: ``x``
    transposed into ``int32[n, record_words(rows)]`` (pad words 0), the
    records gathered by ``perm``, and the ``rows`` words transposed
    back."""
    _check(x, perm)
    rows, n = x.shape
    xt = i32(x).new_zeros((n, record_words(rows)))
    xt[:, :rows] = i32(x).T
    return u32(xt[perm.long(), :rows].T.contiguous())


def take_lanes(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """K5 (replaces ``scripts/probe_gather.py``'s ``pl.pallas_call``):
    ``out[r, j] = x[r, perm[j]]`` for a uint32[rows, n] ``x`` and an
    int32[n] ``perm`` whose values lie in [0, n). The kernel on a CUDA
    tensor, :func:`take_lanes_plain` on a CPU one."""
    if x.device.type == "cpu":
        return take_lanes_plain(x, perm)
    rows, n = _build.cuda_words(x).shape
    if rows > MAX_ROWS:
        raise ValueError(f"take_lanes takes at most {MAX_ROWS} rows, got "
                         f"{rows}")
    _check(x, perm)
    out = torch.empty_like(x)
    _launch(x, perm.contiguous(), out, design(rows, n))
    return out


def _launch(x: torch.Tensor, perm: torch.Tensor, out: torch.Tensor,
            how: str) -> None:
    """Launch K5's ``how`` design ("direct" or "records") on inputs that
    :func:`take_lanes` has checked, writing ``out``; the records design
    allocates its scratch here. Unchecked: the kernel reads ``x`` wherever
    ``perm`` points, so only :func:`take_lanes` and the tests and timings
    that force a design call it. Counts one launch of "take_lanes" a call,
    in either design (the records design's two passes are one K5)."""
    rows, n = x.shape
    if not rows or not n:
        return
    lib = _build.library("lane_gather", _SIGNATURES)
    stream = _build.stream_of(x)
    with torch.cuda.device(x.device):
        if how == "direct":
            _build.launch(lib, "uda_lane_gather", x.data_ptr(),
                          perm.data_ptr(), out.data_ptr(), rows, n, stream)
        elif how == "records":
            rows_p = record_words(rows)
            xt = torch.empty((n, rows_p), dtype=torch.uint32,
                             device=x.device)
            _build.launch(lib, "uda_lane_gather_records", x.data_ptr(),
                          perm.data_ptr(), xt.data_ptr(), out.data_ptr(),
                          rows, rows_p, n, stream)
        else:
            raise ValueError(f"no K5 design {how!r}")
    _build.count("take_lanes")


def row_vector_words(words: torch.Tensor) -> int:
    """uint32 words of one vector the row gather moves: 2 (8-byte loads
    and stores) where the row width is even and the rows start on 8-byte
    boundaries, else 1. Reads the shape and the base address alone."""
    return 2 if words.shape[1] % 2 == 0 and words.data_ptr() % 8 == 0 else 1


def _check_rows(words: torch.Tensor, perm: torch.Tensor) -> None:
    if words.dtype != torch.uint32 or words.dim() != 2:
        raise ValueError(f"words must be uint32[n, w], got {words.dtype} "
                         f"{tuple(words.shape)}")
    n = words.shape[0]
    if perm.dtype != torch.int32 or perm.dim() != 1 or perm.shape[0] < n:
        raise ValueError(f"perm must be int32 with at least {n} entries, "
                         f"got {perm.dtype} {tuple(perm.shape)}")
    if perm.device != words.device:
        raise ValueError(f"perm on {perm.device}, words on {words.device}")


def take_rows_plain(words: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version of the row gather: ``words[perm[:n]]`` by PyTorch's
    indexing (an int64 copy of the index). Refuses an index outside
    [0, n), which indexing would wrap or report otherwise (one
    reduction, one host sync)."""
    _check_rows(words, perm)
    n = words.shape[0]
    idx = perm[:n].long()
    if n:
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi >= n:
            raise IndexError(f"perm values must lie in [0, {n})")
    return u32(i32(words)[idx])


def take_rows(words: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[j, :] = words[perm[j], :]`` for a contiguous uint32[n, w]
    ``words`` and a contiguous int32 ``perm`` of at least n entries, of
    which the first n are read in place (the sort cascade's tie-break row
    is longer by its padding). The kernel on a CUDA tensor, which traps on
    an index outside [0, n) and allocates nothing but the output;
    :func:`take_rows_plain` on a CPU one. Counts one launch of
    "take_rows" a call on the card (none for an empty ``words``)."""
    if words.device.type == "cpu":
        return take_rows_plain(words, perm)
    n, w = _build.cuda_words(words).shape
    _check_rows(words, perm)
    if not perm.is_contiguous():
        raise ValueError("perm must be contiguous: the kernel reads it in "
                         "place")
    out = torch.empty_like(words)
    if not n or not w:
        return out
    lib = _build.library("lane_gather", _SIGNATURES)
    with torch.cuda.device(words.device):
        _build.launch(lib, "uda_row_gather", words.data_ptr(),
                      perm.data_ptr(), out.data_ptr(), n, w,
                      row_vector_words(words), _build.stream_of(words))
    _build.count("take_rows")
    return out
