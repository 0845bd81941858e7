"""The lane gather ``out[:, j] = x[:, perm[j]]`` on ``uint32[rows, n]``.

Counterpart of the one ``pl.pallas_call`` of ``scripts/probe_gather.py``
(kernel K5): a Mosaic lowering probe whose four kernel bodies compute this
function, the in-kernel payload gather of the reference's two-phase merge.
The kernel is CUDA C++ (``uda_tpu_torch/csrc/lane_gather.cu``) in two
designs, chosen by the size of ``x`` alone (:func:`design`): "records"
transposes ``x`` into a scratch of one 16-byte-aligned record a column and
gathers whole records; "direct" gathers one word a thread, for an ``x``
small enough to sit in L2. The wrapper launches the kernel on a CUDA tensor
and runs the plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from uda_tpu_torch.ops import _build
from uda_tpu_torch.ops.sort import i32, u32

__all__ = ["take_lanes", "take_lanes_plain", "design", "record_words",
           "SMALL_BYTES", "TILE_COLS", "MAX_ROWS"]

# Columns one block of either pass of the records design takes (kTile).
TILE_COLS = 256
# The most rows a launch takes: the direct kernel has a block row per row.
MAX_ROWS = 65535
# The largest x (rows * n * 4 bytes) the direct kernel gathers: up to here
# it beats the two passes on the card, whose x then sits in L2
# (chip_smoke.sweep_take_lanes times both designs on either side).
SMALL_BYTES = 1 << 20

_C = ctypes
_SIGNATURES = {
    "uda_lane_gather": ([_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
                         _C.c_size_t, _C.c_void_p], _C.c_int),
    "uda_lane_gather_records": ([_C.c_void_p, _C.c_void_p, _C.c_void_p,
                                 _C.c_void_p, _C.c_int, _C.c_int,
                                 _C.c_size_t, _C.c_void_p], _C.c_int),
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
