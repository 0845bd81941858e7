"""The slim keys cascade: the keys8 sort on a ``uint32[4, n]`` layout.

Counterpart of ``uda_tpu/ops/pallas_fold.py``. The keys8 engine's 8-row
keys matrix carries data in only 4 rows when there are at most 3 key words
(rows 3..6 are zero), so this cascade runs on the slim layout
``[k0, k1, k2, tb]`` (rows num_keys..2 ride along as payload; row 3 is the
tie-break): half the bytes per pass. The plain versions are the
lanes-layout ones at ``tb_row=3``. The kernels are CUDA C++
(``uda_tpu_torch/csrc/lanes_fold.cu``), the device code of K2 and K1
(``csrc/lanes_common.cuh``) instantiated for this layout:

- K3, ``tile_sort_folded`` (replaces ``uda_tpu/ops/pallas_fold.py:90``
  ``_tile_sort_kernel_folded``): bound by bytes in principle, by its merge
  rounds in practice. A block merge sort with the data in registers, V
  records a thread sorted with no barrier, then merge-path rounds in
  shared memory. A tile wider than one block takes is sorted as sub-tiles
  merged by K4.
- K4, ``merge_pass_folded`` (replaces ``uda_tpu/ops/pallas_fold.py:135``
  ``_merge_pass_kernel_folded`` and its window table ``_pass_splits``):
  bound by bytes. The partition kernel of K1 (``pallas_sort.merge_partition``)
  finds every block's split in parallel, ties to A; each block then loads
  exactly its window, merges from register heads and writes every row
  once. Its block width comes from the slim layout's shared-memory budget,
  not from ``tile``.

The TPU kernels fold two element halves into 8 rows to halve their vector
work; that is a TPU device, and the output contract is what carries over.
"""

from __future__ import annotations

import ctypes

import torch

from uda_tpu_torch.ops import _build
from uda_tpu_torch.ops.pallas_sort import (_LANE, _cat_words, _check_words,
                                           merge_partition, merge_pass_plain,
                                           tile_sort_plain)
from uda_tpu_torch.ops.sort import fill_words, i32, u32

__all__ = ["sort_lanes_folded", "sort_lanes_folded4", "tile_sort_folded",
           "tile_sort_folded_plain", "merge_pass_folded",
           "merge_pass_folded_plain", "merge_pass_folded_width"]

_SLOT = 4   # rows of the slim layout: 3 key rows + tie-break
_TB = 7     # tie-break row of the standard keys8 layout
_TB4 = 3    # tie-break row of the slim layout

_C = ctypes
_SIGNATURES = {
    "uda_tile_sort_folded": ([_C.c_void_p, _C.c_void_p, _C.c_size_t,
                              _C.c_int, _C.c_int, _C.c_void_p], _C.c_int),
    "uda_merge_pass_folded": ([_C.c_void_p, _C.c_void_p, _C.c_void_p,
                               _C.c_size_t, _C.c_int, _C.c_int,
                               _C.c_size_t, _C.c_void_p], _C.c_int),
    "uda_tile_sort_folded_max_tile": ([_C.c_int, _C.c_size_t], _C.c_int),
    "uda_merge_pass_folded_width": ([_C.c_int, _C.c_size_t, _C.c_size_t],
                                    _C.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.library("lanes_fold", _SIGNATURES)


def tile_sort_folded_plain(x4: torch.Tensor, tile: int,
                           num_keys: int) -> torch.Tensor:
    """Plain version of K3."""
    return tile_sort_plain(x4, tile, num_keys, _TB4)


def merge_pass_folded_plain(x4: torch.Tensor, run_len: int, tile: int,
                            num_keys: int) -> torch.Tensor:
    """Plain version of K4."""
    return merge_pass_plain(x4, run_len, tile, num_keys, _TB4)


def tile_sort_folded(x4: torch.Tensor, tile: int,
                     num_keys: int) -> torch.Tensor:
    """K3 (replaces ``uda_tpu/ops/pallas_fold.py::_tile_sort_kernel_folded``):
    the kernel on a CUDA tensor, :func:`tile_sort_folded_plain` on a CPU
    one.

    On the card a block sorts at most ``uda_tile_sort_folded_max_tile``
    records (16384 at 1 key word, 8192 at 2 or 3); a wider tile is sorted
    as such sub-tiles and then merged by K4's passes, which order by
    (keys, arrival index) as the tile's stable sort does."""
    if x4.device.type == "cpu":
        return tile_sort_folded_plain(x4, tile, num_keys)
    n = _build.cuda_words(x4, rows=_SLOT).shape[1]
    if tile < _LANE or tile & (tile - 1) or n % tile:
        raise ValueError(f"tile={tile} must be a power of two >= {_LANE} "
                         f"that divides n={n}")
    lib = _lib()
    sub = lib.uda_tile_sort_folded_max_tile(num_keys,
                                            _build.smem_limit(x4.device))
    if not sub:
        raise ValueError(f"tile_sort_folded takes 1 to 3 key words, got "
                         f"{num_keys}")
    sub = min(tile, sub)
    out = torch.empty_like(x4)
    with torch.cuda.device(x4.device):
        _build.launch(lib, "uda_tile_sort_folded", x4.data_ptr(),
                      out.data_ptr(), n, num_keys, sub,
                      _build.stream_of(x4))
    _build.count("tile_sort_folded")
    spare = None
    while sub < tile:
        spare = merge_pass_folded(out, sub, sub, num_keys, out=spare)
        out, spare = spare, out
        sub *= 2
    return out


def merge_pass_folded_width(num_keys: int, n: int, run_len: int) -> int:
    """K4's block width on the card for one pass: records per block, a
    power of two up to 4096 that divides ``n`` and ``2 * run_len`` and
    whose shared memory fits the slim layout's budget (0 for a key count
    K4 does not take). The output does not depend on it."""
    return _lib().uda_merge_pass_folded_width(num_keys, n, run_len)


def merge_pass_folded(x4: torch.Tensor, run_len: int, tile: int,
                      num_keys: int, out: "torch.Tensor | None" = None
                      ) -> torch.Tensor:
    """K4 (replaces ``uda_tpu/ops/pallas_fold.py::_merge_pass_kernel_folded``
    and its window table): the partition kernel and the merge kernel on a
    CUDA tensor, :func:`merge_pass_folded_plain` on a CPU one; the result
    goes into ``out`` when given. On the card the blocks are
    :func:`merge_pass_folded_width` records wide whatever ``tile`` is: the
    pass depends only on ``run_len``."""
    if out is not None and (out.shape != x4.shape or out.dtype != x4.dtype
                            or out.data_ptr() == x4.data_ptr()):
        raise ValueError("merge_pass_folded needs a separate output like x4")
    if x4.device.type == "cpu":
        res = merge_pass_folded_plain(x4, run_len, tile, num_keys)
        return res if out is None else u32(i32(out).copy_(i32(res)))
    n = _build.cuda_words(x4, rows=_SLOT).shape[1]
    width = merge_pass_folded_width(num_keys, n, run_len)
    if not width:
        raise ValueError(f"merge_pass_folded takes 1 to 3 key words, got "
                         f"{num_keys}")
    return _merge_pass_folded_at(x4, run_len, num_keys, width, out)


def _merge_pass_folded_at(x4: torch.Tensor, run_len: int, num_keys: int,
                          width: int, out: "torch.Tensor | None"
                          ) -> torch.Tensor:
    """K4 on the card with blocks of ``width`` records (a power of two up
    to 4096 dividing n and 2 * run_len): the partition, then the merge."""
    splits = merge_partition(x4, run_len, width, num_keys, _TB4)
    out = torch.empty_like(x4) if out is None else _build.cuda_words(out)
    lib = _lib()
    with torch.cuda.device(x4.device):
        _build.launch(lib, "uda_merge_pass_folded", x4.data_ptr(),
                      out.data_ptr(), splits.data_ptr(), x4.shape[1],
                      num_keys, width, run_len, _build.stream_of(x4))
    _build.count("merge_pass_folded")
    return out


def sort_lanes_folded4(x4: torch.Tensor, num_keys: int,
                       tile: int = 1024) -> torch.Tensor:
    """The slim-layout cascade: ``x4`` is uint32[4, n] rows
    ``[k0, k1, k2, tb]`` (row 3 is overwritten with the arrival index);
    returns the sorted [4, n] tensor. ``tile`` must be a power-of-two
    multiple of 256 (the reference's folded lane width), and n a
    power-of-two multiple of ``tile``."""
    x4 = _check_words(x4)
    rows, n = x4.shape
    if rows != _SLOT:
        raise ValueError(f"slim folded cascade needs a 4-row array, "
                         f"got {rows} rows")
    if not 0 < num_keys <= 3:
        raise ValueError(f"folded cascade needs num_keys <= 3, got "
                         f"{num_keys}")
    if tile & (tile - 1) or tile % (2 * _LANE):
        raise ValueError(f"tile={tile} must be a power of two multiple "
                         f"of {2 * _LANE}")
    if n % tile or (n // tile) & (n // tile - 1):
        raise ValueError(f"n={n} must be a power-of-two multiple of "
                         f"tile={tile}")
    levels = (n // tile).bit_length() - 1
    y = tile_sort_folded(x4, tile, num_keys)
    spare = torch.empty_like(y) if levels else None
    for lvl in range(levels):
        z = merge_pass_folded(y, tile << lvl, tile, num_keys, out=spare)
        spare, y = y, z
    return y


def sort_lanes_folded(x: torch.Tensor, num_keys: int,
                      tile: int = 1024) -> torch.Tensor:
    """Drop-in for ``sort_lanes(x, num_keys, tb_row=7)`` on 8-row keys
    arrays with ``num_keys <= 3``: same output contract (rows 3..6 zeroed,
    row 7 the arrival index), run on the slim layout."""
    x = _check_words(x)
    rows, n = x.shape
    if rows != 8:
        raise ValueError(f"folded cascade needs an 8-row keys array, "
                         f"got {rows} rows")
    out4 = sort_lanes_folded4(_cat_words([x[:_TB4], x[_TB:_TB + 1]]),
                              num_keys, tile=tile)
    return _cat_words([out4[:_TB4], fill_words((_TB - _TB4, n), x.device),
                       out4[_TB4:]])
