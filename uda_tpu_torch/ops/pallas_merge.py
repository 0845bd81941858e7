"""Pairwise merge of two sorted row runs on K1, the merge-pass kernel.

Counterpart of ``uda_tpu/ops/pallas_merge.py``. ``merge_sorted_pair`` takes
two key-sorted row matrices ``uint32[na, W]`` and ``uint32[nb, W]`` (key
words in the leading ``num_keys`` columns) and returns their stable merge,
``uint32[na + nb, W]``: on equal keys A's rows come first.

The reference packs the pair into its 32-row lanes layout, B stored
descending so the pair is bitonic as stored, and runs one ``_pass_splits``
+ ``_merge_pass``. The port keeps the result and not the mechanism: the
pair becomes ``uint32[W + 1, 2L]``, the W columns as rows and then one
tie-break row, A ascending in ``[0, L)`` and B ascending in ``[L, 2L)``
(24 zero rows would triple K1's bytes at W = 7), and one
``pallas_sort.merge_pass`` merges it: the partition kernel and the merge
kernel on a CUDA tensor, their plain version on a CPU tensor. ``L`` is the
larger run rounded up to the tile, as in the reference (``_ceil_runs``);
K1 takes any ``L`` whose pair width its blocks divide.

The tie-break row holds each record's index in ``concat(a, b)``, so equal
keys keep arrival order, and gives the padding columns past each run the
highest indices, B's above A's: their keys are all-0xFFFFFFFF, so they
sort after every real row and only a row that is itself all-0xFFFFFFFF in
every column can tie with them, which changes no output byte.
"""

from __future__ import annotations

import torch

from uda_tpu_torch.ops import pallas_sort
from uda_tpu_torch.ops.pallas_sort import _lex_lt
from uda_tpu_torch.ops.sort import _as_i64, fill_words, i32, u32, words_of

__all__ = ["merge_sorted_pair", "merge_splits", "pack_pair", "pair_run_len"]

_ALL_ONES = 0xFFFFFFFF
MAX_COLS = pallas_sort.ROWS - 1  # W + 1 rows within K1's 32


def merge_splits(a: torch.Tensor, b: torch.Tensor, tile: int,
                 num_keys: int) -> torch.Tensor:
    """For each output tile boundary d = t * tile, the number of A rows in
    the first d rows of the stable merge (merge-path diagonal
    intersection, ties to A). Returns int32[ceil((na + nb) / tile)]. A
    vectorised binary search on the runs' device (a host-callable
    analysis utility, as in the reference)."""
    na, nb = a.shape[0], b.shape[0]
    num_tiles = -(-(na + nb) // tile)
    d = torch.arange(num_tiles, device=a.device, dtype=torch.int64) * tile
    if na == 0 or nb == 0:
        return d.clamp(max=na).to(torch.int32)
    ka = [_as_i64(a[:, c]) for c in range(num_keys)]
    kb = [_as_i64(b[:, c]) for c in range(num_keys)]
    lo = (d - nb).clamp(min=0)
    hi = d.clamp(max=na)
    for _ in range(max(na, nb).bit_length() + 1):
        mid = (lo + hi + 1) // 2        # candidate: rows of A taken
        j = d - mid                     # rows of B taken
        ia = (mid - 1).clamp(0, na - 1)
        ib = j.clamp(0, nb - 1)
        b_lt_a = _lex_lt([k[ib] for k in kb], [k[ia] for k in ka])
        ok = (mid <= 0) | (j >= nb) | ~b_lt_a   # A[mid-1] <= B[j]
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return lo.to(torch.int32)


def pair_run_len(na: int, nb: int, tile: int) -> int:
    """The run length ``L`` of the packed pair: the larger run rounded up
    to a multiple of ``tile`` (the reference's ``_ceil_runs``)."""
    return max(tile, -(-max(na, nb) // tile) * tile)


def pack_pair(a: torch.Tensor, b: torch.Tensor, L: int) -> torch.Tensor:
    """Two sorted ``uint32[n, W]`` runs -> the ``uint32[W + 1, 2L]`` pair
    K1 merges: the W columns as rows, A in ``[0, L)`` and B in
    ``[L, 2L)``, all-0xFFFFFFFF columns past each run, and row W the
    tie-break (see the module docstring)."""
    na, w = a.shape
    nb = b.shape[0]
    x = fill_words((w + 1, 2 * L), a.device, _ALL_ONES)
    i32(x)[:w, :na] = i32(a).T
    i32(x)[:w, L:L + nb] = i32(b).T
    lane = torch.arange(L, device=a.device, dtype=torch.int64)
    tb = torch.cat([torch.where(lane < na, lane, lane + nb),
                    torch.where(lane < nb, lane + na, lane + L)])
    i32(x)[w] = i32(words_of(tb))
    return x


def merge_sorted_pair(a: torch.Tensor, b: torch.Tensor, num_keys: int,
                      tile: int = 512) -> torch.Tensor:
    """Merge two key-sorted row matrices into one (stable: A's rows precede
    B's on equal keys). ``a``/``b``: ``uint32[n, W]`` tensors on one
    device with key words in the leading ``num_keys`` columns, W <= 31.
    The output has ``a.shape[0] + b.shape[0]`` rows, on that device. K1
    (replaces ``uda_tpu/ops/pallas_merge.py::merge_sorted_pair``'s
    ``_pass_splits`` + ``_merge_pass``) on a CUDA tensor, its plain
    version on a CPU one."""
    if tile <= 0 or tile & (tile - 1) or tile % 128:
        raise ValueError(f"tile must be a power of two multiple of 128, "
                         f"got {tile} (the merge kernel requires it)")
    for r in (a, b):
        if r.dtype != torch.uint32 or r.dim() != 2:
            raise ValueError(f"runs are 2-D uint32 row matrices, got "
                             f"{r.dtype} {tuple(r.shape)}")
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError("the two runs differ in width or device")
    if a.shape[1] > MAX_COLS:
        raise ValueError(f"{a.shape[1]} record words do not fit the "
                         f"{pallas_sort.ROWS}-row lanes layout")
    if not 0 < num_keys <= a.shape[1]:
        raise ValueError(f"num_keys={num_keys} outside 1..{a.shape[1]}")
    na, w = a.shape
    nb = b.shape[0]
    if na == 0:
        return b
    if nb == 0:
        return a
    L = pair_run_len(na, nb, tile)
    out = pallas_sort.merge_pass(pack_pair(a, b, L), L, tile, num_keys, w)
    return u32(i32(out)[:w, :na + nb].T.contiguous())
