"""Full stable record sort in the records-as-columns ("lanes") layout.

Counterpart of ``uda_tpu/ops/pallas_sort.py``. Records are the COLUMNS of a
``uint32[rows, n]`` tensor: row r holds word r of every record. Rows
``[0, num_keys)`` are the key words (compared unsigned, most significant
first); row ``tb_row`` is the stability tie-break, which the tile sort
fills with the global arrival index and the output keeps; the other rows
are payload.

``sort_lanes`` is one tile sort (kernel K2, ``tile_sort``) and
``log2(n / tile)`` merge passes (kernel K1, ``merge_pass``), which the host
runs in a loop, swapping two buffers. The kernels are CUDA C++
(``uda_tpu_torch/csrc/lanes_sort.cu``); a merge pass is two launches, the
partition kernel (``merge_partition``, every block's merge-path split) and
the merge kernel. Each wrapper launches its kernel on a CUDA tensor and
runs its plain PyTorch version on a CPU tensor: per-tile sorts, and per
pass one merge-path split per output tile found by a vectorised binary
search (the reference's ``_pass_splits``), then the tile merged from its
two windows. The merge kernel's blocks need not be ``tile`` wide: a pass
is a function of ``run_len`` alone.

The TPU kernels alternate tile directions, mask windows with +inf and roll
lanes to suit their bitonic networks; those are TPU devices, not
contracts. Here every run stays ascending between passes; the public
outputs are the reference's, byte for byte.
"""

from __future__ import annotations

import ctypes

import torch

from uda_tpu_torch.ops import _build
from uda_tpu_torch.ops.sort import (_as_i64, fill_words, i32,
                                    stable_lex_argsort, u32, words_of)

__all__ = ["ROWS", "TB_ROW_DEFAULT", "sort_lanes", "rows_to_lanes",
           "lanes_to_rows", "keys8_sort_perm", "pad_pow2", "tile_sort",
           "tile_sort_plain", "merge_pass", "merge_pass_plain",
           "merge_partition", "merge_partition_plain", "merge_pass_width",
           "merge_splits"]

ROWS = 32               # row count of the full lanes layout
TB_ROW_DEFAULT = 31     # default tie-break row (last)
_LANE = 128             # smallest tile; the padding unit of pad_pow2
_PLAIN_CHUNK = 1 << 22  # records per step of a plain version (bounds memory)

_C = ctypes
_SIGNATURES = {
    "uda_tile_sort": ([_C.c_void_p, _C.c_void_p, _C.c_size_t, _C.c_int,
                       _C.c_int, _C.c_int, _C.c_int, _C.c_void_p], _C.c_int),
    "uda_merge_partition": ([_C.c_void_p, _C.c_void_p, _C.c_size_t,
                             _C.c_int, _C.c_int, _C.c_int, _C.c_size_t,
                             _C.c_void_p], _C.c_int),
    "uda_merge_pass": ([_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_size_t,
                        _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_size_t,
                        _C.c_void_p], _C.c_int),
    "uda_tile_sort_max_tile": ([_C.c_int, _C.c_size_t], _C.c_int),
    "uda_merge_pass_smem": ([_C.c_int, _C.c_int, _C.c_int], _C.c_size_t),
    "uda_merge_pass_width": ([_C.c_int, _C.c_int, _C.c_size_t, _C.c_size_t],
                             _C.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.library("lanes_sort", _SIGNATURES)


def rows_to_lanes(words: torch.Tensor, rows: int = ROWS) -> torch.Tensor:
    """[n, W] row-matrix records -> [rows, n] lanes layout (rows W.. are
    zero)."""
    n, cols = words.shape
    if cols > rows:
        raise ValueError(f"{cols} record words > {rows} layout rows")
    out = fill_words((rows, n), words.device)
    i32(out)[:cols] = i32(words).T
    return out


def lanes_to_rows(lanes: torch.Tensor, num_words: int) -> torch.Tensor:
    """[rows, n] lanes layout -> [n, num_words] row matrix."""
    return u32(i32(lanes)[:num_words].T.contiguous())


def pad_pow2(n: int, tile: int) -> tuple[int, int]:
    """The lane-padding rule of every lanes-engine entry point: pad ``n``
    records up to ``m`` (a power of two, at least 128) and clamp ``tile``
    so sort_lanes' preconditions hold. Returns (m, tile)."""
    m = max(_LANE, 1 << max(0, n - 1).bit_length())
    return m, min(tile, m)


def tile_sort_plain(x: torch.Tensor, tile: int, num_keys: int,
                    tb_row: int) -> torch.Tensor:
    """Plain version of K2: every tile of ``tile`` records sorted
    ascending by its key rows, stable, with row ``tb_row`` holding each
    record's global arrival index."""
    rows, n = x.shape
    out = torch.empty_like(x)
    step = max(tile, _PLAIN_CHUNK // tile * tile)
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        keys = [x[r, c0:c1].reshape(-1, tile) for r in range(num_keys)]
        order = stable_lex_argsort(keys, dim=1)
        base = torch.arange(c0, c1, tile, device=x.device)
        src = (order + base[:, None]).flatten()
        i32(out)[:, c0:c1] = i32(x)[:, src]
        i32(out)[tb_row, c0:c1] = i32(words_of(src))
    return out


def _lex_lt(a: list, b: list) -> torch.Tensor:
    """Elementwise a < b, lexicographic over lists of int64 tensors."""
    lt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for u, v in zip(a, b):
        lt |= eq & (u < v)
        eq &= u == v
    return lt


def merge_splits(keys: list, n: int, run_len: int, tile: int):
    """Per output tile of one pass that merges ascending runs of
    ``run_len`` into runs of ``2 * run_len``: the A-run base column and
    the merge-path split (i0, j0), the numbers of A and B records among
    the pair's records merged before the tile. A vectorised binary search
    over all tiles at once (the reference's ``_pass_splits``); ``keys``
    are the int64 key rows plus the tie-break row, so ties go to A by
    arrival order. K1's partition kernel computes the same split per
    block of its own width (:func:`merge_partition`)."""
    L = run_len
    out0 = torch.arange(0, n, tile, device=keys[0].device)
    a_base = out0 // (2 * L) * (2 * L)
    b_base = a_base + L
    d = out0 - a_base
    lo = (d - L).clamp(min=0)
    hi = d.clamp(max=L)
    for _ in range(L.bit_length() + 1):
        mid = (lo + hi + 1) // 2                # candidate: A records taken
        j = d - mid                             # B records taken
        a_idx = a_base + (mid - 1).clamp(0, L - 1)
        b_idx = b_base + j.clamp(0, L - 1)
        b_lt_a = _lex_lt([k[b_idx] for k in keys], [k[a_idx] for k in keys])
        ok = (mid <= 0) | (j >= L) | ~b_lt_a
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return a_base, lo, d - lo


def merge_pass_plain(x: torch.Tensor, run_len: int, tile: int,
                     num_keys: int, tb_row: int) -> torch.Tensor:
    """Plain version of K1: adjacent ascending runs of ``run_len`` records
    merged into ascending runs of ``2 * run_len``, ties to the first run.
    Per output tile: the merge-path split, then the first ``tile`` records
    of its two windows in order."""
    rows, n = x.shape
    L = run_len
    keys = [_as_i64(x[r]) for r in [*range(num_keys), tb_row]]
    a_base, i0, j0 = merge_splits(keys, n, L, tile)
    q = torch.arange(tile, device=x.device)
    out = torch.empty_like(x)
    per = max(1, _PLAIN_CHUNK // tile)
    for t0 in range(0, n // tile, per):
        t1 = min(n // tile, t0 + per)
        ia = i0[t0:t1, None] + q
        ib = j0[t0:t1, None] + q
        cols = torch.cat([a_base[t0:t1, None] + ia.clamp(max=L - 1),
                          a_base[t0:t1, None] + L + ib.clamp(max=L - 1)],
                         dim=1)
        past_end = torch.cat([ia >= L, ib >= L], dim=1).to(torch.int64)
        order = stable_lex_argsort([past_end, *(k[cols] for k in keys)],
                                   dim=1)
        src = torch.gather(cols, 1, order[:, :tile]).flatten()
        i32(out)[:, t0 * tile:t1 * tile] = i32(x)[:, src]
    return out


def tile_sort(x: torch.Tensor, tile: int, num_keys: int,
              tb_row: int) -> torch.Tensor:
    """K2 (replaces ``uda_tpu/ops/pallas_sort.py::_tile_sort_kernel``):
    the kernel on a CUDA tensor, :func:`tile_sort_plain` on a CPU one.

    On the card a block sorts at most ``uda_tile_sort_max_tile`` records
    (its registers and shared memory, fewer for more key words); a wider
    tile is sorted as such sub-tiles and then merged by K1's passes, which
    order by (keys, arrival index) as the tile's stable sort does."""
    if x.device.type == "cpu":
        return tile_sort_plain(x, tile, num_keys, tb_row)
    rows, n = _build.cuda_words(x).shape
    if tile < _LANE or tile & (tile - 1) or n % tile:
        raise ValueError(f"tile={tile} must be a power of two >= {_LANE} "
                         f"that divides n={n}")
    lib = _lib()
    sub = lib.uda_tile_sort_max_tile(num_keys, _build.smem_limit(x.device))
    if not sub:
        raise ValueError(f"tile_sort takes 1 to 31 key words, got "
                         f"{num_keys}")
    sub = min(tile, sub)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch(lib, "uda_tile_sort", x.data_ptr(), out.data_ptr(), n,
                      rows, num_keys, tb_row, sub, _build.stream_of(x))
    _build.count("tile_sort")
    spare = None
    while sub < tile:
        spare = merge_pass(out, sub, sub, num_keys, tb_row, out=spare)
        out, spare = spare, out
        sub *= 2
    return out


def merge_pass_width(rows: int, num_keys: int, n: int, run_len: int) -> int:
    """K1's block width on the card for one pass: records per block, a
    power of two that divides ``n`` and ``2 * run_len`` and whose shared
    memory fits three blocks per SM (0 for a key count K1 does not take).
    The output does not depend on it."""
    return _lib().uda_merge_pass_width(rows, num_keys, n, run_len)


def merge_partition_plain(x: torch.Tensor, run_len: int, width: int,
                          num_keys: int, tb_row: int) -> torch.Tensor:
    """Plain version of K1's partition kernel: the A-run split ``i0`` of
    every block of ``width`` output records (int32)."""
    keys = [_as_i64(x[r]) for r in [*range(num_keys), tb_row]]
    return merge_splits(keys, x.shape[1], run_len, width)[1].to(torch.int32)


def merge_partition(x: torch.Tensor, run_len: int, width: int,
                    num_keys: int, tb_row: int) -> torch.Tensor:
    """The partition kernel of K1 and K4 (replaces the window table
    ``uda_tpu/ops/pallas_sort.py::_pass_splits``): per block of ``width``
    output records of one pass, the number of A-run records merged before
    it, one thread per block boundary. The kernel on a CUDA tensor,
    :func:`merge_partition_plain` on a CPU one."""
    if x.device.type == "cpu":
        return merge_partition_plain(x, run_len, width, num_keys, tb_row)
    rows, n = _build.cuda_words(x).shape
    if width <= 0 or n % width:
        raise ValueError(f"width={width} must divide n={n}")
    lib = _lib()
    splits = torch.empty(n // width, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(lib, "uda_merge_partition", x.data_ptr(),
                      splits.data_ptr(), n, num_keys, tb_row, width, run_len,
                      _build.stream_of(x))
    _build.count("merge_partition")
    return splits


def merge_pass(x: torch.Tensor, run_len: int, tile: int, num_keys: int,
               tb_row: int, out: "torch.Tensor | None" = None
               ) -> torch.Tensor:
    """K1 (replaces ``uda_tpu/ops/pallas_sort.py::_merge_pass_kernel`` and
    its window table ``_pass_splits``): the partition kernel and the merge
    kernel on a CUDA tensor, :func:`merge_pass_plain` on a CPU one; the
    result goes into ``out`` when given. On the card the blocks are
    :func:`merge_pass_width` records wide whatever ``tile`` is: the pass
    depends only on ``run_len``."""
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.data_ptr() == x.data_ptr()):
        raise ValueError("merge_pass needs a separate output like x")
    if x.device.type == "cpu":
        res = merge_pass_plain(x, run_len, tile, num_keys, tb_row)
        return res if out is None else u32(i32(out).copy_(i32(res)))
    rows, n = _build.cuda_words(x).shape
    lib = _lib()
    width = merge_pass_width(rows, num_keys, n, run_len)
    if not width:
        raise ValueError(f"merge_pass takes 1 to 31 key words, got "
                         f"{num_keys}")
    _build.check_smem(lib.uda_merge_pass_smem(rows, num_keys, width),
                      x.device, "merge_pass")
    splits = merge_partition(x, run_len, width, num_keys, tb_row)
    out = torch.empty_like(x) if out is None else _build.cuda_words(out)
    with torch.cuda.device(x.device):
        _build.launch(lib, "uda_merge_pass", x.data_ptr(), out.data_ptr(),
                      splits.data_ptr(), n, rows, num_keys, tb_row, width,
                      run_len, _build.stream_of(x))
    _build.count("merge_pass")
    return out


def _cat_words(parts: list) -> torch.Tensor:
    """torch.cat of uint32 tensors along rows, through int32 views."""
    return u32(torch.cat([i32(p) for p in parts]))


def _check_words(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint32 \
            or x.dim() != 2:
        raise ValueError("expected a 2-D torch.uint32 tensor")
    return u32(i32(x).contiguous())


def keys8_sort_perm(keyrows: torch.Tensor, tile: int = 1024,
                    folded: bool = False):
    """The keys8 cascade core: sort an 8-row keys-only matrix and return
    ``(sorted_key_rows, perm)``, ``perm[j]`` (int32) the source column of
    sorted position j, stable by arrival order among equal keys.

    ``keyrows``: uint32[k, m] with 1 <= k <= 7 key rows, m a power-of-two
    multiple of ``tile``. Callers own their padding: pad columns must sort
    after every real one (all-0xFFFFFFFF keys tie with real all-max keys,
    and the arrival tie-break keeps the real ones first because padding
    holds the highest columns). ``folded`` takes the slim cascade
    (ops/pallas_fold.py, kernels K3/K4) where k <= 3 and ``tile`` is a
    multiple of 256; the output is the same."""
    keyrows = _check_words(keyrows)
    k, m = keyrows.shape
    if not 0 < k <= 7:
        raise ValueError(f"keys8 needs 1..7 key rows, got {k}")
    if folded and k <= 3 and tile % (2 * _LANE) == 0:
        from uda_tpu_torch.ops.pallas_fold import sort_lanes_folded4

        mat4 = _cat_words([keyrows, fill_words((4 - k, m), keyrows.device)])
        out4 = sort_lanes_folded4(mat4, num_keys=k, tile=tile)
        return out4[:k], out4[3].view(torch.int32)
    mat8 = _cat_words([keyrows, fill_words((8 - k, m), keyrows.device)])
    out8 = sort_lanes(mat8, num_keys=k, tb_row=7, tile=tile)
    return out8[:k], out8[7].view(torch.int32)


def sort_lanes(x: torch.Tensor, num_keys: int, tb_row: int = TB_ROW_DEFAULT,
               tile: int = 1024, two_phase: bool = False) -> torch.Tensor:
    """Full stable sort of records in the lanes layout.

    ``x``: uint32[rows, n] with key words in rows [0, num_keys); row
    ``tb_row`` is overwritten with the arrival index and holds it in the
    output. n must be a power-of-two multiple of ``tile`` (pad with
    all-0xFFFFFFFF-key records otherwise). ``two_phase`` is accepted and
    checked as in the reference (num_keys <= 6); on this card both forms
    are one kernel, which moves the payload rows once per launch.

    Returns the sorted tensor (ascending by keys, stable by arrival)."""
    x = _check_words(x)
    rows, n = x.shape
    if tile & (tile - 1) or tile % _LANE:
        raise ValueError(f"tile={tile} must be a power of two multiple "
                         f"of {_LANE}")
    if n % tile or (n // tile) & (n // tile - 1):
        raise ValueError(f"n={n} must be a power-of-two multiple of "
                         f"tile={tile}")
    if not 0 < num_keys <= tb_row < rows:
        raise ValueError(f"bad num_keys={num_keys} / tb_row={tb_row}")
    if two_phase and num_keys + 2 > 8:
        raise ValueError(f"two_phase needs num_keys <= 6, got {num_keys}")
    levels = (n // tile).bit_length() - 1
    y = tile_sort(x, tile, num_keys, tb_row)
    spare = torch.empty_like(y) if levels else None
    for lvl in range(levels):
        z = merge_pass(y, tile << lvl, tile, num_keys, tb_row, out=spare)
        spare, y = y, z
    return y
