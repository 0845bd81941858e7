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
  merged by K4. ``tile_sort_folded_rows`` is the same kernel reading the
  key words from row-major records in place (``sort_records_folded4``,
  the TeraSort engine's cascade): it writes the bytes ``tile_sort_folded``
  writes for the padded [4, m] matrix of those keys, which is never built.
- K4, ``merge_pass_folded`` (replaces ``uda_tpu/ops/pallas_fold.py:135``
  ``_merge_pass_kernel_folded`` and its window table ``_pass_splits``):
  bound by bytes. The partition kernel of K1 (``pallas_sort.merge_partition``)
  finds every block's split in parallel, ties to A; each block then loads
  exactly its window, merges from register heads and writes every row
  once. Its block width comes from the slim layout's shared-memory budget,
  not from ``tile``. A pass over columns that are no power-of-two multiple
  of its runs (the records cascade on whole blocks) merges its last pair
  with a short B run, or copies a lone A run.
- K4's multiway passes, ``merge_pass4_folded`` and ``merge_pass8_folded``:
  groups of four or eight adjacent runs merged at once, so the cascade
  takes a half or a third of the passes at the same bytes a pass
  (``merge_plan``: the fewest passes, eight-way, one of them four-way
  where that many passes leave room for it, first). Their own partition
  (``merge_partition4``, ``merge_partition8``: a multiway selection, each
  block boundary's four or eight splits) and merge kernel, one template
  over the number of runs; the output is two or three two-way passes',
  ties to the earlier run, byte for byte, and a group's last runs may be
  short or missing as a pair's are.

The TPU kernels fold two element halves into 8 rows to halve their vector
work; that is a TPU device, and the output contract is what carries over.
"""

from __future__ import annotations

import ctypes

import torch

from uda_tpu_torch.ops import _build
from uda_tpu_torch.ops.pallas_sort import (_LANE, _PLAIN_CHUNK, _cat_words,
                                           _check_words, _lex_lt,
                                           merge_partition, merge_pass_plain,
                                           merge_path_split, record_key_rows,
                                           tile_sort_plain)
from uda_tpu_torch.ops.sort import (_as_i64, fill_words, i32,
                                    stable_lex_argsort, u32)

__all__ = ["sort_lanes_folded", "sort_lanes_folded4", "sort_records_folded4",
           "records_cascade_columns", "tile_sort_folded",
           "tile_sort_folded_plain", "tile_sort_folded_rows",
           "merge_pass_folded",
           "merge_pass_folded_plain", "merge_pass_folded_width",
           "merge_pass4_folded", "merge_pass4_folded_plain",
           "merge_pass4_folded_width", "merge_partition4",
           "merge_partition4_plain", "merge4_splits", "group_runs",
           "merge_pass8_folded", "merge_pass8_folded_plain",
           "merge_pass8_folded_width", "merge_partition8",
           "merge_partition8_plain", "merge_plan"]

_SLOT = 4   # rows of the slim layout: 3 key rows + tie-break
_TB = 7     # tie-break row of the standard keys8 layout
_TB4 = 3    # tie-break row of the slim layout
_WAYS = 4   # runs a four-way K4 pass merges
_WAYS8 = 8  # runs an eight-way K4 pass merges
_K4_MAX_WIDTH = _build.header_constant("K1_MAX_WIDTH")  # K4's widest block

_C = ctypes
_SIGNATURES = {
    "uda_tile_sort_folded": ([_C.c_void_p, _C.c_void_p, _C.c_size_t,
                              _C.c_int, _C.c_int, _C.c_void_p], _C.c_int),
    "uda_merge_pass_folded": ([_C.c_void_p, _C.c_void_p, _C.c_void_p,
                               _C.c_size_t, _C.c_int, _C.c_int,
                               _C.c_size_t, _C.c_void_p], _C.c_int),
    "uda_tile_sort_folded_rows": ([_C.c_void_p, _C.c_size_t, _C.c_size_t,
                                   _C.c_void_p, _C.c_size_t, _C.c_int,
                                   _C.c_int, _C.c_void_p], _C.c_int),
    "uda_tile_sort_folded_max_tile": ([_C.c_int, _C.c_size_t], _C.c_int),
    "uda_merge_pass_folded_width": ([_C.c_int, _C.c_size_t, _C.c_size_t],
                                    _C.c_int),
    "uda_merge_ways_folded_width": ([_C.c_int, _C.c_int, _C.c_size_t,
                                     _C.c_size_t], _C.c_int),
    "uda_merge_partition_ways_folded": ([_C.c_void_p, _C.c_void_p,
                                         _C.c_size_t, _C.c_int, _C.c_int,
                                         _C.c_int, _C.c_size_t,
                                         _C.c_void_p], _C.c_int),
    "uda_merge_pass_ways_folded": ([_C.c_void_p, _C.c_void_p, _C.c_void_p,
                                    _C.c_size_t, _C.c_int, _C.c_int,
                                    _C.c_int, _C.c_size_t, _C.c_void_p],
                                   _C.c_int),
    "uda_merge_pass_folded_occupancy": ([_C.c_int, _C.c_int, _C.c_int,
                                         _C.POINTER(_C.c_int),
                                         _C.POINTER(_C.c_int)], _C.c_int),
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
    sub = _k3_block_tile(x4.device, n, tile, num_keys)
    out = torch.empty_like(x4)
    lib = _lib()
    with torch.cuda.device(x4.device):
        _build.launch(lib, "uda_tile_sort_folded", x4.data_ptr(),
                      out.data_ptr(), n, num_keys, sub,
                      _build.stream_of(x4))
    _build.count("tile_sort_folded")
    return _merge_sub_tiles(out, sub, tile, num_keys)


def tile_sort_folded_rows(words: torch.Tensor, num_keys: int, m: int,
                          tile: int) -> torch.Tensor:
    """K3 on records in place: ``tile_sort_folded(x4, tile, num_keys)``
    for ``x4`` the padded [4, m] matrix of the first ``num_keys`` words of
    the row-major records ``words`` (uint32[n, w], n <= m; columns n..m-1
    all-0xFFFFFFFF keys, rows num_keys..2 zero), without building it: on
    the card the kernel reads each record's key words where they lie. On a
    CPU tensor the matrix is built and :func:`tile_sort_folded_plain` runs.
    Counted as a ``tile_sort_folded`` launch and as a
    ``tile_sort_folded_rows`` one."""
    n, w = words.shape
    if not 0 < num_keys <= min(w, _TB4):
        raise ValueError(f"tile_sort_folded_rows takes 1 to 3 key words "
                         f"within a record of {w}, got {num_keys}")
    if n > m:
        raise ValueError(f"{n} records do not fit m={m} columns")
    if m > 1 << 32:
        raise ValueError(f"m={m} columns: the arrival index holds 2^32")
    if words.device.type == "cpu":
        return tile_sort_folded_plain(
            record_key_rows(words, num_keys, m, rows=_SLOT), tile, num_keys)
    _build.cuda_words(words)
    sub = _k3_block_tile(words.device, m, tile, num_keys)
    out = torch.empty((_SLOT, m), dtype=torch.uint32, device=words.device)
    lib = _lib()
    with torch.cuda.device(words.device):
        _build.launch(lib, "uda_tile_sort_folded_rows", words.data_ptr(), n,
                      w, out.data_ptr(), m, num_keys, sub,
                      _build.stream_of(words))
    _build.count("tile_sort_folded")
    _build.count("tile_sort_folded_rows")
    return _merge_sub_tiles(out, sub, tile, num_keys)


def _k3_block_tile(device, n: int, tile: int, num_keys: int) -> int:
    """The tile one K3 block sorts for a cascade ``tile``: the tile, or
    the widest one block takes where it is narrower."""
    if tile < _LANE or tile & (tile - 1) or n % tile:
        raise ValueError(f"tile={tile} must be a power of two >= {_LANE} "
                         f"that divides n={n}")
    sub = _lib().uda_tile_sort_folded_max_tile(num_keys,
                                               _build.smem_limit(device))
    if not sub:
        raise ValueError(f"tile_sort_folded takes 1 to 3 key words, got "
                         f"{num_keys}")
    return min(tile, sub)


def _merge_sub_tiles(out: torch.Tensor, sub: int, tile: int,
                     num_keys: int) -> torch.Tensor:
    """K3's sorted sub-tiles of ``sub`` records merged by K4 into sorted
    tiles of ``tile``, by the passes ``merge_plan`` gives a tile."""
    spare = None
    for run_len, ways in merge_plan(tile, sub):
        spare = _MERGE_STEP[ways](out, run_len, sub, num_keys, out=spare)
        out, spare = spare, out
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


def merge_pass_folded_occupancy(num_keys: int, ways: int,
                                width: int) -> tuple:
    """K4's merge kernel on the card, two-way (``ways`` 2), four-way (4) or
    eight-way (8), at ``width`` records a block: (registers a thread,
    resident blocks a multiprocessor)."""
    regs, blocks = _C.c_int(0), _C.c_int(0)
    _build.launch(_lib(), "uda_merge_pass_folded_occupancy", num_keys, ways,
                  width, _C.byref(regs), _C.byref(blocks))
    return regs.value, blocks.value


def group_runs(g0: torch.Tensor, n: int, run_len: int) -> torch.Tensor:
    """The four run lengths (int64[..., 4]) of the groups that start at
    columns ``g0`` of a four-way pass over ``n`` columns: ``run_len`` each
    where the group lies wholly inside n; the last group of a cascade on a
    whole number of blocks has short or missing runs, as
    ``pallas_sort.pair_runs`` gives a pair's (a group of one run copies
    it)."""
    starts = g0[..., None] + run_len * torch.arange(_WAYS, device=g0.device)
    return (n - starts).clamp(min=0, max=run_len)


def _rank_col(keys: list, n: int, a_base, la, b_base, lb, k,
              steps: int) -> torch.Tensor:
    """The column of the record of rank ``k`` (from 0, below la + lb) in
    the stable merge of A and B, ties to A."""
    i = merge_path_split(keys, n, a_base, la, b_base, lb, k, steps)
    j = k - i
    a_col = (a_base + i).clamp(0, n - 1)
    b_col = (b_base + j).clamp(0, n - 1)
    take_b = (j < lb) & ((i >= la) | _lex_lt([w[b_col] for w in keys],
                                             [w[a_col] for w in keys]))
    return torch.where(take_b, b_col, a_col)


def merge4_splits(keys: list, n: int, run_len: int, tile: int):
    """Per output tile of one four-way pass, which merges groups of four
    ascending runs of ``run_len`` into runs of ``4 * run_len`` (the last
    group's runs as :func:`group_runs` gives them): the group's base
    column and int64[tiles, 4], the numbers of A, B, C and D records merged
    before the tile, ties to the earlier run. ``keys`` are the int64 key
    rows plus the tie-break row. A vectorised search over all tiles at
    once, of its own form: the split j between AB (the stable merge of A
    with B) and CD, each probe finding the records of rank j - 1 in AB and
    d - j in CD by a two-way split; then j's and d - j's two-way splits.
    The four-way partition kernel finds the same splits by a multiway
    selection (:func:`merge_partition4`)."""
    L = run_len
    out0 = torch.arange(0, n, tile, device=keys[0].device)
    g0 = out0 // (_WAYS * L) * (_WAYS * L)
    d = out0 - g0
    lens = group_runs(g0, n, L)
    ab = (g0, lens[:, 0], g0 + L, lens[:, 1])
    cd = (g0 + 2 * L, lens[:, 2], g0 + 3 * L, lens[:, 3])
    lab, lcd = ab[1] + ab[3], cd[1] + cd[3]
    steps = (2 * L).bit_length() + 1
    lo = (d - lcd).clamp(min=0)
    hi = torch.minimum(d, lab)
    for _ in range(steps):
        j = (lo + hi + 1) // 2       # candidate: AB records taken
        k = d - j                    # CD records taken
        a_col = _rank_col(keys, n, *ab, (j - 1).clamp(min=0), steps)
        c_col = _rank_col(keys, n, *cd, k, steps)
        c_lt_a = _lex_lt([w[c_col] for w in keys], [w[a_col] for w in keys])
        ok = (j <= 0) | (k >= lcd) | ~c_lt_a
        lo = torch.where(ok, j, lo)
        hi = torch.where(ok, hi, j - 1)
    ia = merge_path_split(keys, n, *ab, lo, steps)
    ic = merge_path_split(keys, n, *cd, d - lo, steps)
    return g0, torch.stack([ia, lo - ia, ic, d - lo - ic], dim=1)


def merge_partition4_plain(x4: torch.Tensor, run_len: int, width: int,
                           num_keys: int) -> torch.Tensor:
    """Plain version of the four-way partition kernel: each block of
    ``width`` output records' A, B, C and D splits (int32[blocks, 4])."""
    keys = [_as_i64(x4[r]) for r in [*range(num_keys), _TB4]]
    return merge4_splits(keys, x4.shape[1], run_len, width)[1].to(
        torch.int32)


def merge_pass4_folded_plain(x4: torch.Tensor, run_len: int, tile: int,
                             num_keys: int) -> torch.Tensor:
    """Plain version of K4's four-way pass: groups of four adjacent
    ascending runs of ``run_len`` merged into ascending runs of ``4 *
    run_len``, ties to the earlier run (the last group's runs as
    :func:`group_runs` gives them): two two-way passes' output. Per output
    tile: the four splits (:func:`merge4_splits`), then the first ``tile``
    records of its four windows in order."""
    rows, n = x4.shape
    L = run_len
    keys = [_as_i64(x4[r]) for r in [*range(num_keys), _TB4]]
    g0, sp = merge4_splits(keys, n, L, tile)
    lens = group_runs(g0, n, L)
    q = torch.arange(tile, device=x4.device)
    out = torch.empty_like(x4)
    per = max(1, _PLAIN_CHUNK // (2 * tile))
    for t0 in range(0, n // tile, per):
        t1 = min(n // tile, t0 + per)
        cols, past = [], []
        for r in range(_WAYS):
            i = sp[t0:t1, r:r + 1] + q
            ln = lens[t0:t1, r:r + 1]
            # a position past a run's end reads some record in n, its place
            # taken by the past-end flag
            cols.append((g0[t0:t1, None] + r * L + torch.minimum(i, ln - 1)
                         ).clamp(0, n - 1))
            past.append(i >= ln)
        cols = torch.cat(cols, dim=1)
        order = stable_lex_argsort(
            [torch.cat(past, dim=1).to(torch.int64), *(k[cols] for k in keys)],
            dim=1)
        src = torch.gather(cols, 1, order[:, :tile]).flatten()
        i32(out)[:, t0 * tile:t1 * tile] = i32(x4)[:, src]
    return out


def merge_pass4_folded_width(num_keys: int, n: int, run_len: int) -> int:
    """The four-way pass's block width on the card: records per block, a
    power of two up to 2048 that divides ``n`` and ``4 * run_len`` and
    whose shared memory fits K4's budget (0 for a key count K4 does not
    take). The output does not depend on it."""
    return _lib().uda_merge_ways_folded_width(num_keys, _WAYS, n, run_len)


def merge_partition4(x4: torch.Tensor, run_len: int, width: int,
                     num_keys: int) -> torch.Tensor:
    """The four-way partition kernel: per block of ``width`` output
    records of one four-way pass, the A, B, C and D records merged before
    it (int32[blocks, 4]), one thread a block boundary running a multiway
    selection on the power-of-two grid. The kernel on a CUDA tensor,
    :func:`merge_partition4_plain` on a CPU one. Counted as a
    ``merge_partition`` launch and as a ``merge_partition4`` one."""
    if x4.device.type == "cpu":
        return merge_partition4_plain(x4, run_len, width, num_keys)
    return _merge_partition_ways(x4, run_len, width, num_keys, _WAYS)


def _merge_partition_ways(x4: torch.Tensor, run_len: int, width: int,
                          num_keys: int, ways: int) -> torch.Tensor:
    """The multiway partition kernel of ``ways`` (4 or 8) runs a group on
    the card: int32[n // width, ways]."""
    n = _build.cuda_words(x4, rows=_SLOT).shape[1]
    if width <= 0 or n % width:
        raise ValueError(f"width={width} must divide n={n}")
    splits = torch.empty((n // width, ways), dtype=torch.int32,
                         device=x4.device)
    with torch.cuda.device(x4.device):
        _build.launch(_lib(), "uda_merge_partition_ways_folded",
                      x4.data_ptr(), splits.data_ptr(), n, num_keys, ways,
                      width, run_len, _build.stream_of(x4))
    _build.count("merge_partition")
    _build.count(f"merge_partition{ways}")
    return splits


def merge_pass4_folded(x4: torch.Tensor, run_len: int, tile: int,
                       num_keys: int, out: "torch.Tensor | None" = None
                       ) -> torch.Tensor:
    """K4's four-way pass: the four-way partition and merge kernels on a
    CUDA tensor, :func:`merge_pass4_folded_plain` on a CPU one; the result
    goes into ``out`` when given. On the card the blocks are
    :func:`merge_pass4_folded_width` records wide whatever ``tile`` is.
    Counted as a ``merge_pass_folded`` launch (it is K4) and as a
    ``merge_pass_folded4`` one."""
    return _merge_pass_ways(x4, run_len, tile, num_keys, out, _WAYS)


def _merge_pass_ways(x4: torch.Tensor, run_len: int, tile: int,
                     num_keys: int, out: "torch.Tensor | None",
                     ways: int) -> torch.Tensor:
    """K4's pass of ``ways`` (4 or 8) runs a group: the kernels on a CUDA
    tensor, the plain version on a CPU one."""
    name = f"merge_pass{ways}_folded"
    if out is not None and (out.shape != x4.shape or out.dtype != x4.dtype
                            or out.data_ptr() == x4.data_ptr()):
        raise ValueError(f"{name} needs a separate output like x4")
    if x4.device.type == "cpu":
        res = _PLAIN_STEP[ways](x4, run_len, tile, num_keys)
        return res if out is None else u32(i32(out).copy_(i32(res)))
    n = _build.cuda_words(x4, rows=_SLOT).shape[1]
    width = _lib().uda_merge_ways_folded_width(num_keys, ways, n, run_len)
    if not width:
        raise ValueError(f"{name} takes 1 to 3 key words, got {num_keys}")
    return _merge_pass_ways_at(x4, run_len, num_keys, width, out, ways)


def _merge_pass_ways_at(x4: torch.Tensor, run_len: int, num_keys: int,
                        width: int, out: "torch.Tensor | None", ways: int
                        ) -> torch.Tensor:
    """The multiway pass on the card with blocks of ``width`` records (a
    power of two up to 2048 dividing n and ways * run_len): the partition,
    then the merge."""
    splits = _merge_partition_ways(x4, run_len, width, num_keys, ways)
    out = torch.empty_like(x4) if out is None else _build.cuda_words(out)
    with torch.cuda.device(x4.device):
        _build.launch(_lib(), "uda_merge_pass_ways_folded", x4.data_ptr(),
                      out.data_ptr(), splits.data_ptr(), x4.shape[1],
                      num_keys, ways, width, run_len, _build.stream_of(x4))
    _build.count("merge_pass_folded")
    _build.count(f"merge_pass_folded{ways}")
    return out


def _group_order(x4: torch.Tensor, run_len: int, num_keys: int,
                 ways: int) -> torch.Tensor:
    """The columns of one pass of ``ways`` runs a group in merged order
    (int64[n]): every group's columns stably sorted by (key words,
    tie-break), so equal records keep their column order, the earlier run
    first. Where the runs ascend, that is their merge."""
    group = torch.arange(x4.shape[1], device=x4.device) // (ways * run_len)
    return stable_lex_argsort(
        [group, *(_as_i64(x4[r]) for r in [*range(num_keys), _TB4])])


def merge_pass8_folded_plain(x4: torch.Tensor, run_len: int, tile: int,
                             num_keys: int) -> torch.Tensor:
    """Plain version of K4's eight-way pass: groups of eight adjacent
    ascending runs of ``run_len`` merged into ascending runs of ``8 *
    run_len``, ties to the earlier run (the last group's runs short or
    missing where the columns end): three two-way passes' output. Of its
    own form: one stable sort of every group by (key words, tie-break);
    ``tile`` is taken for the steps' common signature and not used."""
    return u32(i32(x4)[:, _group_order(x4, run_len, num_keys, _WAYS8)])


def merge_partition8_plain(x4: torch.Tensor, run_len: int, width: int,
                           num_keys: int) -> torch.Tensor:
    """Plain version of the eight-way partition kernel: per block of
    ``width`` output records of one eight-way pass, how many records of
    each of its group's eight runs are merged before it (int32[blocks,
    8]), ties to the earlier run; they sum to the block's diagonal. Counted
    from the group's stable order (:func:`merge_pass8_folded_plain`'s):
    each run's records among the positions from the group's start to the
    block's."""
    n = x4.shape[1]
    group = _WAYS8 * run_len
    pos = torch.arange(n, device=x4.device)
    run = (_group_order(x4, run_len, num_keys, _WAYS8) - pos // group * group
           ) // run_len
    out0 = torch.arange(0, n, width, device=x4.device)
    g0 = out0 // group * group
    counts = []
    for r in range(_WAYS8):
        before = torch.cat([torch.zeros(1, dtype=torch.int64,
                                        device=x4.device),
                            torch.cumsum(run == r, 0)])
        counts.append(before[out0] - before[g0])
    return torch.stack(counts, dim=1).to(torch.int32)


def merge_pass8_folded_width(num_keys: int, n: int, run_len: int) -> int:
    """The eight-way pass's block width on the card: records per block, a
    power of two up to 2048 that divides ``n`` and ``8 * run_len`` and
    whose shared memory fits K4's budget (0 for a key count K4 does not
    take). The output does not depend on it."""
    return _lib().uda_merge_ways_folded_width(num_keys, _WAYS8, n, run_len)


def merge_partition8(x4: torch.Tensor, run_len: int, width: int,
                     num_keys: int) -> torch.Tensor:
    """The eight-way partition kernel: per block of ``width`` output
    records of one eight-way pass, the records of each of its group's
    eight runs merged before it (int32[blocks, 8]), one thread a block
    boundary running the four-way kernel's multiway selection over eight
    runs. The kernel on a CUDA tensor, :func:`merge_partition8_plain` on a
    CPU one. Counted as a ``merge_partition`` launch and as a
    ``merge_partition8`` one."""
    if x4.device.type == "cpu":
        return merge_partition8_plain(x4, run_len, width, num_keys)
    return _merge_partition_ways(x4, run_len, width, num_keys, _WAYS8)


def merge_pass8_folded(x4: torch.Tensor, run_len: int, tile: int,
                       num_keys: int, out: "torch.Tensor | None" = None
                       ) -> torch.Tensor:
    """K4's eight-way pass: the eight-way partition and merge kernels on a
    CUDA tensor, :func:`merge_pass8_folded_plain` on a CPU one; the result
    goes into ``out`` when given. On the card the blocks are
    :func:`merge_pass8_folded_width` records wide whatever ``tile`` is; a
    block merges its eight windows in three levels in shared memory.
    Counted as a ``merge_pass_folded`` launch (it is K4) and as a
    ``merge_pass_folded8`` one."""
    return _merge_pass_ways(x4, run_len, tile, num_keys, out, _WAYS8)


_PLAIN_STEP = {_WAYS: merge_pass4_folded_plain,
               _WAYS8: merge_pass8_folded_plain}
_MERGE_STEP = {2: merge_pass_folded, _WAYS: merge_pass4_folded,
               _WAYS8: merge_pass8_folded}


def merge_plan(n: int, tile: int) -> list:
    """K4's passes over ``n`` columns of sorted tiles of ``tile`` records,
    as ``(run_len, ways)``: the fewest passes, eight-way ones, and where
    that many passes leave room for one of them to be four-way (r runs, p
    passes of eight-way ones, r <= 4 * 8^(p - 1)), the four-way pass
    first; two runs take a two-way pass. A level of r runs leaves
    ceil(r / ways). The rule reads the run count alone. At 100,003,840
    columns and tile 1024 (97,660 tiles): one four-way pass, then five
    eight-way ones (97,660, 24,415, 3,052, 382, 48, 6, 1 runs), where
    four-way passes take 9 and two-way passes alone 17."""
    plan = []
    runs, run_len = -(-n // tile), tile
    while runs > 1:
        passes = ((runs - 1).bit_length() + 2) // 3  # eight-way ones
        ways = (2 if runs == 2
                else _WAYS if runs <= _WAYS << 3 * (passes - 1) else _WAYS8)
        plan.append((run_len, ways))
        runs, run_len = -(-runs // ways), run_len * ways
    return plan


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
    _check_cascade(n, num_keys, tile)
    return _merge_tiles(tile_sort_folded(x4, tile, num_keys), tile, num_keys)


def sort_records_folded4(words: torch.Tensor, num_keys: int, m: int,
                         tile: int = 1024) -> torch.Tensor:
    """The slim-layout cascade on records in place: the sorted [4, m]
    matrix of the first ``num_keys`` words of the row-major records
    ``words`` (uint32[n, w], n <= m; padding columns all-0xFFFFFFFF keys,
    so they sort after every real record, and rows num_keys..2 zero),
    which is never built: K3 reads the key words in place
    (:func:`tile_sort_folded_rows`), then K4's passes. ``tile`` as
    ``sort_lanes_folded4`` takes it; ``m`` a power-of-two multiple of it,
    where this equals ``sort_lanes_folded4`` on that matrix, or any
    multiple of ``max(tile, 4096)`` (:func:`records_cascade_columns`):
    then the cascade sorts whole blocks, its last run short, and its
    columns are the stable order of those keys all the same."""
    words = _check_words(words)
    _check_cascade(m, num_keys, tile, whole_blocks=True)
    return _merge_tiles(tile_sort_folded_rows(words, num_keys, m, tile),
                        tile, num_keys)


def records_cascade_columns(n: int, tile: int) -> int:
    """The columns :func:`sort_records_folded4` sorts ``n`` records in at
    ``tile``: the fewer of the power-of-two multiple of the tile that
    holds them and the whole number of blocks of ``max(tile, 4096)`` that
    does. Both the tile and K4's widest block divide the latter, so every
    K4 pass keeps the block width it has at a power of two; at 10^8
    records and tile 1024 it is 100,003,840 columns, not 2^27."""
    unit = max(tile, _K4_MAX_WIDTH)
    pow2 = max(tile, 1 << max(0, n - 1).bit_length())
    return min(pow2, -(-n // unit) * unit)


def _check_cascade(n: int, num_keys: int, tile: int,
                   whole_blocks: bool = False) -> None:
    """The cascade's shape: ``n`` a power-of-two multiple of ``tile``, or,
    with ``whole_blocks`` (the records cascade alone), any multiple of
    ``max(tile, 4096)``."""
    if not 0 < num_keys <= 3:
        raise ValueError(f"folded cascade needs num_keys <= 3, got "
                         f"{num_keys}")
    if tile & (tile - 1) or tile % (2 * _LANE):
        raise ValueError(f"tile={tile} must be a power of two multiple "
                         f"of {2 * _LANE}")
    unit = max(tile, _K4_MAX_WIDTH)
    if n % tile or ((n // tile) & (n // tile - 1)
                    and not (whole_blocks and n % unit == 0)):
        raise ValueError(f"n={n} must be a power-of-two multiple of "
                         f"tile={tile}"
                         + (f" or a multiple of {unit}" if whole_blocks
                            else ""))


def _merge_tiles(y: torch.Tensor, tile: int, num_keys: int) -> torch.Tensor:
    """K4's passes over K3's sorted tiles, up to one sorted run, as
    :func:`merge_plan` gives them; where the tiles are no power of two,
    each level's last group or pair has short runs or none
    (:func:`group_runs`, ``pallas_sort.pair_runs``)."""
    plan = merge_plan(y.shape[1], tile)
    spare = torch.empty_like(y) if plan else None
    for run_len, ways in plan:
        z = _MERGE_STEP[ways](y, run_len, tile, num_keys, out=spare)
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
