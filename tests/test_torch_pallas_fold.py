"""The port's slim keys cascade (uda_tpu_torch.ops.pallas_fold) against the
JAX package on the same numpy inputs, byte for byte (interpret-mode
Pallas on the JAX side, the plain versions on the port's side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EQUAL_RUN_CASES, equal_runs
from port_helpers import (oracle, paired_gauges_settle,  # noqa: F401
                          records, words)
from uda_tpu.ops import pallas_fold as jpf
from uda_tpu.ops import pallas_sort as jps
from uda_tpu_torch.models import terasort as tts
from uda_tpu_torch.ops import pallas_fold as tpf
from uda_tpu_torch.ops import pallas_sort as tps


@pytest.mark.parametrize("num_keys,n,tile", [(3, 1024, 256),
                                             (1, 512, 256)])
def test_sort_lanes_folded4_matches_jax(num_keys, n, tile):
    x = words(40 + num_keys, 4, n, num_keys)
    want = np.asarray(jpf.sort_lanes_folded4(jnp.asarray(x), num_keys,
                                             tile=tile, interpret=True))
    got = tpf.sort_lanes_folded4(torch.from_numpy(x), num_keys, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_lanes_folded_matches_jax():
    x = words(50, 8, 512, 2)
    want = np.asarray(jpf.sort_lanes_folded(jnp.asarray(x), 2, tile=256,
                                            interpret=True))
    got = tpf.sort_lanes_folded(torch.from_numpy(x), 2, tile=256).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[3:7].any()  # rows 3..6 zeroed


@pytest.mark.parametrize("num_keys,n,tile", [(3, 8192, 256), (2, 4096, 512),
                                             (1, 256, 256),
                                             (3, 16384, 4096),
                                             (2, 2048, 256),
                                             (1, 1 << 14, 256),
                                             (3, 1 << 15, 4096)])
def test_sort_lanes_folded4_matches_lexsort(num_keys, n, tile):
    x = words(n + num_keys, 4, n, num_keys)
    got = tpf.sort_lanes_folded4(torch.from_numpy(x), num_keys, tile=tile)
    np.testing.assert_array_equal(got.numpy(), oracle(x, num_keys, 3))


@pytest.mark.parametrize("k,tile", [(1, 256), (2, 512), (3, 1024),
                                    (3, 128)])
def test_keys8_folded_equals_unfolded(k, tile):
    """keys8f's contract: folded=True gives what folded=False gives (tile
    128 cannot fold and takes the standard cascade, as in the
    reference)."""
    x = torch.from_numpy(words(k * tile, k, 4096, k))
    sk, perm = tps.keys8_sort_perm(x, tile=tile, folded=True)
    sk0, perm0 = tps.keys8_sort_perm(x, tile=tile)
    assert torch.equal(sk, sk0) and torch.equal(perm, perm0)
    assert perm.dtype == torch.int32


@pytest.mark.parametrize("shape,kwargs,match", [
    ((8, 1024), dict(num_keys=3, tile=256), "4-row array"),
    ((4, 1024), dict(num_keys=4, tile=256), "num_keys <= 3"),
    ((4, 1024), dict(num_keys=0, tile=256), "num_keys <= 3"),
    ((4, 1024), dict(num_keys=3, tile=128), "multiple of 256"),
    ((4, 1536), dict(num_keys=3, tile=512), "power-of-two multiple"),
])
def test_folded4_guards_match_jax(shape, kwargs, match):
    x = np.zeros(shape, np.uint32)
    with pytest.raises(ValueError, match=match):
        jpf.sort_lanes_folded4(jnp.asarray(x), interpret=True, **kwargs)
    with pytest.raises(ValueError, match=match):
        tpf.sort_lanes_folded4(torch.from_numpy(x), **kwargs)


def test_folded_guard_matches_jax():
    x = np.zeros((4, 512), np.uint32)
    with pytest.raises(ValueError, match="8-row keys array"):
        jpf.sort_lanes_folded(jnp.asarray(x), 3, tile=256, interpret=True)
    with pytest.raises(ValueError, match="8-row keys array"):
        tpf.sort_lanes_folded(torch.from_numpy(x), 3, tile=256)



@pytest.mark.parametrize("num_keys,tile", [(1, 8192), (3, 8192),
                                           (1, 16384), (3, 16384)])
def test_sort_lanes_folded4_wide_tiles_match_lexsort(num_keys, tile):
    """Tiles past one K3 block on the card (8192 at 2-3 key words, 16384
    at 1): the cascade takes them and sorts as numpy does."""
    x = words(tile + num_keys, 4, 2 * tile, num_keys)
    got = tpf.sort_lanes_folded4(torch.from_numpy(x), num_keys, tile=tile)
    np.testing.assert_array_equal(got.numpy(), oracle(x, num_keys, 3))


@pytest.mark.parametrize("num_keys,n,run_len", EQUAL_RUN_CASES)
def test_merge_pass_folded_plain_sends_ties_to_a(num_keys, n, run_len):
    """Runs whose records have equal (key words, tie-break) twins in the
    other run: each merged pair is numpy's stable lexsort of the pair,
    every A record before its B twin."""
    x = equal_runs(n + num_keys, n, run_len, num_keys)
    got = tpf.merge_pass_folded_plain(torch.from_numpy(x), run_len, run_len,
                                      num_keys).numpy()
    for a0 in range(0, n, 2 * run_len):
        pair = x[:, a0:a0 + 2 * run_len]
        perm = np.lexsort([pair[3], *(pair[r] for r in
                                      reversed(range(num_keys)))])
        np.testing.assert_array_equal(got[:, a0:a0 + 2 * run_len],
                                      pair[:, perm])
        assert (perm[0::2] < run_len).all() and (perm[1::2] >= run_len).all()


@pytest.mark.parametrize("num_keys,n,run_len,width", [(1, 2048, 256, 512),
                                                      (2, 2048, 512, 256),
                                                      (3, 4096, 1024, 2048)])
def test_merge_partition_slim_matches_jax_pass_splits(num_keys, n, run_len,
                                                      width):
    """The partition on the slim layout (4 rows, tie-break row 3; its
    plain version on the CPU) equals the reference's _pass_splits as
    sort_lanes_folded4 calls it, with K4's width as its tile, on the final
    pass, where every output tile ascends."""
    x = words(n + width, 4, n, num_keys)
    x[3] = np.arange(n, dtype=np.uint32)
    asc = x.copy()
    ref = x.copy()
    for base in range(0, n, run_len):
        run = oracle(x[:, base:base + run_len], num_keys, 3)
        run[3] += np.uint32(base)
        asc[:, base:base + run_len] = run
        desc = (base // run_len) % 2 == 1
        ref[:, base:base + run_len] = run[:, ::-1] if desc else run
    spl = np.asarray(jps._pass_splits(jnp.asarray(ref), run_len, True, width,
                                      num_keys, 3))
    got = tps.merge_partition(torch.from_numpy(asc), run_len, width,
                              num_keys, 3)
    np.testing.assert_array_equal(got.numpy(), run_len - spl[:, 2])


def _keyr(w: np.ndarray, num_keys: int, m: int) -> torch.Tensor:
    """The transposed, padded key rows of records, as the keys8 engines
    build them for the [k, m] cascade entry."""
    keyr = np.full((num_keys, m), 0xFFFFFFFF, np.uint32)
    keyr[:, :w.shape[0]] = w[:, :num_keys].T
    return torch.from_numpy(keyr)


def _slim_shape(n: int) -> tuple:
    """(m, tile) of the slim cascade for n records: the lanes padding rule,
    at least one 256-record tile."""
    return tps.pad_pow2(max(n, 256), 1024)


@pytest.mark.parametrize("width", [3, 26])
@pytest.mark.parametrize("num_keys", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 3 * 4096 + 5])
def test_sort_records_folded4_matches_keys8_sort_perm(n, num_keys, width):
    """The cascade on records in place returns the sorted keys and the
    permutation keys8_sort_perm returns on the transposed, padded key
    rows; real all-0xFFFFFFFF keys (5% of the records) sort before the
    padding, and the whole [4, m] result is sort_lanes_folded4's on the
    matrix of those keys."""
    w = words(n + 7 * num_keys + width, width, n, num_keys).T.copy()
    m, tile = _slim_shape(n)
    out4 = tpf.sort_records_folded4(torch.from_numpy(w), num_keys, m,
                                    tile=tile)
    want_sk, want_perm = tps.keys8_sort_perm(_keyr(w, num_keys, m),
                                             tile=tile, folded=True)
    perm = out4[3].view(torch.int32)
    assert torch.equal(out4[:num_keys], want_sk)
    assert torch.equal(perm, want_perm)
    assert sorted(perm[:n].tolist()) == list(range(n))
    mat4 = tps.record_key_rows(torch.from_numpy(w), num_keys, m, rows=4)
    assert torch.equal(mat4[:num_keys], _keyr(w, num_keys, m))
    assert not mat4[num_keys:].any()
    assert torch.equal(out4, tpf.sort_lanes_folded4(mat4, num_keys,
                                                    tile=tile))


@pytest.mark.parametrize("kind", ["equal", "ones"])
@pytest.mark.parametrize("n", [1025, 3 * 4096 + 5])
def test_sort_records_folded4_keeps_equal_keys_in_arrival_order(n, kind):
    """All-equal keys (and all-0xFFFFFFFF ones, equal to the padding's):
    the permutation is the arrival order, real records first."""
    w = words(n, 26, n, 3, kind).T.copy()
    m, tile = _slim_shape(n)
    out4 = tpf.sort_records_folded4(torch.from_numpy(w), 3, m, tile=tile)
    assert torch.equal(out4[3].view(torch.int32),
                       torch.arange(m, dtype=torch.int32))


def test_sort_records_folded4_matches_jax():
    """The cascade on records in place against the JAX package's keys8
    cascade on the key rows it would have built."""
    n, m = 1000, 1024
    w = words(61, 26, n, 3).T.copy()
    want_sk, want_perm = jps.keys8_sort_perm(
        jnp.asarray(_keyr(w, 3, m).numpy()), tile=256, interpret=True)
    out4 = tpf.sort_records_folded4(torch.from_numpy(w), 3, m, tile=256)
    np.testing.assert_array_equal(out4[:3].numpy(), np.asarray(want_sk))
    np.testing.assert_array_equal(out4[3].view(torch.int32).numpy(),
                                  np.asarray(want_perm))


@pytest.mark.parametrize("n", [1, 1023, 1025, 3 * 4096 + 5])
def test_single_chip_sort_keys8f_equals_carry(n):
    w = torch.from_numpy(records(n + 11, n))
    got = tts.single_chip_sort(w, path="keys8f", device="cpu")
    carry = tts.single_chip_sort(w, path="carry", device="cpu")
    np.testing.assert_array_equal(got.numpy(), carry.numpy())


@pytest.mark.parametrize("shape,num_keys,m,match", [
    ((100, 2), 3, 128, "within a record of 2"),
    ((100, 26), 0, 128, "1 to 3 key words"),
    ((100, 26), 4, 128, "1 to 3 key words"),
    ((300, 26), 3, 256, "do not fit m=256"),
    ((300, 26), 3, 1 << 33, "holds 2\\^32"),
])
def test_tile_sort_folded_rows_refuses_what_it_does_not_take(shape, num_keys,
                                                             m, match):
    w = torch.zeros(shape, dtype=torch.uint32)
    with pytest.raises(ValueError, match=match):
        tpf.tile_sort_folded_rows(w, num_keys, m, 128)


# the records cascade on whole blocks: columns a multiple of max(tile,
# 4096), so each pass's last pair may have a short B run or none
_BLOCK = 4096


def _whole_blocks(n: int, tile: int = 1024) -> int:
    unit = max(tile, _BLOCK)
    return -(-n // unit) * unit


@pytest.mark.parametrize("num_keys", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 1023, 1025, 2 * 4096 + 5, 3 * 4096 + 5,
                               5 * 4096 + 1, 9 * 4096 + 3])
def test_sort_records_folded4_on_whole_blocks_matches_the_pow2_cascade(
        n, num_keys):
    """The cascade on whole blocks sorts the records as the one on the
    power-of-two padding does: the same sorted keys and permutation in
    the first n columns, every record once; the padding after them in
    arrival order."""
    w = words(n + 3 * num_keys, 26, n, num_keys).T.copy()
    m = _whole_blocks(n)
    m2, tile = _slim_shape(n)
    out4 = tpf.sort_records_folded4(torch.from_numpy(w), num_keys, m,
                                    tile=1024)
    want_sk, want_perm = tps.keys8_sort_perm(_keyr(w, num_keys, m2),
                                             tile=tile, folded=True)
    perm = out4[3].view(torch.int32)
    assert out4.shape == (4, m)
    assert torch.equal(out4[:num_keys, :n], want_sk[:, :n])
    assert torch.equal(perm[:n], want_perm[:n])
    assert sorted(perm[:n].tolist()) == list(range(n))
    assert torch.equal(perm[n:], torch.arange(n, m, dtype=torch.int32))
    assert (out4[:num_keys, n:].view(torch.int32) == -1).all()


@pytest.mark.parametrize("kind", ["equal", "ones"])
@pytest.mark.parametrize("n", [2 * 4096 + 5, 5 * 4096 + 1])
def test_sort_records_folded4_on_whole_blocks_keeps_arrival_order(n, kind):
    """All-equal keys, and all-0xFFFFFFFF ones equal to the padding's, on
    whole blocks: the permutation is the arrival order, real records
    before the padding."""
    w = words(n, 26, n, 3, kind).T.copy()
    m = _whole_blocks(n)
    out4 = tpf.sort_records_folded4(torch.from_numpy(w), 3, m, tile=1024)
    assert torch.equal(out4[3].view(torch.int32),
                       torch.arange(m, dtype=torch.int32))


def _runs_with_a_short_last(seed: int, num_keys: int, run_len: int,
                            n: int) -> np.ndarray:
    """[4, n] slim records in ascending runs of ``run_len`` (the last one
    shorter where n is no multiple of it), keys from a small alphabet so
    that runs tie, row 3 the arrival index."""
    rng = np.random.default_rng(seed)
    x = np.zeros((4, n), np.uint32)
    x[:num_keys] = rng.integers(0, 4, size=(num_keys, n), dtype=np.uint32)
    x[3] = np.arange(n, dtype=np.uint32)
    for base in range(0, n, run_len):
        x[:, base:base + run_len] = oracle(x[:, base:base + run_len],
                                           num_keys, 3)
        x[3, base:base + run_len] += np.uint32(base)
    return x


@pytest.mark.parametrize("num_keys", [1, 3])
@pytest.mark.parametrize("pairs,short", [(2, 512), (2, 1024), (1, 1536),
                                         (0, 256), (0, 768)])
def test_merge_pass_folded_plain_takes_a_short_last_run(num_keys, pairs,
                                                        short):
    """A pass whose last pair has a short B run (``short`` past the A run)
    or a lone A run (``short`` <= run_len): every full pair and the last
    one are numpy's stable lexsort of the pair, ties to A; the partition's
    splits stay inside the pair's runs."""
    L, tile = 1024, 256
    n = pairs * 2 * L + short
    x = _runs_with_a_short_last(n + num_keys, num_keys, L, n)
    got = tpf.merge_pass_folded_plain(torch.from_numpy(x), L, tile,
                                      num_keys).numpy()
    for a0 in range(0, n, 2 * L):
        pair = x[:, a0:a0 + 2 * L]
        perm = np.lexsort([pair[3], *(pair[r] for r in
                                      reversed(range(num_keys)))])
        np.testing.assert_array_equal(got[:, a0:a0 + 2 * L], pair[:, perm])
    splits = tps.merge_partition_plain(torch.from_numpy(x), L, tile,
                                       num_keys, 3).numpy()
    a_base = np.arange(0, n, tile) // (2 * L) * (2 * L)
    la = np.minimum(L, n - a_base)
    lb = np.minimum(L, n - a_base - la)
    d = np.arange(0, n, tile) - a_base
    assert ((splits >= np.maximum(0, d - lb)) & (splits <= np.minimum(d, la))
            ).all()


@pytest.mark.parametrize("n,tile,whole", [(3 * 1024, 1024, True),
                                          (3 * 4096, 1024, False),
                                          (5 * 4096, 256, False),
                                          (20480, 8192, True)])
def test_check_cascade_keeps_the_pow2_contract(n, tile, whole):
    """Only the records cascade takes whole blocks, and only whole blocks
    of max(tile, 4096): every other n that is no power-of-two multiple of
    the tile is refused, as sort_lanes_folded4 refuses it."""
    with pytest.raises(ValueError, match="power-of-two multiple"):
        tpf._check_cascade(n, 3, tile, whole_blocks=whole)
    with pytest.raises(ValueError, match="power-of-two multiple"):
        tpf.sort_lanes_folded4(torch.zeros((4, n), dtype=torch.uint32), 3,
                               tile=tile)


def test_sort_records_folded4_takes_whole_blocks_alone():
    """sort_records_folded4 takes 3 x 4096 columns at tile 1024 and
    refuses 3 x 1024; sort_lanes_folded4 refuses both."""
    w = torch.from_numpy(records(7, 3 * 4096 - 5))
    tpf._check_cascade(3 * 4096, 3, 1024, whole_blocks=True)
    assert tpf.sort_records_folded4(w, 3, 3 * 4096).shape == (4, 3 * 4096)
    with pytest.raises(ValueError, match="or a multiple of 4096"):
        tpf.sort_records_folded4(w[:3000], 3, 3 * 1024)


@pytest.mark.parametrize("n,tile,columns", [
    (1, 1024, 1024), (1000, 1024, 1024), (4097, 1024, 8192),
    (3 * 4096 + 5, 1024, 16384), (10**5 + 3, 1024, 102400),
    (10**8, 1024, 100_003_840), (1 << 27, 1024, 1 << 27),
    (70_001, 16384, 81920)])
def test_records_cascade_columns(n, tile, columns):
    """The fewer of the power-of-two columns and the whole blocks of
    max(tile, 4096) that hold n records."""
    assert tpf.records_cascade_columns(n, tile) == columns


def test_cascade_unit_is_the_kernels_widest_block():
    """The whole-block unit comes from the kernels' own K1_MAX_WIDTH in
    csrc/lanes_common.cuh, read without a build; a name the header does
    not define is refused."""
    from uda_tpu_torch.ops import _build

    assert _build.header_constant("K1_MAX_WIDTH") == tpf._K4_MAX_WIDTH
    assert tpf.records_cascade_columns(1, 256) == 256
    assert tpf.records_cascade_columns(257, 256) == 512
    assert tpf.records_cascade_columns(
        3 * tpf._K4_MAX_WIDTH + 1, 256) == 4 * tpf._K4_MAX_WIDTH
    with pytest.raises(RuntimeError, match="NO_SUCH_WIDTH"):
        _build.header_constant("NO_SUCH_WIDTH")


@pytest.mark.parametrize("n,columns,passes", [(3 * 4096 + 5, 16384, 2),
                                              (10**5 + 3, 102400, 3)])
def test_single_chip_sort_keys8f_counts_its_cascade(n, columns, passes):
    """keys8f sorts on whole blocks as carry does and counts the records,
    the columns and the K4 passes of its cascade once a call (16 tiles:
    two four-way passes; 100: two four-way and one eight-way)."""
    from uda_tpu_torch.utils.metrics import metrics

    w = torch.from_numpy(records(n + 13, n))
    before = {k: metrics.counters.get(k, 0.0)
              for k in tts.CASCADE_COUNTERS}
    got = tts.single_chip_sort(w, path="keys8f", device="cpu")
    counted = {k: metrics.counters.get(k, 0.0) - before[k]
               for k in tts.CASCADE_COUNTERS}
    carry = tts.single_chip_sort(w, path="carry", device="cpu")
    np.testing.assert_array_equal(got.numpy(), carry.numpy())
    assert counted == {"sort.cascade_records": n,
                       "sort.cascade_columns": columns,
                       "sort.cascade_passes": passes}


# the four-way pass: (runs of 256, output tile 128) and the run lengths of
# the pass's last group: 4, 3, 2 or 1 whole runs, or a short last run
_GROUP_SHAPES = [(2 * 4, ()), (4 + 3, ()), (4 + 2, ()), (4 + 1, ()),
                 (4 + 2, (128,)), (4 + 3, (128,)), (4, (128,)), (0, (128,))]


def _group_runs_input(seed: int, num_keys: int, whole: int, short: tuple,
                      kind: str, L: int = 256) -> np.ndarray:
    """[4, n] slim records in ascending runs of L: ``whole`` whole runs,
    then runs of the ``short`` lengths; the key words of ``kind``
    (``lanes_words``: "mixed" has duplicates, "equal" one value, "ones"
    all-0xFFFFFFFF), row 3 the arrival index."""
    n = whole * L + sum(short)
    x = words(seed, 4, n, num_keys, kind)
    x[3] = np.arange(n, dtype=np.uint32)
    bounds = [i * L for i in range(whole + 1)]
    for length in short:
        bounds.append(bounds[-1] + length)
    for a0, a1 in zip(bounds, bounds[1:]):
        x[:, a0:a1] = oracle(x[:, a0:a1], num_keys, 3)
        x[3, a0:a1] += np.uint32(a0)
    return x


@pytest.mark.parametrize("kind", ["mixed", "equal", "ones"])
@pytest.mark.parametrize("whole,short", _GROUP_SHAPES)
@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_merge_pass4_folded_plain_equals_two_two_way_passes(num_keys, whole,
                                                           short, kind):
    """The four-way pass merges groups of four runs as two two-way passes
    do, byte for byte: groups of 4, 3, 2 and 1 whole runs, a short last
    run, equal and all-0xFFFFFFFF keys (the arrival index decides)."""
    L, tile = 256, 128
    x = torch.from_numpy(_group_runs_input(whole * 7 + len(short) + num_keys,
                                           num_keys, whole, short, kind))
    two = tpf.merge_pass_folded_plain(
        tpf.merge_pass_folded_plain(x, L, tile, num_keys), 2 * L, tile,
        num_keys)
    four = tpf.merge_pass4_folded_plain(x, L, tile, num_keys)
    assert torch.equal(four, two)


@pytest.mark.parametrize("num_keys,n,run_len", [(1, 1 << 12, 256),
                                                (3, 1 << 12, 256),
                                                (2, 3 * 1024, 256)])
def test_merge_pass4_folded_plain_sends_ties_to_the_earliest_run(
        num_keys, n, run_len):
    """Groups whose four runs hold equal (key words, tie-break) twins:
    each merged group is numpy's stable lexsort of the group, every A
    record before its B twin, B before C, C before D, and the pass equals
    two two-way passes."""
    x = equal_runs(n + num_keys, n, run_len, num_keys, ways=4)
    got = tpf.merge_pass4_folded_plain(torch.from_numpy(x), run_len,
                                       run_len, num_keys).numpy()
    g = 4 * run_len
    for a0 in range(0, n, g):
        grp = x[:, a0:a0 + g]
        perm = np.lexsort([grp[3], *(grp[r] for r in
                                     reversed(range(num_keys)))])
        np.testing.assert_array_equal(got[:, a0:a0 + g], grp[:, perm])
        for r in range(4):
            assert (perm[r::4] // run_len == r).all()
    two = tpf.merge_pass_folded_plain(tpf.merge_pass_folded_plain(
        torch.from_numpy(x), run_len, run_len, num_keys), 2 * run_len,
        run_len, num_keys)
    np.testing.assert_array_equal(got, two.numpy())


@pytest.mark.parametrize("whole,short", _GROUP_SHAPES)
@pytest.mark.parametrize("num_keys", [1, 3])
def test_merge_partition4_plain_counts_each_run(num_keys, whole, short):
    """Each block boundary's four splits are how many records of A, B, C
    and D lie before it in numpy's stable sort of the group (ties to the
    earlier run), within the group's run lengths, summing to the
    boundary's diagonal."""
    L, width = 256, 128
    x = _group_runs_input(whole + 3 * num_keys, num_keys, whole, short,
                          "mixed")
    n = x.shape[1]
    got = tpf.merge_partition4_plain(torch.from_numpy(x), L, width,
                                     num_keys).numpy()
    assert got.shape == (n // width, 4)
    for b, out0 in enumerate(range(0, n, width)):
        g0 = out0 // (4 * L) * (4 * L)
        grp = x[:, g0:g0 + 4 * L]
        perm = np.lexsort([grp[3], *(grp[r] for r in
                                     reversed(range(num_keys)))])
        before = perm[:out0 - g0] // L
        np.testing.assert_array_equal(got[b], np.bincount(before,
                                                          minlength=4))


# the eight-way pass: (runs of 256, output tile 128) and the run lengths
# of the pass's last group: 8, 7, 5, 4 or 1 whole runs, or a short last
# run after 8, 3 or no whole runs
_GROUP8_SHAPES = [(2 * 8, ()), (8 + 7, ()), (8 + 5, ()), (8 + 4, ()),
                  (8 + 1, ()), (8 + 3, (128,)), (8, (384,)), (0, (128,))]


@pytest.mark.parametrize("kind", ["mixed", "equal", "ones"])
@pytest.mark.parametrize("whole,short", _GROUP8_SHAPES)
@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_merge_pass8_folded_plain_equals_three_two_way_passes(
        num_keys, whole, short, kind):
    """The eight-way pass merges groups of eight runs as three two-way
    passes do, and as a four-way pass then a two-way one, byte for byte:
    whole groups, groups of 7, 5, 4 and 1 runs, a short last run, equal
    and all-0xFFFFFFFF keys (the arrival index decides)."""
    L, tile = 256, 128
    x = torch.from_numpy(_group_runs_input(whole * 11 + len(short) + num_keys,
                                           num_keys, whole, short, kind))
    two = x
    for lvl in range(3):
        two = tpf.merge_pass_folded_plain(two, L << lvl, tile, num_keys)
    four = tpf.merge_pass_folded_plain(
        tpf.merge_pass4_folded_plain(x, L, tile, num_keys), 4 * L, tile,
        num_keys)
    eight = tpf.merge_pass8_folded_plain(x, L, tile, num_keys)
    assert torch.equal(eight, two)
    assert torch.equal(eight, four)


@pytest.mark.parametrize("num_keys,n,run_len", [(1, 1 << 14, 1024),
                                                (3, 1 << 13, 256),
                                                (2, 3 << 12, 1024),
                                                (3, 9 << 11, 256)])
def test_merge_pass8_folded_plain_sends_ties_to_the_earliest_run(
        num_keys, n, run_len):
    """Groups whose eight runs hold equal (key words, tie-break) twins
    (the last group short or with runs missing): each merged group is
    numpy's stable lexsort of the group, every twin of a run before the
    next run's, and the pass equals three two-way passes."""
    x = equal_runs(n + num_keys, n, run_len, num_keys, ways=8)
    got = tpf.merge_pass8_folded_plain(torch.from_numpy(x), run_len,
                                       run_len, num_keys).numpy()
    g = 8 * run_len
    for a0 in range(0, n, g):
        grp = x[:, a0:a0 + g]
        perm = np.lexsort([grp[3], *(grp[r] for r in
                                     reversed(range(num_keys)))])
        np.testing.assert_array_equal(got[:, a0:a0 + g], grp[:, perm])
        if grp.shape[1] == g:
            for r in range(8):
                assert (perm[r::8] // run_len == r).all()
    two = torch.from_numpy(x)
    for lvl in range(3):
        two = tpf.merge_pass_folded_plain(two, run_len << lvl, run_len,
                                          num_keys)
    np.testing.assert_array_equal(got, two.numpy())


@pytest.mark.parametrize("whole,short", _GROUP8_SHAPES)
@pytest.mark.parametrize("num_keys", [1, 3])
def test_merge_partition8_plain_counts_each_run(num_keys, whole, short):
    """Each block boundary's eight splits are how many records of each
    run lie before it in numpy's stable sort of the group (ties to the
    earlier run), within the group's run lengths, summing to the
    boundary's diagonal."""
    L, width = 256, 128
    x = _group_runs_input(whole + 5 * num_keys, num_keys, whole, short,
                          "mixed")
    n = x.shape[1]
    got = tpf.merge_partition8_plain(torch.from_numpy(x), L, width,
                                     num_keys).numpy()
    assert got.shape == (n // width, 8)
    for b, out0 in enumerate(range(0, n, width)):
        g0 = out0 // (8 * L) * (8 * L)
        grp = x[:, g0:g0 + 8 * L]
        perm = np.lexsort([grp[3], *(grp[r] for r in
                                     reversed(range(num_keys)))])
        before = perm[:out0 - g0] // L
        np.testing.assert_array_equal(got[b], np.bincount(before,
                                                          minlength=8))
        assert got[b].sum() == out0 - g0


@pytest.mark.parametrize("whole,short", [(4, ()), (3, ()), (2, (128,)),
                                         (1, ())])
@pytest.mark.parametrize("kind", ["mixed", "equal"])
def test_merge_partition8_plain_counts_as_the_four_way_one(kind, whole,
                                                           short):
    """On one group of at most four runs, the eight-way splits are the
    four-way partition's (merge4_splits' nested search), four runs
    missing: the same count of each run before each boundary, ties to the
    earlier run."""
    L, width = 256, 128
    x = torch.from_numpy(_group_runs_input(whole + 17, 3, whole, short,
                                           kind))
    eight = tpf.merge_partition8_plain(x, L, width, 3)
    assert torch.equal(eight[:, :4], tpf.merge_partition4_plain(x, L,
                                                                width, 3))
    assert not eight[:, 4:].any()


@pytest.mark.parametrize("num_keys,n,tile", [(2, 2048, 256),
                                             (1, 8192, 256)])
def test_sort_lanes_folded4_eight_way_matches_jax(num_keys, n, tile):
    """A cascade whose plan holds an eight-way pass (8 tiles: one; 32: a
    four-way pass, then an eight-way one) against the JAX package's
    two-way cascade."""
    assert 8 in [ways for _, ways in tpf.merge_plan(n, tile)]
    x = words(70 + num_keys, 4, n, num_keys)
    want = np.asarray(jpf.sort_lanes_folded4(jnp.asarray(x), num_keys,
                                             tile=tile, interpret=True))
    got = tpf.sort_lanes_folded4(torch.from_numpy(x), num_keys, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_records_folded4_eight_way_matches_jax():
    """The cascade on records in place, its plan one eight-way pass over 8
    tiles, against the JAX package's keys8 cascade on the key rows it
    would have built."""
    n, m = 2000, 2048
    assert tpf.merge_plan(m, 256) == [(256, 8)]
    w = words(67, 26, n, 3).T.copy()
    want_sk, want_perm = jps.keys8_sort_perm(
        jnp.asarray(_keyr(w, 3, m).numpy()), tile=256, interpret=True)
    out4 = tpf.sort_records_folded4(torch.from_numpy(w), 3, m, tile=256)
    np.testing.assert_array_equal(out4[:3].numpy(), np.asarray(want_sk))
    np.testing.assert_array_equal(out4[3].view(torch.int32).numpy(),
                                  np.asarray(want_perm))


@pytest.mark.parametrize("n,tile,plan", [
    (1024, 1024, []),
    (2048, 1024, [(1024, 2)]),
    (3 * 1024, 1024, [(1024, 4)]),
    (1 << 14, 1024, [(1024, 4), (4096, 4)]),
    (1 << 15, 1024, [(1024, 4), (4096, 8)]),
    (1_003_520, 1024, [(1024, 4), (4096, 4), (16384, 8), (1 << 17, 8)]),
    (100_003_840, 1024, [(1024, 4)]
     + [(4096 << 3 * i, 8) for i in range(5)]),
    (5 * 1024, 1024, [(1024, 8)]),
    (8 * 1024, 1024, [(1024, 8)]),
    (9 * 1024, 1024, [(1024, 4), (4096, 4)]),
    (64 * 1024, 1024, [(1024, 8), (8192, 8)]),
    (4 * 4096, 4096, [(4096, 4)]),
    (33 * 1024, 1024, [(1024, 8), (8192, 8)])])
def test_merge_plan(n, tile, plan):
    """The fewest passes, eight-way, and where they leave room for one of
    them to be four-way, the four-way pass first; two runs a two-way
    pass: 6 passes at the sort cell's 97,660 tiles of 1024 (100,003,840
    columns; 97,660, 24,415, 3,052, 382, 48, 6, 1 runs), where four-way
    passes take 9 and two-way passes alone 17."""
    assert tpf.merge_plan(n, tile) == plan
    if n == 100_003_840:
        assert len(tpf.merge_plan(n, tile)) == 6


def _record_steps(monkeypatch) -> list:
    """The (run_len, ways) of every K4 pass the cascade runs from here on,
    in order."""
    calls = []

    def counted(step, ways):
        def run(y, run_len, *args, **kw):
            calls.append((run_len, ways))
            return step(y, run_len, *args, **kw)
        return run

    monkeypatch.setattr(tpf, "_MERGE_STEP", {
        ways: counted(step, ways) for ways, step in tpf._MERGE_STEP.items()})
    return calls


def test_merge_tiles_runs_the_plan(monkeypatch):
    """The records cascade runs merge_plan's passes, each by its own step:
    on 100 tiles two four-way passes and one eight-way, and its output is
    the two-way cascade's."""
    n = 10**5 + 3
    w = torch.from_numpy(records(17, n))
    m = tpf.records_cascade_columns(n, 1024)
    y = tpf.tile_sort_folded_rows(w, 3, m, 1024)
    two_way = y
    for lvl in range((m // 1024 - 1).bit_length()):
        two_way = tpf.merge_pass_folded(two_way, 1024 << lvl, 1024, 3)
    calls = _record_steps(monkeypatch)
    got = tpf.sort_records_folded4(w, 3, m, tile=1024)
    assert calls == tpf.merge_plan(m, 1024) == [
        (1024, 4), (4096, 4), (16384, 8)]
    assert torch.equal(got, two_way)


@pytest.mark.parametrize("num_keys,sub,tile,plan", [
    (3, 256, 1024, [(256, 4)]), (1, 256, 2048, [(256, 8)]),
    (2, 512, 1024, [(512, 2)]), (3, 256, 4096, [(256, 4), (1024, 4)])])
def test_sub_tiles_merge_by_the_plan(monkeypatch, num_keys, sub, tile, plan):
    """A tile wider than one K3 block: its sub-tiles are merged by the
    passes merge_plan gives the tile, and the tiles come out sorted as
    the plain K3 sorts them."""
    x = words(tile + num_keys, 4, 2 * tile, num_keys)
    out = tpf.tile_sort_folded_plain(torch.from_numpy(x), sub, num_keys)
    calls = _record_steps(monkeypatch)
    got = tpf._merge_sub_tiles(out, sub, tile, num_keys)
    assert calls == plan
    assert torch.equal(got, tpf.tile_sort_folded_plain(torch.from_numpy(x),
                                                       tile, num_keys))
