"""The port's lanes-layout sort (uda_tpu_torch.ops.pallas_sort) against the
JAX package on the same numpy inputs: byte identity, because a stable
sort or merge has exactly one correct output. On the CPU the kernel
wrappers run their plain PyTorch versions; the JAX side runs its Pallas
kernels in interpret mode at small sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_helpers import oracle, words
from uda_tpu.ops import pallas_sort as jps
from uda_tpu_torch.ops import pallas_sort as tps


def port(fn, x: np.ndarray, *args, **kwargs) -> np.ndarray:
    out = fn(torch.from_numpy(x), *args, **kwargs)
    return out.numpy()


@pytest.mark.parametrize("num_keys,two_phase,n,tile", [
    (3, False, 1024, 128),
    (1, True, 512, 128),
    (3, True, 512, 256),
])
def test_sort_lanes_matches_jax(num_keys, two_phase, n, tile):
    x = words(num_keys + n, 32, n, num_keys)
    want = np.asarray(jps.sort_lanes(jnp.asarray(x), num_keys, tile=tile,
                                     interpret=True, two_phase=two_phase))
    got = port(tps.sort_lanes, x, num_keys, tile=tile, two_phase=two_phase)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,num_keys,tb_row,n,tile", [
    (32, 3, 31, 4096, 128),
    (32, 30, 31, 1024, 256),
    (8, 7, 7, 2048, 128),
    (8, 1, 7, 128, 128),
    (16, 2, 9, 8192, 1024),
])
def test_sort_lanes_matches_lexsort(rows, num_keys, tb_row, n, tile):
    x = words(rows * n, rows, n, num_keys)
    got = port(tps.sort_lanes, x, num_keys, tb_row, tile=tile)
    np.testing.assert_array_equal(got, oracle(x, num_keys, tb_row))


def test_keys8_sort_perm_matches_jax():
    x = words(7, 3, 1024, 3)
    sk, perm = jps.keys8_sort_perm(jnp.asarray(x), tile=256, interpret=True)
    tsk, tperm = tps.keys8_sort_perm(torch.from_numpy(x), tile=256)
    assert tperm.dtype == torch.int32
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(sk))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))


def test_tile_sort_matches_jax_tile_sort():
    x = words(11, 32, 512, 3)
    want = np.asarray(jps._tile_sort(jnp.asarray(x), 128, 3, 31,
                                     alternate=False, interpret=True))
    np.testing.assert_array_equal(port(tps.tile_sort, x, 128, 3, 31), want)
    np.testing.assert_array_equal(port(tps.tile_sort_plain, x, 128, 3, 31),
                                  want)


def test_one_merge_pass_matches_jax():
    """n = 2 * tile: one K2 and one K1 launch. The reference's first tile
    sort alternates directions (its merge input is bitonic as stored);
    the port's runs stay ascending; the merged outputs are equal."""
    tile, nk, tb = 128, 3, 31
    x = words(12, 32, 2 * tile, nk)
    alt = jps._tile_sort(jnp.asarray(x), tile, nk, tb, alternate=True,
                         interpret=True)
    splits = jps._pass_splits(alt, tile, True, tile, nk, tb)
    want = np.asarray(jps._merge_pass(alt, splits, tile, nk, tb,
                                      interpret=True))
    y = tps.tile_sort(torch.from_numpy(x), tile, nk, tb)
    np.testing.assert_array_equal(tps.merge_pass(y, tile, tile, nk,
                                                 tb).numpy(), want)


@pytest.mark.parametrize("n,tile,run_len", [(2048, 128, 128),
                                             (2048, 128, 512),
                                             (4096, 256, 2048)])
def test_merge_splits_match_jax_pass_splits(n, tile, run_len):
    """The port's vectorised merge-path split equals the reference's
    (_pass_splits, thr_a = run_len - i0) on the final pass, where every
    output tile ascends."""
    nk, tb = 2, 7
    x = words(n + run_len, 8, n, nk)
    x[tb] = np.arange(n, dtype=np.uint32)
    # runs of run_len, sorted; the reference stores the B run descending
    asc = x.copy()
    ref = x.copy()
    for base in range(0, n, run_len):
        run = oracle(x[:, base:base + run_len], nk, tb)
        run[tb] += np.uint32(base)
        asc[:, base:base + run_len] = run
        desc = (base // run_len) % 2 == 1
        ref[:, base:base + run_len] = run[:, ::-1] if desc else run
    spl = np.asarray(jps._pass_splits(jnp.asarray(ref), run_len, True, tile,
                                      nk, tb))
    keys = [torch.from_numpy(asc[r]).to(torch.int64) for r in (0, 1, tb)]
    _, i0, j0 = tps.merge_splits(keys, n, run_len, tile)
    np.testing.assert_array_equal(i0.numpy(), run_len - spl[:, 2])
    assert (i0 + j0).tolist() == [(t * tile) % (2 * run_len)
                                  for t in range(n // tile)]


def test_layout_helpers():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, size=(100, 26), dtype=np.uint32)
    lanes = tps.rows_to_lanes(torch.from_numpy(w))
    np.testing.assert_array_equal(lanes.numpy(),
                                  np.asarray(jps.rows_to_lanes(w)))
    np.testing.assert_array_equal(tps.lanes_to_rows(lanes, 26).numpy(), w)
    for n, tile in [(0, 1024), (1, 1024), (100, 1024), (1000, 256),
                    (1 << 20, 1024), ((1 << 20) + 1, 4096)]:
        assert tps.pad_pow2(n, tile) == jps.pad_pow2(n, tile)
    with pytest.raises(ValueError, match="layout rows"):
        tps.rows_to_lanes(torch.zeros((4, 40), dtype=torch.uint32))


@pytest.mark.parametrize("shape,kwargs,match", [
    ((32, 1024), dict(num_keys=3, tile=192), "power of two multiple"),
    ((32, 1024), dict(num_keys=3, tile=64), "power of two multiple"),
    ((32, 384), dict(num_keys=3, tile=128), "power-of-two multiple"),
    ((32, 1024), dict(num_keys=0, tile=128), "bad num_keys"),
    ((32, 1024), dict(num_keys=3, tb_row=32, tile=128), "bad num_keys"),
    ((32, 1024), dict(num_keys=7, tile=128, two_phase=True), "two_phase"),
])
def test_sort_lanes_guards_match_jax(shape, kwargs, match):
    x = np.zeros(shape, np.uint32)
    with pytest.raises(ValueError, match=match):
        jps.sort_lanes(jnp.asarray(x), interpret=True, **kwargs)
    with pytest.raises(ValueError, match=match):
        tps.sort_lanes(torch.from_numpy(x), **kwargs)


def test_keys8_guard_matches_jax():
    for k in (0, 8):
        x = np.zeros((k, 256), np.uint32)
        with pytest.raises(ValueError, match="1..7 key rows"):
            jps.keys8_sort_perm(jnp.asarray(x), tile=128, interpret=True)
        with pytest.raises(ValueError, match="1..7 key rows"):
            tps.keys8_sort_perm(torch.from_numpy(x), tile=128)

