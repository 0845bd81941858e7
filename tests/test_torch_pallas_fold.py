"""The port's slim keys cascade (uda_tpu_torch.ops.pallas_fold) against the
JAX package on the same numpy inputs, byte for byte (interpret-mode
Pallas on the JAX side, the plain versions on the port's side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EQUAL_RUN_CASES, equal_runs
from port_helpers import oracle, words
from uda_tpu.ops import pallas_fold as jpf
from uda_tpu.ops import pallas_sort as jps
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
                                             (3, 16384, 4096)])
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
