"""The port's slim keys cascade (uda_tpu_torch.ops.pallas_fold) against the
JAX package on the same numpy inputs, byte for byte (interpret-mode
Pallas on the JAX side, the plain versions on the port's side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_helpers import oracle, words
from uda_tpu.ops import pallas_fold as jpf
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

