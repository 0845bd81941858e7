"""The port's device GF(2^8) word arithmetic (uda_tpu_torch.coding.gfjax)
against the JAX package's: the code matrices, scaling, the matrix action
and the traced-row decode on random words, encode -> decode identity, and
the pod-size refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.coding import gfjax as jgf
from uda_tpu.utils import errors as jerrors
from uda_tpu_torch.coding import gfjax as tgf
from uda_tpu_torch.interop import words_from_numpy, words_to_numpy
from uda_tpu_torch.utils import errors


def _words(seed: int, shape) -> np.ndarray:
    w = np.random.default_rng(seed).integers(0, 2**32, shape,
                                             dtype=np.uint32)
    w.reshape(-1)[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x01020304]
    return w


def _t(x: np.ndarray) -> torch.Tensor:
    return words_from_numpy(x, "cpu")


@pytest.mark.parametrize("c", [2, 3, 4, 8, 127])
def test_coded_matrices_match(c):
    te, td = tgf.coded_matrices(c)
    je, jd = jgf.coded_matrices(c)
    assert np.array_equal(te, je) and np.array_equal(td, jd)
    assert te.dtype == td.dtype == np.uint8


@pytest.mark.parametrize("c", [0, 1, 128, 129])
def test_bad_block_counts_refused_as_the_reference(c):
    """Outside [2, 128] ``ConfigError``; at 128 the Cauchy rows need 256
    points, past the RS codec's 255, and both raise its StorageError."""
    with pytest.raises(errors.UdaError) as got:
        tgf.coded_matrices(c)
    with pytest.raises(jerrors.UdaError) as want:
        jgf.coded_matrices(c)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert tgf.MAX_CODED_BLOCKS == jgf.MAX_CODED_BLOCKS


@pytest.mark.parametrize("coeff", [0, 1, 2, 3, 0x53, 0x8E, 255])
def test_scale_words_match(coeff):
    x = _words(coeff, (5, 33))
    got = words_to_numpy(tgf.gf_scale_words(coeff, _t(x)))
    want = np.asarray(jgf.gf_scale_words(coeff, jnp.asarray(x)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("c", [2, 4, 5])
def test_matmul_and_decode_row_match(c):
    enc, dec = jgf.coded_matrices(c)
    blocks = _words(10 + c, (c, 3, 7, 6))
    got = tgf.gf_matmul_words(enc, _t(blocks))
    want = jgf.gf_matmul_words(enc, jnp.asarray(blocks))
    assert np.array_equal(words_to_numpy(got), np.asarray(want))
    for row in range(c):
        mine = tgf.gf_decode_row(dec, row, got)
        ref = jgf.gf_decode_row(dec, jnp.int32(row), want)
        assert np.array_equal(words_to_numpy(mine), np.asarray(ref))
        # decoding the coded chunks gives the row's block back
        assert np.array_equal(words_to_numpy(mine), blocks[row])
        assert np.array_equal(
            words_to_numpy(tgf.gf_decode_row(dec, torch.tensor(row), got)),
            blocks[row])


def test_matmul_with_zero_coefficients_matches():
    mat = np.array([[0, 0, 0], [1, 0, 7], [0, 9, 0]], np.uint8)
    blocks = _words(3, (3, 4, 5))
    got = tgf.gf_matmul_words(mat, _t(blocks))
    want = jgf.gf_matmul_words(mat, jnp.asarray(blocks))
    assert np.array_equal(words_to_numpy(got), np.asarray(want))
    assert not words_to_numpy(got)[0].any()
