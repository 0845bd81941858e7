"""The port's lane gather (uda_tpu_torch.ops.lane_gather, kernel K5) against
the Pallas lowering probe it ports (scripts/probe_gather.py): the probe's
own oracle ``x[:, perm]`` at its three shapes, and one interpret-mode run
of its ``kern_take_along`` body. Tolerance 0: a gather moves words."""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from uda_tpu_torch.ops import _build, lane_gather

ROOT = Path(__file__).resolve().parent.parent
PROBE_SHAPES = [(32, 2048), (8, 2048), (8, 512)]


def _probe():
    spec = importlib.util.spec_from_file_location(
        "probe_gather", ROOT / "scripts" / "probe_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_inputs(rows: int, n: int):
    """The probe's inputs (probe_gather.run): its seeds and value range."""
    x = np.random.default_rng(0).integers(0, 1 << 31, (rows, n)).astype(
        np.uint32)
    perm = np.random.default_rng(1).permutation(n).astype(np.int32)
    return x, perm


@pytest.mark.parametrize("rows,n", PROBE_SHAPES)
def test_take_lanes_matches_probe_oracle(rows, n):
    x, perm = _probe_inputs(rows, n)
    got = lane_gather.take_lanes(torch.from_numpy(x), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(x)[:, perm])


def test_take_lanes_matches_interpret_mode_pallas():
    rows, n = 8, 512
    x, perm = _probe_inputs(rows, n)
    f = pl.pallas_call(
        partial(_probe().kern_take_along, rows=rows, n=n),
        in_specs=[pl.BlockSpec((1, n), lambda: (0, 0)),
                  pl.BlockSpec((rows, n), lambda: (0, 0))],
        out_specs=pl.BlockSpec((rows, n), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, n), jnp.uint32),
        interpret=True)
    want = np.asarray(f(jnp.asarray(perm)[None, :], jnp.asarray(x)))
    got = lane_gather.take_lanes(torch.from_numpy(x), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), want)


def test_take_lanes_keeps_every_bit():
    """Words >= 2^31 and all-ones survive the int32 views; a repeated
    index is a gather, not only a permutation."""
    x = np.array([[0, 1, 2**31, 2**32 - 1],
                  [7, 2**31 + 5, 3, 2**32 - 2]], np.uint32)
    idx = np.array([3, 2, 2, 0], np.int32)
    got = lane_gather.take_lanes(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), x[:, idx])
    assert got.dtype == torch.uint32


@pytest.mark.parametrize("perm,match", [
    (torch.arange(8, dtype=torch.int64), "int32"),
    (torch.arange(7, dtype=torch.int32), "int32\\[8\\]"),
    (torch.arange(8, dtype=torch.int32).reshape(2, 4), "int32\\[8\\]"),
])
def test_take_lanes_refuses_a_bad_perm(perm, match):
    x = torch.zeros((4, 8), dtype=torch.uint32)
    with pytest.raises(ValueError, match=match):
        lane_gather.take_lanes(x, perm)


@pytest.mark.parametrize("bad", [-1, 8, 1 << 20])
def test_take_lanes_refuses_an_index_out_of_range(bad):
    """An index outside [0, n) is refused, not wrapped or read past x."""
    x = torch.zeros((4, 8), dtype=torch.uint32)
    perm = torch.arange(8, dtype=torch.int32)
    perm[3] = bad
    with pytest.raises(IndexError, match=r"\[0, 8\)"):
        lane_gather.take_lanes(x, perm)
    with pytest.raises(IndexError, match=r"\[0, 8\)"):
        lane_gather.take_lanes_plain(x, perm)


def test_take_lanes_counts_no_launch_on_the_cpu():
    _build.reset_launches()
    x, perm = _probe_inputs(8, 512)
    lane_gather.take_lanes(torch.from_numpy(x), torch.from_numpy(perm))
    assert _build.launches["take_lanes"] == 0
