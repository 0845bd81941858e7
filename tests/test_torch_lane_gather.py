"""The port's lane gather (uda_tpu_torch.ops.lane_gather, kernel K5) against
the Pallas lowering probe it ports (scripts/probe_gather.py): the probe's
own oracle ``x[:, perm]`` at its three shapes, one interpret-mode run of
its ``kern_take_along`` body, and the plain version's records
decomposition against numpy's ``x[:, perm]`` at the edges of the kernel's
tiles and records. Tolerance 0: a gather moves words."""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from port_helpers import (GATHER_NS, GATHER_ROWS, PERM_KINDS,
                          gather_index)
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


@pytest.mark.parametrize("kind", PERM_KINDS)
@pytest.mark.parametrize("n", GATHER_NS)
@pytest.mark.parametrize("rows", GATHER_ROWS)
def test_take_lanes_plain_records_match_numpy(rows, n, kind):
    """The records decomposition (transpose into padded records, gather
    records, transpose back) equals ``x[:, perm]`` for every record width
    and tile edge, every kind of index, words >= 2^31 and all-ones."""
    rng = np.random.default_rng(rows * 1000 + n)
    x = rng.integers(0, 2**32, size=(rows, n), dtype=np.uint32)
    x[:, ::7] = np.uint32(0xFFFFFFFF)
    idx = gather_index(kind, n, rows + n)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    got = lane_gather.take_lanes_plain(xt, it)
    assert got.dtype == torch.uint32 and got.shape == (rows, n)
    np.testing.assert_array_equal(got.numpy(), x[:, idx])
    np.testing.assert_array_equal(lane_gather.take_lanes(xt, it).numpy(),
                                  x[:, idx])


@pytest.mark.parametrize("rows,want", [(1, 4), (3, 4), (4, 4), (5, 8),
                                       (8, 8), (26, 28), (33, 36)])
def test_records_start_on_16_byte_boundaries(rows, want):
    assert lane_gather.record_words(rows) == want


def test_design_goes_by_the_bytes_of_x():
    """The direct kernel up to SMALL_BYTES of x, the records design past
    it; the probe's shapes and the main path's shape on either side."""
    small = lane_gather.SMALL_BYTES
    assert lane_gather.design(8, small // 32) == "direct"
    assert lane_gather.design(8, small // 32 + 1) == "records"
    assert lane_gather.design(1, small // 4) == "direct"
    assert lane_gather.design(8, 1 << 27) == "records"
    assert lane_gather.design(8, 0) == "direct"
