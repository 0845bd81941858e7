"""The port's row gather (uda_tpu_torch.ops.lane_gather.take_rows) on the
CPU, where the wrapper runs its plain version: numpy's ``x[perm]`` at
record widths of 1, 3, 26 and 27 words and at the edges of the kernel's
blocks, by a permutation, by indices with repeats and by the fourth row
of a longer [4, m] tensor read in place, every bit kept; the checks on
``perm``; and ``single_chip_sort``'s keys8 engines, which move their
records through it, against ``carry`` and the JAX package. Tolerance 0:
a gather moves words."""

import numpy as np
import pytest
import torch

from port_helpers import paired_gauges_settle, records  # noqa: F401
from uda_tpu.models import terasort as jts
from uda_tpu_torch.models import terasort as tts
from uda_tpu_torch.ops import _build, lane_gather

WIDTHS = (1, 3, 26, 27)
PERMS = ("permutation", "repeats", "row3")


def _block_rows(w: int) -> int:
    """Rows one block of the kernel takes at width ``w`` (8-byte words
    where ``w`` is even, as on a fresh tensor)."""
    v = w // 2 if w % 2 == 0 else w
    return lane_gather.ROW_SPAN // v if v < lane_gather.ROW_SPAN else 1


def _edges(w: int) -> list:
    b = _block_rows(w)
    return sorted({1, b - 1, b, b + 1, 3 * b + 2} - {0})


def _words(n: int, w: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).integers(0, 2**32, size=(n, w),
                                             dtype=np.uint32)
    x[::5] = np.uint32(0xFFFFFFFF)
    x[1::7, 0] = np.uint32(0x80000001)
    return x


def _perm(kind: str, n: int, seed: int) -> tuple:
    """(the int32 tensor handed to take_rows, the n indices it holds)."""
    rng = np.random.default_rng(seed)
    if kind == "permutation":
        idx = rng.permutation(n).astype(np.int32)
        return torch.from_numpy(idx), idx
    if kind == "repeats":
        idx = rng.integers(0, n, size=n).astype(np.int32)
        return torch.from_numpy(idx), idx
    # the sort cascade's tie-break row: row 3 of [4, m], m > n, the tail
    # past n holding indices no record has
    m = 2 * n + 3
    full = rng.integers(0, 1 << 30, size=(4, m)).astype(np.int32)
    full[3, :n] = rng.permutation(n)
    t = torch.from_numpy(full)[3]
    return t, full[3, :n].copy()


@pytest.mark.parametrize("kind", PERMS)
@pytest.mark.parametrize("w,n", [(w, n) for w in WIDTHS for n in _edges(w)])
def test_take_rows_matches_numpy(w, n, kind):
    x = _words(n, w, 10 * n + w)
    perm, idx = _perm(kind, n, n + w)
    got = lane_gather.take_rows(torch.from_numpy(x), perm)
    assert got.dtype == torch.uint32 and got.shape == (n, w)
    np.testing.assert_array_equal(got.numpy(), x[idx])
    np.testing.assert_array_equal(
        lane_gather.take_rows_plain(torch.from_numpy(x), perm).numpy(),
        x[idx])


def test_take_rows_keeps_every_bit():
    """All-ones and words >= 2^31 survive the int32 views; a repeated
    index is a gather, not only a permutation."""
    x = np.array([[0, 2**32 - 1, 2**31], [2**31 + 5, 7, 2**32 - 2],
                  [2**32 - 1, 2**32 - 1, 2**32 - 1]], np.uint32)
    idx = np.array([2, 2, 0], np.int32)
    got = lane_gather.take_rows(torch.from_numpy(x), torch.from_numpy(idx))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), x[idx])


def test_take_rows_of_no_rows():
    x = torch.empty((0, 26), dtype=torch.uint32)
    got = lane_gather.take_rows(x, torch.empty(0, dtype=torch.int32))
    assert got.shape == (0, 26) and got.dtype == torch.uint32


@pytest.mark.parametrize("perm,match", [
    (torch.arange(8, dtype=torch.int64), "int32"),
    (torch.arange(8, dtype=torch.int16), "int32"),
    (torch.arange(8, dtype=torch.int32).reshape(2, 4), "int32"),
    (torch.arange(7, dtype=torch.int32), "at least 8"),
])
def test_take_rows_refuses_a_bad_perm(perm, match):
    x = torch.zeros((8, 3), dtype=torch.uint32)
    with pytest.raises(ValueError, match=match):
        lane_gather.take_rows(x, perm)


@pytest.mark.parametrize("bad", [-1, 8, 1 << 20])
def test_take_rows_refuses_an_index_out_of_range(bad):
    """An index outside [0, n) among the first n is refused, not wrapped;
    entries past n are never read."""
    x = torch.zeros((8, 3), dtype=torch.uint32)
    perm = torch.arange(10, dtype=torch.int32)
    perm[9] = bad
    lane_gather.take_rows(x, perm)
    perm[3] = bad
    with pytest.raises(IndexError, match=r"\[0, 8\)"):
        lane_gather.take_rows(x, perm)


def test_take_rows_refuses_words_it_does_not_take():
    perm = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint32"):
        lane_gather.take_rows(torch.zeros((4, 3), dtype=torch.int32), perm)
    with pytest.raises(ValueError, match="uint32"):
        lane_gather.take_rows(torch.zeros(4, dtype=torch.uint32), perm)


def test_take_rows_counts_no_launch_on_the_cpu():
    _build.reset_launches()
    x = torch.from_numpy(_words(300, 26, 1))
    tts.single_chip_sort(x, path="keys8f", tile=256, device="cpu")
    lane_gather.take_rows(x, torch.arange(300, dtype=torch.int32))
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("row_vector,w,offset", [(2, 26, 0), (1, 27, 0),
                                                 (1, 26, 1), (1, 1, 0),
                                                 (2, 2, 0)])
def test_row_vector_words_reads_width_and_base(row_vector, w, offset):
    """8-byte words where the row width is even and the rows start on 8
    bytes; a 4-byte-aligned view of the same rows takes 4-byte words."""
    flat = torch.zeros(4 * w + 2, dtype=torch.uint32)
    x = flat[offset:offset + 4 * w].view(4, w)
    assert flat.data_ptr() % 8 == 0
    assert lane_gather.row_vector_words(x) == row_vector


@pytest.mark.parametrize("path", ["keys8f", "keys8"])
@pytest.mark.parametrize("n,tile", [(1000, 128), (3000, 256)])
def test_single_chip_sort_keys8_engines_match_carry_and_jax(path, n, tile):
    """The keys8 engines move the sorted records through take_rows: the
    bytes are carry's and the JAX package's."""
    w = records(n + 3, n)
    got = tts.single_chip_sort(w, path=path, tile=tile, device="cpu")
    carry = tts.single_chip_sort(w, path="carry", device="cpu")
    np.testing.assert_array_equal(got.numpy(), carry.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jts.single_chip_sort(w, path="carry")))
