"""Shared inputs and the card fixture of the port's tests
(tests/test_torch_*.py).

Lanes-layout records (``words``) come from ``chip_smoke.lanes_words``, the
generator of the on-card smoke run, so both draw the same kinds of keys.
Whether there is a card is decided inside the ``cuda_device`` fixture,
never at import, so every pytest-xdist worker collects the same tests."""

import numpy as np
import pytest
import torch

from chip_smoke import lanes_words as words
from uda_tpu_torch.ops.lane_gather import TILE_COLS


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``gpu``; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def records(seed: int, n: int) -> np.ndarray:
    """uint32[n, 26] TeraSort-shaped records with duplicated keys and some
    all-0xFFFFFFFF keys (word 2's pad bytes zeroed except there)."""
    w = words(seed, 26, n, 3).T.copy()
    w[:, 2] &= np.uint32(0xFFFF0000)
    w[np.random.default_rng(seed + 1).random(n) < 0.05, :3] = 0xFFFFFFFF
    return w


def oracle(x: np.ndarray, num_keys: int, tb_row: int) -> np.ndarray:
    """numpy's stable lexsort of lanes-layout records, tie-break row set."""
    perm = np.lexsort([x[r] for r in reversed(range(num_keys))])
    out = x[:, perm]
    out[tb_row] = perm.astype(np.uint32)
    return out


PERM_KINDS = ("random", "identity", "reversed", "merge", "repeated")
# K5's edges: records of 1 to 9 words, padded by 0 to 3 words to 16-byte
# boundaries; no column, one, a block's tile less one, one tile, one more,
# several tiles
GATHER_ROWS = (1, 3, 4, 5, 8, 26, 31, 32, 33)
GATHER_NS = (0, 1, TILE_COLS - 1, TILE_COLS, TILE_COLS + 1, 4 * TILE_COLS + 5)


def gather_index(kind: str, n: int, seed: int) -> np.ndarray:
    """An int32[n] index for K5 (``x[:, perm]``): a random permutation,
    the identity, the reversal, a merge permutation (the stable order of
    two sorted halves of random keys: two increasing runs interleaved, as
    the two-phase merge applies) or random indices with repeats."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        idx = rng.permutation(n)
    elif kind == "identity":
        idx = np.arange(n)
    elif kind == "reversed":
        idx = np.arange(n)[::-1]
    elif kind == "merge":
        keys = rng.integers(0, 2**32, n, dtype=np.uint64)
        h = n // 2
        runs = np.concatenate([np.sort(keys[:h]), np.sort(keys[h:])])
        idx = np.argsort(runs, kind="stable")
    elif kind == "repeated":
        idx = rng.integers(0, max(n, 1), n)
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(idx, dtype=np.int32)
