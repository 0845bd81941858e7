"""Shared inputs and the card fixture of the port's tests
(tests/test_torch_*.py).

Whether there is a card is decided inside the ``cuda_device`` fixture,
never at import, so every pytest-xdist worker collects the same tests."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``gpu``; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def words(seed: int, rows: int, n: int, num_keys: int) -> np.ndarray:
    """uint32[rows, n]: random payload; key rows mixing random words with
    a small alphabet (duplicates, words >= 2^31, all-0xFFFFFFFF keys)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=(rows, n), dtype=np.uint32)
    alphabet = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    small = rng.random(n) < 0.6
    x[:num_keys, small] = rng.choice(alphabet, size=(num_keys, small.sum()))
    x[:num_keys, rng.random(n) < 0.05] = np.uint32(0xFFFFFFFF)
    return x


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
