"""Shared inputs and the card fixture of the port's tests
(tests/test_torch_*.py).

Lanes-layout records (``words``) come from ``chip_smoke.lanes_words``, the
generator of the on-card smoke run, so both draw the same kinds of keys.
Whether there is a card is decided inside the ``cuda_device`` fixture,
never at import, so every pytest-xdist worker collects the same tests.
``paired_gauges_settle`` is autouse in every port test file that imports
it (all but ``test_torch_gpu.py``, which imports no ``uda_tpu``);
``port_plane`` (autouse where imported) leaves the port's observability
plane pristine around a test, as the conftest does for the reference's."""

import time

import numpy as np
import pytest
import torch

from chip_smoke import lanes_words as words
from uda_tpu_torch.ops.lane_gather import TILE_COLS


@pytest.fixture(autouse=True)
def paired_gauges_settle(request):
    """After each test of a file that imports it: every paired gauge of the
    reference (an increment that a decrement must meet,
    ``uda_tpu/utils/resledger.py`` ``PAIRED_GAUGES``) reads 0 on the port's
    metrics hub, as the reference's ``resledger.drain("bridge.exit")``
    requires of a finished task. The test's other fixtures are set up
    first, so their teardown (which may reset the hub) runs after this
    check; gauges that background threads still hold get 5 s to settle."""
    for name in request.fixturenames:
        if name not in ("request", "paired_gauges_settle"):
            request.getfixturevalue(name)
    yield
    from uda_tpu.utils.resledger import PAIRED_GAUGES
    from uda_tpu_torch.utils.metrics import metrics

    deadline = time.monotonic() + 5.0
    while True:
        left = {g: metrics.get_gauge(g) for g in PAIRED_GAUGES
                if metrics.get_gauge(g)}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert not left, f"paired gauges left charged on the port's hub: {left}"


@pytest.fixture(autouse=True)
def port_plane():
    """The port's process-wide observability state, reset before and
    after a test: the metrics hub, the flight recorder (its dump
    directory too), the sampling profiler, the rollup ring with its
    listeners and the HTTP endpoint, the resource ledger's books and
    lockdep's graph (the conftest resets only the reference's)."""
    from uda_tpu_torch.utils.flightrec import flightrec
    from uda_tpu_torch.utils.locks import lockdep
    from uda_tpu_torch.utils.metrics import metrics
    from uda_tpu_torch.utils.profiler import profiler
    from uda_tpu_torch.utils.resledger import resledger
    from uda_tpu_torch.utils.timeseries import disarm_observability_plane

    def reset():
        disarm_observability_plane()
        profiler.stop()
        profiler.reset()
        flightrec.reset()
        flightrec._dump_dir = ""
        resledger.reset()
        lockdep.reset()
        metrics.reset()

    reset()
    yield
    reset()


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
