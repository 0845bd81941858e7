"""The port's round planner (uda_tpu_torch.parallel.planner) against the
JAX package's, field by field: flat, hierarchical and coded plans over
uniform, skewed, single-destination and empty count matrices, the
capacity guards, and the counters each executed window books."""

import dataclasses
import zlib

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.parallel import planner as jplanner
from uda_tpu.parallel.mesh import MeshTopology as JTopology
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch.parallel import planner as tplanner
from uda_tpu_torch.parallel.mesh import MeshTopology as TTopology
from uda_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()


TOPOS = {"flat8": (None, "shuffle", 1, 8), "2x4": ("dcn", "ici", 2, 4),
         "4x2": ("dcn", "ici", 4, 2), "8x1": ("dcn", "ici", 8, 1),
         "none": None}


def _counts(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 40, (n, n))
    if kind == "skew":
        c = rng.integers(0, 6, (n, n))
        c[:, 3] += rng.integers(50, 200, n)       # one hot destination
        return c
    if kind == "single":
        c = np.zeros((n, n), np.int64)
        c[1, 6] = 37                               # one cross-pod pair
        return c
    if kind == "pod_local":
        c = rng.integers(0, 30, (n, n))
        half = n // 2
        c[:half, half:] = 0
        c[half:, :half] = 0
        return c
    return np.zeros((n, n), np.int64)


def _plan_fields(plan) -> dict:
    d = dataclasses.asdict(plan)
    d["windows"] = [dataclasses.asdict(w) | {"empty": w.empty}
                    for w in plan.windows]
    return d


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("kind", ["uniform", "skew", "single", "pod_local",
                                  "empty"])
@pytest.mark.parametrize("dispatch", ["flat", "hierarchical", "coded"])
@pytest.mark.parametrize("capacity", [1, 7, 64])
def test_plan_rounds_field_by_field(topo, kind, dispatch, capacity):
    spec = TOPOS[topo]
    counts = _counts(kind, 8, zlib.crc32(f"{topo}{kind}{capacity}".encode()))
    hier = dispatch != "flat"
    if spec is not None and spec[0] is not None and not (
            spec[2] > 1 and spec[3] > 1):
        hier = False                    # no pod structure to stage over
    jt = None if spec is None else JTopology(*spec)
    tt = None if spec is None else TTopology(*spec)
    want = jplanner.plan_rounds(counts, capacity, jt, record_bytes=20,
                                hierarchical=hier, coded=dispatch == "coded")
    got = tplanner.plan_rounds(counts, capacity, tt, record_bytes=20,
                               hierarchical=hier, coded=dispatch == "coded")
    assert _plan_fields(got) == _plan_fields(want)
    for win_t, win_j in zip(got.windows, want.windows):
        for coded in (False, True):
            tplanner.record_executed_window(win_t, got, coded=coded)
            jplanner.record_executed_window(win_j, want, coded=coded)
    tplanner.record_plan_skips(got)
    jplanner.record_plan_skips(want)
    assert metrics.snapshot() == {k: v for k, v in jmetrics.snapshot().items()
                                  if k.startswith("exchange.")}


def test_the_empty_exchange_is_one_skipped_window():
    """The planner contract of the reference's empty-exchange test
    (``tests/test_exchange_hier.py``): one planned window, skipped."""
    for hier in (False, True):
        plan = tplanner.plan_rounds(np.zeros((8, 8), np.int64), 2,
                                    TTopology("dcn", "ici", 2, 4),
                                    record_bytes=8, hierarchical=hier)
        assert plan.planned == 1 and plan.skipped == 1
        assert plan.windows == ()
    plan = tplanner.plan_rounds(np.zeros((0, 0), np.int64), 3)
    assert plan.planned == 1 and plan.skipped == 1


@pytest.mark.parametrize("capacity", [0, -3])
def test_non_positive_capacity_raises_as_the_reference(capacity):
    with pytest.raises(ValueError) as got:
        tplanner.plan_rounds(np.ones((4, 4)), capacity)
    with pytest.raises(ValueError) as want:
        jplanner.plan_rounds(np.ones((4, 4)), capacity)
    assert str(got.value) == str(want.value)


def test_hierarchical_tag_overflow_raises_as_the_reference():
    topo = ("dcn", "ici", 2, 4)
    with pytest.raises(ValueError) as got:
        tplanner.plan_rounds(np.ones((8, 8)), 1 << 28, TTopology(*topo),
                             hierarchical=True)
    with pytest.raises(ValueError) as want:
        jplanner.plan_rounds(np.ones((8, 8)), 1 << 28, JTopology(*topo),
                             hierarchical=True)
    assert str(got.value) == str(want.value)


def test_pad_chunk_and_constants():
    assert tplanner.CODED_CHUNK_ROWS == jplanner.CODED_CHUNK_ROWS
    assert tplanner.CODED_WIN_FACTOR == jplanner.CODED_WIN_FACTOR
    for rows in range(-2, 20):
        assert tplanner._pad_chunk(rows) == jplanner._pad_chunk(rows)
