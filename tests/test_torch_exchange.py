"""The port's windowed exchange (uda_tpu_torch.parallel.exchange) against
the JAX package's on the same seeded words: the layout's count matrix,
every round's ``(recv_words, recv_counts)`` for the flat, hierarchical and
coded bodies (capacities that force several rounds included), the
per-axis counters, ``max_rounds``' ``TransportError``,
``exchange_record_batches``, and the two failpoint sites firing with the
reference's keys and outcomes. The reference runs on its 8 CPU devices,
the port on 8 CPU slots."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import parallel as J
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils import failpoints as jfp
from uda_tpu.utils.ifile import crack as jcrack
from uda_tpu.utils.ifile import write_records
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import parallel as T
from uda_tpu_torch.parallel.mesh import Mesh as TMesh
from uda_tpu_torch.parallel.multihost import allgather
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils import failpoints as tfp
from uda_tpu_torch.utils.ifile import crack as tcrack
from uda_tpu_torch.utils.metrics import metrics

P = 8


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()


def meshes(shape: str):
    """(reference mesh, port mesh, exchange axis) of one shape: "flat8",
    or "PxC" pods x chips over the axes ("dcn", "ici")."""
    if shape == "flat8":
        return (J.make_mesh(P, "shuffle"),
                T.make_mesh(P, "shuffle", device="cpu"), "shuffle")
    p, c = map(int, shape.split("x"))
    return (JMesh(np.asarray(jax.devices()[:P]).reshape(p, c),
                  ("dcn", "ici")),
            TMesh(["cpu"] * P, ("dcn", "ici"), (p, c)), ("dcn", "ici"))


def inputs(kind: str, seed: int, rows: int = 48, width: int = 3):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (P * rows, width), dtype=np.uint32)
    dest = rng.integers(0, P, P * rows).astype(np.int32)
    if kind == "skew":
        dest[rng.random(P * rows) < 0.5] = 5
    elif kind == "one":
        dest[:] = 2
    return words, dest


def assert_rounds_equal(tmesh, got, want):
    assert len(got) == len(want)
    for r, ((tw, tc), (jw, jc)) in enumerate(zip(got, want)):
        assert np.array_equal(allgather(tmesh, tc),
                              np.asarray(jc).reshape(-1)), f"counts {r}"
        assert np.array_equal(allgather(tmesh, tw), np.asarray(jw)), \
            f"words {r}"


def exchange_counters(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k.startswith("exchange.")}


@pytest.mark.parametrize("shape", ["flat8", "2x4"])
def test_prepare_layout_matches(shape):
    jm, tm, axis = meshes(shape)
    words, dest = inputs("skew", 1)
    got = T.prepare_layout(words, dest, tm, axis)
    want = J.prepare_layout(words, dest, jm, axis)
    assert np.array_equal(got.counts, np.asarray(want.counts))
    assert np.array_equal(allgather(tm, got.words), np.asarray(want.words))
    assert np.array_equal(allgather(tm, got.pos), np.asarray(want.pos))
    assert got.record_bytes() == want.record_bytes()
    assert (got.hierarchical, got.coded) == (want.hierarchical, want.coded)


CASES = [("flat8", "auto", "uniform", 100), ("flat8", "flat", "skew", 7),
         ("2x4", "flat", "skew", 9), ("2x4", "hierarchical", "skew", 9),
         ("2x4", "hierarchical", "uniform", 100),
         ("4x2", "hierarchical", "skew", 5),
         ("2x4", "coded", "uniform", 4), ("2x4", "coded", "skew", 9),
         ("4x2", "coded", "uniform", 3), ("2x4", "coded", "one", 16),
         ("flat8", "coded", "uniform", 6)]


@pytest.mark.parametrize("shape,mode,kind,capacity", CASES)
def test_shuffle_exchange_matches_per_round(shape, mode, kind, capacity):
    """Every round's delivery and counts, and every per-axis counter
    (ICI/DCN bytes, DCN messages by pod, coded and saved bytes)."""
    jm, tm, axis = meshes(shape)
    words, dest = inputs(kind, capacity)
    got, glay = T.shuffle_exchange(words, dest, tm, axis, capacity,
                                   mode=mode)
    want, wlay = J.shuffle_exchange(words, dest, jm, axis, capacity,
                                    mode=mode)
    assert_rounds_equal(tm, got, want)
    assert exchange_counters(metrics.snapshot()) == \
        exchange_counters(jmetrics.snapshot())
    assert metrics.get("exchange.rounds") == len(got)
    assert (glay.hierarchical, glay.coded) == (wlay.hierarchical, wlay.coded)


def test_coded_rounds_equal_the_flat_rounds():
    """The coded body codes the uniform windows and delivers the flat
    body's bytes (the reference's construction contract)."""
    _, tm, axis = meshes("2x4")
    words, dest = inputs("uniform", 3, rows=64)
    flat, _ = T.shuffle_exchange(words, dest, tm, axis, 8, mode="flat")
    coded, _ = T.shuffle_exchange(words, dest, tm, axis, 8, mode="coded")
    assert metrics.get("exchange.dcn.coded.bytes") > 0
    assert len(flat) == len(coded) > 1
    for (fw, fc), (cw, cc) in zip(flat, coded):
        assert np.array_equal(allgather(tm, fw), allgather(tm, cw))
        assert np.array_equal(allgather(tm, fc), allgather(tm, cc))


def test_hierarchical_needs_a_pod_mesh_as_the_reference():
    jm, tm, axis = meshes("flat8")
    words, dest = inputs("uniform", 2)
    with pytest.raises(errors.ConfigError) as got:
        T.shuffle_exchange(words, dest, tm, axis, 8, mode="hierarchical")
    with pytest.raises(jerrors.ConfigError) as want:
        J.shuffle_exchange(words, dest, jm, axis, 8, mode="hierarchical")
    assert str(got.value).split(" on mesh")[0] == \
        str(want.value).split(" on mesh")[0]
    with pytest.raises(errors.ConfigError, match="unknown exchange mode"):
        T.resolve_exchange_mode(tm, axis, "bogus")


def test_max_rounds_raises_transport_error_before_any_round():
    jm, tm, axis = meshes("flat8")
    words, dest = inputs("one", 4, rows=8)
    with pytest.raises(errors.TransportError) as got:
        T.shuffle_exchange(words, dest, tm, axis, capacity=1, max_rounds=2)
    with pytest.raises(jerrors.TransportError) as want:
        J.shuffle_exchange(words, dest, jm, axis, capacity=1, max_rounds=2)
    assert str(got.value) == str(want.value)
    assert metrics.get("exchange.rounds") == 0


def test_the_empty_exchange_runs_no_round():
    """No record anywhere: one planned window, skipped, no round (the
    planner contract)."""
    _, tm, axis = meshes("2x4")
    got, layout = T.shuffle_exchange(np.zeros((0, 3), np.uint32),
                                     np.zeros(0, np.int32), tm, axis, 4)
    assert got == [] and not layout.counts.any()
    assert metrics.get("exchange.rounds.skipped") == 1
    assert metrics.get("exchange.rounds") == 0


def test_exchange_record_batches_matches():
    """Uneven rows (3 sources, 2 or 3 destinations, empty batches): each
    destination's concatenation in source order, as the reference."""
    rng = np.random.default_rng(5)
    spec = [[write_records([(rng.bytes(int(rng.integers(1, 9))),
                             rng.bytes(int(rng.integers(0, 20))))
                            for _ in range(int(rng.integers(0, 4)))])
             for _ in range(2 + s % 2)] for s in range(3)]
    got = T.exchange_record_batches([[tcrack(b) for b in row]
                                     for row in spec])
    want = J.exchange_record_batches([[jcrack(b) for b in row]
                                      for row in spec])
    assert [list(b.iter_records()) for b in got] == \
        [list(b.iter_records()) for b in want]
    assert len(got) == 3 and T.exchange_record_batches([]) == []


SITES = ("exchange.round", "exchange.decode")


def _armed(spec: str, fn_port, fn_ref):
    """Each package's exchange with ``spec`` armed in its own registry;
    returns (port, reference) outcomes: the error class name, or the
    rounds; and the hits each exchange site took during the call (the
    registries are process-wide, their counts cumulative)."""
    out = []
    for reg, fn in ((tfp.failpoints, fn_port), (jfp.failpoints, fn_ref)):
        before = {site: reg.hits[site] for site in SITES}
        with reg.scoped(spec):
            try:
                res = fn()
            except Exception as e:  # noqa: BLE001 - the outcome under test
                res = type(e).__name__
            out.append((res, {site: reg.hits[site] - before[site]
                              for site in SITES}))
    return out


@pytest.mark.parametrize("shape,spec,fires,hit", [
    ("flat8", "exchange.round=error", True, True),
    ("flat8", "exchange.round=error:match:stageB", False, False),
    ("2x4", "exchange.round=error:match:stageB", True, True),
    ("2x4", "exchange.round=error:match:round1.stageB", True, True),
    ("2x4", "exchange.round=error:transport:once", True, True),
    ("2x4", "exchange.round=delay:1:match:round2", False, True)])
def test_round_site_fires_as_the_reference(shape, spec, fires, hit):
    jm, tm, axis = meshes(shape)
    words, dest = inputs("skew", 6)
    (got, ghits), (want, whits) = _armed(
        spec, lambda: T.shuffle_exchange(words, dest, tm, axis, 9),
        lambda: J.shuffle_exchange(words, dest, jm, axis, 9))
    if fires:
        assert got == want == "TransportError"
    else:
        assert_rounds_equal(tm, got[0], want[0])
    assert ghits == whits
    assert (ghits["exchange.round"] > 0) == hit
    assert metrics.get("failpoint.exchange.round") == \
        jmetrics.get("failpoint.exchange.round")


@pytest.mark.parametrize("spec", ["exchange.decode=error",
                                  "exchange.decode=error:once",
                                  "exchange.decode=error:match:round1",
                                  "exchange.decode=error:transport"])
def test_decode_site_falls_back_as_the_reference(spec):
    """A decode failure (StorageError) falls back to the plain tile within
    the round and counts ``exchange.decode.fallbacks``; another error
    class propagates. The delivered bytes and the ledger are the
    reference's either way."""
    jm, tm, axis = meshes("2x4")
    words, dest = inputs("uniform", 7)
    metrics.reset()
    jmetrics.reset()
    (got, ghits), (want, whits) = _armed(
        spec, lambda: T.shuffle_exchange(words, dest, tm, axis, 4,
                                         mode="coded"),
        lambda: J.shuffle_exchange(words, dest, jm, axis, 4, mode="coded"))
    if isinstance(want, str):
        assert got == want
    else:
        assert_rounds_equal(tm, got[0], want[0])
        assert metrics.get("exchange.decode.fallbacks") == \
            jmetrics.get("exchange.decode.fallbacks") > 0
    assert ghits == whits and ghits["exchange.decode"] > 0
    assert exchange_counters(metrics.snapshot()) == \
        exchange_counters(jmetrics.snapshot())


def test_round_inputs_stay_on_their_slots():
    """Every delivery lands on its slot's device and keeps uint32."""
    _, tm, axis = meshes("2x4")
    words, dest = inputs("uniform", 8)
    rounds, layout = T.shuffle_exchange(words, dest, tm, axis, 100)
    for rw, rc in rounds:
        assert [w.device for w in rw] == tm.devices
        assert all(w.dtype == torch.uint32 for w in rw)
        assert [tuple(w.shape) for w in rw] == [(P * 100, 3)] * P
        assert [tuple(c.shape) for c in rc] == [(P,)] * P
