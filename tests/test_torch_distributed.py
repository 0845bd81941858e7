"""The port's distributed sort (uda_tpu_torch.parallel.distributed) and
``models.terasort.distributed_terasort`` against the JAX package's on the
same seeded words, byte for byte: the fused step for every payload path
(the port's lanes engines, on their plain versions here, held to the
reference's ``carry`` order, which its lanes engines give by
construction, and once to the reference's own interpret-mode ``keys8``),
multiround "always", "auto" after an overflow and "never", the pod
meshes' exchange modes, the ``keys8f`` refusal, the splitters, and the
concatenated valid rows against the single-chip stable sort."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu import parallel as J
from uda_tpu.models import terasort as jterasort
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch import parallel as T
from uda_tpu_torch.interop import words_to_numpy
from uda_tpu_torch.models import terasort as tterasort
from uda_tpu_torch.parallel.mesh import Mesh as TMesh
from uda_tpu_torch.parallel.multihost import allgather
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.metrics import metrics

P = 8
AXIS = "shuffle"
POD = ("dcn", "ici")


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()


@pytest.fixture(scope="module")
def jmesh():
    return J.make_mesh(P, AXIS)


@pytest.fixture(scope="module")
def tmesh():
    return T.make_mesh(P, AXIS, device="cpu")


def pod_meshes(p: int = 2, c: int = 4):
    return (JMesh(np.asarray(jax.devices()[:P]).reshape(p, c), POD),
            TMesh(["cpu"] * P, POD, (p, c)))


def records(seed: int, rows: int = 96, width: int = 5,
            skew: bool = False) -> np.ndarray:
    """Words with equal first words, equal whole keys and all-0xFFFFFFFF
    keys; ``skew`` sends half of them to partition 0."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (P * rows, width), dtype=np.uint32)
    w[:, 0] &= np.uint32(0xE000000F)
    w[rng.random(P * rows) < 0.2, 1:3] = 7
    w[::11, :3] = 0xFFFFFFFF
    if skew:
        w[: P * rows // 2, 0] = 3
    return w


def assert_same(got, want) -> None:
    assert np.array_equal(allgather(got.mesh, got.words),
                          np.asarray(want.words))
    assert np.array_equal(allgather(got.mesh, got.valid_counts),
                          np.asarray(want.valid_counts).reshape(-1))
    assert got.overflow() == want.overflow()


def valid_concat(res) -> np.ndarray:
    words = allgather(res.mesh, res.words)
    n = allgather(res.mesh, res.valid_counts)
    rows = words.reshape(P, -1, words.shape[1])
    return np.concatenate([rows[s, :n[s]] for s in range(P)])


REF_PATHS = ("carry", "gather", "gather2", "carrychunk")
PORT_PATHS = REF_PATHS + ("keys8", "lanes", "lanes2")


@pytest.fixture(scope="module")
def fused_reference(jmesh):
    words = records(1)
    spl = J.uniform_splitters(P)
    return words, {path: J.distributed_sort_step(
        words, spl, jmesh, AXIS, 2 * 96, 3, payload_path=path)
        for path in REF_PATHS}


@pytest.mark.parametrize("path", PORT_PATHS)
def test_fused_step_matches_every_payload_path(path, tmesh, fused_reference):
    words, want = fused_reference
    got = T.distributed_sort_step(words, T.uniform_splitters(P), tmesh,
                                  AXIS, 2 * 96, 3, payload_path=path)
    assert got.overflow() == 0
    assert_same(got, want.get(path, want["carry"]))
    assert metrics.get("exchange.rounds") == 0    # the fused step plans none


def test_keys8f_with_two_keys_matches(tmesh, jmesh):
    words = records(2, width=4)
    spl = J.uniform_splitters(P)
    want = J.distributed_sort_step(words, spl, jmesh, AXIS, 200, 2,
                                   payload_path="carry")
    got = T.distributed_sort_step(words, spl, tmesh, AXIS, 200, 2,
                                  payload_path="keys8f")
    assert_same(got, want)


def test_keys8_matches_the_reference_lanes_engine(tmesh, jmesh):
    """The reference's own keys8 engine (interpret-mode Pallas on its CPU
    mesh) against the port's keys8 on K2/K1's plain versions."""
    words = records(3, rows=32)
    spl = J.uniform_splitters(P)
    want = J.distributed_sort_step(words, spl, jmesh, AXIS, 64, 3,
                                   payload_path="keys8")
    got = T.distributed_sort_step(words, spl, tmesh, AXIS, 64, 3,
                                  payload_path="keys8")
    assert_same(got, want)


@pytest.mark.parametrize("multiround", ["always", "auto", "never"])
@pytest.mark.parametrize("path", ["carry", "keys8"])
def test_multiround_policies_match(multiround, path, tmesh, jmesh):
    """Under skew the fused attempt overflows a capacity of 24: "auto"
    re-runs through the windowed exchange, "never" reports the overflow,
    "always" skips the fused attempt; rounds and skips as the
    reference."""
    words = records(4, skew=True)
    spl = J.uniform_splitters(P)
    want = J.distributed_sort_step(words, spl, jmesh, AXIS, 24, 3,
                                   payload_path="carry",
                                   multiround=multiround)
    got = T.distributed_sort_step(words, spl, tmesh, AXIS, 24, 3,
                                  payload_path=path, multiround=multiround)
    assert_same(got, want)
    for name in ("exchange.rounds", "exchange.rounds.skipped"):
        assert metrics.get(name) == jmetrics.get(name)
    if multiround == "never":
        assert got.overflow() > 0
        with pytest.raises(errors.TransportError) as e:
            got.check()
        with pytest.raises(jerrors.TransportError) as je:
            want.check()
        assert str(e.value) == str(je.value)
    else:
        got.check()
        assert np.array_equal(valid_concat(got), single_chip(words))


def single_chip(words: np.ndarray) -> np.ndarray:
    """The stable sort of the same words by their 3 key words."""
    return words[np.lexsort((words[:, 2], words[:, 1], words[:, 0]))]


@pytest.mark.parametrize("mode,multiround", [
    ("auto", "never"), ("flat", "always"), ("hierarchical", "always"),
    ("coded", "always"), ("coded", "auto")])
def test_pod_mesh_exchange_modes_match(mode, multiround):
    jm, tm = pod_meshes()
    words = records(5, skew=multiround == "auto")
    spl = J.uniform_splitters(P)
    want = J.distributed_sort_step(words, spl, jm, POD, 40, 3,
                                   payload_path="carry",
                                   multiround=multiround,
                                   exchange_mode=mode)
    got = T.distributed_sort_step(words, spl, tm, POD, 40, 3,
                                  payload_path="keys8",
                                  multiround=multiround,
                                  exchange_mode=mode)
    assert_same(got, want)
    assert {k: v for k, v in metrics.snapshot().items()
            if k.startswith("exchange.")} == \
        {k: v for k, v in jmetrics.snapshot().items()
         if k.startswith("exchange.")}


def test_distributed_terasort_matches(tmesh, jmesh):
    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, (P * 128, 26), dtype=np.uint32)
    words[:, 2] &= np.uint32(0xFFFF0000)
    want = jterasort.distributed_terasort(words, jmesh)
    got = tterasort.distributed_terasort(words, tmesh)
    assert_same(got, want)
    got.check()
    assert np.array_equal(valid_concat(got), single_chip(words))
    for k in range(P):
        assert got.words[k].device == torch.device("cpu")
        tterasort.validate_sorted(got.valid_rows(k))


def test_keys8f_on_terasort_is_refused_as_the_reference(tmesh, jmesh):
    """TeraSort's 3 key words plus the invalid flag do not fit the folded
    4-row slot: both packages raise the same ValueError."""
    words = records(7)
    spl = J.uniform_splitters(P)
    with pytest.raises(ValueError) as want:
        J.distributed_sort_step(words, spl, jmesh, AXIS, 200, 3,
                                payload_path="keys8f")
    with pytest.raises(ValueError) as got:
        T.distributed_sort_step(words, spl, tmesh, AXIS, 200, 3,
                                payload_path="keys8f")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="8-row keys view"):
        T.distributed_sort_step(records(7, width=9), spl, tmesh, AXIS, 200,
                                7, payload_path="keys8")
    with pytest.raises(ValueError, match="32-row lanes layout"):
        T.distributed_sort_step(records(7, width=28), spl, tmesh, AXIS,
                                200, 3, payload_path="lanes")


@pytest.mark.parametrize("num_keys", [2, 3])
@pytest.mark.parametrize("multiround", ["never", "always"])
def test_the_mesh_asks_with_its_key_rows(tmesh, monkeypatch, num_keys,
                                         multiround):
    """Both local-sort entries ask the route for ``num_keys + 1`` key rows
    (the keys and the invalid flag)."""
    from uda_tpu_torch.ops import sort as tsort
    from uda_tpu_torch.parallel import distributed as D

    asked = []

    def recording(n_rows, path="auto", lanes_ok=False, device=None,
                  key_rows=None):
        asked.append(key_rows)
        return tsort.route_engine(n_rows, path, lanes_ok, device, key_rows)

    monkeypatch.setattr(D, "route_engine", recording)
    T.distributed_sort_step(records(11), T.uniform_splitters(P), tmesh,
                            AXIS, 400, num_keys, multiround=multiround)
    assert asked and set(asked) == {num_keys + 1}


def test_a_deployed_keys8f_fits_terasort_on_the_mesh(tmesh, monkeypatch):
    """A deployed keys8f reaches TeraSort's 3 keys and the flag as keys8
    (the rows do not fit the slim layout), not as the refusal above; the
    same bytes as the single-chip stable sort."""
    from uda_tpu_torch.ops import sort as tsort

    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "keys8f")
    words = records(12)
    got = T.distributed_sort_step(words, T.uniform_splitters(P), tmesh,
                                  AXIS, 400, 3)
    got.check()
    assert np.array_equal(valid_concat(got), single_chip(words))


def test_unknown_multiround_policy_raises(tmesh):
    with pytest.raises(ValueError, match="unknown multiround policy"):
        T.distributed_sort_step(records(8), T.uniform_splitters(P), tmesh,
                                AXIS, 8, 3, multiround="sometimes")


@pytest.mark.parametrize("p", [1, 2, 3, 8, 64])
def test_splitters_match(p):
    assert np.array_equal(T.uniform_splitters(p), J.uniform_splitters(p))
    sample = np.random.default_rng(p).integers(0, 2**32, 1000,
                                               dtype=np.uint32)
    assert np.array_equal(T.sample_splitters(sample, p),
                          J.sample_splitters(sample, p))
    assert np.array_equal(T.sample_splitters(np.zeros(0, np.uint32), p),
                          J.sample_splitters(np.zeros(0, np.uint32), p))


def test_sampled_splitters_on_skewed_keys(tmesh, jmesh):
    words = records(9, skew=True)
    spl = J.sample_splitters(words[::3, 0], P)
    want = J.distributed_sort_step(words, spl, jmesh, AXIS, 400, 3,
                                   payload_path="carry")
    got = T.distributed_sort_step(words, spl, tmesh, AXIS, 400, 3)
    assert_same(got, want)


def test_auto_resolves_to_carry_on_cpu_slots(tmesh):
    """"auto" on CPU slots is the CPU default (``carry``), as the
    reference's CPU meshes; per-slot lists pass through as the global
    array's blocks."""
    from uda_tpu_torch.ops.sort import route_engine

    assert route_engine(1 << 27, "auto", lanes_ok=True,
                        device=tmesh.devices[0]) == "carry"
    words = records(10)
    blocks = [torch.from_numpy(b.view(np.int32)).view(torch.uint32)
              for b in np.split(words, P)]
    a = T.distributed_sort_step(blocks, T.uniform_splitters(P), tmesh, AXIS,
                                200, 3)
    b = T.distributed_sort_step(words, T.uniform_splitters(P), tmesh, AXIS,
                                200, 3)
    assert np.array_equal(allgather(tmesh, a.words),
                          allgather(tmesh, b.words))
    assert words_to_numpy(a.valid_rows(0)).shape[1] == 5
