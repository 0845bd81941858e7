"""The port's single-chip TeraSort (uda_tpu_torch.models.terasort) against
the JAX package on the same numpy records, byte for byte, on the CPU;
engine routing per device; the validity gate."""

import jax
import numpy as np
import pytest
import torch

from port_helpers import paired_gauges_settle, records  # noqa: F401
from uda_tpu.models import terasort as jts
from uda_tpu_torch import interop
from uda_tpu_torch.device import generator
from uda_tpu_torch.models import terasort as tts
from uda_tpu_torch.ops import pallas_sort as tps
from uda_tpu_torch.ops import sort as tsort
from uda_tpu_torch.utils import tuncache

ENGINES = tsort.ALL_SORT_PATHS + ("auto",)


@pytest.fixture(scope="module")
def recs_and_reference():
    w = records(5, 1000)
    return w, np.asarray(jts.single_chip_sort(w, path="carry"))


@pytest.mark.parametrize("path", ENGINES)
def test_single_chip_sort_matches_jax(path, recs_and_reference):
    w, want = recs_and_reference
    got = tts.single_chip_sort(w, path=path, tile=128, device="cpu")
    assert got.dtype == torch.uint32 and got.shape == (1000, 26)
    np.testing.assert_array_equal(interop.words_to_numpy(got), want)


@pytest.mark.parametrize("n,tile", [(1, 1024), (129, 128), (4096, 1024)])
def test_lanes_engines_pad_and_truncate(n, tile):
    """Non-power-of-two and tiny n pad with all-0xFFFFFFFF-key columns;
    real all-max keys still come first and the padding is cut off."""
    w = records(n, n)
    want = w[np.lexsort([w[:, 2], w[:, 1], w[:, 0]])]
    for path in tsort.LANES_ENGINES:
        got = tts.single_chip_sort(torch.from_numpy(w), path=path, tile=tile,
                                   device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_empty_input_matches_jax():
    w = np.zeros((0, 26), np.uint32)
    for path in ENGINES:
        got = tts.single_chip_sort(w, path=path, device="cpu")
        assert got.shape == (0, 26) and got.dtype == torch.uint32
    assert np.asarray(jts.single_chip_sort(w, path="keys8")).shape == (0, 26)


def test_jax_teragen_records_round_trip_and_sort():
    """Records made by the reference's teragen cross as uint32 numpy, bit
    for bit, and the port sorts them as the reference does."""
    w = np.asarray(jax.device_get(jts.teragen(jax.random.PRNGKey(3), 777)))
    t = interop.words_from_numpy(w, device="cpu")
    np.testing.assert_array_equal(interop.words_to_numpy(t), w)
    np.testing.assert_array_equal(
        tts.single_chip_sort(t, path="keys8", tile=128, device="cpu").numpy(),
        np.asarray(jts.single_chip_sort(w, path="carry")))
    with pytest.raises(TypeError, match="uint32"):
        interop.words_from_numpy(w.astype(np.int64), device="cpu")


def test_teragen_shapes_and_pad_rules():
    gen = generator(0, "cpu")
    w = tts.teragen(gen, 5000).numpy()
    assert w.shape == (5000, tts.RECORD_WORDS) and w.dtype == np.uint32
    assert not (w[:, 2] & 0xFFFF).any() and (w[:, 2] >> 16).any()
    assert (w[:, 0] >= 2**31).any()  # full 32-bit words
    x = tts.teragen_lanes(gen, 5000).numpy()
    assert x.shape == (tps.ROWS, 5000)
    assert not (x[2] & 0xFFFF).any() and not x[tts.RECORD_WORDS:].any()
    assert not np.array_equal(x[:tts.RECORD_WORDS].T, w)
    w2 = tts.teragen(generator(0, "cpu"), 5000).numpy()
    np.testing.assert_array_equal(w, w2)  # a seeded generator repeats


@pytest.mark.parametrize("folded", [False, True])
def test_sort_lanes_keys8_equals_sort_lanes(folded):
    x = tts.teragen_lanes(generator(1, "cpu"), 2048)
    x[:3, ::7] = x[:3, 5:6]   # duplicated keys
    want = tps.sort_lanes(x, num_keys=tts.KEY_WORDS, tile=256)
    got = tts.sort_lanes_keys8(x, tile=256, folded=folded)
    assert torch.equal(got, want)


def test_checksum_matches_jax():
    w = records(9, 3000)
    cols_t = list(torch.from_numpy(w).T)
    cols_j = tuple(jax.numpy.asarray(w[:, c]) for c in range(26))
    assert int(tts._checksum_cols(cols_t)) == int(jts._checksum_cols(cols_j))
    big = np.full((2, 26), 0xFFFFFFFF, np.uint32)   # wrap-around
    assert (int(tts._checksum_cols(list(torch.from_numpy(big).T)))
            == int(jts._checksum_cols(tuple(big[:, c] for c in range(26)))))


@pytest.mark.parametrize("path", tsort.ALL_SORT_PATHS)
def test_bench_step_validates(path):
    viol, ck_in, ck_out = tts.bench_step(4, 1000, 2, path=path, tile=128,
                                         chunk_cols=5, device="cpu")
    assert int(viol) == 0 and int(ck_in) == int(ck_out) != 0


def test_bench_step_counts_what_it_sorts():
    viol, ck_in, _ = tts.bench_step(4, 600, 1, path="carry", device="cpu")
    w = tts.teragen(generator(4, "cpu"), 600)
    assert int(ck_in) == int(tts._checksum_cols(list(w.T)))
    with pytest.raises(ValueError, match="unknown bench path"):
        tts.bench_step(4, 600, 1, path="auto", device="cpu")


def test_validate_sorted_catches_faults():
    w = records(2, 500)
    good = tts.single_chip_sort(w, path="carry", device="cpu")
    tts.validate_sorted(good, torch.from_numpy(w))
    swapped = good.numpy().copy()
    swapped[[0, -1]] = swapped[[-1, 0]]   # first and last keys differ
    with pytest.raises(AssertionError, match="order violations"):
        tts.validate_sorted(torch.from_numpy(swapped))
    bad = good.numpy().copy()
    bad[7, 20] ^= 1                       # a corrupted payload word
    with pytest.raises(AssertionError, match="multiset"):
        tts.validate_sorted(torch.from_numpy(bad), torch.from_numpy(w))
    colswap = good.numpy().copy()
    colswap[:, [5, 6]] = colswap[:, [6, 5]]   # columns swapped
    with pytest.raises(AssertionError, match="multiset"):
        tts.validate_sorted(torch.from_numpy(colswap), torch.from_numpy(w))
    tts.validate_sorted(good[:300], valid_count=300)
    # the reference's gate agrees on the same words
    with pytest.raises(AssertionError, match="multiset"):
        jts.validate_sorted(bad, w)


def test_auto_resolves_per_device(monkeypatch):
    """A cold tune cache: "auto" is carry on the CPU at any size, keys8f
    (gather for a lanes-incapable caller) on the card from
    SMALL_BATCH_ROWS up, and carrychunk on the card below it."""
    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "")
    monkeypatch.setattr(tuncache, "tune_cache", tuncache.TuneCache(""))
    big = tsort.SMALL_BATCH_ROWS
    for n in (10, big):
        assert tsort.route_engine(n, "auto", lanes_ok=True,
                                  device="cpu") == "carry"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tsort.route_engine(big, "auto", lanes_ok=True, device="cuda") \
        == "keys8f"
    assert tsort.route_engine(big, "auto", device="cuda") == "gather"
    assert tsort.route_engine(10, "auto", lanes_ok=True, device="cuda") \
        == "carrychunk"
    assert tsort.route_engine(10, "auto", device="cuda") == "carrychunk"
    assert tsort.route_engine(10, "lanes", lanes_ok=True,
                              device="cuda") == "lanes"
    with pytest.raises(ValueError, match="unknown sort path"):
        tsort.route_engine(10, "keys8", device="cpu")
    with pytest.raises(ValueError, match="unknown sort path"):
        tsort.route_engine(10, "sideways", lanes_ok=True, device="cpu")


@pytest.mark.parametrize("path", ["auto", "carry"])
def test_single_chip_sort_asks_with_its_key_rows(monkeypatch, path):
    """The route is asked for TeraSort's 3 key words, so "auto" on the
    card takes the slim cascade (keys8f)."""
    asked = []

    def recording(n_rows, path="auto", lanes_ok=False, device=None,
                  key_rows=None):
        asked.append((path, lanes_ok, key_rows))
        return tsort.route_engine(n_rows, path, lanes_ok, device, key_rows)

    monkeypatch.setattr(tts, "route_engine", recording)
    w = records(4, 300)
    got = tts.single_chip_sort(w, path=path, tile=128, device="cpu")
    assert asked == [(path, True, tts.KEY_WORDS)] and tts.KEY_WORDS == 3
    np.testing.assert_array_equal(
        interop.words_to_numpy(got), np.asarray(
            jts.single_chip_sort(w, path="carry")))


def test_deployed_sort_path_precedence(monkeypatch):
    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "keys8f")
    assert tsort.resolve_sort_path("auto", lanes_ok=True,
                                   device="cpu") == "keys8f"
    # a lanes engine deployed to a lanes-incapable caller: the default
    assert tsort.resolve_sort_path("auto", device="cpu") == "carry"
    # an explicit path wins over the deployed one
    assert tsort.resolve_sort_path("gather2", lanes_ok=True,
                                   device="cpu") == "gather2"
    w = records(3, 300)
    got = tts.single_chip_sort(w, tile=128, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), w[np.lexsort([w[:, 2], w[:, 1], w[:, 0]])])
    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "sideways")
    with pytest.raises(ValueError, match="UDA_TPU_SORT_PATH"):
        tsort.resolve_sort_path("auto", lanes_ok=True, device="cpu")


def test_apply_perm_chunked_semantics():
    rng = np.random.default_rng(8)
    cols = [torch.from_numpy(rng.integers(0, 2**32, 50, dtype=np.uint32))
            for _ in range(7)]
    perm = torch.from_numpy(rng.permutation(50))
    for cc in (1, 3, 6, 7, 23):
        out = tsort.apply_perm_chunked(perm, cols, chunk_cols=cc)
        assert len(out) == 7
        for c, o in zip(cols, out):
            assert o.dtype == torch.uint32
            np.testing.assert_array_equal(o.numpy(), c.numpy()[perm.numpy()])


def test_stable_lex_argsort_is_unsigned_and_stable():
    rng = np.random.default_rng(6)
    keys = rng.choice(np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1],
                               np.uint32), size=(3, 2000))
    want = np.lexsort(keys[::-1])
    got = tsort.stable_lex_argsort([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got.numpy(), want)

