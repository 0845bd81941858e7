"""The port's tune cache (uda_tpu_torch.utils.tuncache) and the cache
consult and small-batch steering of its ``ops.sort.route_engine``, against
the JAX package's: the same JSON schema both ways (a file written by
either package routes the other), env over cache over built-in, a cold
cache routing exactly as the built-in defaults, corrupt or version-bumped
files ignored and counted, winners a caller cannot run ignored, and on the
card (the accelerator's role) gather-bound winners below 2^20 rows steered
to ``carrychunk``."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.ops import sort as jsort
from uda_tpu.utils import tuncache as jtuncache
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch.ops import sort as tsort
from uda_tpu_torch.utils import tuncache
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.tuncache import TuneCache, rows_bucket

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_metrics():
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture()
def cache_at(tmp_path, monkeypatch):
    """A fresh cache file wired in as the process default of both
    packages (what each route_engine consults), with no deployed
    engine."""
    path = str(tmp_path / "tune.json")
    cache = TuneCache(path)
    monkeypatch.setattr(tuncache, "tune_cache", cache)
    monkeypatch.setattr(jtuncache, "tune_cache", jtuncache.TuneCache(path))
    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "")
    monkeypatch.setattr(jsort, "DEPLOYED_SORT_PATH", "")
    return cache


def _key(n_rows, lanes_ok=False, backend="cpu"):
    return f"{backend}|rows{rows_bucket(n_rows)}|lanes{int(lanes_ok)}"


def _on_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


# -- record/lookup round trip -------------------------------------------------

def test_record_lookup_round_trip(cache_at):
    cache_at.record("sort.engine", "cpu|rows16|lanes0",
                    {"engine": "gather"}, metric=1.25, probe="t")
    rec = cache_at.lookup("sort.engine", "cpu|rows16|lanes0")
    assert rec["winner"] == {"engine": "gather"}
    assert rec["metric"] == 1.25 and rec["probe"] == "t"
    assert cache_at.age_s("sort.engine", "cpu|rows16|lanes0") < 60
    assert cache_at.lookup("sort.engine", "nope") is None
    assert cache_at.age_s("sort.engine", "nope") is None
    assert metrics.get("tune.cache.hits", domain="sort.engine") == 1
    assert metrics.get("tune.cache.misses", domain="sort.engine") == 1
    assert metrics.get("tune.cache.writes") == 1


def test_second_instance_reads_persisted_winner(cache_at):
    cache_at.record("io.read", "linux", {"batch": "on", "gap_kb": 64})
    assert TuneCache(cache_at.path).lookup(
        "io.read", "linux")["winner"]["gap_kb"] == 64


def test_concurrent_domains_merge_not_clobber(cache_at):
    cache_at.record("sort.engine", "k1", {"engine": "carry"})
    TuneCache(cache_at.path).record("io.read", "k2", {"batch": "on"})
    assert cache_at.lookup("sort.engine", "k1") is not None
    assert cache_at.lookup("io.read", "k2") is not None


def test_in_memory_cache_misses_until_recorded():
    cache = TuneCache("")
    assert cache.lookup("sort.engine", "k") is None
    cache.record("sort.engine", "k", {"engine": "carry"})
    assert cache.lookup("sort.engine", "k")["winner"] == {"engine": "carry"}
    assert metrics.get("tune.cache.writes") == 0   # nothing persisted


# -- the file is shared with the reference ------------------------------------

def test_each_package_reads_the_others_file(tmp_path):
    mine, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    TuneCache(mine).record("sort.engine", "gpu|rows27|lanes1",
                           {"engine": "keys8f"}, metric=55.5, probe="p")
    jtuncache.TuneCache(ref).record("sort.engine", "gpu|rows27|lanes1",
                                    {"engine": "keys8f"}, metric=55.5,
                                    probe="p")
    for a, b in ((mine, ref), (ref, mine)):
        got = TuneCache(a).lookup("sort.engine", "gpu|rows27|lanes1")
        want = jtuncache.TuneCache(b).lookup("sort.engine",
                                             "gpu|rows27|lanes1")
        got.pop("probed_unix")
        want.pop("probed_unix")
        assert got == want
    with open(mine) as f:
        doc = json.load(f)
    assert doc["schema"] == tuncache.SCHEMA_VERSION == \
        jtuncache.SCHEMA_VERSION


@pytest.mark.parametrize("n", [1, 1 << 10, 1 << 16, 1 << 20, 10**8])
@pytest.mark.parametrize("engine", ["gather2", "carrychunk", "keys8f",
                                    "lanes", "made-up"])
def test_a_reference_cache_routes_the_port_the_same(cache_at, n, engine):
    """A cache written by the reference's TuneCache, read by both
    route_engines on the CPU: the same engine for every size class, for
    lanes-capable callers and others."""
    for lanes_ok in (False, True):
        jtuncache.tune_cache.record("sort.engine", _key(n, lanes_ok),
                                    {"engine": engine})
    assert rows_bucket(n) == jtuncache.rows_bucket(n)
    for lanes_ok in (False, True):
        want = jsort.route_engine(n, "auto", lanes_ok)
        assert tsort.route_engine(n, "auto", lanes_ok, device="cpu") == want


# -- invalid files: ignored, counted, never fatal -----------------------------

@pytest.mark.parametrize("content", [
    "{ not json at all",
    json.dumps({"schema": 999, "entries": {}}),
    json.dumps({"schema": 1, "entries": "not-a-dict"}),
    "",
])
def test_invalid_cache_ignored_and_counted(cache_at, content):
    with open(cache_at.path, "w") as f:
        f.write(content)
    assert cache_at.lookup("sort.engine", "anything") is None
    assert metrics.get("tune.cache.invalid") >= 1
    assert tsort.route_engine(1 << 16, "auto", device="cpu") == \
        tsort.resolve_sort_path("auto", device="cpu")


def test_invalid_entries_filtered_not_fatal(cache_at):
    with open(cache_at.path, "w") as f:
        json.dump({"schema": 1, "entries": {
            "sort.engine|good": {"winner": {"engine": "gather"}},
            "sort.engine|bad": "not-a-record",
        }}, f)
    assert cache_at.lookup("sort.engine", "good") is not None
    assert cache_at.lookup("sort.engine", "bad") is None


def test_an_unwritable_cache_is_counted_not_fatal(tmp_path):
    """A winner that cannot be persisted costs the route, never the
    caller: counted, and (the file being the table) not served after, as
    in the reference."""
    path = str(tmp_path / "missing-dir" / "tune.json")
    cache, jcache = TuneCache(path), jtuncache.TuneCache(path)
    cache.record("sort.engine", "k", {"engine": "carry"})
    jcache.record("sort.engine", "k", {"engine": "carry"})
    assert metrics.get("errors.swallowed") == 1
    assert cache.lookup("sort.engine", "k") is None
    assert jcache.lookup("sort.engine", "k") is None


# -- route_engine ---------------------------------------------------------------

def test_cold_cache_routes_exactly_the_built_in_defaults(cache_at,
                                                         monkeypatch):
    for n in (1, 1 << 10, 1 << 16, 1 << 20, 1 << 22):
        for lanes_ok in (False, True):
            assert tsort.route_engine(n, "auto", lanes_ok, device="cpu") \
                == tsort.resolve_sort_path("auto", lanes_ok, device="cpu")
    assert tsort.route_engine(1 << 16, "gather", device="cpu") == "gather"
    _on_a_card(monkeypatch)
    for n in (1 << 20, 1 << 22, 10**8):
        assert tsort.route_engine(n, "auto", True, device="cuda") == "keys8f"
        assert tsort.route_engine(n, "auto", device="cuda") == "gather"


def test_route_engine_consults_cached_winner(cache_at):
    n = 1 << 16
    cache_at.record("sort.engine", _key(n), {"engine": "gather2"})
    assert tsort.route_engine(n, "auto", device="cpu") == "gather2"
    assert metrics.get("tune.cache.hits", domain="sort.engine") >= 1
    # another size class misses -> the built-in default
    assert tsort.route_engine(1 << 22, "auto", device="cpu") == \
        tsort.resolve_sort_path("auto", device="cpu")


def test_env_winner_beats_cache(cache_at, monkeypatch):
    n = 1 << 16
    cache_at.record("sort.engine", _key(n), {"engine": "gather2"})
    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "carrychunk")
    assert tsort.route_engine(n, "auto", device="cpu") == "carrychunk"


def test_invalid_cached_engine_ignored(cache_at):
    n = 1 << 16
    cache_at.record("sort.engine", _key(n), {"engine": "totally-made-up"})
    assert tsort.route_engine(n, "auto", device="cpu") == \
        tsort.resolve_sort_path("auto", device="cpu")
    # a lanes winner under a lanes-incapable key never reaches that caller
    cache_at.record("sort.engine", _key(n), {"engine": "lanes"})
    assert tsort.route_engine(n, "auto", lanes_ok=False, device="cpu") == \
        tsort.resolve_sort_path("auto", lanes_ok=False, device="cpu")


def test_the_card_reads_gpu_keys(cache_at, monkeypatch):
    """The cache key names the card ``gpu``, as JAX names it: the 10^8-row
    bucket's winner routes "auto" on the card and nowhere else."""
    _on_a_card(monkeypatch)
    n = 100_000_000
    assert tsort.cache_backend("cuda") == "gpu"
    assert tsort.cache_backend("cpu") == "cpu"
    cache_at.record("sort.engine", "gpu|rows27|lanes1",
                    {"engine": "keys8f"})
    assert _key(n, True, "gpu") == "gpu|rows27|lanes1"
    assert tsort.route_engine(n, "auto", True, device="cuda") == "keys8f"
    assert tsort.route_engine(n, "auto", True, device="cpu") == "carry"
    assert tsort.route_engine(n, "keys8", True, device="cuda") == "keys8"


@pytest.mark.parametrize("cached", [None, "keys8", "keys8f", "gather2",
                                    "carry", "lanes"])
def test_small_batches_are_steered_on_the_card(cache_at, monkeypatch,
                                               cached):
    """Below SMALL_BATCH_ROWS a gather-bound engine, built-in or cached,
    becomes carrychunk on the card; other winners stand; the CPU is never
    steered; from SMALL_BATCH_ROWS up nothing is."""
    _on_a_card(monkeypatch)
    small, big = 1 << 16, tsort.SMALL_BATCH_ROWS
    assert tsort.SMALL_BATCH_ROWS == jsort.SMALL_BATCH_ROWS
    assert tsort.GATHER_BOUND_ENGINES == jsort.GATHER_BOUND_ENGINES
    if cached is not None:
        for n in (small, big):
            cache_at.record("sort.engine", _key(n, True, "gpu"),
                            {"engine": cached})
    got = tsort.route_engine(small, "auto", True, device="cuda")
    base = cached or "keys8f"
    assert got == ("carrychunk" if base in tsort.GATHER_BOUND_ENGINES
                   else base)
    assert tsort.route_engine(big, "auto", True, device="cuda") == base
    assert tsort.route_engine(small, "auto", True, device="cpu") == "carry"
    # an explicit path is never steered
    assert tsort.route_engine(small, "keys8", True, device="cuda") == "keys8"


def test_a_deployed_engine_is_steered_too(cache_at, monkeypatch):
    _on_a_card(monkeypatch)
    monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "keys8f")
    assert tsort.route_engine(1 << 16, "auto", True, device="cuda") == \
        "carrychunk"
    assert tsort.route_engine(1 << 20, "auto", True, device="cuda") == \
        "keys8f"


# -- the key-row rule: the slim cascade where the caller's keys fit it -------

BIG = 100_000_000


@pytest.mark.parametrize("key_rows,want", [
    (None, "keys8f"), (1, "keys8f"), (2, "keys8f"), (3, "keys8f"),
    (4, "keys8"), (7, "keys8")])
def test_the_built_in_fits_the_key_rows(cache_at, monkeypatch, key_rows,
                                        want):
    """A cold cache on the card: keys8f (K3/K4 on 4 rows) where the
    caller's key rows fit its 3, keys8 (K2/K1 on 8 rows) where they do
    not; None asks for no adaptation."""
    _on_a_card(monkeypatch)
    assert tsort.resolve_sort_path("auto", True, device="cuda",
                                   key_rows=key_rows) == want
    for n in (tsort.SMALL_BATCH_ROWS, BIG):
        assert tsort.route_engine(n, "auto", True, device="cuda",
                                  key_rows=key_rows) == want


@pytest.mark.parametrize("key_rows", [None, 3, 4, 7])
def test_key_rows_move_no_other_route(cache_at, monkeypatch, key_rows):
    """The rule touches the cascade alone: a lanes-incapable caller gets
    gather on the card, a batch below 2^20 rows carrychunk, the CPU
    carry, whatever the key rows."""
    assert tsort.route_engine(BIG, "auto", True, device="cpu",
                              key_rows=key_rows) == "carry"
    _on_a_card(monkeypatch)
    assert tsort.route_engine(BIG, "auto", device="cuda",
                              key_rows=key_rows) == "gather"
    for lanes_ok in (False, True):
        assert tsort.route_engine(1 << 16, "auto", lanes_ok, device="cuda",
                                  key_rows=key_rows) == "carrychunk"


@pytest.mark.parametrize("source", ["deployed", "cached"])
@pytest.mark.parametrize("key_rows,want", [(3, "keys8f"), (4, "keys8")])
def test_a_chosen_keys8f_fits_the_key_rows(cache_at, monkeypatch, source,
                                           key_rows, want):
    """A deployed or cached keys8f winner becomes keys8 for a caller whose
    key rows the slim layout cannot hold, and stands for one whose rows
    it can."""
    _on_a_card(monkeypatch)
    if source == "deployed":
        monkeypatch.setattr(tsort, "DEPLOYED_SORT_PATH", "keys8f")
    else:
        cache_at.record("sort.engine", _key(BIG, True, "gpu"),
                        {"engine": "keys8f"})
    assert tsort.route_engine(BIG, "auto", True, device="cuda",
                              key_rows=key_rows) == want
    assert tsort.route_engine(BIG, "auto", True, device="cuda") == "keys8f"


@pytest.mark.parametrize("key_rows", [None, 3, 4, 7])
@pytest.mark.parametrize("path", ["keys8f", "keys8"])
def test_an_explicit_cascade_is_honoured(cache_at, monkeypatch, path,
                                         key_rows):
    _on_a_card(monkeypatch)
    assert tsort.route_engine(BIG, path, True, device="cuda",
                              key_rows=key_rows) == path
    assert tsort.resolve_sort_path(path, True, device="cuda",
                                   key_rows=key_rows) == path


def test_set_default_cache_and_the_env_channel(tmp_path, monkeypatch):
    monkeypatch.setattr(tuncache, "tune_cache", TuneCache(""))
    monkeypatch.delenv("UDA_TPU_TUNE_CACHE", raising=False)
    other = str(tmp_path / "other.json")
    assert tuncache.set_default_cache(other).path == other
    assert tuncache.tune_cache.path == other
    same = tuncache.tune_cache
    assert tuncache.set_default_cache(other) is same
    monkeypatch.setenv("UDA_TPU_TUNE_CACHE", str(tmp_path / "env.json"))
    assert tuncache.cache_path_from_env() == str(tmp_path / "env.json")
    assert tuncache.set_default_cache(str(tmp_path / "third.json")) is same


def test_fresh_process_routes_from_cache_without_probe(cache_at):
    """A persisted winner is consulted by route_engine in a fresh
    interpreter that imports only the port: a cache hit, no probe."""
    n = 1 << 16
    cache_at.record("sort.engine", _key(n), {"engine": "gather2"},
                    metric=9.9, probe="lifecycle-test")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['uda_tpu'] = None\n"
        "from uda_tpu_torch.ops import sort as sort_ops\n"
        "from uda_tpu_torch.utils.metrics import metrics\n"
        f"print('ENGINE', sort_ops.route_engine({n}, 'auto', "
        "device='cpu'))\n"
        "print('PROBES', int(metrics.get('tune.reprobes')))\n"
        "print('HITS', int(metrics.get('tune.cache.hits')))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "UDA_TPU_SORT_PATH")}
    env["UDA_TPU_TUNE_CACHE"] = cache_at.path
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ENGINE gather2" in out.stdout
    assert "PROBES 0" in out.stdout and "HITS 1" in out.stdout


# -- background re-probe rung -------------------------------------------------

def test_ensure_fresh_reprobes_a_stale_entry(cache_at, monkeypatch):
    calls = []
    called = threading.Event()

    def probe(key):
        calls.append(key)
        called.set()

    monkeypatch.setitem(tuncache._PROBES, "sort.engine", probe)
    cache_at.record("sort.engine", "k", {"engine": "carry"})
    tuncache.ensure_fresh(cache_at, "sort.engine", "k", 3600.0)  # fresh
    tuncache.ensure_fresh(cache_at, "sort.engine", "absent", 0.001)
    assert not calls
    with open(cache_at.path) as f:
        doc = json.load(f)
    doc["entries"]["sort.engine|k"]["probed_unix"] = time.time() - 999
    with open(cache_at.path, "w") as f:
        json.dump(doc, f)
    tuncache.ensure_fresh(cache_at, "sort.engine", "k", 1.0)
    assert called.wait(10.0)
    assert calls == ["k"]
    deadline = time.monotonic() + 10.0
    while tuncache._REPROBE_ACTIVE and time.monotonic() < deadline:
        time.sleep(0.01)
    assert metrics.get("tune.reprobes") == 1
    calls.clear()
    tuncache.ensure_fresh(cache_at, "sort.engine", "k", 0.0)  # disabled
    assert not calls
    assert jmetrics.get("tune.reprobes") == 0   # the port's counters only
