"""The port's admission control (uda_tpu_torch.utils.budget.MemoryBudget)
and approach 0, the budget-aware router of ``MergeManager.run``, against
the JAX package's: the device-bytes model, the routing matrix (decision,
cause, reroute and reason for the same explicit budgets), the in-flight
cap's clamp to half the host budget, where the auto budgets come from
(the card's own memory by ``torch.cuda.mem_get_info``, /proc/meminfo),
and each route forced by the budget keys through ``run()`` with the same
bytes for the three key types; the hard ceiling ends in FallbackSignal
with no fetch in either package."""

import builtins
import io

import pytest
import torch

from helpers import make_mof_tree, map_ids
from test_torch_merge_manager import (BYTES, LONG, TEXT, mof_tree, port_run,
                                      reference_run, text_tree)
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.utils import budget as jbudget
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.utils import budget
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config

MB = 1 << 20
APPROACH0 = {"mapred.netmerger.merge.approach": 0}
ROOMY = {"uda.tpu.hbm.budget.mb": 64 * 1024,
         "uda.tpu.host.budget.mb": 64 * 1024}


@pytest.mark.parametrize("nbytes,width,record", [
    (0, 16, 100), (1000, 16, 10), (10 << 30, 16, 100), (123456, 4, 100),
    (1 << 20, 112, 100), (777, 2, 1)])
def test_device_bytes_model_matches_reference(nbytes, width, record):
    assert budget.device_bytes_estimate(nbytes, width, record) == \
        jbudget.device_bytes_estimate(nbytes, width, record)


# (estimate MB, hbm MB, host MB, hard MB, threshold MB, prefer streaming)
ROUTES = [
    (10, 4096, 64 * 1024, 0, 512, False),      # hybrid
    (600, 4096, 64 * 1024, 0, 512, False),     # streaming, in budget
    (1024, 512, 64 * 1024, 0, 512, False),     # over the device budget
    (4096, 512, 64 * 1024, 2048, 512, False),  # over the hard ceiling
    (None, 4096, 64 * 1024, 0, 512, False),    # unknown size
    (1024, 64 * 1024, 256, 0, 4096, False),    # over the host budget
    (10, 4096, 64 * 1024, 0, 512, True),       # checkpoint steers
    (2048, 4096, 64 * 1024, 2048, 2048, False),  # at the ceiling, admitted
    (0, 1, 1, 0, 0, False),                    # an empty partition
]


@pytest.mark.parametrize("est,hbm,host,hard,threshold,ckpt", ROUTES)
def test_routing_matrix_matches_reference(est, hbm, host, hard, threshold,
                                          ckpt):
    kw = dict(hbm_budget_mb=hbm, host_budget_mb=host, hard_ceiling_mb=hard)
    est_b = None if est is None else est * MB
    got = budget.MemoryBudget(device="cpu", **kw).route(
        est_b, threshold * MB, prefer_streaming=ckpt)
    want = jbudget.MemoryBudget(**kw).route(est_b, threshold * MB,
                                            prefer_streaming=ckpt)
    for field in ("decision", "cause", "rerouted", "rejected", "reason",
                  "device_bytes", "estimate_bytes", "hbm_budget_bytes",
                  "host_budget_bytes"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("share", [0.0, 0.25, 1.0])
def test_budgets_from_config_match_reference(share):
    conf = {"uda.tpu.hbm.budget.mb": 1000, "uda.tpu.host.budget.mb": 3000,
            "uda.tpu.budget.hard.mb": 77,
            "uda.tpu.tenant.budget.share": share}
    got = budget.MemoryBudget.from_config(Config(conf), device="cpu")
    want = jbudget.MemoryBudget.from_config(JConfig(conf))
    assert (got.hbm_budget_bytes, got.host_budget_bytes,
            got.hard_ceiling_bytes) == (want.hbm_budget_bytes,
                                        want.host_budget_bytes,
                                        want.hard_ceiling_bytes)


@pytest.mark.parametrize("window,chunk,host_mb,inflight_mb", [
    (256, 1 << 20, 0, 0), (256, 1 << 20, 300, 0), (4, 1024, 300, 0),
    (256, 1 << 20, 300, 64), (1024, 1 << 20, 64 * 1024, 0)])
def test_inflight_cap_matches_reference(window, chunk, host_mb,
                                        inflight_mb):
    """The cap clamps to half the host budget only when a budget was
    built (the auto approach); an explicit cap wins."""
    conf = {"uda.tpu.stage.inflight.mb": inflight_mb}
    got_b = want_b = None
    if host_mb:
        got_b = budget.MemoryBudget(host_budget_mb=host_mb, device="cpu")
        want_b = jbudget.MemoryBudget(host_budget_mb=host_mb)
    assert budget.stage_inflight_cap(Config(conf), window, chunk, got_b) \
        == jbudget.stage_inflight_cap(JConfig(conf), window, chunk, want_b)


def test_auto_budgets_come_from_the_device_and_the_host(monkeypatch):
    """The card's budget is its own total memory (mem_get_info) x 0.9, not
    a table of sizes; on the CPU it is the host's available memory, as in
    the reference; the host budget is /proc/meminfo's MemAvailable x
    mapred.job.shuffle.input.buffer.percent in both packages. Both
    packages read one fixed /proc/meminfo text: the live file moves
    between reads while other processes allocate."""
    meminfo = ("MemTotal:       65536000 kB\n"
               "MemFree:         1234567 kB\n"
               "MemAvailable:   12345678 kB\n")
    real_open = builtins.open

    def fixed_open(file, *args, **kwargs):
        if file == "/proc/meminfo":
            return io.StringIO(meminfo)
        return real_open(file, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", fixed_open)
    seen = []

    def mem_get_info(device=None):
        seen.append(device)
        return (3 << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    card = budget.MemoryBudget(host_budget_mb=1)
    assert card.hbm_budget_bytes == int(80 * 1024 * 0.9) * MB
    assert seen and seen[0].type == "cuda"
    host_mb = budget._host_available_mb()
    assert host_mb == jbudget._host_available_mb()
    assert host_mb == 12345678 // 1024
    cpu = budget.MemoryBudget(device="cpu")
    assert cpu.hbm_budget_bytes == int(host_mb * 0.9) * MB
    assert cpu.host_budget_bytes == int(host_mb * 0.7) * MB


def test_budget_refuses_bad_knobs_as_the_reference_does():
    for kw in ({"enforce": "panic"}, {"tenant_share": 1.5}):
        with pytest.raises(errors.UdaError) as got:
            budget.MemoryBudget(device="cpu", **kw)
        with pytest.raises(jerrors.UdaError) as want:
            jbudget.MemoryBudget(**kw)
        assert str(got.value) == str(want.value)


def test_budget_takes_the_managers_device(tmp_path, monkeypatch):
    """MemoryBudget takes the manager's device: on the CPU it never asks
    for the card."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", None)
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    try:
        mm = MergeManager(LocalFetchClient(engine), TEXT, Config(),
                          device="cpu")
        assert mm.budget().device.type == "cpu"
        assert mm.budget().hbm_budget_bytes > 0
    finally:
        engine.stop()


# the route each set of keys forces: (extra keys, decision, cause)
FORCED = {
    "hybrid": (dict(ROOMY), "hybrid", ""),
    "streaming": (dict(ROOMY, **{"uda.tpu.auto.approach.threshold.mb": 0}),
                  "streaming", ""),
    "hbm": ({"uda.tpu.hbm.budget.mb": 1,
             "uda.tpu.host.budget.mb": 64 * 1024}, "streaming", "hbm"),
    "host": ({"uda.tpu.hbm.budget.mb": 64 * 1024,
              "uda.tpu.host.budget.mb": 1,
              "uda.tpu.auto.approach.threshold.mb": 1 << 20},
             "streaming", "host"),
}


def _big_tree(root: str, java_class: str, seed: int) -> list:
    """A tree whose reduce partition 1 holds over 1 MB, so 1 MB budgets
    bind: the device model exceeds a 1 MB device budget, the partition a
    1 MB host budget."""
    if java_class == TEXT:
        return text_tree(root, "job", 4, 2000, seed)
    make_mof_tree(root, "job", 4, 2, 7200, seed=seed,
                  key_bytes=12 if java_class == BYTES else 8, val_bytes=70,
                  sort_key=((lambda kv: kv[0][4:]) if java_class == BYTES
                            else None))
    return map_ids("job", 4)


def _run_keep(root, mids, java_class, conf, port: bool):
    """One ``run()`` of either package: ((bytes emitted, stream), the
    manager, for its last_admission and overlapped merger)."""
    out = bytearray()
    if port:
        engine = DataEngine(DirIndexResolver(root), Config(conf))
        mm = MergeManager(LocalFetchClient(engine), java_class,
                          Config(conf), device="cpu")
    else:
        engine = JDataEngine(JDirIndexResolver(root), JConfig(conf))
        mm = JMergeManager(JLocalFetchClient(engine), java_class,
                           JConfig(conf))
    try:
        n = mm.run("job", mids, 1, out.extend)
    finally:
        engine.stop()
    return (n, bytes(out)), mm


@pytest.mark.parametrize("route", list(FORCED))
@pytest.mark.parametrize("java_class", [TEXT, BYTES, LONG])
def test_auto_approach_routes_match_reference(tmp_path, java_class, route):
    """Each route forced by the budget keys: the same decision and cause
    in both packages, the same bytes, and no device run where the device
    budget is what rerouted."""
    extra, decision, cause = FORCED[route]
    root = str(tmp_path / "mof")
    big = bool(cause)
    mids = (_big_tree if big else mof_tree)(root, java_class,
                                            seed=len(route))
    runs = []
    for side in ("port", "ref"):
        conf = dict(APPROACH0, **extra,
                    **{"mapred.rdma.buf.size": 64 if big else 1,
                       "uda.tpu.spill.dirs": str(tmp_path / side)})
        runs.append(_run_keep(root, mids, java_class, conf,
                              port=side == "port"))
    (got, mm), (want, jmm) = runs
    assert got[0] == want[0] == len(got[1]) > 1024
    assert got[1] == want[1]
    g, w = mm.last_admission, jmm.last_admission
    assert (g.decision, g.cause, g.rerouted) == \
        (w.decision, w.cause, w.rerouted) == \
        (decision, cause, bool(cause))
    assert g.estimate_bytes == w.estimate_bytes > 0
    if route == "hybrid":
        assert mm._active_overlap is None
        return
    om = mm._active_overlap
    assert om.device_runs == (cause != "hbm") == \
        jmm._active_overlap.device_runs
    if cause == "hbm":
        assert om.stats["device_merges"] == 0


class _Counting:
    """Mixin: counts start_fetch calls and reports a fixed estimate."""

    def __init__(self, engine, estimate):
        super().__init__(engine)
        self._estimate = estimate
        self.fetches = 0

    def estimate_partition_bytes(self, job_id, mids, reduce_id):
        return self._estimate

    def start_fetch(self, req, on_complete):
        self.fetches += 1
        super().start_fetch(req, on_complete)


class _PortCounting(_Counting, LocalFetchClient):
    pass


class _RefCounting(_Counting, JLocalFetchClient):
    pass


def test_hard_ceiling_falls_back_before_any_fetch_in_both(tmp_path):
    mids = mof_tree(str(tmp_path), TEXT, seed=8)
    conf = dict(APPROACH0, **{"uda.tpu.budget.hard.mb": 1024})
    results = []
    for cls, mm_cls, engine_cls, resolver, cfg, sig in (
            (_PortCounting, MergeManager, DataEngine, DirIndexResolver,
             Config, errors.FallbackSignal),
            (_RefCounting, JMergeManager, JDataEngine, JDirIndexResolver,
             JConfig, jerrors.FallbackSignal)):
        engine = engine_cls(resolver(str(tmp_path)), cfg(conf))
        client = cls(engine, 100 << 30)
        kw = {"device": "cpu"} if mm_cls is MergeManager else {}
        mm = mm_cls(client, TEXT, cfg(conf), **kw)
        try:
            with pytest.raises(sig) as got:
                mm.run("job", mids, 1, lambda b: None)
        finally:
            engine.stop()
        assert client.fetches == 0
        assert mm.last_admission.rejected
        assert mm.last_admission.cause == "hard"
        results.append((type(got.value.cause).__name__,
                        str(got.value.cause)))
    assert results[0] == results[1]
    assert "admission" in results[0][1]


def test_unknown_estimate_routes_to_streaming_in_both(tmp_path):
    mids = mof_tree(str(tmp_path / "mof"), LONG, seed=4)

    def port_client(engine):
        return _PortCounting(engine, None)

    def ref_client(engine):
        return _RefCounting(engine, None)

    got = port_run(str(tmp_path / "mof"), mids, LONG,
                   dict(APPROACH0, **{"uda.tpu.spill.dirs":
                                      str(tmp_path / "p")}),
                   client_of=port_client)
    want = reference_run(str(tmp_path / "mof"), mids, LONG,
                         dict(APPROACH0, **{"uda.tpu.spill.dirs":
                                            str(tmp_path / "r")}),
                         client_of=ref_client)
    assert got == want


def test_estimate_is_exact_or_unknown_as_in_the_reference(tmp_path):
    mids = mof_tree(str(tmp_path), BYTES, seed=6)
    engine = DataEngine(DirIndexResolver(str(tmp_path)), Config())
    jengine = JDataEngine(JDirIndexResolver(str(tmp_path)), JConfig())
    try:
        got = LocalFetchClient(engine)
        want = JLocalFetchClient(jengine)
        for ids in (mids, mids[:1], mids + ["no_such_map"]):
            assert got.estimate_partition_bytes("job", ids, 1) == \
                want.estimate_partition_bytes("job", ids, 1)
        assert got.estimate_partition_bytes("job", mids, 1) > 0
        assert got.estimate_partition_bytes(
            "job", mids + ["no_such_map"], 1) is None
    finally:
        engine.stop()
        jengine.stop()
