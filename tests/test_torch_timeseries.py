"""The port's live telemetry plane (``utils/timeseries``, ``utils/anomaly``,
``tenant/sli``, ``utils/openmetrics``) against the JAX package's: the same
seeded hub deltas give the same rollups (timestamps aside), the anomaly
detectors and the SLI book fed the same rollups fire and report the same,
``arm_observability_plane`` wires ring, detectors, SLI book and the HTTP
exposition from one config, and a live scrape reads the hub."""

import json
import urllib.request

import numpy as np
import pytest

from port_helpers import paired_gauges_settle, port_plane  # noqa: F401
from uda_tpu.tenant import sli as jsli
from uda_tpu.utils import anomaly as janomaly
from uda_tpu.utils import metrics as jmetrics_mod
from uda_tpu.utils import timeseries as jts
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils.metrics import metrics as jmetrics
from uda_tpu_torch.tenant import sli as tsli
from uda_tpu_torch.utils import anomaly as tanomaly
from uda_tpu_torch.utils import metrics as tmetrics_mod
from uda_tpu_torch.utils import timeseries as tts
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import metrics

PKGS = ((jmetrics_mod, jts, janomaly, jsli, JConfig),
        (tmetrics_mod, tts, tanomaly, tsli, Config))


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _feed(m, rng_seed: int, step: int) -> None:
    """One interval's seeded traffic on hub ``m``: labelled counters,
    gauges and latency samples (the same draws for both packages)."""
    rng = np.random.default_rng(rng_seed * 1000 + step)
    for sup in ("h0", "h1"):
        m.add("fetch.bytes", float(rng.integers(1, 1 << 20)), supplier=sup,
              tenant="tA" if sup == "h0" else "tB")
        m.add("fetch.chunks", 1.0, supplier=sup)
        for _ in range(int(rng.integers(0, 6))):
            m.observe("fetch.latency_ms", float(rng.gamma(2.0, 3.0)),
                      supplier=sup, tenant="tA" if sup == "h0" else "tB")
    m.add("supplier.bytes", float(rng.integers(0, 1 << 18)), tenant="tA")
    m.gauge("fetch.on_air", float(rng.integers(0, 9)))
    m.gauge_add("stage.inflight.bytes", float(rng.integers(-2, 3)))
    if step % 3 == 0:
        m.add("fetch.retries", 1.0)


def _strip(roll):
    return {k: v for k, v in roll.items() if k != "ts"}


@pytest.mark.parametrize("seed", range(5))
def test_same_deltas_same_rollups(seed):
    out = []
    for mmod, tsmod, _, _, _ in PKGS:
        m = mmod.Metrics(stats=True)
        clock = FakeClock()
        ts = tsmod.TimeSeries(m, interval_s=1.0, window=8, clock=clock)
        rolls = [ts.sample()]  # the self-baselined first sample
        for step in range(12):
            _feed(m, seed, step)
            clock.t += 0.5 + step * 0.25
            rolls.append(ts.sample())
        out.append({
            "rolls": [_strip(r) for r in rolls],
            "window": [_strip(r) for r in ts.window(seconds=4.0)],
            "rate": ts.counter_rate_series("fetch.bytes"),
            "gauge": ts.gauge_series("fetch.on_air", count=5),
            "p99": ts.percentile_series("fetch.latency_ms"),
            "summary": {k: v for k, v in ts.summary().items()
                        if k != "last_ts"},
            "wire": [_strip(r) for r in ts.wire_block(3.0)["rollups"]]})
    assert out[0] == out[1]
    assert len(out[1]["rolls"]) == 13 and out[1]["summary"]["samples"] == 8


def _roll(seq, counters=None, percentiles=None, gauges=None, dt=1.0):
    return {"seq": seq, "ts": 0.0, "dt": dt,
            "counters": counters or {}, "gauges": gauges or {},
            "percentiles": percentiles or {}}


def _scenario(kind: str) -> list:
    """A rollup sequence that trips one detector (or none); the serve
    side's counter stays steady throughout."""
    ok = {"fetch.latency_ms": {"count": 50, "p50": 4.0, "p95": 8.0,
                               "p99": 10.0}}
    bad = {"fetch.latency_ms": {"count": 50, "p50": 300.0, "p95": 700.0,
                                "p99": 900.0}}

    def c(fetched):
        return {"fetch.bytes": fetched, "supplier.bytes": 5e6}

    rolls = []
    for seq in range(1, 7):
        rolls.append(_roll(seq, c(10e6), ok, {"fetch.on_air": 8.0}))
    for seq in range(7, 12):
        if kind == "collapse":
            rolls.append(_roll(seq, c(0.1e6), ok))
        elif kind == "p99":
            rolls.append(_roll(seq, c(10e6), bad))
        elif kind == "both":
            rolls.append(_roll(seq, c(0.1e6), bad))
        elif kind == "noisy":
            rolls.append(_roll(seq, c(0.1e6 if seq % 2 else 10e6), ok))
        else:  # recovery after a collapse
            rolls.append(_roll(seq, c(0.1e6 if seq < 10 else 10e6), ok))
    for seq in range(12, 16):
        rolls.append(_roll(seq, c(10e6), ok))
    return rolls


@pytest.mark.parametrize("kind", ["collapse", "p99", "both", "noisy",
                                  "recover"])
def test_detectors_fire_and_report_alike(kind, tmp_path):
    from uda_tpu.utils.flightrec import flightrec as jflightrec
    from uda_tpu_torch.utils.flightrec import flightrec

    out = []
    for (mmod, tsmod, amod, _, cfg_cls), hub, rec in zip(
            PKGS, (jmetrics, metrics), (jflightrec, flightrec)):
        eng = amod.AnomalyEngine()
        ts = tsmod.TimeSeries(mmod.Metrics(stats=True), clock=FakeClock())
        assert eng.arm_from_config(cfg_cls({
            "uda.tpu.anomaly.consec": 2, "uda.tpu.anomaly.warmup": 3,
            "uda.tpu.anomaly.dump": True}), ts)
        rec._dump_dir = str(tmp_path / amod.__name__)
        history = []
        for roll in _scenario(kind):
            eng.on_rollup(roll)
            history.append([(a["kind"], a["key"]) for a in eng.active()])
        snap = eng.snapshot()
        for a in snap["active"]:
            a.pop("since_ts")
            a.pop("last_ts")
        dumps = sorted(p.name.split("_")[-1]
                       for p in (tmp_path / amod.__name__).glob("*.json")) \
            if (tmp_path / amod.__name__).exists() else []
        out.append((history, snap, dumps,
                    {k: v for k, v in hub.snapshot().items()
                     if k.startswith("anomaly.")},
                    [e["kind"] for e in rec.events()]))
        eng.reset()
    assert out[0] == out[1]
    if kind in ("collapse", "p99", "both"):
        assert out[1][1]["fired"] >= 1 and out[1][2] == ["anomaly.json"]
    if kind == "noisy":
        assert out[1][1]["fired"] == 0


def test_leak_detector_on_a_rising_gauge():
    out = []
    for mmod, tsmod, amod, _, cfg_cls in PKGS:
        m = mmod.Metrics(stats=True)
        clock = FakeClock()
        ts = tsmod.TimeSeries(m, window=16, clock=clock)
        eng = amod.AnomalyEngine()
        eng.arm_from_config(cfg_cls({"uda.tpu.anomaly.consec": 2,
                                     "uda.tpu.anomaly.warmup": 3}), ts)
        for i in range(8):
            m.gauge("fetch.on_air", 32.0 * (i + 1))
            eng.on_rollup(ts.sample())
            clock.t += 1.0
        out.append([(a["kind"], a["key"], a["rise"]) for a in eng.active()])
        eng.reset()
    assert out[0] == out[1] == [("leak", "fetch.on_air", 224.0)]


class FakeSched:
    """A WDRR scheduler the SLI book can audit (scripted grants)."""

    def __init__(self, weights):
        self.weights = weights
        self.granted = {t: 0 for t in weights}
        self.parked = {t: 0 for t in weights}

    def stats(self):
        return {"total": 4, "free": 4, "grants": 0, "tenants": {
            t: {"parked": self.parked[t], "parked_cost": 0,
                "granted_cost": self.granted[t], "inflight": 0,
                "deficit": 0.0, "weight": w, "boxed": False}
            for t, w in self.weights.items()}}


@pytest.mark.parametrize("seed", range(4))
def test_sli_book_reports_alike(seed):
    """The same rollups and scheduler views (fair shares, a starved
    tenant, latency past the SLO) give the same snapshot, slo block,
    starving set and breach counters."""
    rng = np.random.default_rng(seed)
    plan = []
    for seq in range(1, 13):
        grants = {"tA": int(rng.integers(0, 400)),
                  "tB": 0 if seq > 6 and seed % 2 else
                  int(rng.integers(0, 200))}
        counters = {"fetch.bytes{supplier=h0,tenant=tA}":
                    float(rng.integers(1, 1 << 20)),
                    "supplier.bytes{tenant=tB}":
                    float(rng.integers(0, 1 << 16))}
        pct = {"fetch.latency_ms{supplier=h0,tenant=tA}":
               {"count": 10, "p50": 1.0, "p95": 2.0,
                "p99": float(rng.integers(1, 80))},
               "fetch.latency_ms{supplier=h1,tenant=tA}":
               {"count": 30, "p50": 1.0, "p95": 2.0,
                "p99": float(rng.integers(1, 80))}}
        plan.append((seq, grants, counters, pct))
    out = []
    for (mmod, tsmod, _, smod, cfg_cls), hub in zip(PKGS,
                                                    (jmetrics, metrics)):
        ts = tsmod.TimeSeries(mmod.Metrics(stats=True), window=8,
                              clock=FakeClock())
        book = smod.SliBook()
        book.arm_from_config(cfg_cls({"uda.tpu.slo.fetch.p99.ms": 40.0,
                                      "uda.tpu.slo.objective": 0.9}), ts)
        sched = FakeSched({"tA": 3, "tB": 1})
        book.attach(scheduler=sched, registry=None)
        starving = []
        for seq, grants, counters, pct in plan:
            sched.parked = {"tA": 1, "tB": 2}
            for t, g in grants.items():
                sched.granted[t] += g
            book.on_rollup(_roll(seq, counters, pct, dt=0.5))
            starving.append(book.starving_tenants(1.0))
        out.append((book.snapshot(), book.slo_block(), starving,
                    {k: v for k, v in hub.snapshot().items()
                     if k.startswith("sli.")}))
        book.detach(sched)
        book.reset()
    assert out[0] == out[1]


def test_arm_observability_plane_and_scrape():
    """Stats on: one config arms the ring, the detectors, the SLI book and
    the OpenMetrics endpoint; a scrape reads the hub (``uda_fetch_bytes``
    is ``fetch.bytes``); disarming stops them all. Stats off: nothing."""
    assert not tts.arm_observability_plane(Config())
    cfg = Config({"uda.tpu.stats.enable": True,
                  "uda.tpu.ts.interval.s": 0.05,
                  "uda.tpu.metrics.http.port": 0})
    assert tts.arm_observability_plane(cfg)
    assert tts.timeseries.running and tanomaly.anomaly_engine.armed
    assert tsli.sli_book.armed
    # port 0 means the endpoint is off; start it on any free port
    from uda_tpu_torch.utils.openmetrics import metrics_http
    port = metrics_http.start(0)
    metrics.add("fetch.bytes", 12345.0, supplier="h0")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    assert "uda_fetch_bytes_total 12345\n" in text
    assert 'uda_fetch_bytes_total{supplier="h0"} 12345' in text
    assert text.endswith("# EOF\n")
    tts.disarm_observability_plane()
    assert not tts.timeseries.running and metrics_http.port == 0
    assert not tanomaly.anomaly_engine.armed and not tsli.sli_book.armed


def test_wire_block_json_matches_reference_shape():
    out = []
    for mmod, tsmod, _, _, _ in PKGS:
        m = mmod.Metrics(stats=True)
        ts = tsmod.TimeSeries(m, clock=FakeClock())
        _feed(m, 9, 0)
        ts.sample()
        blk = json.loads(json.dumps(ts.wire_block()))
        out.append(sorted(blk) + sorted(blk["rollups"][0]))
    assert out[0] == out[1]
