"""The port's failpoint framework (uda_tpu_torch.utils.failpoints) against
the JAX package's: the spec grammar, its parse errors, the triggers
(every, once, match, prob with a seed) firing on the same calls, the
truncated and corrupted bytes, the error classes; a site whose module the
port lacks refused with ConfigError; the two sites of the fetch path
(``data_engine.pread``, ``segment.fetch``) armed in both packages, each
with its own ``scoped(...)``, giving the same stream, or the same error
class inside FallbackSignal, as the reference."""

import time

import pytest

from test_torch_merge_manager import TEXT, port_run, reference_run, text_tree
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils import failpoints as jfp
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils import failpoints as tfp
from uda_tpu_torch.utils.config import Config


def _outcomes(reg, site: str, calls: list) -> list:
    """What ``reg`` does on each (data, key) call: the bytes it returns or
    the class name of what it raises."""
    out = []
    for data, key in calls:
        try:
            out.append(reg.evaluate(site, data, key))
        except Exception as e:  # noqa: BLE001 - the outcome under test
            out.append(type(e).__name__)
    return out


def _both(spec: str, site: str = "data_engine.pread"):
    got, want = tfp.FailpointRegistry(), jfp.FailpointRegistry()
    got.arm(site, spec)
    want.arm(site, spec)
    return got, want


CALLS = [(bytes(range(i, i + 40)), f"m_{i % 5:06d}/1") for i in range(40)]


@pytest.mark.parametrize("spec", [
    "error", "error:every:3", "error:once", "error:once:match:m_000002",
    "error:match:m_000003", "error:prob:0.3", "error:prob:0.3:seed:7",
    "error:prob:0.5:seed:11:match:m_000001", "truncate", "truncate:4",
    "truncate:100", "truncate:5:every:2", "corrupt", "corrupt:3:seed:5",
    "corrupt:8:every:4:seed:1", "corrupt:2:prob:0.4:seed:3",
    "error:storage", "error:transport:every:2", "error:merge:once",
    "error:protocol", "error:config", "error:uda", "error:compression",
    "error:tenant", "delay:0:every:2"])
def test_actions_and_triggers_fire_as_the_reference(spec):
    """The same calls fire, the same bytes come back (truncate, and
    corrupt's seeded positions), the same error classes are raised."""
    got, want = _both(spec)
    assert _outcomes(got, "data_engine.pread", CALLS) == \
        _outcomes(want, "data_engine.pread", CALLS)
    assert got.hits == want.hits


@pytest.mark.parametrize("site", tfp.PORTED_SITES)
def test_default_error_class_per_site(site):
    got, want = _both("error:every:2", site)
    assert _outcomes(got, site, CALLS[:6]) == _outcomes(want, site,
                                                        CALLS[:6])


@pytest.mark.parametrize("bad", [
    "a.b", "a.b=nonsense", "a.b=error:every", "a.b=delay",
    "a.b=error:bogus_tok", "a.b=", "a.b=truncate:4:seed", "a.b=corrupt:x",
    "a.b=error:prob"])
def test_parse_errors_match_the_reference(bad):
    with pytest.raises(errors.ConfigError) as got:
        tfp.FailpointRegistry().arm_spec(bad)
    with pytest.raises(jerrors.ConfigError) as want:
        jfp.FailpointRegistry().arm_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("site", sorted(set(tfp.KNOWN_SITES)
                                        - set(tfp.PORTED_SITES)))
def test_an_unported_site_is_refused(site):
    """The reference arms the site; the port refuses it, naming the site
    and the module it lacks, instead of arming a schedule that can never
    fire."""
    assert site in jfp.KNOWN_SITES
    jfp.FailpointRegistry().arm(site, "error")
    with pytest.raises(errors.ConfigError, match=site.replace(".", r"\.")) \
            as got:
        tfp.FailpointRegistry().arm_spec(f"{site}=error")
    assert "not ported" in str(got.value)


def test_the_port_knows_every_site_the_reference_knows():
    assert tfp.KNOWN_SITES == jfp.KNOWN_SITES
    assert set(tfp.PORTED_SITES) <= set(tfp.KNOWN_SITES)


def test_scoped_restores_arming_and_trigger_state():
    reg = tfp.FailpointRegistry()
    reg.arm("x.y", "error:every:2")
    assert reg.evaluate("x.y", b"a", "") == b"a"       # call 1
    with reg.scoped("x.y=truncate:1,segment.fetch=delay:1"):
        assert reg.active() == {"x.y": "truncate:1",
                                "segment.fetch": "delay:1"}
    assert reg.active() == {"x.y": "error:every:2"}
    with pytest.raises(errors.UdaError):                # call 2 fires
        reg.evaluate("x.y", b"a", "")
    # re-arming the identical spec keeps the schedule's count
    reg.arm("x.y", "error:every:2")
    assert reg.evaluate("x.y", b"a", "") == b"a"       # call 3
    reg.disarm("x.y")
    assert not reg.is_armed("x.y")


def test_delay_sleeps_and_the_environment_arms():
    reg = tfp.FailpointRegistry()
    reg.arm("d", "delay:30")
    t0 = time.monotonic()
    assert reg.evaluate("d", b"z", "") == b"z"
    assert time.monotonic() - t0 >= 0.02
    saved = tfp.failpoints
    tfp.failpoints = tfp.FailpointRegistry()
    try:
        tfp._load_env({"UDA_FAILPOINTS": "segment.fetch=error:once"})
        assert tfp.failpoints.active() == {"segment.fetch": "error:once"}
        with pytest.raises(errors.ConfigError, match="bridge.upcall"):
            tfp._load_env({"UDA_FAILPOINTS": "bridge.upcall=error"})
    finally:
        tfp.failpoints = saved


@pytest.mark.parametrize("spec", ["exchange.round=error",
                                  "bridge.upcall=truncate"])
def test_config_key_with_an_unported_site_is_refused(tmp_path, spec):
    conf = Config({"uda.tpu.failpoints": spec})
    with tfp.failpoints.scoped(""):
        with pytest.raises(errors.ConfigError, match="not ported"):
            DataEngine(DirIndexResolver(str(tmp_path)), conf)
        with pytest.raises(errors.ConfigError, match="not ported"):
            MergeManager(LocalFetchClient(None), TEXT, conf, device="cpu")


# -- the fetch path's sites, armed in both packages ---------------------------

MODES = {"overlap_off": {"uda.tpu.merge.overlap": False},
         "default": {},
         "streaming": {"uda.tpu.online.streaming": True},
         "hybrid": {"mapred.netmerger.merge.approach": 2}}


def _armed_runs(tmp_path, mids, spec: str, conf: dict, java_class=TEXT):
    """The port's and the reference's run() of the same tree and Config,
    each with ``spec`` armed in its own registry; returns (port, ref)
    results, each (bytes, stream) or the FallbackSignal's cause class."""
    out = []
    for side, reg, run, sig in (
            ("port", tfp.failpoints, port_run, errors.FallbackSignal),
            ("ref", jfp.failpoints, reference_run, jerrors.FallbackSignal)):
        c = dict(conf, **{"uda.tpu.spill.dirs": str(tmp_path / side)})
        with reg.scoped(spec):
            try:
                out.append(run(str(tmp_path / "mof"), mids, java_class, c))
            except sig as e:
                out.append(type(e.cause).__name__)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("spec,chunk_kb", [
    # a periodic error restarts a segment from offset 0, so each segment
    # is one chunk here: at 1 KB chunks every attempt would hit it again
    ("data_engine.pread=error:every:3", 1024),
    ("data_engine.pread=truncate:7:every:2", 1),
    ("segment.fetch=error:every:4", 1024),
    ("segment.fetch=delay:1:prob:0.5:seed:3", 1)])
def test_recoverable_faults_give_the_clean_stream(tmp_path, spec, chunk_kb,
                                                  mode):
    mids = text_tree(str(tmp_path / "mof"), "job", 4, 60, seed=41)
    conf = dict(MODES[mode], **{"mapred.rdma.buf.size": chunk_kb,
                                "uda.tpu.fetch.retries": 10,
                                "mapred.rdma.wqe.per.conn": 2})
    clean = port_run(str(tmp_path / "mof"), mids, TEXT,
                     dict(conf, **{"uda.tpu.spill.dirs":
                                   str(tmp_path / "clean")}))
    assert _armed_runs(tmp_path, mids, spec, conf) == [clean, clean]


@pytest.mark.parametrize("spec,cause", [
    ("data_engine.pread=error:match:map_002", "StorageError"),
    ("segment.fetch=error:match:map_001", "TransportError"),
    ("segment.fetch=error:tenant:once", "TenantError"),
    ("data_engine.pread=corrupt:4:match:map_000", "StorageError")])
def test_terminal_faults_end_in_the_same_fallback(tmp_path, spec, cause):
    """Retries exhausted (or a terminal class): FallbackSignal carrying
    the same error class in both packages. With CRCs on, corruption of
    every read of one map exhausts the one re-fetch and the retries."""
    mids = text_tree(str(tmp_path / "mof"), "job", 3, 30, seed=43)
    conf = {"uda.tpu.fetch.retries": 1, "uda.tpu.fetch.crc": True,
            "mapred.rdma.buf.size": 1}
    assert _armed_runs(tmp_path, mids, spec, conf) == [cause, cause]


def test_crc_catches_one_corruption_and_refetches(tmp_path):
    mids = text_tree(str(tmp_path / "mof"), "job", 4, 40, seed=45)
    conf = {"uda.tpu.fetch.crc": True, "mapred.rdma.buf.size": 1}
    clean = port_run(str(tmp_path / "mof"), mids, TEXT, conf)
    assert _armed_runs(tmp_path, mids, "data_engine.pread=corrupt:8:once",
                       conf) == [clean, clean]
