"""The port's stall watchdog (uda_tpu_torch.utils.watchdog,
``uda.tpu.watchdog.stall.s``) against the JAX package's: the poll period,
the dump, the firing; a fetch wedged by the ``segment.fetch`` delay
failpoint ends in FallbackSignal(StallError) within 3 s in both packages;
a task that makes progress is never fired on; the progress token is
task-local; ``stop()`` drains a fetch loop wedged on its credits."""

import threading
import time

import pytest

from test_torch_merge_manager import TEXT, port_run, reference_run, text_tree
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.merger import MergeManager as JMergeManager
from uda_tpu.mofserver import DataEngine as JDataEngine
from uda_tpu.mofserver import DirIndexResolver as JDirIndexResolver
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu.utils import failpoints as jfp
from uda_tpu.utils import watchdog as jwd
from uda_tpu_torch.merger import LocalFetchClient, MergeManager
from uda_tpu_torch.merger.segment import InputClient
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
from uda_tpu_torch.mofserver.data_engine import FetchResult
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils import failpoints as tfp
from uda_tpu_torch.utils import watchdog as twd
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import metrics


@pytest.mark.parametrize("stall_s", [0.01, 0.15, 0.5, 3.0, 60.0])
def test_poll_period_matches_reference(stall_s):
    assert twd.StallWatchdog(stall_s, lambda: 0).poll_s == \
        jwd.StallWatchdog(stall_s, lambda: 0).poll_s


def test_a_positive_deadline_is_required_as_in_the_reference():
    with pytest.raises(errors.UdaError) as got:
        twd.StallWatchdog(0, lambda: 0)
    with pytest.raises(jerrors.UdaError) as want:
        jwd.StallWatchdog(0, lambda: 0)
    assert str(got.value) == str(want.value)


def test_fires_once_and_dumps_every_stack():
    fired = []
    metrics.add("watchdog.test.counter", 3)
    wd = twd.StallWatchdog(0.15, lambda: 7, on_stall=fired.append,
                           name="wd-test").start()
    try:
        deadline = time.monotonic() + 5
        while not wd.fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.fired and len(fired) == 1
        assert isinstance(fired[0], twd.StallError)
        assert "thread stacks" in wd.last_dump
        assert "wd-test" in wd.last_dump      # its own stack is there
        assert "watchdog.test.counter = 3" in wd.last_dump
    finally:
        wd.stop()


def test_does_not_fire_while_progressing():
    token = [0]

    def progress():
        token[0] += 1
        return token[0]

    wd = twd.StallWatchdog(0.2, progress).start()
    time.sleep(0.7)
    try:
        assert not wd.fired
    finally:
        wd.stop()


def test_the_progress_token_is_task_local(tmp_path):
    """Process-wide counters moving must not read as this task's
    progress; the task's own checkpoint saves must."""
    from uda_tpu_torch.merger import checkpoint

    mm = MergeManager(_Wedge(), TEXT, Config(), device="cpu")
    t0 = mm._progress_token()
    metrics.add("fetch.bytes", 12345)
    metrics.add("emit.bytes", 678)
    assert mm._progress_token() == t0
    mm._ckpt = checkpoint.TaskCheckpoint(str(tmp_path), "j", 0,
                                         interval_s=0.0)
    mm._ckpt.save(lambda: ({"maps": [], "runs": {}, "ledgers": {},
                            "journal": [], "penalty": {}, "forest": {}},
                           {}))
    assert mm._progress_token() != t0
    assert mm._progress_token()[:-1] == t0[:-1]


class _Wedge(InputClient):
    """A transport whose fetches never complete."""

    def __init__(self):
        self.started = []

    def start_fetch(self, req, on_complete):
        self.started.append(req.map_id)


def test_stop_drains_a_fetch_loop_wedged_on_credits():
    mm = MergeManager(_Wedge(), TEXT, Config({"mapred.rdma.wqe.per.conn":
                                              2}), device="cpu")
    err = []

    def run():
        try:
            mm.fetch_all("j", [f"m{i}" for i in range(4)], 0,
                         on_segment=lambda i, s: None)
        except Exception as e:  # noqa: BLE001 - the outcome under test
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 5
    while len(mm.client.started) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    f0 = metrics.get("fetch.failed_admin")
    mm.stop()
    t.join(timeout=10)
    assert not t.is_alive()
    assert err and isinstance(err[0], errors.MergeError)
    assert metrics.get("fetch.failed_admin") == f0 + 2


def test_stop_breaks_the_wait_for_completion_callbacks():
    """A completion wedged inside the on_segment consumer: stop() breaks
    the wait for the callbacks too."""
    class AsyncEmpty(InputClient):
        """Completes each fetch on a thread of its own, never inline."""

        def start_fetch(self, req, on_complete):
            threading.Timer(0.02, on_complete, args=(
                FetchResult(b"", 0, 0, 0, "p", last=True),)).start()

    release = threading.Event()
    mm = MergeManager(AsyncEmpty(), TEXT, Config(), device="cpu")
    err = []

    def run():
        try:
            mm.fetch_all("j", [f"m{i}" for i in range(3)], 0,
                         on_segment=lambda i, s: release.wait())
        except Exception as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and sum(
            1 for s in mm._live_segments if s._done.is_set()) < 3:
        time.sleep(0.01)
    mm.stop()
    threading.Timer(0.3, release.set).start()
    t.join(timeout=10)
    release.set()
    assert not t.is_alive()
    assert err and isinstance(err[0], errors.MergeError)


WEDGE = "segment.fetch=delay:3000:every:4"


@pytest.mark.parametrize("side,mode", [
    ("port", {}), ("port", {"uda.tpu.online.streaming": True}),
    ("port", {"uda.tpu.merge.overlap": False}), ("ref", {})])
def test_a_wedged_fetch_ends_in_fallback_stall_error(tmp_path, side, mode):
    """Every fourth fetch issue sleeps 3 s, far past the 0.5 s deadline:
    run() ends in FallbackSignal(StallError) within 3 s, in the port as
    in the reference."""
    mids = text_tree(str(tmp_path / "mof"), "job", 2, 200, seed=51)
    conf = dict(mode, **{"mapred.rdma.buf.size": 1,
                         "uda.tpu.watchdog.stall.s": 0.5,
                         "uda.tpu.spill.dirs": str(tmp_path / "spill")})
    root = str(tmp_path / "mof")
    if side == "port":
        engine = DataEngine(DirIndexResolver(root), Config(conf))
        mm = MergeManager(LocalFetchClient(engine), TEXT, Config(conf),
                          device="cpu")
        reg, sig = tfp.failpoints, errors.FallbackSignal
    else:
        engine = JDataEngine(JDirIndexResolver(root), JConfig(conf))
        mm = JMergeManager(JLocalFetchClient(engine), TEXT, JConfig(conf))
        reg, sig = jfp.failpoints, jerrors.FallbackSignal
    stalls = metrics.get("watchdog.stalls")
    try:
        with reg.scoped(WEDGE):
            t0 = time.monotonic()
            with pytest.raises(sig) as got:
                mm.run("job", mids, 1, lambda b: None)
            took = time.monotonic() - t0
    finally:
        engine.stop()  # waits for the sleeping fetch
    assert type(got.value.cause).__name__ == "StallError"
    assert took < 3.0, f"ended by the delay, not the watchdog ({took} s)"
    assert mm._watchdog is None
    if side == "port":
        assert metrics.get("watchdog.stalls") == stalls + 1


def test_no_stall_while_the_task_progresses(tmp_path):
    """Slow but moving (every fetch issue 20 ms late): the watchdog at
    0.5 s never fires and the stream equals the reference's."""
    mids = text_tree(str(tmp_path / "mof"), "job", 2, 60, seed=53)
    conf = {"mapred.rdma.buf.size": 1, "uda.tpu.watchdog.stall.s": 0.5}
    stalls = metrics.get("watchdog.stalls")
    with tfp.failpoints.scoped("segment.fetch=delay:20"):
        got = port_run(str(tmp_path / "mof"), mids, TEXT, conf)
    assert metrics.get("watchdog.stalls") == stalls
    assert got == reference_run(str(tmp_path / "mof"), mids, TEXT, conf)
