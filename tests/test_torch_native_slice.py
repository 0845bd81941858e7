"""The reduce task on the native host runtime: ``MergeManager.run`` of the
port against the JAX package's, both with ``uda.tpu.use.native`` on, in
every mode (the overlapped merger with and without its pipeline,
streaming, overlap off, hybrid LPQ/RPQ), and the port with the switch on
against the port with it off: the same stream bytes, with native calls
made only while the switch is on. An LZO-compressed MOF tree, written
through each package's codec ladder on a host without liblzo2 (the
builtin C++ rung), is the same file byte for byte, and reduces to the
reference's stream."""

import ctypes.util

import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from test_torch_merge_manager import (BYTES, LONG, TEXT, mof_tree, port_run,
                                      reference_run)
from uda_tpu import compress as jcompress
from uda_tpu.merger import LocalFetchClient as JLocalFetchClient
from uda_tpu.mofserver import writer as jwriter
from uda_tpu.utils import ifile as jifile
from uda_tpu_torch import compress, native
from uda_tpu_torch.merger import LocalFetchClient
from uda_tpu_torch.mofserver import writer
from uda_tpu_torch.utils import ifile

MODES = {
    "default": {},
    "pipeline_off": {"uda.tpu.stage.pipeline": False},
    "streaming": {"uda.tpu.online.streaming": True},
    "overlap_off": {"uda.tpu.merge.overlap": False},
    "hybrid": {"mapred.netmerger.merge.approach": 2,
               "mapred.netmerger.hybrid.lpq.size": 2},
}


@pytest.fixture(autouse=True)
def _switches():
    ifile.set_native_enabled(True)
    jifile.set_native_enabled(True)
    native.reset_calls()
    yield
    ifile.set_native_enabled(True)
    jifile.set_native_enabled(True)
    native.reset_calls()


def _conf(tmp_path, mode: str, side: str, **extra) -> dict:
    conf = dict({"mapred.rdma.buf.size": 1}, **MODES[mode], **extra)
    conf["uda.tpu.spill.dirs"] = str(tmp_path / f"spill_{side}")
    return conf


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("java_class", [TEXT, BYTES, LONG])
def test_run_on_native_matches_reference(tmp_path, mode, java_class):
    root = str(tmp_path / "mof")
    mids = mof_tree(root, java_class, seed=len(mode))
    native.reset_calls()
    got = port_run(root, mids, java_class,
                   _conf(tmp_path, mode, "port", **{"uda.tpu.use.native":
                                                    True}))
    calls = dict(native.calls)
    want = reference_run(root, mids, java_class,
                         _conf(tmp_path, mode, "ref",
                               **{"uda.tpu.use.native": True}))
    assert got == want
    assert got[0] > 2
    # the supplier's reads and the emit's framing went through C++
    assert calls.get("pool_submit", 0) > 0
    assert calls.get("write_records", 0) > 0
    if mode == "hybrid":
        assert calls.get("kway_create", 0) == 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_native_on_and_off_give_the_same_stream(tmp_path, mode):
    root = str(tmp_path / "mof")
    mids = mof_tree(root, TEXT, seed=3)
    runs = {}
    for flag in (True, False, True):
        native.reset_calls()
        runs.setdefault(flag, []).append(
            (port_run(root, mids, TEXT,
                      _conf(tmp_path, mode, f"port{flag}",
                            **{"uda.tpu.use.native": flag})),
             sum(native.calls.values())))
        assert ifile.native_enabled() is flag
    (on1, calls_on1), (on2, calls_on2) = runs[True]
    [(off, calls_off)] = runs[False]
    assert on1 == on2 == off
    assert calls_on1 > 0 and calls_on2 > 0
    assert calls_off == 0


@pytest.mark.skipif(ctypes.util.find_library("lzo2") is not None,
                    reason="liblzo2 is installed: both ladders take it")
def test_lzo_compressed_mof_trees_are_the_references(tmp_path):
    """F4: without liblzo2 each package's ``get_codec("lzo")`` is its
    builtin C++ codec, so the compressed MOFs are the same files (they
    differed while the port's ladder fell to literal-run Python), and
    the port's reduce over its own tree emits the reference's stream
    over the reference's tree."""
    rng_parts = [sorted((bytes([i % 7]) * 10, b"v%05d" % i * 40)
                        for i in range(seed * 50, seed * 50 + 300))
                 for seed in range(3)]
    files = {}
    for side, pkg, wmod in (("p", compress, writer),
                            ("r", jcompress, jwriter)):
        w = wmod.MOFWriter(str(tmp_path / side), "job",
                           codec=pkg.get_codec("lzo"))
        for m in range(3):
            w.write(f"attempt_job_m_{m:06d}_0", [rng_parts[m],
                                                  rng_parts[(m + 1) % 3]])
        files[side] = {}
        for path in sorted((tmp_path / side).rglob("file.out*")):
            files[side][str(path.relative_to(tmp_path / side))] = \
                path.read_bytes()
    assert files["p"] == files["r"]
    assert len(files["p"]) == 6
    out_bytes = sum(len(v) for k, v in files["p"].items()
                    if k.endswith("file.out"))
    raw_bytes = sum(len(k) + len(v) + 2 for part in rng_parts
                    for k, v in part) * 2
    assert out_bytes < raw_bytes // 4  # real LZO matches, not literals
    mids = [f"attempt_job_m_{m:06d}_0" for m in range(3)]
    conf = {"mapred.rdma.buf.size": 1}
    got = port_run(
        str(tmp_path / "p"), mids, "uda.tpu.RawBytes", conf,
        client_of=lambda e: compress.DecompressingClient(
            LocalFetchClient(e), compress.get_codec("lzo")), reduce_id=0)
    want = reference_run(
        str(tmp_path / "r"), mids, "uda.tpu.RawBytes", conf,
        client_of=lambda e: jcompress.DecompressingClient(
            JLocalFetchClient(e), jcompress.get_codec("lzo")), reduce_id=0)
    assert got == want
