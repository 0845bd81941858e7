"""The port's multi-process mesh over gloo against the reference's
single-process 8-device mesh, byte for byte.

Each test starts its processes as ``python tests/test_torch_multihost.py
<rank> <world> <port> <slots> <out>`` (the ``__main__`` block below, which
imports the port only), joins them in one gloo group on 127.0.0.1 and runs
the sort step (fused: carry and keys8; multiround after a skew overflow),
the exchange (flat, hierarchical, coded) on the 2-axis mesh whose outer
axis is the process, and ``exchange_blobs``. Rank 0 writes what it
gathered; the test holds it to the reference on the same words."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 8
ROWS = 64          # rows a slot
SKEW_CAP = 16
HIER_CAP = 24
TIMEOUT_S = 120


def _words(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (P * ROWS, 5), dtype=np.uint32)
    w[:, 0] &= np.uint32(0xF000000F)          # equal first words
    w[::9, :2] = 0xFFFFFFFF
    return w


def _skewed(seed: int) -> np.ndarray:
    w = _words(seed)
    w[: P * ROWS // 2, 0] = 7                 # half of them to partition 0
    return w


def _blobs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [[((s * 3 + j) % P, rng.bytes(int(n)))
             for j, n in enumerate(rng.integers(0, 700, 1 + s % 3))]
            for s in range(P)]


def _worker(rank: int, world: int, port: int, slots: int, out: str) -> None:
    import torch

    from uda_tpu_torch.parallel import (distributed_sort_step,
                                        exchange_blobs, shuffle_exchange,
                                        uniform_splitters)
    from uda_tpu_torch.parallel import multihost as mh

    mh.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                  timeout_s=TIMEOUT_S)
    mesh = mh.global_mesh(devices=["cpu"] * slots)
    assert mesh.size == P and mesh.distributed
    lo, hi = rank * slots * ROWS, (rank + 1) * slots * ROWS
    spl = uniform_splitters(P)
    got = {}
    words = _words(1)
    for path in ("carry", "keys8"):
        res = distributed_sort_step(mh.shard_rows(words[lo:hi], mesh), spl,
                                    mesh, "shuffle", 2 * ROWS, 2,
                                    payload_path=path)
        res.check()
        got[f"fused_{path}"] = mh.allgather(mesh, res.words)
        got[f"fused_{path}_n"] = mh.allgather(mesh, res.valid_counts)
    res = distributed_sort_step(mh.shard_rows(_skewed(2)[lo:hi], mesh), spl,
                                mesh, "shuffle", SKEW_CAP, 2,
                                payload_path="carry")
    got["skew"] = mh.allgather(mesh, res.words)
    got["skew_n"] = mh.allgather(mesh, res.valid_counts)
    mesh2 = mh.global_mesh_2axis(ici_axis="ici", devices=["cpu"] * slots)
    dest = (words[:, 1] % P).astype(np.int32)
    for mode in ("flat", "hierarchical", "coded"):
        rounds, _ = shuffle_exchange(
            mh.shard_rows(words[lo:hi], mesh2),
            mh.shard_rows(dest[lo:hi], mesh2), mesh2, ("dcn", "ici"),
            HIER_CAP, mode=mode)
        for r, (rw, rc) in enumerate(rounds):
            got[f"{mode}_{r}_w"] = mh.allgather(mesh2, rw)
            got[f"{mode}_{r}_c"] = mh.allgather(mesh2, rc)
        got[f"{mode}_rounds"] = np.int64(len(rounds))
    delivered = exchange_blobs(_blobs(3), mesh, "shuffle")
    got["blobs"] = np.frombuffer(repr(delivered).encode(), np.uint8)
    torch.distributed.destroy_process_group()
    if rank == 0:
        np.savez(out, **got)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(world: int, tmp_path) -> dict:
    out = str(tmp_path / "got.npz")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), str(P // world), out], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    with np.load(out) as z:
        return dict(z)


def _reference() -> dict:
    import jax
    from jax.sharding import Mesh

    from uda_tpu.parallel import (distributed_sort_step, exchange_blobs,
                                  make_mesh, shuffle_exchange,
                                  uniform_splitters)

    mesh = make_mesh(P, "shuffle")
    spl = uniform_splitters(P)
    want = {}
    words = _words(1)
    # the reference's carry path gives the lanes engines' order
    res = distributed_sort_step(words, spl, mesh, "shuffle", 2 * ROWS, 2,
                                payload_path="carry")
    for path in ("carry", "keys8"):
        want[f"fused_{path}"] = np.asarray(res.words)
        want[f"fused_{path}_n"] = np.asarray(res.valid_counts).reshape(-1)
    res = distributed_sort_step(_skewed(2), spl, mesh, "shuffle", SKEW_CAP,
                                2, payload_path="carry")
    want["skew"] = np.asarray(res.words)
    want["skew_n"] = np.asarray(res.valid_counts).reshape(-1)
    mesh2 = Mesh(np.asarray(jax.devices()[:P]).reshape(2, P // 2),
                 ("dcn", "ici"))
    dest = (words[:, 1] % P).astype(np.int32)
    for mode in ("flat", "hierarchical", "coded"):
        rounds, _ = shuffle_exchange(words, dest, mesh2, ("dcn", "ici"),
                                     HIER_CAP, mode=mode)
        for r, (rw, rc) in enumerate(rounds):
            want[f"{mode}_{r}_w"] = np.asarray(rw)
            want[f"{mode}_{r}_c"] = np.asarray(rc).reshape(-1)
        want[f"{mode}_rounds"] = np.int64(len(rounds))
    want["blobs"] = np.frombuffer(
        repr(exchange_blobs(_blobs(3), mesh, "shuffle")).encode(), np.uint8)
    return want


_WANT = {}


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_processes_match_the_reference(world, tmp_path):
    """2 processes x 4 slots and 4 x 2: every result gathered on rank 0
    equals the reference's 8-device result; on the 2-axis mesh the
    process is the DCN axis, so stage B crosses processes."""
    if not _WANT:
        _WANT.update(_reference())
    got = _run(world, tmp_path)
    assert sorted(got) == sorted(_WANT)
    for key, want in _WANT.items():
        assert np.array_equal(got[key].reshape(want.shape), want), key


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
