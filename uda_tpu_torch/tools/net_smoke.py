"""Loopback smoke of the port's network shuffle data plane: a
ShuffleServer over a synthetic MOF tree on 127.0.0.1, two concurrent
reduce clients running full MergeManager shuffles through
RemoteFetchClient (HostRoutingClient's default socket factory), each
output held byte for byte to the in-process LocalFetchClient path, then
one MSG_STATS poll of the live server. Exit code != 0 on any mismatch or
wedge.

The port's counterpart of ``scripts/net_smoke.py``, with its tree (job
``jobSmoke``, 6 maps, 2 reducers, 200 records a map of 10-byte keys and
30-byte values, seed 42, written by the port's ``MOFWriter``: the same
bytes as the reference's test helper writes), its output lines and its
exit codes. The reduces run on ``--device`` (the card unless ``--device
cpu``), where K1 merges the runs. ``--spans FILE`` records the smoke as a
span tree and writes the JSONL file ``scripts/trace_merge.py`` stitches::

    python -m uda_tpu_torch.tools.net_smoke [--spans FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import threading
import zlib

import numpy as np

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.merger import (HostRoutingClient, LocalFetchClient,
                                  MergeManager)
from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver, MOFWriter
from uda_tpu_torch.net import ShuffleServer
from uda_tpu_torch.net.client import fetch_remote_stats
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.metrics import metrics

JOB = "jobSmoke"
NUM_MAPS = 6
NUM_REDUCERS = 2
RECORDS_PER_MAP = 200
SEED = 42
KEY_BYTES = 10
VAL_BYTES = 30
KEY_TYPE = "uda.tpu.RawBytes"
JOIN_S = 120


def map_ids(job_id: str, num_maps: int) -> list:
    return [f"attempt_{job_id}_m_{m:06d}_0" for m in range(num_maps)]


def write_tree(root: str, job_id: str = JOB, num_maps: int = NUM_MAPS,
               num_reducers: int = NUM_REDUCERS,
               records_per_map: int = RECORDS_PER_MAP,
               seed: int = SEED) -> None:
    """A map-output tree under ``root``: each map draws its records from
    one seeded generator (key, then value), sends each to reducer
    ``crc32(key) % num_reducers`` and writes its partitions sorted by
    key."""
    rng = np.random.default_rng(seed)
    writer = MOFWriter(root, job_id)
    for mid in map_ids(job_id, num_maps):
        parts: list = [[] for _ in range(num_reducers)]
        for _ in range(records_per_map):
            k = rng.bytes(KEY_BYTES)
            v = rng.bytes(VAL_BYTES)
            parts[zlib.crc32(k) % num_reducers].append((k, v))
        writer.write(mid, [sorted(p, key=lambda kv: kv[0]) for p in parts])


def run_reduce(port: int, reduce_id: int, out: dict, device) -> None:
    router = HostRoutingClient(config=Config())
    mm = MergeManager(router, KEY_TYPE, Config(), device=device)
    blocks: list = []
    maps = [(f"127.0.0.1:{port}", m) for m in map_ids(JOB, NUM_MAPS)]
    try:
        mm.run(JOB, maps, reduce_id, lambda b: blocks.append(bytes(b)))
        out[reduce_id] = b"".join(blocks)
    finally:
        router.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", default=None, metavar="FILE",
                    help="record the smoke as a span tree and write its "
                         "JSONL file (scripts/trace_merge.py input)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the reduces' device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.spans is not None:
        metrics.enable_spans()
    with tempfile.TemporaryDirectory(prefix="uda_net_smoke_") as tmp:
        write_tree(tmp)
        engine = DataEngine(DirIndexResolver(tmp), Config())
        server = ShuffleServer(engine, Config(), host="127.0.0.1", port=0)
        server.start()
        try:
            rc = _smoke(engine, server, device)
        finally:
            server.stop()
            engine.stop()
    if rc:
        return rc
    if args.spans is not None:
        n = metrics.export_spans_jsonl(args.spans)
        print(f"NET SMOKE: {n} spans -> {args.spans}")
    print(f"NET SMOKE OK: {NUM_REDUCERS} concurrent reduce clients, "
          f"{int(metrics.get('net.requests'))} requests, "
          f"{int(metrics.get('net.bytes.out', role='server'))} B served, "
          f"byte-identical to the local path")
    return 0


def _smoke(engine, server, device) -> int:
    out: dict = {}
    threads = [threading.Thread(target=run_reduce,
                                args=(server.port, r, out, device))
               for r in range(NUM_REDUCERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        if t.is_alive():
            print("NET SMOKE FAIL: reduce client wedged", flush=True)
            return 1
    for r in range(NUM_REDUCERS):
        if r not in out:
            print(f"NET SMOKE FAIL: reducer {r} produced no output")
            return 1
        mm = MergeManager(LocalFetchClient(engine), KEY_TYPE, Config(),
                          device=device)
        blocks: list = []
        mm.run(JOB, map_ids(JOB, NUM_MAPS), r,
               lambda b: blocks.append(bytes(b)))
        if out[r] != b"".join(blocks):
            print(f"NET SMOKE FAIL: reducer {r} output differs from "
                  f"the LocalFetchClient path")
            return 1
    # the introspection plane: one MSG_STATS poll against the live server
    # must return counters, the resledger block and the server's provider
    # (the udatop scrape surface)
    snap = fetch_remote_stats("127.0.0.1", server.port)
    if "counters" not in snap or "resledger" not in snap \
            or "net.server" not in snap.get("providers", {}):
        print(f"NET SMOKE FAIL: MSG_STATS snapshot incomplete: "
              f"{sorted(snap)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
