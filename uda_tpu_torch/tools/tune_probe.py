"""tune_probe: seeded fly-off probes that populate the online tuning
cache (uda_tpu_torch/utils/tuncache.py).

The port's counterpart of ``scripts/tune_probe.py``, with its flags,
output lines, exit codes and record shapes: it measures on THIS host and
persists per-(key-shape, platform, backend) winners that
``ops.sort.route_engine`` and the batched host-I/O plane consult at
routing time. Env-var winners still override the cache (env > cache >
built-in). A cache file written by either package routes the other.

Domains probed (``--domain`` selects one, default both):

- ``sort.engine``: a ``terasort.bench_step`` fly-off on ``--device`` (the
  card unless ``--device cpu``) over ``carry``, ``gather``, ``gather2``
  and ``carrychunk``, plus the lanes engines (``lanes``, ``lanes2``,
  ``keys8``, ``keys8f``: the hand kernels K1-K4) where they run for real,
  on the card, at two row-bucket shapes; one winner per (backend,
  rows-bucket, lanes-capability) key, ``gpu|rows<b>|lanes<0|1>`` on the
  card and ``cpu|...`` on the CPU. On the CPU the lanes engines would run
  their plain versions, so they are left out there.
- ``io.read``: a ``submit_batch`` burst A/B over coalesce-gap settings on
  a synthetic MOF (the io_bench hot-burst shape, in-process), one winner
  per platform: {batch, gap_kb, batch_max, backend}.

Re-probe rung: ``--reprobe-age S`` skips entries younger than S seconds;
``--force`` re-measures everything. Probes count ``tune.probes``, and the
last line says how many this run made (a second run over a warm cache
prints ``0 probe(s) run``).

Usage::

    UDA_TPU_TUNE_CACHE=/path/tune.json python -m uda_tpu_torch.tools.tune_probe
    python -m uda_tpu_torch.tools.tune_probe --cache /path/tune.json \\
        --domain io.read
    python -m uda_tpu_torch.tools.tune_probe --cache t.json --quick \\
        --device cpu

Exit codes: 0 ok; 2 no cache path (``--cache`` or ``UDA_TPU_TUNE_CACHE``).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile
import time

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.utils.metrics import metrics
from uda_tpu_torch.utils.tuncache import (TuneCache, cache_path_from_env,
                                          rows_bucket)

JOB = "jobTuneProbe"
MAP = "attempt_jobTuneProbe_m_000000_0"
# The engines every backend probes (the reference's pure-XLA set).
BASE_ENGINES = ("carry", "gather", "gather2", "carrychunk")
# The sort fly-off's row counts, at full size and with --quick.
SIZES = (1 << 16, 1 << 20)
QUICK_SIZES = (1 << 14,)


def _fresh(cache, domain: str, key: str, reprobe_age: float,
           force: bool) -> bool:
    """True when the entry is fresh enough to SKIP re-probing."""
    if force:
        return False
    age = cache.age_s(domain, key)
    if age is None:
        return False
    if reprobe_age <= 0:
        return True  # a winner exists and no staleness horizon: keep it
    return age <= reprobe_age


def sort_candidates(device, lanes_ok: bool) -> list:
    """The fly-off's engines for one key: the lanes engines join only for
    a lanes-capable caller on the card, where they launch K1-K4."""
    from uda_tpu_torch.ops import sort as sort_ops

    names = list(BASE_ENGINES)
    if lanes_ok and device.type == "cuda":
        names += list(sort_ops.LANES_ENGINES)
    return names


def probe_sort_engine(cache, quick: bool, reprobe_age: float,
                      force: bool, seed: int, device) -> list:
    """Fly-off per (backend, rows-bucket, lanes-capability): time each
    candidate engine with bench_step (zero order violations and equal
    checksums required: a broken engine can never be crowned) and persist
    the winner."""
    from uda_tpu_torch.models import terasort
    from uda_tpu_torch.ops import sort as sort_ops

    backend = sort_ops.cache_backend(device)
    sizes = QUICK_SIZES if quick else SIZES
    out = []
    for n in sizes:
        for lanes_ok in (False, True):
            key = f"{backend}|rows{rows_bucket(n)}|lanes{int(lanes_ok)}"
            if _fresh(cache, "sort.engine", key, reprobe_age, force):
                out.append((key, "fresh", None))
                continue
            metrics.add("tune.probes", domain="sort.engine")
            best = None
            times = {}
            for path in sort_candidates(device, lanes_ok):
                def one(s, path=path):
                    t0 = time.perf_counter()
                    viol, ck_in, ck_out = terasort.bench_step(
                        s, n, 1, path=path, tile=min(1024, n),
                        device=device)
                    bad = int(viol)  # synchronises with the device
                    dt = time.perf_counter() - t0
                    if bad or int(ck_in) != int(ck_out):
                        raise AssertionError(
                            f"{path}: {bad} order violations, checksums "
                            f"{int(ck_in)} / {int(ck_out)}")
                    return dt

                try:
                    one(seed)  # warm-up
                    dt = min(one(seed + 1), one(seed + 2))
                    times[path] = round(dt, 5)
                    if best is None or dt < best[1]:
                        best = (path, dt)
                except Exception as e:  # noqa: BLE001 - one engine's
                    # failure (an unsupported shape or device) must not
                    # end the fly-off; it is recorded and cannot win
                    times[path] = f"error: {type(e).__name__}"
            if best is None:
                out.append((key, "no-winner", None))
                continue
            gbps = n * terasort.RECORD_BYTES / 1e9 / best[1]
            cache.record("sort.engine", key,
                         {"engine": best[0], "times_s": times},
                         metric=round(gbps, 4), probe="tune_probe")
            out.append((key, "probed", best[0]))
    return out


def probe_io_read(cache, quick: bool, reprobe_age: float, force: bool,
                  seed: int) -> list:
    """Burst A/B over the batched read plane's parameters on a synthetic
    MOF: batch off against on at each coalesce-gap rung; the winner is the
    fastest configuration whose bytes matched the file."""
    from uda_tpu_torch.mofserver.data_engine import DataEngine, ShuffleRequest
    from uda_tpu_torch.mofserver.index import IndexRecord
    from uda_tpu_torch.utils.config import Config

    key = sys.platform
    if _fresh(cache, "io.read", key, reprobe_age, force):
        return [(key, "fresh", None)]
    metrics.add("tune.probes", domain="io.read")

    class _Resolver:
        def __init__(self, path, n):
            self._rec = IndexRecord(start_offset=0, raw_length=n,
                                    part_length=n, path=path)

        def resolve(self, job_id, map_id, reduce_id):
            return self._rec

    total = (8 << 20) if quick else (64 << 20)
    chunk = 64 << 10
    burst = 64 if quick else 256

    def burst_offsets():
        # the hot-burst shape: mostly sequential chunks with jitter. The
        # rng is rebuilt per call so every configuration and repetition
        # fetches the same ranges in the same order
        offs = [(i * chunk) % (total - chunk) for i in range(burst)]
        random.Random(seed).shuffle(offs)
        return offs

    with tempfile.TemporaryDirectory(prefix="uda_tune_probe_") as tmp:
        path = os.path.join(tmp, "probe.mof")
        block = os.urandom(1 << 20)
        with open(path, "wb") as f:
            left = total
            while left > 0:
                f.write(block[:min(left, len(block))])
                left -= len(block)

        def run(cfg_over: dict, batched: bool) -> float:
            engine = DataEngine(_Resolver(path, total),
                                Config(dict(cfg_over)))
            try:
                offs = burst_offsets()
                reqs = [ShuffleRequest(JOB, MAP, 0, off, chunk)
                        for off in offs]
                t0 = time.perf_counter()
                if batched:
                    futs = engine.submit_batch(reqs)
                else:
                    futs = [engine.submit(r) for r in reqs]
                with open(path, "rb") as oracle_f:
                    for req, fut in zip(reqs, futs):
                        res = fut.result(timeout=60.0)
                        oracle_f.seek(req.offset)
                        want = oracle_f.read(min(chunk, total - req.offset))
                        if bytes(res.data) != want:
                            raise AssertionError("probe identity broke")
                return time.perf_counter() - t0
            finally:
                engine.stop()

        reps = 2 if quick else 3
        results = {"off": min(run({}, batched=False) for _ in range(reps))}
        best = ("off", results["off"], {})
        for gap in (0, 64, 256):
            name = f"gap{gap}"
            results[name] = min(
                run({"uda.tpu.read.coalesce.gap.kb": gap}, batched=True)
                for _ in range(reps))
            if results[name] < best[1]:
                best = (name, results[name],
                        {"batch": "on", "gap_kb": gap, "batch_max": 256})
        probe_engine = DataEngine(_Resolver(path, total), Config())
        winner = dict(best[2] or {"batch": "off"})
        winner["backend"] = probe_engine.io_backend
        probe_engine.stop()
    mbps = burst * chunk / (1 << 20) / best[1]
    cache.record("io.read", key, winner, metric=round(mbps, 2),
                 probe="tune_probe")
    return [(key, "probed",
             f"{winner} ({ {k: round(v, 4) for k, v in results.items()} })")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default="",
                    help="tuning-cache path (default: UDA_TPU_TUNE_CACHE"
                         " env, required one way or the other)")
    ap.add_argument("--domain", choices=["sort.engine", "io.read"],
                    help="probe one domain only (default: both)")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes (CI / test sizes)")
    ap.add_argument("--force", action="store_true",
                    help="re-measure even fresh entries")
    ap.add_argument("--reprobe-age", type=float, default=0.0,
                    help="re-measure entries older than this many "
                         "seconds (0 = existing winners are kept; "
                         "this is the background re-probe rung)")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--list", action="store_true",
                    help="print the cache entries and exit")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the sort fly-off's device (default: the card; "
                         "without one the probe raises unless --device "
                         "cpu)")
    args = ap.parse_args(argv)

    path = args.cache or cache_path_from_env()
    if not path:
        print("tune_probe: no cache path (--cache or UDA_TPU_TUNE_CACHE)",
              file=sys.stderr)
        return 2
    cache = TuneCache(path)
    if args.list:
        for k, v in sorted(cache.entries().items()):
            print(f"{k}: {v.get('winner')} (metric {v.get('metric')})")
        return 0
    sort_domain = args.domain in (None, "sort.engine")
    device = resolve_device(args.device) if sort_domain else None
    before = metrics.get("tune.probes")
    reports = []
    if args.domain in (None, "io.read"):
        reports += probe_io_read(cache, args.quick, args.reprobe_age,
                                 args.force, args.seed)
    if sort_domain:
        reports += probe_sort_engine(cache, args.quick, args.reprobe_age,
                                     args.force, args.seed, device)
    probes = int(metrics.get("tune.probes") - before)
    for key, status, winner in reports:
        line = f"tune_probe: {key}: {status}"
        if winner is not None:
            line += f" -> {winner}"
        print(line)
    print(f"tune_probe: {probes} probe(s) run, cache at {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
