"""The wire reduce driver: TeraSort reduce tasks back to back, each one
``MergeManager.run`` fetching its map outputs over TCP from the shuffle
supplier of every node, merging on the card and handing its stream to a
consumer, as a reduce task of a job on several nodes does.

The configuration gives the job as ``drivers/reduce.py`` reads it, and
its layout: ``nodes`` NodeManagers, each holding ``maps_per_node`` of the
``maps`` map outputs (map ``m`` on node ``m // maps_per_node``). Set-up
writes each node's map outputs under its own directory with the
benchmark's writer, starts one supplier process a node
(``portbench/supplier.py``: a ``DataEngine`` behind an
``EvLoopShuffleServer`` on 127.0.0.1, an ephemeral port) and runs the warm
tasks.

Each task builds its own ``HostRoutingClient`` (the socket default: one
``RemoteFetchClient`` connection a supplier, dialled by the task) with
entries ``(["127.0.0.1:<port of the map's node>"], map)``, and stops it at
its end. The window, the consumer, the sampling and the judgement are the
reduce driver's (``measure`` runs its loop); each task's record also gets
``timers``: the task's change in every ``*_time`` counter of the port's
metrics hub. ``close`` closes each supplier's standard input, logs the
counters it prints (the bytes it sent by sendfile against the bytes the
reducer fetched) and reaps it, killing one that does not exit in time.
"""

from __future__ import annotations

import json
import os
import select
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import gen, ifile
from portbench.drivers import reduce as local
from portbench.reference import reduce_wire as reference

JOB = local.JOB
START_S = 120.0      # a supplier's imports and bind, on a loaded host
STOP_S = 20.0        # a supplier's drain and exit once asked


def setup(run):
    state = SimpleNamespace(tmp=None, suppliers=[], captured={},
                            timer_log=[], log=run.log)
    try:
        _setup(run, state)
    except BaseException:
        close(state)
        raise
    return state


def _setup(run, state) -> None:
    from uda_tpu_torch.merger import HostRoutingClient, MergeManager
    from uda_tpu_torch.utils.config import Config

    c, t = run.config, run.traffic
    nodes, per = int(c["nodes"]), int(c["maps_per_node"])
    if nodes * per != int(c["maps"]):
        raise ValueError(f"{nodes} nodes x {per} maps is not the "
                         f"configuration's {c['maps']} maps")
    state.tmp = tempfile.mkdtemp(prefix="portbench-wire-")
    state.parts = gen.tera_partitions(
        run.seed, int(c["maps"]), int(c["records_per_segment"]),
        int(c["reducers"]), int(c["reduce_partition"]))
    dirs = [os.path.join(state.tmp, f"node{k}") for k in range(nodes)]
    mids = []
    for m, rec in enumerate(state.parts):
        mid = ifile.map_id(JOB, m)
        ifile.write_map_output(os.path.join(dirs[m // per], JOB, mid), [rec])
        mids.append(mid)
    for d in dirs:
        state.suppliers.append(_spawn(d, c["conf"]))
    ports = [_port_of(p) for p in state.suppliers]
    run.log(f"{nodes} suppliers listening on 127.0.0.1 ports {ports}, "
            f"pids {[p.pid for p in state.suppliers]}")
    conf = Config(dict(c["conf"]))
    dev = run.device

    def task(consumer, entries) -> None:
        from uda_tpu_torch.utils.metrics import metrics

        before = metrics.snapshot()
        client = HostRoutingClient(config=conf)
        try:
            MergeManager(client, c["key_class"], conf, device=dev).run(
                JOB, entries, 0, consumer)
        finally:
            client.stop()
            state.timer_log.append(_timers(metrics.snapshot(), before))

    state.task = task
    state.entries = [([f"127.0.0.1:{ports[m // per]}"], mid)
                     for m, mid in enumerate(mids)]
    state.call = lambda consumer: task(consumer, state.entries)
    # the reduce driver's sampling and consumer buffers, touched now so
    # that no page is first written inside the window
    stream_len = sum(p.size for p in state.parts) + len(ifile.EOF_MARKER)
    rng = np.random.default_rng(gen.seed64(run.seed))
    state.sample = set(int(i) for i in rng.choice(
        int(t["sample_from"]), int(t["sample_tasks"]), replace=False))
    state.bufs = {i: np.ones(stream_len, np.uint8)
                  for i in sorted(state.sample) + [-1]}
    walls = []
    for _ in range(int(t["warm_tasks"])):
        start = time.perf_counter()
        state.call(local.Sink(state.bufs[-1], 0.0))
        local._sync(dev)
        walls.append(round(time.perf_counter() - start, 3))
    run.log(f"warm task walls {walls}")


def _spawn(node_dir: str, conf: dict) -> subprocess.Popen:
    """One supplier process over ``node_dir``, the card hidden from it;
    it finds ``portbench`` and ``uda_tpu_torch`` where this process
    found them."""
    import portbench
    import uda_tpu_torch

    roots = [str(Path(mod.__file__).resolve().parents[1])
             for mod in (portbench, uda_tpu_torch)]
    path = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(roots + ([path] if path else [])))
    return subprocess.Popen(
        [sys.executable, "-m", "portbench.supplier", "--dir", node_dir,
         "--conf", json.dumps(conf)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)


def _port_of(proc: subprocess.Popen) -> int:
    """The port a supplier prints once it listens."""
    ready, _, _ = select.select([proc.stdout], [], [], START_S)
    line = proc.stdout.readline() if ready else b""
    if not line:
        raise RuntimeError(f"supplier {proc.pid} printed no port within "
                           f"{START_S:g} s (exit code {proc.poll()})")
    return int(json.loads(line)["port"])


def _timers(now: dict, then: dict) -> dict:
    """The change of every ``*_time`` counter (no labelled series)."""
    return {k: v - then.get(k, 0.0) for k, v in now.items()
            if k.endswith("_time") and "{" not in k}


def measure(state, run) -> dict:
    """The reduce driver's window; each task's record gets its timers
    where every task of the window ran through ``state.task``."""
    from uda_tpu_torch.utils.metrics import metrics

    state.timer_log.clear()
    rec = local.measure(state, run)
    if len(state.timer_log) == len(rec["tasks"]):
        for task, timers in zip(rec["tasks"], state.timer_log):
            task["timers"] = timers
    counters = {k: v for k, v in metrics.snapshot().items()
                if k.startswith("net.") and "{" not in k}
    run.log(f"the port's net counters since the run started: {counters}")
    return rec


def check(state, run, record) -> dict:
    """Every kept stream against the reference's stable merge of the
    partitions the benchmark made."""
    want = reference.merged_records(state.parts)
    # a window that reached no sampled task has nothing judged
    bad = 0 if state.captured else want.shape[0]
    for got in state.captured.values():
        bad += reference.records_out_of_place(want, got)
    run.log(f"judged the streams of tasks {sorted(state.captured)}")
    return {"records_out_of_place": (bad, 0)}


def close(state) -> None:
    """Stop every supplier (its standard input closed, then a kill after
    ``STOP_S``), log what each served, and remove the map outputs."""
    ends = []
    for proc in state.suppliers:
        try:
            out, _ = proc.communicate(timeout=STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        if proc.returncode:
            state.log(f"supplier {proc.pid} exited {proc.returncode}")
        else:
            ends.append(json.loads(out.splitlines()[-1]))
    if ends:
        from uda_tpu_torch.utils.metrics import metrics

        sent = [e["counters"].get("net.sendfile.bytes", 0) for e in ends]
        state.log(f"suppliers sent {sent} B by sendfile ({sum(sent):.0f} "
                  f"B in all), served "
                  f"{[e['counters'].get('net.serve.copy', 0) for e in ends]}"
                  f" requests by copy and initialised the card "
                  f"{[e['cuda_initialized'] for e in ends]}; the reducer "
                  f"fetched {metrics.get('fetch.bytes'):.0f} B")
    state.suppliers = []
    if state.tmp is not None:
        shutil.rmtree(state.tmp, ignore_errors=True)
        state.tmp = None
