"""The dead-supplier reduce driver: the wire driver's reduce tasks
(``drivers/reduce_wire.py``: one supplier process a node on 127.0.0.1,
one ``HostRoutingClient`` a task, ``MergeManager.run`` at the default
``Config``) over map outputs erasure-coded across the nodes, with the
supplier of every node in ``dead_nodes`` killed before the warm tasks and
never restarted.

Set-up starts one supplier a node over the node's directory, learns the
ports and writes every map with the port's ``mofserver.
write_striped_map_output`` under the configuration's ``coding_scheme``,
over the node directories in the reducer's canonical order (the sorted
``127.0.0.1:<port>`` strings), so that the writer and the reducer derive
one placement: map ``m``'s primary is node ``m // maps_per_node``, chunk
``i`` of its stripe on the ``i``-th supplier after it in that order. A
supplier's resolver reads a map's index when it is asked for it, so the
files written after it listens are served. Then set-up SIGKILLs and
reaps the dead nodes' suppliers and runs the warm tasks. The entries
still name each dead node's maps on that node, as Hadoop's
map-completion events would: every task meets the refused dials, spends
its retries and rebuilds those partitions from shards on the live nodes.

Each task's record carries the wire driver's ``timers`` and
``counters``: the task's change in each counter of ``COUNTERS`` (a
labelled one summed over its series). ``check`` judges the kept streams
against ``reference/reduce_dead.py`` and, so that the cell cannot pass
without doing what it exists for, counts the window's tasks that did not
rebuild one partition a dead node's map, and their recovery failures and
fallbacks. ``close`` reaps the live suppliers as the wire driver does.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

from portbench import gen, ifile
from portbench.drivers import reduce as local
from portbench.drivers import reduce_wire as wire
from portbench.reference import reduce_dead as reference

JOB = local.JOB
REBUILT = "coding.reconstructed.partitions"
FAILURES = "coding.recover.failures"
FALLBACKS = "fallback.signals"
COUNTERS = (REBUILT, FAILURES, FALLBACKS, "coding.shard.fetches",
            "coding.reconstructed.bytes")
_KEY_AT = 2     # a framed record's serialized Text key follows 2 vints


def setup(run):
    state = SimpleNamespace(tmp=None, suppliers=[], dead=[], captured={},
                            timer_log=[], counter_log=[], log=run.log)
    try:
        _setup(run, state)
    except BaseException:
        close(state)
        raise
    return state


def _setup(run, state) -> None:
    from uda_tpu_torch.coding import parse_scheme
    from uda_tpu_torch.merger import HostRoutingClient, MergeManager
    from uda_tpu_torch.mofserver import write_striped_map_output
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.errors import FallbackSignal

    c, t = run.config, run.traffic
    nodes, per = int(c["nodes"]), int(c["maps_per_node"])
    if nodes * per != int(c["maps"]):
        raise ValueError(f"{nodes} nodes x {per} maps is not the "
                         f"configuration's {c['maps']} maps")
    dead = sorted({int(k) for k in c["dead_nodes"]})
    if not dead or not set(dead) < set(range(nodes)):
        raise ValueError(f"dead_nodes {c['dead_nodes']} is not a proper "
                         f"subset of the {nodes} nodes")
    scheme = parse_scheme(c["coding_scheme"])
    state.tmp = tempfile.mkdtemp(prefix="portbench-dead-")
    state.parts = gen.tera_partitions(
        run.seed, int(c["maps"]), int(c["records_per_segment"]),
        int(c["reducers"]), int(c["reduce_partition"]))
    dirs = [os.path.join(state.tmp, f"node{k}") for k in range(nodes)]
    for d in dirs:
        os.makedirs(d)
        state.suppliers.append(wire._spawn(d, c["conf"]))
    ports = [wire._port_of(p) for p in state.suppliers]
    hosts = [f"127.0.0.1:{p}" for p in ports]
    canonical = sorted(range(nodes), key=lambda k: hosts[k])
    at = {k: i for i, k in enumerate(canonical)}
    roots = [dirs[k] for k in canonical]
    start = time.perf_counter()
    mids = []
    for m, rec in enumerate(state.parts):
        mid = ifile.map_id(JOB, m)
        write_striped_map_output(roots, at[m // per], JOB, mid,
                                 [_pairs(rec)], scheme)
        mids.append(mid)
    run.log(f"{nodes} suppliers listening on 127.0.0.1 ports {ports}, "
            f"pids {[p.pid for p in state.suppliers]}; {len(mids)} maps "
            f"written {scheme} in {time.perf_counter() - start:.3f} s, "
            f"primaries in sorted host order {canonical}")
    for k in dead:
        proc = state.suppliers[k]
        proc.kill()
        proc.wait(timeout=wire.STOP_S)
        state.dead.append(proc)
    state.suppliers = [p for k, p in enumerate(state.suppliers)
                       if k not in dead]
    run.log(f"killed the suppliers of nodes {dead} (pids "
            f"{[p.pid for p in state.dead]}, exit codes "
            f"{[p.returncode for p in state.dead]})")
    state.rebuilt = len(dead) * per
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
            now = metrics.snapshot()
            state.timer_log.append(wire._timers(now, before))
            state.counter_log.append(_counters(now, before))

    state.task = task
    state.entries = [([hosts[m // per]], mid) for m, mid in enumerate(mids)]
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
        try:
            state.call(local.Sink(state.bufs[-1], 0.0))
        except FallbackSignal:
            # the window's tasks fall back too, and fail the run there
            traceback.print_exc()
        local._sync(dev)
        walls.append(round(time.perf_counter() - start, 3))
    run.log(f"warm task walls {walls}; their reconstructions "
            f"{[c[REBUILT] for c in state.counter_log]}")


def _pairs(rec: np.ndarray) -> list:
    """One partition's framed records as the port's writer takes them:
    (serialized Text key, serialized Text value) pairs."""
    n, width = rec.shape
    klen = int(rec[0, 0])
    vlen = width - _KEY_AT - klen
    if n and not ((rec[:, 0] == klen).all() and (rec[:, 1] == vlen).all()):
        raise ValueError("records are not of one framing")
    keys = rec[:, _KEY_AT:_KEY_AT + klen].tobytes()
    values = rec[:, _KEY_AT + klen:].tobytes()
    return [(keys[i * klen:(i + 1) * klen], values[i * vlen:(i + 1) * vlen])
            for i in range(n)]


def _counters(now: dict, then: dict) -> dict:
    """The change of each counter of ``COUNTERS``, summed over its
    labelled series where it has any."""
    out = {}
    for name in COUNTERS:
        keys = [k for k in now if k.startswith(name + "{")] or [name]
        out[name] = sum(now.get(k, 0.0) - then.get(k, 0.0) for k in keys)
    return out


def measure(state, run) -> dict:
    """The wire driver's window; each task's record also gets its
    counters where every task of the window ran through ``state.task``."""
    state.counter_log.clear()
    rec = wire.measure(state, run)
    if len(state.counter_log) == len(rec["tasks"]):
        for task, counters in zip(rec["tasks"], state.counter_log):
            task["counters"] = counters
        run.log(f"the window's tasks' changes in "
                f"{', '.join(COUNTERS)}: "
                f"{[[c[k] for k in COUNTERS] for c in state.counter_log]}")
    if all("timers" in t for t in rec["tasks"]):
        names = sorted({k for t in rec["tasks"] for k in t["timers"]})
        run.log("the window's timers, summed over its tasks: " + str(
            {k: round(sum(t["timers"].get(k, 0.0) for t in rec["tasks"]), 3)
             for k in names}))
    return rec


def check(state, run, record) -> dict:
    """Every kept stream against the reference's stable merge of the
    partitions the benchmark made, and every task of the window against
    what the dead nodes owe it: ``state.rebuilt`` partitions rebuilt, no
    recovery failure, no fallback (a task without counters counts as
    one that rebuilt none)."""
    want = reference.merged_records(state.parts)
    # a window that reached no sampled task has nothing judged
    bad = 0 if state.captured else want.shape[0]
    for got in state.captured.values():
        bad += reference.records_out_of_place(want, got)
    run.log(f"judged the streams of tasks {sorted(state.captured)}")
    counted = [t.get("counters") for t in record["tasks"]]
    amiss = sum(c is None or c[REBUILT] != state.rebuilt for c in counted)
    return {"records_out_of_place": (bad, 0),
            "tasks_rebuilt_otherwise": (amiss, 0),
            "recover_failures": (int(sum(c[FAILURES] for c in counted
                                         if c)), 0),
            "fallbacks": (int(sum(c[FALLBACKS] for c in counted if c)), 0)}


def close(state) -> None:
    """Close the killed suppliers' pipes, then stop the live ones and
    remove the map outputs as the wire driver does."""
    for proc in state.dead:
        proc.stdin.close()
        proc.stdout.close()
    wire.close(state)
