"""The straggler reduce driver: the wire driver's reduce tasks
(``drivers/reduce_wire.py``: one supplier process a node on 127.0.0.1,
one ``HostRoutingClient`` a task, ``MergeManager.run`` at the
configuration's ``conf``) over map outputs kept on two nodes each, with
the supplier of every node in ``slow_nodes`` holding each chunk read
before it answers.

Set-up writes map ``m``'s output under its primary node ``m //
maps_per_node`` and under the next node, ``(m // maps_per_node + 1) %
nodes``, with the benchmark's writer, starts one supplier a node (a slow
node's with ``slow_supplier_conf`` over ``conf``: the failpoint that
delays its reads) and runs the warm tasks. Each task's entries name both
copies, primary first, as ``MergeManager.fetch_all`` takes replicas; the
reducer's ``Config`` is ``conf`` alone, so a chunk that outlives the
straggler threshold gets a duplicate fetch to the other copy and the
winner keeps the segment.

Each task's record carries the wire driver's ``timers`` and
``counters``: the task's change in each counter of ``COUNTERS`` that the
program registers. ``check`` judges the kept streams against
``reference/reduce_straggler.py`` and, so that the cell cannot pass
without doing what it exists for, counts the window's tasks that won no
speculation race, and their fallbacks. The slow supplier's read backlog
(its reads admitted and not yet answered, read over MSG_STATS) is logged
after each warm task and after the window. ``close`` reaps the suppliers
as the wire driver does.
"""

from __future__ import annotations

import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from portbench import gen, ifile
from portbench.drivers import reduce as local
from portbench.drivers import reduce_wire as wire
from portbench.reference import reduce_straggler as reference

JOB = local.JOB
WON = "fetch.speculation.won"
FALLBACKS = "fallback.signals"
COUNTERS = ("fetch.speculated", WON, "fetch.speculation.lost",
            "fetch.stale_completions", "fetch.hedged.bytes", "fetch.bytes",
            FALLBACKS)
HEDGE_TIMER = "fetch_hedge"
BACKLOG_GAUGES = ("supplier.reads.on_air", "supplier.read.bytes.on_air",
                  "io.batch.inflight", "net.server.inflight")
DROPPED = "supplier.reads.dropped"


def setup(run):
    state = SimpleNamespace(tmp=None, suppliers=[], captured={},
                            timer_log=[], counter_log=[], log=run.log)
    try:
        _setup(run, state)
    except BaseException:
        close(state)
        raise
    return state


def _setup(run, state) -> None:
    from uda_tpu_torch.merger import HostRoutingClient, MergeManager
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.metrics import METRICS_REGISTRY, PORT_TIMERS

    c, t = run.config, run.traffic
    nodes, per = int(c["nodes"]), int(c["maps_per_node"])
    if nodes * per != int(c["maps"]):
        raise ValueError(f"{nodes} nodes x {per} maps is not the "
                         f"configuration's {c['maps']} maps")
    if int(c["replicas"]) != 2 or nodes < 2:
        raise ValueError(f"{c['replicas']} copies on {nodes} nodes: the "
                         f"driver keeps 2 copies on 2 of at least 2 nodes")
    slow = sorted({int(k) for k in c["slow_nodes"]})
    if not slow or not set(slow) < set(range(nodes)):
        raise ValueError(f"slow_nodes {c['slow_nodes']} is not a proper "
                         f"subset of the {nodes} nodes")
    state.counter_names = [n for n in COUNTERS if n in METRICS_REGISTRY]
    state.timed_hedge = HEDGE_TIMER in PORT_TIMERS
    state.tmp = tempfile.mkdtemp(prefix="portbench-straggler-")
    state.parts = gen.tera_partitions(
        run.seed, int(c["maps"]), int(c["records_per_segment"]),
        int(c["reducers"]), int(c["reduce_partition"]))
    dirs = [os.path.join(state.tmp, f"node{k}") for k in range(nodes)]
    start = time.perf_counter()
    mids = []
    for m, rec in enumerate(state.parts):
        mid = ifile.map_id(JOB, m)
        for k in _holders(m, per, nodes):
            ifile.write_map_output(os.path.join(dirs[k], JOB, mid), [rec])
        mids.append(mid)
    written_s = time.perf_counter() - start
    for k, d in enumerate(dirs):
        conf = dict(c["conf"])
        if k in slow:
            conf.update(c["slow_supplier_conf"])
        state.suppliers.append(wire._spawn(d, conf))
    ports = [wire._port_of(p) for p in state.suppliers]
    hosts = [f"127.0.0.1:{p}" for p in ports]
    state.slow_ports = [ports[k] for k in slow]
    run.log(f"{nodes} suppliers listening on 127.0.0.1 ports {ports}, "
            f"pids {[p.pid for p in state.suppliers]}; slow nodes {slow} "
            f"({c['slow_supplier_conf']}); {len(mids)} maps written twice "
            f"in {written_s:.3f} s")
    conf = state.conf = Config(dict(c["conf"]))
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
            timers = wire._timers(now, before)
            if state.timed_hedge:
                timers.setdefault(HEDGE_TIMER + "_time", 0.0)
            state.timer_log.append(timers)
            state.counter_log.append(
                {n: now.get(n, 0.0) - before.get(n, 0.0)
                 for n in state.counter_names})

    state.task = task
    state.entries = [([hosts[k] for k in _holders(m, per, nodes)], mid)
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
    walls, backlogs = [], []
    for _ in range(int(t["warm_tasks"])):
        start = time.perf_counter()
        state.call(local.Sink(state.bufs[-1], 0.0))
        local._sync(dev)
        walls.append(round(time.perf_counter() - start, 3))
        backlogs.append(_backlog(state))
    run.log(f"warm task walls {walls}; races won "
            f"{[x.get(WON) for x in state.counter_log]}; the slow "
            f"suppliers' backlog after each {backlogs}")


def _holders(m: int, per: int, nodes: int) -> list:
    """The nodes that hold map ``m``'s output: its primary, then the
    replica on the next node."""
    primary = m // per
    return [primary, (primary + 1) % nodes]


def _backlog(state) -> list:
    """Each slow supplier's reads in flight, read over MSG_STATS: its
    gauges of ``BACKLOG_GAUGES`` and the reads it dropped unread; None
    for a supplier that did not answer."""
    from uda_tpu_torch.net.client import fetch_remote_stats

    out = []
    for port in state.slow_ports:
        try:
            snap = fetch_remote_stats("127.0.0.1", port, timeout=5.0)
        except Exception:  # noqa: BLE001 - a log line, not a result
            out.append(None)
            continue
        gauges = snap.get("gauges", {})
        read = {g: gauges.get(g, 0) for g in BACKLOG_GAUGES}
        read[DROPPED] = snap.get("counters", {}).get(DROPPED, 0)
        out.append(read)
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
                f"{', '.join(state.counter_names)}: "
                f"{[[x[k] for k in state.counter_names] for x in state.counter_log]}")
    if all("timers" in t for t in rec["tasks"]):
        names = sorted({k for t in rec["tasks"] for k in t["timers"]})
        run.log("the window's timers, summed over its tasks: " + str(
            {k: round(sum(t["timers"].get(k, 0.0) for t in rec["tasks"]), 3)
             for k in names}))
    run.log(f"the slow suppliers' backlog after the window "
            f"{_backlog(state)}")
    _log_races(state, run)
    return rec


def _log_races(state, run) -> None:
    """Which alternates the run's races went to and won on (the counters'
    supplier series), and the straggler threshold that held at the
    window's end: the floor, or the latency percentile where the latency
    histogram records."""
    from uda_tpu_torch.utils.metrics import metrics
    from uda_tpu_torch.utils.retry import SpeculationPolicy

    series = {k: v for k, v in metrics.snapshot().items()
              if k.startswith(("fetch.speculated{", WON + "{"))}
    policy = SpeculationPolicy.from_config(state.conf)
    run.log(f"the run's races by alternate {series}; the threshold at the "
            f"window's end {policy.threshold_ms():.3f} ms (floor "
            f"{policy.floor_ms:g} ms, p{policy.pn} of "
            f"{metrics.percentile('fetch.latency_ms', float(policy.pn))})")


def check(state, run, record) -> dict:
    """Every kept stream against the reference's stable merge of the
    partitions the benchmark made, and every task of the window against
    what the cell exists for: at least one speculation race won, no
    fallback (a task without counters counts as one that won none)."""
    want = reference.merged_records(state.parts)
    # a window that reached no sampled task has nothing judged
    bad = 0 if state.captured else want.shape[0]
    for got in state.captured.values():
        bad += reference.records_out_of_place(want, got)
    run.log(f"judged the streams of tasks {sorted(state.captured)}")
    counted = [t.get("counters") for t in record["tasks"]]
    unhedged = sum(x is None or not x.get(WON) for x in counted)
    return {"records_out_of_place": (bad, 0),
            "tasks_unhedged": (unhedged, 0),
            "fallbacks": (int(sum(x.get(FALLBACKS, 0) for x in counted
                                  if x)), 0)}


def close(state) -> None:
    """Stop every supplier and remove the map outputs as the wire driver
    does."""
    wire.close(state)
