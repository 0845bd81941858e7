"""The sort driver: a closed loop of one client sorting TeraSort records
on the card through ``uda_tpu_torch.models.terasort.single_chip_sort(
words, "auto")``.

Traffic parameters: ``call_rows`` (the records of each call, in turn),
``inputs`` (distinct input batches made on the card in set-up and used
in turn, so that no call sees the previous call's input; input i holds
``call_rows[i % len(call_rows)]`` records), ``warm_calls`` (calls on each
input at set-up) and ``sample_calls`` of the window's first
``sample_from`` calls, drawn from the seed in equal numbers from each
size, whose outputs are kept and judged after the window.

A call counts once its output is complete on the card (the client
synchronises). The window closes at the end of the first call that ends
at or after ``--seconds``; ``sorted_records`` counts every record of the
window's calls.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import gen, trace
from portbench.reference import sort as reference

KERNELS = {"K1": "merge_pass", "K1 partition": "merge_partition",
           "K2": "tile_sort", "K3": "tile_sort_folded",
           "K4": "merge_pass_folded", "K5": "take_lanes"}


def setup(run):
    from uda_tpu_torch.models import terasort
    from uda_tpu_torch.ops import sort as sort_ops

    t = run.traffic
    rows = [int(r) for r in t["call_rows"]]
    dev = run.device
    g = gen.card_generator(run.seed, dev)
    inputs = [gen.teragen(g, rows[i % len(rows)])
              for i in range(int(t["inputs"]))]
    for n in sorted(set(rows)):
        engine = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev)
        run.log(f'"auto" routes {n} records to {engine}')
    state = SimpleNamespace(
        inputs=inputs, kept=[],
        call=lambda words: terasort.single_chip_sort(words, "auto",
                                                     device=dev))
    # the kept calls: as many of each size as of the others, so that every
    # seed keeps the same bytes
    rng = np.random.default_rng(gen.seed64(run.seed))
    state.sample = set()
    for r in range(len(rows)):
        state.sample.update(int(i) for i in rng.choice(
            np.arange(r, int(t["sample_from"]), len(rows)),
            int(t["sample_calls"]) // len(rows), replace=False))
    for _ in range(int(t["warm_calls"])):
        for words in inputs:
            state.call(words)
            _sync(dev)
    return state


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(state, run) -> dict:
    from uda_tpu_torch.ops import _build

    dev = run.device
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    kept = []
    calls = 0
    records = 0
    traced_records = 0
    tr = trace.Trace().start() if run.trace else None
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        i = calls % len(state.inputs)
        words = state.inputs[i]
        with torch.profiler.record_function("portbench.sort_call"):
            out = state.call(words)
            _sync(dev)
        end = time.perf_counter()
        if calls in state.sample:
            kept.append((i, out))
        del out
        calls += 1
        records += int(words.shape[0])
        if tr is not None and tr.active:
            traced_records = records
            tr.tick()
        if end >= deadline:
            break
    window_s = end - t0
    if tr is not None:
        tr.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # what the harness holds on the card beside a call, in the peak too:
    # the inputs other than the call's and the kept outputs
    sizes = [w.numel() * w.element_size() for w in state.inputs]
    held = sum(sizes) - max(sizes) + sum(o.numel() * o.element_size()
                                         for _, o in kept)
    launches = {k: _build.launches[v] for k, v in KERNELS.items()}
    run.log(f"window {window_s:.3f} s, {calls} calls, {records} records; "
            f"peak {peak} B, {held} B of it held by the harness; "
            f"launches {launches}")
    state.kept = kept
    rec = {"window_s": window_s, "attempted": calls, "failed": 0,
           "sorted_records": records, "peak_bytes": peak,
           "held_bytes": held, "launches": launches}
    if tr is not None:
        rec["trace"] = trace.summarize(tr)
        rec["trace"]["sorted_records"] = traced_records
    return rec


def check(state, run, record) -> dict:
    """Every kept output against the reference's stable whole-key order of
    its input."""
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    # a window too short to reach a sampled call has nothing to judge:
    # every record of the first input counts as not judged, so not correct
    bad = 0 if state.kept else int(state.inputs[0].shape[0])
    for i, out in state.kept:
        bad += reference.records_out_of_place(state.inputs[i], out)
    run.log(f"judged the outputs of {len(state.kept)} calls")
    state.kept = []
    return {"records_out_of_place": (bad, 0)}


def close(state) -> None:
    state.inputs = []
    state.kept = []
