"""The traced run's reading of the card: ``torch.profiler`` over the
measured window, reduced to the device's busy time (the union of its
intervals), the summed device time, the device operations that took
most time and the idle gaps by what the host was doing: the innermost
host operation or program span running in the middle of each gap."""

from __future__ import annotations

import heapq
import time

import torch

from portbench import arith

# profiler activities that are work on the device; ranges such as
# ``gpu_user_annotation`` only project host annotations onto its timeline
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
TRACE_S = 10.0
NAME_CHARS = 120
ANCHOR = "portbench.window"
ANCHOR_END = "portbench.window_end"
NO_HOST_OP = "host, no operation"


class Trace:
    """``torch.profiler`` (host operations and, where there is a card, its
    operations) and the port's own spans (``uda_tpu_torch.utils.
    metrics``) over the first calls or tasks of the measured window: from
    its start to the end of the first call or task that ends ``seconds``
    or more after it (``tick`` after each). That keeps the reading of a
    trace of many short calls inside the run's time limit.

    ``anchor_ns`` and ``anchor_end_ns`` are the host clock's
    ``perf_counter_ns`` at the start of the ``ANCHOR`` range and of the
    ``ANCHOR_END`` range after it: the two tie the program's spans to the
    profiler's clock, whose rate differs from the host clock's by about a
    part in a thousand."""

    def __init__(self, seconds: float = TRACE_S):
        self.seconds = seconds
        self.window_s = None
        self.spans: list = []

    def start(self) -> "Trace":
        from torch.profiler import ProfilerActivity, profile, record_function
        from uda_tpu_torch.utils.metrics import metrics

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._spans_were_on = metrics.record_spans
        metrics.enable_spans()
        self._first_span = len(metrics.spans)
        # a range's start is stamped as it is entered: read the clock
        # just before
        self.anchor_ns = time.perf_counter_ns()
        self._range = record_function(ANCHOR)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    @property
    def active(self) -> bool:
        return self.window_s is None

    def tick(self) -> None:
        """After a call or task: stop once the traced window is long
        enough."""
        if self.active and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        from torch.profiler import record_function
        from uda_tpu_torch.utils.metrics import metrics

        if not self.active:
            return
        self.window_s = time.perf_counter() - self.t0
        self._range.__exit__(None, None, None)
        self.anchor_end_ns = time.perf_counter_ns()
        with record_function(ANCHOR_END):
            pass
        self.prof.stop()
        if not self._spans_were_on:
            metrics.disable_spans()
        self.spans = [(sp["ts"], sp["ts"] + sp["dur"], sp["name"])
                      for sp in metrics.spans[self._first_span:]]
        del metrics.spans[self._first_span:]


def _span_ns(ev) -> tuple:
    if hasattr(ev, "start_ns"):
        start = ev.start_ns()
        return start, start + ev.duration_ns()
    start = ev.start_us() * 1000
    return start, start + ev.duration_us() * 1000


def _is_device(ev) -> bool:
    if hasattr(ev, "activity_type"):
        return ev.activity_type() in DEVICE_ACTIVITIES
    return (ev.device_type() == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation())


def events(prof) -> tuple:
    """(device events, host events) of a profile, each a list of (start
    ns, end ns, name), sorted by start."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start, end = _span_ns(ev)
        (dev if _is_device(ev) else host).append((start, end, ev.name()))
    dev.sort()
    host.sort()
    return dev, host


def profiler_clock(tr, host: list):
    """The map from ``perf_counter`` seconds to the profiler's ns, through
    the two anchor ranges among the ``host`` events; None without them."""
    marks = {h[2]: h[0] for h in host if h[2] in (ANCHOR, ANCHOR_END)}
    if len(marks) != 2:
        return None
    rate = (marks[ANCHOR_END] - marks[ANCHOR]) \
        / (tr.anchor_end_ns - tr.anchor_ns)

    def at(t_s: float) -> int:
        return int(marks[ANCHOR] + (t_s * 1e9 - tr.anchor_ns) * rate)

    return at


def _host_labels(host: list, points: list) -> list:
    """For each time in ``points`` (ascending), the innermost host event
    of ``host`` (sorted by start) that covers it: the latest to start,
    on any thread. Events that end before a point never cover a later
    one, so they leave the heap for good."""
    labels = []
    heap: list = []
    i = 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        labels.append(heap[0][2][:NAME_CHARS] if heap else NO_HOST_OP)
    return labels


def _top(sums: dict) -> list:
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:TOP]]


def summarize(tr: Trace) -> dict:
    """A stopped trace's reading: ``busy_s`` (the union of device
    intervals), ``kernel_s`` (device time summed over operations),
    ``window_s``, and the breakdown's ``device_ops`` and ``idle_gaps``
    (seconds summed by device operation, and by the host operation or
    program span running in the middle of each gap, the 10 largest of
    each)."""
    dev, host = events(tr.prof)
    at = profiler_clock(tr, host)
    host = sorted([h for h in host if h[2] not in (ANCHOR, ANCHOR_END)]
                  + ([(at(a), at(b), name) for a, b, name in tr.spans]
                     if at is not None else []))
    by_op: dict = {}
    kernel_ns = 0
    for start, end, name in dev:
        kernel_ns += end - start
        key = name[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (end - start) / 1e9
    spans = arith.merged((s, e) for s, e, _ in dev)
    busy_ns = sum(e - s for s, e in spans)
    gaps: dict = {}
    if spans:
        lo = min([spans[0][0]] + [h[0] for h in host[:1]])
        hi = max([spans[-1][1]] + [h[1] for h in host])
        edges = [lo] + [x for s in spans for x in s] + [hi]
        holes = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        labels = _host_labels(host, [(a + b) / 2 for a, b in holes])
        for (a, b), label in zip(holes, labels):
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return {"busy_s": busy_ns / 1e9, "kernel_s": kernel_ns / 1e9,
            "window_s": tr.window_s, "device_events": len(dev),
            "device_ops": _top(by_op), "idle_gaps": _top(gaps)}
