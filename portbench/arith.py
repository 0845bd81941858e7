"""The benchmark's metric arithmetic: the card's memory rate, the least
time a byte count allows (after ``chip_smoke.bound``), the union of device
intervals (after ``chip_smoke.device_time``) and per-GB sums."""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12

RECORD_BYTES = 100         # a TeraSort record: 10 B key, 90 B value
# TeraSort words a sorted record moves at the least: its 26 words (104
# bytes) read once and written once, whatever the engine.
SORT_BYTES_PER_RECORD = 2 * 104


def bound_s(nbytes: float) -> float:
    """The least seconds the card could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S


def sort_least_s(records: int) -> float:
    """The least seconds any sort of ``records`` TeraSort records needs on
    the card: each record's words read once and written once."""
    return bound_s(records * SORT_BYTES_PER_RECORD)


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def idle_pct(busy_s: float, window_s: float) -> float:
    """The device's idle share of a window, in percent."""
    return 100.0 * (1.0 - busy_s / window_s)


def per_gb(seconds: float, nbytes: float):
    """Seconds per GB (10^9 bytes); None where no byte moved."""
    return seconds / (nbytes / 1e9) if nbytes > 0 else None


def sort_gb_per_s(record: dict):
    """TeraSort bytes (100 B a record) of every call of a sort window over
    the window, in GB/s; None for a record of another kind."""
    if "sorted_records" not in record:
        return None
    return record["sorted_records"] * RECORD_BYTES / record["window_s"] / 1e9


def sort_roofline_pct(record: dict):
    """The least time any sort of the traced calls' records needs over
    the device time summed over every operation in those calls, in
    percent; None without a trace of the card."""
    tr = record.get("trace")
    if not tr or not tr["device_events"] or "sorted_records" not in tr:
        return None
    return 100.0 * sort_least_s(tr["sorted_records"]) / tr["kernel_s"]


def trace_idle_pct(record: dict):
    """The device's idle share of the traced window, in percent; None
    without a trace of the card."""
    tr = record.get("trace")
    if not tr or not tr["device_events"]:
        return None
    return idle_pct(tr["busy_s"], tr["window_s"])
