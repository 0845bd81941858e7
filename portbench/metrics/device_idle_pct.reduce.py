"""``device_idle_pct.reduce``: the device's idle share of the reduce
cell's traced window, as ``device_idle_pct.sort``."""

from portbench import arith


def read(run, record):
    return arith.trace_idle_pct(record)
