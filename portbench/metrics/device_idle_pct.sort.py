"""``device_idle_pct.sort``: the device's idle share of the bulk sort
cell's traced window: 1 - the union of its operations' intervals / the
window's wall, in percent."""

from portbench import arith


def read(run, record):
    return arith.trace_idle_pct(record)
