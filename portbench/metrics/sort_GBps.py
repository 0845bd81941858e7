"""``sort_GBps``: TeraSort bytes (100 B a record) the bulk sort cell
sorted per second, every record of the window's calls over the whole
window."""

from portbench import arith


def read(run, record):
    return arith.sort_gb_per_s(record)
