"""``sort_kernels_roofline``: of the bulk sort cell's traced calls, the
least time any sort of their records needs on the card (each record's
104 bytes read once and written once, at the memory rate) over the
device time summed over every operation in them, in percent. The count
depends on the records alone, never on the engine, its tiles or its
passes."""

from portbench import arith


def read(run, record):
    return arith.sort_roofline_pct(record)
