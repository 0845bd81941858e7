"""``task_MBps.reduce``: framed partition bytes handed to the reducer's
consumer per second, every byte received during the window over the
window. A per-layer reading: on a shared host the rate of host-bound
reduce tasks spreads too widely between runs to hold a bound."""


def read(run, record):
    if "consumed_bytes" not in record:
        return None
    return record["consumed_bytes"] / record["window_s"] / 1e6
