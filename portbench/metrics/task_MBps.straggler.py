"""``task_MBps.straggler``: framed partition bytes handed to the reducer's
consumer per second while one supplier holds each chunk read 300 ms,
every byte received during the window over the window. Read beside the
wire cell's ``task_MBps.reduce``, it is what a straggling node costs a
reduce task once its chunks are hedged to their replicas. A per-layer
reading, as ``task_MBps.reduce`` is: on a shared host the rate of
host-bound reduce tasks spreads too widely between runs to hold a
bound."""


def read(run, record):
    if "consumed_bytes" not in record:
        return None
    return record["consumed_bytes"] / record["window_s"] / 1e6
