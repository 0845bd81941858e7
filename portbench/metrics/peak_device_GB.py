"""``peak_device_GB``: ``torch.cuda.max_memory_allocated()`` over the
window, reset at its start, less what the harness itself holds on the
card through the window (a sort cell's other inputs and kept outputs),
in GB (10^9 bytes): the card memory the system under test takes. Nothing
on the CPU."""


def read(run, record):
    if run.device.type != "cuda":
        return None
    return (record["peak_bytes"] - record["held_bytes"]) / 1e9
