"""The port's operator and measurement tools, each run as ``python -m
uda_tpu_torch.tools.<name>``: the tune-cache probe (``tune_probe``), the
consoles over MSG_STATS (``udatop``, ``udafleet``), the critical-path CLI
(``critpath``) and the loopback net smoke (``net_smoke``)."""
