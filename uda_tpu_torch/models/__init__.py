"""Workloads of the port (see uda_tpu_torch/__init__.py)."""
