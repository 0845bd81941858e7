"""Version of the PyTorch/CUDA port (kept in step with uda_tpu/version.py)."""

__version__ = "0.1.0"
