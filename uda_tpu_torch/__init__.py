"""uda_tpu_torch — the PyTorch/CUDA port of uda_tpu for NVIDIA Hopper.

A second package beside ``uda_tpu`` (the JAX reference, left as it is).
It imports ``torch``, numpy and the standard library, never ``jax`` or
anything of ``uda_tpu``; what it needs from there it keeps as its own copy.
Module names mirror the reference so each module's counterpart is easy to
find: ``ops/sort.py``, ``ops/pallas_sort.py``, ``ops/pallas_fold.py``,
``models/terasort.py``. The Pallas kernels of the reference are CUDA C++
kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``).

Entry points run on the card (``device=None`` means ``"cuda"``) unless the
caller passes ``device="cpu"``; see ``device.py``.
"""

from uda_tpu_torch.version import __version__

__all__ = ["__version__"]
