"""The state carried between the JAX package and the port.

This system has no weights: its state is the records and the engine
knobs. Records cross as ``uint32`` numpy arrays (for example from
``jax.device_get(teragen(...))``) and become device tensors with the same
bits, and back. The engine knobs are read under the reference's names,
``UDA_TPU_SORT_PATH`` and ``UDA_TPU_CHUNK_COLS``, once at import, in
``uda_tpu_torch/ops/sort.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from uda_tpu_torch.device import resolve_device

__all__ = ["words_from_numpy", "words_to_numpy"]


def words_from_numpy(words, device=None) -> torch.Tensor:
    """``uint32`` numpy words -> a ``torch.uint32`` tensor on ``device``
    (``None`` = the card), bit for bit."""
    arr = np.ascontiguousarray(words)
    if arr.dtype != np.uint32:
        raise TypeError(f"records are uint32 words, got {arr.dtype}")
    if not arr.flags.writeable:   # e.g. from jax.device_get: torch may not
        arr = arr.copy()          # share a read-only buffer
    return torch.from_numpy(arr.view(np.int32)).to(
        resolve_device(device)).view(torch.uint32)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """A ``torch.uint32`` tensor on any device -> ``uint32`` numpy."""
    if words.dtype != torch.uint32:
        raise TypeError(f"records are uint32 words, got {words.dtype}")
    return words.view(torch.int32).cpu().numpy().view(np.uint32)
