"""The one place that decides a device.

Entry points take ``device=None``, which means the card (``"cuda"``). Where
there is no card they raise, unless the caller asks for the CPU with
``device="cpu"`` (as the tests do): the port never falls back to the CPU on
its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "generator"]


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"uda_tpu_torch runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "uda_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return dev


def generator(seed: int, device: "str | torch.device | None" = None
              ) -> torch.Generator:
    """A seeded ``torch.Generator`` on the resolved device (the port's
    counterpart of a ``jax.random`` key; the two give different bits)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
