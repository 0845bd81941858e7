"""The lane gather ``out[:, j] = x[:, perm[j]]`` on ``uint32[rows, n]``.

Counterpart of the one ``pl.pallas_call`` of ``scripts/probe_gather.py``
(kernel K5): a Mosaic lowering probe whose four kernel bodies compute this
function, the in-kernel payload gather of the reference's two-phase merge.
The kernel is CUDA C++ (``uda_tpu_torch/csrc/lane_gather.cu``). The wrapper
launches it on a CUDA tensor and runs the plain PyTorch version on a CPU
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from uda_tpu_torch.ops import _build
from uda_tpu_torch.ops.sort import take_cols

__all__ = ["take_lanes", "take_lanes_plain"]

_C = ctypes
_SIGNATURES = {
    "uda_lane_gather": ([_C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int,
                         _C.c_size_t, _C.c_void_p], _C.c_int),
}


def _check(x: torch.Tensor, perm: torch.Tensor) -> None:
    if perm.dtype != torch.int32 or perm.dim() != 1 \
            or perm.shape[0] != x.shape[-1]:
        raise ValueError(f"perm must be int32[{x.shape[-1]}], got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if perm.device != x.device:
        raise ValueError(f"perm on {perm.device}, x on {x.device}")
    # the kernel reads x where perm points, unchecked: refuse an index
    # outside [0, n) on either device (one host sync; K5 is on no hot path)
    n = x.shape[-1]
    if n and (int(perm.min()) < 0 or int(perm.max()) >= n):
        raise IndexError(f"perm values must lie in [0, {n})")


def take_lanes_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: ``x[:, perm]`` through ``int32`` views."""
    _check(x, perm)
    return take_cols(x, perm.long())


def take_lanes(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """K5 (replaces ``scripts/probe_gather.py``'s ``pl.pallas_call``):
    ``out[r, j] = x[r, perm[j]]`` for a uint32[rows, n] ``x`` and an
    int32[n] ``perm`` whose values lie in [0, n). The kernel on a CUDA
    tensor, :func:`take_lanes_plain` on a CPU one."""
    if x.device.type == "cpu":
        return take_lanes_plain(x, perm)
    rows, n = _build.cuda_words(x).shape
    _check(x, perm)
    perm = perm.contiguous()
    out = torch.empty_like(x)
    if rows and n:
        lib = _build.library("lane_gather", _SIGNATURES)
        with torch.cuda.device(x.device):
            _build.launch(lib, "uda_lane_gather", x.data_ptr(),
                          perm.data_ptr(), out.data_ptr(), rows, n,
                          _build.stream_of(x))
        _build.count("take_lanes")
    return out
