"""Multi-process wiring for the distributed exchange, on ``torch.distributed``.

Counterpart of ``uda_tpu/parallel/multihost.py``. The reference joins
processes with ``jax.distributed`` and builds global arrays whose shards
live on every process's devices. Here a process group joins the
processes (gloo on the CPU, NCCL on the card), the mesh covers every
process's slots in process-major blocks, and per-slot state stays a list
of tensors, one per local slot:

- ``initialize``: ``init_process_group`` at ``tcp://<address>``;
- ``global_mesh`` / ``global_mesh_2axis``: a mesh over every process's
  slots (the process is the outer ``dcn`` axis of the 2-axis form);
- ``put_global`` / ``put_rows`` / ``zeros_global`` / ``shard_rows`` /
  ``replicate``: per-slot lists from a global array, from each process's
  own rows, or zeros, without a global buffer on any process;
- ``allgather``: every slot's tensor back on every process as one numpy
  array (the validation path).

Nothing on the card's host tells a program of a cluster: the caller gives
the address, the world size and its rank. NCCL cannot put two ranks on one
card, so a host with one card runs the multi-process path at world size 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.parallel.mesh import (SHUFFLE_AXIS, Mesh, RowSharding,
                                         _bits, visible_devices)

__all__ = ["initialize", "global_mesh", "global_mesh_2axis", "shard_rows",
           "replicate", "allgather", "put_global", "put_rows",
           "zeros_global"]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=None, timeout_s: float = 120.0
               ) -> None:
    """Join the process group: process 0 serves the rendezvous at
    ``coordinator_address`` (host:port), every process connects to it.
    The backend is gloo for ``device="cpu"`` and NCCL on the card."""
    import datetime

    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(
        backend="gloo" if dev.type == "cpu" else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def _local_devices(devices: Optional[Sequence], device) -> list:
    return ([torch.device(d) for d in devices] if devices is not None
            else visible_devices(device))


def _world() -> tuple:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("call multihost.initialize first")
    return dist.get_rank(), dist.get_world_size()


def _check_even(n_local: int, nproc: int) -> None:
    """Every process must hold as many slots as the others."""
    import torch.distributed as dist

    counts = [None] * nproc
    dist.all_gather_object(counts, n_local)
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold {counts} slots; uneven "
                         "per-process slot counts are not supported")


def global_mesh(axis: str = SHUFFLE_AXIS, devices: Optional[Sequence] = None,
                device=None) -> Mesh:
    """1-D mesh over every process's slots, process-major. ``devices``
    are this process's slots (one card may repeat); by default its
    visible cards."""
    rank, world = _world()
    devs = _local_devices(devices, device)
    _check_even(len(devs), world)
    return Mesh(devs, (axis,), (len(devs) * world,), rank, world,
                distributed=True)


def global_mesh_2axis(dcn_axis: str = "dcn", ici_axis: str = SHUFFLE_AXIS,
                      devices: Optional[Sequence] = None,
                      device=None) -> Mesh:
    """The deployment-shaped 2-axis mesh: the PROCESS boundary is the
    outer (DCN) axis, each process's slots the inner (ICI) axis."""
    rank, world = _world()
    devs = _local_devices(devices, device)
    _check_even(len(devs), world)
    return Mesh(devs, (dcn_axis, ici_axis), (world, len(devs)), rank,
                world, distributed=True)


def _to_slot(arr, device: torch.device) -> torch.Tensor:
    """numpy or a tensor -> a tensor on ``device`` with the same bits."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).to(device).view(
            torch.uint32)
    return torch.from_numpy(arr).to(device)


def put_global(arr, sharding: RowSharding) -> list:
    """Per-slot row blocks of a GLOBAL array (numpy or a tensor): slot s
    gets block ``sharding.block(s)`` of ``sharding.num_blocks`` equal
    blocks, on its device. On one card the blocks of a tensor already
    there are views, not copies."""
    mesh = sharding.mesh
    n = int(arr.shape[0])
    g = sharding.num_blocks
    if n % g:
        raise ValueError(f"{n} rows do not split into {g} equal blocks "
                         f"over {sharding.axis!r}")
    rows = n // g
    out = []
    for k, slot in enumerate(mesh.local_slots):
        b = sharding.block(slot)
        out.append(_to_slot(arr[b * rows:(b + 1) * rows], mesh.devices[k]))
    return out


def put_rows(words, mesh: Mesh, axis=SHUFFLE_AXIS) -> list:
    """Row-shard a GLOBAL array onto the mesh. A per-slot list (one
    tensor per local slot, e.g. from :func:`shard_rows`) passes through."""
    if isinstance(words, (list, tuple)):
        if len(words) != len(mesh.local_slots):
            raise ValueError(f"{len(words)} blocks for "
                             f"{len(mesh.local_slots)} local slots")
        return [_to_slot(w, mesh.devices[k]) for k, w in enumerate(words)]
    return put_global(words, RowSharding(mesh, axis))


def zeros_global(shape, dtype: torch.dtype, sharding: RowSharding) -> list:
    """Per-slot zero blocks of a global ``shape`` row-sharded over
    ``sharding``, without a global buffer anywhere."""
    g = sharding.num_blocks
    if shape[0] % g:
        raise ValueError(f"{shape[0]} rows do not split into {g} blocks")
    block = (shape[0] // g, *shape[1:])
    want = torch.int32 if dtype == torch.uint32 else dtype
    return [torch.zeros(block, dtype=want, device=d).view(dtype)
            for d in sharding.mesh.devices]


def shard_rows(local_rows, mesh: Mesh, axis=SHUFFLE_AXIS) -> list:
    """Per-slot blocks from THIS process's row block (every process
    passes its own rows; the global row count is the sum): the local rows
    split evenly over the local slots."""
    n = int(local_rows.shape[0])
    per = len(mesh.local_slots)
    if n % per:
        raise ValueError(f"{n} local rows do not split over {per} slots")
    rows = n // per
    return [_to_slot(local_rows[k * rows:(k + 1) * rows], mesh.devices[k])
            for k in range(per)]


def replicate(arr, mesh: Mesh) -> list:
    """The same array on every local slot (identical per-process data)."""
    return [_to_slot(arr, d) for d in mesh.devices]


def allgather(mesh: Mesh, xs: Sequence[torch.Tensor],
              axis=None) -> np.ndarray:
    """Every slot's tensor, concatenated in slot order along dim 0, as
    numpy on every process (``uint32`` stays ``uint32``). With ``axis``
    naming fewer axes than the mesh has, the slots that differ only in
    the others hold replicas: one replica's blocks come back, in rank
    order (the reference's output sharded along ``axis``)."""
    parts = mesh.gather_slots(xs)
    if axis is not None and mesh.axis_size(axis) < mesh.size:
        parts = [parts[t] for t in mesh.group(0, axis)]
    if not parts:
        return np.zeros(0)
    dtype = parts[0].dtype
    cat = torch.cat([_bits(p) for p in parts]).numpy()
    return cat.view(np.uint32) if dtype == torch.uint32 else cat
