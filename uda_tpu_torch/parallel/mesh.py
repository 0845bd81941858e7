"""The slot mesh, its topology descriptor and the collectives between slots.

Counterpart of ``uda_tpu/parallel/mesh.py``. The reference lays devices
out in a ``jax.sharding.Mesh``, runs one ``shard_map`` body per device and
lets ``lax.all_to_all`` / ``lax.all_gather`` move data between them. The
port has no SPMD compiler, so its :class:`Mesh` is a grid of *slots*:

- a mesh has axis names and a shape, and one slot per position, numbered
  row-major (so on a ``dcn:2,ici:4`` mesh slot ``t`` is pod ``t // 4``,
  chip ``t % 4``, the reference's device linear-index contract);
- each slot carries its ``torch.device``; a process holds a contiguous,
  process-major block of slots (``local_slots``), as the reference's
  ``global_mesh`` puts each process's devices in one block;
- per-slot state is a list of tensors, one per local slot, and a body
  runs once per slot in a Python loop;
- the collectives live here and only here (:meth:`Mesh.all_to_all`,
  :meth:`Mesh.all_gather`, :meth:`Mesh.gather_slots`). Slots of one
  process exchange by tensor copies on their devices (an all-to-all of
  ``[P_src, P_dst, ...]`` blocks is a swap of the first two axes); slots
  in other processes exchange through ``torch.distributed``
  (``all_to_all_single`` with per-process splits, ``all_gather_into_
  tensor``), over gloo on the CPU and NCCL on the card. Data crosses
  processes as bytes: gloo refuses ``uint32``.

:func:`make_mesh` defaults to every visible card. A caller may pass an
explicit ``devices`` list that names one card more than once, one entry
per slot: that is how a host with one card runs an 8-slot mesh, the
counterpart of the reference's 8 forced host devices. It is never a
default. ``device="cpu"`` gives CPU slots (the tests).

The reference's ``shard_map``/``check_vma`` shim
(``uda_tpu/parallel/__init__.py``) is JAX-only and has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import ConfigError

__all__ = ["make_mesh", "mesh_from_config", "shard_spec", "SHUFFLE_AXIS",
           "MeshTopology", "mesh_topology", "is_dcn_axis", "Mesh",
           "RowSharding", "visible_devices"]

SHUFFLE_AXIS = "shuffle"

AxisSpec = Union[str, Tuple[str, ...]]


def is_dcn_axis(name) -> bool:
    """An axis is DCN-tagged by NAME: ``dcn`` or any ``dcn``-prefixed
    name (``dcn``, ``dcn0`` ...). Everything else rides ICI."""
    return str(name).startswith("dcn")


def _axes(axis: AxisSpec) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor the copy and cat paths take: 32-bit words as int32."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


class Mesh:
    """A grid of slots over named axes (see the module docstring).

    ``devices`` are the ``torch.device`` s of this process's slots, in slot
    order; ``shape`` the axis sizes, in the order of ``axis_names``. A mesh
    spread over ``num_processes`` processes (``multihost.global_mesh``)
    holds ``size // num_processes`` slots here, from ``process_index *
    size // num_processes`` on, and moves data between processes through
    the default ``torch.distributed`` process group."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 shape: Sequence[int], process_index: int = 0,
                 num_processes: int = 1, distributed: bool = False):
        names = tuple(str(a) for a in axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"bad mesh axes {names} for shape {sizes}")
        if any(s <= 0 for s in sizes):
            raise ValueError(f"mesh axis sizes must be positive: {sizes}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size = math.prod(sizes)
        if self.size % num_processes:
            raise ValueError(f"{self.size} slots do not split over "
                             f"{num_processes} processes")
        per = self.size // num_processes
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != per:
            raise ValueError(f"{len(self.devices)} devices for the {per} "
                             f"slots of process {process_index}")
        self.process_index = int(process_index)
        self.num_processes = int(num_processes)
        self.distributed = bool(distributed)
        self.local_slots = range(self.process_index * per,
                                 (self.process_index + 1) * per)
        self._groups: dict = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, slots {self.local_slots.start}.."
                f"{self.local_slots.stop - 1} of {self.size} on "
                f"{sorted({str(d) for d in self.devices})})")

    # -- axis groups ----------------------------------------------------------

    def owner(self, slot: int) -> int:
        """The process that holds global slot ``slot``."""
        return slot // len(self.local_slots)

    def axis_size(self, axis: AxisSpec) -> int:
        """Participants of one exchange over ``axis`` (``lax.psum(1,
        axis)``): the product of the NAMED axes only."""
        return math.prod(self.shape[a] for a in _axes(axis))

    def group(self, slot: int, axis: AxisSpec) -> list:
        """The global slots that exchange with ``slot`` over ``axis``, in
        rank order: the named axes vary (linearized in the order named),
        every other coordinate stays ``slot``'s."""
        return self._axis_groups(axis)[0][slot]

    def axis_index(self, slot: int, axis: AxisSpec) -> int:
        """``slot``'s rank in its ``axis`` group (``lax.axis_index``)."""
        return self._axis_groups(axis)[1][slot]

    def _axis_groups(self, axis: AxisSpec) -> tuple:
        key = _axes(axis)
        got = self._groups.get(key)
        if got is not None:
            return got
        missing = [a for a in key if a not in self.shape]
        if missing:
            raise ValueError(f"mesh has axes {self.axis_names}, not "
                             f"{missing}")
        sizes = tuple(self.shape.values())
        pos = {a: i for i, a in enumerate(self.axis_names)}
        sub = tuple(self.shape[a] for a in key)
        groups, ranks = [], []
        for slot in range(self.size):
            coord = list(np.unravel_index(slot, sizes))
            members = []
            for r in range(math.prod(sub)):
                c = list(coord)
                for a, v in zip(key, np.unravel_index(r, sub)):
                    c[pos[a]] = int(v)
                members.append(int(np.ravel_multi_index(c, sizes)))
            groups.append(members)
            ranks.append(members.index(slot))
        self._groups[key] = (groups, ranks)
        return self._groups[key]

    # -- collectives ------------------------------------------------------------

    def all_to_all(self, xs: Sequence[torch.Tensor],
                   axis: AxisSpec) -> list:
        """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
        tiled=False)`` over every local slot at once: ``xs[k]`` is local
        slot k's tensor, its leading dimension the ``axis`` group's size;
        returns ``ys`` with ``ys[k][j]`` = group member j's block for slot
        k, on slot k's device."""
        g = self.axis_size(axis)
        base = self.local_slots.start
        xs = list(xs)
        if len(xs) != len(self.local_slots) or any(
                x.shape[0] != g for x in xs):
            raise ValueError(f"all_to_all over {axis!r} takes one tensor "
                             f"per local slot with leading dimension {g}")
        if self.distributed:
            return self._all_to_all_dist(xs, axis)
        ys = []
        for k, slot in enumerate(self.local_slots):
            r = self.axis_index(slot, axis)
            dev = self.devices[k]
            blocks = [_bits(xs[t - base][r]).to(dev)
                      for t in self.group(slot, axis)]
            ys.append(torch.stack(blocks).view(xs[k].dtype))
        return ys

    def all_gather(self, xs: Sequence[torch.Tensor],
                   axis: AxisSpec) -> list:
        """``lax.all_gather(x, axis, axis=0, tiled=False)``: ``ys[k][j]``
        = group member j's tensor."""
        g = self.axis_size(axis)
        return self.all_to_all([x.unsqueeze(0).expand(g, *x.shape)
                                for x in xs], axis)

    def gather_slots(self, xs: Sequence[torch.Tensor]) -> list:
        """Every global slot's tensor, in slot order, on the CPU: the
        host readback of per-slot results (``multihost.allgather``).
        Across processes the slots' tensors must share a shape."""
        xs = [x.detach() for x in xs]
        if not self.distributed:
            return [x.cpu() for x in xs]
        import torch.distributed as dist

        shapes = {tuple(x.shape) for x in xs}
        if len(shapes) != 1 or len({x.dtype for x in xs}) != 1:
            raise ValueError("gather_slots across processes needs one "
                             "shape and dtype for every slot")
        proto = xs[0]
        # the group's device: gloo takes CPU tensors, NCCL the card's
        local = torch.cat([_bytes_of(x) for x in xs]).to(self.devices[0])
        out = torch.empty(local.numel() * self.num_processes,
                          dtype=torch.uint8, device=local.device)
        dist.all_gather_into_tensor(out, local)
        per = out.cpu().view(self.size, -1)
        return [_from_bytes(per[s], proto) for s in range(self.size)]

    def _all_to_all_dist(self, xs: list, axis: AxisSpec) -> list:
        """The cross-process all-to-all: one ``all_to_all_single`` of
        bytes, each process's send buffer the blocks its slots address to
        that process's slots, in (source slot, rank) order, which the
        receiver enumerates the same way. Every process's own blocks take
        the same route (at world size 1 the whole exchange does)."""
        import torch.distributed as dist

        proto = xs[0][0]
        nbytes = proto.numel() * proto.element_size()
        per = len(self.local_slots)
        base = self.local_slots.start
        send = [[] for _ in range(self.num_processes)]
        for k, slot in enumerate(self.local_slots):
            for j, t in enumerate(self.group(slot, axis)):
                send[self.owner(t)].append(_bytes_of(xs[k][j]))
        recv_from = [[] for _ in range(self.num_processes)]
        for q in range(self.num_processes):
            for t in range(q * per, (q + 1) * per):
                for d in self.group(t, axis):
                    if self.owner(d) == self.process_index:
                        recv_from[q].append((t, d))
        dev = self.devices[0]
        inp = torch.cat([b for blocks in send for b in blocks]).to(dev)
        out = torch.empty(nbytes * sum(len(r) for r in recv_from),
                          dtype=torch.uint8, device=dev)
        dist.all_to_all_single(
            out, inp, output_split_sizes=[nbytes * len(r)
                                          for r in recv_from],
            input_split_sizes=[nbytes * len(b) for b in send])
        ys = [[None] * self.axis_size(axis) for _ in range(per)]
        flat = [pair for r in recv_from for pair in r]
        for i, (t, d) in enumerate(flat):
            block = out[i * nbytes:(i + 1) * nbytes]
            ys[d - base][self.axis_index(t, axis)] = _from_bytes(block,
                                                                 proto)
        return [torch.stack([_bits(b).to(self.devices[k])
                             for b in ys[k]]).view(proto.dtype)
                for k in range(per)]


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    return _bits(x).contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """Bytes back into a tensor shaped and typed like ``proto``."""
    want = torch.int32 if proto.dtype == torch.uint32 else proto.dtype
    return b.contiguous().view(want).reshape(proto.shape).view(proto.dtype)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """How the exchange axes map onto the physical fabric.

    Slot linear index contract: rows sharded over ``(dcn_axis,
    ici_axis)`` land on slots in row-major (pod-major) order, so global
    slot ``t`` is pod ``t // pod_size``, chip ``t % pod_size``."""

    dcn_axis: Optional[str]     # None = no DCN-tagged axis (flat mesh)
    ici_axis: Optional[str]     # the intra-pod axis name (None if flat
    #                             over an untagged multi-axis tuple)
    num_pods: int
    pod_size: int

    @property
    def num_devices(self) -> int:
        return self.num_pods * self.pod_size

    @property
    def hierarchical(self) -> bool:
        """True when the mesh has a real pod structure the two-stage
        exchange can exploit (>1 pod of >1 chip)."""
        return (self.dcn_axis is not None and self.num_pods > 1
                and self.pod_size > 1)

    @property
    def coded_capable(self) -> bool:
        """True when the coded stage-B dispatch can run at all: a real pod
        structure whose pod size keeps the Cauchy-code points inside
        GF(2^8) (pod_size <= 128, ``coding/gfjax``). Whether a window
        codes is the host plan's per-pair decision (``planner``)."""
        return self.hierarchical and self.pod_size <= 128

    def pod_of(self, device_index: int) -> int:
        return int(device_index) // self.pod_size

    def chip_of(self, device_index: int) -> int:
        return int(device_index) % self.pod_size

    def pod_members(self, pod: int) -> range:
        return range(pod * self.pod_size, (pod + 1) * self.pod_size)

    def egress_chip(self, src_pod: int, dst_pod: int) -> int:
        """The one chip of ``src_pod`` that stages the coalesced DCN tile
        for pod pair (src_pod -> dst_pod), and the ingress chip of
        ``dst_pod`` for the same pair; the rotation spreads pairs across
        chips. The round body and the planner both compute this."""
        return (src_pod + dst_pod) % self.pod_size


def mesh_topology(mesh: Mesh, axis: AxisSpec) -> MeshTopology:
    """Classify the exchange axes of ``mesh``: a 2-tuple whose OUTER axis
    is DCN-tagged and whose inner is not is a (pods x chips) hierarchy;
    anything else is one flat exchange group."""
    if isinstance(axis, str):
        return MeshTopology(None, axis, 1, int(mesh.shape[axis]))
    names = tuple(axis)
    if len(names) == 1:
        return MeshTopology(None, names[0], 1, int(mesh.shape[names[0]]))
    if (len(names) == 2 and is_dcn_axis(names[0])
            and not is_dcn_axis(names[1])):
        return MeshTopology(names[0], names[1],
                            int(mesh.shape[names[0]]),
                            int(mesh.shape[names[1]]))
    size = 1
    for n in names:
        size *= int(mesh.shape[n])
    return MeshTopology(None, None, 1, size)


def visible_devices(device=None) -> list:
    """The slots a mesh gets by default: every visible card, or one CPU
    slot for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(num_devices: Optional[int] = None,
              axis: str = SHUFFLE_AXIS,
              devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """1-D mesh of ``num_devices`` slots. ``devices`` names each slot's
    device (one card may stand for several slots); by default the slots
    are every visible card, or ``num_devices`` CPU slots when ``device``
    is ``"cpu"``."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        for d in devs:
            resolve_device(d)
    elif resolve_device(device).type == "cpu":
        devs = [torch.device("cpu")] * (num_devices or 1)
    else:
        devs = visible_devices(device)
    if num_devices is not None:
        if num_devices > len(devs):
            raise ConfigError(
                f"requested {num_devices} devices, have {len(devs)}")
        devs = devs[:num_devices]
    return Mesh(devs, (axis,), (len(devs),))


def mesh_from_config(cfg: Config, devices: Optional[Sequence] = None,
                     device=None) -> Mesh:
    """Mesh from the ``uda.tpu.mesh.shape`` flag: ``'axis:N,axis2:M'``;
    empty = 1-D over all devices. ``'dcn:4,ici:8'`` is 4 pods x 8 chips;
    the outer DCN axis comes first so pods are slot-contiguous. The slots
    come from ``devices`` (one entry per slot, a card may repeat) or the
    visible devices; fewer than the shape needs raises ``ConfigError``."""
    spec = str(cfg.get("uda.tpu.mesh.shape")).strip()
    if not spec:
        return make_mesh(devices=devices, device=device)
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition(":")
        if not size.isdigit():
            raise ConfigError(f"bad mesh spec segment {part!r}")
        names.append(name.strip())
        sizes.append(int(size))
    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_devices(device))
    need = int(np.prod(sizes))
    if need > len(devs):
        raise ConfigError(f"mesh {spec} needs {need} devices, have "
                          f"{len(devs)}")
    return Mesh(devs[:need], tuple(names), tuple(sizes))


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Rows sharded along ``axis`` (the counterpart of
    ``NamedSharding(mesh, PartitionSpec(axis))``): slot ``s`` holds row
    block ``mesh.axis_index(s, axis)`` of a global array; slots that
    differ only in other axes hold the same block."""

    mesh: Mesh
    axis: AxisSpec = SHUFFLE_AXIS

    def block(self, slot: int) -> int:
        return self.mesh.axis_index(slot, self.axis)

    @property
    def num_blocks(self) -> int:
        return self.mesh.axis_size(self.axis)


def shard_spec(mesh: Mesh, axis: AxisSpec = SHUFFLE_AXIS) -> RowSharding:
    """Row sharding along the shuffle axis."""
    return RowSharding(mesh, axis)
