"""The port's slot mesh (uda_tpu_torch.parallel.mesh) against the JAX
package's: the topology descriptor over 1-D, ``dcn:2,ici:4`` and untagged
meshes, ``egress_chip``, ``mesh_from_config``'s decisions and refusals,
and the mesh layer's collectives against their definitions."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.parallel import mesh as jmesh
from uda_tpu.utils import errors as jerrors
from uda_tpu.utils.config import Config as JConfig
from uda_tpu_torch.parallel import mesh as tmesh
from uda_tpu_torch.parallel import multihost as tmh
from uda_tpu_torch.utils import errors
from uda_tpu_torch.utils.config import Config

CPU8 = ["cpu"] * 8
SHAPES = [(("shuffle",), (8,), "shuffle"),
          (("dcn", "ici"), (2, 4), ("dcn", "ici")),
          (("dcn", "ici"), (4, 2), ("dcn", "ici")),
          (("dcn", "ici"), (2, 4), "ici"),
          (("dcn", "ici"), (2, 4), ("ici",)),
          (("a", "b"), (2, 4), ("a", "b")),
          (("dcn0", "x"), (8, 1), ("dcn0", "x")),
          (("ici", "dcn"), (4, 2), ("ici", "dcn"))]


def _both(names, sizes):
    j = JMesh(np.asarray(jax.devices()[:8]).reshape(sizes), names)
    t = tmesh.Mesh(CPU8, names, sizes)
    return j, t


@pytest.mark.parametrize("names,sizes,axis", SHAPES)
def test_topology_matches_the_reference(names, sizes, axis):
    j, t = _both(names, sizes)
    jt, tt = jmesh.mesh_topology(j, axis), tmesh.mesh_topology(t, axis)
    assert dataclass_fields(jt) == dataclass_fields(tt)
    for prop in ("num_devices", "hierarchical", "coded_capable"):
        assert getattr(jt, prop) == getattr(tt, prop), prop
    for d in range(tt.num_devices):
        assert (jt.pod_of(d), jt.chip_of(d)) == (tt.pod_of(d), tt.chip_of(d))
    for g in range(tt.num_pods):
        assert list(jt.pod_members(g)) == list(tt.pod_members(g))
        for g2 in range(tt.num_pods):
            assert jt.egress_chip(g, g2) == tt.egress_chip(g, g2)


def dataclass_fields(topo) -> tuple:
    return (topo.dcn_axis, topo.ici_axis, topo.num_pods, topo.pod_size)


@pytest.mark.parametrize("name", ["dcn", "dcn0", "dcnx", "ici", "shuffle",
                                  "xdcn", ""])
def test_dcn_tagging(name):
    assert tmesh.is_dcn_axis(name) == jmesh.is_dcn_axis(name)


@pytest.mark.parametrize("spec", ["", "shuffle:8", "dcn:2,ici:4",
                                  "dcn:4,ici:2", "a:2,b:2,c:2", "x:3",
                                  "dcn:4,ici:4", "dcn:2,ici", "dcn:a",
                                  "x:16"])
def test_mesh_from_config_matches_the_reference(spec):
    """The same axes and shape, or the same refusal, from the same key:
    the port's slots are 8 CPU slots passed as ``devices``, the
    reference's its 8 host devices."""
    try:
        want = jmesh.mesh_from_config(JConfig({"uda.tpu.mesh.shape": spec}))
    except jerrors.ConfigError as e:
        with pytest.raises(errors.ConfigError) as got:
            tmesh.mesh_from_config(Config({"uda.tpu.mesh.shape": spec}),
                                   devices=CPU8)
        assert str(got.value) == str(e)
        return
    got = tmesh.mesh_from_config(Config({"uda.tpu.mesh.shape": spec}),
                                 devices=CPU8)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.devices == [torch.device("cpu")] * got.size


def test_mesh_from_config_refuses_too_few_slots():
    """Without ``devices`` the CPU has one slot: a shape that needs more
    raises, as the reference does when it has too few devices."""
    with pytest.raises(errors.ConfigError, match="needs 8 devices, have 1"):
        tmesh.mesh_from_config(Config({"uda.tpu.mesh.shape": "dcn:2,ici:4"}),
                               device="cpu")
    with pytest.raises(errors.ConfigError, match="needs 8 devices, have 4"):
        tmesh.mesh_from_config(Config({"uda.tpu.mesh.shape": "dcn:2,ici:4"}),
                               devices=["cpu"] * 4)


def test_make_mesh_slots_and_refusal():
    m = tmesh.make_mesh(8, device="cpu")
    assert m.shape == {"shuffle": 8} and len(m.local_slots) == 8
    assert tmesh.make_mesh(4, "x", devices=CPU8).shape == {"x": 4}
    with pytest.raises(errors.ConfigError, match="requested 9 devices, "
                                                 "have 8"):
        tmesh.make_mesh(9, devices=CPU8)
    with pytest.raises(jerrors.ConfigError, match="requested 9 devices, "
                                                  "have 8"):
        jmesh.make_mesh(9)
    spec = tmesh.shard_spec(m)
    assert spec.num_blocks == 8 and spec.block(3) == 3


@pytest.mark.parametrize("names,sizes,axis", SHAPES)
def test_groups_follow_axis_index(names, sizes, axis):
    """A slot's group over ``axis`` varies the named axes only, in rank
    order, and its rank is its linearized coordinate over them (the
    ``lax.axis_index`` of a row-major device grid)."""
    t = tmesh.Mesh(CPU8, names, sizes)
    grid = np.arange(8).reshape(sizes)
    axes = (axis,) if isinstance(axis, str) else axis
    for slot in range(8):
        coord = np.unravel_index(slot, sizes)
        sub = [t.shape[a] for a in axes]
        want = []
        for r in range(int(np.prod(sub))):
            c = list(coord)
            for a, v in zip(axes, np.unravel_index(r, sub)):
                c[names.index(a)] = v
            want.append(int(grid[tuple(c)]))
        assert t.group(slot, axis) == want
        assert t.axis_index(slot, axis) == want.index(slot)


@pytest.mark.parametrize("axis", ["dcn", "ici", ("dcn", "ici")])
def test_all_to_all_and_all_gather(axis):
    """``ys[k][j]`` is group member j's block k-rank, and the all-gather
    stacks the group's tensors, on a 2x4 mesh."""
    t = tmesh.Mesh(CPU8, ("dcn", "ici"), (2, 4))
    g = t.axis_size(axis)
    xs = [(torch.arange(g * 3, dtype=torch.int32) + 100 * s)
          .reshape(g, 3).view(torch.uint32) for s in range(8)]
    ys = t.all_to_all(xs, axis)
    gs = t.all_gather([x[0] for x in xs], axis)
    for s in range(8):
        grp = t.group(s, axis)
        r = t.axis_index(s, axis)
        assert ys[s].dtype == torch.uint32
        for j, peer in enumerate(grp):
            assert torch.equal(ys[s][j].view(torch.int32),
                               xs[peer][r].view(torch.int32))
            assert torch.equal(gs[s][j].view(torch.int32),
                               xs[peer][0].view(torch.int32))


def test_row_placement_matches_the_reference_sharding():
    """``put_rows`` gives slot s the row block the reference's
    ``NamedSharding(mesh, P(axis))`` puts on device s, and ``allgather``
    returns the global array."""
    words = np.arange(8 * 6 * 2, dtype=np.uint32).reshape(48, 2)
    t = tmesh.make_mesh(8, device="cpu")
    blocks = tmh.put_rows(words, t)
    assert [b.shape for b in blocks] == [(6, 2)] * 8
    assert np.array_equal(tmh.allgather(t, blocks), words)
    j = jmesh.make_mesh(8)
    arr = jax.device_put(words, jmesh.shard_spec(j))
    for s, shard in enumerate(sorted(arr.addressable_shards,
                                     key=lambda sh: sh.index[0].start)):
        assert np.array_equal(np.asarray(shard.data),
                              tmh.allgather(t, [blocks[s]]))
    with pytest.raises(ValueError, match="equal blocks"):
        tmh.put_rows(words[:47], t)
