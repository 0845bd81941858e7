"""Multi-chip data plane of the port (counterpart of ``uda_tpu/parallel``):
the slot mesh and its collectives, the windowed all-to-all exchange (flat,
hierarchical and coded), the bytes exchange behind a job's shuffle across
the mesh, and the distributed sort step. The reference's ``shard_map``
shim is JAX-only and has no counterpart (``parallel/mesh.py``)."""

from uda_tpu_torch.parallel.bytes_exchange import (ExchangeFetchClient,
                                                   exchange_blobs)
from uda_tpu_torch.parallel.distributed import (DistributedSortResult,
                                                distributed_sort_step,
                                                sample_splitters,
                                                uniform_splitters)
from uda_tpu_torch.parallel.exchange import (ShuffleLayout,
                                             exchange_record_batches,
                                             exchange_round, prepare_layout,
                                             resolve_exchange_mode,
                                             shuffle_exchange)
from uda_tpu_torch.parallel.mesh import (SHUFFLE_AXIS, MeshTopology,
                                         make_mesh, mesh_from_config,
                                         mesh_topology, shard_spec)
from uda_tpu_torch.parallel.planner import RoundPlan, WindowPlan, plan_rounds

__all__ = ["DistributedSortResult", "distributed_sort_step",
           "sample_splitters", "uniform_splitters", "ShuffleLayout",
           "exchange_record_batches", "exchange_round", "prepare_layout",
           "resolve_exchange_mode", "shuffle_exchange", "exchange_blobs",
           "ExchangeFetchClient", "SHUFFLE_AXIS", "MeshTopology",
           "make_mesh", "mesh_from_config", "mesh_topology", "shard_spec",
           "RoundPlan", "WindowPlan", "plan_rounds"]
