"""Cross-shard computations of the port: the distinct count, the
dataset-sharded mesh stack, the mesh-sharded fused index, its pod
dispatch tier, and the fleet query plane and multi-process compute
(``dispatch``, also the worker entry ``python -m
sbeacon_tpu_torch.parallel.dispatch``, so it is imported on first use,
not here)."""

from .mesh import (
    Mesh,
    MeshFusedIndex,
    MeshPendingResults,
    StackedIndex,
    aggregate_struct,
    make_mesh,
    mesh_devices,
    mesh_fused,
    local_fused_reference,
)

__all__ = [
    "Mesh",
    "MeshDispatchTier",
    "MeshFusedIndex",
    "MeshPendingResults",
    "StackedIndex",
    "aggregate_struct",
    "local_fused_reference",
    "make_mesh",
    "mesh_devices",
    "mesh_fused",
]


def __getattr__(name):
    if name == "MeshDispatchTier":
        from .dispatch import MeshDispatchTier

        return MeshDispatchTier
    raise AttributeError(name)
