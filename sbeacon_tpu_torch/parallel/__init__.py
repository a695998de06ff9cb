"""Cross-shard computations of the port: the distinct count, the
dataset-sharded mesh stack, the mesh-sharded fused index and its pod
dispatch tier."""

from .dispatch import MeshDispatchTier
from .mesh import (
    Mesh,
    MeshFusedIndex,
    MeshPendingResults,
    StackedIndex,
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
    "local_fused_reference",
    "make_mesh",
    "mesh_devices",
    "mesh_fused",
]
