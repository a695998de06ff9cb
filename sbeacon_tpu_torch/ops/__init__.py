"""Device indexes and query dispatch.

Counterpart of ``sbeacon_tpu/ops/__init__.py``. A single shard's serving
index is a ``ScatterDeviceIndex`` (the scatter match kernel); the fused
stack of all warm shards is a ``FusedDeviceIndex`` (the bisection query
kernel), and so are its k=1 form ``DeviceIndex`` and the delta tail's
``L0DeviceIndex`` / ``CompositeL0DeviceIndex``. Every index lives on
an explicit device; the entry points run on the GPU unless the caller
asks for the CPU.
"""

from __future__ import annotations

import torch

from .kernel import (
    CompositeL0DeviceIndex,
    DeviceIndex,
    FusedDeviceIndex,
    L0DeviceIndex,
    QueryResults,
    QuerySpec,
    ReadyQueryResults,
    encode_queries,
    run_queries,
)
from .kernel import _BisectIndex
from .scatter_kernel import ScatterDeviceIndex, run_queries_scattered


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Raises when the GPU is asked for and
    none is present: no path moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU — "
            "pass device='cpu' to run the plain-PyTorch kernels on the CPU"
        )
    return dev


def make_device_index(shard, device=None) -> ScatterDeviceIndex:
    """The serving index of one shard on ``device`` (default: the GPU)."""
    return ScatterDeviceIndex(shard, resolve_device(device))


def run_queries_auto(
    index,
    queries,
    *,
    window_cap: int = 2048,
    record_cap: int = 1024,
    async_fetch: bool = False,
    sample_masks=None,
    mask_counts=None,
):
    """Run a query batch on the index's kernel — one call site for the
    engine and the micro-batcher: the bisection kernel for a
    ``FusedDeviceIndex`` / ``DeviceIndex`` / L0 index, the scatter match
    kernel for a ``ScatterDeviceIndex``, and the owner-sliced fused
    query for a mesh-sharded fused index (``parallel.mesh.MeshFusedIndex``,
    duck-typed on its ``run_mesh_queries`` so ops never imports
    parallel).

    ``async_fetch=True`` returns a handle with ``.fetch() ->
    QueryResults`` as soon as the launch is enqueued, so the caller can
    do host work while the card runs it; the scatter kernels read back
    inside their call and return their results behind the same contract
    (``ReadyQueryResults``). The default returns the ``QueryResults``.

    ``sample_masks`` / ``mask_counts`` arm the mesh tier's plane
    reduction and are only meaningful for a plane-stacked
    MeshFusedIndex: passing them for any other index raises."""
    if isinstance(index, ScatterDeviceIndex):
        if sample_masks is not None:
            raise ValueError("sample_masks only ride the mesh plane program")
        res = run_queries_scattered(
            index, queries, window_cap=window_cap, record_cap=record_cap
        )
        return ReadyQueryResults(res) if async_fetch else res
    mesh_run = getattr(index, "run_mesh_queries", None)
    if mesh_run is not None:
        kwargs = {}
        if sample_masks is not None:
            kwargs.update(sample_masks=sample_masks, mask_counts=mask_counts)
        return mesh_run(
            queries, window_cap=window_cap, record_cap=record_cap,
            async_fetch=async_fetch, **kwargs
        )
    if sample_masks is not None:
        raise ValueError("sample_masks only ride the mesh plane program")
    if isinstance(index, _BisectIndex):
        return run_queries(
            index, queries, window_cap=window_cap, record_cap=record_cap,
            async_fetch=async_fetch,
        )
    raise TypeError(f"no kernel serves {type(index).__name__} in this package")


__all__ = [
    "CompositeL0DeviceIndex",
    "DeviceIndex",
    "FusedDeviceIndex",
    "L0DeviceIndex",
    "QueryResults",
    "QuerySpec",
    "ReadyQueryResults",
    "ScatterDeviceIndex",
    "encode_queries",
    "make_device_index",
    "resolve_device",
    "run_queries",
    "run_queries_auto",
    "run_queries_scattered",
]
