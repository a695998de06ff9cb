"""Device indexes and query dispatch.

Counterpart of ``sbeacon_tpu/ops/__init__.py``. Every index this
package builds is a ``ScatterDeviceIndex`` (the scatter match kernel)
on an explicit device; the entry points run on the GPU unless the
caller asks for the CPU.
"""

from __future__ import annotations

import torch

from .kernel import QueryResults, QuerySpec, encode_queries
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
) -> QueryResults:
    """Run a query batch on the index's kernel and read the results
    back — one call site for the engine and the micro-batcher."""
    if not isinstance(index, ScatterDeviceIndex):
        raise TypeError(
            f"no kernel serves {type(index).__name__} in this package yet"
        )
    return run_queries_scattered(
        index, queries, window_cap=window_cap, record_cap=record_cap
    )


__all__ = [
    "QueryResults",
    "QuerySpec",
    "ScatterDeviceIndex",
    "encode_queries",
    "make_device_index",
    "resolve_device",
    "run_queries_auto",
]
