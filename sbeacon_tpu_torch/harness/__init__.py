"""Bench, simulation and chaos harness (counterpart of
``sbeacon_tpu/harness``).

``faults`` (stdlib-only chaos hooks) is imported eagerly — the serving
path calls its ``fault_point`` — but the simulation and benchmark
tooling is exposed LAZILY (PEP 562): core modules import
``sbeacon_tpu_torch.harness.faults`` at module load, and that must not
drag the synthetic-data writers and genomics fixtures into every server
process.
"""

from . import faults

_LAZY = {
    "populate": "simulate",
    "random_submission": "simulate",
    "run_latency_suite": "latency",
    "run_concurrent_soak": "latency",
    "run_metadata_scale": "scale",
    "cached_synthetic_shard": "bench_cache",
}

__all__ = ["faults", *_LAZY]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
