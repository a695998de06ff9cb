"""Typed configuration for the port's query path.

Counterpart of ``sbeacon_tpu/config.py``, trimmed to the fields the
``/g_variants`` path reads. Defaults stay those of the JAX package
(``window_cap`` 2048, ``record_cap`` 1024, the micro-batcher on, fused
multi-dataset dispatch on up to 64e6 stacked rows, device genotype
planes on under an 11 GB budget, the dataset-sharded mesh leg on, the
response cache on with scoped invalidation, the L0 delta-tail index
past 4 shards or 4096 rows).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BeaconInfo:
    """Beacon identity, as the envelopes read it."""

    beacon_id: str = "org.tpu.beacon"
    api_version: str = "v2.0.0"
    uri: str = "http://localhost:5000"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Query engine tuning.

    window_cap: max candidate rows a query may span on the device; wider
      windows take the uncapped host matcher.
    record_cap: max matched rows returned per query (host fallback past it).
    microbatch*: the serving micro-batcher (serving.MicroBatcher); with
      wait 0 batches form from requests queuing behind a launch.
    timing_window: entries kept per timing ring.
    fused_dispatch: stack every warm shard into one FusedDeviceIndex so
      a k-dataset query costs one launch and queries for different
      datasets coalesce into one micro-batch; it holds a second device
      copy of the columns (60 B/row), so it is skipped past
      fused_max_rows stacked rows.
    device_planes: upload each shard's genotype bit planes to the device
      (selected samples and sample-hit extraction read them there);
      a plane set that would take the device's resident and in-flight
      planes past plane_hbm_budget_gb stays on the host. (The JAX
      package's plane_upload_chunk_mb is a constant here,
      ops.plane_kernel.UPLOAD_CHUNK_BYTES: the upload never holds a
      plane twice on the device, so no caller needs to turn it off.)
    use_mesh: serve a multi-dataset query through the dataset-sharded
      stack (parallel.mesh) when the mesh has two or more devices; it
      holds its own device copy of the columns, and of the planes when
      they fit plane_hbm_budget_gb beside the resident ones.
    mesh_min_shards: the smallest per-query target count worth the pod
      dispatch tier (parallel.dispatch.MeshDispatchTier; below it,
      per-shard dispatch is already one launch). The JAX package's
      mesh_dispatch is read by its fleet plane, not ported yet; its
      mesh_slice / mesh_owner_outputs are the tier's ``layout`` argument
      here, and the tier stacks the planes whenever every shard has
      them and they fit (no mesh_planes switch).
    response_cache*: the LRU in front of ``VariantEngine.search`` keyed on
      (per-dataset base fingerprint, normalized query, response
      shaping); negative results cache too. size <= 0 or
      ``response_cache`` off disables it; ttl_s 0 means no expiry.
    scoped_invalidation: a publish evicts only the cached entries whose
      dataset set AND coordinate bracket overlap the new rows; off
      restores the wholesale clear on every publish.
    l0_min_shards / l0_min_rows: past EITHER threshold (a key's standing
      delta tail in shards, or its total tail rows) the tail stacks
      into the L0 index (``ops.kernel.L0DeviceIndex``), served by ONE
      bisection-query launch across keys; 0 disables that trigger, both
      0 disable the L0 tier (every tail shard is matched on the host).
    """

    window_cap: int = 2048
    record_cap: int = 1024
    microbatch: bool = True
    microbatch_max: int = 512
    microbatch_wait_ms: float = 0.0
    timing_window: int = 65536
    fused_dispatch: bool = True
    fused_max_rows: int = 64_000_000
    device_planes: bool = True
    plane_hbm_budget_gb: float = 11.0
    use_mesh: bool = True
    mesh_min_shards: int = 2
    response_cache: bool = True
    response_cache_size: int = 4096
    response_cache_ttl_s: float = 300.0
    scoped_invalidation: bool = True
    l0_min_shards: int = 4
    l0_min_rows: int = 4096


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """batch_timeout_s: bound on a micro-batch submit's wait for its
    kernel launch; past it a wedged launch fails the request."""

    batch_timeout_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class BeaconConfig:
    info: BeaconInfo = dataclasses.field(default_factory=BeaconInfo)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig
    )
