"""Typed configuration for the port's query path and its HTTP surface.

Counterpart of ``sbeacon_tpu/config.py``, trimmed to the fields the
Beacon read routes read: the beacon's identity (``BeaconInfo``), the
storage layout (``StorageConfig``), the engine, the resilience envelope
(deadlines, admission, the query runner's pool), ``AuthConfig`` and
``BeaconConfig.from_env`` for the env vars of those fields. The JAX
package's persistent compile cache has no counterpart: the kernels build
once into ``build/kernels/``. Defaults stay those of the JAX package
(``window_cap`` 2048, ``record_cap`` 1024, the micro-batcher on, fused
multi-dataset dispatch on up to 64e6 stacked rows, device genotype
planes on under an 11 GB budget, the dataset-sharded mesh leg on, the
response cache on with scoped invalidation, the L0 delta-tail index
past 4 shards or 4096 rows).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

#: the falsy spellings for boolean env knobs
ENV_OFF = ("0", "false", "no", "off")


@dataclasses.dataclass(frozen=True)
class BeaconInfo:
    """Beacon identity, as the envelopes and the framework routes read it."""

    beacon_id: str = "org.tpu.beacon"
    beacon_name: str = "TPU Native Beacon"
    api_version: str = "v2.0.0"
    environment: str = "dev"
    description: str = "TPU-native GA4GH Beacon v2 implementation"
    version: str = "v2.0"
    welcome_url: str = ""
    alternative_url: str = ""
    org_id: str = "TPU"
    org_name: str = "TPU Beacon"
    org_description: str = ""
    org_address: str = ""
    org_welcome_url: str = ""
    org_contact_url: str = ""
    org_logo_url: str = ""
    default_granularity: str = "boolean"
    uri: str = "http://localhost:5000"


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    """On-disk layout of a data root: the persisted index shards
    (``index_dir``), the entity metadata (``metadata_db``), the ontology
    closures (``ontology_db``), the ingest ledger (``ledger_db``) and the
    query runner's spilled result sets (``query_results_dir``). The same
    layout as the JAX package's, so the port opens a root it wrote."""

    root: Path = Path("./beacon_data")

    @property
    def index_dir(self) -> Path:
        return self.root / "variant-index"

    @property
    def metadata_db(self) -> Path:
        return self.root / "metadata.sqlite"

    @property
    def ledger_db(self) -> Path:
        return self.root / "ledger.sqlite"

    @property
    def ontology_db(self) -> Path:
        return self.root / "ontology.sqlite"

    @property
    def query_results_dir(self) -> Path:
        """Spilled query result sets."""
        return self.root / "query-results"

    def ensure(self) -> "StorageConfig":
        for p in (self.root, self.index_dir, self.query_results_dir):
            p.mkdir(parents=True, exist_ok=True)
        return self


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
    max_response_inline_bytes: a query job's response body past this
      size spills to ``StorageConfig.query_results_dir``.
    request_timeout_s: how long a request waits on its query job.
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
    max_response_inline_bytes: int = 300 * 1024
    request_timeout_s: float = 600.0


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """The failure envelope (resilience.py).

    default_deadline_s: request deadline when the client sends no
      ``X-Beacon-Deadline`` header; 0 disables. ``/submit`` is exempt
      from the default (an explicit header still applies there).
    batch_timeout_s: bound on a micro-batch submit's wait for its
      kernel launch; past it a wedged launch fails the request.
    max_in_flight: admission cap; excess requests answer 429 +
      Retry-After instead of queueing.
    shed_retry_after_s: the Retry-After a shed request is given.
    runner_workers / runner_max_pending: the async query runner's
      bounded pool and its shed threshold; runner_bulk_share is the
      share of the pending slots the bulk lane may hold.
    """

    default_deadline_s: float = 60.0
    batch_timeout_s: float = 60.0
    max_in_flight: int = 256
    shed_retry_after_s: float = 1.0
    runner_workers: int = 8
    runner_max_pending: int = 64
    runner_bulk_share: float = 0.5


@dataclasses.dataclass(frozen=True)
class AuthConfig:
    """``submit_token`` set: POST/PATCH ``/submit`` needs
    ``Authorization: Bearer <token>``; empty is open. (The JAX package's
    ``worker_token`` comes with the fleet plane.)"""

    submit_token: str = ""


#: env var -> (ResilienceConfig field, type)
_RESILIENCE_ENV = {
    "BEACON_DEADLINE_S": ("default_deadline_s", float),
    "BEACON_BATCH_TIMEOUT_S": ("batch_timeout_s", float),
    "BEACON_MAX_IN_FLIGHT": ("max_in_flight", int),
    "BEACON_SHED_RETRY_AFTER_S": ("shed_retry_after_s", float),
    "BEACON_RUNNER_WORKERS": ("runner_workers", int),
    "BEACON_RUNNER_MAX_PENDING": ("runner_max_pending", int),
    "BEACON_RUNNER_BULK_SHARE": ("runner_bulk_share", float),
}

#: env var -> (EngineConfig field, type); bool fields read ENV_OFF
_ENGINE_ENV = {
    "BEACON_WINDOW_CAP": ("window_cap", int),
    "BEACON_RECORD_CAP": ("record_cap", int),
    "BEACON_USE_MESH": ("use_mesh", bool),
    "BEACON_MESH_MIN_SHARDS": ("mesh_min_shards", int),
    "BEACON_PLANE_HBM_BUDGET_GB": ("plane_hbm_budget_gb", float),
    "BEACON_FUSED_DISPATCH": ("fused_dispatch", bool),
    "BEACON_FUSED_MAX_ROWS": ("fused_max_rows", int),
    "BEACON_RESPONSE_CACHE": ("response_cache", bool),
    "BEACON_RESPONSE_CACHE_SIZE": ("response_cache_size", int),
    "BEACON_RESPONSE_CACHE_TTL_S": ("response_cache_ttl_s", float),
    "BEACON_SCOPED_INVALIDATION": ("scoped_invalidation", bool),
    "BEACON_L0_MIN_SHARDS": ("l0_min_shards", int),
    "BEACON_L0_MIN_ROWS": ("l0_min_rows", int),
}


def _env_overrides(env, table: dict) -> dict:
    out = {}
    for var, (field, conv) in table.items():
        if var in env:
            raw = env[var]
            out[field] = (
                raw.lower() not in ENV_OFF if conv is bool else conv(raw)
            )
    return out


@dataclasses.dataclass(frozen=True)
class BeaconConfig:
    info: BeaconInfo = dataclasses.field(default_factory=BeaconInfo)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    auth: AuthConfig = dataclasses.field(default_factory=AuthConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig
    )

    @staticmethod
    def from_env(root: str | os.PathLike | None = None) -> "BeaconConfig":
        """The config with the JAX package's env-var overrides of the
        fields this package has."""
        env = os.environ
        info = BeaconInfo(
            beacon_id=env.get("BEACON_ID", BeaconInfo.beacon_id),
            beacon_name=env.get("BEACON_NAME", BeaconInfo.beacon_name),
            api_version=env.get("BEACON_API_VERSION", BeaconInfo.api_version),
            environment=env.get("BEACON_ENVIRONMENT", BeaconInfo.environment),
            uri=env.get("BEACON_URL", BeaconInfo.uri),
        )
        storage = StorageConfig(
            root=Path(root or env.get("BEACON_DATA_ROOT", "./beacon_data"))
        )
        return BeaconConfig(
            info=info,
            storage=storage,
            engine=EngineConfig(**_env_overrides(env, _ENGINE_ENV)),
            auth=AuthConfig(submit_token=env.get("BEACON_SUBMIT_TOKEN", "")),
            resilience=ResilienceConfig(
                **_env_overrides(env, _RESILIENCE_ENV)
            ),
        )
