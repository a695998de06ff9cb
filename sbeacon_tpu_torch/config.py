"""Typed configuration for the port's query path and its HTTP surface.

Counterpart of ``sbeacon_tpu/config.py``, trimmed to the fields the
Beacon read routes and the policy plane behind them read: the beacon's
identity (``BeaconInfo``), the storage layout (``StorageConfig``), the
engine, the resilience envelope (deadlines, admission, the query
runner's pool, the per-worker circuit breakers, failover and partial
results), the coordinator->worker transport (``TransportConfig``,
``config.py:345-378`` there), ``AuthConfig``, traffic shaping
(``ShapingConfig``, ``:382-440``), the observability plane
(``ObservabilityConfig``, ``:443-552``, with the fleet digest interval
and the migration knobs), ingest (``IngestConfig``, with the remote
slice-scan workers) and the ontology resolvers (``ResolverConfig``,
``:215-297``) and ``BeaconConfig.from_env`` for the env vars of those
fields (``:679-830``). The JAX
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
      per-shard dispatch is already one launch). mesh_dispatch: a
      fleet coordinator (``parallel.dispatch.DistributedEngine``) with a
      local engine consults that tier per query. The JAX package's
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
    mesh_dispatch: bool = True
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
class IngestConfig:
    """Slice-planning cost model (reference: summariseVcf constants
    :21-25 and the ABS_MAX_DATA_SPLIT / VCF_S3_OUTPUT_SIZE_LIMIT terraform
    ceilings, main.tf:16-17). The planner minimises total_time x cost over
    slice size — here 'dispatch' is a thread-pool task instead of an SNS
    message + lambda cold start, so the constants default far cheaper, but
    the optimiser itself is the same math."""

    min_task_time: float = 0.005  # MIN_SS_TIME (s)
    scan_rate: float = 200_000_000  # SS_RATE (compressed B/s, host parse)
    dispatch_cost: float = 0.0005  # SNS_TIME equivalent (s/task)
    max_concurrency: int = 64  # MAX_CONCURRENCY
    workers: int = 8  # parallel slice workers
    max_range_bytes: int = 750 * 1024 * 1024  # ABS_MAX_DATA_SPLIT
    # also materialise reference-layout binary region files per VCF
    # (vcf-summaries/ portable exchange format, index/portable.py)
    export_portable: bool = True
    # remote slice-scan workers (the reference's <=1000-lambda
    # summariseSlice fan-out): slice jobs scatter round-robin across
    # these worker URLs; empty = scan on this host's thread pool
    scan_worker_urls: tuple[str, ...] = ()
    scan_timeout_s: float = 120.0  # per-slice worker call budget
    scan_retries: int = 1  # extra workers tried before local fallback
    # ingest-while-serving (delta shards + background compaction):
    # stream_deltas publishes each completed slice of a FIRST-TIME
    # summarisation to the engine immediately as a queryable delta
    # shard (read-your-writes before the merge barrier); the base
    # publish is deferred to the compactor so the fused/mesh stacks and
    # the response cache are not demolished per submit. delta_max_shards
    # is the per-(dataset, vcf) delta-tail depth that kicks an early
    # compaction; compact_interval_s is the background compactor's
    # cadence (<=0 disables the thread — folds then only run on the
    # depth trigger or an explicit run_once()).
    stream_deltas: bool = True
    delta_max_shards: int = 8
    compact_interval_s: float = 30.0
    # size-tiered compaction: >0 arms the tiered fold
    # policy — raw delta tails fold into intermediate L1 artifacts
    # (persisted, epoch-ranged, adoptable after a crash) and the full
    # base merge only runs once the accumulated L1 bytes reach this
    # ratio of the base's bytes, so per-fold write amplification stops
    # scaling with base size. <=0 selects the legacy policy: every
    # fold is a full base merge. Tiered is the default (under
    # sustained multi-key ingest it folds L1 per trigger and merges the
    # base only at the ratio, so GC stays bounded); set
    # BEACON_COMPACT_BASE_RATIO=0 to get the merge-every-fold behaviour.
    compact_base_ratio: float = 0.35
    # superseded base/L1 artifacts are parked in a per-key .retired/
    # dir at each base merge and the newest N generations are kept;
    # older ones are GC'd (ingest.gc_bytes counts the reclaim). GC
    # only ever touches .retired/ — a serving artifact can never be
    # deleted.
    artifact_retain: int = 2
    # defer the end-of-summarisation BASE publish to the compactor
    # cadence as well (continuous-ingest mode): submits then never pay
    # a fingerprint bump / stack rebuild inline — the standing deltas
    # serve until the next fold. Off (default) keeps the base publish
    # at the end of each summarisation (identical post-submit state to
    # the pre-delta write path; slices still stream mid-scan).
    defer_base_publish: bool = False


# canonical external-service endpoints (reference indexer:40-42); the
# resolver clients in metadata/resolvers.py import these — single source
DEFAULT_OLS_URL = "https://www.ebi.ac.uk/ols/api/ontologies"
DEFAULT_ONTOSERVER_URL = (
    "https://r4.ontoserver.csiro.au/fhir/ValueSet/$expand"
)


@dataclasses.dataclass(frozen=True)
class ResolverConfig:
    """External ontology resolution (the indexer's OLS/Ontoserver calls,
    reference indexer/lambda_function.py:40-42). Off by default: an
    air-gapped deployment must not stall submissions on network timeouts;
    closures can also be loaded offline via OntologyStore."""

    enabled: bool = False
    ols_url: str = DEFAULT_OLS_URL
    ontoserver_url: str = DEFAULT_ONTOSERVER_URL
    workers: int = 8


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
    breaker_failure_threshold / breaker_reset_s /
      breaker_half_open_probes: the per-worker circuit breaker of a
      fleet coordinator: consecutive failures that open a route, how
      long it stays open, and the probe calls a half-open route admits.
    failover_retries: extra replicas a failed worker leg may re-route
      to before its datasets fall to the partial-results path.
    partial_results: when no replica of a dataset is reachable, answer
      with the datasets that responded and name the rest in the
      envelope (``meta.unavailableDatasets`` and a warning) instead of
      failing the whole request.
    """

    default_deadline_s: float = 60.0
    batch_timeout_s: float = 60.0
    max_in_flight: int = 256
    shed_retry_after_s: float = 1.0
    runner_workers: int = 8
    runner_max_pending: int = 64
    runner_bulk_share: float = 0.5
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 30.0
    breaker_half_open_probes: int = 1
    failover_retries: int = 2
    partial_results: bool = True


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Coordinator->worker data-plane knobs (parallel/transport.py).

    pool_size: keep-alive connections kept per worker host. Not a
      concurrency cap: a burst beyond it opens extra connections that
      are closed, not pooled, on return.
    idle_ttl_s: pooled connections idle longer than this are closed on
      next touch (workers reap their side slightly later).
    gzip_min_bytes: request bodies at or over this size are
      gzip-compressed on the wire (0 disables).
    hedge_delay_s: if a /search primary has not answered within this
      delay, the same call races on a second replica and the first
      answer wins. >0 fixed; 0 adaptive (the p95 of recent RTTs, once
      enough samples exist); <0 off.
    bool_short_circuit: boolean-granularity fan-outs return as soon as
      any worker reports a hit, abandoning the rest of the scatter.
    replica_hedge: hedge slow /search primaries with a second replica
      of the same datasets; single-replica fleets never hedge.
    """

    pool_size: int = 4
    idle_ttl_s: float = 60.0
    gzip_min_bytes: int = 32 * 1024
    hedge_delay_s: float = 0.0
    bool_short_circuit: bool = True
    replica_hedge: bool = True


@dataclasses.dataclass(frozen=True)
class ShapingConfig:
    """Traffic shaping and brownout (shaping.py): weighted fair queueing
    across tenants, priority lanes, adaptive Retry-After, and an
    SLO-driven brownout ladder.

    enabled: the whole layer on/off (off: the global admission gate
      alone).
    tenant_header: header carrying an explicit tenant id; requests
      without it bucket by Authorization hash, else ``anon``.
    tenant_weights: ``tenant=weight`` comma list for the DRR drain
      ratio (``gold=4,free=1``); unlisted tenants get
      ``default_weight``.
    tenant_max_in_flight / tenant_queue_depth: per-tenant running cap
      and per-tenant per-lane queue bound; a full queue sheds 429 with
      the adaptive Retry-After.
    max_queue_wait_s: a queued request not granted within this bound
      sheds (its request deadline may cut earlier -> 504).
    bulk_starvation_ms: a bulk waiter older than this is served ahead
      of the interactive lane (one per dispatch pass).
    retry_after_floor_s / retry_after_ceil_s: clamp on the adaptive
      Retry-After (p90 of the shed lane's measured queue wait).
    max_tenants: distinct tenant states (and metric label values)
      tracked before new ids share the ``overflow`` bucket.
    brownout*: the ladder — sustained SLO breach steps up
      (hedge off -> bulk pause -> AIMD cap squeeze -> global shed)
      after ``up_hold_s``; sustained recovery steps down after
      ``down_hold_s``, restoring squeezed caps by ``ai_step`` per tick.
    cost_drr: the fair queue charges a grant the measured mean cost of
      its query shape (accounting.py) instead of a flat 1; off by
      default.
    """

    enabled: bool = True
    tenant_header: str = "X-Beacon-Tenant"
    tenant_weights: str = ""
    default_weight: float = 1.0
    tenant_max_in_flight: int = 64
    tenant_queue_depth: int = 128
    max_queue_wait_s: float = 10.0
    bulk_starvation_ms: float = 500.0
    retry_after_floor_s: float = 1.0
    retry_after_ceil_s: float = 60.0
    max_tenants: int = 64
    brownout: bool = True
    brownout_up_hold_s: float = 3.0
    brownout_down_hold_s: float = 15.0
    brownout_md_factor: float = 0.5
    brownout_ai_step: float = 0.25
    brownout_min_scale: float = 0.125
    cost_drr: bool = False


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """The observability plane's knobs. Tracing itself stays env-gated
    (``SBEACON_TRACE=1``, utils/trace.py).

    slow_query_ms: any request slower than this emits one structured
      JSON line to the ``sbeacon.slowquery`` logger and the in-memory
      ring served at ``/_trace``; 0 records every request, negative
      disables. slow_query_log: a file the lines also append to.
    profile_dir: arms ``torch.profiler`` capture of the kernel launch
      regions into this directory (``SBEACON_PROFILE``).
    slo_*: the SLO engine (slo.py, ``/slo``): the default availability
      and latency objectives, per-route overrides
      (``route:field=value[:...]`` comma list) and the burn factor that,
      sustained on both windows, marks a route breached.
    event_journal / event_journal_size: the control-plane event journal
      (``/ops/events``).
    cost_accounting / cost_window_s: the per-(tenant, lane, shape) cost
      table (accounting.py, ``/ops/costs``) and the window of its
      per-shape mean.
    canary_enabled / canary_interval_s / canary_latency_ms: the
      known-answer canary prober (canary.py); interval <= 0 arms no
      thread (``run_once()`` still works).
    fleet_digest_interval_s: how often a fleet coordinator's
      ``/fleet/status`` re-polls every worker's ``/ops/digest`` (lazily,
      when read).
    device_ring_size / compile_tracking: the device flight recorder's
      launch ring and its kernel build tracker (``/device/status``).
    migration_enabled: serve ``POST /fleet/migrate``
      (``BEACON_MIGRATION_ENABLED``; ``GET /fleet/migrations`` always
      answers). migration_verify_rounds: consecutive clean canary-verify
      rounds the target must answer before cut-over (floor 1).
      migration_copy_timeout_s: the copy phase's wall budget, also the
      base of the stuck-migration diagnosis.
    explain_enabled: serve ``?explain=1`` (worker-token gated when one
      is set); plan_sample_n / plan_drift_windows: the sampled plan
      store and its drift sentinel (plan.py, ``/ops/plans``).
    """

    slow_query_ms: float = 1000.0
    slow_query_log: str = ""
    profile_dir: str = ""
    slo_availability_target: float = 0.999
    slo_latency_ms: float = 250.0
    slo_latency_target: float = 0.99
    slo_routes: str = ""
    slo_alert_burn_rate: float = 14.4
    event_journal: bool = True
    event_journal_size: int = 1024
    cost_accounting: bool = True
    cost_window_s: float = 300.0
    fleet_digest_interval_s: float = 10.0
    canary_enabled: bool = True
    canary_interval_s: float = 30.0
    canary_latency_ms: float = 1000.0
    device_ring_size: int = 256
    compile_tracking: bool = True
    migration_enabled: bool = True
    migration_verify_rounds: int = 3
    migration_copy_timeout_s: float = 120.0
    explain_enabled: bool = False
    plan_sample_n: int = 16
    plan_drift_windows: int = 2


@dataclasses.dataclass(frozen=True)
class AuthConfig:
    """``submit_token`` set: POST/PATCH ``/submit`` needs
    ``Authorization: Bearer <token>``; empty is open. ``worker_token``
    guards ``?explain=1`` the same way (and, in the JAX package, the
    worker plane)."""

    submit_token: str = ""
    worker_token: str = ""


#: env var -> (ResilienceConfig field, type)
_RESILIENCE_ENV = {
    "BEACON_DEADLINE_S": ("default_deadline_s", float),
    "BEACON_BATCH_TIMEOUT_S": ("batch_timeout_s", float),
    "BEACON_MAX_IN_FLIGHT": ("max_in_flight", int),
    "BEACON_SHED_RETRY_AFTER_S": ("shed_retry_after_s", float),
    "BEACON_RUNNER_WORKERS": ("runner_workers", int),
    "BEACON_RUNNER_MAX_PENDING": ("runner_max_pending", int),
    "BEACON_RUNNER_BULK_SHARE": ("runner_bulk_share", float),
    "BEACON_BREAKER_THRESHOLD": ("breaker_failure_threshold", int),
    "BEACON_BREAKER_RESET_S": ("breaker_reset_s", float),
    "BEACON_BREAKER_PROBES": ("breaker_half_open_probes", int),
    "BEACON_FAILOVER_RETRIES": ("failover_retries", int),
    "BEACON_PARTIAL_RESULTS": ("partial_results", bool),
}

#: env var -> (TransportConfig field, type)
_TRANSPORT_ENV = {
    "BEACON_POOL_SIZE": ("pool_size", int),
    "BEACON_POOL_IDLE_S": ("idle_ttl_s", float),
    "BEACON_GZIP_MIN_BYTES": ("gzip_min_bytes", int),
    "BEACON_HEDGE_DELAY_S": ("hedge_delay_s", float),
    "BEACON_BOOL_SHORT_CIRCUIT": ("bool_short_circuit", bool),
    "BEACON_REPLICA_HEDGE": ("replica_hedge", bool),
}

#: env var -> (EngineConfig field, type); bool fields read ENV_OFF
_ENGINE_ENV = {
    "BEACON_WINDOW_CAP": ("window_cap", int),
    "BEACON_RECORD_CAP": ("record_cap", int),
    "BEACON_USE_MESH": ("use_mesh", bool),
    "BEACON_MESH_DISPATCH": ("mesh_dispatch", bool),
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


#: env var -> (ObservabilityConfig field, type)
_OBSERVABILITY_ENV = {
    "SBEACON_SLOW_QUERY_MS": ("slow_query_ms", float),
    "SBEACON_SLOW_QUERY_LOG": ("slow_query_log", str),
    "SBEACON_PROFILE": ("profile_dir", str),
    "BEACON_SLO_AVAILABILITY": ("slo_availability_target", float),
    "BEACON_SLO_LATENCY_MS": ("slo_latency_ms", float),
    "BEACON_SLO_LATENCY_TARGET": ("slo_latency_target", float),
    "BEACON_SLO_ROUTES": ("slo_routes", str),
    "BEACON_SLO_ALERT_BURN": ("slo_alert_burn_rate", float),
    "BEACON_EVENT_JOURNAL_SIZE": ("event_journal_size", int),
    "BEACON_FLEET_DIGEST_INTERVAL_S": ("fleet_digest_interval_s", float),
    "BEACON_CANARY_INTERVAL_S": ("canary_interval_s", float),
    "BEACON_CANARY_LATENCY_MS": ("canary_latency_ms", float),
    "BEACON_DEVICE_RING_SIZE": ("device_ring_size", int),
    "BEACON_MIGRATION_VERIFY_ROUNDS": ("migration_verify_rounds", int),
    "BEACON_MIGRATION_COPY_TIMEOUT_S": ("migration_copy_timeout_s", float),
    "BEACON_PLAN_SAMPLE_N": ("plan_sample_n", int),
    "BEACON_PLAN_DRIFT_WINDOWS": ("plan_drift_windows", int),
    "BEACON_EVENT_JOURNAL_ENABLED": ("event_journal", bool),
    "BEACON_CANARY_ENABLED": ("canary_enabled", bool),
    "BEACON_COMPILE_TRACKING": ("compile_tracking", bool),
    "BEACON_MIGRATION_ENABLED": ("migration_enabled", bool),
    "BEACON_EXPLAIN_ENABLED": ("explain_enabled", bool),
    "BEACON_COST_ACCOUNTING": ("cost_accounting", bool),
    "BEACON_COST_WINDOW_S": ("cost_window_s", float),
}

#: env var -> (IngestConfig field, type)
_INGEST_ENV = {
    "BEACON_INGEST_WORKERS": ("workers", int),
    "BEACON_STREAM_DELTAS": ("stream_deltas", bool),
    "BEACON_DELTA_MAX_SHARDS": ("delta_max_shards", int),
    "BEACON_COMPACT_INTERVAL_S": ("compact_interval_s", float),
    "BEACON_COMPACT_BASE_RATIO": ("compact_base_ratio", float),
    "BEACON_ARTIFACT_RETAIN": ("artifact_retain", int),
    "BEACON_DEFER_BASE_PUBLISH": ("defer_base_publish", bool),
}

#: env var -> (ShapingConfig field, type)
_SHAPING_ENV = {
    "BEACON_TENANT_HEADER": ("tenant_header", str),
    "BEACON_TENANT_WEIGHTS": ("tenant_weights", str),
    "BEACON_TENANT_DEFAULT_WEIGHT": ("default_weight", float),
    "BEACON_TENANT_MAX_IN_FLIGHT": ("tenant_max_in_flight", int),
    "BEACON_TENANT_QUEUE_DEPTH": ("tenant_queue_depth", int),
    "BEACON_MAX_QUEUE_WAIT_S": ("max_queue_wait_s", float),
    "BEACON_BULK_STARVATION_MS": ("bulk_starvation_ms", float),
    "BEACON_RETRY_AFTER_FLOOR_S": ("retry_after_floor_s", float),
    "BEACON_RETRY_AFTER_CEIL_S": ("retry_after_ceil_s", float),
    "BEACON_MAX_TENANTS": ("max_tenants", int),
    "BEACON_BROWNOUT_UP_S": ("brownout_up_hold_s", float),
    "BEACON_BROWNOUT_DOWN_S": ("brownout_down_hold_s", float),
    "BEACON_SHAPING": ("enabled", bool),
    "BEACON_BROWNOUT": ("brownout", bool),
    "BEACON_COST_DRR": ("cost_drr", bool),
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
    transport: TransportConfig = dataclasses.field(
        default_factory=TransportConfig
    )
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig
    )
    shaping: ShapingConfig = dataclasses.field(
        default_factory=ShapingConfig
    )
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    resolvers: ResolverConfig = dataclasses.field(
        default_factory=ResolverConfig
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
        ingest_over = _env_overrides(env, _INGEST_ENV)
        if "BEACON_SCAN_WORKERS" in env:
            ingest_over["scan_worker_urls"] = tuple(
                u.strip()
                for u in env["BEACON_SCAN_WORKERS"].split(",")
                if u.strip()
            )
        return BeaconConfig(
            info=info,
            storage=storage,
            engine=EngineConfig(**_env_overrides(env, _ENGINE_ENV)),
            auth=AuthConfig(
                submit_token=env.get("BEACON_SUBMIT_TOKEN", ""),
                worker_token=env.get("BEACON_WORKER_TOKEN", ""),
            ),
            resilience=ResilienceConfig(
                **_env_overrides(env, _RESILIENCE_ENV)
            ),
            transport=TransportConfig(**_env_overrides(env, _TRANSPORT_ENV)),
            observability=ObservabilityConfig(
                **_env_overrides(env, _OBSERVABILITY_ENV)
            ),
            shaping=ShapingConfig(**_env_overrides(env, _SHAPING_ENV)),
            ingest=IngestConfig(**ingest_over),
            resolvers=ResolverConfig(
                enabled=env.get("BEACON_RESOLVE_ONTOLOGIES", "").lower()
                in ("1", "true", "yes", "on"),
                ols_url=env.get("BEACON_OLS_URL", DEFAULT_OLS_URL),
                ontoserver_url=env.get(
                    "BEACON_ONTOSERVER_URL", DEFAULT_ONTOSERVER_URL
                ),
                workers=int(env.get("BEACON_RESOLVER_WORKERS", "8")),
            ),
        )
