"""Per-request cost attribution: the tenant accounting plane.

Counterpart of ``sbeacon_tpu/accounting.py``, all of it: ``cost_units``,
``query_shape`` and ``CostAccounting`` with its cost-aware DRR seam.

- **The per-request** :class:`~sbeacon_tpu_torch.telemetry.CostVector`
  (riding every request context): the batcher pro-rates each launch's
  measured time to the specs in the launch, the host matcher charges
  candidate rows walked, the response cache stamps its outcome, the
  fair queue charges admission wait, and the API layer charges response
  bytes. Charges with no ambient context land in
  ``telemetry.UNATTRIBUTED_COST``, so the attribution ratio is
  measurable.
- **This module's** :class:`CostAccounting` table: at the end of every
  tracked request the API layer folds the vector into a per-``(tenant,
  lane, query-shape)`` bucket — bounded tenant cardinality reusing
  shaping's overflow cap, decaying time windows with an injectable
  clock, lifetime totals, and a bounded per-shape sample ring for
  mean/p99 cost. Work off any request is recorded under ``system``.

Served surfaces: ``/ops/costs``, tenant-labeled ``cost.*`` metrics,
cost fields on slow-query-log records, the ``/debug/status`` diagnosis,
and the scheduling seam :meth:`CostAccounting.drr_charge` (the fair
queue charges a measured per-shape cost instead of a flat 1 when
``BEACON_COST_DRR`` is on; off by default).

Cost units are **device-microsecond equivalents**: one unit is one
microsecond of device-launch time; host scan converts at ~50M rows/s,
response serialization at ~100 MB/s, a worker RTT at its duration.
Queue wait is attributed per tenant but excluded from the unit scalar.

Stdlib only and importable from any layer.
"""

from __future__ import annotations

import collections
import threading
import time

from .shaping import FairQueueAdmission
from .telemetry import UNATTRIBUTED_COST, percentiles

#: the tenant background work (compaction, off-request ingest) bills to
SYSTEM_TENANT = "system"
#: shared bucket once ``max_tenants`` distinct tenants are tracked —
#: the same cap and bucket name as shaping's classifier
OVERFLOW_TENANT = "overflow"
#: shared bucket once ``max_shapes`` distinct query shapes are tracked
OVERFLOW_SHAPE = "other"

# -- the cost-unit conversion rates (device-microsecond equivalents) ----------

#: one host-scanned candidate row ≈ 0.02 µs (a ~50M rows/s numpy scan)
HOST_ROW_US = 0.02
#: a worker RTT occupies that worker for its duration: 1 ms = 1000 µs
WORKER_RTT_US_PER_MS = 1000.0
#: one response byte ≈ 0.01 µs (~100 MB/s serialization)
RESPONSE_BYTE_US = 0.01
#: fixed per-delta-shard walk overhead (dispatch + materialize setup)
DELTA_SHARD_US = 5.0


def cost_units(vec: dict) -> float:
    """The scalar cost of one request's vector snapshot, in
    device-microsecond equivalents (queue wait excluded — contention
    is not work)."""
    return (
        vec.get("device_us", 0.0)
        + vec.get("host_rows", 0.0) * HOST_ROW_US
        + vec.get("worker_rtt_ms", 0.0) * WORKER_RTT_US_PER_MS
        + vec.get("response_bytes", 0.0) * RESPONSE_BYTE_US
        + vec.get("delta_shards", 0.0) * DELTA_SHARD_US
    )


def query_shape(route: str, granularity: str | None) -> str:
    """The bounded query-shape key: route label (already cardinality-
    bounded by the API layer) x requested granularity. This is the SAME
    key the DRR charge hook looks up, so learned per-shape costs apply
    to admission of the shape that incurred them."""
    g = str(granularity or "default").lower()
    if g not in ("boolean", "count", "record", "default"):
        g = "other"
    return f"{route}:{g}"


class _Window:
    """Decaying sums over ``window_s``: N epoch-stamped slots, each
    lazily reset when its epoch rolls over (the slo.py `_BucketRing`
    idiom, generalised to float field sums). Thread-safety is the
    caller's — CostAccounting holds one lock across the table."""

    SLOTS = 8

    __slots__ = ("_bucket_s", "_epoch", "_n", "_units", "_clock")

    def __init__(self, window_s: float, clock):
        self._bucket_s = max(0.001, float(window_s)) / self.SLOTS
        self._epoch = [-1] * self.SLOTS
        self._n = [0] * self.SLOTS
        self._units = [0.0] * self.SLOTS
        self._clock = clock

    def add(self, units: float, n: int = 1) -> None:
        idx = int(self._clock() / self._bucket_s)
        slot = idx % self.SLOTS
        if self._epoch[slot] != idx:
            self._epoch[slot] = idx
            self._n[slot] = 0
            self._units[slot] = 0.0
        self._n[slot] += n
        self._units[slot] += units

    def totals(self) -> tuple[int, float]:
        """(requests, units) over the live window."""
        now_idx = int(self._clock() / self._bucket_s)
        lo = now_idx - self.SLOTS
        n, units = 0, 0.0
        for slot in range(self.SLOTS):
            if lo < self._epoch[slot] <= now_idx:
                n += self._n[slot]
                units += self._units[slot]
        return n, units


class _Bucket:
    """One (tenant, lane, shape) accounting bucket: lifetime field
    sums + a decaying window of (requests, units)."""

    __slots__ = ("requests", "units", "fields", "window")

    def __init__(self, window_s: float, clock):
        self.requests = 0
        self.units = 0.0
        self.fields = collections.defaultdict(float)
        self.window = _Window(window_s, clock)

    def fold(self, vec: dict, units: float) -> None:
        self.requests += 1
        self.units += units
        for k, v in vec.items():
            if isinstance(v, (int, float)) and v:
                self.fields[k] += v
        self.window.add(units)


class _ShapeAgg:
    """Per-(lane, shape) aggregate across tenants: the scheduling
    seam's lookup — windowed mean plus a bounded sample ring for
    mean/p99 reporting."""

    SAMPLES = 512

    __slots__ = ("requests", "units", "window", "recent")

    def __init__(self, window_s: float, clock):
        self.requests = 0
        self.units = 0.0
        self.window = _Window(window_s, clock)
        self.recent = collections.deque(maxlen=self.SAMPLES)

    def fold(self, units: float) -> None:
        self.requests += 1
        self.units += units
        self.window.add(units)
        self.recent.append(units)


class CostAccounting:
    """The per-(tenant, lane, query-shape) cost table.

    ``record`` folds one finished request's cost-vector snapshot;
    ``record_system`` books off-request work (compaction) under the
    ``system`` tenant; ``snapshot`` renders the ``/ops/costs``
    document; ``shape_cost``/``drr_charge`` are the cost-aware
    scheduling seam. Cardinality is bounded on BOTH axes: distinct
    tenants beyond ``max_tenants`` share the ``overflow`` bucket
    (shaping's cap, reused) and distinct shapes beyond ``max_shapes``
    share ``other``. The clock is injectable so the decaying windows
    are testable without sleeping.
    """

    #: windowed samples required before shape_cost trusts the window
    #: over the lifetime mean
    MIN_WINDOW_SAMPLES = 8
    #: clamp on the normalized DRR charge, sourced from the fair
    #: queue (the module whose deficit refill cap DEFINES the safe
    #: bound — a charge above its cap could strand a queued request
    #: forever); one source, so the two sides cannot drift apart
    MIN_DRR_CHARGE = FairQueueAdmission.MIN_DRR_CHARGE
    MAX_DRR_CHARGE = FairQueueAdmission.MAX_DRR_CHARGE

    def __init__(
        self,
        *,
        window_s: float = 300.0,
        max_tenants: int = 64,
        max_shapes: int = 64,
        clock=time.monotonic,
    ):
        self.window_s = float(window_s)
        self.max_tenants = max(1, int(max_tenants))
        self.max_shapes = max(1, int(max_shapes))
        self._clock = clock
        self._lock = threading.Lock()
        # (tenant, lane, shape) -> _Bucket
        self._buckets: dict[tuple[str, str, str], _Bucket] = {}
        self._tenants: set[str] = set()
        self._shapes: set[str] = set()
        # (lane, shape) -> _ShapeAgg ; lane -> _ShapeAgg (lane mean)
        self._shape_agg: dict[tuple[str, str], _ShapeAgg] = {}
        self._lane_agg: dict[str, _ShapeAgg] = {}
        # lifetime grand totals (the attribution numerator)
        self._total = collections.defaultdict(float)
        self._total_requests = 0

    # -- folding -------------------------------------------------------------

    def _bound_tenant(self, tenant: str) -> str:
        if tenant in self._tenants:
            return tenant
        if (
            len(self._tenants) >= self.max_tenants
            and tenant not in (OVERFLOW_TENANT, SYSTEM_TENANT)
        ):
            tenant = OVERFLOW_TENANT
        self._tenants.add(tenant)
        return tenant

    def _bound_shape(self, shape: str) -> str:
        if shape in self._shapes:
            return shape
        if len(self._shapes) >= self.max_shapes and shape != OVERFLOW_SHAPE:
            shape = OVERFLOW_SHAPE
        self._shapes.add(shape)
        return shape

    def record(
        self, tenant: str, lane: str, shape: str, vec: dict
    ) -> float:
        """Fold one request's cost-vector snapshot; returns the cost
        units charged. O(#fields) under one lock — request-path safe."""
        units = cost_units(vec)
        with self._lock:
            tenant = self._bound_tenant(tenant or "anon")
            shape = self._bound_shape(shape or OVERFLOW_SHAPE)
            key = (tenant, lane, shape)
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = _Bucket(self.window_s, self._clock)
            b.fold(vec, units)
            sk = (lane, shape)
            agg = self._shape_agg.get(sk)
            if agg is None:
                agg = self._shape_agg[sk] = _ShapeAgg(
                    self.window_s, self._clock
                )
            agg.fold(units)
            lagg = self._lane_agg.get(lane)
            if lagg is None:
                lagg = self._lane_agg[lane] = _ShapeAgg(
                    self.window_s, self._clock
                )
            lagg.fold(units)
            self._total_requests += 1
            self._total["units"] += units
            for k, v in vec.items():
                if isinstance(v, (int, float)) and v:
                    self._total[k] += v
        return units

    def record_system(self, shape: str, **fields) -> float:
        """Book off-request background work (compaction, deferred
        ingest folds) under the ``system`` tenant / ``bulk`` lane, so
        amortised cost shows up next to the tenants it serves."""
        return self.record(SYSTEM_TENANT, "bulk", shape, dict(fields))

    # -- the scheduling seam (cost-aware DRR) --------------------------------

    def shape_cost(self, lane: str, shape: str) -> float:
        """Measured mean cost units of one request of ``shape`` in
        ``lane``: the decaying window's mean once it has enough
        samples, else the lifetime mean, else 0.0 (unknown shape)."""
        with self._lock:
            agg = self._shape_agg.get((lane, shape))
            if agg is None:
                return 0.0
            n, units = agg.window.totals()
            if n >= self.MIN_WINDOW_SAMPLES:
                return units / n
            if agg.requests:
                return agg.units / agg.requests
            return 0.0

    def drr_charge(self, lane: str, shape: str) -> float:
        """The deficit a DRR grant of this shape should cost, as a
        multiple of the lane's mean request cost, clamped to
        [0.25, 2.0] so no shape can be starved outright or ride free.
        Unknown shapes (or an idle lane) charge the flat 1.0."""
        sc = self.shape_cost(lane, shape)
        if sc <= 0.0:
            return 1.0
        with self._lock:
            lagg = self._lane_agg.get(lane)
            if lagg is None:
                return 1.0
            n, units = lagg.window.totals()
            if n >= self.MIN_WINDOW_SAMPLES:
                mean = units / n
            elif lagg.requests:
                mean = lagg.units / lagg.requests
            else:
                return 1.0
        if mean <= 0.0:
            return 1.0
        return min(
            self.MAX_DRR_CHARGE, max(self.MIN_DRR_CHARGE, sc / mean)
        )

    # -- rollups -------------------------------------------------------------

    def tenant_field(self, field: str) -> dict[str, float]:
        """{tenant: lifetime value} for the tenant-labeled ``cost.*``
        series (``field='units'``/``'requests'``/a vector field)."""
        out: dict[str, float] = {}
        with self._lock:
            for (tenant, _lane, _shape), b in self._buckets.items():
                if field == "units":
                    v = b.units
                elif field == "requests":
                    v = float(b.requests)
                else:
                    v = b.fields.get(field, 0.0)
                out[tenant] = out.get(tenant, 0.0) + v
        return {t: round(v, 3) for t, v in out.items()}

    def shape_units(self) -> dict[tuple[str, str], float]:
        """{(lane, shape): windowed mean cost units} for the
        ``cost.shape_units`` gauge."""
        out = {}
        with self._lock:
            for (lane, shape), agg in self._shape_agg.items():
                n, units = agg.window.totals()
                if n:
                    out[(lane, shape)] = round(units / n, 3)
                elif agg.requests:
                    out[(lane, shape)] = round(
                        agg.units / agg.requests, 3
                    )
        return out

    def snapshot(self, top_n: int = 8) -> dict:
        """The ``/ops/costs`` document."""
        unattributed = UNATTRIBUTED_COST.snapshot()
        with self._lock:
            tenants: dict[str, dict] = {}
            for (tenant, lane, shape), b in self._buckets.items():
                doc = tenants.setdefault(
                    tenant,
                    {"requests": 0, "units": 0.0, "windowUnits": 0.0},
                )
                doc["requests"] += b.requests
                doc["units"] += b.units
                _n, w_units = b.window.totals()
                doc["windowUnits"] += w_units
                for k, v in b.fields.items():
                    doc[k] = doc.get(k, 0.0) + v
            for doc in tenants.values():
                for k, v in list(doc.items()):
                    if isinstance(v, float):
                        doc[k] = round(v, 3)
            shapes: dict[str, dict] = {}
            # rendering key: the bare shape, lane-qualified only when
            # two lanes share one shape string (the 'other' overflow
            # bucket can legitimately exist in both) — a plain
            # shape-keyed dict would silently overwrite one lane's
            # aggregate with the other's
            shape_lanes: dict[str, int] = {}
            for (_lane, shape) in self._shape_agg:
                shape_lanes[shape] = shape_lanes.get(shape, 0) + 1
            for (lane, shape), agg in self._shape_agg.items():
                qs = percentiles(agg.recent)
                key = shape if shape_lanes[shape] == 1 else (
                    f"{shape}|{lane}"
                )
                shapes[key] = {
                    "lane": lane,
                    "requests": agg.requests,
                    "units": round(agg.units, 3),
                    "meanUnits": round(
                        agg.units / agg.requests, 3
                    )
                    if agg.requests
                    else 0.0,
                    "p99Units": qs.get("p99", 0.0),
                }
            totals = {
                k: round(v, 3) for k, v in sorted(self._total.items())
            }
            totals["requests"] = self._total_requests
        top = sorted(
            tenants.items(), key=lambda kv: -kv[1]["units"]
        )[:top_n]
        costliest_shape = max(
            shapes.items(), key=lambda kv: kv[1]["units"], default=(None,)
        )[0] if shapes else None
        # attribution ratio: what fraction of MEASURED work landed in
        # some (tenant, shape) bucket vs. the unattributed residue —
        # the acceptance bar is >= 0.95 on device µs and host rows
        attribution = {}
        for field in ("device_us", "host_rows"):
            att = totals.get(field, 0.0)
            tot = att + unattributed.get(field, 0.0)
            attribution[field] = round(att / tot, 4) if tot else 1.0
        return {
            "enabled": True,
            "windowS": self.window_s,
            "costUnit": "device-microsecond equivalents",
            "totals": totals,
            "unattributed": {
                k: round(v, 3)
                for k, v in unattributed.items()
                if isinstance(v, (int, float)) and v
            },
            "attributionRatio": attribution,
            "tenants": tenants,
            "topTenants": [[t, d["units"]] for t, d in top],
            "shapes": shapes,
            "costliestTenant": top[0][0] if top else None,
            "costliestShape": costliest_shape,
        }

    def debug(self) -> dict:
        """The compact ``/debug/status`` rollup."""
        snap = self.snapshot(top_n=3)
        return {
            "requests": snap["totals"].get("requests", 0),
            "units": snap["totals"].get("units", 0.0),
            "topTenants": snap["topTenants"],
            "costliestTenant": snap["costliestTenant"],
            "costliestShape": snap["costliestShape"],
            "attributionRatio": snap["attributionRatio"],
        }

    # -- metrics -------------------------------------------------------------

    def register_metrics(self, registry) -> None:
        """The tenant-labeled ``cost.*`` series (callback-backed off
        the table, whose tenant axis is already cardinality-bounded)
        plus the per-shape windowed mean."""
        registry.counter(
            "cost.requests",
            "requests folded into the cost accounting table",
            label="tenant",
            fn=lambda: self.tenant_field("requests"),
        )
        registry.counter(
            "cost.units",
            "attributed cost units (device-microsecond equivalents)",
            label="tenant",
            fn=lambda: self.tenant_field("units"),
        )
        registry.counter(
            "cost.device_us",
            "attributed device-launch microseconds",
            label="tenant",
            fn=lambda: self.tenant_field("device_us"),
        )
        registry.counter(
            "cost.host_rows",
            "attributed host-scan candidate rows",
            label="tenant",
            fn=lambda: self.tenant_field("host_rows"),
        )
        registry.counter(
            "cost.worker_rtt_ms",
            "attributed worker round-trip milliseconds",
            label="tenant",
            fn=lambda: self.tenant_field("worker_rtt_ms"),
        )
        registry.counter(
            "cost.response_bytes",
            "attributed serialized response bytes",
            label="tenant",
            fn=lambda: self.tenant_field("response_bytes"),
        )
        registry.gauge(
            "cost.shape_units",
            "windowed mean cost units per (lane, query shape)",
            label=("lane", "shape"),
            fn=self.shape_units,
        )


def disabled_snapshot() -> dict:
    """The ``/ops/costs`` body when accounting is configured off."""
    return {"enabled": False}
