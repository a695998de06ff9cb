"""Telemetry of the port: the device-launch seam, metrics, request context.

Counterpart of ``sbeacon_tpu/telemetry.py``, trimmed to what the
serving path calls:

- the launch seam: ``record_device_launch`` / ``note_device_stage``,
  a launch count per kernel and a short ring of recent launch records
  (each naming its kernel and its ``family``), ``launches_by_family``;
  ``device_warmup_phase`` marks the launches its thread makes inside
  it (``warmup: true`` in their records). A kernel wrapper calls
  ``record_device_launch`` exactly where it launches its CUDA kernel
  and nowhere else, so ``launch_count(name)`` counts real device
  launches. The plain-PyTorch twins never record;
- the metrics registry (``MetricsRegistry`` with ``Counter``, ``Gauge``
  and ``Histogram``; ``telemetry.py:88-475``), rendered as nested JSON;
- the per-request ``CostVector``, ``charge_cost`` and
  ``charge_cost_to`` (``:509-634``);
- ``RequestContext``, ``request_context``, ``current_context`` and
  ``annotate`` (``:636-764``);
- the bounded event journal, ``publish_event`` and its reader
  ``EventJournal.events`` (``:825-1003``, without the env configuration
  and the paginated read).

The slow-query log, the device flight recorder's compile tracker and
``jax.profiler`` regions are not ported yet.
"""

from __future__ import annotations

import collections
import logging
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

log = logging.getLogger(__name__)

# -- metric instruments -------------------------------------------------------

#: fixed request/stage latency bucket upper bounds, in milliseconds
#: (Prometheus-style cumulative buckets; +Inf is implicit)
LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

#: instrument names are stable dotted lowercase identifiers —
#: ``tools/check_metric_names.py`` enforces the same grammar statically
_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")


#: default cap on distinct label values a value-owning instrument may
#: mint per family; overflow collapses to :data:`OVERFLOW_LABEL` and
#: ticks the registry's ``telemetry.label_overflow`` counter — the
#: registry-level twin of shaping's 64-tenant cap, so NO producer can
#: turn attacker-controlled input into unbounded series
DEFAULT_MAX_LABEL_VALUES = 64
#: the shared bucket overflowing label values collapse into
OVERFLOW_LABEL = "other"


class _Instrument:
    """Shared base: a named, optionally labeled, typed series.

    ``fn`` makes the instrument callback-backed (collector style): the
    callback returns the current value — a number, or a
    ``{label_value: number}`` dict when ``label`` is set. Without
    ``fn`` the instrument owns its value(s) under a short lock.

    ``label`` may also be a TUPLE of label names (e.g. ``("route",
    "window")``): the value dict is then keyed by matching tuples of
    label values, rendered as multi-label Prometheus series and as
    nested maps in the JSON snapshot.

    Value-owning labeled instruments enforce a **cardinality guard**:
    at most ``max_label_values`` distinct label values are ever minted
    per family; further values collapse into the shared ``"other"``
    bucket and tick ``telemetry.label_overflow{family=...}``. (Before
    this guard only shaping's tenant classifier enforced a cap — the
    registry itself would happily mint a series per attacker-chosen
    header value.) Callback-backed instruments are exempt: their
    producer owns the state and its bounds.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str = "", *,
                 fn=None, label=None, json_render: bool = True,
                 max_label_values: int | None = None):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must be dotted lowercase "
                "(e.g. 'batcher.launches')"
            )
        self.name = name
        self.help = help
        self.fn = fn
        self.label = label
        #: normalized label-name tuple (None = unlabeled)
        self.labels: tuple[str, ...] | None = (
            None
            if label is None
            else (label,) if isinstance(label, str) else tuple(label)
        )
        #: False = Prometheus-only (used where the back-compat JSON
        #: shape differs from the dotted nesting, e.g. breaker state)
        self.json_render = json_render
        self.max_label_values = int(
            max_label_values
            if max_label_values is not None
            else DEFAULT_MAX_LABEL_VALUES
        )
        #: the registry's shared label-overflow counter (set at
        #: registration; None on free-standing instruments)
        self._overflow = None
        self._lock = threading.Lock()
        self._value = 0.0
        self._children: dict[str, float] = {}

    def _guard_label(self, label_value, children: dict):
        """The label value to actually mint, under the cardinality
        guard (call holding ``self._lock``): a NEW value on a family
        already at its cap collapses to ``"other"``."""
        if (
            label_value is None
            or label_value in children
            or len(children) < self.max_label_values
        ):
            return label_value
        ov = self._overflow
        if ov is not None and ov is not self:
            ov.inc(label_value=self.name)
        if isinstance(label_value, tuple):
            return (OVERFLOW_LABEL,) * len(label_value)
        return OVERFLOW_LABEL

    def _bump(self, n: float, label_value: str | None) -> None:
        with self._lock:
            if label_value is None:
                self._value += n
            else:
                label_value = self._guard_label(
                    label_value, self._children
                )
                self._children[label_value] = (
                    self._children.get(label_value, 0.0) + n
                )

    def collect(self):
        """Current value: a number, or {label_value: number}."""
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:  # a broken callback must not kill /metrics
                log.exception("metric %s callback failed", self.name)
                return None
        with self._lock:
            if self.label is not None:
                return dict(self._children)
            return self._value


class Counter(_Instrument):
    """Monotonic cumulative count (requests served, cache hits)."""

    kind = "counter"

    def inc(self, n: float = 1.0, *, label_value: str | None = None) -> None:
        self._bump(n, label_value)


class Gauge(_Instrument):
    """Point-in-time level (queue depth, entries resident)."""

    kind = "gauge"

    def set(self, v: float, *, label_value: str | None = None) -> None:
        with self._lock:
            if label_value is None:
                self._value = float(v)
            else:
                label_value = self._guard_label(
                    label_value, self._children
                )
                self._children[label_value] = float(v)


class Histogram(_Instrument):
    """Fixed-bucket latency histogram with per-label-value children.

    ``observe`` is the hot-path entry: one short lock, one linear
    bucket scan over the fixed boundary tuple (13 compares) — no
    allocation. Buckets are cumulative at render time, Prometheus
    semantics. (The JAX package's trace-id exemplars ride its
    OpenMetrics exposition, which comes with the HTTP surface.)
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *,
                 buckets: tuple = LATENCY_BUCKETS_MS,
                 label: str | None = None,
                 max_label_values: int | None = None):
        super().__init__(name, help, label=label,
                         max_label_values=max_label_values)
        self.buckets = tuple(float(b) for b in buckets)
        # label_value (or "") -> [counts per bucket + overflow, count, sum]
        self._series: dict[str, list] = {}

    def observe(self, v: float, *, label_value: str | None = None) -> None:
        key = label_value if label_value is not None else ""
        with self._lock:
            if key:
                key = self._guard_label(key, self._series)
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [
                    [0] * (len(self.buckets) + 1), 0, 0.0
                ]
            counts = s[0]
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s[1] += 1
            s[2] += v

    def collect(self):
        """{label_value: {"count", "sum", "buckets": {le: cumulative}}}
        (unlabeled histograms use the single key ``""``)."""
        out = {}
        with self._lock:
            for key, (counts, n, total) in self._series.items():
                cum, acc = {}, 0
                for b, c in zip(self.buckets, counts):
                    acc += c
                    cum[f"{b:g}"] = acc
                cum["+Inf"] = acc + counts[-1]
                out[key] = {
                    "count": n,
                    "sum": round(total, 3),
                    "buckets": cum,
                }
        return out


class MetricsRegistry:
    """One process surface of typed series with stable dotted names.

    Registration raises on duplicates so renames/collisions break at
    wiring time (and in CI via ``tools/check_metric_names.py``), not
    silently on a dashboard.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        # the registry's own cardinality-guard evidence: one family
        # label per instrument that ever collapsed a label value to
        # "other" (family names are bounded by the registrations)
        registry = self
        self._label_overflow = registry.counter(
            "telemetry.label_overflow",
            "label values collapsed to 'other' by the cardinality guard",
            label="family",
        )

    def _register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            if inst.name in self._instruments:
                raise ValueError(f"metric {inst.name!r} already registered")
            self._instruments[inst.name] = inst
            # wire the shared overflow counter into every value-owning
            # instrument (the counter itself guards via its own cap)
            inst._overflow = getattr(self, "_label_overflow", None)
        return inst

    def counter(self, name: str, help: str = "", *,
                fn=None, label=None,
                json_render: bool = True,
                max_label_values: int | None = None) -> Counter:
        return self._register(
            Counter(name, help, fn=fn, label=label,
                    json_render=json_render,
                    max_label_values=max_label_values)
        )

    def gauge(self, name: str, help: str = "", *,
              fn=None, label=None,
              json_render: bool = True,
              max_label_values: int | None = None) -> Gauge:
        return self._register(
            Gauge(name, help, fn=fn, label=label,
                  json_render=json_render,
                  max_label_values=max_label_values)
        )

    def histogram(self, name: str, help: str = "", *,
                  buckets: tuple = LATENCY_BUCKETS_MS,
                  label: str | None = None,
                  max_label_values: int | None = None) -> Histogram:
        return self._register(Histogram(name, help, buckets=buckets,
                                        label=label,
                                        max_label_values=max_label_values))

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def _snapshot(self) -> list[_Instrument]:
        with self._lock:
            return [self._instruments[k] for k in sorted(self._instruments)]

    # -- renderings ----------------------------------------------------------

    def render_json(self) -> dict:
        """Nested-by-dots snapshot: ``batcher.launcher.queued`` renders
        as ``{"batcher": {"launcher": {"queued": N}}}`` — the exact
        shape the old hand-assembled ``/metrics`` dict had, so
        dashboards and tests keep their keys."""
        out: dict = {}
        for inst in self._snapshot():
            if not inst.json_render:
                continue
            val = inst.collect()
            if val is None:
                continue
            if inst.kind == "histogram" and isinstance(val, dict):
                # unlabel single-series histograms for readability
                if set(val) == {""}:
                    val = val[""]
            elif (
                isinstance(val, dict)
                and val
                and isinstance(next(iter(val)), tuple)
            ):
                # multi-label series nest by label value:
                # {("g_variants", "5m"): 2.0} -> {"g_variants": {"5m": 2.0}}
                nested: dict = {}
                for key_tuple, v in val.items():
                    node = nested
                    for part in key_tuple[:-1]:
                        node = node.setdefault(str(part), {})
                    node[str(key_tuple[-1])] = v
                val = nested
            node = out
            parts = inst.name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
        return out


def percentiles(xs) -> dict:
    """{'p50', 'p90', 'p99'} of a sample (empty dict when empty)."""
    xs = sorted(xs)
    if not xs:
        return {}
    pick = lambda p: xs[min(len(xs) - 1, int(p * len(xs)))]
    return {"p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99)}


# -- per-request cost vector ---------------------------------------------------


class CostVector:
    """The resource cost ONE request incurred, accumulated additively
    by the instrumentation points along its path:

    - ``device_us`` — device-launch microseconds, pro-rated from the
      batcher's measured per-launch execute time to this request's
      share of the launch's query specs (serving.py);
    - ``host_rows`` — candidate rows walked by the numpy host matcher
      (``engine.host_match_rows`` — per-shard fallbacks, overflow
      paths, and the delta tail);
    - ``delta_shards`` — delta-tail shards walked for this query
      (engine / mesh-tier per-shard host dispatch);
    - ``worker_rtt_ms`` — coordinator->worker round-trip time on
      successful ``/search`` legs (a worker was occupied that long on
      this request's behalf);
    - ``queue_wait_ms`` — time queued (fair-queue admission wait +
      micro-batch wait); contention, not resource cost, so it is
      excluded from the cost-unit scalar but attributed per tenant;
    - ``response_bytes`` — serialized response size;
    - ``cache`` — response-cache outcome (``hit`` / ``negative_hit`` /
      ``miss`` / ``""`` when the cache never saw the query).

    One vector rides each :class:`RequestContext`; charges without an
    ambient context fall into the process-global
    :data:`UNATTRIBUTED_COST` residue so the accounting plane can
    prove what fraction of measured work it attributed. Additive
    updates take one short lock — engine scatter threads and the
    batcher's fetcher thread charge the same vector concurrently.
    """

    NUMERIC = (
        "device_us",
        "host_rows",
        "delta_shards",
        "worker_rtt_ms",
        "queue_wait_ms",
        "response_bytes",
    )

    __slots__ = NUMERIC + ("cache", "_sealed", "_lock")

    def __init__(self):
        for f in self.NUMERIC:
            setattr(self, f, 0.0)
        self.cache = ""
        self._sealed = False
        self._lock = threading.Lock()

    def add(self, *, cache: str | None = None, **fields) -> None:
        """Accumulate numeric fields (and/or set the cache outcome).
        Unknown field names raise — a typo'd charge site must fail in
        tests, not silently leak cost. Charges landing AFTER the
        vector was :meth:`seal`-ed (the request already folded into
        the accounting table — e.g. a launch completing after its
        submitter 504ed, or a losing hedge leg's RTT) redirect to the
        unattributed residue, so they appear in the attribution
        DENOMINATOR instead of vanishing from both sides."""
        with self._lock:
            sealed = self._sealed
            if not sealed:
                for k, v in fields.items():
                    if k not in self.NUMERIC:
                        raise ValueError(f"unknown cost field {k!r}")
                    setattr(self, k, getattr(self, k) + float(v))
                if cache:
                    self.cache = cache
        if sealed and self is not UNATTRIBUTED_COST:
            UNATTRIBUTED_COST.add(cache=cache, **fields)

    def seal(self) -> None:
        """Mark the vector folded: later charges go to the residue."""
        with self._lock:
            self._sealed = True

    def snapshot(self) -> dict:
        with self._lock:
            out = {f: getattr(self, f) for f in self.NUMERIC}
            out["cache"] = self.cache
        return out

    def nonzero(self) -> bool:
        with self._lock:
            return bool(self.cache) or any(
                getattr(self, f) for f in self.NUMERIC
            )

    def as_dict(self) -> dict:
        """Compact rounded rendering for slow-query-log records and
        ``/debug/status`` — zero fields are dropped."""
        snap = self.snapshot()
        out = {}
        for f in self.NUMERIC:
            v = snap[f]
            if v:
                out[f] = round(v, 2)
        if snap["cache"]:
            out["cache"] = snap["cache"]
        return out


#: process-global residue: charges that land with NO ambient request
#: context (warmup launches, background drains, abandoned waiters)
#: accumulate here, so ``/ops/costs`` can report an attribution ratio
#: instead of silently dropping unowned work
UNATTRIBUTED_COST = CostVector()


def charge_cost(**fields) -> None:
    """Charge the current request's cost vector (ambient context), or
    the process-global unattributed residue when off-request. The
    no-context fast path is one thread-local read."""
    ctx = getattr(_ambient, "ctx", None)
    vec = ctx.cost if ctx is not None else UNATTRIBUTED_COST
    vec.add(**fields)


def charge_cost_to(ctx, **fields) -> None:
    """Charge an EXPLICIT request context's cost vector (pool threads
    holding a captured context, e.g. the batcher's fetcher stage);
    ``ctx=None`` charges the unattributed residue."""
    vec = ctx.cost if ctx is not None else UNATTRIBUTED_COST
    vec.add(**fields)


# -- request context / distributed tracing ------------------------------------


def new_trace_id() -> str:
    """64-bit hex trace id (the Dapper convention's width)."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestContext:
    """Ambient per-request identity: one trace id from ingress to every
    worker hop, plus an outcome-notes dict producers annotate (cache
    hit/miss, fused/mesh path, breaker trips) that the slow-query log
    snapshots. ``notes`` is copy-on-write (:func:`annotate` rebinds a
    fresh dict, never mutates in place), so a reader iterating its
    snapshot can never race a writer — an abandoned pool thread may
    still be annotating after the request returned. Two concurrent
    annotates may drop one note; acceptable for observability."""

    __slots__ = (
        "trace_id", "route", "t_start", "notes", "cost", "plan",
        "explain",
    )

    def __init__(self, trace_id: str | None = None, route: str = ""):
        self.trace_id = trace_id or new_trace_id()
        self.route = route
        self.t_start = time.perf_counter()
        self.notes: dict = {}
        #: the request's resource-cost vector: created
        #: eagerly so concurrent charge sites never race an install
        self.cost = CostVector()
        #: the request's execution-plan stage list:
        #: plan.plan_stage appends bounded entries; created eagerly
        #: like the cost vector so producers never race an install
        self.plan: list = []
        #: True when the API layer authorized ?explain=1 — the engine's
        #: cache front bypasses the response cache for explained
        #: requests (plan.explain_active)
        self.explain = False

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.t_start) * 1e3


_ambient = threading.local()


def current_context() -> RequestContext | None:
    """The request context the API layer scoped onto this thread (or
    None). Pool workers re-install the submitting request's context via
    :func:`request_context`, exactly like ambient deadlines."""
    return getattr(_ambient, "ctx", None)


@contextmanager
def request_context(ctx: RequestContext | None):
    """Install ``ctx`` as this thread's ambient request context
    (``None`` restores 'no context' — safe to pass through)."""
    prev = getattr(_ambient, "ctx", None)
    _ambient.ctx = ctx
    try:
        yield ctx
    finally:
        _ambient.ctx = prev


#: the literal registry of every outcome-note key producers may
#: ``annotate(...)`` — the slow-query log's schema, in effect. The
#: static lint ``tools/check_annotation_keys.py`` (tier-1 via
#: tests/test_telemetry.py) enforces two-way parity between this set
#: and the annotate() call sites, exactly like the metric-name lint:
#: an unregistered key is an invisible note, a registered-but-unused
#: key is a dashboard field that silently flatlined.
ANNOTATION_KEYS = frozenset({
    "batch_index",
    "batch_ms",
    "breaker",
    "dispatch",
    "dispatch_l0",
    "dispatch_tier",
    "failover",
    "granularity",
    "lane",
    "mesh_delta_tail",
    "mesh_fallback",
    "mesh_tail_l0",
    "mesh_planes",
    "mesh_shards",
    "query_job",
    "replica_hedge",
    "response_cache",
    "short_circuit",
    "tenant",
    "unavailable_datasets",
})


def annotate(**kw) -> None:
    """Attach outcome notes (``response_cache="hit"``, ``path="fused"``)
    to the current request, if any — a no-op off-request, so producers
    call it unconditionally. Copy-on-write rebind: the previous notes
    dict is never mutated, so concurrent readers (the slow-query log
    snapshotting a request an abandoned pool thread still annotates)
    cannot crash mid-iteration."""
    ctx = getattr(_ambient, "ctx", None)
    if ctx is not None:
        ctx.notes = {**ctx.notes, **kw}


# -- event journal --------------------------------------------------------------


class EventJournal:
    """Bounded structured journal of control-plane transitions (the
    JAX package's flight recorder of events): delta publishes
    (``ingest.delta_publish``), L0 builds (``ingest.l0_build``),
    dataset drops and cache invalidations each publish ONE small event,
    stamped with monotonic and wall time and the ambient trace id when
    the transition happened inside a request. Publishing is O(1): one
    lock, one deque append. The ring holds the last ``keep`` events;
    ``events`` reads them (the JAX package serves them at
    ``/ops/events``, which comes with the HTTP surface).
    """

    def __init__(self, keep: int = 1024, *, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(keep))
        )
        self._seq = 0

    def publish(self, kind: str, **data) -> int:
        """Record one event; returns its sequence number. ``data`` values
        must be JSON-safe."""
        evt: dict = {"kind": kind, "tMono": round(self._clock(), 6),
                     "time": time.time()}
        ctx = current_context()
        if ctx is not None:
            evt["traceId"] = ctx.trace_id
        if data:
            evt["data"] = data
        with self._lock:
            self._seq += 1
            evt["seq"] = self._seq
            self._ring.append(evt)
        return evt["seq"]

    def events(self, *, since: int = 0, kind: str = "") -> list[dict]:
        """Events with seq > ``since``, newest last; ``kind`` keeps
        those of that kind or of a kind under it (``ingest`` matches
        ``ingest.l0_build``)."""
        with self._lock:
            return [
                dict(e)
                for e in self._ring
                if e["seq"] > since and (
                    not kind or e["kind"] == kind
                    or e["kind"].startswith(kind + "."))
            ]


#: the process journal: control-plane sites publish here via
#: :func:`publish_event`
journal = EventJournal()


def publish_event(kind: str, **data) -> int:
    """Publish one control-plane event to the process journal."""
    return journal.publish(kind, **data)


# -- device-launch seam -----------------------------------------------------------

_lock = threading.Lock()
_counts: dict[str, int] = {}
_seq = 0
#: the most recent launch records, newest last (bounded)
_recent: deque = deque(maxlen=4096)
#: cumulative per-name totals that are not launch counts (e.g. the mesh
#: tier's evaluated (entry, query-slot) pairs)
_totals: dict[str, int] = {}
#: launches by the ``family`` their records name (the JAX flight
#: recorder's program families: ``fused`` for the fused stack,
#: ``fused_l0`` for the delta tail's L0 index, ...)
_families: dict[str, int] = {}
#: depth of the open ``device_warmup_phase`` scopes, per thread: a warm
#: launch runs on the thread that opened the scope, and serving launches
#: made meanwhile on other threads stay serving launches
_warmup = threading.local()


def record_device_launch(kernel: str, **kw) -> int:
    """Count one launch of ``kernel`` and keep its record (``kw``:
    shapes, slot counts, launch ms, ``family``). Returns the record's
    sequence number for :func:`note_device_stage`. A launch inside
    :func:`device_warmup_phase` is marked ``warmup: true``."""
    global _seq
    with _lock:
        _counts[kernel] = _counts.get(kernel, 0) + 1
        fam = kw.get("family")
        if fam is not None:
            _families[fam] = _families.get(fam, 0) + 1
        _seq += 1
        rec = {"seq": _seq, "kernel": kernel, **kw}
        if getattr(_warmup, "depth", 0):
            rec["warmup"] = True
        _recent.append(rec)
        return _seq


@contextmanager
def device_warmup_phase():
    """``with device_warmup_phase(): engine.warmup()``: the launches the
    calling thread makes inside the scope are warmup launches, not
    serving ones (launches on other threads meanwhile are not marked)."""
    _warmup.depth = getattr(_warmup, "depth", 0) + 1
    try:
        yield
    finally:
        _warmup.depth -= 1


def launches_by_family() -> dict:
    """{family: launches} since the last :func:`reset_launch_counts`."""
    with _lock:
        return dict(_families)


def note_device_stage(seq, **kw) -> None:
    """Attach stage timings (e.g. ``fetch_ms``) to a recorded launch;
    ``seq=None`` (a CPU run, which launched nothing) no-ops."""
    if seq is None:
        return
    with _lock:
        for rec in reversed(_recent):
            if rec["seq"] == seq:
                rec.update(kw)
                return


def launch_count(kernel: str) -> int:
    with _lock:
        return _counts.get(kernel, 0)


def add_total(name: str, n: int = 1) -> None:
    """Add ``n`` to the cumulative total ``name``."""
    with _lock:
        _totals[name] = _totals.get(name, 0) + int(n)


def total(name: str) -> int:
    with _lock:
        return _totals.get(name, 0)


def reset_launch_counts() -> None:
    """Zero every kernel's count and every total, and drop the launch
    records."""
    with _lock:
        _counts.clear()
        _totals.clear()
        _families.clear()
        _recent.clear()


def recent_launches() -> list[dict]:
    with _lock:
        return [dict(r) for r in _recent]
