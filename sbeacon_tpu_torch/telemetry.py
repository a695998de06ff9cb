"""Unified telemetry plane: launch seam, metrics, request context,
event journal, slow-query log, device flight recorder, profiling.

Counterpart of ``sbeacon_tpu/telemetry.py``, all of it, with the
device-launch seam of this package in front of the flight recorder:

- the launch seam: ``record_device_launch`` / ``note_device_stage``,
  a launch count per kernel and a short ring of recent launch records
  (each naming its kernel and its ``family``), ``launches_by_family``;
  ``device_warmup_phase`` marks the launches its thread makes inside
  it (``warmup: true`` in their records), and a launch made under a
  request context carries its ``traceId``. A kernel wrapper calls
  ``record_device_launch`` exactly where it launches its CUDA kernel
  and nowhere else, so ``launch_count(name)`` counts real device
  launches. The plain-PyTorch twins never record. Every launch also
  lands in the process :data:`flight_recorder`;
- the metrics registry (``MetricsRegistry`` with ``Counter``, ``Gauge``
  and ``Histogram``, trace-id exemplars on histograms), rendered as
  nested JSON or as Prometheus / OpenMetrics text
  (``render_prometheus(openmetrics=)``, ``telemetry.py:412`` there);
- the per-request ``CostVector``, ``charge_cost`` and ``charge_cost_to``;
- ``RequestContext``, ``request_context``, ``current_context``,
  ``annotate`` and ``sanitize_trace_id`` for an inbound
  ``X-Beacon-Trace`` header;
- ``SlowQueryLog`` (``:765``): one structured JSON line per request
  above a latency threshold;
- the bounded event journal (``EventJournal``, ``publish_event``) with
  its paginated read (``events_page``: ``since``, a kind prefix list,
  a ``nextSince`` cursor) and ``configure``; served at ``/ops/events``;
- ``DeviceFlightRecorder`` (``:1015-1410``) and
  ``register_device_metrics`` (``:1449``): per-launch records, launch
  counts by family, pad waste, fetched bytes and the compile tracker,
  served at ``/device/status``. The port's compile tracker keys on
  what compiles on the card: a kernel library's first build or load
  (``ops._build.load``), one key per kernel. A launch runs at its
  batch's own size, so a new batch size compiles nothing. The pad
  counters count the pads a launch really carries: the scatter match
  kernel's chunk slots and the L0 segment table's ``SHARD_TIERS``
  shards; every other launch pads nothing;
- the process capture (``profiler``, a :class:`_Profiler`) on
  ``torch.profiler``: ``SBEACON_PROFILE=<dir>`` (or
  ``ObservabilityConfig.profile_dir``) starts one process-wide capture
  of CPU and CUDA activity on every thread at the batcher's first
  kernel launch, and a Chrome trace is
  exported into the directory at exit. The program marks its regions
  with ``utils.trace.span``, which records while any ``torch.profiler``
  capture runs, this one included; the JAX package's ``profile_region``
  has no counterpart here.

Stdlib only at import (torch is imported only when profiling is armed,
numpy only for percentiles) and importable from any layer.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import random
import re
import threading
import time
import uuid
from bisect import bisect_left
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

    ``observe`` is the hot-path entry: one short lock, one binary
    search of the fixed boundary tuple — no allocation. Buckets are
    cumulative at render time, Prometheus semantics.

    With ``exemplars=True`` each observation may carry a trace id
    (explicit ``exemplar=`` argument, or the ambient request context's
    id): the most recent (trace id, value, wall time) is kept per
    bucket, so a slow bucket on a dashboard links straight to the
    distributed trace that landed in it (``/_trace?trace_id=...``).
    Rendered as OpenMetrics ``# {trace_id="..."} value ts`` suffixes in
    the text exposition and an ``exemplars`` map in the JSON snapshot.
    Memory is bounded by (label values x buckets) — one slot each.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *,
                 buckets: tuple = LATENCY_BUCKETS_MS,
                 label: str | None = None,
                 exemplars: bool = False,
                 max_label_values: int | None = None):
        super().__init__(name, help, label=label,
                         max_label_values=max_label_values)
        self.buckets = tuple(float(b) for b in buckets)
        self.exemplars_enabled = bool(exemplars)
        # label_value (or "") -> [counts per bucket + overflow, count, sum]
        self._series: dict[str, list] = {}
        # (label_value, le) -> (trace_id, observed value, wall time)
        self._exemplars: dict[tuple[str, str], tuple] = {}

    def observe(self, v: float, *, label_value: str | None = None,
                exemplar: str | None = None) -> None:
        key = label_value if label_value is not None else ""
        if self.exemplars_enabled and exemplar is None:
            ctx = current_context()
            if ctx is not None:
                exemplar = ctx.trace_id
        with self._lock:
            if key:
                key = self._guard_label(key, self._series)
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [
                    [0] * (len(self.buckets) + 1), 0, 0.0
                ]
            counts, _n, _sum = s
            # the first bound at or above v; len(buckets) is the
            # overflow (+Inf) slot
            i = bisect_left(self.buckets, v)
            counts[i] += 1
            le = f"{self.buckets[i]:g}" if i < len(self.buckets) else "+Inf"
            s[1] += 1
            s[2] += v
            if self.exemplars_enabled and exemplar:
                self._exemplars[(key, le)] = (exemplar, v, time.time())

    def collect(self):
        """{label_value: {"count", "sum", "buckets": {le: cumulative}
        [, "exemplars": {le: {traceId, value, time}}]}} (unlabeled
        histograms use the single key ``""``)."""
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
            for (key, le), (tid, v, t) in self._exemplars.items():
                series = out.get(key)
                if series is not None:
                    series.setdefault("exemplars", {})[le] = {
                        "traceId": tid,
                        "value": round(v, 4),
                        "time": round(t, 3),
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
                  exemplars: bool = False,
                  max_label_values: int | None = None) -> Histogram:
        return self._register(Histogram(name, help, buckets=buckets,
                                        label=label, exemplars=exemplars,
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

    def render_prometheus(self, *, openmetrics: bool = False) -> str:
        """Prometheus text exposition. Dotted names flatten to
        underscores under the ``sbeacon_`` namespace. Exemplar
        annotations are only legal in the OpenMetrics dialect — the
        classic text format's parser rejects them — so they render
        only with ``openmetrics=True`` (which also appends the
        spec-required ``# EOF`` terminator)."""
        lines: list[str] = []
        for inst in self._snapshot():
            val = inst.collect()
            if val is None:
                continue
            pname = "sbeacon_" + inst.name.replace(".", "_")
            if inst.help:
                lines.append(f"# HELP {pname} {inst.help}")
            lines.append(f"# TYPE {pname} {inst.kind}")
            # OpenMetrics requires counter SAMPLES to be named
            # <family>_total (the TYPE line keeps the family name);
            # the classic format rejects the suffix form instead
            sname = (
                pname + "_total"
                if openmetrics and inst.kind == "counter"
                else pname
            )
            if inst.kind == "histogram":
                label = inst.label
                for key, series in sorted(val.items()):
                    base = f'{label}="{_esc(key)}",' if label and key else ""
                    exem = (
                        series.get("exemplars") or {}
                        if openmetrics
                        else {}
                    )
                    for le, cum in series["buckets"].items():
                        line = f'{pname}_bucket{{{base}le="{le}"}} {cum}'
                        ex = exem.get(le)
                        if ex is not None:
                            # OpenMetrics exemplar: the most recent
                            # observation that landed in this bucket,
                            # linked to its distributed trace
                            line += (
                                f' # {{trace_id="{_esc(ex["traceId"])}"}}'
                                f' {_num(ex["value"])} {ex["time"]:.3f}'
                            )
                        lines.append(line)
                    sfx = f"{{{base[:-1]}}}" if base else ""
                    lines.append(f"{pname}_sum{sfx} {series['sum']}")
                    lines.append(f"{pname}_count{sfx} {series['count']}")
            elif isinstance(val, dict):
                labels = inst.labels or ("key",)
                for key, v in sorted(val.items()):
                    vals = key if isinstance(key, tuple) else (key,)
                    lbl = ",".join(
                        f'{ln}="{_esc(str(lv))}"'
                        for ln, lv in zip(labels, vals)
                    )
                    lines.append(f"{sname}{{{lbl}}} {_num(v)}")
            else:
                lines.append(f"{sname} {_num(val)}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _esc(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def percentiles(xs) -> dict:
    """{p50, p95, p99} of a sample window (numpy-interpolated, 2dp),
    or {} when empty — the one summary shape every stage-timing
    producer (batcher, engine materialisation, runner admission wait)
    feeds into /debug/status and the bench records."""
    xs = list(xs)
    if not xs:
        return {}
    import numpy as np

    a = np.asarray(xs)
    return {
        "p50": round(float(np.percentile(a, 50)), 2),
        "p95": round(float(np.percentile(a, 95)), 2),
        "p99": round(float(np.percentile(a, 99)), 2),
    }


def _num(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    return f"{f:g}"


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

#: the cross-process trace header (coordinator->worker and client->API)
TRACE_HEADER = "X-Beacon-Trace"


def new_trace_id() -> str:
    """64-bit hex trace id (the Dapper convention's width)."""
    return uuid.uuid4().hex[:16]


#: acceptable inbound trace ids — anything else is replaced with a
#: fresh id, since the value is re-emitted into log lines and headers
#: (no CRLF or unbounded junk pass-through)
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


def sanitize_trace_id(raw: str | None) -> str | None:
    """``raw`` if it is a well-formed trace id, else None."""
    if raw and _TRACE_ID_RE.match(raw):
        return raw
    return None


#: span ids: 64 random bits from a generator of this process's own,
#: seeded from the OS once (again in a forked child). ``uuid4`` reads
#: the OS on every call and gives up the GIL to do so: beside one busy
#: thread a call then waits most of a switch interval to get it back
_span_ids = random.Random()
os.register_at_fork(after_in_child=_span_ids.seed)


def new_span_id() -> str:
    return f"{_span_ids.getrandbits(64):016x}"


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


def handoff_span_id() -> str:
    """The span open on the thread that handed this thread its work
    (``request_context(..., span_id=)``), or ""."""
    return getattr(_ambient, "span_id", "")


@contextmanager
def request_context(ctx: RequestContext | None, span_id: str = ""):
    """Install ``ctx`` as this thread's ambient request context
    (``None`` restores 'no context' — safe to pass through).
    ``span_id`` is the span open where the work was handed off
    (``utils.trace.current_span_id()`` there): the first span this
    thread opens inside takes it as its parent."""
    prev = getattr(_ambient, "ctx", None)
    prev_span = getattr(_ambient, "span_id", "")
    _ambient.ctx = ctx
    _ambient.span_id = span_id
    try:
        yield ctx
    finally:
        _ambient.ctx = prev
        _ambient.span_id = prev_span


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


# -- slow-query log -----------------------------------------------------------


class SlowQueryLog:
    """Structured slow-request record: any request whose latency tops
    ``threshold_ms`` emits one JSON line (trace id, route, status,
    elapsed, outcome notes) to the ``sbeacon.slowquery`` logger (and an
    optional file) and lands in a bounded in-memory ring for ``/_trace``
    adjacency. ``threshold_ms < 0`` disables; ``0`` records everything
    (debug). The fast path for a request under threshold is one float
    compare."""

    def __init__(self, threshold_ms: float = 1000.0, *,
                 keep: int = 256, path: str = ""):
        self.threshold_ms = float(threshold_ms)
        self.path = path
        self._keep = max(1, keep)
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._count = 0
        self._logger = logging.getLogger("sbeacon.slowquery")

    def count(self) -> int:
        with self._lock:
            return self._count

    def recent(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def maybe_record(self, *, trace_id: str, route: str, status: int,
                     elapsed_ms: float, notes: dict | None = None) -> bool:
        if self.threshold_ms < 0 or elapsed_ms < self.threshold_ms:
            return False
        entry = {
            "traceId": trace_id,
            "route": route,
            "status": int(status),
            "elapsedMs": round(elapsed_ms, 2),
            "thresholdMs": self.threshold_ms,
            "time": time.time(),
        }
        if notes:
            entry["notes"] = dict(notes)
        line = json.dumps(entry, sort_keys=True, default=str)
        with self._lock:
            self._count += 1
            self._ring.append(entry)
            if len(self._ring) > self._keep:
                del self._ring[: -self._keep]
        self._logger.warning("%s", line)
        if self.path:
            try:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
            except OSError:  # a full disk must not fail the request
                log.exception("slow-query log write failed")
        return True


# -- flight recorder (control-plane event journal) ----------------------------


class EventJournal:
    """Bounded structured journal of control-plane transitions — the
    flight recorder of events. Delta publishes (``ingest.delta_publish``),
    L0 builds (``ingest.l0_build``), dataset drops, cache invalidations,
    admission sheds and brownout steps (``shaping.*``), canary outcomes
    (``canary.*``), plan drift (``plan.drift``) and kernel builds outside
    warmup (``device.compile``) each publish ONE small event here,
    stamped with monotonic time (ordering survives wall clock jumps),
    wall time and the ambient trace id when the transition happened
    inside a request. ``/ops/events`` serves the ring with
    ``since``/``kind`` filters.

    Publishing is O(1): one lock, one deque append. The ring holds the
    last ``keep`` events; ``published()`` counts lifetime publishes so a
    consumer can detect it missed events that already rolled off.
    """

    def __init__(self, keep: int = 1024, *, enabled: bool = True,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.enabled = bool(enabled)
        self._keep = max(1, int(keep))
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self._keep
        )
        self._seq = 0
        self._published = 0

    def configure(self, *, keep: int | None = None,
                  enabled: bool | None = None) -> None:
        """Apply config-tier settings to an already-constructed journal
        (the process-global one is built at import from env defaults;
        ObservabilityConfig re-applies through the app)."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if keep is not None and max(1, int(keep)) != self._keep:
                self._keep = max(1, int(keep))
                self._ring = collections.deque(
                    self._ring, maxlen=self._keep
                )

    def publish(self, kind: str, **data) -> int | None:
        """Record one event; returns its sequence number (None when the
        journal is disabled). ``data`` values must be JSON-safe — the
        event is served verbatim at ``/ops/events``."""
        if not self.enabled:
            return None
        evt: dict = {"kind": kind, "tMono": round(self._clock(), 6),
                     "time": time.time()}
        ctx = current_context()
        if ctx is not None:
            evt["traceId"] = ctx.trace_id
        if data:
            evt["data"] = data
        with self._lock:
            self._seq += 1
            self._published += 1
            evt["seq"] = self._seq
            self._ring.append(evt)
        return evt["seq"]

    @staticmethod
    def _kind_matcher(kind: str):
        """``kind`` is a COMMA-SEPARATED list of filters, each
        matching exactly or by prefix (``breaker`` matches
        ``breaker.open``) — one parser for BOTH the newest-capped and
        the paginated read paths, so their filter semantics can never
        diverge."""
        kinds = [k.strip() for k in kind.split(",") if k.strip()]

        def _match(k: str) -> bool:
            return not kinds or any(
                k == want or k.startswith(want + ".") for want in kinds
            )

        return _match

    def events(self, *, since: int = 0, kind: str = "",
               limit: int = 256) -> list[dict]:
        """Events with seq > ``since``, newest last, optionally
        filtered by kind (comma-separated exact-or-prefix list — an
        operator correlating two control planes tails ONE interleaved
        stream), capped at the most recent ``limit``."""
        _match = self._kind_matcher(kind)
        with self._lock:
            evs = [
                dict(e)
                for e in self._ring
                if e["seq"] > since and _match(e["kind"])
            ]
        limit = int(limit)
        return evs[-limit:] if limit > 0 else []

    def events_page(
        self, *, since: int = 0, kind: str = "", limit: int = 256
    ) -> tuple[list[dict], int]:
        """Forward pagination for tailing clients:
        the OLDEST ``limit`` matching events with seq > ``since`` plus a
        ``nextSince`` cursor — pass it back as ``since`` to resume with
        no re-reads and no silently skipped middle (the newest-capped
        :meth:`events` drops a burst's middle entries, so a tailer had
        to guess the next monotonic stamp). When the page is truncated
        the cursor is the last returned seq (more pages follow); when
        the caller is caught up it jumps to the journal head, so
        filtered tails skip non-matching events instead of rescanning
        them every poll. Entries that rolled off the ring during the
        client's gap are gone either way — ``published()`` vs the count
        consumed detects that loss."""
        _match = self._kind_matcher(kind)
        limit = int(limit)
        if limit <= 0:
            return [], int(since)
        page: list[dict] = []
        truncated = False
        with self._lock:
            # stop at limit+1 matches: a far-behind tailer must cost a
            # page's worth of copies under the lock, not a full-ring
            # copy discarded down to `limit` (publish_event contends
            # on this lock from control-plane hot paths)
            for e in self._ring:
                if e["seq"] > since and _match(e["kind"]):
                    if len(page) == limit:
                        truncated = True
                        break
                    page.append(dict(e))
            head = self._seq
        if truncated:  # resume right after this page
            return page, page[-1]["seq"]
        return page, max(int(since), head)

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def published(self) -> int:
        with self._lock:
            return self._published


def _env_journal() -> EventJournal:
    from .config import ENV_OFF

    size = os.environ.get("BEACON_EVENT_JOURNAL_SIZE", "") or "1024"
    enabled = os.environ.get(
        "BEACON_EVENT_JOURNAL_ENABLED", ""
    ).lower() not in ENV_OFF
    try:
        keep = int(size)
    except ValueError:
        keep = 1024
    return EventJournal(keep=keep, enabled=enabled)


#: the process event journal: control-plane sites publish here via
#: :func:`publish_event`; ``/ops/events`` serves it. Process-global
#: like ``profiler``: the engine and the shaper live below the app
#: layer and need no registry reference to be observable.
journal = _env_journal()


def publish_event(kind: str, **data) -> int | None:
    """Publish one control-plane event to the process journal."""
    return journal.publish(kind, **data)



# -- device-plane flight recorder ---------------------------------------------


#: the program families the device plane dispatches, as launch records
#: name them: the scatter match kernel (``scatter``), the bisection
#: query kernel over the fused stack (``fused``) and over the delta
#: tail's L0 index (``fused_l0``), the selected-samples and plane-stats
#: kernels (``plane``, as the JAX package names its plane programs),
#: the stacked kernels and the ring step (``mesh``), the mesh-fused
#: kernel in its layouts (``mesh_replicated``, ``mesh_sliced``, and
#: ``plane`` with planes) and the distinct count (``distinct``)
DEVICE_FAMILIES = (
    "scatter",
    "fused",
    "fused_l0",
    "mesh",
    "mesh_replicated",
    "mesh_sliced",
    "plane",
    "distinct",
)


class DeviceFlightRecorder:
    """Per-launch telemetry for every device kernel — the device-plane
    twin of the control plane's :class:`EventJournal`.

    - a bounded **launch ring**: kernel, program family, slot tier,
      real-vs-padded slots (padding-waste ratio), evaluated pairs,
      launch/fetch ms and the ambient trace id per launch;
    - lifetime **counters** under one lock;
    - a **compile tracker**: the first build or load of a kernel
      library in the process is its compile (one key per kernel); one
      observed outside a warmup phase emits a ``device.compile`` journal
      event and ticks ``device.mid_request_compiles``.

    Everything is O(1) per launch (one short lock, dict upserts) and
    every read snapshots under the same short lock — never an engine
    lock — so ``/device/status`` answers while a stack rebuild is in
    flight.
    """

    def __init__(self, ring_size: int = 256, *,
                 compile_tracking: bool = True):
        self._lock = threading.Lock()
        self._keep = max(1, int(ring_size))
        self._ring: "collections.deque[dict]" = collections.deque()
        self._by_seq: dict[int, dict] = {}
        self._recorded = 0
        self.compile_tracking = bool(compile_tracking)
        self._families: dict[str, int] = {}
        self._sliced = 0
        self._pairs = 0
        # padding accounting: family -> [real, padded] slots, and
        # (family, tier) -> [real, padded] for the tier view
        self._pad: dict[str, list] = {}
        self._pad_tier: dict[tuple, list] = {}
        self._fetched_bytes = 0
        # no upload buffer is ever donated in this package: the counter
        # stays for the catalogue
        self._donated = 0
        self._compiles: dict[str, dict] = {}
        self._mid_request = 0
        self._last_mid: dict | None = None

    def configure(self, *, ring_size: int | None = None,
                  compile_tracking: bool | None = None) -> None:
        """Apply config-tier settings to the process-global recorder
        (built at import from env defaults, like :data:`journal`)."""
        with self._lock:
            if compile_tracking is not None:
                self.compile_tracking = bool(compile_tracking)
            if ring_size is not None:
                self._keep = max(1, int(ring_size))
                while len(self._ring) > self._keep:
                    old = self._ring.popleft()
                    self._by_seq.pop(old["seq"], None)

    # -- the write seams --------------------------------------------------------

    def record_launch(
        self,
        family: str,
        *,
        seq: int,
        kernel: str = "",
        tier: int,
        specs_real: int,
        specs_padded: int,
        evaluated_pairs: int = 0,
        launch_ms: float = 0.0,
        sliced: bool = False,
        warmup: bool = False,
    ) -> None:
        """Record ONE device launch under the seam's sequence number
        ``seq`` (the handle :meth:`note_stage` attaches timings and
        pad corrections to)."""
        specs_real = int(specs_real)
        specs_padded = max(int(specs_padded), specs_real, 1)
        rec: dict = {
            "family": family,
            "kernel": kernel,
            "tier": int(tier),
            "specs": specs_real,
            "padded": specs_padded,
            "padWaste": round(1.0 - specs_real / specs_padded, 4),
            "evaluatedPairs": int(evaluated_pairs),
            "launchMs": round(float(launch_ms), 3),
            "time": time.time(),
            "seq": int(seq),
        }
        if sliced:
            rec["sliced"] = True
        if warmup:
            rec["warmup"] = True
        ctx = current_context()
        if ctx is not None:
            rec["traceId"] = ctx.trace_id
        with self._lock:
            self._recorded += 1
            self._families[family] = self._families.get(family, 0) + 1
            if sliced:
                self._sliced += 1
            self._pairs += int(evaluated_pairs)
            pad = self._pad.setdefault(family, [0, 0])
            pad[0] += specs_real
            pad[1] += specs_padded
            ptier = self._pad_tier.setdefault((family, int(tier)), [0, 0])
            ptier[0] += specs_real
            ptier[1] += specs_padded
            self._ring.append(rec)
            self._by_seq[rec["seq"]] = rec
            while len(self._ring) > self._keep:
                old = self._ring.popleft()
                self._by_seq.pop(old["seq"], None)

    def record_build(self, kernel: str, duration_ms: float, *,
                     warmup: bool) -> None:
        """The compile tracker's seam: ``kernel``'s library was built or
        loaded for the first time in this process (``ops._build.load``).
        Outside a warmup phase it is a mid-request compile."""
        evt = None
        with self._lock:
            if not self.compile_tracking or kernel in self._compiles:
                return
            entry = {
                "key": kernel,
                "family": kernel,
                "tier": 0,
                "durationMs": round(float(duration_ms), 3),
                "time": time.time(),
                "warmup": bool(warmup),
            }
            self._compiles[kernel] = entry
            if not warmup:
                self._mid_request += 1
                self._last_mid = entry
                evt = entry
        if evt is not None:
            # outside the recorder lock: the journal has its own
            publish_event(
                "device.compile",
                program=kernel,
                shape=evt["key"],
                tier=evt["tier"],
                durationMs=evt["durationMs"],
            )

    def note_stage(self, seq: int, *, encode_ms: float | None = None,
                   fetch_ms: float | None = None,
                   fetch_bytes: int | None = None,
                   specs_real: int | None = None) -> None:
        """Attach a stage timing to a recorded launch, or correct its
        real slot count (``specs_real``: the scatter match kernel learns
        how many of its chunk slots were pads after the launch). The
        per-record annotation no-ops once the record rolled off the
        ring; ``fetch_bytes`` and the pad correction still count."""
        with self._lock:
            if fetch_bytes is not None:
                self._fetched_bytes += int(fetch_bytes)
            rec = self._by_seq.get(seq)
            if rec is None:
                return
            if encode_ms is not None:
                rec["encodeMs"] = round(float(encode_ms), 3)
            if fetch_ms is not None:
                rec["fetchMs"] = round(float(fetch_ms), 3)
            if fetch_bytes is not None:
                rec["fetchBytes"] = int(fetch_bytes)
            if specs_real is not None:
                real = min(int(specs_real), rec["padded"])
                delta = real - rec["specs"]
                rec["specs"] = real
                rec["padWaste"] = round(1.0 - real / rec["padded"], 4)
                self._pad[rec["family"]][0] += delta
                self._pad_tier[(rec["family"], rec["tier"])][0] += delta

    # -- read surfaces --------------------------------------------------------

    @property
    def evaluated_pairs(self) -> int:
        with self._lock:
            return self._pairs

    @property
    def fetched_bytes(self) -> int:
        with self._lock:
            return self._fetched_bytes

    @property
    def donated_buffers(self) -> int:
        with self._lock:
            return self._donated

    def launches_by_family(self) -> dict:
        with self._lock:
            return dict(self._families)

    def _pad_waste_by_family_locked(self) -> dict:
        return {
            f: round(1.0 - real / padded, 4)
            for f, (real, padded) in self._pad.items()
            if padded
        }

    def pad_waste_by_family(self) -> dict:
        """{family: lifetime padding-waste ratio} — pad slots over all
        launched slots."""
        with self._lock:
            return self._pad_waste_by_family_locked()

    def _worst_pad_waste_locked(self) -> dict | None:
        worst = None
        for (family, tier), (real, padded) in self._pad_tier.items():
            if not padded:
                continue
            waste = 1.0 - real / padded
            if worst is None or waste > worst[0]:
                worst = (waste, family, tier)
        if worst is None:
            return None
        return {
            "family": worst[1],
            "tier": worst[2],
            "waste": round(worst[0], 4),
        }

    def worst_pad_waste(self) -> dict | None:
        """The worst (family, tier) padding-waste cell, or None before
        any launch — ``/debug/status`` diagnosis material."""
        with self._lock:
            return self._worst_pad_waste_locked()

    def mid_request_compiles(self) -> int:
        with self._lock:
            return self._mid_request

    def last_mid_request_compile(self) -> dict | None:
        with self._lock:
            return dict(self._last_mid) if self._last_mid else None

    def _compile_snapshot_locked(self) -> dict:
        entries = [dict(e) for e in self._compiles.values()]
        return {
            "enabled": self.compile_tracking,
            "programs": len(entries),
            "midRequestCompiles": self._mid_request,
            "lastMidRequestCompile": (
                dict(self._last_mid) if self._last_mid else None
            ),
            "warmupShapes": sorted(
                e["key"] for e in entries if e["warmup"]
            ),
            "entries": sorted(entries, key=lambda e: e["time"]),
        }

    def compile_snapshot(self) -> dict:
        """The kernels built or loaded, against the warmup set."""
        with self._lock:
            return self._compile_snapshot_locked()

    def launch_summary(self) -> dict:
        """The compact rollup (no ring) ``/debug/status`` embeds."""
        with self._lock:
            return {
                "total": sum(self._families.values()),
                "byFamily": dict(self._families),
                "sliced": self._sliced,
                "evaluatedPairs": self._pairs,
            }

    def snapshot(self) -> dict:
        """The ``/device/status`` launch document: counters, the ring
        (oldest first), padding waste by family and tier, and the
        compile tracker — assembled under ONE lock hold, so the ring and
        the counters describe the same instant."""
        with self._lock:
            ring = [dict(r) for r in self._ring]
            families = dict(self._families)
            by_tier = {
                f"{family}:{tier}": round(1.0 - real / padded, 4)
                for (family, tier), (real, padded)
                in sorted(self._pad_tier.items())
                if padded
            }
            return {
                "total": sum(families.values()),
                "byFamily": families,
                "sliced": self._sliced,
                "evaluatedPairs": self._pairs,
                "fetchedBytes": self._fetched_bytes,
                "donatedBuffers": self._donated,
                "ring": {"size": self._keep, "recorded": self._recorded,
                         "entries": ring},
                "padWaste": {
                    "byFamily": self._pad_waste_by_family_locked(),
                    "byTier": by_tier,
                    "worst": self._worst_pad_waste_locked(),
                },
                "compiles": self._compile_snapshot_locked(),
            }


def _env_flight_recorder() -> DeviceFlightRecorder:
    from .config import ENV_OFF

    raw = os.environ.get("BEACON_DEVICE_RING_SIZE", "") or "256"
    try:
        ring = int(raw)
    except ValueError:
        ring = 256
    tracking = os.environ.get(
        "BEACON_COMPILE_TRACKING", ""
    ).lower() not in ENV_OFF
    return DeviceFlightRecorder(ring, compile_tracking=tracking)


#: the process device-plane flight recorder. Process-global like
#: ``journal``: the kernel modules live below the app layer and need no
#: registry reference to be observable.
flight_recorder = _env_flight_recorder()


def register_device_metrics(registry) -> None:
    """The device-plane series, callback-backed off the process
    recorder (call once per registry)."""
    registry.counter(
        "device.launches",
        "device kernel launches by family (scatter / fused / fused_l0 "
        "/ mesh / mesh_replicated / mesh_sliced / plane / distinct)",
        label="family",
        fn=lambda: flight_recorder.launches_by_family(),
    )
    registry.counter(
        "device.evaluated_pairs",
        "evaluated (device, query-slot) pairs summed over all mesh "
        "launches — the per-device work proxy",
        fn=lambda: flight_recorder.evaluated_pairs,
    )
    registry.gauge(
        "device.pad_waste",
        "lifetime padding-waste ratio by program family (pad slots "
        "launched / all slots launched)",
        label="family",
        fn=lambda: flight_recorder.pad_waste_by_family(),
    )
    registry.counter(
        "device.mid_request_compiles",
        "kernel library builds or loads observed OUTSIDE a warmup phase",
        fn=lambda: flight_recorder.mid_request_compiles(),
    )
    registry.counter(
        "device.fetched_bytes",
        "bytes result fetches materialised on host across all kernel "
        "families",
        fn=lambda: flight_recorder.fetched_bytes,
    )
    registry.counter(
        "device.donated_buffers",
        "query-batch buffers donated to their launch (none in this "
        "package)",
        fn=lambda: flight_recorder.donated_buffers,
    )


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
    :func:`device_warmup_phase` is marked ``warmup: true``.

    The launch also lands in the process :data:`flight_recorder` under
    its ``family`` (the kernel's name when it names none), its slots
    being ``pad_real`` of ``pad_slots`` when the caller launches pads,
    else its ``specs``, ``slots`` or ``rows`` (one for a launch with
    none of those), unpadded; ``sliced`` marks a sliced mesh layout."""
    global _seq
    warm = bool(getattr(_warmup, "depth", 0))
    ctx = current_context()
    with _lock:
        _counts[kernel] = _counts.get(kernel, 0) + 1
        fam = kw.get("family")
        if fam is not None:
            _families[fam] = _families.get(fam, 0) + 1
        _seq += 1
        seq = _seq
        rec = {"seq": seq, "kernel": kernel, **kw}
        if warm:
            rec["warmup"] = True
        if ctx is not None:
            rec["traceId"] = ctx.trace_id
        _recent.append(rec)
    real = kw.get("pad_real")
    if real is None:
        real = kw.get("specs", kw.get("slots", kw.get("rows", 1)))
    padded = kw.get("pad_slots", real)
    flight_recorder.record_launch(
        fam or kernel,
        seq=seq,
        kernel=kernel,
        tier=padded,
        specs_real=real,
        specs_padded=padded,
        evaluated_pairs=kw.get("evaluated_pairs", 0),
        launch_ms=kw.get("launch_ms", 0.0),
        sliced=bool(kw.get("sliced", False)),
        warmup=warm,
    )
    return seq


@contextmanager
def device_warmup_phase():
    """``with device_warmup_phase(): engine.warmup()``: the launches the
    calling thread makes inside the scope are warmup launches, not
    serving ones (launches on other threads meanwhile are not marked),
    and the kernel libraries it builds or loads are expected compiles."""
    _warmup.depth = getattr(_warmup, "depth", 0) + 1
    try:
        yield
    finally:
        _warmup.depth -= 1


def in_warmup_phase() -> bool:
    """True inside this thread's :func:`device_warmup_phase`."""
    return bool(getattr(_warmup, "depth", 0))


def launches_by_family() -> dict:
    """{family: launches} since the last :func:`reset_launch_counts`."""
    with _lock:
        return dict(_families)


def note_device_stage(seq, **kw) -> None:
    """Attach stage timings (e.g. ``fetch_ms``) to a recorded launch;
    ``seq=None`` (a CPU run, which launched nothing) no-ops. The flight
    recorder takes ``encode_ms``, ``fetch_ms``, ``fetch_bytes`` and
    ``specs_real`` (the real slots of a padded launch)."""
    if seq is None:
        return
    flight_recorder.note_stage(
        seq, **{k: kw[k] for k in ("encode_ms", "fetch_ms", "fetch_bytes",
                                   "specs_real") if k in kw}
    )
    with _lock:
        for rec in reversed(_recent):
            if rec["seq"] == seq:
                rec.update(kw)
                return


def launch_count(kernel: str) -> int:
    with _lock:
        return _counts.get(kernel, 0)


def launch_counts() -> dict:
    """{kernel: launches} since the last :func:`reset_launch_counts`."""
    with _lock:
        return dict(_counts)


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


# -- the process capture -----------------------------------------------------


class _Profiler:
    """``SBEACON_PROFILE=<dir>`` (or ``ObservabilityConfig.profile_dir``)
    arms one process-wide ``torch.profiler`` capture of CPU and CUDA
    activity on every thread (``profile_all_threads`` where this torch
    has it: the batcher launches from pool threads), started by the
    batcher's first kernel launch. While it runs, every program span
    records a ``sbeacon.<name>`` range in it. At exit (or :meth:`stop`)
    the trace is exported as Chrome JSON into the directory
    (``exported`` names the file)."""

    def __init__(self, directory: str | None = None):
        if directory is None:
            directory = os.environ.get("SBEACON_PROFILE", "")
        self.directory = directory
        self._lock = threading.Lock()
        self._started = False
        self._failed = False
        self._prof = None
        #: the exported trace's path, once written
        self.exported: str | None = None

    @property
    def pending(self) -> bool:
        """Armed, and not started (nor failed to start) yet."""
        return bool(self.directory) and not (self._started or self._failed)

    def start(self) -> bool:
        """Start the capture (once per process); False when unarmed or
        when this torch cannot profile."""
        with self._lock:
            if self._started:
                return True
            if self._failed or not self.directory:
                return False
            try:
                import atexit

                import torch
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                kw = {}
                try:
                    kw["experimental_config"] = (
                        torch._C._profiler._ExperimentalConfig(
                            profile_all_threads=True
                        )
                    )
                except (AttributeError, TypeError):
                    pass  # this torch profiles the starting thread only
                os.makedirs(self.directory, exist_ok=True)
                prof = profile(activities=activities, **kw)
                prof.start()
                self._prof = prof
                atexit.register(self.stop)
                self._started = True
                return True
            except Exception:
                # profiling is an optimisation aid, never a dependency
                log.exception("torch profiler unavailable; disabling")
                self._failed = True
                return False

    def stop(self) -> str | None:
        """Stop the capture and export it; returns the trace's path
        (None when nothing was captured)."""
        with self._lock:
            prof, self._prof = self._prof, None
        if prof is None:
            return self.exported
        try:
            prof.stop()
            path = os.path.join(
                self.directory, f"sbeacon-trace-{os.getpid()}.json"
            )
            prof.export_chrome_trace(path)
            self.exported = path
        except Exception:
            log.exception("torch profiler export failed")
        return self.exported


profiler = _Profiler()
