"""SLO burn-rate engine: multi-window error-budget burn per route.

Counterpart of ``sbeacon_tpu/slo.py``, all of it: the probe-route
source ``PROBE_ROUTE_LABELS`` and the sets derived from it (``:57-111``
there), ``SloObjective``, ``parse_route_objectives`` and ``SloEngine``
(``:113-533``). Each route carries two objectives, following the
multi-window burn-rate method of the SRE workbook:

- **availability**: at most ``1 - availability_target`` of requests may
  answer 5xx (e.g. target 0.999 -> 0.1% error budget);
- **latency**: at least ``latency_target`` of non-5xx requests must
  finish under ``latency_ms``.

Good/bad counts land in ring-buffered per-bucket counters spanning the
longest window, and the **burn rate** over a window is ``observed bad
ratio / error budget``. A route is **breached** when BOTH the fast (5m)
and slow (1h) windows burn above the alert factor.

Objectives are declared in :class:`~sbeacon_tpu_torch.config.
ObservabilityConfig` (``BEACON_SLO_*`` env): one default objective plus
per-route overrides. Stdlib only, with an injectable clock; ``record``
is O(1) — one lock, two ring-bucket increments — and sits on the
request path.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time

#: (name, seconds) — fast and slow burn windows, in rendering order
WINDOWS: tuple[tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))

#: THE single literal source of the probe/diagnostic route surface.
#: Three request-path lists derive from it — the SLO budget exclusion
#: here, the API layer's auth/admission bypass set, and the
#: request-latency histogram's named diagnostic labels — so they cannot
#: drift apart (``tests/test_torch_probe_routes.py`` checks the
#: derivation statically and at run time): single-segment entries are
#: route labels AND paths; dotted entries are the two-segment diagnostic
#: surfaces (``ops.events`` = ``/ops/events``); ``canary`` is the
#: prober's synthetic in-process route (canary.py) — excluded from
#: budgets and cost tables like every probe, though it never arrives
#: over HTTP. The ``fleet.*`` surfaces keep their labels (and answer
#: 404 in this package until the fleet plane is ported).
PROBE_ROUTE_LABELS = frozenset({
    "health",
    "ready",
    "metrics",
    "slo",
    "_trace",
    "canary",
    "ops.events",
    "ops.costs",
    "ops.plans",
    "debug.status",
    "device.status",
    "fleet.status",
    "fleet.migrations",
})

#: probe labels that are NOT auth/admission-bypass transport paths:
#: ``/_trace`` can render large span trees so it stays behind the
#: admission gate, and ``canary`` is never an HTTP path at all
NON_PATH_PROBE_LABELS = frozenset({"_trace", "canary"})

#: probe labels with no HTTP path at all (the prober's synthetic
#: in-process route) — everything else appears in the API route table
NON_HTTP_PROBE_LABELS = frozenset({"canary"})

#: the API layer's bypass set (served before auth/admission/deadlines)
PROBE_BYPASS_PATHS = frozenset(
    label.replace(".", "/")
    for label in PROBE_ROUTE_LABELS - NON_PATH_PROBE_LABELS
)

#: single-segment probe labels that ARE HTTP route heads (the latency
#: histogram's bounded head set derives its probe members from this)
PROBE_HEAD_LABELS = frozenset(
    label
    for label in PROBE_ROUTE_LABELS - NON_HTTP_PROBE_LABELS
    if "." not in label
)

#: the two-segment diagnostic surfaces the latency histogram may mint
#: named route labels for (anything else under their heads collapses
#: to "other" so a URL scanner cannot mint series)
DIAGNOSTIC_ROUTE_LABELS = frozenset(
    label for label in PROBE_ROUTE_LABELS if "." in label
)

#: probe/diagnostic routes never carry objectives: scrapes and status
#: queries must not consume (or fabricate) anyone's error budget
EXCLUDED_ROUTES = frozenset(
    label for label in PROBE_ROUTE_LABELS if "." not in label
)
_EXCLUDED_HEADS = tuple(
    sorted({label.split(".", 1)[0] for label in DIAGNOSTIC_ROUTE_LABELS})
)


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One route's objectives (availability + latency threshold)."""

    availability_target: float = 0.999
    latency_ms: float = 250.0
    latency_target: float = 0.99

    def __post_init__(self):
        for f in ("availability_target", "latency_target"):
            v = getattr(self, f)
            if not (0.0 < v < 1.0):
                raise ValueError(f"{f} must be in (0, 1), got {v}")
        if self.latency_ms <= 0:
            raise ValueError("latency_ms must be > 0")


def parse_route_objectives(
    spec: str, default: SloObjective
) -> dict[str, SloObjective]:
    """Per-route overrides from the compact ``BEACON_SLO_ROUTES`` form:
    comma-separated ``route:field=value[:field=value...]`` entries, e.g.
    ``g_variants:latency_ms=50:latency_target=0.99,info:availability=0.99``.
    Unknown fields or malformed entries raise at wiring time — a typo'd
    objective silently falling back to the default is exactly the kind
    of drift an SLO declaration exists to prevent."""
    out: dict[str, SloObjective] = {}
    field_of = {
        "availability": "availability_target",
        "availability_target": "availability_target",
        "latency_ms": "latency_ms",
        "latency_target": "latency_target",
    }
    for entry in (e.strip() for e in spec.split(",") if e.strip()):
        parts = entry.split(":")
        route, overrides = parts[0].strip(), {}
        if not route:
            raise ValueError(f"BEACON_SLO_ROUTES entry missing route: {entry!r}")
        for kv in parts[1:]:
            key, sep, val = kv.partition("=")
            if not sep or key.strip() not in field_of:
                raise ValueError(
                    f"BEACON_SLO_ROUTES: bad field {kv!r} in {entry!r} "
                    "(want availability=/latency_ms=/latency_target=)"
                )
            overrides[field_of[key.strip()]] = float(val)
        out[route] = dataclasses.replace(default, **overrides)
    return out


class _BucketRing:
    """Per-``bucket_s`` (good, bad) counters covering ``horizon_s``.

    A slot is lazily reset when its epoch index changes, so no sweeper
    thread exists and an idle route costs nothing. Thread-safety is the
    caller's (SloEngine holds one lock across both rings)."""

    __slots__ = ("_bucket_s", "_n", "_good", "_bad", "_epoch", "_clock")

    def __init__(self, horizon_s: float, bucket_s: float, clock):
        self._bucket_s = float(bucket_s)
        # +1: the partially-filled current bucket rides alongside a
        # full horizon of closed ones
        self._n = int(horizon_s / bucket_s) + 1
        self._good = [0] * self._n
        self._bad = [0] * self._n
        self._epoch = [-1] * self._n
        self._clock = clock

    def record(self, ok: bool) -> None:
        idx = int(self._clock() / self._bucket_s)
        slot = idx % self._n
        if self._epoch[slot] != idx:
            self._epoch[slot] = idx
            self._good[slot] = 0
            self._bad[slot] = 0
        if ok:
            self._good[slot] += 1
        else:
            self._bad[slot] += 1

    def totals(self, window_s: float) -> tuple[int, int]:
        """(good, bad) over the trailing ``window_s``."""
        now_idx = int(self._clock() / self._bucket_s)
        lo = now_idx - int(window_s / self._bucket_s)
        good = bad = 0
        for slot in range(self._n):
            e = self._epoch[slot]
            if lo < e <= now_idx:
                good += self._good[slot]
                bad += self._bad[slot]
        return good, bad


class _RouteState:
    __slots__ = ("objective", "avail", "latency")

    def __init__(self, objective: SloObjective, horizon_s, bucket_s, clock):
        self.objective = objective
        self.avail = _BucketRing(horizon_s, bucket_s, clock)
        self.latency = _BucketRing(horizon_s, bucket_s, clock)


def _burn(bad: int, total: int, budget: float) -> float:
    if total <= 0:
        return 0.0
    return round((bad / total) / max(budget, 1e-9), 3)


class SloEngine:
    """Per-route multi-window burn-rate evaluation over request
    outcomes. ``record`` is called by the API layer once per request;
    ``snapshot`` renders the ``/slo`` document; ``register_metrics``
    exposes ``slo.burn_rate{route,window}`` (availability),
    ``slo.latency_burn_rate{route,window}`` and ``slo.breached{route}``
    gauges in the app registry. Breach *listeners*
    (:meth:`add_breach_listener`) get the current breached-route list
    at most once per ``NOTIFY_INTERVAL_S``, evaluated on the request
    path after recording — the brownout ladder (shaping.py) subscribes
    here, so degradation reacts to the same signal that pages."""

    #: min seconds between breach-listener evaluations: the breach set
    #: is O(routes x windows) to compute and must not run per request
    NOTIFY_INTERVAL_S = 1.0

    #: distinct tenants carrying their own burn rings before new ids
    #: share the overflow bucket (shaping's 64-tenant cap, reused)
    MAX_TENANTS = 64
    #: the shared bucket once MAX_TENANTS tenants are tracked
    OVERFLOW_TENANT = "overflow"
    #: tenant-scoped rings use coarser buckets than the global ones:
    #: 64 tenants x routes x 5s buckets would be real memory for a
    #: per-tenant VIEW, and 30s resolution is plenty for attribution
    TENANT_BUCKET_S = 30.0

    def __init__(
        self,
        *,
        default: SloObjective | None = None,
        routes: dict[str, SloObjective] | None = None,
        windows: tuple = WINDOWS,
        alert_burn_rate: float = 14.4,
        bucket_s: float = 5.0,
        max_tenants: int | None = None,
        clock=time.monotonic,
    ):
        self.default = default or SloObjective()
        self.overrides = dict(routes or {})
        self.windows = tuple(windows)
        self.alert_burn_rate = float(alert_burn_rate)
        self._bucket_s = float(bucket_s)
        self._horizon_s = max(s for _n, s in self.windows)
        self._clock = clock
        self._lock = threading.Lock()
        self._route_states: dict[str, _RouteState] = {}
        # tenant -> route -> _RouteState: the per-tenant SLO view
        # (/slo?tenant=...), recorded alongside the global rings so a
        # tenant's 5xx storm is attributable without moving any other
        # tenant's burn. Cardinality-bounded like shaping's classifier.
        self.max_tenants = int(
            max_tenants if max_tenants is not None else self.MAX_TENANTS
        )
        self._tenant_states: dict[str, dict[str, _RouteState]] = {}
        self._listeners: list = []
        self._last_notify = -math.inf
        # routes with declared overrides exist from the start, so /slo
        # shows the objective (at zero traffic) instead of nothing
        for route, obj in self.overrides.items():
            self._route_states[route] = _RouteState(
                obj, self._horizon_s, self._bucket_s, clock
            )

    @classmethod
    def from_config(
        cls, obs, *, max_tenants: int | None = None
    ) -> "SloEngine":
        """Build from an ObservabilityConfig (the ``BEACON_SLO_*``
        tier). ``max_tenants`` threads shaping's tenant cap through so
        every tenant-bounded plane (shaping, accounting, SLO views)
        collapses to overflow at the SAME count."""
        default = SloObjective(
            availability_target=getattr(
                obs, "slo_availability_target", 0.999
            ),
            latency_ms=getattr(obs, "slo_latency_ms", 250.0),
            latency_target=getattr(obs, "slo_latency_target", 0.99),
        )
        return cls(
            default=default,
            routes=parse_route_objectives(
                getattr(obs, "slo_routes", "") or "", default
            ),
            alert_burn_rate=getattr(obs, "slo_alert_burn_rate", 14.4),
            max_tenants=max_tenants,
        )

    @staticmethod
    def tracked(route: str) -> bool:
        return (
            route not in EXCLUDED_ROUTES
            and route.split(".", 1)[0] not in _EXCLUDED_HEADS
        )

    # -- the request-path entry ---------------------------------------------

    def record(
        self,
        route: str,
        status: int,
        elapsed_ms: float,
        tenant: str | None = None,
    ) -> None:
        """One request outcome. Availability: 5xx is bad. Latency: only
        non-5xx requests count (a failed request's latency is noise),
        bad when over the route's threshold. Route cardinality is
        bounded upstream by the API layer's route labeling; ``tenant``
        (when classified) additionally lands the outcome in that
        tenant's own rings — isolated, so one tenant's storm never
        moves another's view — bounded by ``max_tenants`` with
        overflow sharing one bucket."""
        if self.tracked(route):
            ok = status < 500
            good_latency = elapsed_ms  # compared per-objective below
            with self._lock:
                st = self._route_states.get(route)
                if st is None:
                    st = self._route_states[route] = _RouteState(
                        self.overrides.get(route, self.default),
                        self._horizon_s,
                        self._bucket_s,
                        self._clock,
                    )
                st.avail.record(ok)
                if ok:
                    st.latency.record(
                        good_latency <= st.objective.latency_ms
                    )
                if tenant:
                    by_route = self._tenant_states.get(tenant)
                    if by_route is None:
                        if (
                            len(self._tenant_states) >= self.max_tenants
                            and tenant != self.OVERFLOW_TENANT
                        ):
                            tenant = self.OVERFLOW_TENANT
                            by_route = self._tenant_states.get(tenant)
                        if by_route is None:
                            by_route = self._tenant_states[tenant] = {}
                    tst = by_route.get(route)
                    if tst is None:
                        tst = by_route[route] = _RouteState(
                            self.overrides.get(route, self.default),
                            self._horizon_s,
                            self.TENANT_BUCKET_S,
                            self._clock,
                        )
                    tst.avail.record(ok)
                    if ok:
                        tst.latency.record(
                            good_latency <= tst.objective.latency_ms
                        )
        # untracked routes still drive notification: health probes must
        # keep the brownout ladder's recovery clock ticking even when
        # shed 429s are the only tracked traffic
        self._maybe_notify()

    # -- breach listeners ----------------------------------------------------

    def add_breach_listener(self, fn) -> None:
        """``fn(breached_routes: list[str])`` called from the request
        path, rate-limited to one evaluation per ``NOTIFY_INTERVAL_S``.
        Listeners must be fast and must not raise (failures are logged
        and swallowed — degradation control must never fail requests)."""
        self._listeners.append(fn)

    def _maybe_notify(self) -> None:
        if not self._listeners:
            return
        with self._lock:
            now = self._clock()
            if now - self._last_notify < self.NOTIFY_INTERVAL_S:
                return
            self._last_notify = now
        breached = self.breached_routes()
        for fn in self._listeners:
            try:
                fn(breached)
            except Exception:  # pragma: no cover - defensive
                logging.getLogger(__name__).exception(
                    "SLO breach listener failed"
                )

    # -- evaluation ----------------------------------------------------------

    def _route_doc(self, route: str, st: _RouteState) -> dict:
        obj = st.objective
        doc: dict = {}
        breached_any = False
        for kind, ring, budget, extra in (
            (
                "availability",
                st.avail,
                1.0 - obj.availability_target,
                {"target": obj.availability_target},
            ),
            (
                "latency",
                st.latency,
                1.0 - obj.latency_target,
                {
                    "target": obj.latency_target,
                    "thresholdMs": obj.latency_ms,
                },
            ),
        ):
            windows = {}
            burning_all = True
            for wname, wsec in self.windows:
                good, bad = ring.totals(wsec)
                total = good + bad
                rate = _burn(bad, total, budget)
                windows[wname] = {
                    "good": good,
                    "bad": bad,
                    "total": total,
                    "badRatio": round(bad / total, 5) if total else 0.0,
                    "burnRate": rate,
                }
                if rate < self.alert_burn_rate:
                    burning_all = False
            breached = burning_all
            breached_any = breached_any or breached
            kdoc = {"windows": windows, "breached": breached}
            kdoc.update(extra)
            doc[kind] = kdoc
        doc["breached"] = breached_any
        return doc

    def snapshot(self, tenant: str | None = None) -> dict:
        """The ``/slo`` document: every tracked route's objectives,
        per-window good/bad/burn, and breach verdicts. With ``tenant``
        (the ``/slo?tenant=...`` view) the SAME document shape is
        rendered from that tenant's isolated rings — routes the tenant
        never touched are absent, and a ``tenant`` field names the
        scope (the overflow bucket, when the id overflowed the cap)."""
        # evaluated under the engine lock: _BucketRing's lazy-reset
        # slots are only coherent when reads exclude record()'s
        # stamp-then-zero mutation (a horizon-old bucket's counts must
        # never surface under a fresh epoch)
        with self._lock:
            if tenant is None:
                states = self._route_states
            else:
                if (
                    tenant not in self._tenant_states
                    and len(self._tenant_states) >= self.max_tenants
                ):
                    tenant = self.OVERFLOW_TENANT
                states = self._tenant_states.get(tenant, {})
            doc = {
                "alertBurnRate": self.alert_burn_rate,
                "windows": {n: s for n, s in self.windows},
                "routes": {
                    route: self._route_doc(route, st)
                    for route, st in sorted(states.items())
                },
            }
            if tenant is not None:
                doc["tenant"] = tenant
            return doc

    def tenants(self) -> list[str]:
        """Tenants with per-tenant burn rings (``/slo`` discovery)."""
        with self._lock:
            return sorted(self._tenant_states)

    def burn_rates(self, kind: str = "availability") -> dict:
        """{(route, window): burn rate} for the gauge callbacks."""
        out = {}
        with self._lock:
            for route, st in self._route_states.items():
                obj = st.objective
                if kind == "availability":
                    ring, budget = st.avail, 1.0 - obj.availability_target
                else:
                    ring, budget = st.latency, 1.0 - obj.latency_target
                for wname, wsec in self.windows:
                    good, bad = ring.totals(wsec)
                    out[(route, wname)] = _burn(bad, good + bad, budget)
        return out

    def breached(self) -> dict[str, int]:
        """{route: 0/1} — 1 when either objective burns above the
        alert factor on BOTH windows (the page condition)."""
        with self._lock:
            return {
                route: int(self._route_doc(route, st)["breached"])
                for route, st in self._route_states.items()
            }

    def breached_routes(self) -> list[str]:
        return sorted(r for r, b in self.breached().items() if b)

    def register_metrics(self, registry) -> None:
        registry.gauge(
            "slo.burn_rate",
            "availability error-budget burn rate per route and window",
            label=("route", "window"),
            fn=lambda: self.burn_rates("availability"),
        )
        registry.gauge(
            "slo.latency_burn_rate",
            "latency error-budget burn rate per route and window",
            label=("route", "window"),
            fn=lambda: self.burn_rates("latency"),
        )
        registry.gauge(
            "slo.breached",
            "1 when a route burns over the alert factor on both windows",
            label="route",
            fn=self.breached,
        )
