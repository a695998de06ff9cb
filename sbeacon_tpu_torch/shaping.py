"""Traffic shaping: tenant fair queueing, priority lanes, brownout.

Counterpart of ``sbeacon_tpu/shaping.py``, all of it. One composable
layer in front of the global admission gate:

- **Tenant classification** (:func:`classify_tenant`): the
  ``X-Beacon-Tenant`` header when present (bounded charset), else a
  stable hash bucket of the ``Authorization`` credential, else the
  shared ``anon`` bucket. Cardinality is capped (``max_tenants``);
  overflow tenants share one ``overflow`` bucket.
- **Priority lanes** (:func:`classify_lane`): ``interactive``
  (boolean/count granularity) versus ``bulk`` (record retrieval and
  ``/submit``). Interactive has strict precedence, with a starvation
  escape hatch: a bulk waiter older than ``bulk_starvation_ms`` is
  served next regardless.
- **Weighted deficit-round-robin fair queues**
  (:class:`FairQueueAdmission`, with the ``admission.queue`` fault
  site): per-tenant bounded queues drained by DRR with configurable
  weights, per-tenant in-flight caps and a global running cap. A shed
  answer's ``Retry-After`` is **adaptive**: the p90 of the shed lane's
  measured queue wait, floor/ceiling clamped.
- **Brownout ladder** (:class:`BrownoutLadder`): driven by the SLO
  engine's breach signal, a sustained breach steps through rungs —
  disable hedging, pause the bulk lane, shrink per-tenant caps
  AIMD-style, global shed — and steps back down on sustained recovery
  with hysteresis. Every transition publishes a ``shaping.brownout``
  event and moves the ``shaping.brownout_level`` gauge. The hedge rung
  calls the app's hedge control (``parallel.dispatch.set_hedging_enabled``),
  a flag nothing in this package reads until hedged scans come with
  the fleet plane.

Stdlib only and importable from any layer. The fair queue is passive:
dispatch runs under the caller's lock on ``release``/brownout
transitions — no scheduler thread.
"""

from __future__ import annotations

import collections
import hashlib
import math
import re
import threading
import time
from contextlib import contextmanager

from .harness.faults import fault_point
from .resilience import DeadlineExceeded, Overloaded, current_deadline
from .telemetry import charge_cost, publish_event

# -- lanes --------------------------------------------------------------------

LANE_INTERACTIVE = "interactive"
LANE_BULK = "bulk"
#: precedence order — earlier lanes drain first
LANES = (LANE_INTERACTIVE, LANE_BULK)


def requested_granularity(
    query_params: dict | None, body: dict | None
) -> str | None:
    """The request's requestedGranularity (body wins over query
    params), lowercased, or None — ONE extraction shared by the lane
    classifier and the cost-accounting shape key, so the two can
    never diverge on precedence."""
    g = None
    if isinstance(body, dict):
        q = body.get("query")
        if isinstance(q, dict):
            g = q.get("requestedGranularity")
    if g is None and query_params:
        g = query_params.get("requestedGranularity")
    return str(g).lower() if g else None


def classify_lane(
    path_head: str, query_params: dict | None, body: dict | None
) -> str:
    """The request's priority lane, from the query spec: record-
    granularity retrieval (and ``/submit`` ingest) is ``bulk``; the
    boolean/count existence checks a human is waiting on are
    ``interactive``. Routes with no granularity default interactive —
    entity lookups and framework endpoints are small."""
    if path_head == "submit":
        return LANE_BULK
    g = requested_granularity(query_params, body)
    return LANE_BULK if g == "record" else LANE_INTERACTIVE


# -- tenant classification ----------------------------------------------------

#: acceptable explicit tenant ids (re-emitted into metrics labels and
#: journal events, so no unbounded junk or header-injection pass-through)
_TENANT_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")

#: the bucket for unauthenticated, unlabeled traffic
ANON_TENANT = "anon"
#: the shared bucket once ``max_tenants`` distinct ids are tracked
OVERFLOW_TENANT = "overflow"


def classify_tenant(
    headers: dict | None, *, header: str = "X-Beacon-Tenant"
) -> str:
    """The request's tenant id: the explicit header (well-formed) wins;
    else an API-key bucket derived from the Authorization credential
    (stable hash — the credential itself never reaches a label); else
    the shared anonymous bucket."""
    tenant_h = header.lower()
    explicit = auth = None
    for k, v in (headers or {}).items():
        lk = k.lower()
        if lk == tenant_h:
            explicit = v
        elif lk == "authorization":
            auth = v
    if explicit and _TENANT_RE.match(explicit):
        return explicit
    if auth:
        return "key-" + hashlib.sha256(auth.encode()).hexdigest()[:8]
    return ANON_TENANT


def parse_tenant_weights(spec: str) -> dict[str, float]:
    """``tenant=weight`` comma list (``gold=4,free=1``). Malformed
    entries raise at wiring time — a typo'd weight silently falling
    back to the default is drift, exactly like a typo'd SLO."""
    out: dict[str, float] = {}
    for entry in (e.strip() for e in (spec or "").split(",") if e.strip()):
        name, sep, val = entry.partition("=")
        name = name.strip()
        if not sep or not name or not _TENANT_RE.match(name):
            raise ValueError(f"BEACON_TENANT_WEIGHTS: bad entry {entry!r}")
        w = float(val)
        if w <= 0:
            raise ValueError(
                f"BEACON_TENANT_WEIGHTS: weight must be > 0 in {entry!r}"
            )
        out[name] = w
    return out


# -- fair queue ---------------------------------------------------------------


class _Waiter:
    __slots__ = (
        "event", "tenant", "lane", "shape", "t_enqueue",
        "granted", "rejected",
    )

    def __init__(self, tenant: str, lane: str, now: float,
                 shape: str | None = None):
        self.event = threading.Event()
        self.tenant = tenant
        self.lane = lane
        #: the query-shape key (accounting.query_shape) for the
        #: cost-aware DRR charge; None = flat 1-per-request deficit
        self.shape = shape
        self.t_enqueue = now
        self.granted = False
        self.rejected = False


class _TenantState:
    __slots__ = (
        "name", "weight", "in_flight", "deficit", "queues",
        "admitted", "shed",
    )

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = weight
        self.in_flight = 0
        #: per-lane DRR deficit counters (unit cost per request)
        self.deficit = {lane: 0.0 for lane in LANES}
        self.queues: dict[str, collections.deque] = {
            lane: collections.deque() for lane in LANES
        }
        self.admitted = 0
        self.shed = 0

    def queued(self) -> int:
        return sum(len(q) for q in self.queues.values())


class FairQueueAdmission:
    """Weighted deficit-round-robin admission across tenants and lanes.

    ``acquire`` admits immediately when the global and per-tenant
    running caps allow; otherwise the request queues (bounded per
    tenant per lane) and blocks until a ``release`` dispatches it, its
    deadline lapses, or ``max_queue_wait_s`` passes. Dispatch order:
    interactive lane strictly before bulk — except a bulk waiter older
    than ``bulk_starvation_ms`` goes next (the escape hatch) — and
    within a lane, DRR over tenant weights, so a weight-4 tenant drains
    four queued requests per weight-1 tenant's one.

    Sheds raise :class:`~sbeacon_tpu_torch.resilience.Overloaded` whose
    ``retry_after_s`` is the p90 of the shed lane's measured queue-wait
    ring, clamped to ``[retry_floor_s, retry_ceil_s]`` — a client told
    to back off is told *how long the queue actually is*.

    The brownout ladder flips ``set_brownout`` flags here: a paused
    bulk lane sheds (and flushes) bulk, ``cap_scale`` squeezes the
    per-tenant cap AIMD-style, ``global_shed`` refuses everything.
    Thread-safe; the clock is injectable for tests.
    """

    #: recent queue waits (ms) kept per lane for the adaptive Retry-After
    WAIT_RING = 512
    #: min seconds between shaping.shed flight-recorder events — a shed
    #: flood is ONE incident, not thousands of journal entries
    SHED_EVENT_INTERVAL_S = 1.0
    #: clamp on the cost-aware DRR charge: the refill-on-visit cap
    #: banks at most ``2 * max(weight, 1)`` of deficit, so a charge
    #: above 2.0 could strand a queued waiter at quiescence
    MIN_DRR_CHARGE = 0.25
    MAX_DRR_CHARGE = 2.0

    def __init__(
        self,
        *,
        max_in_flight: int = 256,
        tenant_max_in_flight: int = 64,
        tenant_queue_depth: int = 128,
        weights: dict[str, float] | None = None,
        default_weight: float = 1.0,
        max_queue_wait_s: float = 10.0,
        bulk_starvation_ms: float = 500.0,
        retry_floor_s: float = 1.0,
        retry_ceil_s: float = 60.0,
        max_tenants: int = 64,
        cost_charge_fn=None,
        clock=time.monotonic,
    ):
        if max_in_flight < 1 or tenant_max_in_flight < 1:
            raise ValueError("in-flight caps must be >= 1")
        self.max_in_flight = max_in_flight
        self.tenant_max_in_flight = tenant_max_in_flight
        self.tenant_queue_depth = max(1, tenant_queue_depth)
        self.weights = dict(weights or {})
        self.default_weight = default_weight
        self.max_queue_wait_s = max_queue_wait_s
        self.bulk_starvation_ms = bulk_starvation_ms
        self.retry_floor_s = retry_floor_s
        self.retry_ceil_s = retry_ceil_s
        self.max_tenants = max(1, max_tenants)
        #: cost-aware DRR hook (``accounting.drr_charge``): maps
        #: (lane, shape) to the deficit a grant costs. None (default)
        #: keeps the flat 1-per-request charge — the pre-cost path,
        #: byte-identical (``BEACON_COST_DRR`` wires it).
        self._cost_charge_fn = cost_charge_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        self._rr = {lane: 0 for lane in LANES}
        self._total_in_flight = 0
        self._queued = 0
        self._admitted = 0
        self._shed = 0
        self._escapes = 0
        self._waits = {
            lane: collections.deque(maxlen=self.WAIT_RING) for lane in LANES
        }
        #: memoized per-lane Retry-After; invalidated when a wait lands.
        #: A shed storm re-reads the p90 thousands of times between
        #: grants — it must not re-sort the ring under the lock per shed
        self._ra_cache: dict[str, float | None] = {
            lane: None for lane in LANES
        }
        #: wired by TrafficShaper.register_metrics (lane-labeled)
        self._wait_hist = None
        self._bulk_paused = False
        self._global_shed = False
        self._cap_scale = 1.0
        self._last_shed_event = 0.0

    # -- tenant state --------------------------------------------------------

    def _tenant(self, name: str) -> _TenantState:
        ts = self._tenants.get(name)
        if ts is None:
            if (
                len(self._tenants) >= self.max_tenants
                and name != OVERFLOW_TENANT
            ):
                return self._tenant(OVERFLOW_TENANT)
            ts = self._tenants[name] = _TenantState(
                name, self.weights.get(name, self.default_weight)
            )
        return ts

    def _tenant_cap(self) -> int:
        return max(
            1, int(math.ceil(self.tenant_max_in_flight * self._cap_scale))
        )

    def _can_run(self, ts: _TenantState) -> bool:
        return (
            self._total_in_flight < self.max_in_flight
            and ts.in_flight < self._tenant_cap()
        )

    # -- admission -----------------------------------------------------------

    def acquire(
        self, tenant: str, lane: str, shape: str | None = None
    ) -> str:
        """Block until admitted; returns the RESOLVED tenant key (the
        overflow bucket may differ from the requested id) which the
        caller must pass back to :meth:`release`. Raises ``Overloaded``
        on shed (queue full, brownout, queue-wait bound) and
        ``DeadlineExceeded`` when the request's deadline lapsed while
        queued. ``shape`` is the query-shape key the cost-aware DRR
        charge looks up; it has no effect without a
        ``cost_charge_fn``."""
        # chaos site: plans can delay or fail the fair-queue path like
        # worker.http / kernel.launch / sqlite.commit (sleeps happen
        # here, OUTSIDE the shaper lock)
        fault_point("admission.queue", f"{tenant}:{lane}")
        deadline = current_deadline()
        shed_exc = shed_event = w = None
        with self._lock:
            ts = self._tenant(tenant)
            if self._global_shed:
                shed_exc, shed_event = self._shed_locked(
                    ts, lane, "brownout: global shed"
                )
            elif lane == LANE_BULK and self._bulk_paused:
                shed_exc, shed_event = self._shed_locked(
                    ts, lane, "brownout: bulk lane paused"
                )
            elif self._can_run(ts) and not ts.queues[lane]:
                self._grant_running_locked(ts)
                return ts.name
            elif len(ts.queues[lane]) >= self.tenant_queue_depth:
                shed_exc, shed_event = self._shed_locked(
                    ts, lane, f"tenant {ts.name!r} {lane} queue full"
                )
            else:
                w = _Waiter(ts.name, lane, self._clock(), shape=shape)
                ts.queues[lane].append(w)
                self._queued += 1
        if shed_exc is not None:
            if shed_event:
                publish_event("shaping.shed", **shed_event)
            raise shed_exc
        w.event.wait(deadline.clamp(self.max_queue_wait_s))
        with self._lock:
            if w.granted:
                return ts.name
            if not w.rejected:
                # still queued: withdraw so a later dispatch doesn't
                # grant a slot nobody is waiting for
                try:
                    ts.queues[lane].remove(w)
                    self._queued -= 1
                except ValueError:
                    # granted between the wait timeout and this lock
                    if w.granted:
                        return ts.name
                self._note_wait_locked(
                    lane, (self._clock() - w.t_enqueue) * 1e3
                )
            ts.shed += 1
            self._shed += 1
            ra = self._retry_after_locked(lane)
        if deadline.expired():
            raise DeadlineExceeded(
                f"request deadline expired in the {lane} fair queue"
            )
        raise Overloaded(
            f"tenant {ts.name!r} {lane} lane saturated "
            f"(waited {self.max_queue_wait_s}s at the fair queue)",
            retry_after_s=ra,
        )

    def release(self, tenant: str) -> None:
        """Return a running slot and dispatch queued waiters."""
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is not None and ts.in_flight > 0:
                ts.in_flight -= 1
                self._total_in_flight -= 1
            grants = self._dispatch_locked()
        for g in grants:
            g.event.set()

    @contextmanager
    def admit(self, tenant: str, lane: str, shape: str | None = None):
        key = self.acquire(tenant, lane, shape)
        try:
            yield
        finally:
            self.release(key)

    # -- dispatch (all under self._lock) -------------------------------------

    def _grant_running_locked(self, ts: _TenantState) -> None:
        ts.in_flight += 1
        ts.admitted += 1
        self._total_in_flight += 1
        self._admitted += 1

    def _shed_locked(self, ts, lane, why) -> tuple[Overloaded, dict | None]:
        ts.shed += 1
        self._shed += 1
        ra = self._retry_after_locked(lane)
        event = None
        now = self._clock()
        if now - self._last_shed_event >= self.SHED_EVENT_INTERVAL_S:
            self._last_shed_event = now
            event = {
                "tenant": ts.name,
                "lane": lane,
                "reason": why,
                "shed": self._shed,
                "queued": self._queued,
                "retry_after_s": ra,
            }
        return Overloaded(why, retry_after_s=ra), event

    def _dispatch_locked(self) -> list[_Waiter]:
        grants: list[_Waiter] = []
        # the starvation escape fires at most once per dispatch pass:
        # one aged bulk waiter jumps the interactive lane, not the
        # whole aged backlog (that would invert the precedence)
        escape_left = 1
        while self._total_in_flight < self.max_in_flight:
            w = self._next_waiter_locked(escape=escape_left > 0)
            if w is None:
                break
            if w.lane == LANE_BULK and escape_left > 0:
                escape_left -= 1
            ts = self._tenants[w.tenant]
            self._queued -= 1
            self._grant_running_locked(ts)
            w.granted = True
            self._note_wait_locked(
                w.lane, (self._clock() - w.t_enqueue) * 1e3
            )
            grants.append(w)
        return grants

    def _next_waiter_locked(self, *, escape: bool = True) -> _Waiter | None:
        # starvation escape: the oldest eligible bulk waiter past the
        # threshold is served ahead of the interactive lane — strict
        # precedence must not become strict starvation
        if escape and not self._bulk_paused and self.bulk_starvation_ms >= 0:
            oldest: _TenantState | None = None
            for ts in self._tenants.values():
                q = ts.queues[LANE_BULK]
                if q and self._can_run(ts) and (
                    oldest is None
                    or q[0].t_enqueue
                    < oldest.queues[LANE_BULK][0].t_enqueue
                ):
                    oldest = ts
            if oldest is not None:
                head = oldest.queues[LANE_BULK][0]
                age_ms = (self._clock() - head.t_enqueue) * 1e3
                if age_ms >= self.bulk_starvation_ms:
                    self._escapes += 1
                    return oldest.queues[LANE_BULK].popleft()
        w = self._pop_lane_locked(LANE_INTERACTIVE)
        if w is None and not self._bulk_paused:
            w = self._pop_lane_locked(LANE_BULK)
        return w

    def _grant_charge_locked(self, lane: str, w: _Waiter) -> float:
        """The deficit granting ``w`` costs: flat 1.0 without a cost
        hook; with one (``BEACON_COST_DRR``), the measured mean cost
        of the waiter's query shape relative to the lane mean, clamped
        to [MIN_DRR_CHARGE, MAX_DRR_CHARGE] so no shape can be starved
        outright or ride entirely free — a record retrieval that costs
        4x a boolean probe drains a tenant's fair share roughly 2x as
        fast (the clamp), instead of counting the same."""
        fn = self._cost_charge_fn
        if fn is None or w.shape is None:
            return 1.0
        try:
            c = float(fn(lane, w.shape))
        except Exception:  # a cost hook must never fail admission
            return 1.0
        return min(self.MAX_DRR_CHARGE, max(self.MIN_DRR_CHARGE, c))

    def _pop_lane_locked(self, lane: str) -> _Waiter | None:
        """One waiter from ``lane`` by weighted DRR: each rotation
        visit refills a tenant's deficit by its weight; each grant
        costs its shape's charge (flat 1 without the cost hook) — so
        over a backlog, granted WORK converges to the weight ratio.
        Tenants at their in-flight cap are skipped (their deficit
        keeps, fairness resumes when slots free)."""
        active = [
            ts
            for ts in self._tenants.values()
            if ts.queues[lane] and self._can_run(ts)
        ]
        if not active:
            return None
        n = len(active)
        ptr = self._rr[lane]
        # enough rotations that even the smallest active weight banks
        # the LARGEST possible charge of deficit: a fixed 2n+1 strands
        # any weight < 0.5 (the pop returns None, the dispatch pass
        # ends, and at quiescence nothing re-triggers it — the waiter
        # sheds on its queue-wait bound against a free server). With
        # the cost hook armed, a head may cost up to MAX_DRR_CHARGE.
        wmin = min(ts.weight for ts in active)
        max_charge = (
            1.0 if self._cost_charge_fn is None else self.MAX_DRR_CHARGE
        )
        rounds = n * (int(math.ceil(max_charge / wmin)) + 1) + 1
        # each head's charge is computed ONCE per pop: the rotation may
        # visit a tenant dozens of times before its deficit suffices,
        # and the cost hook takes the accounting plane's lock — no
        # reason to pay that round-trip per visit for a value that
        # cannot change within one pop (heads only move on a grant)
        charge_cache: dict[int, float] = {}
        for _ in range(rounds):
            ts = active[ptr % n]
            if ts.queues[lane]:
                need = charge_cache.get(id(ts))
                if need is None:
                    need = charge_cache[id(ts)] = (
                        self._grant_charge_locked(lane, ts.queues[lane][0])
                    )
                if ts.deficit[lane] >= need:
                    ts.deficit[lane] -= need
                    self._rr[lane] = ptr
                    return ts.queues[lane].popleft()
            ptr += 1
            nxt = active[ptr % n]
            # refill on advancing INTO a tenant, capped so an idle
            # spell cannot bank unbounded burst credit (the cap is why
            # MAX_DRR_CHARGE must stay <= 2: a costlier head could
            # never accumulate enough deficit to be granted)
            nxt.deficit[lane] = min(
                nxt.deficit[lane] + nxt.weight, 2 * max(nxt.weight, 1.0)
            )
        self._rr[lane] = ptr
        return None

    # -- adaptive Retry-After ------------------------------------------------

    def _note_wait_locked(self, lane: str, wait_ms: float) -> None:
        self._waits[lane].append(wait_ms)
        self._ra_cache[lane] = None
        h = self._wait_hist
        if h is not None:
            h.observe(wait_ms, label_value=lane)

    def _retry_after_locked(self, lane: str) -> float:
        cached = self._ra_cache[lane]
        if cached is not None:
            return cached
        xs = sorted(self._waits[lane])
        if xs:
            # nearest-rank p90, rounded UP: with few samples the
            # estimate must lean pessimistic, not advise the shortest
            # wait observed
            idx = min(len(xs) - 1, max(0, math.ceil(0.9 * len(xs)) - 1))
            p90_s = xs[idx] / 1e3
        else:
            p90_s = 0.0
        v = round(
            min(self.retry_ceil_s, max(self.retry_floor_s, p90_s)), 3
        )
        self._ra_cache[lane] = v
        return v

    def retry_after(self, lane: str) -> float:
        """The backoff a shed request in ``lane`` is advised right now:
        p90 of the lane's measured queue waits, floor/ceiling clamped."""
        with self._lock:
            return self._retry_after_locked(lane)

    # -- brownout hooks ------------------------------------------------------

    def set_brownout(
        self,
        *,
        bulk_paused: bool | None = None,
        global_shed: bool | None = None,
        cap_scale: float | None = None,
    ) -> None:
        """Apply ladder effects. Tightening flushes the affected queues
        (their waiters shed immediately instead of timing out);
        loosening dispatches the backlog under the new limits."""
        wake: list[_Waiter] = []
        with self._lock:
            if bulk_paused is not None:
                self._bulk_paused = bool(bulk_paused)
                if self._bulk_paused:
                    wake += self._flush_locked(lanes=(LANE_BULK,))
            if global_shed is not None:
                self._global_shed = bool(global_shed)
                if self._global_shed:
                    wake += self._flush_locked(lanes=LANES)
            if cap_scale is not None:
                self._cap_scale = min(1.0, max(0.0, float(cap_scale)))
            wake += self._dispatch_locked()
        for w in wake:
            w.event.set()

    def _flush_locked(self, *, lanes) -> list[_Waiter]:
        flushed: list[_Waiter] = []
        for ts in self._tenants.values():
            for lane in lanes:
                q = ts.queues[lane]
                while q:
                    w = q.popleft()
                    w.rejected = True
                    self._queued -= 1
                    flushed.append(w)
        return flushed

    # -- observability -------------------------------------------------------

    def totals(self) -> dict:
        with self._lock:
            return {
                "max_in_flight": self.max_in_flight,
                "in_flight": self._total_in_flight,
                "queued": self._queued,
                "admitted": self._admitted,
                "shed": self._shed,
                "bulk_escapes": self._escapes,
                "cap_scale": self._cap_scale,
                "tenant_cap": self._tenant_cap(),
                "bulk_paused": self._bulk_paused,
                "global_shed": self._global_shed,
            }

    def tenant_field(self, field: str) -> dict[str, float]:
        """{tenant: value} for the tenant-labeled gauge/counter series."""
        with self._lock:
            if field == "queued":
                return {
                    name: ts.queued() for name, ts in self._tenants.items()
                }
            return {
                name: getattr(ts, field)
                for name, ts in self._tenants.items()
            }

    def lane_queued(self) -> dict[str, int]:
        with self._lock:
            out = {lane: 0 for lane in LANES}
            for ts in self._tenants.values():
                for lane in LANES:
                    out[lane] += len(ts.queues[lane])
            return out

    def tenants(self) -> dict:
        """Per-tenant rollup for /debug/status."""
        with self._lock:
            return {
                name: {
                    "weight": ts.weight,
                    "inFlight": ts.in_flight,
                    "queued": ts.queued(),
                    "admitted": ts.admitted,
                    "shed": ts.shed,
                }
                for name, ts in sorted(self._tenants.items())
            }


# -- brownout ladder ----------------------------------------------------------

#: rung names by level (level 0 = healthy); each level applies its rung
#: PLUS every rung below it
BROWNOUT_RUNGS = ("hedge_off", "bulk_pause", "cap_squeeze", "global_shed")


class BrownoutLadder:
    """SLO-driven graceful degradation with hysteresis and AIMD caps.

    Fed by ``SloEngine.add_breach_listener`` (rate-limited to ~1
    evaluation/s by the engine): a breach sustained for ``up_hold_s``
    steps one rung up; recovery sustained for ``down_hold_s`` steps
    back down — the asymmetric holds are the hysteresis that stops the
    ladder flapping on a noisy boundary. At the ``cap_squeeze`` rung
    the per-tenant cap multiplies down by ``md_factor`` per sustained-
    breach tick (to ``min_scale``) before the ladder escalates to
    ``global_shed``; recovery restores the cap additively
    (``ai_step``) and only then steps the level down — classic AIMD,
    so capacity returns gently after an overload.

    Effects: level >= 1 disables scan/replica hedging (via the injected
    ``hedge_control`` — ``parallel.dispatch.set_hedging_enabled``),
    >= 2 pauses the bulk lane, >= 3 squeezes per-tenant caps, >= 4
    sheds globally. Every transition publishes ``shaping.brownout`` to
    the flight recorder.
    """

    def __init__(
        self,
        queue: FairQueueAdmission,
        *,
        up_hold_s: float = 3.0,
        down_hold_s: float = 15.0,
        md_factor: float = 0.5,
        ai_step: float = 0.25,
        min_scale: float = 0.125,
        hedge_control=None,
        clock=time.monotonic,
    ):
        self._queue = queue
        self.up_hold_s = up_hold_s
        self.down_hold_s = down_hold_s
        self.md_factor = md_factor
        self.ai_step = ai_step
        self.min_scale = min_scale
        self._hedge_control = hedge_control
        self._clock = clock
        self._lock = threading.Lock()
        self.level = 0
        self.cap_scale = 1.0
        self._breach_since: float | None = None
        self._clear_since: float | None = None
        self._last_transition = -math.inf
        self.transitions = 0

    def on_signal(self, breached_routes) -> None:
        """The breach-listener entry: evaluate one ladder step."""
        now = self._clock()
        apply = None
        with self._lock:
            if breached_routes:
                self._clear_since = None
                if self._breach_since is None:
                    self._breach_since = now
                held = now - self._breach_since >= self.up_hold_s
                spaced = now - self._last_transition >= self.up_hold_s
                if held and spaced:
                    apply = self._step_up_locked(now, list(breached_routes))
            else:
                self._breach_since = None
                if self._clear_since is None:
                    self._clear_since = now
                held = now - self._clear_since >= self.down_hold_s
                spaced = now - self._last_transition >= self.down_hold_s
                if held and spaced and (
                    self.level > 0 or self.cap_scale < 1.0
                ):
                    apply = self._step_down_locked(now)
        if apply is not None:
            self._apply(*apply)

    def _step_up_locked(self, now, routes):
        cap_rung = BROWNOUT_RUNGS.index("cap_squeeze") + 1
        if self.level == cap_rung and self.cap_scale > self.min_scale:
            # keep squeezing before escalating to the last rung
            self.cap_scale = max(
                self.min_scale, self.cap_scale * self.md_factor
            )
        elif self.level < len(BROWNOUT_RUNGS):
            self.level += 1
            if self.level == cap_rung:
                self.cap_scale = max(
                    self.min_scale, self.cap_scale * self.md_factor
                )
        else:
            return None
        self._last_transition = now
        self.transitions += 1
        return ("up", routes)

    def _step_down_locked(self, now):
        cap_rung = BROWNOUT_RUNGS.index("cap_squeeze") + 1
        if self.level >= cap_rung and self.cap_scale < 1.0:
            if self.level > cap_rung:
                self.level -= 1  # leave global_shed first
            else:
                self.cap_scale = min(1.0, self.cap_scale + self.ai_step)
                if self.cap_scale >= 1.0:
                    self.level -= 1
        elif self.level > 0:
            self.level -= 1
        else:
            self.cap_scale = min(1.0, self.cap_scale + self.ai_step)
        self._last_transition = now
        self.transitions += 1
        return ("down", [])

    def _apply(self, direction: str, routes) -> None:
        level, scale = self.level, self.cap_scale
        rung = BROWNOUT_RUNGS[level - 1] if level else "healthy"
        self._queue.set_brownout(
            bulk_paused=level >= 2,
            global_shed=level >= 4,
            cap_scale=scale,
        )
        if self._hedge_control is not None:
            try:
                self._hedge_control(level < 1)
            except Exception:  # a hedge hook must never fail a request
                import logging

                logging.getLogger(__name__).exception(
                    "brownout hedge control failed"
                )
        publish_event(
            "shaping.brownout",
            direction=direction,
            level=level,
            rung=rung,
            cap_scale=round(scale, 4),
            breached_routes=routes,
        )


# -- the facade the app wires -------------------------------------------------


class TrafficShaper:
    """One object owning classification, the fair queue and the ladder;
    ``BeaconApp`` holds exactly one and routes every non-probe request
    through :meth:`admit`."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        tenant_header: str = "X-Beacon-Tenant",
        queue: FairQueueAdmission,
        ladder: BrownoutLadder | None = None,
    ):
        self.enabled = enabled
        self.tenant_header = tenant_header
        self.queue = queue
        self.ladder = ladder

    @classmethod
    def from_config(
        cls, config, *, hedge_control=None, cost_charge_fn=None
    ) -> "TrafficShaper":
        """Build from a BeaconConfig (``config.shaping`` +
        ``config.resilience.max_in_flight`` as the global running cap).
        ``cost_charge_fn`` (``accounting.drr_charge``) is only wired
        through when ``shaping.cost_drr`` is on, so the default DRR
        charge path stays byte-identical to the flat one."""
        sh = config.shaping
        queue = FairQueueAdmission(
            max_in_flight=config.resilience.max_in_flight,
            tenant_max_in_flight=sh.tenant_max_in_flight,
            tenant_queue_depth=sh.tenant_queue_depth,
            weights=parse_tenant_weights(sh.tenant_weights),
            default_weight=sh.default_weight,
            max_queue_wait_s=sh.max_queue_wait_s,
            bulk_starvation_ms=sh.bulk_starvation_ms,
            retry_floor_s=sh.retry_after_floor_s,
            retry_ceil_s=sh.retry_after_ceil_s,
            max_tenants=sh.max_tenants,
            cost_charge_fn=(
                cost_charge_fn
                if getattr(sh, "cost_drr", False)
                else None
            ),
        )
        ladder = None
        if sh.brownout:
            ladder = BrownoutLadder(
                queue,
                up_hold_s=sh.brownout_up_hold_s,
                down_hold_s=sh.brownout_down_hold_s,
                md_factor=sh.brownout_md_factor,
                ai_step=sh.brownout_ai_step,
                min_scale=sh.brownout_min_scale,
                hedge_control=hedge_control,
            )
        return cls(
            enabled=sh.enabled,
            tenant_header=sh.tenant_header,
            queue=queue,
            ladder=ladder,
        )

    def tenant_of(self, headers: dict | None) -> str:
        return classify_tenant(headers, header=self.tenant_header)

    def lane_of(
        self, path_head: str, query_params: dict | None, body: dict | None
    ) -> str:
        return classify_lane(path_head, query_params, body)

    @contextmanager
    def admit(self, tenant: str, lane: str, shape: str | None = None):
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        key = self.queue.acquire(tenant, lane, shape)
        # the fair-queue wait is attributed to the request's cost
        # vector (queue_wait_ms: contention a tenant causes/suffers,
        # reported per tenant but excluded from the cost-unit scalar)
        charge_cost(queue_wait_ms=(time.monotonic() - t0) * 1e3)
        try:
            yield
        finally:
            self.queue.release(key)

    def on_slo_signal(self, breached_routes) -> None:
        if self.enabled and self.ladder is not None:
            self.ladder.on_signal(breached_routes)

    def close(self) -> None:
        """Undo process-global effects: the hedge kill-switch is shared
        by every router/pool in the process, so an app discarded while
        browned out must hand it back enabled — a later app would
        otherwise silently run with hedging off forever."""
        lad = self.ladder
        if (
            lad is not None
            and lad._hedge_control is not None
            and lad.level >= 1
        ):
            try:
                lad._hedge_control(True)
            except Exception:
                pass

    def brownout_level(self) -> int:
        return self.ladder.level if self.ladder is not None else 0

    def debug(self) -> dict:
        """The /debug/status shaping rollup."""
        doc = {
            "enabled": self.enabled,
            "brownoutLevel": self.brownout_level(),
            **{
                k: v
                for k, v in self.queue.totals().items()
                if k
                in (
                    "in_flight",
                    "queued",
                    "shed",
                    "cap_scale",
                    "bulk_paused",
                    "global_shed",
                )
            },
            "tenants": self.queue.tenants(),
        }
        return doc

    def register_metrics(self, registry) -> None:
        """The shaping plane's typed instruments. Tenant-labeled series
        are cardinality-bounded by the classifier's ``max_tenants``
        overflow bucket."""
        q = self.queue
        registry.gauge(
            "shaping.brownout_level",
            "brownout ladder rung in effect (0=healthy .. 4=global shed)",
            fn=self.brownout_level,
        )
        registry.gauge(
            "shaping.cap_scale",
            "AIMD multiplier on the per-tenant in-flight cap (1.0=full)",
            fn=lambda: q.totals()["cap_scale"],
        )
        q._wait_hist = registry.histogram(
            "shaping.queue_wait_ms",
            "fair-queue wait per lane (admission to grant/withdrawal)",
            label="lane",
        )
        registry.gauge(
            "shaping.lane_queued",
            "requests waiting in the fair queue per lane",
            label="lane",
            fn=q.lane_queued,
        )
        registry.counter(
            "shaping.admitted",
            "requests granted a running slot by the fair queue",
            fn=lambda: q.totals()["admitted"],
        )
        registry.counter(
            "shaping.shed",
            "requests shed by the fair queue (429 + adaptive Retry-After)",
            fn=lambda: q.totals()["shed"],
        )
        registry.counter(
            "shaping.bulk_escapes",
            "bulk waiters served via the starvation escape hatch",
            fn=lambda: q.totals()["bulk_escapes"],
        )
        registry.gauge(
            "shaping.retry_after_s",
            "current adaptive Retry-After advice per lane (p90 queue wait)",
            label="lane",
            fn=lambda: {lane: q.retry_after(lane) for lane in LANES},
        )
        registry.gauge(
            "admission.tenant_in_flight",
            "running requests per tenant",
            label="tenant",
            fn=lambda: q.tenant_field("in_flight"),
        )
        registry.gauge(
            "admission.tenant_queued",
            "fair-queued requests per tenant",
            label="tenant",
            fn=lambda: q.tenant_field("queued"),
        )
        registry.counter(
            "admission.tenant_admitted",
            "requests admitted per tenant",
            label="tenant",
            fn=lambda: q.tenant_field("admitted"),
        )
        registry.counter(
            "admission.tenant_shed",
            "requests shed per tenant",
            label="tenant",
            fn=lambda: q.tenant_field("shed"),
        )
