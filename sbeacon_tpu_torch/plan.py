"""Per-request execution plans: the EXPLAIN/ANALYZE plane.

Counterpart of ``sbeacon_tpu/plan.py``: :func:`plan_stage`, the
``PLAN_STAGES`` / ``PLAN_REASONS`` registries (trimmed to the stages
and reasons this package records), :func:`plan_shape`,
:func:`plan_note`, :func:`explain_active`, :func:`plan_document`,
:class:`PlanStore` with its drift sentinel (``:223`` there) and
:func:`register_plan_metrics` (``:424``).

- :func:`plan_stage` — every decision point of the serving path (the
  app's admission, the engine's cache front, its per-target split, the
  pod tier's mesh consult, the micro-batcher's exit) appends ONE
  bounded stage entry to the ambient request's plan
  (``telemetry.RequestContext.plan``): the stage, the decision taken
  and, when a path was refused, why. A no-op off-request, like
  ``annotate``. The fleet plane's stages (``tier``, ``worker``,
  ``fallback``) and reasons (``planes_budget``, ``mesh_error``,
  ``breaker_open``, ``no_replica``) come with it.
- :func:`plan_shape` — the ordered stage/decision fingerprint
  (``admission=interactive>cache=miss>split``): volatile counts and
  details are excluded, so two requests served the same WAY share one
  shape.
- :class:`PlanStore` — the sampled aggregate served at ``/ops/plans``:
  per ``(query-shape, plan-shape)`` counts, cost-unit means, exemplar
  trace ids resolving through ``/_trace``, and the **plan-drift
  sentinel**: when a query-shape's dominant plan-shape changes between
  observation windows it publishes a ``plan.drift`` journal event,
  ticks ``plan.drift{shape}`` and names the shape for the
  ``/debug/status`` diagnosis. Windows roll from the canary prober's
  round loop.

Stdlib only and importable from any layer.
"""

from __future__ import annotations

import collections
import threading
import time

from .telemetry import current_context, publish_event

#: shared overflow bucket once ``max_shapes`` distinct query shapes are
#: tracked — the same name as accounting's per-shape cap
OVERFLOW_SHAPE = "other"

#: stage entries kept per request; a deeper decision tree truncates
#: (the document says so) instead of growing without bound
MAX_PLAN_STAGES = 48

#: distinct plan shapes tracked per query shape before new shapes fold
#: into the overflow plan-shape bucket
MAX_PLAN_SHAPES = 16

#: exemplar trace ids retained per (query-shape, plan-shape) aggregate
EXEMPLAR_KEEP = 4

#: drift events retained for /ops/plans + the /debug/status diagnosis
DRIFT_KEEP = 16

#: detail keys kept per stage entry (scalars only, insertion order)
_DETAIL_CAP = 8
_DETAIL_STR_CAP = 120

#: the literal registry of every plan stage producers may record —
#: the execution-plan document's schema (``tests/test_torch_serving_hooks.py``
#: holds it equal to the stages the package's sources record)
PLAN_STAGES = frozenset({
    "admission",  # tenant + priority lane classification (api/app.py)
    "cache",      # response-cache outcome + scope (engine.search)
    "mesh",       # mesh-tier consult: served, or refused with reason
    "split",      # per-target split counts across device paths
    "batch",      # microbatch exit: the launch family that served
})

#: the literal registry of every refusal reason — each names the
#: alternative NOT taken and why, so a plan reads as a decision tree
#: instead of a breadcrumb trail
PLAN_REASONS = frozenset({
    "stale",          # mesh stack predates the live index fingerprint
    "unbuilt",        # mesh stack not built yet (pre-warmup)
    "planes",         # plane-reading shape the mesh stack cannot serve
    "min_shards",     # query spans too few shards to pay the launch
})


def plan_stage(stage: str, *, decision: str = "", reason: str = "",
               **detail) -> None:
    """Append one bounded stage entry to the current request's
    execution plan, if any — a no-op off-request, so producers call it
    unconditionally (the same contract as ``annotate``).

    ``stage`` must be a literal member of :data:`PLAN_STAGES` and
    ``reason`` (when given) of :data:`PLAN_REASONS`. ``decision`` is the
    branch taken (it becomes part of the plan-shape fingerprint);
    ``detail`` keywords carry the measured evidence (counts, headroom
    bytes) and are excluded from the fingerprint."""
    ctx = current_context()
    if ctx is None:
        return
    plan = getattr(ctx, "plan", None)
    if plan is None or len(plan) >= MAX_PLAN_STAGES:
        return
    entry: dict = {"stage": stage}
    if decision:
        entry["decision"] = str(decision)
    if reason:
        entry["reason"] = str(reason)
    if detail:
        kept = {}
        for k, v in detail.items():
            if len(kept) >= _DETAIL_CAP:
                break
            if isinstance(v, bool) or isinstance(v, (int, float)):
                kept[k] = v
            elif isinstance(v, str):
                kept[k] = v[:_DETAIL_STR_CAP]
        if kept:
            entry["detail"] = kept
    plan.append(entry)


def explain_active() -> bool:
    """True when the current request asked for (and was granted) an
    inline execution plan — the engine's response-cache front and
    ``run_variant_search`` ride this so an explained answer is never
    served from (or written to) a cache."""
    ctx = current_context()
    return bool(ctx is not None and getattr(ctx, "explain", False))


#: stages excluded from the plan-shape fingerprint: the batch exit
#: records the launch family, which depends on what else was queued,
#: so including it would flap the shape of identically-routed
#: requests. It stays in the stage list — evidence, not identity.
VOLATILE_STAGES = frozenset({"batch"})


def plan_shape(entries) -> str:
    """The ordered stage/decision fingerprint of one plan: stages and
    decisions (and refusal reasons) joined in recording order, counts,
    details and :data:`VOLATILE_STAGES` excluded — the identity two
    same-way-served requests share. Bounded by MAX_PLAN_STAGES entries
    upstream."""
    parts = []
    for e in entries:
        if e["stage"] in VOLATILE_STAGES:
            continue
        p = e["stage"]
        if e.get("decision"):
            p += "=" + e["decision"]
        if e.get("reason"):
            p += "!" + e["reason"]
        parts.append(p)
    return ">".join(parts) if parts else "empty"


def plan_document(ctx) -> dict:
    """The ``meta.executionPlan`` document for one request context:
    the full stage list plus the compact fingerprint."""
    entries = list(getattr(ctx, "plan", None) or ())
    return {
        "stages": entries,
        "shape": plan_shape(entries),
        "truncated": len(entries) >= MAX_PLAN_STAGES,
    }


def plan_note(ctx) -> dict:
    """The compact ``notes.plan`` record for the slow-query log: the
    fingerprint plus any refusal reasons, so a logged outlier is
    diagnosable without reproducing it under ``?explain=1``."""
    entries = getattr(ctx, "plan", None) or ()
    note: dict = {"shape": plan_shape(entries)}
    refusals = [e["reason"] for e in entries if e.get("reason")]
    if refusals:
        note["refusals"] = refusals
    return note


class _PlanAgg:
    """One (query-shape, plan-shape) aggregate: count, cost-unit sum,
    and a bounded exemplar ring (trace ids + the latest sampled full
    stage list)."""

    __slots__ = ("count", "units", "exemplars", "stages", "last_t")

    def __init__(self):
        self.count = 0
        self.units = 0.0
        self.exemplars: collections.deque = collections.deque(
            maxlen=EXEMPLAR_KEEP
        )
        self.stages: list | None = None
        self.last_t = 0.0


class PlanStore:
    """The sampled plan aggregate + drift sentinel behind
    ``GET /ops/plans``.

    ``observe`` folds one finished request (cheap: two dict lookups and
    integer adds; the full stage document is retained only every
    ``sample_n``-th observation per aggregate). ``roll_window`` closes
    the current observation window — wired into the canary prober's
    round loop, and called lazily from ``observe`` when ``window_s``
    lapsed, so drift is caught within one window on busy AND idle
    fleets. A drift = the newest closed window's dominant plan-shape
    for a query-shape differing from the previous closed window's."""

    def __init__(
        self,
        *,
        sample_n: int = 16,
        max_shapes: int = 64,
        drift_windows: int = 2,
        window_s: float = 30.0,
        clock=time.monotonic,
    ):
        self.sample_n = max(1, int(sample_n))
        self.max_shapes = max(1, int(max_shapes))
        self.drift_windows = max(2, int(drift_windows))
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        #: qshape -> pshape -> _PlanAgg (lifetime)
        self._aggs: dict[str, dict[str, _PlanAgg]] = {}
        #: qshape -> Counter(pshape) for the OPEN window
        self._window: dict[str, collections.Counter] = {}
        #: qshape -> deque of closed-window dominant pshapes
        self._dominants: dict[str, collections.deque] = {}
        self._window_started = clock()
        self._windows_rolled = 0
        self._observations = 0
        self._sampled = 0
        self._drifts: collections.deque = collections.deque(
            maxlen=DRIFT_KEEP
        )
        self._drift_counts: dict[str, int] = {}

    # -- the fold ------------------------------------------------------------

    def _bound_qshape(self, qshape: str) -> str:
        if qshape in self._aggs or len(self._aggs) < self.max_shapes:
            return qshape
        return OVERFLOW_SHAPE

    def observe(
        self,
        qshape: str,
        entries,
        *,
        units: float = 0.0,
        trace_id: str = "",
    ) -> None:
        """Fold one finished request's plan into the aggregate (and
        lazily roll the window when ``window_s`` lapsed)."""
        pshape = plan_shape(entries)
        now = self._clock()
        with self._lock:
            qshape = self._bound_qshape(qshape)
            by_plan = self._aggs.setdefault(qshape, {})
            if pshape not in by_plan and len(by_plan) >= MAX_PLAN_SHAPES:
                pshape = OVERFLOW_SHAPE
            agg = by_plan.get(pshape)
            if agg is None:
                agg = by_plan[pshape] = _PlanAgg()
            agg.count += 1
            agg.units += float(units)
            agg.last_t = now
            self._observations += 1
            # systematic 1-in-N exemplar retention: the first
            # observation of a shape always samples (a brand-new plan
            # shape must be inspectable immediately), then every Nth
            if agg.count == 1 or agg.count % self.sample_n == 0:
                self._sampled += 1
                if trace_id:
                    agg.exemplars.append(trace_id)
                agg.stages = list(entries)
            self._window.setdefault(
                qshape, collections.Counter()
            )[pshape] += 1
            lapsed = (
                self.window_s > 0
                and now - self._window_started >= self.window_s
            )
        if lapsed:
            self.roll_window()

    # -- the drift sentinel --------------------------------------------------

    def roll_window(self) -> list[dict]:
        """Close the open observation window: per query-shape, compute
        the window's dominant plan-shape and compare it with the
        previous closed window's. Returns (and retains + publishes)
        the drift events detected. Wired into the canary prober's
        round loop; also called lazily from ``observe``."""
        drifts: list[dict] = []
        with self._lock:
            window = self._window
            self._window = {}
            self._window_started = self._clock()
            self._windows_rolled += 1
            for qshape, counts in window.items():
                if not counts:
                    continue
                dominant = counts.most_common(1)[0][0]
                ring = self._dominants.setdefault(
                    qshape,
                    collections.deque(maxlen=self.drift_windows),
                )
                prev = ring[-1] if ring else None
                ring.append(dominant)
                if prev is not None and prev != dominant:
                    event = {
                        "shape": qshape,
                        "from": prev,
                        "to": dominant,
                        "window": self._windows_rolled,
                        "time": time.time(),
                    }
                    drifts.append(event)
                    self._drifts.append(event)
                    self._drift_counts[qshape] = (
                        self._drift_counts.get(qshape, 0) + 1
                    )
        for event in drifts:
            # outside the lock: journal publication takes the journal's
            # own lock and may call listeners
            publish_event(
                "plan.drift",
                shape=event["shape"],
                prev=event["from"],
                now=event["to"],
            )
        return drifts

    # -- surfaces ------------------------------------------------------------

    def drifted_shapes(self) -> list[str]:
        """Query shapes with a retained drift event, newest last — the
        ``/debug/status`` diagnosis entry."""
        with self._lock:
            seen: dict[str, None] = {}
            for e in self._drifts:
                seen[e["shape"]] = None
            return list(seen)

    def counters(self) -> dict:
        with self._lock:
            return {
                "observations": self._observations,
                "sampled": self._sampled,
                "shapes": sum(
                    len(v) for v in self._aggs.values()
                ),
                "drifts": dict(self._drift_counts),
            }

    def snapshot(self) -> dict:
        """The ``GET /ops/plans`` document."""
        with self._lock:
            shapes: dict[str, dict] = {}
            for qshape in sorted(self._aggs):
                by_plan = self._aggs[qshape]
                plans = {}
                for pshape in sorted(by_plan):
                    agg = by_plan[pshape]
                    plans[pshape] = {
                        "count": agg.count,
                        "meanUnits": round(
                            agg.units / agg.count, 2
                        )
                        if agg.count
                        else 0.0,
                        "exemplarTraceIds": list(agg.exemplars),
                        "sampledStages": agg.stages,
                    }
                ring = self._dominants.get(qshape)
                shapes[qshape] = {
                    "plans": plans,
                    "dominant": ring[-1] if ring else None,
                    "previousDominant": (
                        ring[-2] if ring and len(ring) > 1 else None
                    ),
                }
            return {
                "sampleN": self.sample_n,
                "windowS": self.window_s,
                "driftWindows": self.drift_windows,
                "windowsRolled": self._windows_rolled,
                "observations": self._observations,
                "sampled": self._sampled,
                "shapes": shapes,
                "drifts": list(self._drifts),
            }


def register_plan_metrics(registry, store: PlanStore) -> None:
    """The ``plan.*`` series (callback-backed off the store's lifetime
    counters, catalogue-stable like every optional plane)."""
    registry.counter(
        "plan.sampled",
        "execution plans retained by the sampled plan store",
        fn=lambda: store.counters()["sampled"],
    )
    registry.gauge(
        "plan.shapes",
        "distinct (query-shape, plan-shape) aggregates tracked",
        fn=lambda: store.counters()["shapes"],
    )
    registry.counter(
        "plan.drift",
        "dominant plan-shape changes between observation windows",
        label="shape",
        fn=lambda: store.counters()["drifts"],
    )
