"""Per-request execution plans: the stage entries of EXPLAIN.

Counterpart of ``sbeacon_tpu/plan.py:1-205``: :func:`plan_stage`, the
``PLAN_STAGES`` / ``PLAN_REASONS`` registries (trimmed to the stages
and reasons this package records), :func:`plan_shape` and
:func:`plan_note`. Every decision point of
the serving path (the engine's cache front, its per-target split, the
micro-batcher's exit) appends ONE bounded stage entry to the ambient
request's plan (``telemetry.RequestContext.plan``): the stage, the
decision taken and, when a path was refused, why. A no-op off-request,
like ``annotate``. The sampled ``PlanStore`` aggregate, its drift
sentinel, the ``meta.executionPlan`` document and ``?explain=1`` come
with the HTTP surface, and with it the stages of admission, tier
choice, worker legs and fallbacks.

Stdlib only and importable from any layer.
"""

from __future__ import annotations

from .telemetry import current_context

#: stage entries kept per request; a deeper decision tree truncates
#: (the document says so) instead of growing without bound
MAX_PLAN_STAGES = 48

#: detail keys kept per stage entry (scalars only, insertion order)
_DETAIL_CAP = 8
_DETAIL_STR_CAP = 120

#: the literal registry of every plan stage producers may record —
#: the execution-plan document's schema (``tests/test_torch_serving_hooks.py``
#: holds it equal to the stages the package's sources record)
PLAN_STAGES = frozenset({
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
