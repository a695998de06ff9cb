"""The port's execution-plan plane against the JAX package's, at
tolerance 0: the stage entries, ``plan_shape``, ``plan_document``,
``plan_note`` and ``explain_active`` of the same request contexts, and
``PlanStore`` fed the same seeded plans under one injected clock — its
folds, sampling, cardinality caps, window rolls and drift sentinel
(``snapshot``, ``counters``, ``drifted_shapes``, the ``plan.drift``
journal events) and the ``plan.*`` series.
"""

import random
import time

import pytest

import sbeacon_tpu.plan as jplan
import sbeacon_tpu.telemetry as jtel
import sbeacon_tpu_torch.plan as tplan
import sbeacon_tpu_torch.telemetry as ttel

NOW = 1_790_000_123.5


@pytest.fixture
def wall(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def _stages(plan_mod, tel_mod, rng, explain):
    ctx = tel_mod.RequestContext(trace_id="t", route="g_variants")
    ctx.explain = explain
    outside = plan_mod.explain_active()
    with tel_mod.request_context(ctx):
        active = plan_mod.explain_active()
        plan_mod.plan_stage("admission", decision=rng.choice(
            ("interactive", "bulk")), tenant="gold")
        plan_mod.plan_stage("cache", decision=rng.choice(("miss", "off")))
        if rng.random() < 0.5:
            plan_mod.plan_stage("mesh", decision="refused",
                                reason=rng.choice(("stale", "planes")),
                                headroom=12, note="x" * 200, flag=True,
                                skipped=[1])
        plan_mod.plan_stage("split", decision="fanout", fused=2, scatter=3,
                            mesh=0, l0=1, a=1, b=2, c=3, d=4, e=5)
        plan_mod.plan_stage("batch", decision="FusedDeviceIndex",
                            batch_ms=1.5)
        for _ in range(rng.choice((0, 60))):
            plan_mod.plan_stage("cache", decision="hit")
    return (outside, active, plan_mod.plan_shape(ctx.plan),
            plan_mod.plan_document(ctx), plan_mod.plan_note(ctx))


def test_stage_documents_equal():
    for seed in range(8):
        for explain in (False, True):
            got = _stages(tplan, ttel, random.Random(seed), explain)
            want = _stages(jplan, jtel, random.Random(seed), explain)
            assert got == want
    assert tplan.plan_shape([]) == jplan.plan_shape([]) == "empty"
    # off-request: nothing recorded, nothing raised
    tplan.plan_stage("cache", decision="miss")
    assert tplan.plan_document(ttel.RequestContext()) == (
        jplan.plan_document(jtel.RequestContext()))


PSHAPES = (
    [{"stage": "admission", "decision": "interactive"},
     {"stage": "cache", "decision": "miss"},
     {"stage": "split", "decision": "fanout"}],
    [{"stage": "admission", "decision": "interactive"},
     {"stage": "cache", "decision": "hit"}],
    [{"stage": "mesh", "decision": "refused", "reason": "planes"},
     {"stage": "batch", "decision": "FusedDeviceIndex"}],
)


def _store(plan_mod, tel_mod, seed, sample_n, max_shapes, window_s):
    clk = [50.0]
    store = plan_mod.PlanStore(sample_n=sample_n, max_shapes=max_shapes,
                               drift_windows=3, window_s=window_s,
                               clock=lambda: clk[0])
    seq0 = tel_mod.journal.last_seq()
    rng = random.Random(seed)
    reads = []
    phase = 0
    for i in range(500):
        clk[0] += rng.choice((0.01, 0.3, 2.0))
        if i % 120 == 119:
            phase += 1  # the dominant plan of a shape flips
        qshape = rng.choice(("g_variants:boolean", "g_variants:record",
                             "info:default", f"s{i % 7}:count"))
        k = (phase + (rng.random() < 0.2)) % len(PSHAPES)
        store.observe(qshape, PSHAPES[k], units=rng.uniform(0, 900),
                      trace_id=f"tr{i}")
        if i % 97 == 0:
            reads.append(store.roll_window())
        if i % 61 == 0:
            reads.append((store.counters(), store.drifted_shapes()))
    reg = tel_mod.MetricsRegistry()
    plan_mod.register_plan_metrics(reg, store)
    events = [
        (e["kind"], e["data"])
        for e in tel_mod.journal.events(since=seq0, kind="plan.drift",
                                        limit=10_000)
    ]
    return {"reads": reads, "snapshot": store.snapshot(),
            "counters": store.counters(),
            "drifted": store.drifted_shapes(), "events": events,
            "json": reg.render_json(), "text": reg.render_prometheus()}


@pytest.mark.parametrize("seed,sample_n,max_shapes,window_s",
                         [(0, 16, 64, 30.0), (1, 1, 3, 5.0),
                          (2, 4, 64, 0.0)])
def test_plan_store_equal(wall, seed, sample_n, max_shapes, window_s):
    got = _store(tplan, ttel, seed, sample_n, max_shapes, window_s)
    want = _store(jplan, jtel, seed, sample_n, max_shapes, window_s)
    assert got == want
    if window_s:
        assert got["snapshot"]["drifts"], "the walk drifted nothing"


def test_registries_hold_the_app_stages():
    """The stages this package records are JAX's registered ones."""
    assert tplan.PLAN_STAGES <= jplan.PLAN_STAGES
    assert tplan.PLAN_REASONS <= jplan.PLAN_REASONS
    assert "admission" in tplan.PLAN_STAGES
    for name in ("MAX_PLAN_STAGES", "MAX_PLAN_SHAPES", "EXEMPLAR_KEEP",
                 "DRIFT_KEEP", "OVERFLOW_SHAPE"):
        assert getattr(tplan, name) == getattr(jplan, name), name
