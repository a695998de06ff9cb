"""The port's SLO engine against the JAX package's, at tolerance 0:
the probe-route source and the sets derived from it, objective parsing,
and ``SloEngine`` fed the same seeded outcomes under one injected clock
— burn rates, breach verdicts and the breach listener's signals at every
step, ``snapshot()`` (global and per tenant) and the ``slo.*`` series.
"""

import random

import pytest

import sbeacon_tpu.slo as jslo
import sbeacon_tpu.telemetry as jtel
import sbeacon_tpu_torch.slo as tslo
import sbeacon_tpu_torch.telemetry as ttel
from sbeacon_tpu.config import ObservabilityConfig as JObs
from sbeacon_tpu_torch.config import ObservabilityConfig

ROUTES = ("g_variants", "datasets.g_variants", "info", "individuals.id",
          "health", "canary", "ops.costs")


def test_probe_route_sets_equal():
    for name in ("PROBE_ROUTE_LABELS", "NON_PATH_PROBE_LABELS",
                 "NON_HTTP_PROBE_LABELS", "PROBE_BYPASS_PATHS",
                 "PROBE_HEAD_LABELS", "DIAGNOSTIC_ROUTE_LABELS",
                 "EXCLUDED_ROUTES", "_EXCLUDED_HEADS", "WINDOWS"):
        assert getattr(tslo, name) == getattr(jslo, name), name
    for route in ROUTES + ("ops", "fleet.status", "debug.x", "other"):
        assert tslo.SloEngine.tracked(route) == jslo.SloEngine.tracked(route)


@pytest.mark.parametrize("spec", [
    "",
    "g_variants:latency_ms=50:latency_target=0.99, info:availability=0.99",
    "boolean:latency_ms=50",
    "g_variants:bogus=1",
    ":latency_ms=1",
    "g_variants:latency_ms",
    "g_variants:availability=2",
])
def test_parse_route_objectives(spec):
    def run(mod):
        try:
            got = mod.parse_route_objectives(spec, mod.SloObjective())
        except ValueError as e:
            return "error", str(e)
        return {k: (v.availability_target, v.latency_ms, v.latency_target)
                for k, v in got.items()}

    assert run(tslo) == run(jslo)


def _drive(mod, tel, seed, obs, max_tenants):
    clk = [1000.0]
    cfg = mod.SloEngine.from_config(obs, max_tenants=max_tenants)
    # the objectives of the config tier, on the injected clock
    eng = mod.SloEngine(default=cfg.default, routes=cfg.overrides,
                        alert_burn_rate=cfg.alert_burn_rate,
                        max_tenants=max_tenants, clock=lambda: clk[0])
    signals = []
    eng.add_breach_listener(lambda routes: signals.append(
        (clk[0], sorted(routes))))
    rng = random.Random(seed)
    steps = []
    for i in range(400):
        clk[0] += rng.choice((0.05, 0.5, 2.0, 7.0, 31.0))
        route = rng.choice(ROUTES)
        status = rng.choice((200, 200, 200, 404, 429, 500, 503, 504))
        ms = rng.choice((1.0, 40.0, 120.0, 260.0, 2500.0))
        tenant = rng.choice(("gold", "free", None, f"t{i % 5}"))
        eng.record(route, status, ms, tenant=tenant)
        if i % 37 == 0:
            steps.append((eng.burn_rates("availability"),
                          eng.burn_rates("latency"), eng.breached(),
                          eng.breached_routes()))
    reg = tel.MetricsRegistry()
    eng.register_metrics(reg)
    return {
        "steps": steps,
        "signals": signals,
        "snapshot": eng.snapshot(),
        "tenants": eng.tenants(),
        "by_tenant": {t: eng.snapshot(tenant=t)
                      for t in eng.tenants() + ["nobody"]},
        "json": reg.render_json(),
        "text": reg.render_prometheus(),
    }


@pytest.mark.parametrize("seed,max_tenants", [(0, None), (1, 3), (2, 64)])
def test_slo_engine_equal_step_by_step(seed, max_tenants):
    kw = dict(slo_latency_ms=100.0, slo_routes="info:availability=0.99:"
              "latency_ms=50,boolean:latency_ms=20", slo_alert_burn_rate=6.0)
    got = _drive(tslo, ttel, seed, ObservabilityConfig(**kw), max_tenants)
    want = _drive(jslo, jtel, seed, JObs(**kw), max_tenants)
    assert got == want
    assert got["signals"], "the walk breached no route: widen it"


def test_from_config_defaults_equal():
    got = tslo.SloEngine.from_config(ObservabilityConfig())
    want = jslo.SloEngine.from_config(JObs())
    assert (got.default, got.alert_burn_rate, got.max_tenants) == (
        tslo.SloObjective(**vars(want.default)), want.alert_burn_rate,
        want.max_tenants)
    assert got.snapshot() == want.snapshot()
