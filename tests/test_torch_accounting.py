"""The port's cost accounting against the JAX package's, at tolerance
0: ``cost_units`` and ``query_shape``, and ``CostAccounting`` fed the
same seeded cost vectors under one injected clock — ``snapshot``,
``debug``, ``shape_cost``, the cost-aware DRR charge, the tenant and
shape caps, off-request ``system`` work, and the ``cost.*`` series.
The process-global unattributed residue each package keeps is replaced
by one fed the same charges.
"""

import random

import pytest

import sbeacon_tpu.accounting as jacc
import sbeacon_tpu.telemetry as jtel
import sbeacon_tpu_torch.accounting as tacc
import sbeacon_tpu_torch.telemetry as ttel

TENANTS = ("gold", "free", "anon", "t3", "t4", "t5", "t6")
SHAPES = ("g_variants:boolean", "g_variants:record", "info:default",
          "datasets.g_variants:count", "individuals.id:default",
          "g_variants.id:record", "x:other")
LANES = ("interactive", "bulk")


def _vec(rng):
    vec = {}
    for field in ("device_us", "host_rows", "delta_shards", "worker_rtt_ms",
                  "queue_wait_ms", "response_bytes"):
        if rng.random() < 0.6:
            vec[field] = round(rng.uniform(0, 5000), 3)
    vec["cache"] = rng.choice(("", "hit", "miss", "negative_hit"))
    return vec


def test_cost_units_and_query_shape():
    rng = random.Random(3)
    for _ in range(50):
        vec = _vec(rng)
        assert tacc.cost_units(vec) == jacc.cost_units(vec)
    for route in ("g_variants", "info", "datasets.g_variants"):
        for g in (None, "", "boolean", "COUNT", "Record", "weird", "default"):
            assert tacc.query_shape(route, g) == jacc.query_shape(route, g)


def _drive(acc_mod, tel_mod, monkeypatch, seed, max_tenants, max_shapes):
    residue = tel_mod.CostVector()
    monkeypatch.setattr(acc_mod, "UNATTRIBUTED_COST", residue)
    clk = [500.0]
    acct = acc_mod.CostAccounting(window_s=60.0, max_tenants=max_tenants,
                                  max_shapes=max_shapes,
                                  clock=lambda: clk[0])
    rng = random.Random(seed)
    reads = []
    for i in range(300):
        clk[0] += rng.choice((0.1, 1.0, 9.0, 45.0))
        if i % 29 == 0:
            residue.add(device_us=rng.uniform(0, 900),
                        host_rows=rng.randrange(100))
        if i % 41 == 0:
            acct.record_system("compaction.fold",
                               device_us=rng.uniform(0, 100),
                               host_rows=rng.randrange(1000))
        acct.record(rng.choice(TENANTS), rng.choice(LANES),
                    rng.choice(SHAPES), _vec(rng))
        if i % 23 == 0:
            reads.append((
                {k: acct.shape_cost(lane, k) for lane in LANES
                 for k in SHAPES},
                {k: acct.drr_charge(lane, k) for lane in LANES
                 for k in SHAPES + ("unknown",)},
                sorted(acct.shape_units().items()),
                acct.tenant_field("units"),
                acct.tenant_field("device_us"),
            ))
    reg = tel_mod.MetricsRegistry()
    acct.register_metrics(reg)
    return {
        "reads": reads,
        "snapshot": acct.snapshot(),
        "top2": acct.snapshot(top_n=2),
        "debug": acct.debug(),
        "json": reg.render_json(),
        "text": reg.render_prometheus(),
    }


@pytest.mark.parametrize("seed,max_tenants,max_shapes",
                         [(0, 64, 64), (1, 3, 4), (2, 5, 64)])
def test_cost_table_equal(monkeypatch, seed, max_tenants, max_shapes):
    got = _drive(tacc, ttel, monkeypatch, seed, max_tenants, max_shapes)
    want = _drive(jacc, jtel, monkeypatch, seed, max_tenants, max_shapes)
    assert got == want


def test_disabled_snapshot_equal():
    assert tacc.disabled_snapshot() == jacc.disabled_snapshot()


def test_drr_charge_reaches_the_fair_queue():
    """The cost-aware DRR seam, wired as the app wires it: a shaper built
    with ``cost_drr`` charges a grant the shape's measured cost."""
    from sbeacon_tpu.config import BeaconConfig as JConfig
    from sbeacon_tpu.config import ShapingConfig as JShaping
    from sbeacon_tpu.shaping import TrafficShaper as JShaper
    from sbeacon_tpu_torch.config import BeaconConfig, ShapingConfig
    from sbeacon_tpu_torch.shaping import TrafficShaper

    out = []
    for acc_mod, shaper, cfg in (
            (tacc, TrafficShaper, BeaconConfig(shaping=ShapingConfig(
                cost_drr=True))),
            (jacc, JShaper, JConfig(shaping=JShaping(cost_drr=True)))):
        acct = acc_mod.CostAccounting()
        for _ in range(10):
            acct.record("a", "interactive", "cheap:boolean",
                        {"device_us": 100.0})
            acct.record("b", "interactive", "exp:record",
                        {"device_us": 10_000.0})
        sh = shaper.from_config(cfg, cost_charge_fn=acct.drr_charge)
        q = sh.queue
        with q._lock:
            out.append([q._grant_charge_locked(
                "interactive", type("W", (), {"shape": s})())
                for s in ("cheap:boolean", "exp:record", None, "nope")])
    assert out[0] == out[1]
