"""The port's traffic shaping against the JAX package's, at tolerance 0:
tenant and lane classification, the weighted fair queue's grant order
(the DRR drain, strict lane precedence, the bulk starvation escape, the
cost-aware charge), its sheds with the adaptive Retry-After of the
measured queue waits, the brownout ladder stepped by the same breach
signal under one injected clock, and the shaper's debug rollup and
series. The queue is driven without threads: waiters are enqueued as
``acquire`` enqueues them and granted by ``release``.
"""

import random

import pytest

import sbeacon_tpu.shaping as jsh
import sbeacon_tpu.telemetry as jtel
import sbeacon_tpu_torch.shaping as tsh
import sbeacon_tpu_torch.telemetry as ttel
from sbeacon_tpu.config import BeaconConfig as JConfig
from sbeacon_tpu.config import ResilienceConfig as JResilience
from sbeacon_tpu.config import ShapingConfig as JShaping
from sbeacon_tpu.resilience import Overloaded as JOverloaded
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    ResilienceConfig,
    ShapingConfig,
)
from sbeacon_tpu_torch.resilience import Overloaded


@pytest.fixture(autouse=True)
def _hedging_restored():
    yield
    from sbeacon_tpu.parallel import dispatch as jdispatch
    from sbeacon_tpu_torch.parallel import dispatch as tdispatch

    jdispatch.set_hedging_enabled(True)
    tdispatch.set_hedging_enabled(True)


HEADERS = [
    None,
    {},
    {"X-Beacon-Tenant": "gold"},
    {"x-beacon-tenant": "free", "Authorization": "Bearer k"},
    {"X-Beacon-Tenant": "bad tenant!"},
    {"X-Beacon-Tenant": "a" * 65, "authorization": "Bearer other"},
    {"Authorization": "Bearer k"},
    {"X-Tenant": "custom"},
]
LANE_CASES = [
    ("g_variants", None, {"query": {"requestedGranularity": "record"}}),
    ("g_variants", {"requestedGranularity": "RECORD"}, None),
    ("g_variants", {"requestedGranularity": "record"},
     {"query": {"requestedGranularity": "count"}}),
    ("submit", None, None),
    ("info", None, None),
    ("g_variants", None, {"query": "not a dict"}),
    ("datasets/ds1/g_variants", None,
     {"query": {"requestedGranularity": "boolean"}}),
]


def test_classification_equal():
    for h in HEADERS:
        for header in ("X-Beacon-Tenant", "X-Tenant"):
            assert tsh.classify_tenant(h, header=header) == (
                jsh.classify_tenant(h, header=header))
    for head, qp, body in LANE_CASES:
        assert tsh.classify_lane(head, qp, body) == jsh.classify_lane(
            head, qp, body)
        assert tsh.requested_granularity(qp, body) == (
            jsh.requested_granularity(qp, body))
    for spec in ("", "gold=4,free=1", " gold = 4 , free=0.5,", "x=0",
                 "x=-1", "bad", "a=b", "bad tenant=2,ok=3"):
        def parse(mod):
            try:
                return mod.parse_tenant_weights(spec)
            except ValueError as e:
                return "error", str(e)

        assert parse(tsh) == parse(jsh)


def _enqueue(mod, q, tenant, lane, shape=None):
    """A waiter queued exactly as ``acquire`` queues one (its enqueue
    branch), without a thread blocking on it."""
    with q._lock:
        ts = q._tenant(tenant)
        w = mod._Waiter(ts.name, lane, q._clock(), shape=shape)
        ts.queues[lane].append(w)
        q._queued += 1
    return w


def _grant_order(mod, seed, cost_fn=None):
    rng = random.Random(seed)
    clk = [10.0]
    q = mod.FairQueueAdmission(
        max_in_flight=1, tenant_max_in_flight=1, tenant_queue_depth=64,
        weights={"gold": 4.0, "free": 1.0, "tiny": 0.4},
        bulk_starvation_ms=300.0, clock=lambda: clk[0],
        cost_charge_fn=cost_fn,
    )
    holder = q.acquire("seed", mod.LANE_INTERACTIVE)
    waiters = []
    for i in range(60):
        clk[0] += rng.choice((0.0, 0.01, 0.05))
        tenant = rng.choice(("gold", "gold", "free", "tiny", "anon"))
        lane = rng.choice((mod.LANE_INTERACTIVE, mod.LANE_BULK))
        shape = rng.choice(("g:boolean", "g:record", None))
        waiters.append(_enqueue(mod, q, tenant, lane, shape))
    order = []
    for _ in waiters:
        clk[0] += rng.choice((0.02, 0.2, 0.6))
        q.release(holder)
        granted = [w for w in waiters if w.granted and w not in order]
        assert len(granted) == 1
        order.append(granted[0])
        holder = granted[0].tenant
    q.release(holder)
    return ([(w.tenant, w.lane, w.shape) for w in order], q.totals(),
            q.tenants(), {lane: q.retry_after(lane) for lane in mod.LANES})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_grant_order_equal(seed):
    assert _grant_order(tsh, seed) == _grant_order(jsh, seed)


def test_cost_aware_grant_order_equal():
    def cost(lane, shape):
        return {"g:boolean": 0.3, "g:record": 1.9}.get(shape, 0.0) * 1.0

    assert _grant_order(tsh, 7, cost) == _grant_order(jsh, 7, cost)


def _sheds(mod, overloaded):
    clk = [0.0]
    q = mod.FairQueueAdmission(
        max_in_flight=1, tenant_max_in_flight=1, tenant_queue_depth=2,
        retry_floor_s=0.5, retry_ceil_s=4.0, max_tenants=3,
        clock=lambda: clk[0],
    )
    out = [q.retry_after(lane) for lane in mod.LANES]
    holder = q.acquire("a", mod.LANE_INTERACTIVE)
    # measured waits: waiters enqueued, granted after the clock moved
    for wait in (0.1, 2.5, 0.7, 9.0, 1.2):
        w = _enqueue(mod, q, "b", mod.LANE_BULK)
        clk[0] += wait
        q.release(holder)
        assert w.granted
        holder = "b"
        out.append(q.retry_after(mod.LANE_BULK))
    # a full queue sheds at once with the adaptive Retry-After
    for tenant, lane in (("c", mod.LANE_BULK), ("c", mod.LANE_BULK),
                         ("c", mod.LANE_BULK), ("d", mod.LANE_INTERACTIVE),
                         ("e", mod.LANE_INTERACTIVE),
                         ("f", mod.LANE_INTERACTIVE)):
        if len(q._tenant(tenant).queues[lane]) < q.tenant_queue_depth:
            _enqueue(mod, q, tenant, lane)
            out.append(("queued", tenant, lane))
            continue
        with pytest.raises(overloaded) as exc:
            q.acquire(tenant, lane)
        out.append((str(exc.value), exc.value.retry_after_s))
    # brownout flags: bulk paused flushes queued bulk, global shed sheds
    q.set_brownout(bulk_paused=True)
    with pytest.raises(overloaded) as exc:
        q.acquire("g", mod.LANE_BULK)
    out.append((str(exc.value), exc.value.retry_after_s, q.totals()))
    q.set_brownout(bulk_paused=False, global_shed=True, cap_scale=0.3)
    with pytest.raises(overloaded) as exc:
        q.acquire("a", mod.LANE_INTERACTIVE)
    out.append((str(exc.value), q.totals(), q.tenants(), q.lane_queued(),
                q.tenant_field("shed"), q.tenant_field("queued")))
    return out


def test_sheds_and_adaptive_retry_after_equal():
    assert _sheds(tsh, Overloaded) == _sheds(jsh, JOverloaded)


def _ladder(mod, tel, seq):
    clk = [0.0]
    q = mod.FairQueueAdmission(max_in_flight=4)
    flags = []
    ladder = mod.BrownoutLadder(q, up_hold_s=1.0, down_hold_s=2.0,
                                md_factor=0.5, ai_step=0.25,
                                min_scale=0.125,
                                hedge_control=flags.append,
                                clock=lambda: clk[0])
    seq0 = tel.journal.last_seq()
    steps = []
    for t, routes in seq:
        clk[0] = t
        ladder.on_signal(routes)
        steps.append((ladder.level, ladder.cap_scale, ladder.transitions,
                      q.totals()))
    events = [e["data"] for e in tel.journal.events(
        since=seq0, kind="shaping.brownout", limit=1000)]
    return steps, flags, events


def test_brownout_ladder_equal():
    rng = random.Random(5)
    seq, t = [], 0.0
    for i in range(120):
        t += rng.choice((0.3, 0.9, 1.1, 2.5))
        breach = (i // 30) % 2 == 0
        seq.append((t, ["g_variants", "info"][: rng.randrange(1, 3)]
                    if breach else []))
    assert _ladder(tsh, ttel, seq) == _ladder(jsh, jtel, seq)


def _shaper(mod, tel, config):
    flags = []
    sh = mod.TrafficShaper.from_config(config, hedge_control=flags.append)
    reg = tel.MetricsRegistry()
    sh.register_metrics(reg)
    out = [sh.tenant_of(h) for h in HEADERS]
    out += [sh.lane_of(head, qp, body) for head, qp, body in LANE_CASES]
    with sh.admit("gold", "interactive", "g:boolean"):
        out.append(sh.debug())
    for _ in range(12):
        sh.on_slo_signal(["g_variants"])
    out += [sh.debug(), sh.brownout_level(), reg.render_json()]
    sh.close()
    return out, flags


@pytest.mark.parametrize("enabled", [True, False])
def test_traffic_shaper_equal(enabled):
    kw = dict(enabled=enabled, tenant_weights="gold=4,free=1",
              tenant_max_in_flight=5, brownout_up_hold_s=0.0)
    got = _shaper(tsh, ttel, BeaconConfig(
        shaping=ShapingConfig(**kw),
        resilience=ResilienceConfig(max_in_flight=9)))
    want = _shaper(jsh, jtel, JConfig(
        shaping=JShaping(**kw), resilience=JResilience(max_in_flight=9)))
    assert got == want


def test_hedge_switch_is_a_module_flag():
    """The brownout's first rung flips the port's process flag, and the
    shaper's close hands it back."""
    from sbeacon_tpu_torch.parallel import dispatch as tdispatch

    sh = tsh.TrafficShaper.from_config(
        BeaconConfig(shaping=ShapingConfig(brownout_up_hold_s=0.0)),
        hedge_control=tdispatch.set_hedging_enabled)
    sh.on_slo_signal(["g_variants"])
    sh.on_slo_signal(["g_variants"])
    assert sh.brownout_level() >= 1 and tdispatch._hedging_enabled is False
    sh.close()
    assert tdispatch._hedging_enabled is True
