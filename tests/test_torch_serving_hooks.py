"""The serving hooks of the port against the JAX package's.

The micro-batcher's request deadlines (504 against 503), its bounded
leader and follower waits, the lane-ordered pop, the deadline filter,
the ``kernel.launch`` fault point and the cost charges; the engine's
``plan_stage`` entries and request annotations for the same request in
both packages; and ``warmup`` launching every kernel family once
against each loaded index. Everything runs on the CPU (the kernel
wrappers run their plain-PyTorch twins); the JAX engines are closed in
fixtures.
"""

import dataclasses
import random
import threading
import time

import pytest
import torch

import sbeacon_tpu.telemetry as jtel
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.harness import faults as jfaults
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.plan import plan_note as j_plan_note
from sbeacon_tpu.plan import plan_shape as j_plan_shape
from sbeacon_tpu.resilience import Deadline as JDeadline
from sbeacon_tpu.testing import random_records
import sbeacon_tpu_torch.serving as serving_mod
import sbeacon_tpu_torch.telemetry as ttel
from sbeacon_tpu_torch import plan as tplan
from sbeacon_tpu_torch import resilience as tres
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.harness import faults
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.ops import make_device_index
from sbeacon_tpu_torch.ops import plane_kernel as tpk
from sbeacon_tpu_torch.ops import scatter_kernel as tsk
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.resilience import (
    BatchTimeout,
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from torch_ingest_corpus import no_thread_leak  # noqa: F401

SAMPLES = ["S0", "S1"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_faults():
    faults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


@pytest.fixture(scope="module")
def dindex():
    recs = random_records(random.Random(11), chrom="1", n=120, n_samples=2)
    shard = shard_from_reference(j_build_index(
        recs, dataset_id="ds", vcf_location="v", sample_names=SAMPLES))
    return shard, make_device_index(shard, "cpu")


def _spec(shard):
    p = int(shard.cols["pos"][0])
    return tk.QuerySpec("1", max(1, p - 5), p + 5, 1, 1 << 30,
                        alternate_bases="N")


def _wedge_launches(monkeypatch):
    """The batcher's kernel dispatch blocks until released."""
    release = threading.Event()
    in_execute = threading.Event()
    orig = serving_mod.run_queries_auto

    def wedged(index, queries, **kw):
        in_execute.set()
        assert release.wait(15), "test deadlock"
        return orig(index, queries, **kw)

    monkeypatch.setattr(serving_mod, "run_queries_auto", wedged)
    return in_execute, release


def _wait_leader(acc):
    t_end = time.time() + 5
    while time.time() < t_end and not acc.leader_active:
        time.sleep(0.005)
    assert acc.leader_active


# -- the taxonomy ---------------------------------------------------------------


def test_taxonomy_and_deadline_as_jax():
    assert (DeadlineExceeded.status, BatchTimeout.status) == (504, 503)
    assert (tres.Overloaded("x").status, tres.CircuitOpen.status) == (429,
                                                                      503)
    assert tres.Overloaded("x").retry_after_s == 1.0
    assert serving_mod.BatchTimeout is BatchTimeout
    assert tres.Deadline.after(0) is tres.NO_DEADLINE
    assert tres.Deadline.after(None) is tres.NO_DEADLINE
    d = Deadline.after(5.0)
    jd = JDeadline.after(5.0)
    assert abs(d.remaining() - jd.remaining()) < 0.5
    assert d.clamp(1.0) == 1.0 and tres.NO_DEADLINE.clamp(None) is None
    assert d.combine(0.5).remaining() < 0.6
    gone = Deadline.after(0.001)
    time.sleep(0.01)
    assert gone.expired()
    with pytest.raises(DeadlineExceeded, match="probe: deadline"):
        gone.check("probe")
    assert tres.current_deadline() is tres.NO_DEADLINE
    seen = []
    with deadline_scope(d):
        assert tres.current_deadline() is d
        t = threading.Thread(target=lambda: seen.append(
            tres.current_deadline()))
        t.start()
        t.join()
    assert seen == [tres.NO_DEADLINE]


# -- the batcher's bounded waits --------------------------------------------------


def test_batcher_follower_times_out_behind_wedged_leader(dindex,
                                                         monkeypatch):
    shard, di = dindex
    spec = _spec(shard)
    mb = serving_mod.MicroBatcher(max_batch=64, max_wait_ms=400)
    _in, release = _wedge_launches(monkeypatch)
    leader_done = []
    lt = threading.Thread(target=lambda: leader_done.append(
        mb.submit(di, spec, window_cap=256, record_cap=64)))
    lt.start()
    acc = mb._accum(di, (256, 64))
    _wait_leader(acc)
    t0 = time.perf_counter()
    with pytest.raises(BatchTimeout):
        mb.submit(di, spec, window_cap=256, record_cap=64, timeout_s=0.2)
    assert time.perf_counter() - t0 < 5.0
    release.set()
    lt.join(10)
    assert not lt.is_alive()
    assert leader_done and leader_done[0].exists is not None
    assert mb.occupancy()["timeouts"] == 1
    got = mb.submit(di, spec, window_cap=256, record_cap=64)
    assert got.exists is not None
    assert acc.leader_active is False and acc.items == []
    mb.close()


def test_batcher_leader_bounded_on_wedged_launch(dindex, monkeypatch):
    shard, di = dindex
    spec = _spec(shard)
    mb = serving_mod.MicroBatcher(max_batch=8, max_wait_ms=0)
    _in, release = _wedge_launches(monkeypatch)
    t0 = time.perf_counter()
    with pytest.raises(BatchTimeout):
        mb.submit(di, spec, window_cap=256, record_cap=64, timeout_s=0.3)
    assert time.perf_counter() - t0 < 5.0
    assert mb.occupancy()["timeouts"] == 1
    with deadline_scope(Deadline.after(0.2)):
        with pytest.raises(DeadlineExceeded):
            mb.submit(di, spec, window_cap=256, record_cap=64)
    release.set()
    time.sleep(0.3)
    acc = mb._accum(di, (256, 64))
    assert acc.leader_active is False and acc.items == []
    got = mb.submit(di, spec, window_cap=256, record_cap=64)
    assert got.exists is not None
    mb.close()


def test_leader_hands_off_backlog_once_served(dindex, monkeypatch):
    shard, di = dindex
    spec = _spec(shard)
    orig = serving_mod.run_queries_auto
    launch_s, window_s = 0.4, 1.0

    def slow(index, queries, **kw):
        time.sleep(launch_s)
        return orig(index, queries, **kw)

    monkeypatch.setattr(serving_mod, "run_queries_auto", slow)
    mb = serving_mod.MicroBatcher(max_batch=2, max_wait_ms=window_s * 1e3)
    t_leader = []

    def leader():
        t0 = time.perf_counter()
        r = mb.submit(di, spec, window_cap=256, record_cap=64)
        t_leader.append((time.perf_counter() - t0, r))

    lt = threading.Thread(target=leader)
    lt.start()
    acc = mb._accum(di, (256, 64))
    _wait_leader(acc)
    results = [None] * 4

    def follower(i):
        results[i] = mb.submit(di, spec, window_cap=256, record_cap=64)

    fts = [threading.Thread(target=follower, args=(i,)) for i in range(4)]
    for t in fts:
        t.start()
    t_end = time.time() + window_s * 0.9
    while time.time() < t_end and len(acc.items) < 5:
        time.sleep(0.005)
    assert len(acc.items) == 5
    lt.join(10)
    took, res = t_leader[0]
    assert res.exists is not None
    assert took < window_s + 2.2 * launch_s, took
    for t in fts:
        t.join(15)
        assert not t.is_alive()
    assert all(r is not None and r.exists is not None for r in results)
    t_end = time.time() + 5
    while time.time() < t_end and acc.leader_active:
        time.sleep(0.01)
    assert acc.leader_active is False and acc.items == []
    mb.close()


def test_batcher_refuses_launch_for_expired_batch(dindex):
    shard, di = dindex
    spec = _spec(shard)
    mb = serving_mod.MicroBatcher(max_batch=8, max_wait_ms=0)
    with deadline_scope(Deadline.after(0.001)):
        time.sleep(0.01)
        with pytest.raises(DeadlineExceeded):
            mb.submit(di, spec, window_cap=256, record_cap=64)
    occ = mb.occupancy()
    assert occ["launches"] == 0 and occ["expired"] == 1
    got = mb.submit(di, spec, window_cap=256, record_cap=64)
    assert got.exists is not None
    assert mb.occupancy()["launches"] == 1
    mb.close()


def test_batcher_ambient_deadline_bounds_follower_wait(dindex, monkeypatch):
    shard, di = dindex
    spec = _spec(shard)
    mb = serving_mod.MicroBatcher(max_batch=64, max_wait_ms=400)
    _in, release = _wedge_launches(monkeypatch)
    lt = threading.Thread(
        target=lambda: mb.submit(di, spec, window_cap=256, record_cap=64))
    lt.start()
    _wait_leader(mb._accum(di, (256, 64)))
    with deadline_scope(Deadline.after(0.2)):
        with pytest.raises(DeadlineExceeded):
            mb.submit(di, spec, window_cap=256, record_cap=64)
    assert mb.occupancy()["expired"] == 1
    assert mb.occupancy()["timeouts"] == 0
    release.set()
    lt.join(10)
    assert not lt.is_alive()
    mb.close()


@pytest.mark.parametrize("lead", [True, False])
def test_interactive_lane_rides_ahead_of_bulk(lead):
    """With a backlog of more than one batch, queued interactive entries
    pop before young bulk ones (FIFO within a lane); the leader's own
    entry stays first, and a bulk entry older than
    ``BULK_SORT_STARVATION_MS`` keeps its FIFO place."""
    mb = serving_mod.MicroBatcher(max_batch=1, max_wait_ms=0)
    acc = serving_mod._Accumulator()
    now = time.perf_counter()

    def entry(tag, lane, age_s=0.0):
        return serving_mod._Pending(
            specs=[tag], event=threading.Event(), lane=lane,
            t_submit=now - age_s)

    me = entry("first", "bulk")
    acc.items = [me, entry("b1", "bulk"), entry("old", "bulk", 1.0),
                 entry("b2", "bulk"), entry("i1", "interactive"),
                 entry("i2", "interactive")]
    acc.leader_active = True
    order = []
    while acc.items:
        batch, more = mb._pop_batch(acc, me if lead else None)
        order.extend(p.specs[0] for p in batch)
        assert more == bool(acc.items) == acc.leader_active
    if lead:
        assert order == ["first", "old", "i1", "i2", "b1", "b2"]
    else:
        assert order == ["old", "i1", "i2", "first", "b1", "b2"]
    mb.close()


# -- fault points ------------------------------------------------------------------


def test_fault_point_fails_every_waiter(dindex):
    shard, di = dindex
    mb = serving_mod.MicroBatcher(max_batch=8, max_wait_ms=0)
    inj = faults.install({"rules": [{"site": "kernel.launch",
                                     "kind": "error", "count": 1}]})
    with pytest.raises(faults.FaultError):
        mb.submit(di, _spec(shard), window_cap=256, record_cap=64)
    assert inj.stats()["kernel.launch[0]"]["activations"] == 1
    assert mb.submit(di, _spec(shard), window_cap=256,
                     record_cap=64).exists is not None
    mb.close()


def test_fault_injector_is_deterministic_and_equal_to_jax():
    plan = {"seed": 42, "rules": [
        {"site": "kernel.launch", "kind": "error", "rate": 0.3}]}

    def pattern(mod):
        inj = mod.install(plan)
        out = []
        for _ in range(50):
            try:
                mod.fault_point("kernel.launch")
                out.append(0)
            except mod.FaultError:
                out.append(1)
        assert inj.stats()["kernel.launch[0]"]["activations"] == sum(out)
        return out

    first = pattern(faults)
    assert 0 < sum(first) < 50
    assert pattern(faults) == first == pattern(jfaults)


def test_fault_rule_after_count_and_match(tmp_path):
    faults.install({"seed": 1, "rules": [{
        "site": "kernel.launch", "kind": "error", "rate": 1.0, "after": 2,
        "count": 2, "match": "w1"}]})
    hits = []
    for _ in range(8):
        try:
            faults.fault_point("kernel.launch", "w1")
            hits.append(0)
        except faults.FaultError:
            hits.append(1)
    assert hits == [0, 0, 1, 1, 0, 0, 0, 0]
    faults.fault_point("kernel.launch", "other")
    plan_file = tmp_path / "plan.json"
    plan_file.write_text('{"seed": 5, "rules": [{"site": "kernel.launch", '
                         '"kind": "latency", "ms": 1.0}]}')
    inj = faults.install_from_env({"BEACON_FAULT_PLAN": f"@{plan_file}"})
    faults.fault_point("kernel.launch")
    assert inj.stats()["kernel.launch[0]"]["hits"] == 1
    faults.uninstall()
    assert faults.install_from_env({}) is None


@pytest.mark.parametrize("microbatch", [True, False])
def test_engine_launch_fault_raises_on_the_request(microbatch):
    recs = random_records(random.Random(3), chrom="1", n=100, n_samples=2)
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(
        use_mesh=False, microbatch=microbatch, response_cache=False)),
        device="cpu")
    try:
        eng.add_index(shard_from_reference(j_build_index(
            recs, dataset_id="ds", vcf_location="v", sample_names=SAMPLES)))
        faults.install({"rules": [{"site": "kernel.launch",
                                   "kind": "error"}]})
        with pytest.raises(faults.FaultError):
            eng.search(VariantQueryPayload(**_doc(["ds"])))
        faults.uninstall()
        assert eng.search(VariantQueryPayload(**_doc(["ds"])))
    finally:
        eng.close()


# -- plan stages, annotations and cost charges against the JAX engine -------------


def _doc(datasets, gran="count", **kw):
    return dict(dataset_ids=list(datasets), reference_name="1", start_min=1,
                start_max=1 << 29, end_min=1, end_max=1 << 30,
                alternate_bases="N", requested_granularity=gran,
                include_datasets="HIT", **kw)


@pytest.fixture
def engines():
    """A JAX engine and a port engine over three datasets, a delta tail
    past the L0 threshold on one, and the fused stacks warm."""
    shards = [j_build_index(
        random_records(random.Random(30 + i), chrom="1", n=150,
                       n_samples=2),
        dataset_id=f"d{i}", vcf_location=f"v{i}", sample_names=SAMPLES)
        for i in range(3)]
    over = dict(use_mesh=False, l0_min_shards=2)
    jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(**over)))
    teng = VariantEngine(BeaconConfig(engine=EngineConfig(**over)),
                         device="cpu")
    try:
        for s in shards:
            jeng.add_index(s)
            teng.add_index(shard_from_reference(s))
        for i in range(3):
            d = j_build_index(
                random_records(random.Random(40 + i), chrom="1", n=30,
                               n_samples=2),
                dataset_id="d0", vcf_location="v0", sample_names=SAMPLES)
            jeng.add_delta(d)
            teng.add_delta(shard_from_reference(d))
        jeng.warmup()
        teng.warmup()
        yield jeng, teng
    finally:
        jeng.close()
        teng.close()


def _traced(jeng, teng, doc):
    jctx = jtel.RequestContext(route="test")
    with jtel.request_context(jctx):
        want = jeng.search(JPayload(**doc))
    tctx = ttel.RequestContext(route="test")
    with ttel.request_context(tctx):
        got = teng.search(VariantQueryPayload(**doc))
    assert ([dataclasses.asdict(r) for r in got]
            == [dataclasses.asdict(r) for r in want])
    return jctx, tctx


def _stages(ctx, single):
    out = []
    for e in ctx.plan:
        e = dict(e)
        if e["stage"] == "batch":
            e.pop("detail")  # batch_ms: a wall time
            if single:
                # one dataset: the JAX engine on the CPU serves it through
                # its fused stack, the port through its scatter index
                e.pop("decision")
        out.append(e)
    return out


@pytest.mark.parametrize("datasets", [["d1", "d2"], [], ["d1"], ["d0"]])
def test_plan_stages_and_annotations_equal_jax(engines, datasets):
    jeng, teng = engines
    single = len(datasets) == 1
    for rep in range(2):  # a miss, then a cache hit
        jctx, tctx = _traced(jeng, teng, _doc(datasets))
        assert _stages(tctx, single) == _stages(jctx, single), rep
        assert tplan.plan_shape(tctx.plan) == j_plan_shape(jctx.plan)
        assert tplan.plan_note(tctx) == j_plan_note(jctx)
        tnotes, jnotes = dict(tctx.notes), dict(jctx.notes)
        for n in (tnotes, jnotes):
            n.pop("batch_ms", None)
            if single:
                n.pop("batch_index", None)
        assert tnotes == jnotes
        assert tctx.cost.cache == jctx.cost.cache
        assert tctx.cost.delta_shards == jctx.cost.delta_shards
    assert tctx.cost.cache == "hit"
    assert tplan.plan_shape(tctx.plan) == "cache=hit"
    assert len(tctx.plan) < tplan.MAX_PLAN_STAGES


def test_batched_request_is_charged_its_wait_and_launch(engines):
    _jeng, teng = engines
    ctx = ttel.RequestContext(route="test")
    with ttel.request_context(ctx):
        teng.search(VariantQueryPayload(**_doc(["d1", "d2"],
                                               no_response_cache=True)))
    snap = ctx.cost.snapshot()
    assert snap["device_us"] > 0 and snap["queue_wait_ms"] >= 0
    assert snap["host_rows"] == 0  # no window overflowed to the host
    reg = ttel.MetricsRegistry()
    teng.register_metrics(reg)
    teng.search(VariantQueryPayload(**_doc(["d2"], no_response_cache=True)))
    hist = reg.render_json()["batcher"]["stage_ms"]
    assert {"batch_wait", "encode", "launch"} <= set(hist)


# -- warmup ---------------------------------------------------------------------------


def _counting(monkeypatch):
    calls = {}
    for mod, name in ((tsk, "scatter_match"), (tsk, "scatter_selected"),
                      (tpk, "plane_stats"), (tk, "bisect_query"),
                      (tm, "stacked_query"), (tm, "stacked_selected")):
        orig = getattr(mod, name)
        calls[name] = []

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name].append(kw.get("family"))
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def test_warmup_launches_every_family_once_per_index(monkeypatch):
    """One launch a kernel family and index: the scatter match per
    shard, the fused match + planes and the plane stats per shard with
    device planes, the bisection query on the fused stack and on the L0
    index, the stacked query (and the stacked selected kernel: the stack
    has planes) on the mesh stack."""
    shards = [
        j_build_index(random_records(random.Random(50 + i), chrom="1",
                                     n=120, n_samples=2),
                      dataset_id=f"d{i}", vcf_location=f"v{i}",
                      sample_names=SAMPLES)
        for i in range(2)
    ]
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(
        l0_min_shards=2, plane_hbm_budget_gb=1.0)), device="cpu")
    monkeypatch.setattr(tm, "mesh_devices", lambda device: [CPU] * 2)
    try:
        for s in shards:
            eng.add_index(shard_from_reference(s))
        for i in range(2):
            eng.add_delta(shard_from_reference(j_build_index(
                random_records(random.Random(60 + i), chrom="1", n=20,
                               n_samples=2),
                dataset_id="d0", vcf_location="v0", sample_names=SAMPLES)))
        assert eng.l0_status()["built"]
        calls = _counting(monkeypatch)
        n = eng.warmup()
        assert len(calls["scatter_match"]) == 2
        assert len(calls["scatter_selected"]) == 2
        assert len(calls["plane_stats"]) == 2
        assert calls["bisect_query"] == ["fused", "fused_l0"]
        assert len(calls["stacked_query"]) == 2  # one per mesh entry
        assert len(calls["stacked_selected"]) == 2
        assert n == 2 * 3 + 2 + 2
    finally:
        eng.close()


def test_warmup_phase_marks_only_its_own_threads_launches():
    """A warm launch made while traffic is served (an L0 rebuild's warm
    launch, on the publishing thread) marks that launch alone: serving
    launches on other threads meanwhile stay serving launches."""
    inside, leave = threading.Event(), threading.Event()

    def warm():
        with ttel.device_warmup_phase():
            ttel.record_device_launch("probe_kernel", family="warm")
            inside.set()
            leave.wait(5)

    ttel.reset_launch_counts()
    t = threading.Thread(target=warm)
    t.start()
    try:
        assert inside.wait(5)
        ttel.record_device_launch("probe_kernel", family="serve")
    finally:
        leave.set()
        t.join()
    recs = {r["family"]: r for r in ttel.recent_launches()
            if r["kernel"] == "probe_kernel"}
    assert recs["warm"].get("warmup") is True
    assert "warmup" not in recs["serve"]
    ttel.reset_launch_counts()


def test_plan_registries_equal_the_stages_the_sources_record():
    """Every ``plan_stage`` call in the package names a registered stage
    and reason, and every registered one is recorded somewhere: an
    unregistered stage is an invisible decision, an unused one drift."""
    import ast
    import pathlib

    root = pathlib.Path(tplan.__file__).parent
    stages, reasons = set(), set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "plan_stage"):
                continue
            assert isinstance(node.args[0], ast.Constant), path
            stages.add(node.args[0].value)
            for kw in node.keywords:
                if kw.arg == "reason":
                    if isinstance(kw.value, ast.Constant):
                        reasons.add(kw.value.value)
                    else:  # the mesh tier's stale/unbuilt refusal
                        reasons |= {"stale", "unbuilt"}
    assert stages == set(tplan.PLAN_STAGES)
    assert reasons == set(tplan.PLAN_REASONS)
