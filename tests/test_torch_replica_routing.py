"""Replica-aware routing of the port's fleet plane.

Twins of the tests of ``tests/test_replica_routing.py`` on the port's
``DistributedEngine``, ``ReplicaRouter`` and ``WorkerServer``: replica
grouping by fingerprint (identical copies, divergent copies, legacy
engine-wide strings, tail-superset chains), last-known-good route
retention, power-of-two-choices routing and its seeded ``rng``, the
adaptive hedge delay and the brownout kill switch, failover, replica
hedging, partial results through the app (``meta.unavailableDatasets``
and ``/ready``'s ``degradedDatasets`` with JAX's schema), the
rediscovery loop, and retire pins. Hedging and failover cases run on
injected ``post=``/``get=`` callables and events. The chaos soak's twin
is ``slow``, as JAX's is.
"""

import dataclasses
import http.client
import json
import random
import re
import threading
import time

import pytest

from sbeacon_tpu_torch.config import (
    BeaconConfig,
    EngineConfig,
    IngestConfig,
    ObservabilityConfig,
    ResilienceConfig,
    StorageConfig,
    TransportConfig,
)
from sbeacon_tpu_torch.harness import faults
from sbeacon_tpu_torch.parallel import dispatch as tdispatch
from sbeacon_tpu_torch.parallel.dispatch import (
    DistributedEngine,
    ReplicaRouter,
    WorkerServer,
    _fingerprint_freshness,
    _fingerprint_parts,
)
from sbeacon_tpu_torch.parallel.transport import _STATS
from sbeacon_tpu_torch.resilience import CircuitBreaker
from sbeacon_tpu.testing import random_records
from torch_fleet_corpus import (
    Fleet,
    dumps,
    jax_engine,
    payload,
    port_engine,
    shard,
)
from torch_ingest_corpus import no_thread_leak  # noqa: F401

resilience = pytest.mark.resilience


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()


@pytest.fixture()
def fleet():
    f = Fleet()
    try:
        yield f
    finally:
        f.close()


def _records(seed=5, n=200):
    return random_records(random.Random(seed), chrom="21", n=n, n_samples=2)


def _shard(recs, ds="rz"):
    return shard(ds, 0, recs=recs, vcf=f"synthetic://{ds}")


def _payload(ds_list, granularity="count", include="HIT"):
    return payload(ds_list, chrom="21", granularity=granularity,
                   include=include)


@pytest.fixture()
def replica_pair(fleet):
    """Two port workers serving IDENTICAL copies of dataset rz (true
    replicas — same records, same fingerprint)."""
    recs = _records()
    w1 = fleet.worker(port_engine([_shard(recs)]))
    w2 = fleet.worker(port_engine([_shard(recs)]))
    return recs, w1, w2


def _answer(ds, exists=False):
    return {"responses": [{"dataset_id": ds, "vcf_location": "v",
                           "exists": exists}]}


# -- discovery: replica grouping ----------------------------------------------


@resilience
def test_discovery_keeps_full_replica_list(replica_pair, fleet):
    _, w1, w2 = replica_pair
    dist = fleet.coordinator([w1.address, w2.address])
    table = dist.replica_table()
    assert set(table["rz"]) == {w1.address, w2.address}
    assert dist.dispatch_stats()["replicas"] == 2
    # the primary view still resolves one url per dataset
    assert dist.routes()["rz"] in table["rz"]


@resilience
def test_divergent_fingerprints_are_not_replicas(caplog, fleet):
    """Two workers advertising the same dataset with DIFFERENT
    fingerprints are not grouped: route to the newer (larger) copy and
    warn."""

    def get(url, timeout_s, headers=None):
        if "old" in url:
            return 200, {"datasets": ["ds"], "fingerprint": "f-old",
                         "dataset_fingerprints": {"ds": "v.vcf|10|20|100"}}
        return 200, {"datasets": ["ds"], "fingerprint": "f-new",
                     "dataset_fingerprints": {"ds": "v.vcf|25|50|250"}}

    def post(url, doc, timeout_s, headers=None):
        return 200, {"responses": []}

    dist = fleet.coordinator(["http://old:1", "http://new:1"], retries=0,
                             post=post, get=get)
    with caplog.at_level("WARNING"):
        table = dist.replica_table()
    assert table["ds"] == ("http://new:1",)
    assert any("divergent index copies" in r.message
               for r in caplog.records)


@resilience
def test_empty_discovery_keeps_last_known_good_routes(caplog, fleet):
    """An all-workers-unreachable pass does NOT publish an empty table
    over a known-good one."""
    reachable = [True]

    def get(url, timeout_s, headers=None):
        if not reachable[0]:
            raise OSError("injected: unreachable")
        return 200, {"datasets": ["ds"], "fingerprint": "f"}

    def post(url, doc, timeout_s, headers=None):
        return 200, {"responses": []}

    dist = fleet.coordinator(["http://w1:1"], retries=0, post=post, get=get)
    assert dist.replica_table()["ds"] == ("http://w1:1",)
    reachable[0] = False
    with caplog.at_level("WARNING"):
        table = dist.replica_table(refresh=True)
    assert table["ds"] == ("http://w1:1",)
    assert dist.datasets() == ["ds"]
    assert any("last-known-good" in r.message for r in caplog.records)
    reachable[0] = True
    assert dist.replica_table(refresh=True)["ds"] == ("http://w1:1",)


@resilience
def test_partial_discovery_keeps_dead_workers_datasets(caplog, fleet):
    """A pass reaching only SOME workers keeps the others' datasets, so
    their queries degrade to MARKED partial results."""
    dead = [False]

    def get(url, timeout_s, headers=None):
        if "w2" in url and dead[0]:
            raise OSError("injected: unreachable")
        ds = "dsA" if "w1" in url else "dsB"
        return 200, {"datasets": [ds], "fingerprint": ds,
                     "dataset_fingerprints": {ds: "v|1|1|10"}}

    def post(url, doc, timeout_s, headers=None):
        if "w2" in url and dead[0]:
            raise OSError("injected: down")
        return 200, {"responses": []}

    dist = fleet.coordinator(["http://w1:1", "http://w2:1"], retries=0,
                             post=post, get=get)
    assert set(dist.replica_table()) == {"dsA", "dsB"}
    dead[0] = True
    with caplog.at_level("WARNING"):
        table = dist.replica_table(refresh=True)
    assert table["dsB"] == ("http://w2:1",)  # retained
    assert table["dsA"] == ("http://w1:1",)
    assert any("last-known-good" in r.message for r in caplog.records)
    assert dist.search(_payload(["dsB"])) == []
    assert dist.dispatch_stats()["partial_responses"] == 1


@resilience
def test_legacy_engine_wide_fingerprint_loses_to_per_dataset(fleet):
    from sbeacon_tpu.parallel.dispatch import (
        _fingerprint_freshness as j_freshness,
    )

    for fp, want in (("v.vcf|10|20|100", 100), ("a|1|2|30&b|4|5|60", 90),
                     ("ds1|v|1|2|1000&ds2|v|3|4|5000", -1),
                     ("garbage", -1), ("v|1|2|30&v#d1|5", 35)):
        assert _fingerprint_freshness(fp) == j_freshness(fp) == want, fp

    def get(url, timeout_s, headers=None):
        if "legacy" in url:
            return 200, {"datasets": ["ds1"],
                         "fingerprint": "ds1|v|1|2|1000&ds2|v|3|4|5000"}
        return 200, {"datasets": ["ds1"], "fingerprint": "f",
                     "dataset_fingerprints": {"ds1": "v|1|2|1000"}}

    def post(url, doc, timeout_s, headers=None):
        return 200, {"responses": []}

    dist = fleet.coordinator(["http://legacy:1", "http://new:1"],
                             retries=0, post=post, get=get)
    assert dist.replica_table()["ds1"] == ("http://new:1",)


# -- the router ----------------------------------------------------------------


@resilience
def test_power_of_two_choices_prefers_faster_replica():
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=30.0)
    router = ReplicaRouter(br)
    router.publish({"ds": ("http://fast:1", "http://slow:1")})
    for _ in range(10):
        router.note_rtt("http://fast:1", 0.002)
        router.note_rtt("http://slow:1", 0.250)
    assert all(router.pick("ds") == "http://fast:1" for _ in range(20))
    assert router.pick("ds", avoid={"http://fast:1"}) == "http://slow:1"
    assert router.pick("ds", avoid={"http://fast:1",
                                    "http://slow:1"}) is None


@resilience
def test_routing_spread_comes_from_the_rng_passed_in():
    """Two routers over the same table and the same seeded rng pick the
    same replicas in the same order; the draws are the rng's."""
    urls = tuple(f"http://w{i}:1" for i in range(5))
    picks = []
    for _ in range(2):
        router = ReplicaRouter(CircuitBreaker(), rng=random.Random(7))
        router.publish({"ds": urls})
        picks.append([router.pick("ds") for _ in range(32)])
    assert picks[0] == picks[1]
    assert len(set(picks[0])) > 1  # unmeasured replicas all get explored
    rng = random.Random(7)
    want = []
    for _ in range(32):
        a, b = rng.sample(list(urls), 2)
        want.append(a)  # equal (unmeasured) RTTs: the first draw wins
    assert picks[0] == want


@resilience
def test_router_skips_breaker_open_routes():
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=30.0)
    router = ReplicaRouter(br)
    router.publish({"ds": ("http://a:1", "http://b:1")})
    router.note_rtt("http://a:1", 0.001)  # a would win on RTT...
    br.record_failure("http://a:1")  # ...but its circuit is open
    assert all(router.pick("ds") == "http://b:1" for _ in range(20))
    # every copy open: route anyway (the call-site gate fast-fails and
    # keeps half-open probing alive)
    br.record_failure("http://b:1")
    assert router.pick("ds") in ("http://a:1", "http://b:1")


@resilience
def test_adaptive_hedge_delay_semantics():
    router = ReplicaRouter(CircuitBreaker())
    assert router.hedge_delay(-1.0) is None  # off
    assert router.hedge_delay(0.3) == 0.3  # fixed
    assert router.hedge_delay(0.0) is None  # adaptive, no samples yet
    for _ in range(router.HEDGE_MIN_SAMPLES):
        router.note_rtt("http://w:1", 0.2)
    assert router.hedge_delay(0.0) == pytest.approx(0.2)
    router2 = ReplicaRouter(CircuitBreaker())
    for _ in range(router2.HEDGE_MIN_SAMPLES):
        router2.note_rtt("http://w:1", 0.0001)
    assert router2.hedge_delay(0.0) == router2.HEDGE_FLOOR_S
    # the brownout ladder's first rung turns every hedge off
    tdispatch.set_hedging_enabled(False)
    try:
        assert tdispatch.hedging_enabled() is False
        assert router.hedge_delay(0.3) is None
        assert router.hedge_delay(0.0) is None
    finally:
        tdispatch.set_hedging_enabled(True)
    assert router.hedge_delay(0.3) == 0.3


# -- failover -----------------------------------------------------------------


@resilience
def test_failover_to_replica_when_primary_dies(replica_pair, fleet):
    """Kill the primary through the seeded worker.http fault plan: the
    query answers from the surviving replica and ticks
    dispatch.failovers."""
    _recs, w1, w2 = replica_pair
    dist = fleet.coordinator([w1.address, w2.address], retries=0)
    ref = dist.search(_payload(["rz"]))
    assert ref and all(r.dataset_id == "rz" for r in ref)
    for _ in range(10):  # steer the p2c pick to w1, then kill w1
        dist.router.note_rtt(w1.address, 0.001)
        dist.router.note_rtt(w2.address, 0.500)
    faults.install({"seed": 7, "rules": [
        {"site": "worker.http", "kind": "error", "rate": 1.0,
         "match": w1.address}]})
    got = dist.search(_payload(["rz"]))
    assert dumps(got) == dumps(ref)
    stats = dist.dispatch_stats()
    assert stats["failovers"] >= 1 and stats["partial_responses"] == 0
    assert dist.breaker.metrics()[w1.address]["consecutive_failures"] >= 1


@resilience
def test_failover_never_retries_the_same_replica(fleet):
    """With every replica down and failover retries to spare, each url
    is tried exactly once and the dataset degrades to partial."""
    calls: list[str] = []

    def post(url, doc, timeout_s, headers=None):
        calls.append(url)
        raise OSError("injected: down")

    def get(url, timeout_s, headers=None):
        return 200, {"datasets": ["ds"], "fingerprint": "f"}

    dist = fleet.coordinator(
        ["http://a:1", "http://b:1", "http://c:1"], retries=0, post=post,
        get=get,
        config=BeaconConfig(resilience=ResilienceConfig(failover_retries=5)),
    )
    assert dist.search(_payload(["ds"])) == []  # partial
    assert sorted(calls) == ["http://a:1/search", "http://b:1/search",
                             "http://c:1/search"]
    assert dist.dispatch_stats()["partial_responses"] == 1
    assert dist.dispatch_stats()["failovers"] == 2


@resilience
def test_replica_hedge_races_slow_primary(fleet):
    """A primary that has not answered within the hedge delay is raced
    by the other replica, whose answer wins; the primary is held until
    the hedge has answered."""
    hedge_answered = threading.Event()

    def post(url, doc, timeout_s, headers=None):
        if "slow" in url:
            hedge_answered.wait(30)
            return 200, {"responses": [{"dataset_id": "ds",
                                        "vcf_location": "slow"}]}
        hedge_answered.set()
        return 200, {"responses": [{"dataset_id": "ds",
                                    "vcf_location": "fast",
                                    "exists": True}]}

    def get(url, timeout_s, headers=None):
        return 200, {"datasets": ["ds"], "fingerprint": "f"}

    dist = fleet.coordinator(
        ["http://slow:1", "http://fast:1"], retries=0, post=post, get=get,
        config=BeaconConfig(transport=TransportConfig(
            hedge_delay_s=0.01, replica_hedge=True)),
    )
    dist.replica_table()
    for _ in range(10):  # steer the p2c pick to the slow primary
        dist.router.note_rtt("http://slow:1", 0.001)
        dist.router.note_rtt("http://fast:1", 0.400)
    hedges0 = _STATS.get("hedges")
    got = dist.search(_payload(["ds"]))
    assert [(r.dataset_id, r.vcf_location) for r in got] == [("ds", "fast")]
    assert _STATS.get("hedges") == hedges0 + 1


@resilience
def test_replica_hedge_config_off_keeps_single_leg(fleet):
    """replica_hedge off: a primary slower than the hedge delay is never
    raced (it answers once its bounded hold lapses)."""
    calls: list[str] = []
    never = threading.Event()

    def post(url, doc, timeout_s, headers=None):
        calls.append(url)
        never.wait(0.2)  # held well past the 5 ms hedge delay
        return 200, {"responses": []}

    def get(url, timeout_s, headers=None):
        return 200, {"datasets": ["ds"], "fingerprint": "f"}

    dist = fleet.coordinator(
        ["http://a:1", "http://b:1"], retries=0, post=post, get=get,
        config=BeaconConfig(transport=TransportConfig(
            hedge_delay_s=0.005, replica_hedge=False)),
    )
    dist.search(_payload(["ds"]))
    assert len(calls) == 1  # no second leg fired


# -- partial results ----------------------------------------------------------


def _coordinator_app(fleet, worker_urls, tmp_path, *, jax=False,
                     **res_over):
    if jax:
        from sbeacon_tpu.api import BeaconApp as App
        from sbeacon_tpu.config import BeaconConfig as Cfg
        from sbeacon_tpu.config import EngineConfig as Eng
        from sbeacon_tpu.config import ResilienceConfig as Res
        from sbeacon_tpu.config import StorageConfig as Sto
        from sbeacon_tpu.engine import VariantEngine as Engine

        cfg = Cfg(storage=Sto(root=tmp_path / "jcoord"),
                  engine=Eng(use_mesh=False, microbatch=False,
                             mesh_dispatch=False),
                  resilience=Res(**res_over))
        local = fleet.own(Engine(cfg))
    else:
        App = None
        cfg = BeaconConfig(
            storage=StorageConfig(root=tmp_path / "coord"),
            engine=EngineConfig(use_mesh=False, microbatch=False),
            resilience=ResilienceConfig(**res_over),
            ingest=IngestConfig(compact_interval_s=0),
            observability=ObservabilityConfig(canary_enabled=False),
        )
        local = fleet.own(port_engine([], use_mesh=False))
    cfg.storage.ensure()
    dist = fleet.coordinator(worker_urls, local=local, config=cfg,
                             retries=0, timeout_s=10.0, jax=jax)
    if App is None:
        from sbeacon_tpu_torch.api import BeaconApp as App
    app = App(cfg, engine=dist)
    app.store.upsert("datasets", [{
        "id": "rz", "name": "rz", "_assemblyId": "GRCh38",
        "_vcfLocations": ["synthetic://rz"]}])
    return app, dist


def _close_app(app) -> None:
    app.close()
    app.store.close()
    app.ontology.close()


def _hit_alt(rec):
    """A plain-base alt carried by some sample (ac > 0), or None."""
    for a, ac in zip(rec.alts, rec.effective_ac()):
        if re.fullmatch(r"[ACGTN]+", a) and ac > 0:
            return a
    return None


def _queryable(recs):
    return [r for r in recs if _hit_alt(r)]


def _gv_query(rec):
    return {"query": {
        "requestedGranularity": "boolean",
        "requestParameters": {
            "assemblyId": "GRCh38", "referenceName": "21",
            "start": [max(0, rec.pos - 1)],
            "end": [rec.pos + len(rec.ref) + 5],
            "alternateBases": _hit_alt(rec)}}}


@resilience
def test_partial_results_envelope_names_dead_dataset(tmp_path, fleet):
    """Every replica of a dataset down: the app answers 200 with the
    dataset in meta.unavailableDatasets and a warning, /ready lists it
    as degraded, dispatch.partial_responses ticks — the JAX app's
    envelope and /ready schema, field for field."""
    recs = _records()
    q = _queryable(recs)
    out = {}
    for jax in (False, True):
        make = jax_engine if jax else port_engine
        worker = fleet.worker(make([_shard(recs)]), jax=jax)
        app, dist = _coordinator_app(fleet, [worker.address], tmp_path,
                                     jax=jax, breaker_failure_threshold=1)
        try:
            status, body = app.handle("POST", "/g_variants",
                                      body=_gv_query(q[0]))
            assert status == 200 and body["responseSummary"]["exists"]
            worker.shutdown()  # the dataset's ONLY replica is gone
            status, body = app.handle("POST", "/g_variants",
                                      body=_gv_query(q[1]))
            assert status == 200, body
            _, ready = app.handle("GET", "/ready")
            _, metrics = app.handle("GET", "/metrics")
            out[jax] = (body, ready, metrics)
        finally:
            _close_app(app)
    (body, ready, metrics), (jbody, jready, jmetrics) = out[False], out[True]
    assert body["meta"]["unavailableDatasets"] == ["rz"]
    assert any("rz" in w for w in body["meta"]["warnings"])
    assert body["responseSummary"]["exists"] is False
    for k in ("unavailableDatasets", "warnings"):
        assert body["meta"][k] == jbody["meta"][k], k
    assert body["responseSummary"] == jbody["responseSummary"]
    assert ready["ready"] is True and ready["degradedDatasets"] == ["rz"]
    assert set(ready) == set(jready)
    assert ready["degradedDatasets"] == jready["degradedDatasets"]
    assert metrics["dispatch"]["partial_responses"] >= 1
    assert metrics["routing"]["replicas"] >= 1
    for k in ("dispatch", "routing"):
        assert set(metrics[k]) <= set(jmetrics[k]), k


@resilience
def test_partial_results_off_preserves_error_semantics(tmp_path, fleet):
    recs = _records()
    q = _queryable(recs)
    worker = fleet.worker(port_engine([_shard(recs)]))
    app, _dist = _coordinator_app(fleet, [worker.address], tmp_path,
                                  partial_results=False)
    try:
        assert app.handle("POST", "/g_variants", body=_gv_query(q[0]))[0] \
            == 200
        worker.shutdown()
        status, body = app.handle("POST", "/g_variants",
                                  body=_gv_query(q[1]))
        assert status >= 500  # strict mode: the failure surfaces
        assert "error" in body
    finally:
        _close_app(app)


@resilience
def test_partial_result_is_not_cached_past_heal(tmp_path, fleet):
    """A degraded answer is not served from the job table's cache after
    the worker returns: the same query heals to the real answer once
    rediscovery republishes the route."""
    recs = _records()
    q = _queryable(recs)
    worker = fleet.worker(port_engine([_shard(recs)]))
    host, port = worker.server.server_address[:2]
    app, dist = _coordinator_app(fleet, [worker.address], tmp_path)
    dist.REDISCOVERY_INTERVAL_S = 0.1
    app.query_runner.PARTIAL_HANDOFF_TTL_S = 0.1
    try:
        status, body = app.handle("POST", "/g_variants",
                                  body=_gv_query(q[0]))
        assert status == 200 and body["responseSummary"]["exists"] is True
        worker.shutdown()
        status, body = app.handle("POST", "/g_variants",
                                  body=_gv_query(q[1]))
        assert status == 200
        assert body["meta"]["unavailableDatasets"] == ["rz"]
        assert body["responseSummary"]["exists"] is False
        # the replica returns at the same address
        fleet.worker(port_engine([_shard(recs)]), host=host, port=port)
        t_end = time.time() + 10
        healed = None
        while time.time() < t_end:
            status, body = app.handle("POST", "/g_variants",
                                      body=_gv_query(q[1]))
            if (status == 200 and "unavailableDatasets" not in body["meta"]
                    and body["responseSummary"]["exists"] is True):
                healed = body
                break
            time.sleep(0.2)
        assert healed is not None, body
    finally:
        _close_app(app)


@resilience
def test_partial_marking_rides_cached_handoff():
    """A coalesced waiter receives the partial marking too, and the
    degraded job is never completed into the TTL cache."""
    from sbeacon_tpu_torch.query_jobs import (
        AsyncQueryRunner,
        JobStatus,
        QueryJobTable,
    )
    from sbeacon_tpu_torch.telemetry import (
        RequestContext,
        annotate,
        request_context,
    )

    class PartialEngine:
        def __init__(self):
            self.config = BeaconConfig()

        def index_fingerprint(self):
            return "fp"

        def search(self, p):
            annotate(unavailable_datasets=("rz",))
            return []

    table = QueryJobTable(":memory:")
    runner = AsyncQueryRunner(PartialEngine(), table)
    try:
        ctx_a = RequestContext(route="a")
        with request_context(ctx_a):
            qid, _ = runner.submit(_payload(["rz"]))
            assert runner.result(qid, wait_s=5.0) == []
        assert ctx_a.notes.get("unavailable_datasets") == ("rz",)
        ctx_b = RequestContext(route="b")
        with request_context(ctx_b):
            assert runner.result(qid) == []
        assert ctx_b.notes.get("unavailable_datasets") == ("rz",)
        assert runner.poll(qid) is not JobStatus.COMPLETED
    finally:
        runner.close()
        table.close()


@resilience
def test_discovery_answer_does_not_reset_closed_breaker(fleet):
    """/datasets answering does not reset a CLOSED circuit's failure
    count, while an OPEN route IS revived by an answering discovery."""

    def get(url, timeout_s, headers=None):
        return 200, {"datasets": ["ds"], "fingerprint": "f"}

    def post(url, doc, timeout_s, headers=None):
        raise OSError("injected: search broken")

    dist = fleet.coordinator(
        ["http://w:1"], retries=0, post=post, get=get,
        config=BeaconConfig(
            resilience=ResilienceConfig(breaker_failure_threshold=3)),
    )
    for _ in range(2):
        assert dist.search(_payload(["ds"])) == []  # partial
        dist.replica_table(refresh=True)  # must NOT reset the count
    assert dist.search(_payload(["ds"])) == []  # third strike
    assert dist.breaker.state("http://w:1") == "open"
    dist.replica_table(refresh=True)  # reachable: the OPEN route revives
    assert dist.breaker.state("http://w:1") == "closed"


# -- rediscovery --------------------------------------------------------------


@resilience
def test_rediscovery_heals_routes_without_manual_reload(replica_pair,
                                                        fleet):
    """A worker failure arms the rediscovery loop; once the worker
    answers /datasets again the breaker-open route revives, and the loop
    exits once every worker answered."""
    _recs, w1, w2 = replica_pair
    dist = fleet.coordinator([w1.address, w2.address], retries=0)
    dist.REDISCOVERY_INTERVAL_S = 0.05
    dist.search(_payload(["rz"]))
    for _ in range(10):
        dist.breaker.record_failure(w1.address)
    assert dist.breaker.state(w1.address) == "open"
    assert dist.unavailable_datasets() == []  # w2 still live
    dist._nudge_rediscovery()
    loop = dist._rediscover_thread
    loop.join(10)
    assert not loop.is_alive()
    assert dist.breaker.state(w1.address) == "closed"
    assert dist.dispatch_stats()["rediscoveries"] >= 1


# -- the chaos soak: kill-and-restart under a 2-replica topology --------------


@pytest.mark.slow
def test_chaos_soak_kill_and_restart_replica_zero_5xx(tmp_path, fleet):
    """2-replica topology, one worker killed mid-run and restarted:
    boolean and record queries keep succeeding with ZERO 5xx."""
    from sbeacon_tpu_torch.api.server import start_background

    recs = _records(n=300)
    w1 = fleet.worker(port_engine([_shard(recs)]))
    w1_host, w1_port = w1.server.server_address[:2]
    w2 = fleet.worker(port_engine([_shard(recs)]))
    qrecs = _queryable(recs)
    app, dist = _coordinator_app(fleet, [w1.address, w2.address], tmp_path)
    dist.REDISCOVERY_INTERVAL_S = 0.2
    server = None
    try:
        assert app.handle("POST", "/g_variants",
                          body=_gv_query(qrecs[0]))[0] == 200
        server, _t = start_background(app)
        port = server.server_address[1]
        n_clients, per_client = 16, 8
        statuses: list[int] = []
        bad: list = []
        lock = threading.Lock()
        start = threading.Barrier(n_clients + 1)

        def client(k: int):
            rng = random.Random(500 + k)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            start.wait()
            for i in range(per_client):
                q = _gv_query(qrecs[rng.randrange(len(qrecs))])
                if i % 2:
                    q["query"]["requestedGranularity"] = "record"
                conn.request("POST", "/g_variants",
                             body=json.dumps(q).encode(),
                             headers={"Content-Type": "application/json",
                                      "X-Beacon-Deadline": "10"})
                r = conn.getresponse()
                doc = json.loads(r.read())
                with lock:
                    statuses.append(r.status)
                    if r.status >= 500:
                        bad.append((r.status, doc))
            conn.close()

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        for t in threads:
            t.start()
        start.wait()
        w1.shutdown()
        for _ in range(10):  # steer p2c at the dead replica
            dist.router.note_rtt(w1.address, 0.0001)
            dist.router.note_rtt(w2.address, 0.5)
        probe = dist.search(_payload(["rz"]))
        assert [r.dataset_id for r in probe] == ["rz"]
        w1b = fleet.worker(port_engine([_shard(recs)]), host=w1_host,
                           port=w1_port)
        for t in threads:
            t.join(120)
            assert not t.is_alive(), "client thread hung"
        assert len(statuses) == n_clients * per_client
        assert not bad, bad[:3]
        stats = dist.dispatch_stats()
        assert stats["failovers"] + stats["rediscoveries"] >= 1, stats
        t_end = time.time() + 10
        while time.time() < t_end and not all(
                dist.breaker.state(u) == "closed"
                for u in (w1b.address, w2.address)):
            time.sleep(0.2)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        _close_app(app)


# -- tail-superset relation & retire pins --------------------------------------


@resilience
def test_tail_superset_copies_stay_routable(fleet):
    """A replica whose delta tail is a SUBSET of another's (same base)
    is a valid, slightly stale copy: both stay routable, deepest tail
    first, and the primary's answer carries the tail rows."""
    recs = _records()
    extra = _records(seed=11, n=30)
    w_deep = fleet.worker(port_engine([_shard(recs)], [_shard(extra)]))
    w_shal = fleet.worker(port_engine([_shard(recs)]))
    dist = fleet.coordinator([w_shal.address, w_deep.address])
    table = dist.replica_table()
    assert set(table["rz"]) == {w_deep.address, w_shal.address}
    assert table["rz"][0] == w_deep.address
    assert dist.routes()["rz"] == w_deep.address
    oracle = fleet.own(port_engine([_shard(recs)], [_shard(extra)]))
    p = _payload(["rz"])
    want = sorted(r.dumps() for r in oracle.search(p))
    got = sorted(r.dumps() for r in dist.call_replica(dist.routes()["rz"],
                                                      p))
    assert got == want


@resilience
def test_tail_superset_chain_orders_deepest_first(fleet):
    from sbeacon_tpu.parallel.dispatch import _fingerprint_parts as j_parts

    for fp in ("v|1|2|30&v#d1|5", "garbage", "v|1|2|30"):
        assert _fingerprint_parts(fp) == j_parts(fp), fp
    assert _fingerprint_parts("v|1|2|30&v#d1|5") == (
        frozenset({"v|1|2|30"}), frozenset({"v#d1|5"}))
    fps = {
        "http://w0:1": "v|1|2|100",
        "http://w1:1": "v|1|2|100&v#d1|5",
        "http://w2:1": "v|1|2|100&v#d1|5&v#d2|7",
    }

    def get(url, timeout_s, headers=None):
        return 200, {"datasets": ["ds"], "fingerprint": "x",
                     "dataset_fingerprints": {
                         "ds": fps[url.rsplit("/", 1)[0]]}}

    def post(url, doc, timeout_s, headers=None):
        return 200, {"responses": []}

    dist = fleet.coordinator(sorted(fps), retries=0, post=post, get=get)
    table = dist.replica_table()["ds"]
    assert set(table) == set(fps) and table[0] == "http://w2:1"


@resilience
def test_tail_superset_requires_matching_base(fleet):
    def get(url, timeout_s, headers=None):
        if "deep" in url:
            return 200, {"datasets": ["ds"], "fingerprint": "f1",
                         "dataset_fingerprints": {"ds": "v|1|2|100&v#d1|5"}}
        return 200, {"datasets": ["ds"], "fingerprint": "f2",
                     "dataset_fingerprints": {"ds": "w|1|2|90&w#d1|5"}}

    def post(url, doc, timeout_s, headers=None):
        return 200, {"responses": []}

    dist = fleet.coordinator(["http://deep:1", "http://othr:1"], retries=0,
                             post=post, get=get)
    assert dist.replica_table()["ds"] == ("http://deep:1",)


@resilience
def test_breaker_open_replica_readmitted_after_discovery(replica_pair,
                                                         fleet):
    _, w1, w2 = replica_pair
    dist = fleet.coordinator([w1.address, w2.address])
    dist.replica_table()
    for _ in range(10):
        dist.breaker.record_failure(w2.address)
    assert not dist.router.live(w2.address)
    assert all(dist.router.pick("rz") == w1.address for _ in range(20))
    dist.replica_table(refresh=True)
    assert dist.router.live(w2.address)
    assert w2.address in {dist.router.pick("rz") for _ in range(50)}


@resilience
def test_retired_route_survives_republish(replica_pair, fleet):
    _, w1, w2 = replica_pair
    dist = fleet.coordinator([w1.address, w2.address])
    assert len(dist.replica_table()["rz"]) == 2
    dist.router.retire("rz", w2.address)
    assert dist.router.table()["rz"] == (w1.address,)
    assert dist.replica_table(refresh=True)["rz"] == (w1.address,)
    assert ("rz", w2.address) in dist.router.retired()
    dist.router.unretire("rz", w2.address)
    assert set(dist.replica_table(refresh=True)["rz"]) == {w1.address,
                                                           w2.address}


@resilience
def test_add_and_remove_worker_republish_routes(replica_pair, fleet):
    _, w1, w2 = replica_pair
    dist = fleet.coordinator([w1.address])
    assert dist.replica_table()["rz"] == (w1.address,)
    assert dist.add_worker(w2.address) is True
    assert dist.add_worker(w2.address) is False
    assert set(dist.router.table()["rz"]) == {w1.address, w2.address}
    assert dist.remove_worker(w1.address) is True
    assert dist.router.table()["rz"] == (w2.address,)
    assert dist.inflight(w2.address) == 0
    assert WorkerServer is tdispatch.WorkerServer
    assert isinstance(dist, DistributedEngine)
    got = dist.search(dataclasses.replace(_payload(["rz"])))
    assert [r.dataset_id for r in got] == ["rz"]
