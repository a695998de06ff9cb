"""The port's fleet observability: the worker digest, ``/fleet/status``
and the fleet canary, against the JAX package's.

Twins of the digest, ``/fleet/status`` and fleet canary cases of
``tests/test_fleet.py``. The digest's keys and its values over the same
shards equal the JAX worker's (``time`` and the device recorder's
fields excepted: the port's CPU twins launch nothing); the status
document's schema equals the JAX coordinator's, for a single-host app
and for a fan-out one; the canary probes every replica and names a
silently stale one.
"""

import random

import pytest

from sbeacon_tpu_torch.api import BeaconApp
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    EngineConfig,
    IngestConfig,
    ObservabilityConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.parallel.dispatch import ops_digest
from sbeacon_tpu_torch.parallel.transport import urllib_get
from sbeacon_tpu_torch.telemetry import journal
from sbeacon_tpu.testing import random_records
from torch_fleet_corpus import Fleet, jax_engine, port_engine, shard
from torch_ingest_corpus import no_thread_leak  # noqa: F401

obs = pytest.mark.obs

#: golden key set of the worker /ops/digest document (the JAX test's)
DIGEST_KEYS = {
    "time", "datasets", "datasetsTotal", "baseFingerprint",
    "datasetFingerprints", "deltaTails", "deltaPublishes", "openBreakers",
    "midRequestCompiles", "worstPadWaste",
}
#: the digest fields that hold the same values over the same shards
SAME_VALUES = ("datasets", "datasetsTotal", "baseFingerprint",
               "datasetFingerprints", "deltaTails", "deltaPublishes",
               "openBreakers")
#: golden key sets of the single-host /fleet/status document
FLEET_KEYS = {"intervalS", "polls", "lastPollAgeS", "workers", "diagnosis",
              "local"}
DIAGNOSIS_KEYS = {"stalestReplica", "hottestWorker", "divergentDatasets",
                  "unreachableWorkers", "worstCompilingReplica"}


@pytest.fixture()
def fleet():
    f = Fleet()
    try:
        yield f
    finally:
        f.close()


def _records(seed, n):
    return random_records(random.Random(seed), chrom="1", n=n, n_samples=2)


def _pair(fleet, ds, recs, delta_recs=None):
    """(port engine, JAX engine) over the same base and delta shards."""
    base = [shard(ds, 0, recs=recs)]
    deltas = [shard(ds, 0, recs=delta_recs)] if delta_recs else []
    return (fleet.own(port_engine(base, deltas)),
            fleet.own(jax_engine(base, deltas)))


def _coordinator_app(fleet, tmp_path, worker_urls, local, *, jax=False):
    if jax:
        from sbeacon_tpu.api import BeaconApp as JApp
        from sbeacon_tpu.config import BeaconConfig as JCfg
        from sbeacon_tpu.config import EngineConfig as JEng
        from sbeacon_tpu.config import ObservabilityConfig as JObs
        from sbeacon_tpu.config import StorageConfig as JSto

        cfg = JCfg(storage=JSto(root=tmp_path / "jstore"),
                   engine=JEng(microbatch=False, mesh_dispatch=False),
                   observability=JObs(slow_query_ms=-1.0,
                                      canary_enabled=False))
        cfg.storage.ensure()
        dist = fleet.coordinator(worker_urls, local=local, config=cfg,
                                 jax=True)
        return JApp(cfg, engine=dist), dist
    cfg = BeaconConfig(
        storage=StorageConfig(root=tmp_path / "store"),
        engine=EngineConfig(microbatch=False),
        ingest=IngestConfig(compact_interval_s=0),
        observability=ObservabilityConfig(slow_query_ms=-1.0,
                                          canary_enabled=False),
    )
    cfg.storage.ensure()
    dist = fleet.coordinator(worker_urls, local=local, config=cfg)
    return BeaconApp(cfg, engine=dist), dist


def _close(app):
    app.close()
    app.store.close()
    app.ontology.close()


# -- worker /ops/digest --------------------------------------------------------


@obs
def test_worker_ops_digest_golden_schema_over_http(fleet):
    recs = _records(10, 60)
    peng, jeng = _pair(fleet, "dgA", recs[:50], recs[50:])
    worker = fleet.worker(peng)
    jworker = fleet.worker(jeng, jax=True)
    code, doc = urllib_get(worker.address + "/ops/digest", 5.0)
    jcode, jdoc = urllib_get(jworker.address + "/ops/digest", 5.0)
    assert code == jcode == 200
    assert set(doc) == set(jdoc) == DIGEST_KEYS
    for k in SAME_VALUES:
        assert doc[k] == jdoc[k], k
    assert doc["datasets"] == ["dgA"] and doc["deltaPublishes"] == 1
    assert doc["deltaTails"]["dgA"]["shards"] == 1
    # the base fingerprint is stable across the standing delta (which
    # rides the full per-dataset fingerprints)
    assert doc["baseFingerprint"] == peng.base_fingerprint()
    assert doc["datasetFingerprints"] == peng.dataset_fingerprints()


@obs
def test_worker_ops_digest_rides_token_boundary(fleet):
    worker = fleet.worker(port_engine([shard("dgB", 11, n=20)]),
                          token="sek")
    code, _doc = urllib_get(worker.address + "/ops/digest", 5.0)
    assert code == 401
    code, doc = urllib_get(worker.address + "/ops/digest", 5.0,
                           {"Authorization": "Bearer sek"})
    assert code == 200 and set(doc) == DIGEST_KEYS


@obs
def test_ops_digest_accepts_extras(fleet):
    eng = fleet.own(port_engine([shard("dgC", 12, n=20)]))
    doc = ops_digest(eng, extras={"sloBreached": ["g_variants"]})
    assert set(doc) == DIGEST_KEYS | {"sloBreached"}
    assert doc["sloBreached"] == ["g_variants"]


# -- /fleet/status -------------------------------------------------------------


@obs
def test_fleet_status_single_host_schema():
    app = BeaconApp(device="cpu")
    try:
        status, doc = app.handle("GET", "/fleet/status")
        assert status == 200
        assert set(doc) == FLEET_KEYS
        assert doc["workers"] == {}
        assert set(doc["diagnosis"]) == DIAGNOSIS_KEYS
        assert doc["diagnosis"]["stalestReplica"] is None
        local = doc["local"]
        assert DIGEST_KEYS <= set(local)
        assert "sloBreached" in local and "canary" in local
    finally:
        _close(app)
        app.engine.close()


@obs
def test_fleet_status_names_stalest_replica_on_divergence(tmp_path, fleet):
    """Two workers advertising DIFFERENT copies of one dataset: the
    diagnosis names the divergent dataset and the stale replica, in the
    JAX coordinator's schema."""
    recs = _records(20, 80)
    docs = {}
    for jax in (False, True):
        make = jax_engine if jax else port_engine
        fresh = fleet.worker(make([shard("dvA", 0, recs=recs)]), jax=jax)
        stale = fleet.worker(make([shard("dvA", 0, recs=recs[:50])]),
                             jax=jax)
        local = fleet.own(make([shard("dvA", 0, recs=recs)]))
        app, _dist = _coordinator_app(fleet, tmp_path / str(jax),
                                      [fresh.address, stale.address], local,
                                      jax=jax)
        try:
            status, doc = app.handle("GET", "/fleet/status")
            assert status == 200
            _, metrics = app.handle("GET", "/metrics")
        finally:
            _close(app)
        docs[jax] = (doc, metrics, fresh.address, stale.address)
    (doc, metrics, fresh, stale), (jdoc, _jm, jfresh, jstale) = (
        docs[False], docs[True])
    assert set(doc) == set(jdoc)
    assert set(doc["diagnosis"]) == set(jdoc["diagnosis"])
    workers = doc["workers"]
    assert set(workers) == {fresh, stale}
    assert all(w["reachable"] for w in workers.values())
    assert set(workers[stale]) == set(jdoc["workers"][jstale])
    assert set(workers[stale]["digest"]) == set(
        jdoc["workers"][jstale]["digest"])
    diag = doc["diagnosis"]
    assert set(diag["divergentDatasets"]["dvA"]) == {fresh, stale}
    assert diag["stalestReplica"] == stale
    assert jdoc["diagnosis"]["stalestReplica"] == jstale
    assert workers[stale]["staleDatasets"] == 1
    assert diag["unreachableWorkers"] == []
    assert set(doc["local"]) == set(jdoc["local"])
    assert doc["migrations"] == [] and diag["stuckMigration"] is None
    assert metrics["fleet"]["digest_polls"] >= 1
    assert metrics["fleet"]["workers_reachable"] == 2
    assert metrics["fleet"]["divergent_datasets"] == 1


@obs
def test_fleet_status_reports_unreachable_worker(tmp_path, fleet):
    recs = _records(21, 40)
    w1 = fleet.worker(port_engine([shard("unA", 0, recs=recs)]))
    w2 = fleet.worker(port_engine([shard("unA", 0, recs=recs)]))
    local = fleet.own(port_engine([shard("unA", 0, recs=recs)]))
    app, dist = _coordinator_app(fleet, tmp_path, [w1.address, w2.address],
                                 local)
    try:
        _, doc = app.handle("GET", "/fleet/status")
        assert doc["diagnosis"]["unreachableWorkers"] == []
        dist.replica_table()
        w2.shutdown()
        dist.fleet.poll()  # explicit pass (the lazy cadence would wait)
        _, doc = app.handle("GET", "/fleet/status")
        assert doc["diagnosis"]["unreachableWorkers"] == [w2.address]
        assert not doc["workers"][w2.address]["reachable"]
        assert "error" in doc["workers"][w2.address]
        # /debug/status fills its fleet sections from the same engine
        dist.replica_table(refresh=True)
        _, dbg = app.handle("GET", "/debug/status")
        assert set(dbg["routing"]["workers"]) == {w1.address, w2.address}
        assert dbg["routing"]["workers"][w2.address]["reachable"] is False
        assert dbg["routing"]["replicas"] == 2  # w2's routes retained
    finally:
        _close(app)


# -- the fleet canary ----------------------------------------------------------


@obs
def test_canary_detects_seeded_stale_replica(tmp_path, fleet):
    """A replica whose delta tail is silently lost fails the known-hit
    probe on the next round (both query shapes, only that replica's
    path), seen as canary.mismatch events, canary metrics and a
    /debug/status diagnosis entry — with the paths JAX's canary probes."""
    recs = _records(32, 80)
    base, tail = recs[:60], recs[60:]
    w_ok = fleet.worker(port_engine([shard("cnC", 0, recs=base)],
                                    [shard("cnC", 0, recs=tail)]))
    stale_engine = port_engine([shard("cnC", 0, recs=base)],
                               [shard("cnC", 0, recs=tail)])
    w_bad = fleet.worker(stale_engine)
    local = fleet.own(port_engine([shard("cnC", 0, recs=base)],
                                  [shard("cnC", 0, recs=tail)]))
    app, dist = _coordinator_app(fleet, tmp_path, [w_ok.address,
                                                   w_bad.address], local)
    try:
        dist.replica_table()  # both copies identical -> both routed
        assert app.canary.sync_probes() == 2
        probe = app.canary._probes[0]
        assert sorted(name for name, _ in app.canary._paths(probe)) == (
            sorted(["engine", "local", f"replica:{w_bad.address}",
                    f"replica:{w_ok.address}"]))
        assert app.canary.run_once()["mismatches"] == 0
        # probe RTTs do not feed the router's rings
        assert not dist.router._rtts
        # seed the fault: drop the replica's delta tail in place
        with stale_engine._lock:
            stale_engine._deltas = {}
            stale_engine._rebuild_serving_state_locked()
        seq0 = journal.last_seq()
        out = app.canary.run_once()
        assert out["mismatches"] == 2
        assert all(f"replica:{w_bad.address}" in m
                   for m in out["mismatched"])
        events = journal.events(since=seq0, kind="canary.mismatch")
        assert events and events[0]["data"]["dataset"] == "cnC"
        assert events[0]["data"]["path"] == f"replica:{w_bad.address}"
        _, doc = app.handle("GET", "/debug/status")
        assert doc["canary"]["mismatches"] == 2
        assert doc["diagnosis"]["canaryMismatches"]
        _, metrics = app.handle("GET", "/metrics")
        assert metrics["canary"]["mismatches"] == 2
    finally:
        _close(app)
