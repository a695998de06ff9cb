"""The pod tier consulted through the port's ``DistributedEngine``, and
the coordinator's no-fallback rule.

Twins of the ``DistributedEngine`` cases of ``tests/test_mesh_dispatch.py``
on a two-entry CPU tier (``MeshDispatchTier(local, devices=[cpu, cpu])``
assigned to the coordinator's ``mesh_tier``): every answer equals the
JAX engine's without mesh, micro-batcher or tier, field for field. Where
JAX's coordinator falls back to the scatter after a tier failure and
lets a boolean hit elsewhere outvote a local-engine error, the port's
raises (ROADMAP Queue 3): a seeded ``mesh.dispatch`` fault, a failed
tier build and a failing local engine each raise through
``DistributedEngine.search``, after the worker legs have settled; a
worker's failure fails over to another replica.
"""

import dataclasses
import random
import threading
import time

import pytest
import torch

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.harness import faults
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.parallel.dispatch import (
    DistributedEngine,
    MeshDispatchTier,
)
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.resilience import (
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from torch_fleet_corpus import Fleet, port_engine, shard
from torch_ingest_corpus import no_thread_leak  # noqa: F401

CPU = torch.device("cpu")
N_SHARDS = 4
DS = [f"d{d}" for d in range(N_SHARDS)]
MODES = {
    "selected": dict(selected_samples_only=True,
                     sample_names={d: ["S1"] for d in DS}),
    "extract": dict(include_samples=True),
}


def _shards():
    """tests/test_mesh_dispatch.py's corpus (two samples, chromosome 1)."""
    return [
        j_build_index(
            j_random_records(random.Random(40 + d), chrom="1", n=250,
                             n_samples=2, p_no_acan=0.4),
            dataset_id=f"d{d}", vcf_location=f"v{d}",
            sample_names=["S0", "S1"])
        for d in range(N_SHARDS)
    ]


def _late(seed=123, name="late2"):
    return shard(name, seed, n=80)


def _doc(datasets=DS, gran="count", include="HIT", **kw):
    return dict(dataset_ids=list(datasets), reference_name="1", start_min=1,
                start_max=1 << 29, end_min=1, end_max=1 << 30,
                alternate_bases="N", requested_granularity=gran,
                include_datasets=include, **kw)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()


@pytest.fixture
def setup():
    """A factory of (port engine, coordinator with a two-entry CPU tier,
    JAX reference engine) over the same shards, closed at the end."""
    made = []

    def make(shards=None, workers=(), **over):
        shards = shards or _shards()
        teng = VariantEngine(BeaconConfig(engine=EngineConfig(
            use_mesh=False, microbatch_wait_ms=0.0, **over)), device="cpu")
        jref = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
            use_mesh=False, mesh_dispatch=False, microbatch=False,
            response_cache=False)))
        for s in shards:
            teng.add_index(shard_from_reference(s))
            jref.add_index(s)
        dist = DistributedEngine(list(workers), local=teng)
        # the coordinator's own tier sees one CPU entry (unavailable);
        # the test assigns a two-entry one, as the card's smoke does
        dist.mesh_tier.close()
        dist.mesh_tier = MeshDispatchTier(teng, devices=[CPU, CPU])
        made.append((dist, teng, jref))
        return teng, dist, jref

    yield make
    for dist, teng, jref in made:
        dist.close()
        teng.close()
        jref.close()


def _asd(responses):
    return [dataclasses.asdict(r) for r in responses]


def _same(dist, jref, doc):
    got = dist.search(VariantQueryPayload(**doc))
    assert _asd(got) == _asd(jref.search(JPayload(**doc))), doc
    return got


def test_tier_refusal_reasons_are_counted(setup):
    teng, dist, _jref = setup()
    tier = dist.mesh_tier
    pay = VariantQueryPayload(**_doc())
    assert tier.resolve(DS, pay) == set()  # nothing built
    assert tier.stats()["refusals"].get("unbuilt", 0) >= 1
    assert dist.warmup() > 0
    assert tier.resolve(["d0"], VariantQueryPayload(**_doc(["d0"]))) == set()
    assert tier.stats()["refusals"].get("min_shards", 0) == 1
    wild = VariantQueryPayload(**_doc(gran="record", include="ALL",
                                      reference_bases="AN",
                                      **MODES["selected"]))
    assert tier.resolve(DS, wild) == set()
    assert tier.stats()["refusals"].get("planes", 0) == 1
    teng.add_index(shard_from_reference(_late()))
    assert tier.resolve(DS, pay) == set()
    assert tier.stats()["refusals"].get("stale", 0) >= 1
    assert dist.dispatch_stats()["mesh_refusals"].get("unbuilt", 0) >= 1


def test_tier_plane_stack_counts_against_engine_budget(setup):
    teng, dist, _jref = setup()
    before = teng.plane_hbm_resident()
    dist.warmup()
    tier = dist.mesh_tier
    assert tier.stats()["planes"] is True
    stack_bytes = tier._state[0].plane_bytes_device
    assert stack_bytes > 0
    assert teng.plane_hbm_resident() >= before + stack_bytes


@pytest.mark.parametrize("gran", ["boolean", "count", "record"])
def test_tier_plane_parity_suite(setup, gran):
    _teng, dist, jref = setup()
    dist.warmup()
    assert dist.mesh_tier.stats()["planes"] is True
    for mode in ("selected", "extract"):
        _same(dist, jref, _doc(gran=gran, include="ALL", **MODES[mode]))
    assert dist.mesh_tier.stats()["dispatches"] == 2


def test_tier_planes_stay_warm_across_delta_publish(setup):
    teng, dist, jref = setup()
    dist.warmup()
    tier = dist.mesh_tier
    delta = shard("d0", 77, n=40, vcf="v0")
    teng.add_delta(shard_from_reference(delta))
    jref.add_delta(delta)
    _same(dist, jref, _doc(gran="record", include="ALL",
                           **MODES["selected"]))
    st = tier.stats()
    assert st["dispatches"] == 1 and st["ready"] and st["planes"]
    late = _late(5, "late3")
    teng.add_index(shard_from_reference(late))
    assert tier.warmup() > 0
    assert tier.stats()["planes"] is True
    assert tier.stats()["shards"] == N_SHARDS + 1


@pytest.mark.parametrize("gran, include", [
    ("boolean", "NONE"), ("count", "HIT"), ("record", "HIT"),
    ("aggregated", "ALL")])
def test_tier_parity_across_granularities(setup, gran, include):
    _teng, dist, jref = setup()
    assert dist.warmup() > 0
    assert dist.mesh_tier.stats()["ready"]
    _same(dist, jref, _doc(gran=gran, include=include))
    assert dist.mesh_tier.stats()["dispatches"] == 1


def test_tier_rides_microbatcher(setup):
    teng, dist, _jref = setup()
    dist.warmup()
    dist.search(VariantQueryPayload(**_doc()))
    assert 4 in teng.batcher.occupancy()["fused_hist"]
    assert dist.mesh_tier.stats()["dispatches"] == 1


def test_tier_plane_shapes_ride_the_single_launch(setup):
    _teng, dist, jref = setup()
    dist.warmup()
    got = _same(dist, jref, _doc(gran="record", include="ALL",
                                 **MODES["extract"]))
    assert len(got) == N_SHARDS
    assert all(r.sample_names for r in got if r.exists)
    assert dist.mesh_tier.stats()["dispatches"] == 1


def test_tier_goes_cold_on_ingest_then_rebuilds(setup):
    teng, dist, jref = setup()
    dist.warmup()
    tier = dist.mesh_tier
    dist.search(VariantQueryPayload(**_doc()))
    assert tier.stats()["dispatches"] == 1
    late = _late(99, "late")
    teng.add_index(shard_from_reference(late))
    jref.add_index(late)
    got = _same(dist, jref, _doc())  # stale stack refused: engine answers
    assert len(got) == N_SHARDS
    assert tier.warmup() > 0  # inline rebuild picks up the new shard
    assert tier.stats()["shards"] == N_SHARDS + 1
    _same(dist, jref, _doc(["d0", "d1", "late"]))
    assert tier.stats()["dispatches"] >= 2


@pytest.mark.resilience
def test_seeded_tier_fault_raises_without_fallback(setup):
    """A seeded mesh.dispatch fault raises through the coordinator: no
    scatter re-run, no dispatch counted; the next query rides the tier
    again."""
    _teng, dist, jref = setup()
    dist.warmup()
    faults.install({"seed": 3, "rules": [
        {"site": "mesh.dispatch", "kind": "error", "rate": 1.0}]})
    try:
        with pytest.raises(faults.FaultError):
            dist.search(VariantQueryPayload(**_doc()))
    finally:
        faults.uninstall()
    assert dist.mesh_tier.stats()["dispatches"] == 0
    assert "mesh_fallbacks" not in dist.dispatch_stats()
    _same(dist, jref, _doc())
    assert dist.mesh_tier.stats()["dispatches"] == 1


@pytest.mark.resilience
def test_tier_deadline_expiry_never_falls_back(setup):
    _teng, dist, _jref = setup()
    dist.warmup()
    with deadline_scope(Deadline.after(0.001)):
        time.sleep(0.01)  # the deadline is certainly lapsed
        with pytest.raises(DeadlineExceeded):
            dist.search(VariantQueryPayload(**_doc()))
    assert dist.mesh_tier.stats()["dispatches"] == 0


@pytest.mark.resilience
def test_failed_tier_build_raises_through_search(setup, monkeypatch):
    """A background build that failed is raised by the next consult of
    the coordinator, not answered around."""
    _teng, dist, _jref = setup()

    class Broken(tm.MeshFusedIndex):
        def __init__(self, *a, **k):
            raise RuntimeError("upload failed")

    monkeypatch.setattr(tm, "MeshFusedIndex", Broken)
    pay = VariantQueryPayload(**_doc())
    got = dist.search(pay)  # arms the background build; the engine serves
    assert len(got) == N_SHARDS
    for t in list(dist.mesh_tier._builds):
        t.join()
    with pytest.raises(RuntimeError, match="failed to build"):
        dist.search(pay)


def test_tier_mixed_query_splits_mesh_and_http(setup):
    fleet = Fleet()
    try:
        w0 = shard("w0", 7, n=150)
        worker = fleet.worker(port_engine([w0], mesh_dispatch=False))
        _teng, dist, jref = setup(workers=[worker.address])
        jref.add_index(w0)
        dist.warmup()
        got = _same(dist, jref, _doc(DS + ["w0"]))
        assert [r.dataset_id for r in got] == DS + ["w0"]
        assert dist.mesh_tier.stats()["dispatches"] == 1
    finally:
        fleet.close()


# -- the no-fallback rule ------------------------------------------------------


@pytest.mark.resilience
@pytest.mark.parametrize("gran, include", [("count", "HIT"),
                                           ("boolean", "NONE")])
def test_local_engine_failure_raises_after_the_workers_settle(gran, include):
    """The coordinator's local engine raising fails the request, even a
    boolean one a worker's hit would have decided; the worker leg has
    settled by then (no stranded pool task)."""
    local_failed, worker_done = threading.Event(), threading.Event()

    class FailingLocal:
        def datasets(self):
            return ["dsL"]

        def search(self, p):
            local_failed.set()
            raise RuntimeError("injected: local launch failed")

    def post(url, doc, timeout_s, headers=None):
        assert local_failed.wait(30)
        worker_done.set()
        return 200, {"responses": [{"dataset_id": "dsW",
                                    "vcf_location": "v", "exists": True}]}

    def get(url, timeout_s, headers=None):
        return 200, {"datasets": ["dsW"], "fingerprint": "f"}

    dist = DistributedEngine(["http://w:1"], retries=0, post=post, get=get,
                             local=FailingLocal(), config=BeaconConfig())
    try:
        p = VariantQueryPayload(**_doc(["dsL", "dsW"], gran=gran,
                                       include=include))
        with pytest.raises(RuntimeError, match="local launch failed"):
            dist.search(p)
        assert worker_done.is_set()
        assert dist.short_circuits == 0
    finally:
        dist.close()


@pytest.mark.resilience
def test_worker_failure_fails_over_beside_the_tier(setup):
    """A worker's failure keeps JAX's semantics: the dataset fails over
    to its other replica while the local datasets ride the tier."""
    fleet = Fleet()
    try:
        w0 = shard("w0", 7, n=150)
        ws = [fleet.worker(port_engine([w0])) for _ in range(2)]
        _teng, dist, jref = setup(workers=[w.address for w in ws])
        jref.add_index(w0)
        dist.warmup()
        for _ in range(10):  # steer the p2c pick at the worker to fail
            dist.router.note_rtt(ws[0].address, 0.001)
            dist.router.note_rtt(ws[1].address, 0.5)
        dist.replica_table()
        faults.install({"seed": 1, "rules": [
            {"site": "worker.http", "kind": "error", "rate": 1.0,
             "match": ws[0].address}]})
        _same(dist, jref, _doc(DS + ["w0"], gran="record"))
        stats = dist.dispatch_stats()
        assert stats["failovers"] == 1 and stats["partial_responses"] == 0
        assert stats["mesh_dispatches"] == 1
    finally:
        faults.uninstall()
        fleet.close()
