"""The port's live shard migration against the JAX package's, at
tolerance 0.

Twin of ``tests/test_migration.py``. A source worker serves a dataset's
base and standing delta tail, an empty target worker waits outside the
fleet, and a coordinator routes only the source. The happy path runs
through a JAX fleet and a port fleet side by side (``POST
/fleet/migrate`` on each coordinator app, ``GET /fleet/migrations``
polled until the migration completes): the documents equal each other
once worker urls and ages are masked, and every answer equals the JAX
fleet's and an unmigrated JAX engine's. The port fleet alone then
covers the resumed copy, a crash at each of the four ``migration:*``
seams, a verify mismatch, validation and the disable switch, the stuck
diagnosis, an adopted tail past the L0 threshold and a target whose
device build fails: after every one the answers equal the unmigrated
JAX engine's. The chaos soak is marked ``slow``, as in JAX.
"""

from __future__ import annotations

import random
import re
import threading
import time

import pytest

from sbeacon_tpu.harness import faults as jfaults
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.api import BeaconApp
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    EngineConfig,
    IngestConfig,
    ObservabilityConfig,
    ShapingConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.harness import faults
from sbeacon_tpu_torch.parallel.migration import Migration, MigrationError
from sbeacon_tpu_torch.index.columnar import shard_from_reference
from torch_fleet_corpus import (
    Fleet,
    jax_engine,
    jax_payload,
    payload,
    port_engine,
    shard,
)
from torch_ingest_corpus import no_thread_leak  # noqa: F401

resilience = pytest.mark.resilience

SEAMS = (
    "migration:copy",
    "migration:dual_serve",
    "migration:verify",
    "migration:cutover",
)
GRANULARITIES = ("boolean", "count", "record")


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()
    jfaults.uninstall()


def _records(seed=5, n=200):
    return random_records(random.Random(seed), chrom="21", n=n, n_samples=2)


def _mg(recs, ds="mg"):
    return shard(ds, 0, recs=recs, vcf=f"synthetic://{ds}")


def _payload(granularity="count", ds="mg"):
    return payload([ds], chrom="21", granularity=granularity)


def _sorted(responses):
    return sorted(r.dumps() for r in responses)


class Side:
    """One package's migration fleet: a source worker over base + tail,
    an empty target worker, a coordinator routing only the source."""

    def __init__(self, fleet, base, deltas, *, jax=False, **coord):
        make = jax_engine if jax else port_engine
        self.src_eng = fleet.own(make(base, deltas))
        self.tgt_eng = fleet.own(make([]))
        self.w_src = fleet.worker(self.src_eng, jax=jax)
        self.w_tgt = fleet.worker(self.tgt_eng, jax=jax)
        self.dist = fleet.coordinator([self.w_src.address], jax=jax,
                                      **coord)
        self.dist.replica_table()
        self.src, self.tgt = self.w_src.address, self.w_tgt.address

    def run(self, **kw):
        return self.dist.migrations.run("mg", self.src, self.tgt, **kw)


@pytest.fixture()
def fleet():
    f = Fleet()
    try:
        yield f
    finally:
        f.close()


def _corpus():
    """The standard dataset: a base and a one-delta tail."""
    return [_mg(_records())], [_mg(_records(seed=9, n=40))]


@pytest.fixture(scope="module")
def oracle():
    """An unmigrated JAX engine of the standard dataset, shared by the
    module (its compiled programs are reused across the tests)."""
    eng = jax_engine(*_corpus())
    try:
        yield eng
    finally:
        eng.close()


@pytest.fixture()
def side(fleet, oracle):
    """The port fleet of the standard dataset (one verify round: the
    happy path holds the default three), and the oracle."""
    cfg = BeaconConfig(observability=ObservabilityConfig(
        migration_verify_rounds=1, canary_enabled=False))
    return Side(fleet, *_corpus(), config=cfg), oracle


def _assert_answers(dist, oracle, grans=("count",)):
    """The fleet's answers equal the unmigrated JAX engine's."""
    for gran in grans:
        p = _payload(gran)
        assert _sorted(dist.search(p)) == _sorted(
            oracle.search(jax_payload(p))), gran


def _masked(doc, urls):
    """A /fleet/migrations document with worker urls named by role and
    the clock-dependent ages zeroed."""
    out = []
    for m in doc["migrations"]:
        m = dict(m, phaseAgeS=0, ageS=0)
        m["source"], m["target"] = urls[m["source"]], urls[m["target"]]
        out.append(m)
    return {**doc, "migrations": out}


def _coordinator_app(fleet, tmp_path, side, *, jax):
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
        return JApp(cfg, engine=side.dist)
    cfg = BeaconConfig(
        storage=StorageConfig(root=tmp_path / "store"),
        engine=EngineConfig(microbatch=False),
        ingest=IngestConfig(compact_interval_s=0),
        observability=ObservabilityConfig(slow_query_ms=-1.0,
                                          canary_enabled=False))
    cfg.storage.ensure()
    return BeaconApp(cfg, engine=side.dist)


def _wait_terminal(app, mig_id, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        _, doc = app.handle("GET", "/fleet/migrations")
        mm = [m for m in doc["migrations"] if m["id"] == mig_id]
        if mm and mm[0]["phase"] in ("completed", "rolled_back", "failed"):
            return doc
        time.sleep(0.02)
    raise AssertionError(f"{mig_id} never finished: {doc}")


# -- the protocol --------------------------------------------------------------


@resilience
def test_migrate_happy_path_byte_identical(fleet, oracle, tmp_path):
    """copy -> dual-serve -> verify -> cut-over through each package's
    coordinator app: the dataset moves source -> target, the source's
    copy is dropped, the two apps' migration documents are equal, and
    every answer equals the JAX fleet's and an unmigrated engine's."""
    base, deltas = _corpus()
    # each coordinator app ingests into an (empty) local engine
    sides = {jax: Side(fleet, base, deltas, jax=jax, local=fleet.own(
        (jax_engine if jax else port_engine)([]))) for jax in (False, True)}
    apps = {jax: _coordinator_app(fleet, tmp_path, s, jax=jax)
            for jax, s in sides.items()}
    docs = {}
    try:
        for jax, s in sides.items():
            app = apps[jax]
            body = {"dataset": "mg", "source": s.src, "target": s.tgt}
            status, doc = app.handle("POST", "/fleet/migrate", None, body)
            assert status == 202, doc
            # the protocol thread may have entered its copy phase already
            assert doc["phase"] in ("pending", "copy")
            assert doc["migrationId"] == "mig-1"
            done = _wait_terminal(app, doc["migrationId"])
            docs[jax] = _masked(done, {s.src: "S", s.tgt: "T"})
            # a migrate without its endpoints is refused up front
            assert app.handle("POST", "/fleet/migrate", None, {})[0] == 400
            _, metrics = app.handle("GET", "/metrics")
            assert metrics["migration"]["completed"] == 1
        assert docs[False] == docs[True]
        (m,) = docs[False]["migrations"]
        assert m["phase"] == "completed" and m["error"] is None
        assert (m["artifactsCopied"], m["artifactsSkipped"],
                m["verifyRounds"]) == (2, 0, 3)
        assert m["bytesCopied"] > 0
        assert docs[False]["counters"] == {
            "started": 1, "completed": 1, "rolled_back": 0,
            "bytes_copied": m["bytesCopied"]}
        assert docs[False]["stuck"] is None

        port, jside = sides[False], sides[True]
        assert port.dist.replica_table(refresh=True)["mg"] == (port.tgt,)
        assert port.src_eng.migration_manifest("mg")["artifacts"] == []
        assert port.dist.router.retired() == set()
        # the target's manifest is the source's before the move, and
        # equals the JAX target's
        assert port.tgt_eng.migration_manifest("mg") == \
            jside.tgt_eng.migration_manifest("mg")
        assert port.tgt_eng.dataset_fingerprints() == \
            oracle.dataset_fingerprints()
        for gran in GRANULARITIES:
            p = _payload(gran)
            want = _sorted(oracle.search(jax_payload(p)))
            assert _sorted(port.dist.search(p)) == want, gran
            assert _sorted(jside.dist.search(jax_payload(p))) == want, gran
        stats = port.dist.dispatch_stats()
        assert stats["migration_completed"] == 1
        assert stats["migration_bytes_copied"] == m["bytesCopied"]
        fleet_doc = port.dist.fleet.snapshot()
        assert fleet_doc["migrations"][0]["phase"] == "completed"
        assert fleet_doc["diagnosis"]["stuckMigration"] is None
    finally:
        for app in apps.values():
            app.close()
            app.store.close()
            app.ontology.close()


@resilience
def test_copy_resumes_from_adopted_artifacts(side):
    """A target already holding the base (a crashed earlier copy) is
    resumed: the manifest diff skips it and streams only the delta."""
    s, oracle = side
    s.tgt_eng.add_index(s.src_eng.export_artifact("mg", "synthetic://mg"))
    m = s.run()
    assert m.phase == "completed"
    assert (m.artifacts_skipped, m.artifacts_copied) == (1, 1)
    _assert_answers(s.dist, oracle)


@resilience
@pytest.mark.parametrize("seam", SEAMS)
def test_seam_crash_never_half_routes(side, seam):
    """A crash at each phase-entry seam leaves the source routed and
    serving the unmigrated answers; a copy crash resumes on a re-run,
    later crashes roll the target back out and drop its copy."""
    s, oracle = side
    faults.install(
        {"seed": 3, "rules": [{"site": seam, "kind": "error", "rate": 1.0}]})
    with pytest.raises(MigrationError):
        s.run()
    faults.uninstall()
    m = s.dist.migrations.status()[-1]
    if seam == "migration:copy":
        assert m["phase"] == "failed"
        assert s.dist.migrations.counters()["rolled_back"] == 0
    else:
        assert m["phase"] == "rolled_back"
        assert s.dist.migrations.counters()["rolled_back"] == 1
        assert s.tgt_eng.migration_manifest("mg")["artifacts"] == []
    assert s.dist.replica_table(refresh=True)["mg"] == (s.src,)
    _assert_answers(s.dist, oracle, GRANULARITIES)
    m2 = s.run()
    assert m2.phase == "completed"
    _assert_answers(s.dist, oracle, GRANULARITIES)
    assert s.dist.replica_table(refresh=True)["mg"] == (s.tgt,)


@resilience
def test_verify_mismatch_aborts_and_rolls_back(side):
    """A target whose answers diverge (rows added at verify entry) is
    never promoted: the round aborts, the target is routed out and
    dropped, and the source keeps serving the true answers."""
    s, oracle = side

    def corrupt(phase, m):
        if phase == "verify":
            s.tgt_eng.add_delta(
                shard_from_reference(_mg(_records(seed=77, n=25))))

    with pytest.raises(MigrationError, match="mismatch"):
        s.run(on_phase=corrupt)
    m = s.dist.migrations.status()[-1]
    assert m["phase"] == "rolled_back" and "mismatch" in m["error"]
    assert s.dist.migrations.counters()["rolled_back"] == 1
    assert s.dist.replica_table(refresh=True)["mg"] == (s.src,)
    _assert_answers(s.dist, oracle)


@resilience
def test_migrate_validation_and_disable(side):
    s, _oracle = side
    with pytest.raises(MigrationError, match="same worker"):
        s.dist.migrations.run("mg", s.src, s.src)
    with pytest.raises(MigrationError, match="needs dataset"):
        s.dist.migrations.run("", s.src, s.tgt)
    s.dist.config = BeaconConfig(
        observability=ObservabilityConfig(migration_enabled=False))
    with pytest.raises(MigrationError, match="disabled"):
        s.run()


@resilience
def test_stuck_migration_diagnosed_in_fleet_digest(side):
    """A phase that outlives its bound (2x the measured copy time after
    the copy) is named by ``stuck()`` and by the fleet digest."""
    s, _oracle = side
    now = time.monotonic()
    wedged = Migration(id="mig-wedged", dataset="mg", source="http://a:1",
                       target="http://b:1", phase="verify",
                       started_mono=now - 100.0, phase_mono=now - 100.0,
                       copy_s=1.0)
    with s.dist.migrations._lock:
        s.dist.migrations._migrations.append(wedged)
    st = s.dist.migrations.stuck()
    assert st is not None and st["id"] == "mig-wedged"
    assert st["phase"] == "verify" and st["phaseAgeS"] > st["boundS"]
    snap = s.dist.fleet.snapshot()
    assert snap["diagnosis"]["stuckMigration"]["id"] == "mig-wedged"
    assert any(mm["id"] == "mig-wedged" for mm in snap["migrations"])


@resilience
def test_adopted_tail_rides_the_l0_index(fleet):
    """A tail of ``l0_min_shards`` deltas moves at its original epochs,
    and the target rebuilds its L0 index over it (J3's ``fused_l0``
    form on the card): the target's fingerprints and answers equal the
    unmigrated engine's."""
    base = [_mg(_records())]
    deltas = [_mg(_records(seed=40 + k, n=30)) for k in range(4)]
    s = Side(fleet, base, deltas)
    # the JAX oracle matches its tail on the host (no L0 programs to
    # compile): the same answers by the L0 leg's contract
    oracle = fleet.own(jax_engine(base, deltas, l0_min_shards=0,
                                  l0_min_rows=0))
    assert s.src_eng.l0_status()["built"]
    m = s.run()
    assert m.phase == "completed" and m.artifacts_copied == 5
    l0 = s.tgt_eng.l0_status()
    assert l0["built"] and l0["keys"]["mg/synthetic://mg"]["shards"] == 4
    assert s.tgt_eng.dataset_fingerprints() == oracle.dataset_fingerprints()
    assert sorted(s.tgt_eng._deltas[("mg", "synthetic://mg")]) == [1, 2, 3,
                                                                   4]
    _assert_answers(s.dist, oracle, GRANULARITIES)


@resilience
@pytest.mark.parametrize("what", ["add_index", "adopt_delta"])
def test_target_device_failure_fails_the_migration(side, monkeypatch, what):
    """A target whose device build fails while adopting (the base's
    ``add_index``, the tail's ``adopt_delta``) answers ``/migrate/adopt``
    with 500: the migration fails, the target is never routed, and the
    source keeps serving; nothing is served from the host instead."""
    s, oracle = side

    def broken(*_a, **_kw):
        raise RuntimeError("device build failed")

    monkeypatch.setattr(s.tgt_eng, what, broken)
    with pytest.raises(MigrationError, match="500"):
        s.run()
    m = s.dist.migrations.status()[-1]
    assert m["phase"] == "failed" and "device build failed" in m["error"]
    assert s.dist.replica_table(refresh=True)["mg"] == (s.src,)
    _assert_answers(s.dist, oracle, GRANULARITIES)


def test_adopt_delta_refuses_epochs_an_l1_shard_covers(fleet):
    """A target whose compactor folded adopted epochs into an L1 shard
    refuses those epochs when a re-mirror offers them again (the JAX
    engine adopts them, serving their rows twice); an epoch past the
    L1 range is adopted."""
    from sbeacon_tpu_torch.index.columnar import merge_shards

    base = [_mg(_records())]
    deltas = [_mg(_records(seed=40 + k, n=30)) for k in range(4)]
    src = fleet.own(port_engine(base, deltas))
    tgt = fleet.own(port_engine(base, deltas[:3]))
    key = ("mg", "synthetic://mg")
    tail = tgt.delta_snapshot(key)[0][2]
    assert tgt.replace_delta_range(key, [1, 2, 3], merge_shards(
        [s for _e, s in tail]))
    fp = tgt.dataset_fingerprints()["mg"]
    for epoch in (1, 2, 3):
        assert not tgt.adopt_delta(src.export_artifact(
            "mg", "synthetic://mg", epoch=epoch), epoch)
    assert tgt.dataset_fingerprints()["mg"] == fp
    assert tgt.adopt_delta(src.export_artifact("mg", "synthetic://mg",
                                               epoch=4), 4)
    assert sorted(tgt._deltas[key]) == [3, 4]


# -- the chaos soak: migrate under load ---------------------------------------


def _hit_alt(rec):
    for a, ac in zip(rec.alts, rec.effective_ac()):
        if re.fullmatch(r"[ACGTN]+", a) and ac > 0:
            return a
    return None


def _gv_query(rec):
    return {"query": {
        "requestedGranularity": "boolean",
        "requestParameters": {
            "assemblyId": "GRCh38", "referenceName": "21",
            "start": [max(0, rec.pos - 1)],
            "end": [rec.pos + len(rec.ref) + 5],
            "alternateBases": _hit_alt(rec)}}}


@pytest.mark.slow
def test_chaos_soak_migrate_under_load_zero_5xx(fleet, tmp_path):
    """Mixed boolean/count traffic runs while TWO datasets migrate to a
    worker that joins the fleet mid-soak; another replica is killed
    mid-migration; the drained source leaves afterwards. Zero 5xx, both
    migrations complete, and the answers after the soak equal an
    unmigrated JAX engine's."""
    recs0, extra0 = _records(seed=21, n=240), _records(seed=22, n=40)
    recs1 = _records(seed=23, n=200)
    d0 = ([_mg(recs0, "d0")], [_mg(extra0, "d0")])
    d1 = [_mg(recs1, "d1")]
    e1 = fleet.own(port_engine(d0[0] + d1, d0[1]))
    e2 = fleet.own(port_engine(*d0))
    e3 = fleet.own(port_engine([]))
    w1, w2, w3 = (fleet.worker(e) for e in (e1, e2, e3))
    # the brownout ladder off: the CPU twins' worker calls take about a
    # second, which breaches the default latency SLO, and the ladder
    # would then shed the soak's own /fleet/migrate (a 429)
    cfg = BeaconConfig(
        storage=StorageConfig(root=tmp_path / "coord"),
        engine=EngineConfig(use_mesh=False, microbatch=False),
        ingest=IngestConfig(compact_interval_s=0),
        shaping=ShapingConfig(brownout=False),
        observability=ObservabilityConfig(canary_enabled=False))
    cfg.storage.ensure()
    local = fleet.own(port_engine([]))
    dist = fleet.coordinator([w1.address, w2.address], local=local,
                             config=cfg, retries=0, timeout_s=10.0)
    app = BeaconApp(cfg, engine=dist)
    app.store.upsert("datasets", [
        {"id": ds, "name": ds, "_assemblyId": "GRCh38",
         "_vcfLocations": [f"synthetic://{ds}"]} for ds in ("d0", "d1")])
    dist.replica_table()
    oracle = fleet.own(jax_engine(d0[0] + d1, d0[1]))
    pre = {ds: _sorted(oracle.search(jax_payload(_payload(ds=ds))))
           for ds in ("d0", "d1")}
    qrecs = [r for r in recs0 if _hit_alt(r)]
    statuses, bad = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(k):
        rng = random.Random(900 + k)
        while not stop.is_set():
            q = _gv_query(qrecs[rng.randrange(len(qrecs))])
            if rng.random() < 0.5:
                q["query"]["requestedGranularity"] = "count"
            status, body = app.handle("POST", "/g_variants", body=q,
                                      headers={"X-Beacon-Deadline": "15"})
            with lock:
                statuses.append(status)
                if status >= 500:
                    bad.append((status, body))
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(6)]
    for t in threads:
        t.start()

    def migrate(ds):
        st, doc = app.handle("POST", "/fleet/migrate", body={
            "dataset": ds, "source": w1.address, "target": w3.address})
        assert st == 202, doc
        return doc["migrationId"]

    try:
        time.sleep(0.3)
        mig1 = migrate("d0")
        time.sleep(0.2)
        w2.shutdown()  # d0's other replica dies mid-migration
        doc = _wait_terminal(app, mig1)
        assert [m["phase"] for m in doc["migrations"]] == ["completed"]
        doc = _wait_terminal(app, migrate("d1"))
        assert doc["migrations"][-1]["phase"] == "completed"
        assert dist.remove_worker(w1.address)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        app.close()
        app.store.close()
        app.ontology.close()
    assert statuses, "no traffic recorded"
    assert not bad, f"5xx during soak: {bad[:5]} of {len(bad)}"
    for ds in ("d0", "d1"):
        assert _sorted(dist.search(_payload(ds=ds))) == pre[ds], ds
    table = dist.replica_table(refresh=True)
    assert w3.address in table["d0"] and w1.address not in table["d0"]
    assert table["d1"] == (w3.address,)
    counters = dist.migrations.counters()
    assert (counters["completed"], counters["rolled_back"]) == (2, 0)
