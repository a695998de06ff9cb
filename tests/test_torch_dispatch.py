"""The port's fleet query plane against the JAX package's.

Twins of ``tests/test_dispatch.py`` on the port's ``WorkerServer`` and
``DistributedEngine`` (CPU engines), each fleet held at tolerance 0
against one port engine holding every dataset AND against the JAX fleet
over the same shards; both mixed-wire directions (the port's
coordinator over JAX workers, JAX's coordinator over port workers); the
worker entry's ``--help`` and its refusal without a GPU; and the server
entry with ``--worker`` as a child process, its bodies equal to an
in-process app over one engine. Concurrency cases wait on events, not
on the wall clock.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

from sbeacon_tpu_torch.config import (
    BeaconConfig,
    IngestConfig,
    ObservabilityConfig,
    ResilienceConfig,
    StorageConfig,
    TransportConfig,
)
from sbeacon_tpu_torch.parallel.dispatch import DistributedEngine, WorkerError
from sbeacon_tpu_torch.parallel.transport import urllib_get, urllib_post
from sbeacon_tpu_torch.payloads import VariantSearchResponse
from torch_fleet_corpus import (
    Fleet,
    dumps,
    jax_engine,
    jax_payload,
    payload,
    port_engine,
    shard,
)
from torch_ingest_corpus import no_thread_leak  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

PAYLOAD = payload(granularity="boolean")
#: every granularity and detail level the fan-out merges
SHAPES = [("boolean", "NONE"), ("boolean", "HIT"), ("count", "HIT"),
          ("record", "ALL"), ("aggregated", "ALL")]


def _shards():
    return {"dsA": shard("dsA", 100), "dsB": shard("dsB", 101),
            "dsC": shard("dsC", 200)}


@pytest.fixture()
def fleet():
    f = Fleet()
    try:
        yield f
    finally:
        f.close()


@pytest.fixture()
def cluster(fleet):
    """Port workers w1 (dsA, dsB) and w2 (dsC), their JAX twins jw1 and
    jw2, and one port engine over all three shards."""
    s = _shards()
    w1 = fleet.worker(port_engine([s["dsA"], s["dsB"]]))
    w2 = fleet.worker(port_engine([s["dsC"]]))
    jw1 = fleet.worker(jax_engine([s["dsA"], s["dsB"]]), jax=True)
    jw2 = fleet.worker(jax_engine([s["dsC"]]), jax=True)
    single = fleet.own(port_engine(list(s.values())))
    return w1, w2, jw1, jw2, single


def _sorted(responses):
    return sorted(responses, key=lambda r: (r.dataset_id, r.vcf_location))


def _answer(responses, p):
    """What a fan-out must agree on: every response, except for a
    boolean OR with no resultset detail, which short-circuits at the
    first hit and so answers only ``exists``."""
    if p.requested_granularity == "boolean" and p.include_datasets == "NONE":
        return any(r.exists for r in responses)
    return dumps(responses)


def test_distributed_matches_single_engine(cluster, fleet):
    w1, w2, jw1, jw2, single = cluster
    dist = fleet.coordinator([w1.address, w2.address])
    jdist = fleet.coordinator([jw1.address, jw2.address], jax=True)
    assert dist.datasets() == jdist.datasets() == ["dsA", "dsB", "dsC"]
    for gran, include in SHAPES:
        p = dataclasses.replace(PAYLOAD, requested_granularity=gran,
                                include_datasets=include)
        got = _answer(dist.search(p), p)
        assert got == _answer(_sorted(single.search(p)), p), gran
        assert got == _answer(jdist.search(jax_payload(p)), p), gran


def test_mixed_wire_directions_agree(cluster, fleet):
    """The port's coordinator over JAX workers, and JAX's coordinator
    over port workers, answer as the all-JAX fleet does."""
    w1, w2, jw1, jw2, _single = cluster
    jdist = fleet.coordinator([jw1.address, jw2.address], jax=True)
    port_over_jax = fleet.coordinator([jw1.address, jw2.address])
    jax_over_port = fleet.coordinator([w1.address, w2.address], jax=True)
    for gran, include in SHAPES:
        p = dataclasses.replace(PAYLOAD, requested_granularity=gran,
                                include_datasets=include)
        want = _answer(jdist.search(jax_payload(p)), p)
        assert _answer(port_over_jax.search(p), p) == want, gran
        assert _answer(jax_over_port.search(jax_payload(p)), p) == want, gran
    # the wire form of the probe flag and the discovery document too
    _, jdoc = urllib_get(f"{jw1.address}/datasets", 5)
    _, pdoc = urllib_get(f"{w1.address}/datasets", 5)
    assert pdoc["datasets"] == jdoc["datasets"]
    assert pdoc["dataset_fingerprints"] == jdoc["dataset_fingerprints"]


def test_dataset_subset_routes_to_one_worker(cluster, fleet):
    w1, w2, *_ = cluster
    dist = fleet.coordinator([w1.address, w2.address])
    got = dist.search(dataclasses.replace(PAYLOAD, dataset_ids=["dsC"]))
    assert [r.dataset_id for r in got] == ["dsC"]


def test_local_engine_composes(cluster, fleet):
    w1, _w2, jw1, _jw2, _single = cluster
    local = fleet.own(port_engine([shard("dsLocal", 300)]))
    dist = fleet.coordinator([w1.address], local=local)
    jlocal = fleet.own(jax_engine([shard("dsLocal", 300)]))
    jdist = fleet.coordinator([jw1.address], local=jlocal, jax=True)
    assert dist.datasets() == ["dsA", "dsB", "dsLocal"]
    got = dist.search(PAYLOAD)
    assert {r.dataset_id for r in got} == {"dsA", "dsB", "dsLocal"}
    assert dumps(got) == dumps(jdist.search(jax_payload(PAYLOAD)))
    assert "local=" in dist.index_fingerprint()


def test_worker_fingerprint_in_coordinator(cluster, fleet):
    w1, w2, *_ = cluster
    dist = fleet.coordinator([w1.address, w2.address])
    fp = dist.index_fingerprint()
    assert w1.address in fp and w2.address in fp
    assert "dsA" in fp  # worker fingerprints carry shard identity


def test_retry_then_error(fleet):
    """Strict mode (partial_results=False): an unreachable sole worker
    fails the query after the per-route retries."""
    calls = {"n": 0}

    def flaky_post(url, doc, timeout_s):
        calls["n"] += 1
        raise OSError("refused")

    def fake_get(url, timeout_s):
        return 200, {"datasets": ["dsX"], "fingerprint": "f"}

    dist = fleet.coordinator(
        ["http://127.0.0.1:1"], retries=2, post=flaky_post, get=fake_get,
        config=BeaconConfig(
            resilience=ResilienceConfig(partial_results=False)),
    )
    with pytest.raises(WorkerError):
        dist.search(dataclasses.replace(PAYLOAD, dataset_ids=["dsX"]))
    assert calls["n"] == 3  # initial + 2 retries


def test_stale_routes_refresh_on_miss(cluster, fleet):
    w1, w2, *_ = cluster
    dist = fleet.coordinator([w1.address])
    assert dist.datasets() == ["dsA", "dsB"]  # cache populated
    # dsC's worker joins after discovery: an explicit request triggers
    # a refresh, not a silent skip
    dist.worker_urls.append(w2.address)
    got = dist.search(dataclasses.replace(PAYLOAD, dataset_ids=["dsC"]))
    assert [r.dataset_id for r in got] == ["dsC"]


def test_unreachable_worker_skipped_in_discovery(fleet):
    w = fleet.worker(port_engine([shard("dsA", 100)]))
    dist = fleet.coordinator([w.address, "http://127.0.0.1:1"])
    assert dist.datasets() == ["dsA"]  # the dead worker drops out


def test_worker_error_travels_to_coordinator(cluster):
    w1, _w2, jw1, _jw2, _single = cluster
    # a malformed payload surfaces as a 500 carrying the error, as the
    # JAX worker answers it
    status, out = urllib_post(f"{w1.address}/search", {"bogus": 1}, 5)
    jstatus, jout = urllib_post(f"{jw1.address}/search", {"bogus": 1}, 5)
    assert status == jstatus == 500 and "error" in out
    assert out == jout


def test_cli_help_entrypoints():
    """The deployment entries exist: python -m sbeacon_tpu_torch.api.server
    and python -m sbeacon_tpu_torch.parallel.dispatch."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for mod in ("sbeacon_tpu_torch.api.server",
                "sbeacon_tpu_torch.parallel.dispatch"):
        out = subprocess.run(
            [sys.executable, "-m", mod, "--help"], capture_output=True,
            text=True, timeout=120, env=env,
        )
        assert out.returncode == 0, out.stderr
        assert "--port" in out.stdout and "--device" in out.stdout


def test_worker_entry_refuses_without_a_gpu(tmp_path):
    """The worker entry serves on the card unless asked for the CPU: on
    a host without CUDA it exits with the engine's refusal."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "sbeacon_tpu_torch.parallel.dispatch",
         "--data-root", str(tmp_path), "--port", "0"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "worker serving" not in out.stdout


def test_app_ingest_targets_local_engine(tmp_path, cluster, fleet):
    """A BeaconApp over a DistributedEngine ingests into the local
    engine and then serves the new dataset beside the workers'."""
    from sbeacon_tpu_torch.api import BeaconApp
    from sbeacon_tpu_torch.testing import make_test_vcf

    w1, *_ = cluster
    cfg = BeaconConfig(
        storage=StorageConfig(root=tmp_path / "coord"),
        ingest=IngestConfig(compact_interval_s=0),
        observability=ObservabilityConfig(canary_enabled=False),
    )
    cfg.storage.ensure()
    local = fleet.own(port_engine([]))
    dist = fleet.coordinator([w1.address], local=local, config=cfg)
    app = BeaconApp(cfg, engine=dist)
    try:
        vcf = tmp_path / "l.vcf.gz"
        make_test_vcf(str(vcf), seed=5, chroms=("1",), n_per_chrom=60)
        status, out = app.handle(
            "POST", "/submit",
            body={"datasetId": "dsLocal", "assemblyId": "GRCh38",
                  "vcfLocations": [str(vcf)], "dataset": {"name": "local"}},
        )
        assert status == 200, out
        assert "dsLocal" in local.datasets()
        assert set(dist.datasets()) >= {"dsA", "dsB", "dsLocal"}
        got = dist.search(PAYLOAD)
        assert {r.dataset_id for r in got} == {"dsA", "dsB", "dsLocal"}
    finally:
        app.close()
        app.store.close()
        app.ontology.close()


def _sole_response(ds, exists):
    return {"responses": [{"dataset_id": ds, "vcf_location": "v",
                           "exists": exists}]}


def test_fast_failure_awaits_slow_siblings(fleet):
    """A fast-failing worker does not strand its slow sibling's task:
    search() settles every future before raising (strict mode)."""
    failed, done = threading.Event(), threading.Event()

    def post(url, doc, timeout_s):
        if "fast" in url:
            failed.set()
            raise OSError("down")
        # the slow sibling answers only after the fast one has failed
        assert failed.wait(30)
        done.set()
        return 200, {"responses": []}

    def get(url, timeout_s):
        ds = "dsF" if "fast" in url else "dsS"
        return 200, {"datasets": [ds], "fingerprint": ds}

    dist = fleet.coordinator(
        ["http://fast:1", "http://slow:1"], retries=0, post=post, get=get,
        config=BeaconConfig(
            resilience=ResilienceConfig(partial_results=False)),
    )
    with pytest.raises(WorkerError):
        dist.search(dataclasses.replace(PAYLOAD, dataset_ids=["dsF", "dsS"]))
    # the raise happened only after the slow sibling finished
    assert done.is_set()


def test_local_search_runs_concurrently_with_fanout(fleet):
    """The coordinator's local-shard search overlaps the worker scatter:
    each leg waits for the other to be running (a barrier that a
    sequential coordinator would never pass)."""
    both = threading.Barrier(2, timeout=30)

    class FakeLocal:
        def datasets(self):
            return ["dsL"]

        def search(self, p):
            both.wait()
            return [VariantSearchResponse(dataset_id="dsL",
                                          vcf_location="v")]

    def post(url, doc, timeout_s, headers=None):
        both.wait()
        return 200, _sole_response("dsW", False)

    def get(url, timeout_s, headers=None):
        return 200, {"datasets": ["dsW"], "fingerprint": "f"}

    dist = fleet.coordinator(["http://w:1"], retries=0, post=post, get=get,
                             config=BeaconConfig(), local=FakeLocal())
    got = dist.search(dataclasses.replace(PAYLOAD, dataset_ids=["dsL",
                                                                "dsW"]))
    assert {r.dataset_id for r in got} == {"dsL", "dsW"}
    assert dist.mesh_tier is None  # no stack to build over a fake engine


def test_bool_hit_beats_sibling_error_regardless_of_order(fleet):
    """A boolean OR is decided by any hit: a sibling worker's error does
    not fail the query even when it lands FIRST."""
    errored = threading.Event()

    def post(url, doc, timeout_s, headers=None):
        if "werr" in url:
            raise OSError("injected: down")
        # the hit arrives once the error's leg has settled
        assert errored.wait(30)
        return 200, _sole_response("dH", True)

    def get(url, timeout_s, headers=None):
        ds = "dE" if "werr" in url else "dH"
        return 200, {"datasets": [ds], "fingerprint": ds}

    dist = fleet.coordinator(["http://werr:1", "http://whit:1"], retries=0,
                             post=post, get=get)
    submit = dist._pool.submit

    def submit_leg(fn, *args, **kw):
        # the error leg's future is done (its waiters told) before
        # ``errored`` lets the hit go
        f = submit(fn, *args, **kw)
        if fn == dist._search_group and "werr" in args[0]:
            f.add_done_callback(lambda _f: errored.set())
        return f

    dist._pool.submit = submit_leg
    p = dataclasses.replace(PAYLOAD, dataset_ids=["dE", "dH"],
                            include_datasets="NONE",
                            requested_granularity="boolean")
    got = dist.search(p)  # must NOT raise WorkerError
    assert any(r.exists for r in got)
    # nothing was abandoned (the error future had already settled)
    assert dist.short_circuits == 0


def test_bool_short_circuit_honors_config_toggle(fleet):
    """transport.bool_short_circuit=False keeps the full drain for
    boolean fan-outs: the slow leg answers only after the hit did, and
    its response is still merged."""
    hit_sent = threading.Event()

    def post(url, doc, timeout_s, headers=None):
        if "whit" in url:
            hit_sent.set()
            return 200, _sole_response("dH", True)
        assert hit_sent.wait(30)
        return 200, _sole_response("dS", False)

    def get(url, timeout_s, headers=None):
        ds = "dH" if "whit" in url else "dS"
        return 200, {"datasets": [ds], "fingerprint": ds}

    cfg = BeaconConfig(transport=TransportConfig(bool_short_circuit=False))
    dist = fleet.coordinator(["http://whit:1", "http://wslow:1"], retries=0,
                             post=post, get=get, config=cfg)
    p = dataclasses.replace(PAYLOAD, dataset_ids=["dH", "dS"],
                            include_datasets="NONE",
                            requested_granularity="boolean")
    got = dist.search(p)
    assert {r.dataset_id for r in got} == {"dH", "dS"}  # full drain
    assert dist.short_circuits == 0


def test_engine_close_releases_pools(cluster):
    w1, *_ = cluster
    dist = DistributedEngine([w1.address])
    dist.search(PAYLOAD)
    dist.close()
    assert dist._pool._shutdown
    assert dist.transport.metrics()["pooled"] == 0


def test_worker_token_gates_requests(fleet):
    """Workers with a shared token 401 unauthenticated calls; a
    coordinator with the token works end to end, and /health stays open
    for liveness probes — as the JAX worker does."""
    s = shard("dsA", 100)
    w = fleet.worker(port_engine([s]), token="s3cret")
    jw = fleet.worker(jax_engine([s]), token="s3cret", jax=True)
    for addr in (w.address, jw.address):
        assert urllib_get(f"{addr}/health", 5)[0] == 200
        # a 401 on a GET comes back as (status, body), not raised
        status, doc = urllib_get(f"{addr}/datasets", 5)
        assert status == 401 and "error" in doc
        status, _ = urllib_post(f"{addr}/search",
                                json.loads(PAYLOAD.dumps()), 5)
        assert status == 401
        status, doc = urllib_get(f"{addr}/datasets", 5,
                                 {"Authorization": "Bearer s3cret"})
        assert status == 200 and doc["datasets"] == ["dsA"]
    dist = fleet.coordinator([w.address], token="s3cret")
    assert {r.dataset_id for r in dist.search(PAYLOAD)} == {"dsA"}
    # the JAX coordinator's token reaches the port worker too
    jdist = fleet.coordinator([w.address], token="s3cret", jax=True)
    assert dumps(jdist.search(jax_payload(PAYLOAD))) == dumps(
        dist.search(PAYLOAD))
    # a wrong token is rejected
    bad = fleet.coordinator([w.address], token="wrong")
    assert bad.datasets() == []


def test_scan_and_migrate_refused_until_ported(cluster):
    """The worker's ``/scan`` and ``/migrate/*`` answer as the JAX
    worker's: an untokened worker without ``open_scan`` refuses
    ``/scan`` with 403, and ``/migrate/manifest`` lists the dataset's
    artifacts (none for an unknown dataset)."""
    w1, _w2, jw1, _jw2, _single = cluster
    for body in ({}, {"dataset": "dsA"}, {"dataset": "nope"}):
        for path in ("/scan", "/migrate/manifest"):
            got = urllib_post(f"{w1.address}{path}", body, 5)
            want = urllib_post(f"{jw1.address}{path}", body, 5)
            assert got == want, path
    status, doc = urllib_post(f"{w1.address}/scan", {}, 5)
    assert status == 403 and "token" in doc["error"]
    status, doc = urllib_post(f"{w1.address}/migrate/manifest",
                              {"dataset": "dsA"}, 5)
    assert status == 200 and [a["kind"] for a in doc["artifacts"]] == [
        "base"]
    # the body was read before the refusal: the connection stays usable
    assert urllib_get(f"{w1.address}/health", 5)[0] == 200


def test_replicas_fail_over_as_the_jax_fleet_does(fleet):
    """Two port workers serving one dataset's identical copy: a replica
    set; with one killed, queries answer from the other, equal to the
    JAX fleet's answer."""
    s = shard("rz", 5, n=200, chrom="21")
    ws = [fleet.worker(port_engine([s])) for _ in range(2)]
    jws = [fleet.worker(jax_engine([s]), jax=True) for _ in range(2)]
    dist = fleet.coordinator([w.address for w in ws], retries=0)
    jdist = fleet.coordinator([w.address for w in jws], retries=0, jax=True)
    p = payload(["rz"], chrom="21", granularity="record", include="ALL")
    assert set(dist.replica_table()["rz"]) == {w.address for w in ws}
    want = dumps(jdist.search(jax_payload(p)))
    assert dumps(dist.search(p)) == want
    for _ in range(10):  # steer the p2c pick at the worker to kill
        dist.router.note_rtt(ws[0].address, 0.001)
        dist.router.note_rtt(ws[1].address, 0.5)
    ws[0].shutdown()
    assert dumps(dist.search(p)) == want
    assert dist.dispatch_stats()["failovers"] >= 1
    assert dist.dispatch_stats()["partial_responses"] == 0


# -- the server entry as a fleet coordinator ----------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dataset_doc(ds):
    vcf = f"{ds}.vcf.gz"
    return {"id": ds, "name": ds, "_assemblyId": "GRCh38",
            "_vcfLocations": [vcf], "_vcfGroups": [[vcf]],
            "_vcfGroupsExplicit": False, "_vcfChromosomeMap": []}


def _post(base, path, body):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _unmasked(doc):
    doc = json.loads(json.dumps(doc))
    for key in ("traceId", "elapsedTimeMs"):
        doc.get("meta", {}).pop(key, None)
    return doc


def test_server_entry_with_workers(tmp_path, cluster, fleet):
    """``python -m sbeacon_tpu_torch.api.server --worker URL --worker
    URL`` serves /g_variants by fanning out over the workers: its bodies
    equal an in-process app's over one engine holding every dataset,
    and its /fleet/status names both workers reachable."""
    from sbeacon_tpu_torch.api import BeaconApp
    from sbeacon_tpu_torch.metadata import MetadataStore

    w1, w2, _jw1, _jw2, single = cluster
    root = tmp_path / "coord"
    cfg = BeaconConfig(storage=StorageConfig(root=root))
    cfg.storage.ensure()
    store = MetadataStore(cfg.storage.metadata_db)
    store.upsert("datasets", [_dataset_doc(d) for d in ("dsA", "dsB",
                                                         "dsC")])
    store.close()
    ref_root = tmp_path / "ref"
    ref_cfg = BeaconConfig(
        storage=StorageConfig(root=ref_root),
        ingest=IngestConfig(compact_interval_s=0),
        observability=ObservabilityConfig(canary_enabled=False),
    )
    ref_cfg.storage.ensure()
    for name in ("metadata.sqlite", "ontology.sqlite"):
        if (root / name).exists():
            (ref_root / name).write_bytes((root / name).read_bytes())
    ref = BeaconApp(ref_cfg, engine=single)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1",
               BEACON_CANARY_ENABLED="0", BEACON_COMPACT_INTERVAL_S="0")
    errors = open(tmp_path / "stderr.txt", "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "sbeacon_tpu_torch.api.server",
         "--device", "cpu", "--data-root", str(root), "--host",
         "127.0.0.1", "--port", str(port), "--worker", w1.address,
         "--worker", w2.address],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=errors,
        text=True,
    )
    try:
        line = child.stdout.readline()
        assert line.startswith(f"beacon serving on 127.0.0.1:{port}"), (
            line, (tmp_path / "stderr.txt").read_text())
        assert "device cpu, 2 workers" in line
        base = f"http://127.0.0.1:{port}"
        for gran, path in (("boolean", "/g_variants"),
                           ("count", "/datasets/dsC/g_variants"),
                           ("record", "/g_variants")):
            q = {"query": {"requestedGranularity": gran,
                           "includeResultsetResponses": "HIT",
                           "requestParameters": {
                               "assemblyId": "GRCh38",
                               "referenceName": "1", "start": [0],
                               "end": [1 << 29], "alternateBases": "N"}}}
            status, got = _post(base, path, q)
            rstatus, want = ref.handle("POST", path, body=q)
            assert status == rstatus == 200, got
            assert json.dumps(_unmasked(got)) == json.dumps(
                _unmasked(want)), path
        with urllib.request.urlopen(f"{base}/fleet/status",
                                    timeout=30) as r:
            doc = json.loads(r.read())
        assert set(doc["workers"]) == {w1.address, w2.address}
        assert doc["diagnosis"]["unreachableWorkers"] == []
    finally:
        child.terminate()
        child.wait(60)
        errors.close()
        ref.close()
        ref.store.close()
        ref.ontology.close()
    assert "Traceback" not in (tmp_path / "stderr.txt").read_text()

