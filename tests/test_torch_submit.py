"""``/submit`` on the port against the JAX package's, at tolerance 0.

Each case builds the JAX app and the port's app (a CPU engine) on two
fresh data roots and sends both the same submissions: POST and PATCH,
``payloadRef`` from a file and over ``http://``, a ``vcfGroups`` that
does not partition ``vcfLocations``, missing and unreachable VCFs, and
bodies that break the schema (jsonschema's messages: missing, extra,
mistyped and empty fields). The ``/submit`` answers must be equal, and
after each submit the ``/g_variants`` and entity bodies too (masked as
in tests/torch_app_corpus.py). Then the ontology resolvers through an
injected transport and the SQL UDFs against the JAX package's.
"""

from __future__ import annotations

import base64
import copy
import json
import random

import pytest

from sbeacon_tpu.api.app import BeaconApp as JBeaconApp
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.config import IngestConfig as JIngestConfig
from sbeacon_tpu.config import ObservabilityConfig as JObservabilityConfig
from sbeacon_tpu.config import StorageConfig as JStorageConfig
from sbeacon_tpu.genomics.tabix import ensure_index as j_ensure_index
from sbeacon_tpu.metadata import resolvers as jr
from sbeacon_tpu.metadata import udfs as ju
from sbeacon_tpu.metadata.ontology import OntologyStore as JOntologyStore
from sbeacon_tpu.metadata.store import MetadataStore as JMetadataStore
from sbeacon_tpu.testing import make_test_vcf as j_make_test_vcf
from sbeacon_tpu_torch.api import BeaconApp
from sbeacon_tpu_torch.api import submit as tsubmit
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    EngineConfig,
    IngestConfig,
    ObservabilityConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.metadata import resolvers as tr
from sbeacon_tpu_torch.metadata import udfs as tu
from sbeacon_tpu_torch.metadata.ontology import OntologyStore
from sbeacon_tpu_torch.metadata.store import MetadataStore
from sbeacon_tpu_torch.testing import range_server
from torch_app_corpus import SEX_TERMS, dumped, submission
from torch_ingest_corpus import no_thread_leak  # noqa: F401

SAMPLES6 = [f"S{i:04d}" for i in range(6)]


class Apps:
    """The JAX app and the port's app, each on its own fresh root; the
    compactor and the canary off (run by hand), the port on the CPU."""

    def __init__(self, tmp_path, **ingest):
        ingest.setdefault("compact_interval_s", 0.0)
        jcfg = JBeaconConfig(
            storage=JStorageConfig(root=tmp_path / "jroot"),
            engine=JEngineConfig(use_mesh=False),
            ingest=JIngestConfig(**ingest),
            observability=JObservabilityConfig(canary_enabled=False))
        tcfg = BeaconConfig(
            storage=StorageConfig(root=tmp_path / "troot"),
            engine=EngineConfig(use_mesh=False),
            ingest=IngestConfig(**ingest),
            observability=ObservabilityConfig(canary_enabled=False))
        jcfg.storage.ensure()
        tcfg.storage.ensure()
        self.j = JBeaconApp(jcfg)
        self.t = BeaconApp(tcfg, engine=VariantEngine(tcfg, device="cpu"))

    def both(self, method, path, query_params=None, body=None,
             headers=None):
        js, jb = self.j.handle(method, path, copy.deepcopy(query_params),
                               copy.deepcopy(body), headers=dict(
                                   headers or {}))
        ts, tb = self.t.handle(method, path, copy.deepcopy(query_params),
                               copy.deepcopy(body), headers=dict(
                                   headers or {}))
        assert ts == js, (method, path, ts, js, tb, jb)
        assert dumped(tb, path) == dumped(jb, path), (method, path, tb, jb)
        return ts, tb

    def reads(self, recs, chroms=("1", "2"), datasets=("ds1",)):
        """The read surface over what was submitted: every answer equal."""
        for path in ["/datasets", "/individuals", "/analyses", "/cohorts",
                     "/filtering_terms", "/info"] + [
                         f"/datasets/{d}" for d in datasets]:
            self.both("GET", path)
        rng = random.Random(7)
        for k in range(12):
            r = rng.choice(recs)
            gran = ("boolean", "count", "record")[k % 3]
            rp = {"assemblyId": "GRCh38", "referenceName": r.chrom,
                  "start": [r.pos - 1 - (k % 4) * 500],
                  "end": [r.pos + len(r.ref) + 5 + (k % 4) * 500],
                  "alternateBases": "N"}
            body = {"meta": {"apiVersion": "2.0"},
                    "query": {"requestedGranularity": gran,
                              "includeResultsetResponses": "HIT",
                              "requestParameters": rp}}
            if k % 4 == 3:
                body["query"]["filters"] = [
                    {"id": SEX_TERMS[k % 2], "scope": "individuals"}]
            self.both("POST", "/g_variants", body=body)
            for d in datasets:
                self.both("POST", f"/datasets/{d}/g_variants", body=body)
        for c in chroms:
            self.both("GET", "/g_variants", query_params={
                "referenceName": c, "start": "0", "end": "100000000",
                "alternateBases": "N", "requestedGranularity": "count"})

    def close(self):
        for app in (self.j, self.t):
            app.close()
            app.engine.close()
            app.store.close()
            app.ontology.close()
            app.ingest.ledger.close()


@pytest.fixture
def vcfs(tmp_path):
    """Two VCFs of six samples (chromosomes 1-2 and 3), indexed."""
    out = []
    for name, seed, chroms in (("a.vcf.gz", 31, ("1", "2")),
                               ("b.vcf.gz", 32, ("3",))):
        p = tmp_path / "vcfs" / name
        p.parent.mkdir(exist_ok=True)
        recs = j_make_test_vcf(p, seed=seed, chroms=chroms, n_per_chrom=150,
                               n_samples=6)
        j_ensure_index(p)
        out.append((p, recs))
    return out


@pytest.fixture
def apps(tmp_path):
    a = Apps(tmp_path, min_task_time=1e-6, scan_rate=1e6,
             dispatch_cost=1e-7, max_concurrency=1000)
    yield a
    a.close()


def _sub(ds, vcf, **over):
    body = submission(ds, f"c-{ds}", vcf, lambda i: SEX_TERMS[i % 2],
                      samples=SAMPLES6)
    body.update(over)
    return body


def test_post_submit_then_reads_equal(apps, vcfs):
    (a, recs), _ = vcfs
    status, body = apps.both("POST", "/submit", body=_sub("ds1", a))
    assert status == 200
    assert body["completed"] == [
        "Verified VCF locations", "Added dataset metadata", "Added cohorts",
        "Added individuals", "Added biosamples", "Added runs",
        "Added analyses", "Rebuilt indexes"]
    assert body["pending"][0].startswith("Summarised 1 VCF(s): ")
    apps.reads(recs)
    # the streamed slices were folded by the inline base publish
    assert apps.t.engine.delta_stats() == apps.j.engine.delta_stats() == {}
    assert apps.t.ingest.ledger.delta_summary() == \
        apps.j.ingest.ledger.delta_summary()
    assert apps.t.ingest.ledger.delta_summary()["delta_publishes"] >= 2


def test_patch_and_resubmit_equal(apps, vcfs):
    (a, recs), (b, recs_b) = vcfs
    apps.both("POST", "/submit", body=_sub("ds1", a))
    status, _ = apps.both("PATCH", "/submit", body={
        "datasetId": "ds1", "dataset": {"name": "renamed"}})
    assert status == 200
    apps.both("GET", "/datasets/ds1")
    # a served VCF re-submitted: no streaming, the same answers
    assert not apps.t.ingest.pipeline._streaming("ds1", str(a))
    apps.both("POST", "/submit", body=_sub("ds1", a))
    # PATCH adding a VCF, then only vcfGroups, then shrinking
    status, _ = apps.both("PATCH", "/submit", body={
        "datasetId": "ds1", "vcfLocations": [str(a), str(b)]})
    assert status == 200
    apps.reads(recs + recs_b, chroms=("1", "2", "3"))
    status, _ = apps.both("PATCH", "/submit", body={
        "datasetId": "ds1", "vcfGroups": [[str(a)], [str(b)]]})
    assert status == 200
    apps.both("GET", "/datasets/ds1")
    status, _ = apps.both("PATCH", "/submit", body={
        "datasetId": "ds1", "vcfLocations": [str(a)]})
    assert status == 200
    apps.both("GET", "/datasets/ds1")
    apps.reads(recs)


def test_vcf_groups_partition_error_and_submit_without_cohort(apps, vcfs):
    (a, _), (b, _) = vcfs
    status, body = apps.both("POST", "/submit", body={
        "datasetId": "dsg", "assemblyId": "GRCh38", "dataset": {"name": "g"},
        "vcfLocations": [str(a), str(b)], "vcfGroups": [[str(a)]]})
    assert status == 400 and "vcfGroups" in body["error"]["errorMessage"]
    status, body = apps.both("POST", "/submit", body={
        "datasetId": "solo", "assemblyId": "GRCh38", "vcfLocations": [],
        "dataset": {"name": "solo"},
        "individuals": [{"id": "SOLO-I", "sex": {"id": "NCIT:C20197"}}]})
    assert status == 200 and "Added individuals" in body["completed"]
    apps.both("GET", "/individuals/SOLO-I")


def test_vcf_location_errors_equal(apps, tmp_path):
    for locs in (["/nonexistent/x.vcf.gz"],
                 ["/nonexistent/x.vcf.gz", "/nonexistent/y.vcf.gz"],
                 ["http://127.0.0.1:9/nope.vcf.gz"]):
        status, body = apps.both("POST", "/submit", body={
            "datasetId": "bad", "assemblyId": "GRCh38", "vcfLocations": locs,
            "dataset": {"name": "bad"}})
        assert status == 400
    (tmp_path / "raw.vcf.gz").write_bytes(b"not bgzf at all")
    status, body = apps.both("POST", "/submit", body={
        "datasetId": "bad", "assemblyId": "GRCh38",
        "vcfLocations": [str(tmp_path / "raw.vcf.gz")],
        "dataset": {"name": "bad"}})
    assert status == 400 and "Could not index" in body["error"][
        "errorMessage"]
    apps.both("GET", "/submit")  # the method check: 400 in both


BAD_BODIES = [
    {},
    {"datasetId": "x"},
    {"datasetId": "", "assemblyId": "", "vcfLocations": [""],
     "dataset": {}},
    {"datasetId": 3, "assemblyId": ["GRCh38"], "vcfLocations": "a.vcf.gz",
     "dataset": []},
    {"datasetId": "x", "assemblyId": "GRCh38", "vcfLocations": [],
     "dataset": {}, "extra": 1, "another": None},
    {"datasetId": "x", "assemblyId": "GRCh38", "vcfLocations": [1, ""],
     "dataset": {}, "vcfGroups": [["a", 2], "b"], "individuals": [1, {}],
     "index": "yes", "cohortId": 5, "cohort": [], "runs": {},
     "biosamples": [[]], "analyses": [None], "zzz": 0, "aaa": 0},
    {"payloadRef": ""},
    {"payloadRef": 7},
    {"payloadRef": "/x.json", "datasetId": "x"},
    [],
    "not an object",
]


@pytest.mark.parametrize("body", BAD_BODIES, ids=range(len(BAD_BODIES)))
@pytest.mark.parametrize("method", ["POST", "PATCH"])
def test_schema_messages_equal(apps, method, body):
    status, out = apps.both(method, "/submit", body=body)
    if method == "PATCH" and body == {"datasetId": "x"}:
        assert status == 200  # an update needs only the dataset id
    else:
        assert status == 400 and out["error"]["errorCode"] == 400


@pytest.mark.parametrize("update", [False, True])
def test_validate_submission_messages_equal(update):
    from sbeacon_tpu.api import submit as jsubmit
    from sbeacon_tpu.api.requests import RequestError as JRequestError
    from sbeacon_tpu_torch.api.requests import RequestError

    for body in BAD_BODIES[:6]:
        if update and body == {"datasetId": "x"}:
            tsubmit.validate_submission(body, update=True)  # valid
            continue
        with pytest.raises(RequestError) as a:
            tsubmit.validate_submission(body, update=update)
        with pytest.raises(JRequestError) as b:
            jsubmit.validate_submission(body, update=update)
        assert str(a.value) == str(b.value)
    assert tsubmit.SUBMIT_SCHEMA_NEW == jsubmit.SUBMIT_SCHEMA_NEW
    assert tsubmit.SUBMIT_SCHEMA_UPDATE == jsubmit.SUBMIT_SCHEMA_UPDATE
    assert tsubmit.PAYLOAD_REF_SCHEMA == jsubmit.PAYLOAD_REF_SCHEMA


def test_payload_ref_file_and_http_equal(apps, vcfs, tmp_path):
    (a, recs), _ = vcfs
    sub = _sub("dsPR", a)
    sub["individuals"] += [{"id": f"i{k}", "sex": {"id": "x"},
                            "note": "z" * 200} for k in range(300)]
    ref = tmp_path / "payload.json"
    ref.write_text(json.dumps(sub))
    status, _ = apps.both("POST", "/submit", body={"payloadRef": str(ref)})
    assert status == 200
    apps.reads(recs, datasets=("dsPR",))
    apps.both("GET", "/individuals", query_params={
        "requestedGranularity": "count"})
    with range_server(tmp_path) as base:
        status, _ = apps.both("POST", "/submit", body={
            "payloadRef": f"{base}/payload.json"})
        assert status == 200
        nest = tmp_path / "nest.json"
        nest.write_text(json.dumps({"payloadRef": str(ref)}))
        for bad in ({"payloadRef": str(tmp_path / "missing.json")},
                    {"payloadRef": str(a)},
                    {"payloadRef": f"{base}/missing.json"},
                    {"payloadRef": str(nest)}):
            status, _ = apps.both("POST", "/submit", body=bad)
            assert status == 400


def test_remote_vcf_submission_equal(apps, vcfs):
    (a, recs), _ = vcfs
    with range_server(a.parent) as base:
        status, body = apps.both("POST", "/submit", body=_sub(
            "dsR", f"{base}/{a.name}"))
        assert status == 200
        apps.reads(recs, datasets=("dsR",))


def test_debug_status_and_metrics_carry_ingest(apps, vcfs):
    (a, _), _ = vcfs
    apps.both("POST", "/submit", body=_sub("ds1", a))
    for app in (apps.t, apps.j):
        app.ingest.compactor.run_once()
    _, tb = apps.t.handle("GET", "/debug/status")
    _, jb = apps.j.handle("GET", "/debug/status")
    assert tb["ingest"]["compactor"] == jb["ingest"]["compactor"]
    assert tb["ingest"]["deltaTails"] == jb["ingest"]["deltaTails"]
    tm = apps.t.telemetry.render_json()
    jm = apps.j.telemetry.render_json()
    assert tm["compaction"] == jm["compaction"]
    assert tm["ingest"]["native_fallbacks"] == jm["ingest"][
        "native_fallbacks"]
    assert {"slice_disk_bytes", "gc_bytes", "native_fallbacks"} <= set(
        tm["ingest"])


def test_compactor_thread_stops_with_the_app(tmp_path):
    cfg = BeaconConfig(storage=StorageConfig(root=tmp_path / "r"),
                       observability=ObservabilityConfig(
                           canary_enabled=False))
    cfg.storage.ensure()
    app = BeaconApp(cfg, engine=VariantEngine(cfg, device="cpu"))
    try:
        assert app.ingest.compactor._thread.is_alive()
        assert app.ingest.compactor.accounting is app.accounting
    finally:
        app.close()
        app.engine.close()
        app.store.close()
        app.ontology.close()
        app.ingest.ledger.close()
    assert not app.ingest.compactor._thread.is_alive()


def test_submit_runs_indexer_when_enabled(tmp_path, monkeypatch):
    import dataclasses

    from sbeacon_tpu_torch.config import ResolverConfig

    cfg = BeaconConfig(storage=StorageConfig(root=tmp_path / "r"),
                       ingest=IngestConfig(compact_interval_s=0.0),
                       observability=ObservabilityConfig(
                           canary_enabled=False))
    cfg.storage.ensure()
    app = BeaconApp(cfg, engine=VariantEngine(cfg, device="cpu"))
    try:
        app.config = dataclasses.replace(app.config,
                                         resolvers=ResolverConfig(
                                             enabled=True))
        monkeypatch.setattr(tr.OlsResolver, "ontology_meta", lambda self, p:
                            {"id": p, "baseUri": f"http://x/{p}_"})
        monkeypatch.setattr(tr.OlsResolver, "ancestors",
                            lambda self, term, meta:
                            {f"{term.split(':')[0]}:ROOT"})
        status, out = app.handle("POST", "/submit", body={
            "datasetId": "ds", "assemblyId": "GRCh38", "vcfLocations": [],
            "dataset": {"name": "d"},
            "individuals": [{"id": "I0", "sex": {"id": "HP:0000001"}}],
            "index": True})
        assert status == 200, out
        assert any("Resolved ontology closures" in c
                   for c in out["completed"])
        assert "HP:ROOT" in app.ontology.term_ancestors("HP:0000001")
    finally:
        app.close()
        app.engine.close()
        app.store.close()
        app.ontology.close()
        app.ingest.ledger.close()


# -- resolvers through an injected transport -------------------------------


class Ols:
    def __init__(self):
        self.calls = []

    def __call__(self, method, url, body):
        self.calls.append((method, url))
        if url.endswith("/hp"):
            return 200, {"ontologyId": "hp", "config": {
                "baseUris": ["http://purl.obolibrary.org/obo/HP_"]}}
        if "page=2" in url:
            return 200, {"_embedded": {"terms": [{"obo_id": "HP:0000002"}]},
                         "_links": {}}
        if "hierarchicalAncestors" in url:
            return 200, {"_embedded": {"terms": [
                {"obo_id": "HP:0000001"}, {"obo_id": "HP:0000118"},
                {"obo_id": None}]},
                "_links": {"next": {"href": url + "&page=2"}}}
        return 404, {}


class Ontoserver:
    def __init__(self, fail=2):
        self.n, self.fail, self.bodies = 0, fail, []

    def __call__(self, method, url, body):
        self.n += 1
        self.bodies.append(body)
        if self.n <= self.fail:
            if self.n % 2:
                raise OSError("connection reset")
            return 500, {}
        return 200, {"expansion": {"contains": [{"code": "123"},
                                                {"code": "9"}]}}


@pytest.mark.parametrize("term", ["HP:0000001", "hp:0000924", "SNOMED:123",
                                  "snomed:123", "123456", "NCIT:C20197",
                                  "weird"])
def test_term_prefix_equal(term):
    assert tr.term_prefix(term) == jr.term_prefix(term)


def test_resolvers_equal_through_a_transport():
    a, b = Ols(), Ols()
    ta, ja = tr.OlsResolver(transport=a), jr.OlsResolver(transport=b)
    meta = ta.ontology_meta("HP")
    assert meta == ja.ontology_meta("HP")
    assert ta.ancestors("HP:0000924", meta) == ja.ancestors("HP:0000924",
                                                            meta)
    assert a.calls == b.calls
    c, d = Ontoserver(), Ontoserver()
    tc = tr.OntoserverResolver(transport=c, retry_sleep_s=0)
    jc = jr.OntoserverResolver(transport=d, retry_sleep_s=0)
    for term in ("SNOMED:123", "snomed:123", "123456"):
        assert tc.ancestors(term, {"baseUri": "http://snomed.info/sct"}) == \
            jc.ancestors(term, {"baseUri": "http://snomed.info/sct"})
    assert c.bodies == d.bodies and c.n == d.n
    dead = tr.OntoserverResolver(transport=lambda m, u, b: (500, {}),
                                 retries=3, retry_sleep_s=0)
    assert dead.ancestors("SNOMED:1", {}) is None


def _seed(store_cls):
    store = store_cls()
    store.upsert("individuals", [
        {"id": "I0", "sex": {"id": "HP:0000924", "label": "x"},
         "_datasetId": "ds"},
        {"id": "I1", "sex": {"id": "SNOMED:123", "label": "y"},
         "_datasetId": "ds"},
        {"id": "I2", "sex": {"id": "ZZZ:1", "label": "z"},
         "_datasetId": "ds"}])
    store.rebuild_indexes()
    return store


def test_term_tree_indexer_equal():
    out = []
    for mod, Store, Onto in ((tr, MetadataStore, OntologyStore),
                             (jr, JMetadataStore, JOntologyStore)):
        store, onto = _seed(Store), Onto()
        idx = mod.TermTreeIndexer(
            store, onto, ols=mod.OlsResolver(transport=Ols()),
            ontoserver=mod.OntoserverResolver(transport=Ontoserver(),
                                              retry_sleep_s=0),
            workers=2)
        first, second = idx.run(), idx.run()
        out.append((first, second,
                    sorted(onto.term_ancestors("HP:0000924")),
                    sorted(onto.term_descendants("HP:0000001")),
                    sorted(onto.term_ancestors("SNOMED:123")),
                    onto.get_ontology("HP"), onto.get_ontology("SNOMED")))
        store.close()
        onto.close()
    assert out[0] == out[1]
    assert out[0][0]["resolved"] == 2 and out[0][1]["skipped"] == 2


# -- the SQL UDFs --------------------------------------------------------------

KEY = base64.b64encode(bytes(range(16))).decode()


def _secrets(name):
    assert name == "beacon-key"
    return KEY


@pytest.mark.parametrize("s", ["", "hello", "x" * 10_000, "unicode ✓ ∆"])
def test_udfs_equal(s):
    assert tu.compress(s) == ju.compress(s)
    assert tu.decompress(ju.compress(s)) == s
    assert tu.encrypt(s, "beacon-key", _secrets) == ju.encrypt(
        s, "beacon-key", _secrets)
    assert tu.decrypt(ju.encrypt(s, "beacon-key", _secrets), "beacon-key",
                      _secrets) == s
    ct = tu.encrypt_gcm(s, "beacon-key", _secrets)
    assert ju.decrypt_gcm(ct, "beacon-key", _secrets) == s
    assert tu.decrypt_gcm(ju.encrypt_gcm(s, "beacon-key", _secrets),
                          "beacon-key", _secrets) == s


def test_udfs_on_the_port_store(monkeypatch):
    monkeypatch.setenv("SBEACON_SECRET_BEACON_KEY", KEY)
    assert tu.env_secrets("beacon-key") == ju.env_secrets("beacon-key")
    store = MetadataStore()
    tu.register_udfs(store, _secrets)
    (got,) = store.query("SELECT decompress(compress('metadata sql'))")[0]
    assert got == "metadata sql"
    (ct,) = store.query("SELECT encrypt('pii', 'beacon-key')")[0]
    assert ct == ju.encrypt("pii", "beacon-key", _secrets)
    (pt,) = store.query("SELECT decrypt(?, 'beacon-key')", [ct])[0]
    assert pt == "pii"
    store.close()
