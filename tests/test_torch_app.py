"""The port's Beacon HTTP surface held against the JAX package's.

Every read request of tests/test_api.py goes through both apps — the JAX
app on a data root its own ``/submit`` wrote, the port's app
(``sbeacon_tpu_torch.api.BeaconApp`` on a CPU engine, whose kernel
wrappers run their plain-PyTorch twins) on a copy of that root's index,
metadata and ontology (tests/torch_app_corpus.py says why never the job
table) — through ``handle`` and over real HTTP (``start_background``).
Statuses are equal and bodies equal byte for byte as ``json.dumps``
strings with key order kept, after masking ``meta.traceId``,
``meta.elapsedTimeMs`` and the creation and update times of ``/`` and
``/info``. Tolerance 0.

Beside those: the deadline header's 400s, a 429 with ``Retry-After``
while one request holds the only admission slot, the auth gate in front
of ``/submit`` and the authorised submit's answer (equal to the JAX
package's), a failing kernel launch answering 500, and the
mesh leg behind the app (the twin of
tests/test_mesh_serving.py::test_beacon_app_serves_through_mesh).
"""

import http.client
import json
import random
import threading

import pytest

from sbeacon_tpu.api import BeaconApp as JBeaconApp
from sbeacon_tpu.api.envelopes import Envelopes as JEnvelopes
from sbeacon_tpu.api.server import start_background as jstart_background
from sbeacon_tpu.config import AuthConfig as JAuthConfig
from sbeacon_tpu.genomics.tabix import ensure_index
from sbeacon_tpu.genomics.vcf import write_vcf
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.api import BeaconApp
from sbeacon_tpu_torch.api.server import start_background
from sbeacon_tpu_torch.config import (
    AuthConfig,
    ResilienceConfig,
    ShapingConfig,
)
from sbeacon_tpu_torch.harness import faults
from sbeacon_tpu_torch.parallel import mesh as tm
from torch_app_corpus import (
    CPU,
    SAMPLES,
    SEX_TERMS,
    both,
    close_jax,
    close_port,
    copy_root,
    dumped,
    jax_ingest,
    open_jax,
    open_port,
    submission,
)


class Pair:
    def __init__(self, japp, papp, recs):
        self.j, self.p, self.recs = japp, papp, recs
        self.searches = 0
        search = papp.engine.search

        def counted(payload):
            self.searches += 1
            return search(payload)

        papp.engine.search = counted

    def both(self, method, path, query_params=None, body=None, headers=None):
        return both(self.j, self.p, method, path, query_params, body, headers)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("beacon")
    recs = random_records(
        random.Random(5), chrom="22", n=120, n_samples=len(SAMPLES),
        p_no_acan=0.3,
    )
    vcf = root / "ds1.vcf.gz"
    write_vcf(vcf, recs, sample_names=SAMPLES)
    ensure_index(vcf)
    jax_ingest(root / "data",
               [submission("ds1", "c1", vcf, lambda i: SEX_TERMS[i % 2])],
               edges=[("HP:0000", "HP:9999"), ("HP:0001", "HP:9999")])
    port_root = copy_root(root / "data", root / "port")
    japp = open_jax(root / "data")
    papp = open_port(port_root)
    yield Pair(japp, papp, recs)
    close_port(papp)
    close_jax(japp)


def _hit_query(recs, granularity="boolean", include="NONE"):
    """A query guaranteed to hit: first record with nonzero AC."""
    rec = next(
        r for r in recs
        if sum(r.effective_ac()) > 0 and not r.alts[0].startswith("<")
    )
    return rec, {
        "query": {
            "requestedGranularity": granularity,
            "includeResultsetResponses": include,
            "requestParameters": {
                "assemblyId": "GRCh38",
                "referenceName": "22",
                "start": [rec.pos - 1],
                "end": [rec.pos],
                "referenceBases": rec.ref.upper(),
                "alternateBases": rec.alts[0].upper(),
            },
        }
    }


def _carries(gt: str) -> bool:
    return any(t == "1" for t in gt.replace("|", "/").split("/"))


def test_framework_endpoints(pair):
    for path in ("/", "/info", "/configuration", "/map", "/entry_types"):
        status, body = pair.both("GET", path)
        assert status == 200
        assert body["meta"]["beaconId"] == pair.p.config.info.beacon_id
    _, m = pair.both("GET", "/map")
    assert len(m["response"]["endpointSets"]) == 7


def test_filtering_terms(pair):
    _, body = pair.both("GET", "/filtering_terms")
    ids = {t["id"] for t in body["response"]["filteringTerms"]}
    assert "NCIT:C16576" in ids and "HP:0000" in ids
    pair.both("GET", "/filtering_terms", {"skip": "1", "limit": "2"})
    pair.both("GET", "/individuals/filtering_terms")
    pair.both("GET", "/biosamples/filtering_terms")
    _, body = pair.both("GET", "/datasets/ds1/filtering_terms")
    assert "HP:0000" in {t["id"] for t in body["response"]["filteringTerms"]}
    pair.both("GET", "/cohorts/c1/filtering_terms")


def test_entity_collections(pair):
    _, body = pair.both("GET", "/individuals",
                        {"requestedGranularity": "count"})
    assert body["responseSummary"] == {
        "exists": True, "numTotalResults": len(SAMPLES)}
    _, body = pair.both("GET", "/individuals",
                        {"requestedGranularity": "record", "limit": "3"})
    assert body["response"]["resultSets"][0]["resultsCount"] == 3
    pair.both("GET", "/individuals",
              {"requestedGranularity": "record", "skip": "2", "limit": "3"})
    _, body = pair.both("POST", "/individuals", body={"query": {
        "requestedGranularity": "count", "filters": [{"id": "NCIT:C16576"}]}})
    assert body["responseSummary"]["numTotalResults"] == 3
    # an ontology parent expands to its descendants (the registered edges)
    _, body = pair.both("POST", "/individuals", body={"query": {
        "requestedGranularity": "record", "filters": [{"id": "HP:9999"}]}})
    assert body["responseSummary"]["numTotalResults"] == len(SAMPLES)
    pair.both("POST", "/individuals", body={"query": {
        "requestedGranularity": "boolean",
        "filters": [{"id": "HP:0001", "includeDescendantTerms": False}]}})
    for kind in ("datasets", "cohorts", "biosamples", "runs", "analyses"):
        pair.both("GET", f"/{kind}")
        pair.both("GET", f"/{kind}", {"requestedGranularity": "record"})


def test_entity_by_id_and_cross_entity(pair):
    _, body = pair.both("GET", "/individuals/I0",
                        {"requestedGranularity": "record"})
    assert body["response"]["resultSets"][0]["results"][0]["id"] == "I0"
    _, body = pair.both("GET", "/datasets/ds1/individuals",
                        {"requestedGranularity": "count"})
    assert body["responseSummary"]["numTotalResults"] == len(SAMPLES)
    for path, want in (("/individuals/I2/biosamples", ["B2"]),
                       ("/biosamples/B3/runs", ["R3"]),
                       ("/runs/R1/analyses", ["A1"]),
                       ("/biosamples/B1/analyses", ["A1"])):
        _, body = pair.both("GET", path, {"requestedGranularity": "record"})
        got = [r["id"] for r in body["response"]["resultSets"][0]["results"]]
        assert got == want, path
    pair.both("GET", "/datasets/ds1/biosamples",
              {"requestedGranularity": "record", "limit": "2"})
    _, body = pair.both("GET", "/cohorts/c1/individuals",
                        {"requestedGranularity": "count"})
    assert body["responseSummary"]["numTotalResults"] == len(SAMPLES)
    _, body = pair.both("GET", "/individuals/NOPE")
    assert body["responseSummary"]["exists"] is False
    pair.both("GET", "/datasets/ds1", {"requestedGranularity": "record"})
    pair.both("GET", "/cohorts/c1/g_variants")  # no such route: 404


def test_g_variants_boolean_and_record(pair):
    rec, q = _hit_query(pair.recs)
    status, body = pair.both("POST", "/g_variants", body=q)
    assert status == 200 and body["responseSummary"]["exists"] is True
    _, q = _hit_query(pair.recs, "record", "HIT")
    _, body = pair.both("POST", "/g_variants", body=q)
    results = body["response"]["resultSets"][0]["results"]
    assert results and results[0]["variation"]["referenceBases"] == rec.ref
    _, body = pair.both("POST", "/g_variants", body={"query": {
        "requestedGranularity": "boolean",
        "requestParameters": {"assemblyId": "GRCh38", "referenceName": "21",
                              "start": [5], "end": [6],
                              "alternateBases": "T"}}})
    assert body["responseSummary"]["exists"] is False
    # a wide bracket at every granularity and resultset mode, paged
    for gran in ("boolean", "count", "record"):
        for include in ("NONE", "HIT", "ALL"):
            pair.both("POST", "/g_variants", body={"query": {
                "requestedGranularity": gran,
                "includeResultsetResponses": include,
                "pagination": {"skip": 1, "limit": 4},
                "requestParameters": {
                    "assemblyId": "GRCh38", "referenceName": "22",
                    "start": [0, 10_000_000], "end": [0, 10_000_000],
                    "alternateBases": "N"}}})


def test_g_variants_filtered_selected_samples(pair):
    """A filter resolves to analyses' VCF samples: the selected-samples
    search over the datasets they belong to."""
    ind = {"scope": "individuals"}
    for filters in ([{"id": "NCIT:C16576", **ind}], [{"id": "HP:9999", **ind}],
                    [{"id": "NCIT:C20197", **ind}, {"id": "HP:0001", **ind}],
                    [{"id": "HP:0000", **ind, "includeDescendantTerms": False}],
                    [{"id": "NCIT:C0000", **ind}], [{"id": "NCIT:C16576"}]):
        for gran in ("boolean", "count", "record"):
            pair.both("POST", "/g_variants", body={"query": {
                "requestedGranularity": gran,
                "includeResultsetResponses": "HIT",
                "filters": filters,
                "requestParameters": {
                    "assemblyId": "GRCh38", "referenceName": "22",
                    "start": [0, 10_000_000], "end": [0, 10_000_000],
                    "alternateBases": "N"}}})
    # the sex filter selects the even samples: the search ran with them
    status, body = pair.both("POST", "/g_variants", body={"query": {
        "requestedGranularity": "record", "includeResultsetResponses": "HIT",
        "filters": [{"id": "NCIT:C16576", **ind}],
        "requestParameters": {"assemblyId": "GRCh38", "referenceName": "22",
                              "start": [0, 10_000_000],
                              "end": [0, 10_000_000],
                              "alternateBases": "N"}}})
    assert status == 200 and body["responseSummary"]["exists"] is True


def test_g_variants_get_form(pair):
    rec, _ = _hit_query(pair.recs)
    _, body = pair.both("GET", "/g_variants", {
        "assemblyId": "GRCh38", "referenceName": "22",
        "start": str(rec.pos - 1), "end": str(rec.pos),
        "referenceBases": rec.ref.upper(),
        "alternateBases": rec.alts[0].upper(),
        "requestedGranularity": "count",
        "includeResultsetResponses": "HIT",
    })
    assert body["responseSummary"]["exists"] is True
    assert body["responseSummary"]["numTotalResults"] >= 1


def test_g_variants_id_roundtrip(pair):
    rec, q = _hit_query(pair.recs, "record", "HIT")
    _, body = pair.both("POST", "/g_variants", body=q)
    vid = body["response"]["resultSets"][0]["results"][0]["variantInternalId"]
    _, body = pair.both("GET", f"/g_variants/{vid}",
                        {"requestedGranularity": "boolean"})
    assert body["responseSummary"]["exists"] is True
    pair.both("GET", f"/g_variants/{vid}", {"requestedGranularity": "record"})
    _, body = pair.both("GET", f"/g_variants/{vid}/individuals",
                        {"requestedGranularity": "record"})
    carriers = {r["id"] for r in body["response"]["resultSets"][0]["results"]}
    want = {f"I{i}" for i, gt in enumerate(rec.genotypes) if _carries(gt)}
    if want:
        assert carriers == want
    _, body = pair.both("GET", f"/g_variants/{vid}/biosamples",
                        {"requestedGranularity": "count"})
    assert body["responseSummary"]["numTotalResults"] == len(want)
    pair.both("GET", "/g_variants/not-base64!")  # malformed id: 400
    pair.both("GET", f"/g_variants/{vid}/runs")  # no such route: 404


def test_scoped_g_variants(pair):
    rec = next(
        r for r in pair.recs
        if _carries(r.genotypes[0]) and not r.alts[0].startswith("<")
    )
    q = {"query": {"requestedGranularity": "boolean", "requestParameters": {
        "assemblyId": "GRCh38", "referenceName": "22",
        "start": [rec.pos - 1], "end": [rec.pos],
        "alternateBases": rec.alts[0].upper()}}}
    for path in ("/individuals/I0/g_variants", "/datasets/ds1/g_variants",
                 "/analyses/A0/g_variants", "/runs/R0/g_variants",
                 "/biosamples/B0/g_variants"):
        _, body = pair.both("POST", path, body=q)
        assert body["responseSummary"]["exists"] is True, path
    for i in range(len(SAMPLES)):
        pair.both("POST", f"/individuals/I{i}/g_variants", body=q)
    pair.both("POST", "/individuals/NOPE/g_variants", body=q)
    wide = {"query": {"requestedGranularity": "record",
                      "includeResultsetResponses": "HIT",
                      "requestParameters": {
                          "assemblyId": "GRCh38", "referenceName": "22",
                          "start": [0, 10_000_000], "end": [0, 10_000_000],
                          "alternateBases": "N"}}}
    pair.both("POST", "/individuals/I1/g_variants", body=wide)
    pair.both("POST", "/datasets/ds1/g_variants", body=wide)


def test_errors(pair):
    status, _ = pair.both("POST", "/g_variants", body={"query": {}})
    assert status == 400
    status, _ = pair.both("GET", "/nope")
    assert status == 404
    status, _ = pair.both("GET", "/individuals",
                          {"requestedGranularity": "bogus"})
    assert status == 400
    pair.both("GET", "/schemas/nope")
    pair.both("GET", "/individuals/I0/nope")


def test_post_body_schema_validation(pair):
    bad = [
        {"query": {"requestedGranularity": "bogus"}},
        {"query": {"requestParameters": {"alternateBases": "XYZ"}}},
        {"query": {"pagination": {"skip": -1}}},
        {"query": {"filters": [{"scope": "individuals"}]}},
        {"query": {"requestParameters": {"start": [1, 2, 3]}}},
        {"query": {"requestParameters": {"start": ["x"]}}},
        {"query": {"includeResultsetResponses": "SOME"}},
    ]
    for body in bad:
        status, _ = pair.both("POST", "/individuals", body=body)
        assert status == 400, body
    status, _ = pair.both("POST", "/individuals", body={
        "query": {"requestParameters": {"alternateBases": "acgtRY"}}})
    assert status == 200


def test_lowercase_alleles_normalised(pair):
    rec, q = _hit_query(pair.recs)
    rp = q["query"]["requestParameters"]
    rp["alternateBases"] = rp["alternateBases"].lower()
    rp["referenceBases"] = rec.ref.lower()
    _, body = pair.both("POST", "/g_variants", body=q)
    assert body["responseSummary"]["exists"] is True


def test_lowercase_variant_type_normalised(pair):
    for vt in ("del", "DEL", "ins", "INS", "snp"):
        pair.both("POST", "/g_variants", body={"query": {
            "requestParameters": {"assemblyId": "GRCh38",
                                  "referenceName": "22", "start": [1],
                                  "end": [100000000], "variantType": vt},
            "requestedGranularity": "boolean"}})


def test_entity_schemas_served_and_referenced(pair):
    _, listing = pair.both("GET", "/schemas")
    assert len(listing["entityTypes"]) == 7
    for entity in listing["schemas"]:
        pair.both("GET", f"/schemas/{entity}")
    _, q = _hit_query(pair.recs, "record", "HIT")
    _, body = pair.both("POST", "/g_variants", body=q)
    assert body["meta"]["returnedSchemas"][0]["entityType"] == "genomicVariant"


def test_health_endpoint(pair):
    status, body = pair.both("GET", "/health")
    assert status == 200 and body["ok"] is True
    status, body = pair.both("GET", "/ready")
    assert status == 200 and body["shards"] == 1


def test_port_computes_every_variant_request(pair):
    """The port's root holds no job table of the JAX package's: every
    new variant request runs the port's engine."""
    before = pair.searches
    for k in range(3):
        pair.both("POST", "/g_variants", body={"query": {
            "requestedGranularity": "count",
            "includeResultsetResponses": "HIT",
            "requestParameters": {
                "assemblyId": "GRCh38", "referenceName": "22",
                "start": [k, 9_000_000 + k], "end": [k, 9_000_000 + k],
                "alternateBases": "N"}}})
    assert pair.searches == before + 3


def test_deadline_header_400s(pair):
    q = _hit_query(pair.recs)[1]
    for raw in ("nan", "NaN", "inf", "-inf", "0", "-1", "abc", ""):
        status, _ = pair.both("POST", "/g_variants", body=q,
                              headers={"X-Beacon-Deadline": raw})
        assert status == 400, raw
    status, _ = pair.both("POST", "/g_variants", body=q,
                          headers={"x-beacon-deadline": "30"})
    assert status == 200
    # the probes bypass the deadline (and admission)
    status, _ = pair.both("GET", "/health",
                          headers={"X-Beacon-Deadline": "nan"})
    assert status == 200


def test_trace_header_honoured(pair):
    _, body = pair.p.handle("GET", "/info",
                            headers={"X-Beacon-Trace": "abc-123"})
    assert body["meta"]["traceId"] == "abc-123"
    _, body = pair.p.handle("GET", "/info",
                            headers={"X-Beacon-Trace": "bad trace\r\n"})
    assert body["meta"]["traceId"] != "bad trace\r\n"
    assert isinstance(body["meta"]["elapsedTimeMs"], float)


def _variant_post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), json.loads(r.read())
    finally:
        conn.close()


def test_admission_sheds_429_with_retry_after(pair):
    """max_in_flight=1 and one request held inside the engine: the next
    request is shed by the global admission gate with 429 and a
    Retry-After header equal to the envelope's retryAfterSeconds; the
    probes still answer. Shaping is off: with it on (the default) the
    fair queue, whose running cap is the same max_in_flight, would queue
    the request ahead of the gate (its sheds are held in
    tests/test_torch_app_policy.py)."""
    papp = open_port(pair.p.config.storage.root,
                     resilience=ResilienceConfig(max_in_flight=1,
                                                 shed_retry_after_s=0.25),
                     shaping=ShapingConfig(enabled=False))
    entered, release = threading.Event(), threading.Event()
    search = papp.engine.search

    def held(payload):
        entered.set()
        assert release.wait(30)
        return search(payload)

    papp.engine.search = held
    server, _ = start_background(papp)
    port = server.server_address[1]
    try:
        # a query no earlier test sent: the job table (shared with the
        # module's port app, one root) has no answer for it
        q = {"query": {"requestedGranularity": "count",
                       "includeResultsetResponses": "HIT",
                       "requestParameters": {
                           "assemblyId": "GRCh38", "referenceName": "22",
                           "start": [11, 7_000_011], "end": [11, 7_000_011],
                           "alternateBases": "N"}}}
        t = threading.Thread(target=_variant_post,
                             args=(port, "/g_variants", q))
        t.start()
        assert entered.wait(30)
        status, headers, body = _variant_post(port, "/g_variants", q)
        assert status == 429
        assert body["retryAfterSeconds"] == 1
        assert headers["Retry-After"] == "1"
        want = JEnvelopes(pair.j.config.info).error(
            429, "server at capacity (1 in flight)")
        want["meta"].update(traceId="", elapsedTimeMs=0.0)
        want["retryAfterSeconds"] = 1
        assert dumped(body, "/g_variants") == dumped(want, "/g_variants")
        assert papp.handle("GET", "/ready")[1]["inFlight"] == 1
        release.set()
        t.join(30)
        assert papp.admission.metrics()["shed"] == 1
        assert papp.handle("GET", "/metrics")[1]["admission"]["shed"] == 1
    finally:
        release.set()
        server.shutdown()
        server.server_close()
        close_port(papp)


def test_kernel_failure_is_a_500(pair):
    """A failing launch gives the request the 500 envelope, never a
    quiet answer from the host."""
    body = {"query": {"requestedGranularity": "count",
                      "includeResultsetResponses": "HIT",
                      "requestParameters": {
                          "assemblyId": "GRCh38", "referenceName": "22",
                          "start": [7, 8_000_007], "end": [7, 8_000_007],
                          "alternateBases": "N"}}}
    inj = faults.install({"rules": [{"site": "kernel.launch"}]})
    try:
        status, out = pair.p.handle("POST", "/g_variants", body=body)
    finally:
        faults.uninstall()
    assert status == 500
    assert out["error"]["errorCode"] == 500
    assert out["error"]["errorMessage"].startswith(
        "FaultError: injected kernel.launch failure")
    # the query job's search failed, and so did the direct re-run
    assert inj.stats()["kernel.launch[0]"]["activations"] >= 2
    pair.both("POST", "/g_variants", body=body)


def test_http_roundtrip_equals_handle(pair):
    """The same requests over both servers: equal statuses and bodies
    (masked), the port's equal to its own in-process answer."""
    jserver, _ = jstart_background(pair.j)
    pserver, _ = start_background(pair.p)
    try:
        rec, q = _hit_query(pair.recs, "record", "HIT")
        vid = pair.p.handle("POST", "/g_variants", body=q)[1][
            "response"]["resultSets"][0]["results"][0]["variantInternalId"]
        requests = [
            ("GET", "/info", None), ("GET", "/", None),
            ("GET", "/map", None), ("GET", "/filtering_terms", None),
            ("GET", "/individuals?requestedGranularity=record&limit=2", None),
            ("GET", "/individuals/I3", None),
            ("GET", "/biosamples/B1/runs?requestedGranularity=record", None),
            ("POST", "/g_variants", q),
            ("POST", "/datasets/ds1/g_variants", q),
            ("POST", "/individuals/I0/g_variants", q),
            ("GET", f"/g_variants/{vid}?requestedGranularity=record", None),
            ("GET", f"/g_variants/{vid}/individuals"
                    "?requestedGranularity=record", None),
            ("POST", "/g_variants", {"query": {}}),
            ("GET", "/nope", None), ("GET", "/health", None),
        ]
        conns = [http.client.HTTPConnection("127.0.0.1",
                                            s.server_address[1], timeout=30)
                 for s in (jserver, pserver)]
        for method, path, body in requests:
            got = []
            for conn in conns:
                conn.request(method, path,
                             body=None if body is None else json.dumps(body),
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                assert r.getheader("Access-Control-Allow-Origin") == "*"
                got.append((r.status, json.loads(r.read())))
            (js, jb), (ps, pb) = got
            bare = path.split("?")[0]
            assert ps == js, path
            assert dumped(pb, bare) == dumped(jb, bare), path
        for conn in conns:
            conn.close()
        conn = http.client.HTTPConnection("127.0.0.1",
                                          pserver.server_address[1])
        conn.request("OPTIONS", "/g_variants")
        r = conn.getresponse()
        r.read()
        assert r.status == 204
        assert "X-Beacon-Deadline" in r.getheader(
            "Access-Control-Allow-Headers")
        conn.close()
    finally:
        for s in (jserver, pserver):
            s.shutdown()
            s.server_close()


def test_submit_auth_token(tmp_path, pair):
    """A configured submit token: the port's 401 and 403 bodies equal
    the JAX package's; with the token the port's answer (a 400: the VCF
    does not exist) equals the JAX package's, in process and over
    HTTP."""
    sub = submission("dsA", "cA", "/nonexistent.vcf.gz",
                     lambda i: SEX_TERMS[i % 2])
    root = copy_root(pair.j.config.storage.root, tmp_path / "port")
    japp = open_jax(pair.j.config.storage.root,
                    auth=JAuthConfig(submit_token="hunter2"))
    papp = open_port(root, auth=AuthConfig(submit_token="hunter2"))
    try:
        status, body = both(japp, papp, "POST", "/submit", body=sub)
        assert status == 401 and body["error"]["errorCode"] == 401
        status, _ = both(japp, papp, "PATCH", "/submit", body=sub)
        assert status == 401
        status, _ = both(japp, papp, "POST", "/submit", body=sub,
                         headers={"Authorization": "Bearer wrong"})
        assert status == 403
        status, body = both(japp, papp, "POST", "/submit", body=sub,
                            headers={"authorization": "Bearer hunter2"})
        assert status == 400
        assert "Could not find file" in body["error"]["errorMessage"]
        assert both(japp, papp, "GET", "/datasets")[0] == 200
        # over HTTP: header casing of a real transport, and a 401 PATCH
        server, _ = start_background(papp)
        try:
            port = server.server_address[1]
            status, _, got = _variant_post(
                port, "/submit", sub, {"authorization": "Bearer hunter2"})
            jstatus, want = japp.handle(
                "POST", "/submit", body=sub,
                headers={"authorization": "Bearer hunter2"})
            assert status == jstatus == 400
            assert dumped(got, "/submit") == dumped(want, "/submit")
            conn = http.client.HTTPConnection("127.0.0.1", port)
            conn.request("PATCH", "/submit", body=json.dumps(sub),
                         headers={"Content-Type": "application/json"})
            assert conn.getresponse().status == 401
            conn.close()
        finally:
            server.shutdown()
            server.server_close()
    finally:
        close_port(papp)
        close_jax(japp)


def test_custom_auth_verifier(tmp_path, pair):
    seen = []

    def verifier(method, path, headers):
        seen.append((method, path))
        return headers.get("X-User") == "admin", "not admin"

    japp = JBeaconApp(pair.j.config, engine=pair.j.engine,
                      store=pair.j.store, ontology=pair.j.ontology,
                      auth_verifier=verifier)
    papp = BeaconApp(pair.p.config, engine=pair.p.engine,
                     store=pair.p.store, ontology=pair.p.ontology,
                     auth_verifier=verifier)
    try:
        status, _ = both(japp, papp, "POST", "/submit",
                         body={"datasetId": "x"},
                         headers={"X-User": "nobody"})
        assert status == 401
        status, body = both(japp, papp, "POST", "/submit",
                            body={"datasetId": "x"},
                            headers={"X-User": "nobody",
                                     "Authorization": "Bearer whatever"})
        assert status == 403
        assert "not admin" in body["error"]["errorMessage"]
        status, body = both(japp, papp, "POST", "/submit",
                            body={"datasetId": "x"},
                            headers={"X-User": "admin",
                                     "Authorization": "Bearer whatever"})
        assert status == 400
        assert "'assemblyId' is a required property" in \
            body["error"]["errorMessage"]
        assert len(seen) == 6
    finally:
        japp.close()
        papp.close()


def test_app_rejects_shardless_engine():
    class QueryOnly:
        def search(self, p):
            return []

    with pytest.raises(ValueError, match="add_index"):
        BeaconApp(engine=QueryOnly())


def test_beacon_app_serves_through_mesh(tmp_path, monkeypatch):
    """Two datasets submitted through the JAX app; the port's app on a
    copy of the root with its mesh patched to [cpu, cpu]: a /g_variants
    POST over both runs the mesh leg (mesh_searches + 1) with the JAX
    app's body."""
    monkeypatch.setattr(tm, "mesh_devices", lambda device=None: [CPU, CPU])
    subs = []
    for d in range(2):
        recs = random_records(random.Random(70 + d), chrom="22", n=80,
                              n_samples=len(SAMPLES))
        vcf = tmp_path / f"m{d}.vcf.gz"
        write_vcf(vcf, recs, sample_names=SAMPLES)
        ensure_index(vcf)
        subs.append({"datasetId": f"m{d}", "assemblyId": "GRCh38",
                     "vcfLocations": [str(vcf)],
                     "dataset": {"id": f"m{d}", "name": f"M{d}"},
                     "index": True})
    jax_ingest(tmp_path / "data", subs)
    papp = open_port(copy_root(tmp_path / "data", tmp_path / "port"))
    japp = open_jax(tmp_path / "data")
    try:
        before = papp.engine.mesh_searches
        jbefore = japp.engine.mesh_searches
        status, body = both(japp, papp, "POST", "/g_variants", body={
            "query": {"requestedGranularity": "count",
                      "requestParameters": {
                          "assemblyId": "GRCh38", "referenceName": "22",
                          "start": [1, 1 << 30], "end": [1, 1 << 30],
                          "alternateBases": "N"}}})
        assert status == 200 and body["responseSummary"]["exists"] is True
        assert papp.engine.mesh_searches == before + 1
        assert japp.engine.mesh_searches == jbefore + 1
        both(japp, papp, "POST", "/g_variants", body={
            "query": {"requestedGranularity": "record",
                      "includeResultsetResponses": "ALL",
                      "requestParameters": {
                          "assemblyId": "GRCh38", "referenceName": "22",
                          "start": [1, 1 << 30], "end": [1, 1 << 30],
                          "alternateBases": "N"}}})
    finally:
        close_port(papp)
        close_jax(japp)
