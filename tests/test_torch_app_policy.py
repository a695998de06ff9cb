"""The port app's policy and observability plane against the JAX app's.

``tests/torch_app_corpus.py``'s pair of apps (a data root written by the
JAX app's ``/submit``; the port on a copy of its index, metadata and
ontology) under the JAX default config with explain on behind a worker
token, tenant weights, and no canary thread. The same requests, with
the same tenant, lane and explain headers, go through both apps'
``handle``:

- deterministic bodies byte for byte, ``meta.traceId`` and
  ``meta.elapsedTimeMs`` masked as in ``tests/test_torch_app.py``: the
  Beacon routes under tenants and lanes, the explain gate's 404, 401
  and 403, the shaper's 429 under a brownout, ``/_trace`` while tracing
  is off;
- every other body (``/slo``, ``/ops/events``, ``/ops/costs``,
  ``/ops/plans``, ``/debug/status``, ``/device/status``, the explained
  plan, the slow-query records, the exposition) on its key set and its
  counters. Device launches and timings differ by nature: the port's
  CPU twins launch nothing, and a latency depends on the host.

``/fleet/status`` of a single-host app serves JAX's schema (an empty
worker map and the app's own digest); ``/fleet/migrations`` and ``POST
/fleet/migrate`` answer as JAX's app does.
"""

import copy
import json
import random

import pytest

from sbeacon_tpu.config import AuthConfig as JAuthConfig
from sbeacon_tpu.config import ObservabilityConfig as JObs
from sbeacon_tpu.config import ShapingConfig as JShaping
from sbeacon_tpu.genomics.tabix import ensure_index
from sbeacon_tpu.genomics.vcf import write_vcf
from sbeacon_tpu.testing import random_records
from sbeacon_tpu.utils.trace import tracer as jtracer
from sbeacon_tpu_torch.config import (
    AuthConfig,
    ObservabilityConfig,
    ShapingConfig,
)
from sbeacon_tpu_torch.utils.trace import tracer as ttracer
from torch_app_corpus import (
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
from torch_ingest_corpus import no_thread_leak  # noqa: F401

TOKEN = "policy-token"
GOOD = {"Authorization": f"Bearer {TOKEN}"}


def _policy(obs_cls, auth_cls, shaping_cls):
    return dict(
        auth=auth_cls(worker_token=TOKEN),
        observability=obs_cls(explain_enabled=True, canary_enabled=False),
        shaping=shaping_cls(tenant_weights="gold=4,free=1"),
    )


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    root = tmp_path_factory.mktemp("policy")
    recs = random_records(random.Random(7), chrom="22", n=120,
                          n_samples=len(SAMPLES), p_no_acan=0.3)
    vcf = root / "ds1.vcf.gz"
    write_vcf(vcf, recs, sample_names=SAMPLES)
    ensure_index(vcf)
    jax_ingest(root / "data",
               [submission("ds1", "c1", vcf, lambda i: SEX_TERMS[i % 2])],
               edges=[("HP:0000", "HP:9999"), ("HP:0001", "HP:9999")])
    port_root = copy_root(root / "data", root / "port")
    japp = open_jax(root / "data", **_policy(JObs, JAuthConfig, JShaping))
    papp = open_port(port_root, **_policy(ObservabilityConfig, AuthConfig,
                                          ShapingConfig))
    try:
        yield japp, papp, recs
    finally:
        close_port(papp)
        close_jax(japp)


def _query(recs, k, granularity):
    rec = [r for r in recs if sum(r.effective_ac()) > 0
           and not r.alts[0].startswith("<")][k]
    return {"query": {
        "requestedGranularity": granularity,
        "includeResultsetResponses": "HIT",
        "requestParameters": {
            "assemblyId": "GRCh38", "referenceName": "22",
            "start": [rec.pos - 1], "end": [rec.pos],
            "referenceBases": rec.ref.upper(),
            "alternateBases": rec.alts[0].upper()}}}


#: (method, path, query params, body kind, headers) of the traffic
TRAFFIC = [
    ("POST", "/g_variants", None, ("boolean", 0), {"X-Beacon-Tenant": "gold"}),
    ("POST", "/g_variants", None, ("record", 1), {"X-Beacon-Tenant": "free"}),
    ("POST", "/datasets/ds1/g_variants", None, ("count", 2), {}),
    ("POST", "/individuals/I1/g_variants", None, ("record", 3),
     {"X-Beacon-Tenant": "gold"}),
    ("GET", "/individuals", {"requestedGranularity": "record"}, None,
     {"X-Beacon-Tenant": "free"}),
    ("GET", "/individuals/I2", None, None, {"Authorization": "Bearer k1"}),
    ("GET", "/info", None, None, {"X-Beacon-Tenant": "bad tenant!"}),
    ("GET", "/filtering_terms", None, None, {}),
    ("POST", "/g_variants", {"explain": "1"}, ("count", 4), GOOD),
    ("POST", "/g_variants", {"explain": "1"}, ("record", 5),
     {**GOOD, "X-Beacon-Tenant": "gold"}),
    ("GET", "/nowhere", None, None, {"X-Beacon-Tenant": "gold"}),
]


def _send(japp, papp, recs, method, path, params, body, headers):
    b = None if body is None else _query(recs, body[1], body[0])
    js, jb = japp.handle(method, path, copy.deepcopy(params),
                         copy.deepcopy(b), headers=dict(headers))
    ps, pb = papp.handle(method, path, copy.deepcopy(params),
                         copy.deepcopy(b), headers=dict(headers))
    return (js, jb), (ps, pb)


def _strip_plan(body):
    body = copy.deepcopy(body)
    body.get("meta", {}).pop("executionPlan", None)
    return body


def _keys(doc, depth=2):
    """The nested key structure of a document, ``depth`` levels deep."""
    if not isinstance(doc, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in sorted(doc.items())}


def test_traffic_bodies_and_folds(apps):
    japp, papp, recs = apps
    for method, path, params, body, headers in TRAFFIC:
        (js, jb), (ps, pb) = _send(japp, papp, recs, method, path, params,
                                   body, headers)
        assert ps == js, (path, ps, js, pb)
        assert dumped(_strip_plan(pb), path) == dumped(_strip_plan(jb),
                                                       path), path
        if params and params.get("explain"):
            jp, pp = jb["meta"]["executionPlan"], pb["meta"]["executionPlan"]
            assert set(pp) == set(jp)
            # the decisions; the batch stage names each package's index
            # class and its time
            assert ([(s["stage"], s.get("decision"), s.get("reason"))
                     for s in pp["stages"] if s["stage"] != "batch"]
                    == [(s["stage"], s.get("decision"), s.get("reason"))
                        for s in jp["stages"] if s["stage"] != "batch"])
            assert pp["stages"][0] == jp["stages"][0]  # admission
        else:
            assert "executionPlan" not in pb["meta"]

    # the SLO fold: per-route availability counts equal; the latency
    # objective's total too (its good/bad split is each host's timing)
    _, jslo = japp.handle("GET", "/slo")
    _, pslo = papp.handle("GET", "/slo")
    assert _keys(pslo, 3) == _keys(jslo, 3)
    for route, doc in jslo["routes"].items():
        got = pslo["routes"][route]
        assert got["availability"] == doc["availability"], route
        for w, win in doc["latency"]["windows"].items():
            assert got["latency"]["windows"][w]["total"] == win["total"]
    # per tenant too
    for tenant in ("gold", "free", "anon"):
        _, jt = japp.handle("GET", "/slo", {"tenant": tenant})
        _, pt = papp.handle("GET", "/slo", {"tenant": tenant})
        assert {r: d["availability"] for r, d in pt["routes"].items()} == {
            r: d["availability"] for r, d in jt["routes"].items()}

    # the cost fold: the same requests under the same tenants, lanes
    # and shapes; the response bytes equal (bodies equal but for the
    # masked fields, which have the same widths here)
    _, jc = japp.handle("GET", "/ops/costs")
    _, pc = papp.handle("GET", "/ops/costs")
    assert set(pc) == set(jc)
    assert {t: d["requests"] for t, d in pc["tenants"].items()} == {
        t: d["requests"] for t, d in jc["tenants"].items()}
    assert {s: (d["lane"], d["requests"]) for s, d in pc["shapes"].items()
            } == {s: (d["lane"], d["requests"])
                  for s, d in jc["shapes"].items()}
    assert pc["totals"]["requests"] == jc["totals"]["requests"]

    # the plan fold: the same (query-shape, plan-shape) aggregates
    _, jpl = japp.handle("GET", "/ops/plans")
    _, ppl = papp.handle("GET", "/ops/plans")
    assert _keys(ppl, 1) == _keys(jpl, 1)
    assert {q: {p: v["count"] for p, v in d["plans"].items()}
            for q, d in ppl["shapes"].items()} == {
        q: {p: v["count"] for p, v in d["plans"].items()}
        for q, d in jpl["shapes"].items()}
    assert ppl["observations"] == jpl["observations"]


def test_explain_gate(apps):
    japp, papp, recs = apps
    import dataclasses

    body = ("count", 6)
    # 401 without a credential, 403 with a wrong one: byte for byte
    for headers in ({}, {"Authorization": "Bearer wrong"}):
        (js, jb), (ps, pb) = _send(japp, papp, recs, "POST", "/g_variants",
                                   {"explain": "1"}, body, headers)
        assert (ps, dumped(pb, "/g_variants")) == (
            js, dumped(jb, "/g_variants"))
        assert ps in (401, 403)
    # disabled: a 404 that looks like no such feature
    saved = (japp.config, papp.config)
    try:
        japp.config = dataclasses.replace(
            japp.config, observability=dataclasses.replace(
                japp.config.observability, explain_enabled=False))
        papp.config = dataclasses.replace(
            papp.config, observability=dataclasses.replace(
                papp.config.observability, explain_enabled=False))
        (js, jb), (ps, pb) = _send(japp, papp, recs, "POST", "/g_variants",
                                   {"explain": "1"}, body, GOOD)
        assert ps == js == 404
        assert dumped(pb, "/g_variants") == dumped(jb, "/g_variants")
    finally:
        japp.config, papp.config = saved


def test_brownout_sheds_equal(apps):
    """A paused bulk lane sheds a record request with the same 429
    envelope and Retry-After in both apps; interactive still serves."""
    japp, papp, recs = apps
    for app in (japp, papp):
        app.shaping.queue.set_brownout(bulk_paused=True)
    try:
        for body, want in ((("record", 7), 429), (("boolean", 7), 200)):
            (js, jb), (ps, pb) = _send(
                japp, papp, recs, "POST", "/g_variants", None, body,
                {"X-Beacon-Tenant": "free"})
            assert ps == js == want
            assert dumped(pb, "/g_variants") == dumped(jb, "/g_variants")
        assert papp.shaping.debug()["tenants"]["free"]["shed"] == (
            japp.shaping.debug()["tenants"]["free"]["shed"])
    finally:
        for app in (japp, papp):
            app.shaping.queue.set_brownout(bulk_paused=False)


def test_diagnostic_routes(apps):
    japp, papp, recs = apps
    _send(japp, papp, recs, "POST", "/g_variants", None, ("boolean", 8),
          {"X-Beacon-Tenant": "gold"})
    for path in ("/debug/status", "/device/status", "/ops/events"):
        js, jb = japp.handle("GET", path)
        ps, pb = papp.handle("GET", path)
        assert ps == js == 200, path
        assert set(pb) == set(jb), path
    _, jd = japp.handle("GET", "/debug/status")
    _, pd = papp.handle("GET", "/debug/status")
    # the batcher's fetch stage and fetcher pool are there, as in JAX
    assert "fetch_ms" in pd["stages"] and "fetch_ms" in jd["stages"]
    assert (set(pd["queues"]["batcher"]) == set(jd["queues"]["batcher"])
            == {"launcher", "fetcher"})
    # the sections whose shape does not hang on the launches (the
    # port's CPU twins launch nothing): key for key, three levels
    for k in ("slo", "queues", "ingest", "stages", "costs", "canary",
              "plans", "events"):
        assert _keys(pd[k], 3) == _keys(jd[k], 3), k
    # the sections of a local engine: no breakers, no routes
    assert pd["breakers"] == jd["breakers"] == {}
    assert pd["routing"] == jd["routing"] == {}
    assert pd["diagnosis"]["openBreakers"] == []
    assert set(pd["diagnosis"]) == set(jd["diagnosis"])
    assert _keys(pd["queues"], 2) == _keys(jd["queues"], 2)
    assert pd["canary"]["enabled"] is jd["canary"]["enabled"] is False
    for k in ("shed", "queued", "brownoutLevel", "bulk_paused"):
        assert pd["queues"]["shaping"][k] == jd["queues"]["shaping"][k]
    _, jdev = japp.handle("GET", "/device/status")
    _, pdev = papp.handle("GET", "/device/status")
    assert set(pdev["hbm"]) == set(jdev["hbm"])
    assert set(pdev["stacks"]) == set(jdev["stacks"])
    assert set(pdev["compiles"]) == set(jdev["compiles"])
    # the event journal's paginated read
    for params in ({"since": "0", "limit": "2"}, {"kind": "shaping,plan"},
                   {"since": "x"}):
        js, jb = japp.handle("GET", "/ops/events", params)
        ps, pb = papp.handle("GET", "/ops/events", params)
        assert ps == js
        assert set(pb) == set(jb)
    # the fleet status of a single-host app: JAX's schema, key for key
    js, jb = japp.handle("GET", "/fleet/status")
    ps, pb = papp.handle("GET", "/fleet/status")
    assert ps == js == 200
    assert set(pb) == set(jb) and set(pb["diagnosis"]) == set(
        jb["diagnosis"])
    assert set(pb["local"]) == set(jb["local"])
    assert pb["workers"] == jb["workers"] == {}
    # the migration plane of a single-host app: an empty history, and
    # a migrate refused (no controller), as in JAX
    assert papp.handle("GET", "/fleet/migrations") == japp.handle(
        "GET", "/fleet/migrations")
    assert papp.handle("GET", "/fleet/migrations")[1]["migrations"] == []
    for method in ("POST", "GET"):
        js, jb = japp.handle(method, "/fleet/migrate", None, {})
        ps, pb = papp.handle(method, "/fleet/migrate", None, {})
        assert ps == js
        assert set(pb) == set(jb)
    assert papp.handle("GET", "/ops/nope")[0] == japp.handle(
        "GET", "/ops/nope")[0]


#: JAX span name -> the port's, where the port renamed a span
PORT_SPAN = {"serving.microbatch": "kernel.launch"}


def test_trace_route_and_exemplars(apps):
    japp, papp, recs = apps
    both(japp, papp, "GET", "/_trace")  # 404 while tracing is off
    jtracer.enable()
    ttracer.enable()
    try:
        for app in (japp, papp):
            app.handle("POST", "/g_variants", None,
                       _query(recs, 9, "boolean"),
                       headers={"X-Beacon-Trace": "policy-t1"})
        js, jb = japp.handle("GET", "/_trace", {"trace_id": "policy-t1"})
        ps, pb = papp.handle("GET", "/_trace", {"trace_id": "policy-t1"})
        assert ps == js == 200
        assert set(pb) == set(jb)
        assert pb["traces"] and all(t["traceId"] == "policy-t1"
                                    for t in pb["traces"])
        # the port names its batcher's launch span ``kernel.launch``
        # where the JAX package says ``serving.microbatch``
        assert pb["traces"][0]["name"] == PORT_SPAN.get(
            jb["traces"][0]["name"], jb["traces"][0]["name"])
        # the exemplar of that request's latency bucket names its trace
        # in the OpenMetrics dialect only
        for app in (japp, papp):
            st, om = app.handle("GET", "/metrics",
                                {"format": "openmetrics"})
            st2, prom = app.handle("GET", "/metrics",
                                   {"format": "prometheus"})
            assert st == st2 == 200
            assert 'trace_id="policy-t1"' in om and om.endswith("# EOF\n")
            assert "trace_id=" not in prom
        _, jom = japp.handle("GET", "/metrics", None,
                             headers={"Accept": "application/openmetrics-"
                                                "text; version=1.0.0"})
        assert isinstance(jom, str)
    finally:
        jtracer.disable()
        ttracer.disable()
        jtracer.reset()
        ttracer.reset()


def test_metrics_exposition_families(apps):
    """The port's families are JAX's, less the fleet plane's and the
    ingest slice's, each with JAX's TYPE."""
    japp, papp, _recs = apps

    def types(text):
        out = {}
        for ln in text.splitlines():
            if ln.startswith("# TYPE "):
                _h, _t, name, kind = ln.split(" ", 3)
                out[name] = kind
        return out

    jt = types(japp.handle("GET", "/metrics", {"format": "prometheus"})[1])
    pt = types(papp.handle("GET", "/metrics", {"format": "prometheus"})[1])
    missing = set(jt) - set(pt)
    extra = set(pt) - set(jt)
    assert not extra, extra
    fleet = ("sbeacon_breaker", "sbeacon_transport", "sbeacon_dispatch",
             "sbeacon_compaction", "sbeacon_ingest", "sbeacon_batcher_fetch",
             "sbeacon_mesh", "sbeacon_fleet", "sbeacon_migration",
             "sbeacon_routing")
    assert all(m.startswith(fleet) for m in missing), sorted(missing)
    assert {k: pt[k] for k in pt} == {k: jt[k] for k in pt}
    policy = ("sbeacon_slo_", "sbeacon_cost_", "sbeacon_plan_",
              "sbeacon_canary_", "sbeacon_shaping_", "sbeacon_device_",
              "sbeacon_events_published", "sbeacon_request_slow_queries")
    for prefix in policy:
        assert any(k.startswith(prefix) for k in pt), prefix


def test_slow_query_records(apps):
    japp, papp, recs = apps
    for app in (japp, papp):
        app.slow_log.threshold_ms = 0.0
    try:
        n = (japp.slow_log.count(), papp.slow_log.count())
        _send(japp, papp, recs, "POST", "/g_variants", None, ("count", 10),
              {"X-Beacon-Tenant": "gold"})
        assert (japp.slow_log.count() - n[0], papp.slow_log.count() - n[1]
                ) == (1, 1)
        jr, pr = japp.slow_log.recent()[-1], papp.slow_log.recent()[-1]
        assert set(pr) == set(jr)
        assert (pr["route"], pr["status"]) == (jr["route"], jr["status"])
        assert set(pr["notes"]) == set(jr["notes"])
        # (batch_index names each package's index class: every port
        # shard is a ScatterDeviceIndex)
        for k in ("tenant", "lane", "granularity", "plan",
                  "response_cache"):
            assert pr["notes"][k] == jr["notes"][k], k
    finally:
        for app in (japp, papp):
            app.slow_log.threshold_ms = 1000.0
    assert json.dumps(papp._digest_extras()["canary"]) == json.dumps(
        japp._digest_extras()["canary"])
