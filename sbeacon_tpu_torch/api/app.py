"""The Beacon v2 application: one router over the read surface.

Counterpart of ``sbeacon_tpu/api/app.py`` (``:94-398, 521-767, 768-800,
1159-1172, 1207-1616``), trimmed to the Beacon routes and the pieces of
the policy plane every request goes through:

    /  /info  /configuration  /map  /entry_types  /filtering_terms
    /schemas  /schemas/{entity}
    /{entity}                        x {datasets, cohorts, individuals,
    /{entity}/filtering_terms           biosamples, runs, analyses}
    /{entity}/{id}
    /{entity}/{id}/{sub}             (cross-entity joins + scoped g_variants)
    /g_variants  /g_variants/{id}  /g_variants/{id}/{biosamples,individuals}
    /health  /ready  /metrics        (probes: no auth, admission, deadline)

with the submit auth gate, the ``X-Beacon-Deadline`` header, the
admission gate, the trace id of ``X-Beacon-Trace`` and the error mapping
to 400/429/503/504/500. ``/submit`` answers 501 until the ingest slice
is ported (the auth gate still runs first). Traffic shaping, cost
accounting, SLOs, execution plans and explain, the canary, the
slow-query log, Prometheus exposition and the diagnostic routes
(``/_trace``, ``/slo``, ``/ops/*``, ``/debug/status``,
``/device/status``, ``/fleet/*``) are not ported: those paths answer
the router's 404.

Every handler returns ``(status_code, body_dict)``; transport (the HTTP
server, tests) is external.
"""

from __future__ import annotations

import hmac
import math
import time
from pathlib import Path

from ..config import BeaconConfig, StorageConfig
from ..engine import VariantEngine
from ..harness import faults
from ..ingest.service import IngestService, VcfLocationError
from ..metadata import MetadataStore, OntologyStore
from ..metadata.filters import FilterError
from ..query_jobs import AsyncQueryRunner, QueryJobTable
from ..resilience import (
    NO_DEADLINE,
    AdmissionController,
    Deadline,
    ResilienceError,
    deadline_scope,
    register_admission_metrics,
)
from ..telemetry import (
    MetricsRegistry,
    RequestContext,
    request_context,
    sanitize_trace_id,
)
from ..utils.trace import span
from .envelopes import Envelopes
from .framework import (
    configuration_response,
    entry_types_response,
    info_response,
    map_response,
)
from .requests import BeaconRequest, RequestError, parse_request
from .variants import decode_internal_id, resolve_datasets, run_variant_search

ENTITY_PATHS = {
    "datasets",
    "cohorts",
    "individuals",
    "biosamples",
    "runs",
    "analyses",
}

_SET_TYPE = {
    "datasets": "dataset",
    "cohorts": "cohort",
    "individuals": "individuals",
    "biosamples": "biosamples",
    "runs": "runs",
    "analyses": "analyses",
    "g_variants": "genomicVariant",
}

# {parent}/{id}/{child} metadata joins: child rows whose ``column`` = id
_CROSS_ENTITY: dict[tuple[str, str], tuple[str, str]] = {
    ("datasets", "individuals"): ("individuals", "_datasetid"),
    ("datasets", "biosamples"): ("biosamples", "_datasetid"),
    ("cohorts", "individuals"): ("individuals", "_cohortid"),
    ("individuals", "biosamples"): ("biosamples", "individualid"),
    ("biosamples", "analyses"): ("analyses", "biosampleid"),
    ("biosamples", "runs"): ("runs", "biosampleid"),
    ("runs", "analyses"): ("analyses", "runid"),
}

#: the probes: GET only, served before auth, admission and deadlines
PROBE_PATHS = frozenset({"health", "ready", "metrics"})


def strip_private(doc: dict) -> dict:
    """Drop '_'-prefixed internal fields."""
    return {k: v for k, v in doc.items() if not k.startswith("_")}


def _header(headers: dict | None, name: str) -> str | None:
    """Case-insensitive single-header lookup over a plain dict."""
    name = name.lower()
    for k, v in (headers or {}).items():
        if k.lower() == name:
            return v
    return None


def _authorization_header(headers: dict) -> str:
    return _header(headers, "authorization") or ""


def bearer_token_verifier(token: str):
    """Default auth hook: require ``Authorization: Bearer <token>``.

    Returns a verifier ``(method, path, headers) -> (authorized, reason)``;
    deployments needing real identity (OIDC, mTLS) pass their own
    callable as ``BeaconApp(auth_verifier=...)``.
    """

    def verify(method: str, path: str, headers: dict) -> tuple[bool, str]:
        got = _authorization_header(headers)
        # constant-time compare, on bytes: compare_digest raises
        # TypeError on non-ASCII str, which would turn a malformed
        # header into a 500
        if not hmac.compare_digest(
            got.encode(), f"Bearer {token}".encode()
        ):
            return False, "invalid token"
        return True, ""

    return verify


class BeaconApp:
    """The Beacon routes over a metadata store and a variant engine.

    Without ``engine=`` the app builds a ``VariantEngine`` on ``device``
    (the GPU by default, raising where there is none; ``device="cpu"``
    for the plain-PyTorch twins). The engine may be caller-owned and is
    not closed by :meth:`close`.
    """

    def __init__(
        self,
        config: BeaconConfig | None = None,
        *,
        store: MetadataStore | None = None,
        ontology: OntologyStore | None = None,
        engine: VariantEngine | None = None,
        ingest: IngestService | None = None,
        auth_verifier=None,
        device=None,
    ):
        if config is None:
            # configless (ad hoc / test) apps keep sqlite in memory and
            # the job table under a throwaway temp root, removed when
            # the app is garbage-collected
            import tempfile

            config_given = False
            self._tmp_root = tempfile.TemporaryDirectory(prefix="beacon-")
            self.config = BeaconConfig(
                storage=StorageConfig(root=Path(self._tmp_root.name))
            )
        else:
            config_given = True
            self.config = config
        storage = self.config.storage
        if ontology is None:
            ontology = (
                OntologyStore(storage.ontology_db)
                if config_given
                else OntologyStore()
            )
        self.ontology = ontology
        if store is None:
            store = (
                MetadataStore(storage.metadata_db, ontology=self.ontology)
                if config_given
                else MetadataStore(ontology=self.ontology)
            )
        elif store.ontology is None:
            store.ontology = self.ontology
        self.store = store
        self.engine = engine or VariantEngine(self.config, device=device)
        if ingest is None and not hasattr(self.engine, "add_index"):
            # fail at wiring time, not on the first load
            raise ValueError(
                "engine cannot host index shards (no add_index): pass a "
                "VariantEngine or an explicit ingest= service"
            )
        self.ingest = ingest or IngestService(self.config, engine=self.engine)
        self.env = Envelopes(self.config.info)
        # async query job table: coalesces concurrent identical queries,
        # caches results for the query TTL, spills oversized response
        # sets to query_results_dir
        storage.ensure()
        self.query_jobs = QueryJobTable(
            storage.root / "query-jobs.sqlite",
            spill_dir=storage.query_results_dir,
            inline_limit=self.config.engine.max_response_inline_bytes,
        )
        self.query_runner = AsyncQueryRunner(self.engine, self.query_jobs)
        # bounded in-flight admission + request deadlines; the probes
        # bypass both so they answer while the server is saturated
        res = self.config.resilience
        self.admission = AdmissionController(
            res.max_in_flight, retry_after_s=res.shed_retry_after_s
        )
        # readiness flag: constructed apps are servable; a deployment
        # may clear it during reload/drain so load balancers back off
        self.ready = True
        self.telemetry = MetricsRegistry()
        self._register_metrics()
        # mutating-route auth: explicit verifier > config token > open
        if auth_verifier is not None:
            self.auth_verifier = auth_verifier
        elif self.config.auth.submit_token:
            self.auth_verifier = bearer_token_verifier(
                self.config.auth.submit_token
            )
        else:
            self.auth_verifier = None

    def close(self) -> None:
        """Release app-owned resources: the async runner's worker pool
        and the job table. The engine is NOT closed here."""
        self.query_runner.close()
        self.query_jobs.close()
        self.ingest.close()

    def _register_metrics(self) -> None:
        """Wire the app's, the admission gate's, the runner's and the
        engine's instruments into this app's registry. Suppliers read
        through ``self`` so a component swapped at runtime (tests replace
        ``app.admission``) stays observable."""
        reg = self.telemetry
        self._req_latency = reg.histogram(
            "request.latency_ms",
            "end-to-end request latency per route",
            label="route",
            # entity heads x sub-routes top the default 64-value guard
            max_label_values=128,
        )
        register_admission_metrics(reg, lambda: self.admission)
        self.query_runner.register_metrics(reg)
        engine_reg = getattr(self.engine, "register_metrics", None)
        if engine_reg is not None:
            engine_reg(reg)

    #: bounded route-label set for the latency histogram — unknown
    #: paths collapse to "other" so a URL scanner cannot mint series
    _ROUTE_HEADS = ENTITY_PATHS | {
        "info",
        "configuration",
        "map",
        "entry_types",
        "filtering_terms",
        "schemas",
        "submit",
        "g_variants",
    } | PROBE_PATHS

    def _route_label(self, path: str) -> str:
        parts = [p for p in path.strip("/").split("/") if p]
        if not parts:
            return "info"
        head = parts[0]
        if head not in self._ROUTE_HEADS:
            return "other"
        if len(parts) == 1:
            return head
        sub = parts[-1]
        if sub in ("filtering_terms", "g_variants", "biosamples",
                   "individuals", "runs", "analyses"):
            return f"{head}.{sub}"
        return f"{head}.id"

    # -- transport-facing entry --------------------------------------------

    def handle(
        self,
        method: str,
        path: str,
        query_params: dict | None = None,
        body: dict | None = None,
        headers: dict | None = None,
    ) -> tuple[int, dict]:
        """One request end to end, under a request context whose trace id
        is minted here (or honored from an inbound ``X-Beacon-Trace``
        header) and returns in the envelope's ``meta`` beside the
        elapsed time."""
        t0 = time.perf_counter()
        route = self._route_label(path)
        ctx = RequestContext(
            trace_id=sanitize_trace_id(_header(headers, "x-beacon-trace")),
            route=route,
        )
        with request_context(ctx):
            status, payload = self._handle(
                method, path, query_params, body, headers
            )
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        self._req_latency.observe(elapsed_ms, label_value=route)
        if isinstance(payload, dict):
            meta = payload.get("meta")
            if isinstance(meta, dict):
                meta["traceId"] = ctx.trace_id
                meta["elapsedTimeMs"] = round(elapsed_ms, 2)
        return status, payload

    def _handle(
        self, method, path, query_params, body, headers
    ) -> tuple[int, dict]:
        try:
            with span("api.handle", path=path, method=method):
                head = path.strip("/")
                if method.upper() == "GET" and head in PROBE_PATHS:
                    return self._probe(head)
                denied = self._check_auth(method.upper(), path, headers)
                if denied is not None:
                    return denied
                deadline = self._request_deadline(head, headers)
                with deadline_scope(deadline), self.admission.admit():
                    return self._route(
                        method.upper(), path, query_params, body
                    )
        except ResilienceError as e:
            # 429 shed / 503 batch timeout / 504 deadline
            payload = self.env.error(e.status, str(e))
            if e.retry_after_s is not None:
                # integer seconds, rounded up: the Retry-After header
                # carries whole seconds only, and the envelope field
                # says the same thing the header does
                payload["retryAfterSeconds"] = max(
                    1, math.ceil(e.retry_after_s)
                )
            return e.status, payload
        except TimeoutError as e:
            return 504, self.env.error(504, str(e))
        except (RequestError, FilterError, VcfLocationError) as e:
            return 400, self.env.error(400, str(e))
        except Exception as e:
            # a kernel or upload that fails in a request is that
            # request's 500, never a quiet answer from the host
            return 500, self.env.error(500, f"{type(e).__name__}: {e}")

    def _request_deadline(self, head: str, headers: dict | None) -> Deadline:
        """The request's deadline: ``X-Beacon-Deadline`` header
        (seconds) when sent, else the config default — except for
        ``/submit``, which only an explicit header bounds."""
        raw = _header(headers, "x-beacon-deadline")
        if raw is not None:
            try:
                seconds = float(raw)
                # NaN passes every <=0 guard and inf bounds nothing;
                # <=0 must not silently disable the default either
                if not math.isfinite(seconds) or seconds <= 0:
                    raise ValueError(raw)
                return Deadline.after(seconds)
            except (TypeError, ValueError):
                raise RequestError(
                    f"invalid X-Beacon-Deadline header: {raw!r}"
                    " (want a finite number of seconds > 0)"
                ) from None
        if head == "submit":
            return NO_DEADLINE
        return Deadline.after(self.config.resilience.default_deadline_s)

    def _probe(self, head: str) -> tuple[int, dict]:
        info = self.config.info
        if head == "health":
            # liveness: cheap, no store/engine access
            return 200, {"ok": True, "beaconId": info.beacon_id}
        if head == "ready":
            # readiness: local state only
            return (200 if self.ready else 503), {
                "ready": bool(self.ready),
                "beaconId": info.beacon_id,
                "shards": len(getattr(self.engine, "_indexes", {})),
                "inFlight": self.admission.metrics()["in_flight"],
            }
        return 200, self._metrics()

    def _metrics(self) -> dict:
        """The typed-instrument registry as nested JSON, plus the armed
        fault plan."""
        out = self.telemetry.render_json()
        injector = faults.installed()
        if injector is not None:
            out["faults"] = injector.stats()
        return out

    def _check_auth(self, method, path, headers) -> tuple[int, dict] | None:
        """401/403 envelope for unauthorized mutating requests, else None.

        Only ``/submit`` POST/PATCH is gated; read routes stay public.
        No credential presented (no Authorization header) -> 401;
        credential presented but rejected by the verifier -> 403."""
        if self.auth_verifier is None:
            return None
        if path.strip("/") != "submit" or method not in ("POST", "PATCH"):
            return None
        ok, reason = self.auth_verifier(method, path, headers or {})
        if ok:
            return None
        if not _authorization_header(headers or {}):
            return 401, self.env.error(401, "missing Authorization header")
        return 403, self.env.error(403, reason or "forbidden")

    # -- routing ------------------------------------------------------------

    def _route(self, method, path, query_params, body):
        parts = [p for p in path.strip("/").split("/") if p]
        info = self.config.info

        if not parts or parts == ["info"]:
            return 200, info_response(info)
        head = parts[0]
        if head == "schemas":
            from .model_schemas import ENTITY_SCHEMAS, schema_url

            if len(parts) == 1:
                return 200, {
                    "entityTypes": sorted(ENTITY_SCHEMAS),
                    "schemas": {
                        e: schema_url(info.uri, e)
                        for e in sorted(ENTITY_SCHEMAS)
                    },
                }
            if len(parts) == 2 and parts[1] in ENTITY_SCHEMAS:
                return 200, ENTITY_SCHEMAS[parts[1]]
            return 404, self.env.error(
                404, f"unknown schema /{'/'.join(parts[1:])}"
            )
        if len(parts) == 1:
            if head == "configuration":
                return 200, configuration_response(info)
            if head == "map":
                return 200, map_response(info)
            if head == "entry_types":
                return 200, entry_types_response(info)
            if head == "filtering_terms":
                req = parse_request(method, query_params, body)
                terms = self.store.filtering_terms(
                    skip=req.skip, limit=req.limit
                )
                return 200, self.env.filtering_terms(
                    terms, skip=req.skip, limit=req.limit
                )
            if head == "submit":
                if method not in ("POST", "PATCH"):
                    return 400, self.env.error(
                        400, "submit accepts POST (new) or PATCH (update)"
                    )
                return 501, self.env.error(
                    501,
                    "submit is not served by this package yet: ingest "
                    "(the VCF readers and the summarisation pipeline) "
                    "is not ported",
                )

        req = parse_request(method, query_params, body)

        if head == "g_variants":
            return self._route_g_variants(parts, req)
        if head in ENTITY_PATHS:
            return self._route_entity(parts, req)
        return 404, self.env.error(404, f"unknown path /{'/'.join(parts)}")

    # -- entity routes -------------------------------------------------------

    def _route_entity(self, parts: list[str], req: BeaconRequest):
        kind = parts[0]
        if len(parts) == 1:
            return self._entity_collection(kind, req)
        if len(parts) == 2:
            if parts[1] == "filtering_terms":
                terms = self.store.filtering_terms(
                    skip=req.skip, limit=req.limit, kinds=[kind]
                )
                return 200, self.env.filtering_terms(
                    terms, skip=req.skip, limit=req.limit
                )
            return self._entity_by_id(kind, parts[1], req)
        if len(parts) == 3:
            entity_id, sub = parts[1], parts[2]
            if sub == "filtering_terms" and kind in ("datasets", "cohorts"):
                terms = self.store.filtering_terms_for_entity(
                    kind, entity_id, skip=req.skip, limit=req.limit
                )
                return 200, self.env.filtering_terms(
                    terms, skip=req.skip, limit=req.limit
                )
            if sub == "g_variants" and kind != "cohorts":
                # cohorts expose no g_variants endpoint
                return self._scoped_g_variants(kind, entity_id, req)
            join = _CROSS_ENTITY.get((kind, sub))
            if join is not None:
                child_kind, column = join
                return self._entity_collection(
                    child_kind,
                    req,
                    extra_where=f"{column} = ?",
                    extra_params=[entity_id],
                )
        return 404, self.env.error(404, f"unknown path /{'/'.join(parts)}")

    def _entity_collection(
        self,
        kind: str,
        req: BeaconRequest,
        *,
        extra_where: str | None = None,
        extra_params: list | None = None,
    ):
        """Granularity switch over the store."""
        if req.granularity == "boolean":
            # streaming existence check, not a COUNT scan
            found = self.store.exists(
                kind,
                req.filters,
                extra_where=extra_where,
                extra_params=extra_params,
            )
            return 200, self.env.boolean(exists=found)
        count = self.store.count(
            kind,
            req.filters,
            extra_where=extra_where,
            extra_params=extra_params,
        )
        if req.granularity == "count":
            return 200, self.env.count(exists=count > 0, count=count)
        docs = self.store.fetch(
            kind,
            req.filters,
            skip=req.skip,
            limit=req.limit,
            extra_where=extra_where,
            extra_params=extra_params,
        )
        return 200, self.env.result_sets(
            results=[strip_private(d) for d in docs],
            set_type=_SET_TYPE[kind],
            exists=count > 0,
            total=count,
            skip=req.skip,
            limit=req.limit,
        )

    def _entity_by_id(self, kind: str, entity_id: str, req: BeaconRequest):
        doc = self.store.get_by_id(kind, entity_id)
        results = [strip_private(doc)] if doc else []
        if req.granularity == "boolean":
            return 200, self.env.boolean(exists=bool(doc))
        if req.granularity == "count":
            return 200, self.env.count(exists=bool(doc), count=len(results))
        return 200, self.env.result_sets(
            results=results,
            set_type=_SET_TYPE[kind],
            exists=bool(doc),
            total=len(results),
        )

    # -- variant routes ------------------------------------------------------

    def _route_g_variants(self, parts: list[str], req: BeaconRequest):
        if len(parts) == 1:
            return self._g_variants_collection(req)
        variant_id = parts[1]
        if len(parts) == 2:
            return self._g_variants_by_id(variant_id, req)
        if len(parts) == 3 and parts[2] in ("biosamples", "individuals"):
            return self._g_variants_id_entities(variant_id, parts[2], req)
        return 404, self.env.error(404, f"unknown path /{'/'.join(parts)}")

    def _g_variants_collection(self, req: BeaconRequest):
        """POST/GET /g_variants."""
        start_min, start_max, end_min, end_max = req.coordinates()
        datasets, samples = resolve_datasets(
            self.store, self.ontology, req.assembly_id, req.filters
        )
        agg = run_variant_search(
            self.engine,
            datasets,
            req,
            start_min=start_min,
            start_max=start_max,
            end_min=end_min,
            end_max=end_max,
            samples_by_dataset=samples,
            runner=self.query_runner,
        )
        return 200, self.env.by_granularity(
            req.granularity,
            exists=agg.exists,
            count=len(agg.variants),
            results=agg.results[req.skip : req.skip + req.limit],
            set_type="genomicVariant",
            skip=req.skip,
            limit=req.limit,
        )

    def _g_variants_by_id(self, variant_id: str, req: BeaconRequest):
        """/g_variants/{id}: decode the internal id back into a point
        query; resultsets always ALL."""
        assembly, chrom, pos0, ref, alt = decode_internal_id(variant_id)
        req.assembly_id = assembly
        datasets, samples = resolve_datasets(
            self.store, self.ontology, assembly, req.filters
        )
        agg = run_variant_search(
            self.engine,
            datasets,
            req,
            start_min=pos0 + 1,
            start_max=pos0 + 1,
            end_min=pos0 + 1,
            end_max=pos0 + len(alt) + 1,
            reference_name=chrom,
            reference_bases=ref,
            alternate_bases=alt,
            samples_by_dataset=samples,
            include_resultset_responses="ALL",
            runner=self.query_runner,
        )
        return 200, self.env.by_granularity(
            req.granularity,
            exists=agg.exists,
            count=len(agg.variants),
            results=agg.results,
            set_type="genomicVariant",
        )

    def _g_variants_id_entities(
        self, variant_id: str, sub: str, req: BeaconRequest
    ):
        """/g_variants/{id}/{biosamples,individuals}: find the samples
        carrying the variant, then join to the entity table."""
        assembly, chrom, pos0, ref, alt = decode_internal_id(variant_id)
        req.assembly_id = assembly
        datasets, _ = resolve_datasets(
            self.store, self.ontology, assembly, req.filters
        )
        # force record granularity internally so sample hits materialise
        inner = BeaconRequest(
            method=req.method,
            granularity="record",
            filters=req.filters,
            assembly_id=assembly,
        )
        agg = run_variant_search(
            self.engine,
            datasets,
            inner,
            start_min=pos0 + 1,
            start_max=pos0 + 1,
            end_min=pos0 + 1,
            end_max=pos0 + len(alt) + 1,
            reference_name=chrom,
            reference_bases=ref,
            alternate_bases=alt,
            include_resultset_responses="ALL",
            runner=self.query_runner,
        )
        docs: list[dict] = []
        for ds_id, names in sorted(agg.sample_names_by_dataset.items()):
            docs.extend(
                self.store.entities_for_samples(
                    sub, ds_id, names, skip=0, limit=1_000_000_000
                )
            )
        count = len(docs)
        return 200, self.env.by_granularity(
            req.granularity,
            exists=count > 0,
            count=count,
            results=[
                strip_private(d)
                for d in docs[req.skip : req.skip + req.limit]
            ],
            set_type=_SET_TYPE[sub],
            skip=req.skip,
            limit=req.limit,
        )

    def _scoped_g_variants(self, kind: str, entity_id: str, req: BeaconRequest):
        """/{entity}/{id}/g_variants — the entity-restricted variant
        search: datasets come from the entity's analyses join and the
        search runs in selected-samples mode; /datasets/{id}/g_variants
        restricts by dataset id only."""
        start_min, start_max, end_min, end_max = req.coordinates()
        if kind == "datasets":
            datasets, samples = resolve_datasets(
                self.store,
                self.ontology,
                req.assembly_id,
                req.filters,
                dataset_ids=[entity_id],
            )
        else:
            samples = {
                "individuals": self.store.sample_names_for_individual,
                "biosamples": self.store.sample_names_for_biosample,
                "runs": self.store.sample_names_for_run,
                "analyses": self.store.sample_names_for_analysis,
            }[kind](entity_id)
            if not samples:
                return 200, self.env.by_granularity(
                    req.granularity, exists=False, count=0, results=[]
                )
            datasets, _ = resolve_datasets(
                self.store,
                self.ontology,
                req.assembly_id,
                req.filters,
                dataset_ids=sorted(samples),
            )
            datasets = [d for d in datasets if samples.get(d["id"])]
        agg = run_variant_search(
            self.engine,
            datasets,
            req,
            start_min=start_min,
            start_max=start_max,
            end_min=end_min,
            end_max=end_max,
            samples_by_dataset=samples,
            runner=self.query_runner,
        )
        return 200, self.env.by_granularity(
            req.granularity,
            exists=agg.exists,
            count=len(agg.variants),
            results=agg.results[req.skip : req.skip + req.limit],
            set_type="genomicVariant",
            skip=req.skip,
            limit=req.limit,
        )
