"""The Beacon v2 application: one router over the read surface and the
policy and observability plane behind it.

Counterpart of ``sbeacon_tpu/api/app.py`` without the fleet's
migration routes:

    /  /info  /configuration  /map  /entry_types  /filtering_terms
    /schemas  /schemas/{entity}
    /{entity}                        x {datasets, cohorts, individuals,
    /{entity}/filtering_terms           biosamples, runs, analyses}
    /{entity}/{id}
    /{entity}/{id}/{sub}             (cross-entity joins + scoped g_variants)
    /g_variants  /g_variants/{id}  /g_variants/{id}/{biosamples,individuals}
    /health  /ready  /metrics        (probes: no auth, admission, deadline)
    /slo  /ops/events  /ops/costs  /ops/plans  /debug/status
    /device/status  /fleet/status    (diagnostic probes, the same bypass)
    /_trace                          (span trees; 404 unless tracing is on)
    /submit                          (POST new / PATCH update: ingest)

Every request runs under a request context (the trace id of
``X-Beacon-Trace`` or a fresh one) and, past the submit auth gate and
the ``?explain=1`` gate (``BEACON_EXPLAIN_ENABLED`` and the worker
token), is classified by tenant and priority lane and admitted through
the shaper's weighted fair queue ahead of the global admission gate,
under its ``X-Beacon-Deadline``. Its outcome folds into the SLO engine,
the cost table and the plan store (probe and diagnostic routes
excluded, all three from ``slo.PROBE_ROUTE_LABELS``), the slow-query
log, and, when explained, ``meta.executionPlan``. The canary prober
runs in the background (``canary_interval_s``). Errors map to
400/429/503/504/500. POST/PATCH ``/submit`` (behind the submit auth
gate) validates the submission, verifies its VCFs, writes its metadata
and runs the summarisation pipeline inline (``api/submit.py``): its
slices serve as deltas while it runs, and the ingest service's delta
compactor folds them off the request path.

The engine may be a fleet coordinator (``parallel.dispatch.
DistributedEngine``): ingestion then goes to its local engine
(``engine.local``), a search that found no reachable replica for some
datasets answers with them named in ``meta.unavailableDatasets`` and a
warning, ``/ready`` lists ``degradedDatasets``, ``/fleet/status``
serves the coordinator's digest poll of every worker, and
``/debug/status`` fills its breakers, routing and workers sections,
``GET /fleet/migrations`` lists its migrations, and ``POST
/fleet/migrate`` (behind the worker token) starts one.

Every handler returns ``(status_code, body_dict)`` — or, for a
Prometheus ``/metrics`` scrape, ``(200, text)``; transport (the HTTP
server, tests) is external.
"""

from __future__ import annotations

import hmac
import json
import logging
import math
import time
from pathlib import Path

from .. import telemetry as telemetry_mod
from ..accounting import (
    CostAccounting,
    cost_units,
    disabled_snapshot,
    query_shape,
)
from ..canary import CanaryProber
from ..config import BeaconConfig, StorageConfig
from ..engine import VariantEngine
from ..harness import faults
from ..ingest.pipeline import register_ingest_metrics
from ..ingest.service import (
    IngestService,
    VcfLocationError,
    register_compaction_metrics,
)
from ..metadata import MetadataStore, OntologyStore
from ..metadata.filters import FilterError
from ..parallel.dispatch import ops_digest, register_dispatch_metrics
from ..parallel.transport import register_transport_metrics
from ..plan import (
    PlanStore,
    plan_document,
    plan_note,
    plan_stage,
    register_plan_metrics,
)
from ..query_jobs import AsyncQueryRunner, QueryJobTable
from ..resilience import (
    NO_DEADLINE,
    AdmissionController,
    Deadline,
    ResilienceError,
    deadline_scope,
    register_admission_metrics,
    register_breaker_metrics,
)
from ..shaping import TrafficShaper, requested_granularity
from ..slo import (
    DIAGNOSTIC_ROUTE_LABELS,
    PROBE_BYPASS_PATHS,
    PROBE_HEAD_LABELS,
    SloEngine,
)
from ..telemetry import (
    MetricsRegistry,
    RequestContext,
    SlowQueryLog,
    annotate,
    current_context,
    journal,
    profiler,
    register_device_metrics,
    request_context,
    sanitize_trace_id,
)
from ..utils.trace import span, tracer
from .envelopes import Envelopes
from .framework import (
    configuration_response,
    entry_types_response,
    info_response,
    map_response,
)
from .requests import BeaconRequest, RequestError, parse_request
from .submit import submit_dataset
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

#: the probes and diagnostic surfaces: GET only, served before auth,
#: admission and deadlines — derived from slo.PROBE_ROUTE_LABELS, the
#: source the SLO budget exclusion and the latency labels share
PROBE_PATHS = PROBE_BYPASS_PATHS



def strip_private(doc: dict) -> dict:
    """Drop '_'-prefixed internal fields."""
    return {k: v for k, v in doc.items() if not k.startswith("_")}


def _wants_explain(query_params: dict | None) -> bool:
    """``?explain=1`` (or true/yes/on) — the inline plan request."""
    raw = str((query_params or {}).get("explain") or "").lower()
    return raw in ("1", "true", "yes", "on")


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
    not closed by :meth:`close`; a fleet coordinator
    (``DistributedEngine`` with ``local=VariantEngine(...)``) ingests
    into its local engine.
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
        # ingestion always targets an engine that can host shards: a
        # fleet coordinator exposes its local engine as .local
        ingest_engine = getattr(self.engine, "local", None) or self.engine
        if ingest is None and not hasattr(ingest_engine, "add_index"):
            # fail at wiring time, not on the first load
            raise ValueError(
                "engine cannot host index shards (no add_index): pass a "
                "VariantEngine, a DistributedEngine with "
                "local=VariantEngine(...), or an explicit ingest= service"
            )
        self.ingest = ingest or IngestService(
            self.config, engine=ingest_engine, store=self.store
        )
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

        # traffic shaping: tenant-weighted fair queueing + priority
        # lanes in FRONT of the global gate (a queued request holds no
        # admission slot), with the brownout ladder fed by the SLO
        # engine's breach signal below. The hedge kill switch is
        # process-wide.
        def _hedge_control(enabled: bool) -> None:
            from ..parallel.dispatch import set_hedging_enabled

            set_hedging_enabled(enabled)

        # cost accounting: every tracked request's CostVector folds into
        # the per-(tenant, lane, query-shape) table served at
        # /ops/costs; tenant cardinality reuses shaping's cap. Built
        # BEFORE the shaper so the cost-aware DRR seam can charge
        # measured shape costs.
        obs = self.config.observability
        if obs.cost_accounting:
            self.accounting = CostAccounting(
                window_s=obs.cost_window_s,
                max_tenants=self.config.shaping.max_tenants,
            )
        else:
            self.accounting = None
        self.shaping = TrafficShaper.from_config(
            self.config,
            hedge_control=_hedge_control,
            cost_charge_fn=(
                self.accounting.drr_charge
                if self.accounting is not None
                else None
            ),
        )
        # the background compactor runs off any request context: book
        # its fold cost under the 'system' tenant via the explicit hook
        compactor = getattr(self.ingest, "compactor", None)
        if compactor is not None and self.accounting is not None:
            compactor.accounting = self.accounting
        # readiness flag: constructed apps are servable; a deployment
        # may clear it during reload/drain so load balancers back off
        self.ready = True
        self.telemetry = MetricsRegistry()
        self.slow_log = SlowQueryLog(
            threshold_ms=obs.slow_query_ms, path=obs.slow_query_log
        )
        # SLO engine: per-route availability + latency objectives as
        # 5m/1h burn rates over every request outcome; the brownout
        # ladder subscribes to its breach signal
        self.slo = SloEngine.from_config(
            obs, max_tenants=self.config.shaping.max_tenants
        )
        self.slo.add_breach_listener(self.shaping.on_slo_signal)
        # execution plans: sampled per-request plan documents by
        # (query-shape, plan-shape), served at /ops/plans; the drift
        # sentinel's window is the canary interval (the prober's round
        # loop rolls it)
        self.plans = PlanStore(
            sample_n=obs.plan_sample_n,
            drift_windows=obs.plan_drift_windows,
            window_s=obs.canary_interval_s,
        )
        # known-answer canary prober: expected-answer probes derived
        # from the serving snapshot under the synthetic 'canary' route
        # (budget- and cost-excluded). The thread waits one full
        # interval before its first round.
        self.canary = CanaryProber(
            self.engine,
            interval_s=obs.canary_interval_s,
            enabled=obs.canary_enabled,
            latency_ms=obs.canary_latency_ms,
            plan_store=self.plans,
        )
        self.canary.start()
        # the process journal and device flight recorder were built from
        # env defaults at import; the config tier re-applies here. The
        # recorder is resolved through the module at call time, so a
        # test that swaps telemetry.flight_recorder swaps this view too.
        journal.configure(
            keep=obs.event_journal_size, enabled=obs.event_journal
        )
        telemetry_mod.flight_recorder.configure(
            ring_size=obs.device_ring_size,
            compile_tracking=obs.compile_tracking,
        )
        if obs.profile_dir:
            # config-armed profiling; the profiler is process-global
            # (one capture per process), so a second app cannot
            # redirect an already-armed capture
            if not profiler.directory:
                profiler.directory = obs.profile_dir
            elif profiler.directory != obs.profile_dir:
                logging.getLogger(__name__).warning(
                    "profiling already armed for %s; ignoring "
                    "profile_dir=%s (one capture per process)",
                    profiler.directory,
                    obs.profile_dir,
                )
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
        """Release app-owned resources: the async runner's worker pool,
        the job table, the canary thread, the shaper and the ingest
        service's compactor thread. The engine is NOT closed here."""
        self.query_runner.close()
        self.query_jobs.close()
        self.canary.close()
        self.shaping.close()
        self.ingest.close()

    # -- telemetry wiring ---------------------------------------------------

    def _register_metrics(self) -> None:
        """Wire every producer's instruments into this app's registry.
        Suppliers read through ``self`` so a component swapped at
        runtime (tests replace ``app.admission``) stays observable."""
        reg = self.telemetry
        # exemplars link each latency bucket to the trace id of its
        # latest request, so a slow bucket resolves at /_trace
        self._req_latency = reg.histogram(
            "request.latency_ms",
            "end-to-end request latency per route",
            label="route",
            exemplars=True,
            # entity heads x sub-routes top the default 64-value guard
            max_label_values=128,
        )
        reg.counter(
            "request.slow_queries",
            "requests recorded by the slow-query log",
            fn=lambda: self.slow_log.count(),
        )
        self.slo.register_metrics(reg)
        if self.accounting is not None:
            self.accounting.register_metrics(reg)
        else:
            # catalogue stability: the cost.* series exist (zeros) even
            # with accounting off
            CostAccounting().register_metrics(reg)
        reg.counter(
            "events.published",
            "control-plane events published to the event journal",
            fn=journal.published,
        )
        register_device_metrics(reg)
        self.canary.register_metrics(reg)
        register_plan_metrics(reg, self.plans)
        register_admission_metrics(reg, lambda: self.admission)
        self.shaping.register_metrics(reg)
        self.query_runner.register_metrics(reg)
        engine_reg = getattr(self.engine, "register_metrics", None)
        if engine_reg is not None:
            engine_reg(reg)
        if "breaker.state" not in reg.names():
            # single-host engines have no worker routes; the series
            # still exist (empty) so the catalogue is deployment-stable
            register_breaker_metrics(
                reg, lambda: getattr(self.engine, "breaker", None)
            )
        if "transport.conn.opened" not in reg.names():
            # the same catalogue stability for the data-plane transport
            # and fan-out series (zeros on a single-host engine)
            register_transport_metrics(reg)
            register_dispatch_metrics(
                reg,
                lambda: getattr(self.engine, "dispatch_stats", dict)(),
            )
        # compaction + slice-disk series (ingest-while-serving plane)
        register_ingest_metrics(reg)
        register_compaction_metrics(
            reg,
            lambda: getattr(self.ingest, "compaction_metrics", dict)(),
        )

    #: heads of the two-segment diagnostic surfaces (``ops``, ``debug``,
    #: ``device``, ``fleet``) — derived from the one probe-route source
    _DIAG_HEADS = frozenset(
        label.split(".", 1)[0] for label in DIAGNOSTIC_ROUTE_LABELS
    )

    #: bounded route-label set for the latency histogram — unknown
    #: paths collapse to "other" so a URL scanner cannot mint series;
    #: probe heads derive from slo.PROBE_ROUTE_LABELS
    _ROUTE_HEADS = (
        ENTITY_PATHS
        | {
            "info",
            "configuration",
            "map",
            "entry_types",
            "filtering_terms",
            "schemas",
            "submit",
            "g_variants",
        }
        | _DIAG_HEADS
        | PROBE_HEAD_LABELS
    )

    def _route_label(self, path: str) -> str:
        parts = [p for p in path.strip("/").split("/") if p]
        if not parts:
            return "info"
        head = parts[0]
        if head not in self._ROUTE_HEADS:
            return "other"
        if len(parts) == 1:
            return head
        if head in self._DIAG_HEADS:
            # only the KNOWN two-segment diagnostic paths get named
            # labels: /ops/<anything-else> collapses like any unknown
            label = f"{head}.{parts[1]}"
            return (
                label if label in DIAGNOSTIC_ROUTE_LABELS else "other"
            )
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
    ) -> tuple[int, dict | str]:
        """One request end to end, under a request context whose trace id
        is minted here (or honored from an inbound ``X-Beacon-Trace``
        header) and returns in the envelope's ``meta`` beside the
        elapsed time; then the outcome folds into the latency histogram
        (with the trace id as exemplar), the SLO engine, the cost table,
        the plan store and the slow-query log."""
        t0 = time.perf_counter()
        route = self._route_label(path)
        # a transport that minted the request's context already (the
        # HTTP server's ``http.request`` span) hands its trace id on
        outer = current_context()
        ctx = RequestContext(
            trace_id=sanitize_trace_id(_header(headers, "x-beacon-trace"))
            or (outer.trace_id if outer is not None else None),
            route=route,
        )
        with request_context(ctx):
            status, payload = self._handle(
                method, path, query_params, body, headers
            )
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        # the exemplar is passed explicitly: this runs OUTSIDE the
        # request_context scope, so the ambient lookup would miss
        self._req_latency.observe(
            elapsed_ms, label_value=route, exemplar=ctx.trace_id
        )
        tenant = ctx.notes.get("tenant")
        self.slo.record(route, status, elapsed_ms, tenant=tenant)
        # cost accounting: fold this request's CostVector into the
        # (tenant, lane, shape) table; probe/diagnostic routes are
        # excluded exactly like SLO budgets. Response bytes are
        # measured here, the one place the final payload exists.
        if self.accounting is not None and self.slo.tracked(route):
            cost = ctx.cost
            if isinstance(payload, dict):
                try:
                    cost.add(
                        response_bytes=len(
                            json.dumps(payload, default=str)
                        )
                    )
                except (TypeError, ValueError):
                    pass
            # seal BEFORE snapshotting: a late charge (a launch finishing
            # after this request 504ed) lands in the unattributed
            # residue, on exactly one side of the fold
            cost.seal()
            self.accounting.record(
                tenant or "anon",
                ctx.notes.get("lane") or "interactive",
                query_shape(route, ctx.notes.get("granularity")),
                cost.snapshot(),
            )
        # execution-plan fold: tracked requests' stage trails aggregate
        # by (query-shape, plan-shape); the canary folds its own probes
        if self.slo.tracked(route):
            self.plans.observe(
                query_shape(route, ctx.notes.get("granularity")),
                ctx.plan,
                units=cost_units(ctx.cost.snapshot()),
                trace_id=ctx.trace_id,
            )
        notes = ctx.notes
        if ctx.cost.nonzero():
            # a slow record carries its cost decomposition
            notes = {**notes, "cost": ctx.cost.as_dict()}
        if ctx.plan:
            # ... and the plan fingerprint + any refusal reasons
            notes = {**notes, "plan": plan_note(ctx)}
        self.slow_log.maybe_record(
            trace_id=ctx.trace_id,
            route=route,
            status=status,
            elapsed_ms=elapsed_ms,
            notes=notes,
        )
        if isinstance(payload, dict):
            meta = payload.get("meta")
            if isinstance(meta, dict):
                meta["traceId"] = ctx.trace_id
                meta["elapsedTimeMs"] = round(elapsed_ms, 2)
                if ctx.explain:
                    # ?explain=1 (gated in _handle): the bounded plan
                    # document rides the envelope — never cached, since
                    # explain forces no_response_cache
                    meta["executionPlan"] = plan_document(ctx)
                unavailable = ctx.notes.get("unavailable_datasets")
                if unavailable:
                    # partial results (DistributedEngine.search): every
                    # replica of these datasets was unreachable, so the
                    # response covers the datasets that answered
                    meta["unavailableDatasets"] = list(unavailable)
                    meta.setdefault("warnings", []).append(
                        "no reachable replica for dataset(s): "
                        + ", ".join(unavailable)
                        + "; results are partial"
                    )
        return status, payload

    def _handle(
        self, method, path, query_params, body, headers
    ) -> tuple[int, dict | str]:
        try:
            with span("api.handle", path=path, method=method):
                head = path.strip("/")
                if method.upper() == "GET" and head in PROBE_PATHS:
                    # probes AND the self-diagnosis surfaces bypass
                    # auth, admission and deadlines: answering while the
                    # server sheds is their whole job
                    return self._probe(head, query_params, headers)
                denied = self._check_auth(method.upper(), path, headers)
                if denied is not None:
                    return denied
                if _wants_explain(query_params):
                    denied = self._check_explain(headers)
                    if denied is not None:
                        return denied
                    ctx = current_context()
                    if ctx is not None:
                        # armed only after the gate: an unauthorized
                        # ?explain=1 never records, never bypasses a
                        # cache, never changes the answer
                        ctx.explain = True
                deadline = self._request_deadline(head, headers)
                # traffic shaping: classify tenant and priority lane,
                # then admit through the weighted fair queue BEFORE the
                # global gate — a queued request holds no admission
                # slot, and the deadline scope bounds the queue wait
                tenant = self.shaping.tenant_of(headers)
                lane = self.shaping.lane_of(head, query_params, body)
                granularity = requested_granularity(query_params, body)
                annotate(tenant=tenant, lane=lane)
                plan_stage("admission", decision=lane, tenant=tenant)
                if granularity:
                    annotate(granularity=granularity)
                # the query-shape key the accounting fold uses, so the
                # cost-aware DRR charges admission with this shape's
                # measured cost
                ctx = current_context()
                shape = query_shape(
                    ctx.route if ctx is not None else head, granularity
                )
                with deadline_scope(deadline), self.shaping.admit(
                    tenant, lane, shape
                ), self.admission.admit():
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

    def _probe(
        self,
        head: str,
        query_params: dict | None = None,
        headers: dict | None = None,
    ) -> tuple[int, dict | str]:
        info = self.config.info
        if head == "health":
            # liveness: cheap, no store/engine access
            return 200, {"ok": True, "beaconId": info.beacon_id}
        if head == "ready":
            # readiness: local state only — never a worker round-trip
            local = getattr(self.engine, "local", None) or self.engine
            body = {
                "ready": bool(self.ready),
                "beaconId": info.beacon_id,
                "shards": len(getattr(local, "_indexes", {})),
                "inFlight": self.admission.metrics()["in_flight"],
            }
            # degraded datasets (every replica's circuit open) are
            # reported but do NOT flip readiness: the server still
            # serves everything else, with partial-results envelopes
            degraded = getattr(self.engine, "unavailable_datasets", None)
            if degraded is not None:
                body["degradedDatasets"] = degraded()
            return (200 if self.ready else 503), body
        if head == "slo":
            # per-route objectives + burn rates; ?tenant=<id> scopes the
            # document to one tenant's burn rings
            want_tenant = (query_params or {}).get("tenant")
            return 200, self.slo.snapshot(tenant=want_tenant or None)
        if head == "ops/events":
            return self._ops_events(query_params)
        if head == "ops/costs":
            # top tenants by cost unit, per-shape mean/p99, attribution
            if self.accounting is None:
                return 200, disabled_snapshot()
            return 200, self.accounting.snapshot()
        if head == "ops/plans":
            # per (query-shape, plan-shape) counts, cost-unit means,
            # exemplar trace ids and the drift sentinel's flips
            return 200, self.plans.snapshot()
        if head == "fleet/status":
            # every worker's /ops/digest collected at a bounded cadence
            # and the coordinator's own digest, with a fleet diagnosis
            return 200, self._fleet_status()
        if head == "debug/status":
            return 200, self._debug_status()
        if head == "device/status":
            return 200, self._device_status()
        if head == "fleet/migrations":
            # migration history and in-flight phases: a diagnostic read
            # (the POST trigger is /fleet/migrate, behind the token)
            ctl = getattr(self.engine, "migrations", None)
            return 200, {
                "migrations": ctl.status() if ctl is not None else [],
                "counters": ctl.counters() if ctl is not None else {},
                "stuck": ctl.stuck() if ctl is not None else None,
            }
        # /metrics: content negotiation — ?format=openmetrics or an
        # ``Accept: application/openmetrics-text`` gets the OpenMetrics
        # dialect WITH exemplars; ?format=prometheus or ``Accept:
        # text/plain`` the classic text format (no exemplars);
        # everything else the nested JSON
        fmt = (query_params or {}).get("format", "")
        accept = _header(headers, "accept") or ""
        if fmt == "openmetrics" or "application/openmetrics-text" in accept:
            return 200, self.telemetry.render_prometheus(openmetrics=True)
        if fmt == "prometheus" or "text/plain" in accept:
            return 200, self.telemetry.render_prometheus()
        return 200, self._metrics()

    def _ops_events(self, query_params: dict | None) -> tuple[int, dict]:
        """The event journal, filtered: ``?since=<seq>`` returns only
        newer events — the OLDEST ``limit`` of them, with a
        ``nextSince`` cursor to pass back as ``since``; ``?kind=`` filters
        by kind prefix (comma-separated list accepted)."""
        qp = query_params or {}
        try:
            since = int(qp.get("since") or 0)
            limit = int(qp.get("limit") or 256)
        except (TypeError, ValueError):
            return 400, self.env.error(
                400, "since/limit must be integers"
            )
        events, next_since = journal.events_page(
            since=since, kind=str(qp.get("kind") or ""), limit=limit
        )
        return 200, {
            "events": events,
            "nextSince": next_since,
            "lastSeq": journal.last_seq(),
            "published": journal.published(),
            "enabled": journal.enabled,
        }

    def _digest_extras(self) -> dict:
        """The coordinator's app-tier digest fields (a worker's digest
        carries engine fields only): SLO breaches, slow-query count,
        top cost tenants, canary rollup."""
        canary = self.canary.counters()
        extras = {
            "sloBreached": self.slo.breached_routes(),
            "slowQueries": self.slow_log.count(),
            "canary": {
                "mismatches": canary["mismatches"],
                "failures": canary["failures"],
            },
        }
        if self.accounting is not None:
            extras["topCostTenants"] = self.accounting.snapshot(
                top_n=3
            )["topTenants"]
        else:
            extras["topCostTenants"] = []
        return extras

    def _fleet_migrate(self, body: dict) -> tuple[int, dict]:
        """``POST /fleet/migrate``: start a live shard migration on the
        fan-out engine's controller. 202: the protocol runs on a
        background thread (poll ``GET /fleet/migrations``); 409: refused
        up front (dataset already migrating, migrations disabled, bad
        endpoints)."""
        from ..parallel.migration import MigrationError

        ctl = getattr(self.engine, "migrations", None)
        if ctl is None:
            return 400, self.env.error(
                400,
                "this deployment has no migration controller "
                "(single-host engine — nothing to migrate between)",
            )
        dataset = str(body.get("dataset") or "")
        source = str(body.get("source") or "")
        target = str(body.get("target") or "")
        if not dataset or not source or not target:
            return 400, self.env.error(
                400, "fleet/migrate needs dataset, source and target"
            )
        try:
            m = ctl.start(dataset, source, target)
        except MigrationError as e:
            return 409, self.env.error(409, str(e))
        return 202, {
            "migrationId": m.id,
            "dataset": m.dataset,
            "source": m.source,
            "target": m.target,
            "phase": m.phase,
        }

    def _fleet_status(self) -> dict:
        """The ``/fleet/status`` document: the coordinator's per-worker
        digest rollup and diagnosis, always with its own digest as
        ``local`` — a single-host deployment serves the same schema
        with an empty worker map."""
        local_engine = getattr(self.engine, "local", None) or self.engine
        local = ops_digest(local_engine, extras=self._digest_extras())
        fleet = getattr(self.engine, "fleet", None)
        if fleet is None:
            doc = {
                "intervalS": self.config.observability.fleet_digest_interval_s,
                "polls": 0,
                "lastPollAgeS": None,
                "workers": {},
                "diagnosis": {
                    "stalestReplica": None,
                    "hottestWorker": None,
                    "divergentDatasets": {},
                    "unreachableWorkers": [],
                    "worstCompilingReplica": None,
                },
            }
        else:
            doc = fleet.snapshot()
        doc["local"] = local
        return doc

    def _debug_status(self) -> dict:
        """The self-diagnosis rollup: SLO state, queue depths, the stage
        decomposition, costs, the canary, the device plane and plans,
        composed into one document whose ``diagnosis`` names what eats
        the latency budget. Local state only — safe to serve while
        saturated. Breakers, routing and workers are a fleet
        coordinator's: empty for a single-host engine."""
        engine = self.engine
        local = getattr(engine, "local", None) or engine
        breaker = getattr(engine, "breaker", None)
        breakers = breaker.metrics() if breaker is not None else {}
        routing: dict = {}
        router = getattr(engine, "router", None)
        if router is not None:
            age = engine.route_table_age_s()
            routing = {
                "datasets": len(router.table()),
                "replicas": router.replica_count(),
                "tableAgeS": None if age is None else round(age, 1),
                "unavailableDatasets": engine.unavailable_datasets(),
                "workers": engine.worker_stats(),
            }
        batcher = getattr(local, "_batcher", None)
        occ = batcher.occupancy() if batcher is not None else {}
        queues = {
            "admission": self.admission.metrics(),
            "shaping": self.shaping.debug(),
            "runner": self.query_runner.metrics(),
            "batcher": {
                k: occ[k] for k in ("launcher", "fetcher") if k in occ
            },
        }
        # stage decomposition: runner admission wait first, then the
        # batcher/engine stages
        stages: dict = {
            "admission_wait_ms": self.query_runner.queue_wait_summary()
        }
        st = getattr(local, "stage_timing", None)
        if st is not None:
            stages.update(st())
        ingest: dict = {}
        delta_stats = getattr(local, "delta_stats", None)
        if delta_stats is not None:
            ingest["deltaTails"] = delta_stats()
        l0_status = getattr(local, "l0_status", None)
        if l0_status is not None:
            ingest["l0"] = l0_status()
        compactor = getattr(self.ingest, "compactor", None)
        if compactor is not None:
            ingest["compactor"] = compactor.metrics()
        slo = self.slo.snapshot()
        breached = sorted(
            r for r, doc in slo["routes"].items() if doc["breached"]
        )
        stage_p99 = {
            name: q.get("p99", 0.0)
            for name, q in stages.items()
            if isinstance(q, dict) and q
        }
        slowest_stage = (
            max(stage_p99, key=stage_p99.get)
            if any(stage_p99.values())
            else None
        )
        workers = routing.get("workers") or {}
        rtts = {
            u: w["medianRttMs"]
            for u, w in workers.items()
            if w.get("medianRttMs") is not None
        }
        costs = (
            self.accounting.debug()
            if self.accounting is not None
            else {"enabled": False}
        )
        # a canary mismatch means the data plane is silently wrong
        canary = self.canary.status()
        recorder = telemetry_mod.flight_recorder
        device = {
            "launches": recorder.launch_summary(),
            "padWaste": recorder.pad_waste_by_family(),
            "midRequestCompiles": recorder.mid_request_compiles(),
        }
        last_compile = recorder.last_mid_request_compile()
        plans = self.plans.counters()
        return {
            "ready": bool(self.ready),
            "beaconId": self.config.info.beacon_id,
            "slo": slo,
            "breakers": breakers,
            "routing": routing,
            "queues": queues,
            "ingest": ingest,
            "stages": stages,
            "costs": costs,
            "canary": canary,
            "device": device,
            "plans": plans,
            "events": {
                "lastSeq": journal.last_seq(),
                "published": journal.published(),
            },
            "diagnosis": {
                "breachedSlos": breached,
                "openBreakers": sorted(
                    u
                    for u, d in breakers.items()
                    if d.get("state") != "closed"
                ),
                "slowestStage": slowest_stage,
                "slowestWorker": (
                    max(rtts, key=rtts.get) if rtts else None
                ),
                "costliestTenant": costs.get("costliestTenant"),
                "costliestShape": costs.get("costliestShape"),
                "canaryMismatches": list(canary.get("mismatched", [])),
                "worstPadWaste": recorder.worst_pad_waste(),
                "midRequestCompiles": device["midRequestCompiles"],
                "lastMidRequestCompile": (
                    last_compile["key"] if last_compile else None
                ),
                "planDrift": self.plans.drifted_shapes(),
            },
        }

    def _device_status(self) -> dict:
        """The device flight recorder's read surface: the launch ring
        and counters (padding waste by family and tier, fetched bytes),
        the compile tracker, the plane ledger, and the fused stack's
        state. Every piece is a lock-free snapshot (the recorder's own
        short lock, a try-lock on the engine's ledger), so this answers
        during a stack rebuild."""
        engine = self.engine
        local = getattr(engine, "local", None) or engine
        doc = telemetry_mod.flight_recorder.snapshot()
        ledger = getattr(local, "plane_ledger", None)
        doc["hbm"] = (
            ledger()
            if callable(ledger)
            else {
                "residentBytes": 0,
                "reservedBytes": 0,
                "reservedTokens": 0,
                "budgetBytes": 0,
                "headroomBytes": 0,
                "stale": False,
            }
        )
        stacks: dict = {}
        fused = getattr(local, "fused_stack_status", None)
        if callable(fused):
            stacks["fused"] = fused()
        tier = getattr(engine, "mesh_tier", None)
        if tier is not None:
            stacks["meshTier"] = tier.stats()
        doc["stacks"] = stacks
        doc["time"] = time.time()
        return doc

    def _metrics(self) -> dict:
        """The typed-instrument registry as nested JSON, plus the two
        surfaces kept in their non-dotted shapes: a fleet coordinator's
        per-worker breaker states and the armed fault plan."""
        out = self.telemetry.render_json()
        breaker = getattr(self.engine, "breaker", None)
        if breaker is not None:
            out["breaker"] = breaker.metrics()
        injector = faults.installed()
        if injector is not None:
            out["faults"] = injector.stats()
        return out

    def _check_explain(self, headers) -> tuple[int, dict] | None:
        """404/401/403 envelope for an unauthorized ``?explain=1``,
        else None (explain may proceed).

        The plan document names internal topology, so it rides the
        worker-token trust boundary: disabled entirely unless
        ``BEACON_EXPLAIN_ENABLED`` (a 404, indistinguishable from the
        feature not existing), then no credential -> 401, wrong
        credential -> 403. Empty worker token = open."""
        if not self.config.observability.explain_enabled:
            return 404, self.env.error(
                404, "explain disabled (set BEACON_EXPLAIN_ENABLED)"
            )
        token = self.config.auth.worker_token
        if not token:
            return None
        got = _authorization_header(headers or {})
        if not got:
            return 401, self.env.error(
                401, "missing Authorization header"
            )
        if not hmac.compare_digest(
            got.encode(), f"Bearer {token}".encode()
        ):
            return 403, self.env.error(
                403, "explain requires the worker token"
            )
        return None

    def _check_auth(self, method, path, headers) -> tuple[int, dict] | None:
        """401/403 envelope for unauthorized mutating requests, else None.

        ``/submit`` POST/PATCH is gated by the submit verifier; read
        routes stay public. No credential presented (no Authorization
        header) -> 401; credential presented but rejected -> 403.
        ``POST /fleet/migrate`` rides the WORKER-token boundary instead:
        it drives ``/migrate/*`` reads and drops across the fleet, the
        same blast radius as direct worker access (an empty worker token
        leaves it open, as the worker routes are)."""
        if path.strip("/") == "fleet/migrate" and method == "POST":
            token = self.config.auth.worker_token
            if not token:
                return None
            got = _authorization_header(headers or {})
            if not got:
                return 401, self.env.error(
                    401, "missing Authorization header"
                )
            if not hmac.compare_digest(
                got.encode(), f"Bearer {token}".encode()
            ):
                return 403, self.env.error(
                    403, "fleet/migrate requires the worker token"
                )
            return None
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
        if parts == ["fleet", "migrate"]:
            # the migrate trigger (worker-token gated in _check_auth)
            if method != "POST":
                return 405, self.env.error(
                    405, "fleet/migrate accepts POST"
                )
            return self._fleet_migrate(body or {})
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
            if head == "_trace":
                # debug-only profiling surface; 404s unless tracing is on
                if not tracer.is_enabled:
                    return 404, self.env.error(404, "tracing disabled")
                # recent span trees + the aggregate report + the
                # slow-query ring; ?trace_id= filters the trees to one
                # request
                want = (query_params or {}).get("trace_id")
                return 200, {
                    "report": tracer.report(),
                    "traces": tracer.recent_trees(trace_id=want),
                    "slowQueries": self.slow_log.recent(),
                }
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
                summary = submit_dataset(
                    self, body or {}, update=(method == "PATCH")
                )
                return 200, summary

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
