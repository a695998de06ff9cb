"""The fleet query plane: worker hosts, the coordinator, the pod tier and
multi-process compute.

Counterpart of ``sbeacon_tpu/parallel/dispatch.py``. Each worker host
owns a set of dataset index shards behind a :class:`WorkerServer`
(``python -m sbeacon_tpu_torch.parallel.dispatch``, serving on the
card); the coordinator's :class:`DistributedEngine` routes a
``VariantQueryPayload`` to the workers owning its datasets (a
thread-pool scatter over the pooled keep-alive transport of
``transport.py``), retries transient failures, and merges the
per-(dataset, vcf) responses, presenting the ``VariantEngine`` interface
so the API layer and the query runner compose unchanged. Datasets served
by several workers keep their full replica list (:class:`ReplicaRouter`):
power-of-two-choices routing over recent RTTs, failover to the next
replica on worker errors or open circuits, replica-hedged searches for
slow primaries (the brownout ladder's first rung turns them off through
:func:`set_hedging_enabled`), partial results when every copy of a
dataset is down, and a background rediscovery loop that heals routes.
:class:`FleetView` collects every worker's ``/ops/digest`` for the app's
``/fleet/status``. The fleet's ingest leg: :class:`ScanWorkerPool`
scatters a summarisation's slice scans over the workers' ``/scan``
(hedged, behind one-strike breakers; a failed remote scan is scanned
again on the coordinator's host). Its migration leg: the workers'
``/migrate/{manifest,fetch,adopt,drop}`` artifact exchange, driven by
``parallel.migration.MigrationController`` (``DistributedEngine.
migrations``). The wire form of every exchange is the JAX package's, so
either package's coordinator drives the other's workers.

The pod dispatch tier (:class:`MeshDispatchTier`): the engine's shards
stack into a ``parallel.mesh.MeshFusedIndex`` sharded over the engine's
mesh, and a query whose datasets all live on the mesh costs ONE mesh
launch through the engine's micro-batcher (``submit_many``): the boolean
OR, the count and allele sums and the record-granularity hit rows, and
for plane-reading shapes the per-query sample-mask reduction too. A
coordinator with a local engine consults it per query. The delta tail of
a served key (the shards ``VariantEngine.add_delta`` published since the
stack was built; the base fingerprint, and so the stack, stays warm)
rides beside the mesh launch: the engine's L0 index answers its covered
targets in one launch (``engine.l0_pre_rows``, which also charges the
host-walked ones), and the rest are matched on the host, as in the JAX
package. ``resolve`` and ``search`` note their ``mesh`` plan stage and
the request annotations, ``search`` checks the request deadline and
hits the ``mesh.dispatch`` fault point, and a launch without the
batcher hits the ``kernel.launch`` fault point.

Multi-process compute (:func:`init_multihost`, JAX's
``jax.distributed.initialize``): every process joins one
``torch.distributed`` process group and records its local mesh entries
in ``parallel.mesh``; ``make_mesh()`` then spans every process, and
the stacked mesh queries of ``parallel.mesh`` and
``distinct_count_device(mesh=)`` fan in through an ``all_reduce``.

Deliberate differences from the JAX package:

- ``init_multihost`` takes the collectives' ``backend`` (nccl by
  default) and this process's mesh ``devices`` (every visible card by
  default); nothing picks another backend or the CPU by itself. The
  engine's mesh leg and the pod tier stay process-local;
- a failure on the coordinator's side raises on the request: a failed
  tier build, upload or launch (a background build's failure is raised
  by the requests that consult the tier until the index set changes),
  and an error of the coordinator's local engine, even where a boolean
  hit elsewhere would have decided the answer. The JAX coordinator logs
  a tier failure and scatters the same datasets again
  (``mesh.fallbacks``), and lets a boolean hit outvote a local error.
  So there is no fallback counter. A WORKER's failure (an error answer,
  a refused connection, a timeout, an open circuit) keeps the JAX
  semantics: failover to another replica, then partial results;
- the worker entry takes ``--device`` (the card by default) and the
  worker serves ``/device/launches`` (its kernel launch counts, by
  kernel and by family) inside the token boundary. A target worker's
  device failure while adopting a migrated artifact (``add_index``'s
  build or upload, ``adopt_delta``'s L0 build) answers
  ``/migrate/adopt`` with 500, and the controller abandons or rolls the
  migration back; nothing is served from the host instead;
- the tier has no journal events and no plane-ledger headroom in its
  ``planes`` refusal.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures as futures_mod
import dataclasses
import gzip
import hmac
import json
import logging
import random
import threading
import time
import urllib.error
import weakref
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .. import telemetry as telemetry_mod
from ..harness.faults import fault_point
from ..payloads import (
    SliceScanPayload,
    VariantQueryPayload,
    VariantSearchResponse,
)
from ..plan import plan_stage
from ..resilience import (
    CLOSED,
    OPEN,
    CircuitBreaker,
    CircuitOpen,
    DeadlineExceeded,
    current_deadline,
    register_breaker_metrics,
)
from ..telemetry import (
    TRACE_HEADER,
    RequestContext,
    annotate,
    charge_cost,
    current_context,
    new_span_id,
    publish_event,
    request_context,
    sanitize_trace_id,
)
from ..utils.trace import Span, span
from . import mesh as _mesh
from .transport import (
    PooledTransport,
    note_hedge,
    register_transport_metrics,
    urllib_post,
)

log = logging.getLogger(__name__)

# -- hedging kill switch ------------------------------------------------------

#: process-wide hedge enable flag: the brownout ladder's FIRST rung
#: (shaping.BrownoutLadder via set_hedging_enabled) — under a sustained
#: SLO breach the cheapest load to shed is the duplicate calls hedging
#: adds, before any request is refused. Process-global like the fault
#: injector: the replica routers live below the app layer.
_hedging_enabled = True


def set_hedging_enabled(enabled: bool) -> None:
    """Flip the process-wide hedging kill switch (brownout rung 1): it
    overrides every replica router's hedge delay; in-flight hedges are
    unaffected."""
    global _hedging_enabled
    _hedging_enabled = bool(enabled)


def hedging_enabled() -> bool:
    return _hedging_enabled


def _hedge_due(fut, started: threading.Event, delay: float) -> bool:
    """Whether a hedge should race the primary ``fut``: it has not
    answered within ``delay`` of its START (``started`` is set by the
    primary's first line). A primary not started yet (queued behind a
    full pool, or its pool thread not yet scheduled) is waited for
    first: the delay measures the worker, not the queue, and a late
    start does not forfeit the race. (The JAX package checks once,
    ``delay`` after the submit, and never hedges a primary that started
    later.)"""
    while not started.wait(delay):
        if fut.done():
            return False
    done, _pending = futures_mod.wait([fut], timeout=delay)
    return not done


# -- worker side --------------------------------------------------------------


def _make_handler(
    engine, token: str = "", open_scan: bool = False, reload_fn=None
):
    class Handler(BaseHTTPRequestHandler):
        # keep-alive: the coordinator's pooled transport holds a few
        # persistent connections per worker instead of a TCP handshake
        # (and a server thread spawn) per call
        protocol_version = "HTTP/1.1"
        # reap idle keep-alive connections a little after the
        # coordinator's pool TTL would have evicted them anyway
        timeout = 120.0

        def log_message(self, *a):  # quiet
            pass

        def _read_body(self) -> bytes:
            """The full request body, gunzipped when the coordinator
            compressed it (transport.py gzip_min_bytes)."""
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            if self.headers.get("Content-Encoding", "").lower() == "gzip":
                raw = gzip.decompress(raw)
            return raw

        def _send(self, status: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            # shared-token gate on the worker boundary; /health stays
            # open for liveness probes
            if not token:
                return True
            got = self.headers.get("Authorization", "")
            # bytes compare: compare_digest raises TypeError on non-ASCII
            # str, which would kill the request with no response
            return hmac.compare_digest(
                got.encode(), f"Bearer {token}".encode()
            )

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"ok": True})
            elif not self._authorized():
                self._send(401, {"error": "unauthorized"})
            elif self.path == "/ops/digest":
                # the fleet digest: behind the SAME token boundary as
                # /search (it names datasets and fingerprints)
                self._send(200, ops_digest(engine))
            elif self.path == "/device/launches":
                # this process's kernel launches by kernel and by family
                # (warmup's included): the card-side evidence a fleet
                # drive reads before and after its traffic
                self._send(
                    200,
                    {
                        "launches": telemetry_mod.launch_counts(),
                        "families": telemetry_mod.launches_by_family(),
                    },
                )
            elif self.path == "/datasets":
                # per-dataset fingerprints let the coordinator group
                # only IDENTICAL shard copies as replicas
                ds_fps = getattr(engine, "dataset_fingerprints", None)
                self._send(
                    200,
                    {
                        "datasets": engine.datasets(),
                        "fingerprint": engine.index_fingerprint(),
                        "dataset_fingerprints": (
                            ds_fps() if ds_fps is not None else {}
                        ),
                    },
                )
            else:
                self._send(404, {"error": "not found"})

        def _send_bytes(self, status: int, body: bytes):
            self.send_response(status)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            # the body is read BEFORE any early return: with HTTP/1.1
            # keep-alive, unread body bytes would bleed into the next
            # request's parse on this connection
            try:
                raw = self._read_body()
            except Exception:
                self._send(400, {"error": "bad request body"})
                return
            if not self._authorized():
                self._send(401, {"error": "unauthorized"})
                return
            if self.path == "/reload":
                # re-pin shards from storage without a process restart
                if reload_fn is None:
                    self._send(404, {"error": "reload not wired"})
                    return
                try:
                    n = reload_fn()
                    self._send(200, {"ok": True, "shards": int(n)})
                except Exception as e:
                    log.exception("worker reload failed")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path.startswith("/migrate/"):
                # the migration artifact plane: manifest / fetch / adopt
                # / drop, inside the SAME token boundary as /search
                self._do_migrate(raw)
                return
            if self.path == "/scan":
                # /scan range-reads a CLIENT-SUPPLIED location (a local
                # path or URL): served only behind a worker token, or
                # when the operator opted in (a private network)
                if not token and not open_scan:
                    self._send(
                        403,
                        {
                            "error": "scan requires a worker token "
                            "(or --open-scan on a private network)"
                        },
                    )
                    return
                self._do_scan(raw)
                return
            if self.path != "/search":
                self._send(404, {"error": "not found"})
                return
            try:
                t_recv = time.perf_counter()
                # from_doc drops unknown keys: this worker keeps
                # answering a coordinator one payload field ahead of it
                payload = VariantQueryPayload.from_doc(json.loads(raw))
                # adopt the coordinator's trace id so worker-side spans
                # parent into the same distributed trace
                ctx = RequestContext(
                    trace_id=sanitize_trace_id(
                        self.headers.get(TRACE_HEADER)
                    ),
                    route="worker.search",
                )
                with request_context(ctx), span(
                    "worker.search",
                    datasets=len(payload.dataset_ids or []),
                ):
                    t_eng = time.perf_counter()
                    responses = engine.search(payload)
                    engine_s = time.perf_counter() - t_eng
                t_ser = time.perf_counter()
                docs = [dataclasses.asdict(r) for r in responses]
                serialize_s = time.perf_counter() - t_ser
                # the span summary the coordinator grafts as child spans
                # of its worker call: ``queueMs`` is the micro-batch wait
                # the engine annotated, ``cache`` the response-cache
                # outcome, ``rows`` the matched rows shipped back
                notes = ctx.notes
                try:
                    queue_ms = float(notes.get("batch_ms") or 0.0)
                except (TypeError, ValueError):
                    queue_ms = 0.0
                # the batch wait happened INSIDE engine.search: engine
                # time is reported exclusive of it
                engine_excl_ms = max(engine_s * 1e3 - queue_ms, 0.0)
                self._send(
                    200,
                    {
                        "responses": docs,
                        "meta": {
                            "spanId": new_span_id(),
                            "queueMs": round(queue_ms, 3),
                            "engineMs": round(engine_excl_ms, 3),
                            "serializeMs": round(serialize_s * 1e3, 3),
                            "totalMs": round(
                                (time.perf_counter() - t_recv) * 1e3, 3
                            ),
                            "rows": sum(len(r.variants) for r in responses),
                            "cache": notes.get("response_cache", ""),
                            "datasets": len(payload.dataset_ids or []),
                        },
                    },
                )
            except Exception as e:  # worker errors travel to coordinator
                log.exception("worker search failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _do_scan(self, raw: bytes):
            """The ingest slice-scan leaf: range-read, parse and build
            one slice shard, answered as a raw npz blob. The VCF must be
            reachable from the worker (a shared path or a URL)."""
            try:
                from ..index.columnar import dumps_index
                from ..ingest.pipeline import scan_slice_to_shard

                p = SliceScanPayload(**json.loads(raw))
                shard = scan_slice_to_shard(
                    p.vcf_location,
                    p.vstart,
                    p.vend,
                    dataset_id=p.dataset_id,
                    sample_names=p.sample_names,
                )
                self._send_bytes(200, dumps_index(shard))
            except Exception as e:
                log.exception("worker slice scan failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _do_migrate(self, raw: bytes):
            """The migration artifact exchange: ``manifest`` lists a
            dataset's base and standing-delta artifacts by epoch-ranged
            fingerprint (the resume key), ``fetch`` streams one as a raw
            npz blob, ``adopt`` installs a received artifact at its
            ORIGINAL epoch (a base through ``add_index``, onto the
            card), and ``drop`` retires the dataset after cut-over. A
            failed adoption (a device build, upload or L0 build) answers
            500."""
            from ..index.columnar import dumps_index, loads_index

            op = self.path[len("/migrate/"):]
            try:
                doc = json.loads(raw) if raw else {}
                if not isinstance(doc, dict):
                    raise ValueError("migrate body must be an object")
            except Exception:
                self._send(400, {"error": "bad migrate body"})
                return
            ds = str(doc.get("dataset") or "")
            try:
                if op == "manifest":
                    self._send(200, engine.migration_manifest(ds))
                elif op == "fetch":
                    shard = engine.export_artifact(
                        ds, str(doc.get("vcf") or ""),
                        epoch=doc.get("epoch"),
                    )
                    if shard is None:
                        self._send(404, {"error": "artifact not found"})
                    else:
                        self._send_bytes(200, dumps_index(shard))
                elif op == "adopt":
                    shard = loads_index(
                        base64.b64decode(doc.get("blob") or "")
                    )
                    if doc.get("kind") == "delta":
                        adopted = engine.adopt_delta(
                            shard, int(doc.get("epoch") or 0)
                        )
                        self._send(
                            200, {"ok": True, "adopted": bool(adopted)}
                        )
                    else:
                        engine.add_index(shard)
                        self._send(200, {"ok": True, "adopted": True})
                elif op == "drop":
                    self._send(
                        200,
                        {"ok": True, "shards": int(engine.drop_dataset(ds))},
                    )
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:
                log.exception("worker migrate %s failed", op)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _WorkerHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that tracks live client connections so
    shutdown can sever them. A killed worker process takes every
    socket with it; ``server_close`` alone only closes the LISTENER,
    leaving keep-alive handler threads answering on pooled coordinator
    connections — a zombie that would mask the dead-worker failover
    paths the replica layer exists for."""

    daemon_threads = True
    # a burst of coordinator connects must not overflow socketserver's
    # default backlog of 5
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conn_lock = threading.Lock()
        self._conns: set = set()

    def process_request(self, request, client_address):
        with self._conn_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conn_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def handle_error(self, request, client_address):
        # a handler mid-write when close_all_connections severed its
        # socket raises BrokenPipe/ConnectionReset — that IS the
        # faithful kill, not an error worth a stderr traceback
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)

    def close_all_connections(self) -> None:
        import socket as socket_mod

        with self._conn_lock:
            conns, self._conns = list(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket_mod.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class WorkerServer:
    """One worker host's engine behind HTTP."""

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        token: str = "",
        open_scan: bool = False,
        reload_fn=None,
    ):
        self.engine = engine
        self.server = _WorkerHTTPServer(
            (host, port),
            _make_handler(engine, token, open_scan, reload_fn),
        )
        self.thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        h, p = self.server.server_address[:2]
        return f"http://{h}:{p}"

    def start_background(self) -> "WorkerServer":
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True,
            name="worker-server",
        )
        self.thread.start()
        return self

    def shutdown(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        # faithful kill: live keep-alive connections die with the
        # server, like the process death they stand in for
        self.server.close_all_connections()
        if self.thread is not None:
            self.thread.join()


#: datasets/fingerprints listed per digest before truncation — the
#: digest must stay a bounded control-plane message, never a data dump
DIGEST_DATASET_CAP = 128


def ops_digest(engine, extras: dict | None = None) -> dict:
    """The bounded worker-health digest served at ``/ops/digest``:
    per-dataset identity (the divergence signal), delta-tail depth/rows
    (the freshness-lag signal), delta publishes, open breakers and the
    device recorder's health fields. Every field reads lock-free engine
    snapshots. ``extras`` lets an embedded coordinator add its app-tier
    signals (SLO breaches, slow-query count, top cost tenants)."""
    base_fp = getattr(engine, "base_fingerprint", None)
    ds_fps_fn = getattr(engine, "dataset_fingerprints", None)
    delta_stats = getattr(engine, "delta_stats", None)
    delta_metrics = getattr(engine, "delta_metrics", None)
    datasets = engine.datasets()
    ds_fps = dict(
        sorted((ds_fps_fn() if ds_fps_fn is not None else {}).items())[
            :DIGEST_DATASET_CAP
        ]
    )
    breakers: list[str] = []
    breaker = getattr(engine, "breaker", None)
    if breaker is not None:
        breakers = sorted(
            u
            for u, d in breaker.metrics().items()
            if d.get("state") != "closed"
        )
    doc = {
        "time": time.time(),
        "datasets": datasets[:DIGEST_DATASET_CAP],
        "datasetsTotal": len(datasets),
        "baseFingerprint": (
            base_fp() if base_fp is not None else engine.index_fingerprint()
        ),
        "datasetFingerprints": ds_fps,
        "deltaTails": delta_stats() if delta_stats is not None else {},
        "deltaPublishes": (
            delta_metrics().get("publishes", 0)
            if delta_metrics is not None
            else 0
        ),
        "openBreakers": breakers,
        # device-health fields (module attr, not a from-import: the
        # recorder is process-global and tests swap it)
        "midRequestCompiles": (
            telemetry_mod.flight_recorder.mid_request_compiles()
        ),
        "worstPadWaste": telemetry_mod.flight_recorder.worst_pad_waste(),
    }
    if extras:
        doc.update(extras)
    return doc


# -- coordinator side ---------------------------------------------------------


def register_dispatch_metrics(registry, supplier) -> None:
    """The coordinator fan-out's own series. ``supplier`` returns the
    current :meth:`DistributedEngine.dispatch_stats` dict (empty on
    single-host engines — the app's fallback registration keeps the
    catalogue deployment-stable, like the breaker series). The JAX
    package's ``mesh.fallbacks`` series has no producer here (the tier
    raises instead of falling back)."""

    def field(name):
        return lambda: supplier().get(name, 0)

    registry.counter(
        "dispatch.short_circuits",
        "boolean fan-outs answered before the full worker drain",
        fn=field("short_circuits"),
    )
    registry.counter(
        "dispatch.failovers",
        "worker search legs re-routed to another replica after a failure",
        fn=field("failovers"),
    )
    registry.counter(
        "dispatch.partial_responses",
        "searches answered partially with some datasets unavailable",
        fn=field("partial_responses"),
    )
    registry.gauge(
        "routing.replicas",
        "replica routes in the table (sum of copies across datasets)",
        fn=field("replicas"),
    )
    registry.counter(
        "routing.rediscoveries",
        "background route-rediscovery passes run to heal dead routes",
        fn=field("rediscoveries"),
    )
    registry.counter(
        "mesh.dispatches",
        "k-shard queries answered by the pod-local single-launch tier",
        fn=field("mesh_dispatches"),
    )
    registry.counter(
        "mesh.gather_rows",
        "hit rows gathered on-device by the mesh tier's row gather",
        fn=field("mesh_gather_rows"),
    )
    registry.counter(
        "mesh.refusals",
        "queries the mesh tier declined, by reason (planes = "
        "plane-reading shape the stack cannot serve, stale = publish "
        "outran the stack, min_shards = too few local targets, "
        "unbuilt = no stack yet)",
        label="reason",
        fn=lambda: supplier().get("mesh_refusals", {}) or {},
    )
    registry.counter(
        "fleet.digest_polls",
        "worker /ops/digest collection passes run by the fleet view",
        fn=field("fleet_polls"),
    )
    registry.gauge(
        "fleet.workers_reachable",
        "workers whose latest digest poll answered",
        fn=field("fleet_reachable"),
    )
    registry.gauge(
        "fleet.divergent_datasets",
        "datasets whose replicas advertise divergent fingerprints",
        fn=field("fleet_divergent"),
    )
    registry.counter(
        "migration.started",
        "shard migrations started (copy phase entered)",
        fn=field("migration_started"),
    )
    registry.counter(
        "migration.completed",
        "shard migrations completed through cut-over",
        fn=field("migration_completed"),
    )
    registry.counter(
        "migration.rolled_back",
        "shard migrations aborted and rolled back (verify mismatch, "
        "crash mid-protocol)",
        fn=field("migration_rolled_back"),
    )
    registry.counter(
        "migration.bytes_copied",
        "artifact bytes streamed source->target by migration copies",
        fn=field("migration_bytes_copied"),
    )


def _graft_worker_spans(wsp, url: str, meta, rtt_s: float) -> None:
    """Adopt one worker leg's span summary (the ``meta`` block of a
    ``/search`` answer) as child spans of the coordinator's
    ``dispatch.worker_call`` span. Network time is DERIVED (RTT minus
    the worker-reported total, split evenly around the remote span: the
    coordinator cannot observe the clock skew) and the worker's
    queue/engine/serialize stages lay out sequentially inside it. No-op
    when tracing is off (``wsp`` is the null span) or the worker sent
    no summary."""
    sp = getattr(wsp, "span", None)
    if sp is None or not isinstance(meta, dict):
        return
    try:
        total_ms = float(meta.get("totalMs") or 0.0)
    except (TypeError, ValueError):
        return
    rtt_ms = rtt_s * 1e3
    net_ms = max(rtt_ms - total_ms, 0.0)
    wsp.note(
        networkMs=round(net_ms, 3),
        workerMs=round(total_ms, 3),
        rows=meta.get("rows", 0),
        cache=meta.get("cache", ""),
    )
    now = time.perf_counter()
    w_start = now - rtt_s + net_ms / 2e3
    remote = Span(
        name="worker.remote",
        t_start=w_start,
        t_end=w_start + total_ms / 1e3,
        meta={
            "url": url,
            "rows": meta.get("rows", 0),
            "cache": meta.get("cache", ""),
            "datasets": meta.get("datasets", 0),
        },
        trace_id=sp.trace_id,
        span_id=str(meta.get("spanId") or new_span_id()),
    )
    t = w_start
    for name, key in (
        ("worker.queue", "queueMs"),
        ("worker.engine", "engineMs"),
        ("worker.serialize", "serializeMs"),
    ):
        try:
            ms = float(meta.get(key) or 0.0)
        except (TypeError, ValueError):
            ms = 0.0
        if ms <= 0.0:
            continue
        remote.children.append(
            Span(
                name=name,
                t_start=t,
                t_end=t + ms / 1e3,
                trace_id=sp.trace_id,
                span_id=new_span_id(),
            )
        )
        t += ms / 1e3
    sp.children.append(remote)


def _fingerprint_freshness(fp: str) -> int:
    """Total indexed rows encoded in a per-dataset fingerprint (the
    ``vcf|variant_count|call_count|n_rows`` base parts and the
    ``vcf#d<epoch>|rows`` standing delta-tail parts, joined by ``&``) —
    the 'newer copy' heuristic for divergent replicas: re-ingestion only
    grows a dataset's row count. Only the exact 4-field base / 2-field
    epoch-tagged delta shapes parse; anything else sorts oldest (an
    ENGINE-WIDE fallback string must lose to real per-dataset identity,
    not out-freshen it by summing rows across unrelated datasets)."""
    total = 0
    for part in fp.split("&"):
        fields = part.split("|")
        # delta-tail parts count toward freshness, so a deeper-tail copy
        # out-freshens its base twin
        if len(fields) == 2 and "#d" in fields[0]:
            pass
        elif len(fields) != 4:
            return -1
        try:
            total += int(fields[-1])
        except ValueError:
            return -1
    return total


def _fingerprint_parts(
    fp: str,
) -> tuple[frozenset, frozenset] | None:
    """(base parts, delta-tail parts) of a per-dataset fingerprint, or
    None when any part fails the grammar (engine-wide strings never
    enter the tail-superset relation)."""
    bases, deltas = set(), set()
    for part in fp.split("&"):
        fields = part.split("|")
        if len(fields) == 2 and "#d" in fields[0]:
            deltas.add(part)
        elif len(fields) == 4:
            bases.add(part)
        else:
            return None
    return frozenset(bases), frozenset(deltas)


class ReplicaRouter:
    """Replica selection for the search fan-out.

    The discovery pass publishes a ``dataset -> (replica urls)`` table
    here (only fingerprint-compatible copies are grouped); ``pick``
    chooses among the live replicas by power-of-two-choices over the
    recent per-worker RTT record: sample two, take the faster, skip
    breaker-open routes. One slow or dead host then stops attracting
    traffic without any health-check protocol. The sampling draws from
    ``rng`` (a seeded ``random.Random`` by default, so routing spread is
    reproducible).
    """

    #: recent round-trips kept per replica for the p2c comparison and
    #: the adaptive hedge delay
    RTT_WINDOW = 128
    #: adaptive hedging needs this many completed calls before the p95
    #: means anything; until then no hedge fires
    HEDGE_MIN_SAMPLES = 8
    #: adaptive hedge delay never drops below this (a sub-ms p95 would
    #: hedge every call and double fleet load for nothing)
    HEDGE_FLOOR_S = 0.05

    def __init__(self, breaker: CircuitBreaker, *,
                 rng: random.Random | None = None):
        self.breaker = breaker
        self._rng = rng or random.Random(0xBEAC0)
        self._lock = threading.Lock()
        self._table: dict[str, tuple[str, ...]] = {}
        self._rtts: dict[str, collections.deque] = {}
        # (dataset, url) pairs routed OUT: publish() filters them inside
        # its own critical section, so a concurrent rediscovery
        # republish can never resurrect a retired route
        self._retired: set[tuple[str, str]] = set()

    # -- table --------------------------------------------------------------

    def publish(self, table: dict[str, tuple[str, ...]]) -> None:
        new = {ds: tuple(urls) for ds, urls in table.items()}
        with self._lock:
            if self._retired:
                new = {
                    ds: tuple(
                        u for u in urls if (ds, u) not in self._retired
                    )
                    for ds, urls in new.items()
                }
            changed = new != self._table
            self._table = new
        if changed:
            # only actual topology changes are events (the rediscovery
            # loop republishes every pass)
            publish_event(
                "routing.table_publish",
                datasets=len(new),
                replicas=sum(len(u) for u in new.values()),
            )

    def table(self) -> dict[str, tuple[str, ...]]:
        with self._lock:
            return dict(self._table)

    def replicas(self, dataset: str) -> tuple[str, ...]:
        with self._lock:
            return self._table.get(dataset, ())

    def replica_count(self) -> int:
        with self._lock:
            return sum(len(urls) for urls in self._table.values())

    def retire(self, dataset: str, url: str) -> None:
        """Route ``url`` out of ``dataset``'s replica set ATOMICALLY:
        the pin lands and the url leaves the live table inside ONE
        critical section. Retired pairs survive republish."""
        with self._lock:
            self._retired.add((dataset, url))
            urls = self._table.get(dataset)
            if urls and url in urls:
                self._table[dataset] = tuple(
                    u for u in urls if u != url
                )
        publish_event("routing.route_retired", dataset=dataset, url=url)

    def unretire(self, dataset: str, url: str) -> None:
        """Lift a retire pin: the next publish may route the pair again
        if a worker advertises it."""
        with self._lock:
            self._retired.discard((dataset, url))

    def retired(self) -> set[tuple[str, str]]:
        with self._lock:
            return set(self._retired)

    # -- RTT record ---------------------------------------------------------

    def note_rtt(self, url: str, seconds: float) -> None:
        with self._lock:
            ring = self._rtts.get(url)
            if ring is None:
                ring = self._rtts[url] = collections.deque(
                    maxlen=self.RTT_WINDOW
                )
            ring.append(seconds)

    def _rtt(self, url: str) -> float | None:
        """Median recent RTT, or None for an unmeasured replica (treated
        as fast, so fresh replicas get explored instead of starved)."""
        with self._lock:
            ring = self._rtts.get(url)
            if not ring:
                return None
            s = sorted(ring)
        return s[len(s) // 2]

    def median_rtt_ms(self, url: str) -> float | None:
        """Public median-RTT view (``/debug/status`` worker rollup)."""
        rtt = self._rtt(url)
        return None if rtt is None else round(rtt * 1e3, 2)

    def hedge_delay(self, hedge_delay_s: float | None) -> float | None:
        """Seconds to wait before racing a second replica: >0 fixed, 0
        adaptive (p95 of recent RTTs once enough samples exist), <0 or
        None off. The brownout kill switch (``hedging_enabled``)
        overrides all."""
        d = hedge_delay_s
        if d is None or d < 0 or not hedging_enabled():
            return None
        if d > 0:
            return d
        with self._lock:
            all_rtts = [v for ring in self._rtts.values() for v in ring]
        if len(all_rtts) < self.HEDGE_MIN_SAMPLES:
            return None
        all_rtts.sort()
        return max(
            all_rtts[int(0.95 * (len(all_rtts) - 1))], self.HEDGE_FLOOR_S
        )

    # -- selection ----------------------------------------------------------

    def live(self, url: str) -> bool:
        """Pure observation — never consumes a half-open probe (the
        call-site ``allow`` gate does that once per attempted call)."""
        return self.breaker.state(url) != OPEN

    def pick(self, dataset: str, *, avoid=()) -> str | None:
        """The replica to route ``dataset`` to, or None when every copy
        is in ``avoid`` (failover exhausted the replica set)."""
        cands = [u for u in self.replicas(dataset) if u not in avoid]
        if not cands:
            return None
        # breaker-open routes are skipped while an alternative exists;
        # with every copy open, route anyway — the call-site gate
        # raises CircuitOpen cheaply and keeps the half-open probing
        live = [u for u in cands if self.live(u)] or cands
        if len(live) == 1:
            return live[0]
        a, b = self._rng.sample(live, 2)
        ra = self._rtt(a) or 0.0
        rb = self._rtt(b) or 0.0
        return a if ra <= rb else b


class ScanWorkerPool:
    """Coordinator-side round-robin scatter of ingest slice scans.

    The pipeline hands each planned slice to ``scan_blob``; failures
    (worker down, auth, scan error) raise WorkerError and the caller
    falls back to scanning locally — a missing worker degrades
    throughput, never correctness (reference analogue: a failed
    summariseSlice lambda's slice stays in the toUpdate set and is
    re-run). A worker that fails trips its circuit (one-strike breaker:
    open for ``cooldown_s``, then a half-open probe) so one wedged host
    cannot stall every slice for a full timeout each (the dead-worker
    exclusion the query-path scatter already has via discovery refresh).

    Scans are *hedged* (Dean & Barroso, The Tail at Scale): when the
    primary worker has not answered within the hedge delay — fixed, or
    adaptive at the p95 of recent scan RTTs — the same slice races on a
    second worker and the first response wins; the loser is abandoned
    (slice scans are idempotent reads, so duplicate execution only
    costs the loser's CPU). One slow host then bounds *its own* calls,
    not every slice routed to it.
    """

    #: adaptive hedging needs this many completed scans before the p95
    #: means anything; until then no hedge fires
    HEDGE_MIN_SAMPLES = 8
    #: adaptive hedge delay never drops below this (a sub-ms p95 would
    #: hedge every call and double cluster load for nothing)
    HEDGE_FLOOR_S = 0.05

    def __init__(
        self,
        worker_urls: list[str],
        *,
        token: str = "",
        timeout_s: float = 120.0,
        retries: int = 1,
        cooldown_s: float = 30.0,
        post_bytes=None,
        hedge_delay_s: float = 0.0,
        transport: PooledTransport | None = None,
        transport_config=None,
    ):
        if not worker_urls:
            raise ValueError("ScanWorkerPool needs at least one worker URL")
        self.worker_urls = list(worker_urls)
        self.token = token
        self.timeout_s = timeout_s
        self.retries = retries
        self.cooldown_s = cooldown_s
        self.hedge_delay_s = hedge_delay_s
        self._owns_transport = False
        if post_bytes is None:
            if transport is None:
                # built here -> owned here: close() releases the
                # sockets (a caller-passed transport stays caller-owned)
                transport = (
                    PooledTransport.from_config(transport_config)
                    if transport_config is not None
                    else PooledTransport()
                )
                self._owns_transport = True
            post_bytes = transport.post_bytes
        self.transport = transport
        self._post_bytes = post_bytes
        self._bytes_ok = bool(getattr(post_bytes, "accepts_bytes", False))
        self._next = 0
        # a single failure opens the circuit for cooldown_s (scan
        # slices have a local fallback, so one strike is the right
        # threshold), then a half-open probe readmits the worker
        self.breaker = CircuitBreaker(
            failure_threshold=1, reset_timeout_s=cooldown_s
        )
        self._lock = threading.Lock()
        self._rtts: collections.deque = collections.deque(maxlen=128)
        self._hedges = 0
        self._hedge_wins = 0
        self._hedge_exec: ThreadPoolExecutor | None = None

    def close(self) -> None:
        """Release the hedge pool and any owned connection pool."""
        with self._lock:
            pool, self._hedge_exec = self._hedge_exec, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        if self._owns_transport and self.transport is not None:
            self.transport.close()

    def _pick(self) -> str:
        with self._lock:
            for _ in range(len(self.worker_urls)):
                url = self.worker_urls[self._next % len(self.worker_urls)]
                self._next += 1
                if self.breaker.allow(url):
                    return url
            # every worker's circuit is open: take the next anyway (it
            # may have recovered; correctness is covered by local
            # fallback)
            url = self.worker_urls[self._next % len(self.worker_urls)]
            self._next += 1
            return url

    def _pick_other(self, avoid: str) -> str | None:
        """A healthy worker other than ``avoid`` (the hedge target), or
        None when the fleet has no alternative."""
        with self._lock:
            for _ in range(len(self.worker_urls)):
                url = self.worker_urls[self._next % len(self.worker_urls)]
                self._next += 1
                if url != avoid and self.breaker.allow(url):
                    return url
        return None

    def _mark_dead(self, url: str) -> None:
        self.breaker.record_failure(url)

    def _auth_headers(self) -> dict | None:
        return (
            {"Authorization": f"Bearer {self.token}"} if self.token else None
        )

    # -- hedging ------------------------------------------------------------

    def _effective_hedge_delay(self) -> float | None:
        """Seconds to wait before racing a second worker, or None when
        hedging is off (disabled, single worker, or adaptive mode
        without enough RTT history yet)."""
        d = self.hedge_delay_s
        if (
            d is None
            or d < 0
            or len(self.worker_urls) < 2
            or not hedging_enabled()
        ):
            return None
        if d > 0:
            return d
        with self._lock:
            if len(self._rtts) < self.HEDGE_MIN_SAMPLES:
                return None
            s = sorted(self._rtts)
        return max(s[int(0.95 * (len(s) - 1))], self.HEDGE_FLOOR_S)

    def _hedge_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._hedge_exec is None:
                # sized for the ingest pipeline's concurrent run_slice
                # callers plus their hedges: a primary queued behind a
                # full pool must be rare (and is hedge-gated below)
                self._hedge_exec = ThreadPoolExecutor(
                    max_workers=max(8, 2 * len(self.worker_urls)),
                    thread_name_prefix="scan-hedge",
                )
            return self._hedge_exec

    def _note_hedge(self, primary: str, hedge: str) -> None:
        with self._lock:
            self._hedges += 1
        note_hedge()  # process-wide transport.hedges counter
        publish_event("scan.hedge", primary=primary, hedge=hedge)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "rtt_samples": len(self._rtts),
            }

    # -- the scan call ------------------------------------------------------

    def _scan_once(self, url: str, body, headers) -> tuple[int, bytes]:
        """One raw /scan exchange; successful RTTs feed the adaptive
        hedge delay."""
        t0 = time.perf_counter()
        status, out = self._post_bytes(
            f"{url}/scan", body, self.timeout_s, headers
        )
        if status == 200:
            with self._lock:
                self._rtts.append(time.perf_counter() - t0)
        return status, out

    def _settle(
        self, url: str, status: int, out: bytes, last
    ) -> tuple[bytes | None, Exception | None]:
        """Breaker bookkeeping for one answered scan: the blob on 200,
        else the WorkerError to remember."""
        if status == 200:
            self.breaker.record_success(url)
            return out, last
        err = WorkerError(f"{url}: http {status}: {out[:200]!r}")
        if status in (401, 403):
            self._mark_dead(url)
        else:
            # any other HTTP answer proves the worker is ALIVE
            # (the breaker tracks reachability, not scan success —
            # scan errors are handled by retry + local fallback);
            # recording an outcome also releases a half-open probe
            # so a 500-answering worker is not excluded forever
            self.breaker.record_success(url)
        return None, err

    def scan_blob(self, payload: SliceScanPayload) -> bytes:
        """One slice scan on some worker -> the shard's npz blob
        (columnar.dumps_index form), undecoded."""
        # serialize ONCE: a bytes-capable transport ships these bytes
        # verbatim; legacy injected transports still get the dict
        body = (
            payload.dumps().encode()
            if self._bytes_ok
            else json.loads(payload.dumps())
        )
        headers = self._auth_headers()
        last: Exception | None = None
        for _attempt in range(self.retries + 1):
            url = self._pick()
            delay = self._effective_hedge_delay()
            if delay is None:
                try:
                    status, out = self._scan_once(url, body, headers)
                except Exception as e:
                    last = WorkerError(f"{url}: {e}")
                    self._mark_dead(url)
                    continue
                got, last = self._settle(url, status, out, last)
                if got is not None:
                    return got
                continue
            got, last = self._scan_hedged(url, body, headers, delay, last)
            if got is not None:
                return got
        raise last

    def _scan_hedged(
        self, url: str, body, headers, delay: float, last
    ) -> tuple[bytes | None, Exception | None]:
        """One hedged attempt: primary on a pool thread; if it has not
        answered within ``delay`` of its start (``_hedge_due``), race a
        second worker. First response wins; the loser keeps running and
        is ignored."""
        pool = self._hedge_pool()
        started = threading.Event()

        def primary():
            # stamps actual start: under a saturated pool the submit
            # may queue, and a queued primary must not trigger a hedge
            # (the delay would measure queue wait, not the worker, and
            # the hedge would pile more load onto the same full pool)
            started.set()
            return self._scan_once(url, body, headers)

        fut = pool.submit(primary)
        futs = {fut: url}
        if _hedge_due(fut, started, delay):
            other = self._pick_other(url)
            if other is not None:
                self._note_hedge(url, other)
                futs[
                    pool.submit(self._scan_once, other, body, headers)
                ] = other
        pending = set(futs)
        while pending:
            done, pending = futures_mod.wait(
                pending, return_when=futures_mod.FIRST_COMPLETED
            )
            for f in done:
                u = futs[f]
                try:
                    status, out = f.result()
                except Exception as e:
                    last = WorkerError(f"{u}: {e}")
                    self._mark_dead(u)
                    continue
                got, last = self._settle(u, status, out, last)
                if got is not None:
                    if u != url:  # the hedge beat the primary
                        with self._lock:
                            self._hedge_wins += 1
                        publish_event(
                            "scan.hedge_won", winner=u, primary=url
                        )
                    return got, last
        return None, last

    def scan(self, payload: SliceScanPayload):
        """One slice scan on some worker -> VariantIndexShard."""
        from ..index.columnar import loads_index

        return loads_index(self.scan_blob(payload))

    #: reload is a tiny control message — never let it inherit the
    #: (possibly minutes-long) slice-scan timeout
    RELOAD_TIMEOUT_S = 10.0

    def reload_workers(self, *, post=None) -> int:
        """Best-effort concurrent POST /reload to every worker
        (shared-storage fleets re-pin freshly ingested shards without a
        restart); returns how many workers acknowledged. Concurrent with
        a short timeout so one wedged worker cannot stall ingest
        completion, and non-200 answers (404 = reload_fn not wired,
        500 = reload failed) are logged — a fleet silently serving stale
        shards is exactly the failure this call exists to prevent.

        Outcomes feed the scan breaker: any HTTP answer proves the
        worker reachable again (revival after a cooldown — e.g. an
        operator fixed a bad token), except 401/403 which re-confirm
        the auth failure; a transport error keeps/opens the circuit."""
        headers = self._auth_headers()
        if post is None:
            post = (
                self.transport.post_json
                if self.transport is not None
                else urllib_post
            )

        def one(url: str) -> bool:
            try:
                status, doc = post(
                    f"{url}/reload", {}, self.RELOAD_TIMEOUT_S, headers
                )
            except Exception:
                log.warning("worker %s reload failed", url, exc_info=True)
                self._mark_dead(url)
                return False
            if status in (401, 403):
                self._mark_dead(url)
            else:
                self.breaker.record_success(url)
            if status != 200:
                log.warning(
                    "worker %s reload answered http %s: %s",
                    url,
                    status,
                    doc,
                )
                return False
            return True

        with ThreadPoolExecutor(min(8, len(self.worker_urls))) as pool:
            ok = sum(pool.map(one, self.worker_urls))
        if ok < len(self.worker_urls):
            log.warning(
                "only %d/%d workers reloaded; the others serve stale "
                "shards until their next reload/restart",
                ok,
                len(self.worker_urls),
            )
        return ok



class WorkerError(RuntimeError):
    """A worker leg failed: an error answer, a transport failure, or
    every retry spent."""


class MeshDispatchTier:
    """Pod-local single-launch dispatch over a mesh-sharded fused index.

    The tier is an optimisation a caller consults per query (``resolve``
    then ``search``): dataset groups it cannot serve (stack not built
    yet, stale after a publish, a plane-reading shape the stack cannot
    answer, fewer than ``min_shards`` targets) keep the engine's own
    paths, and each refusal is counted by reason. ``min_shards``
    defaults to the engine config's ``mesh_min_shards``; ``layout`` is
    the stack's output layout (``parallel.mesh.LAYOUT_*``: owner-sharded
    by default, or combined over the entries through the ring gather)."""

    def __init__(self, engine, *, min_shards: int | None = None,
                 axis: str = "d", devices=None,
                 layout: int = _mesh.LAYOUT_OWNER):
        self.engine = engine
        if min_shards is None:
            min_shards = engine.config.engine.mesh_min_shards
        self.min_shards = max(1, int(min_shards))
        self.axis = axis
        self.layout = layout
        self._devices = None if devices is None else list(devices)
        self._lock = threading.Lock()
        # (MeshFusedIndex, {key: sid}, {key: shard}, {ds: [keys]}, fp,
        #  {key: plane_index})
        self._state: tuple | None = None
        self._building = False
        # fingerprint a build declined (too few shards): no rebuild per
        # query for an index set that cannot produce a tier
        self._skip_fp: str | None = None
        # (fingerprint, exception) of a failed background build: raised
        # by every consult until the index set changes
        self._error: tuple | None = None
        self._builds: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
        self._dispatches = 0
        self._gather_rows = 0
        # why queries fell off the tier, by reason: planes (a plane shape
        # the stack cannot serve), stale (a publish outran the stack),
        # min_shards (too few local targets), unbuilt (no stack yet,
        # fewer than two mesh entries included)
        self._refusals: dict[str, int] = {}
        # close() raced a background build: the build re-checks this
        # before publishing or registering plane bytes
        self._tier_closed = False
        self._built_at: float | None = None

    # -- availability / build ----------------------------------------------

    def _entries_on_engine(self, mesh) -> int:
        """Mesh entries on the engine's own device, the one its plane
        budget covers: each holds its own copy of a block's planes."""
        return _mesh.entries_on(mesh, self.engine.device)

    def _engine_bytes(self, index) -> int:
        """The stack's plane bytes on the engine's device."""
        return index.plane_bytes_device * self._entries_on_engine(index.mesh)

    def _mesh_devices(self) -> list:
        if self._devices is not None:
            return self._devices
        return _mesh.mesh_devices(self.engine.device)

    def available(self) -> bool:
        """Two or more mesh entries: a one-entry 'pod' would only re-spell
        the fused single-device stack, which the engine already serves."""
        return len(self._mesh_devices()) >= 2

    def _snapshot(self):
        """(keys, shards, planes_of) the stack would build from, via the
        engine's locked snapshot; ``planes_of`` maps keys to the device
        plane index of the same publish."""
        triples = self.engine.index_snapshot()
        return ([k for k, _s, _p in triples], [s for _k, s, _p in triples],
                {k: p for k, _s, p in triples})

    def _ready(self, wait: bool = False):
        """The current state, or None while unbuilt or stale (the caller
        keeps the engine's paths). A stale state arms a background
        rebuild; ``wait=True`` builds inline on the caller's thread. A
        failed background build for the current index set raises."""
        if not self.available():
            return None
        fp = self.engine.base_fingerprint()
        while True:
            with self._lock:
                if self._tier_closed:
                    return None
                state = self._state
                if state is not None and state[4] == fp:
                    return state
                err = self._error
                if err is not None and err[0] == fp and not wait:
                    raise RuntimeError(
                        "the mesh dispatch tier failed to build"
                    ) from err[1]
                if self._skip_fp == fp and not wait:
                    return None
                if not self._building:
                    self._building = True
                    break
                if not wait:
                    return None
            # wait=True with a background build in flight: join it
            # instead of racing a duplicate stack build
            time.sleep(0.05)
        if wait:
            return self._build(fp, inline=True)
        dev = torch.device(self.engine.device)
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        t = threading.Thread(target=self._build_on, args=(fp, dev, stream),
                             name="mesh-tier-build", daemon=True)
        self._builds.add(t)
        t.start()
        return None

    def _build_on(self, fp, dev, stream):
        """The background build, on the engine's device and stream."""
        if stream is None:
            return self._build(fp)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            return self._build(fp)

    def _build(self, fp: str, *, inline: bool = False):
        """Build and publish the stack over the engine's snapshot. The
        plane budget is checked and reserved atomically before the
        build. A failure rolls the reservation back to the stack still
        serving and raises when inline; in the background it is kept for
        the next consult to raise."""
        try:
            state = self._build_state(fp)
        except BaseException as e:
            with self._lock:
                self._error = (fp, e)
                prev = (self._engine_bytes(self._state[0])
                        if self._state is not None else 0)
            self.engine.register_plane_bytes(self, prev)
            if inline:
                raise
            return None
        finally:
            with self._lock:
                self._building = False
        return state

    def _build_state(self, fp):
        keys, shards, planes_of = self._snapshot()
        if len(keys) < self.min_shards:
            with self._lock:
                self._skip_fp = fp
            return None
        mesh = _mesh.make_mesh(devices=self._mesh_devices(), axis=self.axis)
        eng_cfg = self.engine.config.engine
        # the previous stack keeps serving until the new state publishes,
        # so it stays accounted through the build
        with self._lock:
            prev_bytes = (self._engine_bytes(self._state[0])
                          if self._state is not None else 0)
        with_planes = all(s.gt_bits is not None for s in shards)
        if with_planes:
            per_dev = _mesh.MeshFusedIndex.plane_bytes_per_device(
                shards, n_dev=mesh.size)
            # atomic check-and-reserve BEFORE the build: a per-dataset
            # upload admitted mid-build sees these bytes
            with_planes = self.engine.try_reserve_plane_bytes(
                self, prev_bytes + per_dev * self._entries_on_engine(mesh),
                eng_cfg.plane_hbm_budget_gb * 1e9)
        index = _mesh.MeshFusedIndex(
            shards, mesh, axis=self.axis, with_planes=with_planes,
            layout=self.layout,
        )
        for dev in {d for d in mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)  # the uploads are on the card
        sid_of = {k: i for i, k in enumerate(keys)}
        keys_by_ds: dict[str, list] = {}
        for k in keys:
            keys_by_ds.setdefault(k[0], []).append(k)
        state = (index, sid_of, dict(zip(keys, shards)), keys_by_ds, fp,
                 planes_of)
        reg = self.engine.register_plane_bytes
        with self._lock:
            if self._tier_closed:
                reg(self, 0)
                return None
            self._state = state
            self._error = None
            self._built_at = time.time()
        # settle the budget on the new stack alone (a plane-less rebuild
        # releases the old stack's bytes)
        reg(self, self._engine_bytes(index))
        with self._lock:
            raced_close = self._tier_closed
        if raced_close:
            reg(self, 0)
            return None
        return state

    def close(self) -> None:
        """Drop the state and release the stack's plane bytes from the
        engine's budget ledger; an in-flight background build sees the
        flag and discards itself, and is joined here."""
        with self._lock:
            self._tier_closed = True
            self._state = None
        for t in list(self._builds):
            t.join()
        self.engine.register_plane_bytes(self, 0)

    def warmup(self) -> int:
        """Build inline and launch the tier once (and once with planes
        when the stack holds them), which builds and loads its kernels;
        returns the launch count (0 when the tier cannot engage)."""
        from ..ops.kernel import QuerySpec, encode_queries

        state = self._ready(wait=True)
        if state is None:
            return 0
        index = state[0]
        eng = self.engine.config.engine
        spec = QuerySpec("1", 1, 1, 1, 2)
        # one query per entry that owns a shard
        sids = [g * index.d_local for g in range(index.n_dev)
                if g * index.d_local < index.n_shards]
        kw = [{}]
        if index.has_planes:
            kw.append(dict(
                sample_masks=np.zeros((len(sids), index.plane_words),
                                      np.uint32),
                mask_counts=np.zeros(len(sids), np.bool_),
            ))
        for extra in kw:
            index.run_mesh_queries(
                encode_queries([spec] * len(sids), shard_ids=sids),
                window_cap=eng.window_cap, record_cap=eng.record_cap, **extra,
            )
        return len(kw)

    # -- per-query consult ---------------------------------------------------

    def _note_refusal(self, reason: str) -> None:
        with self._lock:
            self._refusals[reason] = self._refusals.get(reason, 0) + 1

    def resolve(self, dataset_ids, payload) -> set:
        """The subset of ``dataset_ids`` this tier serves for this query:
        empty when it should not engage (unbuilt or stale stack, a plane
        shape the stack cannot answer, below ``min_shards``), each
        refusal counted by reason."""
        if not dataset_ids:
            return set()
        # read before _ready: a background build it arms may publish a
        # state before the refusal is counted
        with self._lock:
            built = self._state is not None
        state = self._ready()
        if state is None:
            if built:
                self._note_refusal("stale")
                plan_stage("mesh", decision="refused", reason="stale")
            else:
                self._note_refusal("unbuilt")
                plan_stage("mesh", decision="refused", reason="unbuilt")
            return set()
        index = state[0]
        if self.engine._wants_planes(payload):
            # plane shapes ride the launch when the stack carries the
            # planes AND device row matching is exact for this query (an
            # N-wildcard ref needs host semantics; payload doubles as the
            # spec, only reference_bases is read)
            if not (index.has_planes
                    and self.engine._device_ref_ok(payload, payload)):
                self._note_refusal("planes")
                plan_stage("mesh", decision="refused", reason="planes",
                           has_planes=bool(index.has_planes))
                return set()
        keys_by_ds = state[3]
        covered = {ds for ds in dataset_ids if ds in keys_by_ds}
        n_targets = sum(len(keys_by_ds[ds]) for ds in covered)
        if n_targets < self.min_shards:
            self._note_refusal("min_shards")
            plan_stage("mesh", decision="refused", reason="min_shards",
                       targets=n_targets, min_shards=self.min_shards)
            return set()
        return covered

    def search(self, payload, dataset_ids) -> list:
        """Answer ``dataset_ids`` (a :meth:`resolve` result) with one mesh
        launch for the stacked base shards, then their delta tail: the
        base responses in sorted key order, the tail's after them.
        Raises on any failure."""
        from ..engine import host_match_rows, materialize_response
        from ..ops.kernel import QuerySpec, encode_queries
        from ..ops.plane_kernel import sample_mask_words

        fault_point("mesh.dispatch")
        current_deadline().check("mesh.dispatch")
        with self._lock:
            state = self._state
        if state is None:
            raise WorkerError("mesh tier state gone")
        index, sid_of, shard_of, keys_by_ds, _fp, planes_of = state
        plane_q = self.engine._wants_planes(payload)
        spec_base = QuerySpec(
            chrom=payload.reference_name,
            start_min=payload.start_min,
            start_max=payload.start_max,
            end_min=payload.end_min,
            end_max=payload.end_max,
            reference_bases=payload.reference_bases,
            alternate_bases=payload.alternate_bases,
            variant_type=payload.variant_type,
            variant_min_length=payload.variant_min_length,
            variant_max_length=payload.variant_max_length,
        )
        targets = []
        for ds in sorted(dataset_ids):
            for key in keys_by_ds.get(ds, ()):
                shard = shard_of[key]
                native = shard.meta.get("chrom_native", {}).get(
                    payload.reference_name)
                if native is None:
                    continue  # no matching chromosome in this VCF
                targets.append((key, shard, native, sid_of[key]))
        # the delta tail: shards published since the stack was built (the
        # base fingerprint did not move, so the stack is not stale)
        delta_targets = []
        for ds, vcf, (shard, _di, pl) in self.engine.indexes_for(
                sorted(dataset_ids)):
            if (ds, vcf) in sid_of:
                continue  # base rows: the mesh launch serves them
            native = shard.meta.get("chrom_native", {}).get(
                payload.reference_name)
            if native is None:
                continue
            delta_targets.append(((ds, vcf), shard, native, pl))
        if not targets and not delta_targets:
            return []
        eng = self.engine.config.engine
        specs = [spec_base] * len(targets)
        sids = [sid for _k, _s, _n, sid in targets]
        sel_idx_of: dict = {}
        masks = mask_counts = None
        if plane_q:
            # per-query sample masks, sliced WITH the batch: the owning
            # entry reduces each query's matched rows under ITS mask.
            # Selected samples restrict to the named samples (with
            # genotype-derived counting when the count planes are
            # stacked); extraction takes the full-cohort mask and keeps
            # the INFO-column counts
            W = index.plane_words
            masks = np.zeros((len(targets), W), np.uint32)
            mask_counts = np.zeros(len(targets), np.bool_)
            for i, (key, shard, _native, _sid) in enumerate(targets):
                if payload.selected_samples_only:
                    sel = self.engine._selected_idx(shard, payload, key[0])
                    sel_idx_of[key] = sel
                    masks[i] = sample_mask_words(sel, W)
                    mask_counts[i] = index.has_count_planes
                else:
                    masks[i] = 0xFFFFFFFF
        responses = []
        gathered = 0
        batcher = self.engine.batcher
        if not targets:
            res = None
        elif batcher is not None:
            res = batcher.submit_many(
                index, specs, shard_ids=sids, window_cap=eng.window_cap,
                record_cap=eng.record_cap, sample_masks=masks,
                mask_counts=mask_counts,
            )
        else:
            fault_point("kernel.launch")
            res = index.run_mesh_queries(
                encode_queries(specs, shard_ids=sids),
                window_cap=eng.window_cap, record_cap=eng.record_cap,
                sample_masks=masks, mask_counts=mask_counts,
            )
        for i, (key, shard, native, _sid) in enumerate(targets):
            fused = None
            if res.overflow[i] or res.n_matched[i] > eng.record_cap:
                # window/record overflow: the uncapped host matcher, the
                # contract of every device kernel path
                rows = host_match_rows(
                    shard, spec_base,
                    ref_wildcard=payload.selected_samples_only,
                )
            else:
                keep = res.rows[i] >= 0
                rows = res.rows[i][keep]
                gathered += int(rows.size)
                # the fused triple is exact for this shard only when its
                # count-plane availability matches the stack-wide one (a
                # shard WITH count planes in a stack without them was
                # counted full-cohort); extraction shapes read only
                # or_words, which the count planes do not change
                if plane_q and res.or_words is not None and (
                    not payload.selected_samples_only
                    or index.has_count_planes
                    or not shard.has_count_planes
                ):
                    # or_words come back stack-wide (the widest shard's
                    # W): materialise in this shard's own width (its tail
                    # words are zero by construction)
                    w_shard = shard.gt_bits.shape[1]
                    fused = (
                        res.pc_call[i][keep],
                        res.pc_tok[i][keep],
                        np.asarray(res.or_words[i]).view(np.uint32)[:w_shard],
                    )
            responses.append(materialize_response(
                shard, rows, payload, chrom_label=native, dataset_id=key[0],
                vcf_location=key[1], selected_idx=sel_idx_of.get(key),
                plane_index=planes_of.get(key) if plane_q else None,
                fused=fused,
            ))
        # the tail: the engine's L0 index first (one launch for every
        # covered target; it charges the host-walked ones), the rest on
        # the host
        l0_rows = (
            self.engine.l0_pre_rows(
                [(key, shard) for key, shard, _n, _p in delta_targets],
                spec_base, payload,
            )
            if delta_targets else {}
        )
        l0_covered = sum(1 for v in l0_rows.values() if v is not None)
        for key, shard, native, pl in delta_targets:
            rows = l0_rows.get(key)
            if rows is None:
                rows = host_match_rows(
                    shard, spec_base,
                    ref_wildcard=payload.selected_samples_only,
                )
            responses.append(materialize_response(
                shard, rows, payload, chrom_label=native, dataset_id=key[0],
                vcf_location=key[1],
                selected_idx=(
                    self.engine._selected_idx(shard, payload, key[0])
                    if payload.selected_samples_only else None
                ),
                plane_index=pl if plane_q else None,
            ))
        with self._lock:
            self._dispatches += 1
            self._gather_rows += gathered
        annotate(mesh_shards=len(targets), mesh_delta_tail=len(delta_targets),
                 mesh_tail_l0=l0_covered, mesh_planes=plane_q)
        plan_stage("mesh", decision="served", shards=len(targets),
                   delta_tail=len(delta_targets), tail_l0=l0_covered,
                   planes=plane_q)
        return responses

    def stats(self) -> dict:
        with self._lock:
            state = self._state
            built_at = self._built_at
            out = {
                "dispatches": self._dispatches,
                "gather_rows": self._gather_rows,
                "refusals": dict(self._refusals),
            }
        out["ready"] = state is not None
        out["shards"] = len(state[1]) if state is not None else 0
        out["devices"] = state[0].n_dev if state is not None else 0
        out["planes"] = bool(state[0].has_planes) if state else False
        out["fingerprint"] = state[4] if state is not None else ""
        out["ageS"] = (
            round(time.time() - built_at, 1)
            if state is not None and built_at is not None
            else None
        )
        return out


class FleetView:
    """The coordinator's collected view of every worker's
    ``/ops/digest``, served at ``/fleet/status``. Digests are polled
    lazily at a bounded cadence — a ``snapshot()`` older than
    ``interval_s`` refreshes inline, so an unqueried fleet pays nothing
    and a dashboard polling every second still only touches workers
    once per interval. Polls ride the engine's authenticated transport,
    inside the worker-token boundary.

    The fleet-level ``diagnosis`` names the **stalest replica** (most
    fingerprint-losing dataset copies by the freshness heuristic, else
    the deepest standing delta tail), the **hottest worker** (highest
    median RTT from the router's own measurements), the **divergent
    datasets** (replicas advertising different copies), and the
    unreachable workers.
    """

    #: per-digest GET budget: a digest is a small control message and
    #: must never inherit the minutes-long search timeout
    DIGEST_TIMEOUT_S = 5.0

    def __init__(self, engine, *, interval_s: float = 10.0,
                 clock=time.monotonic):
        self.engine = engine
        self.interval_s = max(0.5, float(interval_s))
        self._clock = clock
        self._lock = threading.Lock()
        # single-flight refresh: concurrent stale snapshot() calls must
        # not each run a full worker sweep (non-blocking acquire — the
        # loser serves the cached view the winner is refreshing)
        self._poll_lock = threading.Lock()
        # url -> {"digest": dict|None, "error": str|None, "tMono": t}
        self._digests: dict[str, dict] = {}
        self._polls = 0
        self._last_poll: float | None = None

    def _poll_one(self, url: str) -> tuple[str, dict, bool]:
        t = self._clock()
        try:
            status, doc = self.engine._get_auth(
                f"{url}/ops/digest",
                min(self.DIGEST_TIMEOUT_S, self.engine.timeout_s),
            )
        except Exception as e:
            return (
                url,
                {
                    "digest": None,
                    "error": f"{type(e).__name__}: {e}",
                    "tMono": t,
                },
                False,
            )
        if status == 200 and isinstance(doc, dict):
            return url, {"digest": doc, "error": None, "tMono": t}, True
        return (
            url,
            {"digest": None, "error": f"http {status}", "tMono": t},
            False,
        )

    def poll(self) -> int:
        """One collection pass over every configured worker; returns
        how many answered. Workers are swept CONCURRENTLY so the pass is
        bounded by one digest timeout, not N of them. Failures are
        recorded per worker (an unreachable worker is a fleet-status
        finding, not an error)."""
        urls = list(self.engine.worker_urls)
        ok = 0
        if urls:
            with ThreadPoolExecutor(
                min(8, len(urls)), thread_name_prefix="fleet-digest"
            ) as pool:
                results = list(pool.map(self._poll_one, urls))
            with self._lock:
                for url, entry, answered in results:
                    self._digests[url] = entry
                    ok += int(answered)
        with self._lock:
            self._polls += 1
            self._last_poll = self._clock()
            for u in list(self._digests):
                if u not in urls:  # decommissioned mid-flight
                    del self._digests[u]
        return ok

    def _divergence(self, rows: dict) -> tuple[dict, dict]:
        """({dataset: {url: fp}} for divergent datasets,
        {url: stale-copy count}) over the cached digests."""
        by_ds: dict[str, dict[str, str]] = {}
        for url, e in rows.items():
            d = e.get("digest")
            if not d:
                continue
            for ds, fp in (d.get("datasetFingerprints") or {}).items():
                by_ds.setdefault(ds, {})[url] = fp
        divergent: dict[str, dict[str, str]] = {}
        stale_counts: dict[str, int] = {}
        for ds, fps in sorted(by_ds.items()):
            if len(set(fps.values())) <= 1:
                continue
            divergent[ds] = dict(sorted(fps.items()))
            win = max(
                fps.values(),
                key=lambda fp: (_fingerprint_freshness(fp), fp),
            )
            for url, fp in fps.items():
                if fp != win:
                    stale_counts[url] = stale_counts.get(url, 0) + 1
        return divergent, stale_counts

    def stats(self) -> dict:
        """The ``fleet.*`` metric values — cached state only, a
        /metrics scrape never triggers worker network IO."""
        with self._lock:
            rows = {u: dict(e) for u, e in self._digests.items()}
            polls = self._polls
        divergent, _stale = self._divergence(rows)
        return {
            "polls": polls,
            "reachable": sum(
                1 for e in rows.values() if e.get("digest") is not None
            ),
            "divergent": len(divergent),
        }

    def snapshot(self) -> dict:
        """The ``/fleet/status`` document (refreshes inline when the
        cached digests are older than ``interval_s``). Its schema is
        the JAX package's: ``migrations`` lists the engine's live and
        recent migrations, and the diagnosis names a stuck one."""
        with self._lock:
            last = self._last_poll
        if last is None or self._clock() - last >= self.interval_s:
            if self._poll_lock.acquire(blocking=False):
                try:
                    self.poll()
                except Exception:  # a broken poll must not 500 status
                    log.exception("fleet digest poll failed")
                finally:
                    self._poll_lock.release()
        with self._lock:
            rows = {u: dict(e) for u, e in self._digests.items()}
            polls = self._polls
            last = self._last_poll
        now = self._clock()
        divergent, stale_counts = self._divergence(rows)
        workers: dict[str, dict] = {}
        tail_rows: dict[str, int] = {}
        for url in sorted(rows):
            e = rows[url]
            d = e.get("digest")
            w: dict = {
                "reachable": d is not None,
                "ageS": round(now - e["tMono"], 1),
                "medianRttMs": self.engine.router.median_rtt_ms(url),
                "staleDatasets": stale_counts.get(url, 0),
            }
            if d is not None:
                w["digest"] = d
                w["deltaTailRows"] = sum(
                    int(t.get("rows", 0))
                    for t in (d.get("deltaTails") or {}).values()
                )
                tail_rows[url] = w["deltaTailRows"]
            else:
                w["error"] = e.get("error")
            workers[url] = w
        # stalest replica: fingerprint-divergence losers first, else the
        # deepest standing delta tail
        stalest = None
        if stale_counts:
            stalest = max(
                sorted(stale_counts), key=lambda u: stale_counts[u]
            )
        elif any(tail_rows.values()):
            stalest = max(sorted(tail_rows), key=lambda u: tail_rows[u])
        rtts = {
            u: w["medianRttMs"]
            for u, w in workers.items()
            if w.get("medianRttMs") is not None
        }
        # the replica whose kernels built mid-request most often
        compiles = {
            u: int((w.get("digest") or {}).get("midRequestCompiles", 0))
            for u, w in workers.items()
        }
        worst_compiling = None
        if any(compiles.values()):
            worst_compiling = max(
                sorted(compiles), key=lambda u: compiles[u]
            )
        # live migrations: phase and ages per migration, and the one
        # whose phase outlived the controller's stuck bound
        migrations: list[dict] = []
        stuck = None
        ctl = getattr(self.engine, "migrations", None)
        if ctl is not None:
            migrations = ctl.status()
            stuck = ctl.stuck()
        return {
            "intervalS": self.interval_s,
            "polls": polls,
            "lastPollAgeS": (
                None if last is None else round(now - last, 1)
            ),
            "workers": workers,
            "migrations": migrations,
            "diagnosis": {
                "stalestReplica": stalest,
                "hottestWorker": (
                    max(sorted(rtts), key=lambda u: rtts[u])
                    if rtts
                    else None
                ),
                "divergentDatasets": divergent,
                "unreachableWorkers": sorted(
                    u for u, w in workers.items() if not w["reachable"]
                ),
                "stuckMigration": stuck,
                "worstCompilingReplica": worst_compiling,
            },
        }


class DistributedEngine:
    """Coordinator: the ``VariantEngine`` interface over remote workers
    (and an optional local engine for locally resident shards).

    Dataset routing is discovered from each worker's ``/datasets`` and
    refreshed on demand. A dataset served by several workers keeps its
    FULL replica list (fingerprint-checked): a :class:`ReplicaRouter`
    picks among live replicas by power-of-two-choices over recent RTTs,
    ``search`` fails over to the next replica when a worker errors or
    its circuit is open, and slow primaries are hedged by a second
    replica after the hedge delay. When no replica of a dataset is
    reachable the search degrades to partial results
    (``resilience.partial_results``), and a background rediscovery loop
    heals routes. A failure on the coordinator's own side (its local
    engine, its mesh tier) raises on the request.
    """

    #: background rediscovery cadence once a route failure armed the
    #: healing loop (it exits when every configured worker answers)
    REDISCOVERY_INTERVAL_S = 2.0

    def __init__(
        self,
        worker_urls: list[str],
        *,
        local=None,
        config=None,
        timeout_s: float = 600.0,
        retries: int = 2,
        max_threads: int = 64,
        post=None,
        get=None,
        token: str = "",
        breaker: CircuitBreaker | None = None,
        transport: PooledTransport | None = None,
    ):
        from ..config import BeaconConfig

        # full VariantEngine interface: the API layer reads engine.config
        self.config = config or (
            local.config if local is not None else BeaconConfig()
        )
        self.worker_urls = list(worker_urls)
        self.local = local
        self.timeout_s = timeout_s
        self.retries = retries
        self.max_threads = max_threads
        tcfg = self.config.transport
        self.transport_config = tcfg
        # default data plane: the pooled keep-alive transport (one
        # instance per engine — connections die with close()); injected
        # post/get callables take precedence
        self._owns_transport = False
        if (post is None or get is None) and transport is None:
            transport = PooledTransport.from_config(tcfg)
            self._owns_transport = True
        self.transport = transport
        self._post = post if post is not None else transport.post_json
        self._get = get if get is not None else transport.get_json
        # a bytes-capable transport receives the payload's serialized
        # JSON verbatim (no dict round-trip on the hot path)
        self._post_bytes_ok = bool(
            getattr(self._post, "accepts_bytes", False)
        )
        self._short_circuits = 0
        self._sc_lock = threading.Lock()
        # does the (possibly injected) transport accept a 4th headers
        # arg? Decided once here, not per call
        import inspect

        try:
            params = inspect.signature(self._post).parameters
            self._post_takes_headers = len(params) >= 4 or any(
                p.kind == inspect.Parameter.VAR_POSITIONAL
                or p.kind == inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):  # builtins/C callables
            self._post_takes_headers = True
        self._token = token or self.config.auth.worker_token
        # per-worker circuit breaker: consecutive /search failures open
        # the route, calls fast-fail instead of eating the full timeout
        # each, and a half-open probe readmits the worker
        res = self.config.resilience
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=res.breaker_failure_threshold,
            reset_timeout_s=res.breaker_reset_s,
            half_open_probes=res.breaker_half_open_probes,
        )
        self._routes_lock = threading.Lock()
        self._discovered = False  # a discovery pass has published
        self._fingerprints: dict[str, str] = {}
        # per-worker last-known /datasets contribution + who answered
        # the most recent pass (the rediscovery loop's healed signal)
        self._last_seen: dict[str, list[tuple[str, str]]] = {}
        self._reachable: set[str] = set()
        self._retention_warned: set[str] = set()
        # monotonic stamp of the last completed discovery pass
        self._last_publish_mono: float | None = None
        # every /search routing decision goes through router.pick —
        # never by indexing a routes dict
        self.router = ReplicaRouter(self.breaker)
        self._failovers = 0
        self._partials = 0
        self._rediscoveries = 0
        self._closed = threading.Event()
        self._rediscover_thread: threading.Thread | None = None
        self._hedge_exec: ThreadPoolExecutor | None = None
        # persistent scatter pool (no per-search thread churn)
        self._pool = ThreadPoolExecutor(
            max_workers=max_threads, thread_name_prefix="dispatch"
        )
        # the pod tier, consulted per query for the local datasets;
        # cheap to construct (its stack builds on first use or warmup).
        # Built over an engine that can stack its shards
        self.mesh_tier: MeshDispatchTier | None = None
        if (local is not None and self.config.engine.mesh_dispatch
                and hasattr(local, "index_snapshot")):
            self.mesh_tier = MeshDispatchTier(
                local, min_shards=self.config.engine.mesh_min_shards
            )
        # the /fleet/status digest view: polled only when read
        self.fleet = FleetView(
            self,
            interval_s=self.config.observability.fleet_digest_interval_s,
        )
        # per-worker in-flight /search legs (guarded by _sc_lock): a
        # migration's cut-over drains a retired source to zero before
        # the source drops the dataset
        self._inflight: dict[str, int] = {}
        # live shard migration (copy -> dual-serve -> canary-verify ->
        # cut-over), served at /fleet/migrate; migration.py never
        # imports this module
        from .migration import MigrationController

        self.migrations = MigrationController(self)

    # headers are passed only when there is something to carry (a
    # configured token, an ambient trace id) AND the transport's
    # signature accepts them; a token with a 3-arg transport still
    # passes headers (a loud TypeError beats unauthenticated calls)
    def _post_auth(self, url: str, doc, timeout_s: float):
        headers: dict = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        ctx = current_context()
        if ctx is not None and self._post_takes_headers:
            # every coordinator->worker hop carries the request's trace
            # id so worker-side spans share it
            headers[TRACE_HEADER] = ctx.trace_id
        if headers:
            return self._post(url, doc, timeout_s, headers)
        return self._post(url, doc, timeout_s)

    def _get_auth(self, url: str, timeout_s: float):
        if self._token:
            return self._get(
                url, timeout_s, {"Authorization": f"Bearer {self._token}"}
            )
        return self._get(url, timeout_s)

    def warmup(self) -> int:
        """Build and launch the local engine's kernels and the tier's
        (remote workers warm their own at their server start); returns
        the launch count."""
        warm = getattr(self.local, "warmup", None)
        n = warm() if warm else 0
        if self.mesh_tier is not None:
            n += self.mesh_tier.warmup()
        return n

    def register_metrics(self, registry) -> None:
        """Coordinator telemetry: per-worker breaker series, the data
        plane's transport series and the fan-out counters, plus the
        local engine's instruments when one is wired."""
        register_breaker_metrics(registry, lambda: self.breaker)
        register_transport_metrics(registry)
        register_dispatch_metrics(registry, self.dispatch_stats)
        reg = getattr(self.local, "register_metrics", None)
        if reg is not None:
            reg(registry)

    @property
    def short_circuits(self) -> int:
        """Boolean fan-outs answered before the full worker drain."""
        with self._sc_lock:
            return self._short_circuits

    def dispatch_stats(self) -> dict:
        """The fan-out counters behind the ``dispatch.*`` /
        ``routing.*`` / ``mesh.*`` / ``fleet.*`` / ``migration.*``
        series."""
        mesh = (
            self.mesh_tier.stats() if self.mesh_tier is not None else {}
        )
        fleet = self.fleet.stats()
        mig = self.migrations.counters()
        with self._sc_lock:
            return {
                "short_circuits": self._short_circuits,
                "failovers": self._failovers,
                "partial_responses": self._partials,
                "rediscoveries": self._rediscoveries,
                "replicas": self.router.replica_count(),
                "mesh_dispatches": mesh.get("dispatches", 0),
                "mesh_gather_rows": mesh.get("gather_rows", 0),
                "mesh_refusals": mesh.get("refusals", {}),
                "fleet_polls": fleet.get("polls", 0),
                "fleet_reachable": fleet.get("reachable", 0),
                "fleet_divergent": fleet.get("divergent", 0),
                "migration_started": mig.get("started", 0),
                "migration_completed": mig.get("completed", 0),
                "migration_rolled_back": mig.get("rolled_back", 0),
                "migration_bytes_copied": mig.get("bytes_copied", 0),
            }

    def route_table_age_s(self) -> float | None:
        """Seconds since the last completed discovery pass published the
        replica table (None before the first)."""
        with self._routes_lock:
            t = self._last_publish_mono
        return None if t is None else time.monotonic() - t

    def worker_stats(self) -> dict[str, dict]:
        """Per-worker health rollup for ``/debug/status``: breaker
        state, recent median RTT, and whether the latest discovery pass
        reached it. Local state only — never a worker call."""
        with self._routes_lock:
            reachable = set(self._reachable)
        return {
            url: {
                "state": self.breaker.state(url),
                "medianRttMs": self.router.median_rtt_ms(url),
                "reachable": url in reachable,
            }
            for url in self.worker_urls
        }

    def unavailable_datasets(self) -> list[str]:
        """Datasets in the route table with no live replica (every
        copy's circuit open) — served as partial results until the
        rediscovery loop heals a route. Local state only, so ``/ready``
        reports it without a worker round-trip."""
        return sorted(
            ds
            for ds, urls in self.router.table().items()
            if urls and not any(self.router.live(u) for u in urls)
        )

    def close(self) -> None:
        """Stop the migration controller and the rediscovery loop,
        release the scatter/hedge pools, close the tier and drop the
        pooled worker connections. The local engine is the caller's and
        stays open."""
        self._closed.set()
        self.migrations.close()
        if self.mesh_tier is not None:
            self.mesh_tier.close()
        self._pool.shutdown(wait=False, cancel_futures=True)
        # under _sc_lock, paired with _hedge_pool's closed check: a
        # hedge executor created concurrently with close() must not
        # escape shutdown
        with self._sc_lock:
            hedge, self._hedge_exec = self._hedge_exec, None
        if hedge is not None:
            hedge.shutdown(wait=False, cancel_futures=True)
        if self._owns_transport and self.transport is not None:
            self.transport.close()

    def __enter__(self) -> "DistributedEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- discovery ----------------------------------------------------------

    @staticmethod
    def _group_replicas(ds: str, entries: list[tuple[str, str]]) -> tuple:
        """The replica urls for one dataset, grouped by per-dataset
        fingerprint: identical shard copies are interchangeable, and so
        are **tail-superset** copies (same base artifacts, delta tails
        forming a subset chain — a replica mid-rolling-ingest is a
        FRESHER copy, not a divergence loser). On a real mismatch the
        newest copy wins (row-count freshness) and the stale workers are
        excluded from this dataset's routes: failover to a divergent
        copy would silently change the answer mid-request."""
        by_fp: dict[str, list[str]] = {}
        for url, fp in entries:
            by_fp.setdefault(fp, []).append(url)
        if len(by_fp) == 1:
            return tuple(next(iter(by_fp.values())))
        parts = {fp: _fingerprint_parts(fp) for fp in by_fp}
        if all(p is not None for p in parts.values()):
            bases = {p[0] for p in parts.values()}
            tails = sorted((p[1] for p in parts.values()), key=len)
            chain = all(a <= b for a, b in zip(tails, tails[1:]))
            if len(bases) == 1 and chain:
                # every copy is routable; deepest tail first so the
                # primary view (routes()[ds] = urls[0]) is the freshest
                ordered = sorted(
                    by_fp,
                    key=lambda fp: (_fingerprint_freshness(fp), fp),
                    reverse=True,
                )
                publish_event(
                    "routing.tail_superset",
                    dataset=ds,
                    copies=len(by_fp),
                    replicas=sum(len(u) for u in by_fp.values()),
                )
                return tuple(
                    u for fp in ordered for u in sorted(by_fp[fp])
                )
        win = max(by_fp, key=lambda fp: (_fingerprint_freshness(fp), fp))
        losers = sorted(
            u for fp, urls in by_fp.items() if fp != win for u in urls
        )
        log.warning(
            "dataset %s: divergent index copies across workers — routing "
            "to the newest copy on %s, excluding stale %s (re-ingest or "
            "POST /reload the excluded workers)",
            ds,
            sorted(by_fp[win]),
            losers,
        )
        return tuple(by_fp[win])

    def _discover(self) -> dict[str, tuple[str, ...]]:
        found: dict[str, list[tuple[str, str]]] = {}  # url -> [(ds, fp)]
        fps: dict[str, str] = {}
        with self._routes_lock:
            urls = list(self.worker_urls)
        for url in urls:
            try:
                status, doc = self._get_auth(f"{url}/datasets", self.timeout_s)
            except urllib.error.HTTPError as e:
                if e.code in (401, 403):
                    # an auth failure must not masquerade as a network
                    # problem
                    log.error(
                        "worker %s rejected coordinator credentials "
                        "(http %s): check BEACON_WORKER_TOKEN / --token",
                        url,
                        e.code,
                    )
                else:
                    log.warning("worker %s unreachable: %s", url, e)
                continue
            except Exception as e:
                log.warning("worker %s unreachable: %s", url, e)
                continue
            if status in (401, 403):
                log.error(
                    "worker %s rejected coordinator credentials (http %s): "
                    "check BEACON_WORKER_TOKEN / --token",
                    url,
                    status,
                )
                continue
            if status != 200:
                continue
            fps[url] = doc.get("fingerprint", "")
            # answering discovery REVIVES an open/half-open route, but
            # must NOT touch a CLOSED circuit's failure count: /datasets
            # answering says nothing about /search health
            if self.breaker.state(url) != CLOSED:
                self.breaker.record_success(url)
            ds_fps = doc.get("dataset_fingerprints") or {}
            found[url] = [
                (ds, str(ds_fps.get(ds, fps[url])))
                for ds in doc.get("datasets", [])
            ]
        with self._routes_lock:
            # per-worker retention: a worker that ANSWERED owns its
            # route contribution outright; a worker that did NOT answer
            # keeps its last-known-good contribution, so its datasets
            # keep degrading to MARKED partial results
            merged: dict[str, list[tuple[str, str]]] = {}
            for url in self.worker_urls:
                per = found.get(url)
                if per is None:
                    per = self._last_seen.get(url, [])
                    # warn ONCE per outage, not once per pass
                    if per and url not in self._retention_warned:
                        self._retention_warned.add(url)
                        log.warning(
                            "worker %s unreachable during discovery; "
                            "keeping its last-known-good routes "
                            "(%d dataset(s), may be stale) until it "
                            "answers",
                            url,
                            len(per),
                        )
                else:
                    self._retention_warned.discard(url)
                for ds, fp in per:
                    merged.setdefault(ds, []).append((url, fp))
            table = {
                ds: self._group_replicas(ds, entries)
                for ds, entries in merged.items()
            }
            self._discovered = True
            self._last_seen.update(found)
            self._reachable = set(found)
            # last-known fingerprints are kept for unreachable workers
            # too: the aggregate index identity (cache keys) must not
            # flap with reachability
            self._fingerprints.update(fps)
            self._last_publish_mono = time.monotonic()
            self.router.publish(table)
        # the router's view: publish() filters retired pairs
        return self.router.table()

    def replica_table(
        self, refresh: bool = False
    ) -> dict[str, tuple[str, ...]]:
        """dataset -> replica urls, discovering on first use."""
        with self._routes_lock:
            discovered = self._discovered
        if not discovered or refresh:
            return self._discover()
        return self.router.table()

    def routes(self, refresh: bool = False) -> dict[str, str]:
        """dataset -> primary worker url (a view of the replica table;
        routing decisions go through the router)."""
        return {
            ds: urls[0]
            for ds, urls in self.replica_table(refresh).items()
            if urls
        }

    # -- fleet membership ---------------------------------------------------

    def add_worker(self, url: str) -> bool:
        """Admit ``url`` to the fleet and run a discovery pass so its
        datasets enter the routing table. False when already a member."""
        with self._routes_lock:
            if url in self.worker_urls:
                return False
            self.worker_urls.append(url)
        self._discover()
        return True

    def remove_worker(self, url: str) -> bool:
        """Drop ``url`` from the fleet and republish routes without its
        contribution (its last-known-good retention included)."""
        with self._routes_lock:
            if url not in self.worker_urls:
                return False
            self.worker_urls.remove(url)
            self._last_seen.pop(url, None)
            self._fingerprints.pop(url, None)
            self._reachable.discard(url)
            self._retention_warned.discard(url)
        self._discover()
        return True

    def inflight(self, url: str) -> int:
        """In-flight /search legs against ``url`` right now."""
        with self._sc_lock:
            return self._inflight.get(url, 0)

    # -- background rediscovery --------------------------------------------

    def _nudge_rediscovery(self) -> None:
        """Arm the healing loop (a worker failure or an open breaker saw
        a dead route): one daemon thread re-runs discovery until every
        configured worker answers again. Idempotent while a loop runs."""
        if self._closed.is_set():
            return
        with self._routes_lock:
            t = self._rediscover_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(
                target=self._rediscover_loop,
                daemon=True,
                name="dispatch-rediscovery",
            )
            self._rediscover_thread = t
        t.start()

    def _rediscover_loop(self) -> None:
        delay = self.REDISCOVERY_INTERVAL_S
        while not self._closed.wait(delay):
            # a permanently gone worker must not spin full-rate
            # discovery forever: back off toward a slow steady probe
            delay = min(delay * 2, max(30.0, self.REDISCOVERY_INTERVAL_S))
            try:
                self._discover()
            except Exception:
                log.exception("route rediscovery pass failed")
            with self._sc_lock:
                self._rediscoveries += 1
            with self._routes_lock:
                # healed = every configured worker ANSWERED the latest
                # pass (not merely has a retained fingerprint)
                reachable = len(self._reachable)
                healed = all(
                    url in self._reachable for url in self.worker_urls
                )
            publish_event(
                "routing.rediscovery",
                healed=healed,
                reachable=reachable,
                workers=len(self.worker_urls),
            )
            if healed:
                return

    def datasets(self) -> list[str]:
        out = set(self.routes())
        if self.local is not None:
            out |= set(self.local.datasets())
        return sorted(out)

    def index_fingerprint(self) -> str:
        self.routes()
        with self._routes_lock:
            parts = [
                f"{url}={fp}"
                for url, fp in sorted(self._fingerprints.items())
            ]
        if self.local is not None:
            parts.append(f"local={self.local.index_fingerprint()}")
        return "&&".join(parts)

    # -- query path ---------------------------------------------------------

    def _call_worker(self, url: str, payload: VariantQueryPayload,
                     deadline=None, ctx=None):
        # the request context rides in explicitly like the deadline
        # (pool thread: the submitting request's thread-locals are not
        # visible) and is re-installed so the trace header and outcome
        # notes work from here down
        with request_context(ctx if ctx is not None else current_context()):
            return self._call_worker_traced(url, payload, deadline)

    def call_replica(
        self, url: str, payload: VariantQueryPayload
    ) -> list[VariantSearchResponse]:
        """One direct ``/search`` against a SPECIFIC replica — no
        failover, no hedging, no routing: the canary prober's
        per-replica probe. Probe RTTs do NOT feed the router's rings
        (sub-millisecond probes would drag the adaptive hedge delay to
        probe scale on an idle fleet)."""
        return self._call_worker_traced(url, payload, note_rtt=False)

    def _call_worker_traced(self, url: str, payload: VariantQueryPayload,
                            deadline=None, *, note_rtt: bool = True):
        # in-flight leg accounting brackets the WHOLE leg (retries
        # included)
        with self._sc_lock:
            self._inflight[url] = self._inflight.get(url, 0) + 1
        try:
            return self._call_worker_leg(
                url, payload, deadline, note_rtt=note_rtt
            )
        finally:
            with self._sc_lock:
                n = self._inflight.get(url, 0) - 1
                if n <= 0:
                    self._inflight.pop(url, None)
                else:
                    self._inflight[url] = n

    def _call_worker_leg(self, url: str, payload: VariantQueryPayload,
                         deadline=None, *, note_rtt: bool = True):
        if not self.breaker.allow(url):
            # fast-fail: the route failed repeatedly and its reset
            # window hasn't lapsed. An open route also arms the
            # rediscovery loop (the worker may have restarted)
            annotate(breaker="open")
            plan_stage(
                "worker",
                decision="fast_fail",
                reason="breaker_open",
                worker=url,
            )
            self._nudge_rediscovery()
            raise CircuitOpen(f"worker {url}: circuit open")
        # serialize ONCE: the pooled transport ships these bytes
        # verbatim; injected dict-contract transports still get a dict
        doc = (
            payload.dumps().encode()
            if self._post_bytes_ok
            else json.loads(payload.dumps())
        )
        # the request deadline is passed EXPLICITLY by search(): this
        # runs on a pool thread
        if deadline is None:
            deadline = current_deadline()
        last = None
        # one span per worker leg: on success the worker's span summary
        # grafts in as child spans
        with span("dispatch.worker_call", url=url) as wsp:
            for attempt in range(self.retries + 1):
                timeout_s = deadline.clamp(self.timeout_s)
                if timeout_s is not None and timeout_s <= 0:
                    deadline.check(f"worker {url} call")
                t0 = time.perf_counter()
                try:
                    fault_point("worker.http", url)
                    status, out = self._post_auth(
                        f"{url}/search", doc, timeout_s
                    )
                except Exception as e:
                    last = WorkerError(f"{url}: {e}")
                else:
                    if status == 200:
                        # successful RTTs feed the router's p2c
                        # comparison, the adaptive hedge delay and the
                        # request's cost vector
                        rtt_s = time.perf_counter() - t0
                        if note_rtt:
                            self.router.note_rtt(url, rtt_s)
                        charge_cost(worker_rtt_ms=rtt_s * 1e3)
                        self.breaker.record_success(url)
                        _graft_worker_spans(
                            wsp, url, out.get("meta"), rtt_s
                        )
                        return [
                            VariantSearchResponse(**r)
                            for r in out.get("responses", [])
                        ]
                    last = WorkerError(
                        f"{url}: http {status}: {out.get('error')}"
                    )
                if attempt < self.retries:  # no dead sleep after final try
                    time.sleep(min(0.05 * (attempt + 1), 1.0))
        if deadline.expired():
            # the REQUEST ran out of time, not the worker out of
            # health: a deadline-clamped timeout must not count against
            # the route
            raise DeadlineExceeded(
                f"worker {url}: request deadline expired"
            ) from last
        self.breaker.record_failure(url)
        self._nudge_rediscovery()
        raise last

    # -- replica hedging + failover ----------------------------------------

    def _hedge_pool(self) -> ThreadPoolExecutor:
        with self._sc_lock:
            if self._hedge_exec is None:
                if self._closed.is_set():
                    # a leg draining through close() must not create an
                    # executor nothing will ever shut down
                    raise WorkerError("engine closed")
                # every multi-replica leg's PRIMARY rides this pool when
                # hedging is armed, so it must never cap fan-out below
                # the scatter pool
                self._hedge_exec = ThreadPoolExecutor(
                    max_workers=max(8, 2 * self.max_threads),
                    thread_name_prefix="dispatch-hedge",
                )
            return self._hedge_exec

    def _hedge_candidate(
        self, ds_list: list[str], avoid: set[str]
    ) -> str | None:
        """A live replica (other than ``avoid``) serving EVERY dataset
        in the group, fastest first, or None (single-replica fleets
        never hedge)."""
        common: set[str] | None = None
        for ds in ds_list:
            urls = set(self.router.replicas(ds))
            common = urls if common is None else common & urls
        cands = sorted((common or set()) - avoid)
        live = [u for u in cands if self.router.live(u)]
        if not live:
            return None
        return min(live, key=lambda u: self.router._rtt(u) or 0.0)

    def _call_replicas(
        self, url: str, payload: VariantQueryPayload, deadline, tried: set
    ) -> list[VariantSearchResponse]:
        """One replica-hedged /search leg: the primary runs on the hedge
        pool; if it has not answered within the hedge delay, the same
        sub-query races on a second replica and the first success wins.
        /search is an idempotent read, so the loser's duplicate only
        costs its CPU. The hedge delay counts from the primary's start
        (``_hedge_due``). A hedge target that also failed is added to
        ``tried`` so failover does not re-try it."""
        delay = None
        if self.transport_config.replica_hedge:
            delay = self.router.hedge_delay(
                self.transport_config.hedge_delay_s
            )
        other = (
            self._hedge_candidate(payload.dataset_ids or [], {url} | tried)
            if delay is not None
            else None
        )
        if delay is None or other is None:
            return self._call_worker_traced(url, payload, deadline)
        pool = self._hedge_pool()
        ctx = current_context()
        started = threading.Event()

        def primary():
            started.set()
            return self._call_worker(url, payload, deadline, ctx)

        fut = pool.submit(primary)
        futs = {fut: url}
        if _hedge_due(fut, started, delay):
            note_hedge()  # process-wide transport.hedges counter
            annotate(replica_hedge=True)
            plan_stage(
                "worker", decision="hedged", primary=url, hedge=other
            )
            publish_event("dispatch.hedge", primary=url, hedge=other)
            futs[
                pool.submit(self._call_worker, other, payload, deadline, ctx)
            ] = other
        pending = set(futs)
        last: Exception | None = None
        while pending:
            done, pending = futures_mod.wait(
                pending, return_when=futures_mod.FIRST_COMPLETED
            )
            for f in done:
                u = futs[f]
                try:
                    out = f.result()
                except Exception as e:
                    last = e
                    if u != url:
                        tried.add(u)
                    continue
                if u != url:  # the hedge answered first
                    publish_event(
                        "dispatch.hedge_won", winner=u, primary=url
                    )
                return out
        raise last

    def _search_group(
        self, url, ds_list, payload: VariantQueryPayload, deadline, ctx
    ):
        # like _call_worker: the request context rides in explicitly
        with request_context(ctx if ctx is not None else current_context()):
            return self._search_group_traced(url, ds_list, payload, deadline)

    def _search_group_traced(
        self, url: str, ds_list: list[str], payload, deadline
    ) -> tuple[list[VariantSearchResponse], list[str], Exception | None]:
        """One scatter leg with automatic failover: the group's primary
        is tried first (hedged); on a worker error or open circuit each
        dataset re-routes to its next untried replica — never the same
        copy twice — until ``resilience.failover_retries`` extra
        replicas have been spent or the replica set is exhausted.
        Returns ``(responses, failed_datasets, first_error)``; only a
        deadline expiry raises (no time left to fail over)."""
        max_extra = self.config.resilience.failover_retries
        responses: list[VariantSearchResponse] = []
        failed: list[str] = []
        first_err: Exception | None = None
        work = [(url, list(ds_list), {url})]
        while work:
            u, dss, tried = work.pop()
            sub = dataclasses.replace(payload, dataset_ids=dss)
            try:
                responses.extend(
                    self._call_replicas(u, sub, deadline, tried)
                )
                continue
            except DeadlineExceeded:
                raise  # the request is out of time — no failover
            except (WorkerError, CircuitOpen) as e:
                if first_err is None:
                    first_err = e
            if len(tried) > max_extra:
                # primary + max_extra replicas all failed: give these
                # datasets up to the partial-results path
                failed.extend(dss)
                continue
            regroup: dict[str, list[str]] = {}
            for ds in dss:
                nxt = self.router.pick(ds, avoid=tried)
                if nxt is None:
                    failed.append(ds)
                else:
                    regroup.setdefault(nxt, []).append(ds)
            for nu, nds in sorted(regroup.items()):
                with self._sc_lock:
                    self._failovers += 1
                annotate(failover=True)
                plan_stage(
                    "worker",
                    decision="failover",
                    failed=u,
                    to=nu,
                    datasets=len(nds),
                )
                publish_event(
                    "dispatch.failover",
                    failed=u,
                    to=nu,
                    datasets=len(nds),
                )
                work.append((nu, nds, tried | {nu}))
        return responses, failed, first_err

    @staticmethod
    def _drain(futures, deadline) -> None:
        """Wait for every worker future to settle (deadline-bounded),
        discarding its outcome: a coordinator-side failure is about to
        raise, and no pool task may be left stranded behind it."""
        pending = set(futures)
        while pending:
            done, pending = futures_mod.wait(
                pending,
                timeout=deadline.remaining(),
                return_when=futures_mod.ALL_COMPLETED,
            )
            if not done:  # deadline expired: leave them on the pool
                return

    def search(
        self, payload: VariantQueryPayload
    ) -> list[VariantSearchResponse]:
        with span("dispatch.search") as sp:
            current_deadline().check("dispatch.search")
            table = self.replica_table()
            wanted = payload.dataset_ids or self.datasets()
            local_ds = (
                set(self.local.datasets()) if self.local is not None else set()
            )
            if any(ds not in local_ds and ds not in table for ds in wanted):
                # an explicitly requested dataset may have been ingested
                # after the last discovery: refresh once before treating
                # it as unknown
                table = self.replica_table(refresh=True)
            # the pod tier's consult for the local datasets; it raises
            # on a failed build (a coordinator-side failure)
            tier = self.mesh_tier
            mesh_ds: set = set()
            if tier is not None:
                mesh_ds = tier.resolve(
                    [ds for ds in wanted if ds in local_ds], payload
                )
            by_worker: dict[str, list[str]] = {}
            local_wanted: list[str] = []
            for ds in wanted:
                if ds in mesh_ds:
                    continue
                if ds in local_ds:
                    local_wanted.append(ds)
                elif ds in table:
                    # p2c primary pick; failover inside the group leg
                    # walks the remaining replicas
                    primary = self.router.pick(ds)
                    if primary is not None:
                        by_worker.setdefault(primary, []).append(ds)
                # still-unknown datasets are skipped, like unmatched
                # chromosomes

            tasks = sorted(by_worker.items())
            # a boolean-granularity fan-out with no resultset detail
            # requested is a logical OR: the first hit anywhere decides
            # the answer, so the rest of the scatter is abandoned
            short_circuit_ok = (
                payload.requested_granularity == "boolean"
                and payload.include_datasets == "NONE"
                and self.transport_config.bool_short_circuit
            )
            short_circuited = False
            responses: list[VariantSearchResponse] = []
            unavailable: list[str] = []
            group_err: Exception | None = None
            deadline = current_deadline()
            ctx = current_context()
            futures = {
                self._pool.submit(
                    self._search_group, url, ds_list, payload,
                    deadline, ctx,
                ): url
                for url, ds_list in tasks
            }
            # which tier is serving this query (the slow-query log's
            # dispatch attribution)
            if mesh_ds:
                tier_label = (
                    "mesh" if not (tasks or local_wanted) else "mixed"
                )
                annotate(dispatch_tier=tier_label)
                plan_stage(
                    "tier",
                    decision=tier_label,
                    mesh_datasets=len(mesh_ds),
                    worker_groups=len(tasks),
                )
            elif tasks:
                annotate(dispatch_tier="http")
                plan_stage(
                    "tier", decision="http", worker_groups=len(tasks)
                )
            elif local_wanted:
                annotate(dispatch_tier="local")
                plan_stage("tier", decision="local")
            # the coordinator's own legs run on this thread while the
            # workers answer: the tier's one launch, then the local
            # engine. Either one's failure raises once every worker
            # future has settled
            try:
                if mesh_ds:
                    responses.extend(tier.search(payload, mesh_ds))
                if local_wanted:
                    responses.extend(
                        self.local.search(
                            dataclasses.replace(
                                payload, dataset_ids=local_wanted
                            )
                        )
                    )
            except BaseException:
                self._drain(futures, deadline)
                raise
            first_err: BaseException | None = None
            pending = set(futures)
            # hit_seen is order-independent: once ANY leg of a boolean
            # OR reports a hit, the aggregate answer is decided — a
            # worker's error cannot change it
            hit_seen = short_circuit_ok and any(
                r.exists for r in responses
            )
            if not hit_seen:
                # fan-in consumes futures AS COMPLETED (a hit can
                # short-circuit) but settles every one before raising.
                # The drain is deadline-bounded: on expiry the caller
                # gets DeadlineExceeded now
                while pending:
                    done, pending = futures_mod.wait(
                        pending,
                        timeout=deadline.remaining(),
                        return_when=futures_mod.FIRST_COMPLETED,
                    )
                    if not done:  # deadline expired mid-drain
                        if first_err is None:
                            first_err = DeadlineExceeded(
                                "worker fan-in: deadline exceeded"
                            )
                        break
                    for f in done:
                        try:
                            out, failed, gerr = f.result()
                        except (
                            Exception,
                            futures_mod.CancelledError,
                        ) as e:
                            # CancelledError (close() mid-search) is a
                            # BaseException: it must not abort the drain
                            if first_err is None:
                                first_err = e
                        else:
                            responses.extend(out)
                            if failed:
                                # this group exhausted its replicas for
                                # these datasets: partial results, not
                                # an immediate failure
                                unavailable.extend(failed)
                                if group_err is None:
                                    group_err = gerr
                            if short_circuit_ok and any(
                                r.exists for r in out
                            ):
                                hit_seen = True
                    if hit_seen:
                        break
            if hit_seen:
                if pending:
                    # abandon the rest of the scatter: queued futures
                    # are cancelled, in-flight ones finish on the pool
                    # and are ignored. The counter only ticks when a
                    # drain was actually cut short
                    for f in pending:
                        f.cancel()
                    short_circuited = True
                    with self._sc_lock:
                        self._short_circuits += 1
                    annotate(short_circuit=True)
            elif first_err is not None:
                # a deadline expiry or a cancelled drain is a real
                # failure — partial results only cover unreachable
                # replicas
                raise first_err
            elif unavailable:
                unavailable = sorted(set(unavailable))
                self._nudge_rediscovery()
                if not self.config.resilience.partial_results:
                    raise group_err or WorkerError(
                        "no reachable replica for dataset(s): "
                        + ", ".join(unavailable)
                    )
                # graceful degradation: answer with the datasets that
                # responded and name the unreachable ones — the API
                # layer stamps meta.unavailableDatasets and a warning
                with self._sc_lock:
                    self._partials += 1
                annotate(unavailable_datasets=tuple(unavailable))
                plan_stage(
                    "fallback",
                    decision="partial",
                    reason="no_replica",
                    datasets=len(unavailable),
                )
                publish_event(
                    "dispatch.partial", datasets=list(unavailable)
                )
                log.warning(
                    "partial results: no reachable replica for %s (%s)",
                    unavailable,
                    group_err,
                )
            responses.sort(key=lambda r: (r.dataset_id, r.vcf_location))
            sp.note(
                workers=len(tasks),
                responses=len(responses),
                short_circuit=short_circuited,
                unavailable=len(unavailable),
            )
        return responses


# -- multi-process compute ---------------------------------------------------


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, backend: str = "nccl",
                   devices=None) -> None:
    """Join ``num_processes`` processes into one ``torch.distributed``
    process group (``tcp://coordinator_address``, this process being rank
    ``process_id``) for compute that spans them: afterwards
    ``parallel.mesh.make_mesh()`` returns the mesh over every process's
    entries, and the mesh entry points fan in across processes.

    ``devices`` are this process's mesh entries (an entry may repeat a
    device); by default every visible CUDA device, and without one this
    raises. A CPU world asks for it: ``devices=[torch.device("cpu")] *
    4, backend="gloo"``. ``backend`` is the collectives' (nccl by
    default); NCCL refuses two ranks on one card, so that layout needs
    ``backend="gloo"``, which the caller chooses. Each rank's entries are
    exchanged (``all_gather_object``) into ``parallel.mesh.world()``."""
    import torch.distributed as dist

    if _mesh.world() is not None:
        raise RuntimeError("this process already joined a process group")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU — "
                "pass devices=[torch.device('cpu')] and backend='gloo' to "
                "join a CPU world"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("init_multihost: 0 devices selected")
    if backend == "nccl" and devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    entries: list = [None] * num_processes
    dist.all_gather_object(entries, [str(d) for d in devices])
    _mesh.set_world(_mesh.World(
        rank=process_id, size=num_processes, backend=backend,
        entries=tuple(tuple(torch.device(d) for d in e) for e in entries),
    ))


def shutdown_multihost() -> None:
    """Leave the process group ``init_multihost`` joined (JAX's
    ``jax.distributed.shutdown``); ``make_mesh()`` is process-local
    again."""
    import torch.distributed as dist

    if _mesh.world() is None:
        return
    dist.destroy_process_group()
    _mesh.set_world(None)


def main(argv: list[str] | None = None) -> None:
    """``python -m sbeacon_tpu_torch.parallel.dispatch`` — one worker
    host: load the data root's index shards on ``--device`` (the card by
    default), build and warm every kernel, and serve the worker
    protocol."""
    import argparse

    from ..config import BeaconConfig
    from ..engine import VariantEngine
    from ..harness.faults import install_from_env
    from ..ingest import IngestService

    p = argparse.ArgumentParser(description="beacon query worker host "
                                            "(PyTorch/CUDA)")
    # loopback by default: workers serve all genomic data unauthenticated
    # unless --token/BEACON_WORKER_TOKEN is set, so exposure beyond the
    # host must be an explicit choice (--host 0.0.0.0 on a private net)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5100)
    p.add_argument(
        "--data-root",
        default=None,
        help="storage root (default: BEACON_DATA_ROOT or ./beacon_data)",
    )
    p.add_argument(
        "--token",
        default=None,
        help="shared bearer token required on every route but /health "
        "(default: BEACON_WORKER_TOKEN env)",
    )
    p.add_argument(
        "--open-scan",
        action="store_true",
        help="serve /scan without a worker token (it reads any "
        "client-supplied VCF location; private networks only)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device the engine serves on (default: cuda)",
    )
    args = p.parse_args(argv)

    config = BeaconConfig.from_env(args.data_root)
    # worker-side chaos: BEACON_FAULT_PLAN arms seeded fault injection
    install_from_env()
    token = args.token if args.token is not None else config.auth.worker_token
    engine = VariantEngine(config, device=args.device)
    service = IngestService(config, engine=engine)
    try:
        n = service.load_all()
        # build every kernel and launch each dispatchable shape once, so
        # no request pays a first build
        n_warm = engine.warmup()
        # bound before the serving line, so the line means "accepting"
        worker = WorkerServer(
            engine,
            host=args.host,
            port=args.port,
            token=token,
            open_scan=args.open_scan,
            reload_fn=service.load_all,
        )
        print(
            f"worker serving on {args.host}:{args.port} ({n} shards, "
            f"datasets: {', '.join(engine.datasets()) or 'none'}, "
            f"device {engine.device}, {n_warm} kernel programs warmed)",
            flush=True,
        )
        try:
            worker.server.serve_forever()
        finally:
            worker.server.server_close()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
        engine.close()


if __name__ == "__main__":  # pragma: no cover
    main()
