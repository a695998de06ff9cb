"""Threaded stdlib HTTP transport for BeaconApp, and the server entry.

Counterpart of ``sbeacon_tpu/api/server.py``: one ThreadingHTTPServer
(URL + query string + JSON body in, JSON out — or a Prometheus text
scrape verbatim, with the OpenMetrics content type for that dialect —
CORS header kept, the ``Retry-After`` header of a shed request), and
``python -m sbeacon_tpu_torch.api.server --data-root DIR``, which loads
every persisted shard of the data root, warms the kernels and serves the
Beacon routes, ``/submit`` included, on the GPU (``--device cpu`` for the
plain-PyTorch twins). With ``--worker URL`` (repeatable) the server is a
fleet coordinator: its local engine hosts the data root's shards and
takes ``/submit``, and every variant search fans out over the workers
(``python -m sbeacon_tpu_torch.parallel.dispatch``) through
``parallel.dispatch.DistributedEngine``.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .app import BeaconApp

#: content types of the two text expositions ``/metrics`` serves
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def _make_handler(app: BeaconApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet by default
            pass

        def _respond(self):
            parsed = urlparse(self.path)
            # flatten single-valued query params (API-GW style)
            query = {
                k: (v[0] if len(v) == 1 else ",".join(v))
                for k, v in parse_qs(parsed.query).items()
            }
            body = None
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                raw = self.rfile.read(length)
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid JSON body"})
                    return
            status, payload = app.handle(
                self.command, parsed.path, query, body,
                headers=dict(self.headers.items()),
            )
            self._send(status, payload)

        def _send(self, status: int, payload):
            if isinstance(payload, str):
                # text payloads (the exposition from /metrics) go out
                # verbatim; the OpenMetrics dialect ends in "# EOF"
                data = payload.encode()
                content_type = (
                    OPENMETRICS_CONTENT_TYPE
                    if payload.endswith("# EOF\n")
                    else PROMETHEUS_CONTENT_TYPE
                )
            else:
                data = json.dumps(payload).encode()
                content_type = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Access-Control-Allow-Origin", "*")
            retry_after = (
                payload.get("retryAfterSeconds")
                if isinstance(payload, dict) and status in (429, 503)
                else None
            )
            if retry_after is not None:
                # the SAME value as the envelope's retryAfterSeconds,
                # which the app already rounded up to whole seconds
                self.send_header(
                    "Retry-After", str(max(1, math.ceil(retry_after)))
                )
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_OPTIONS(self):  # CORS preflight
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header(
                "Access-Control-Allow-Methods", "GET, POST, PATCH, OPTIONS"
            )
            self.send_header(
                "Access-Control-Allow-Headers",
                # the client-settable request headers: auth, per-request
                # deadline, trace id
                "Content-Type, Authorization, X-Beacon-Deadline, "
                "X-Beacon-Trace",
            )
            self.send_header("Content-Length", "0")
            self.end_headers()

        do_GET = _respond
        do_POST = _respond
        do_PATCH = _respond

    return Handler


class _BeaconServer(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of client
    # connects overflows it, the kernel drops the SYN, and the client's
    # retransmit fires after a full second
    request_queue_size = 128


def make_server(app: BeaconApp, host: str = "127.0.0.1", port: int = 0):
    """ThreadingHTTPServer bound to (host, port); port 0 picks a free one."""
    return _BeaconServer((host, port), _make_handler(app))


def serve(app: BeaconApp, host: str = "0.0.0.0", port: int = 5000):
    """Blocking serve-forever (the deployment entry)."""
    _serve_forever(make_server(app, host, port), app)


def _serve_forever(server, app: BeaconApp) -> None:
    try:
        server.serve_forever()
    finally:
        server.server_close()
        # the runner's worker threads are non-daemon: leaving them alive
        # stalls interpreter exit on the atexit join
        app.close()


def start_background(app: BeaconApp, host: str = "127.0.0.1", port: int = 0):
    """(server, thread) with the server running on a daemon thread."""
    server = make_server(app, host, port)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def main(argv: list[str] | None = None) -> None:
    """``python -m sbeacon_tpu_torch.api.server``: one process serving
    the Beacon read routes over a data root, on ``--device`` (the GPU
    by default)."""
    import argparse

    from ..config import BeaconConfig
    from ..engine import VariantEngine
    from ..harness.faults import install_from_env

    p = argparse.ArgumentParser(description="Beacon v2 server (PyTorch/CUDA)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument(
        "--data-root",
        default=None,
        help="storage root (default: BEACON_DATA_ROOT or ./beacon_data)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device the engine serves on (default: cuda)",
    )
    p.add_argument(
        "--worker",
        action="append",
        default=[],
        metavar="URL",
        help="remote worker base URL (repeatable); variant searches fan "
        "out across the workers and the local shards",
    )
    args = p.parse_args(argv)

    config = BeaconConfig.from_env(args.data_root)
    # seeded fault injection against a real server: BEACON_FAULT_PLAN
    install_from_env()
    local = VariantEngine(config, device=args.device)
    engine = local
    if args.worker:
        from ..parallel.dispatch import DistributedEngine

        # the local engine hosts this machine's shards; BeaconApp wires
        # ingestion to it (engine.local) while searches fan out
        engine = DistributedEngine(args.worker, local=local, config=config)
    try:
        app = BeaconApp(config, engine=engine)
    except BaseException:
        if engine is not local:
            engine.close()
        local.close()
        raise
    try:
        n = app.ingest.load_all()
        # build every kernel and warm every dispatchable shape, so no
        # request pays a first build
        n_warm = app.engine.warmup()
        # bound before the serving line, so the line means "accepting"
        server = make_server(app, args.host, args.port)
        print(
            f"beacon serving on {args.host}:{args.port} "
            f"({n} index shards loaded, device {local.device}, "
            f"{len(args.worker)} workers, {n_warm} kernel programs warmed)",
            flush=True,
        )
        _serve_forever(server, app)
    except KeyboardInterrupt:
        pass
    finally:
        app.close()
        if engine is not local:
            engine.close()
        local.close()


if __name__ == "__main__":  # pragma: no cover
    main()
