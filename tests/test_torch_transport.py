"""The port's pooled keep-alive transport (``parallel/transport.py``).

Twins of the nine behavioural tests of ``tests/test_transport.py``:
connection reuse, the pool bound, idle eviction, the stale-connection
replay, gzip bodies, HTTP errors returned as statuses, the deadline
clamp, pre-serialized bodies and the unpooled fallbacks. The
stale-connection case waits on a server-side event set once the
server has really closed the socket, so the replay it checks is never
raced by the server's own close.
"""

import gzip
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from sbeacon_tpu_torch.parallel.transport import (
    PooledTransport,
    urllib_get,
    urllib_post,
)
from sbeacon_tpu_torch.resilience import Deadline, deadline_scope
from torch_ingest_corpus import no_thread_leak  # noqa: F401


class EchoHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, status, doc):
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        # read the mode BEFORE answering: the client may change it as
        # soon as it has the response
        sneaky = self.server.sneaky_close
        if self.path == "/missing":
            self._send(404, {"error": "not found"})
        else:
            self._send(200, {"ok": True, "path": self.path})
        if sneaky:
            # close WITHOUT a Connection: close header — the silent
            # idle-close a pooled client only discovers on its next send
            self.close_connection = True
            self.server.sneaky_sockets.add(self.request)

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n)
        was_gzip = self.headers.get("Content-Encoding", "").lower() == "gzip"
        if was_gzip:
            raw = gzip.decompress(raw)
        self._send(200, {"len": len(raw), "gzip": was_gzip,
                         "echo": json.loads(raw)})


class EchoServer(ThreadingHTTPServer):
    """Counts accepted connections; ``closed`` is set once a socket the
    handler closed silently is really shut."""

    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), EchoHandler)
        self.accepts = 0
        self.sneaky_close = False
        self.sneaky_sockets: set = set()
        self.closed = threading.Event()
        self.thread = threading.Thread(target=self.serve_forever,
                                       daemon=True)
        self.thread.start()

    def get_request(self):
        self.accepts += 1
        return super().get_request()

    def shutdown_request(self, request):
        super().shutdown_request(request)
        if request in self.sneaky_sockets:
            self.closed.set()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}"

    def stop(self):
        self.shutdown()
        self.server_close()
        self.thread.join()


@pytest.fixture()
def echo():
    s = EchoServer()
    try:
        yield s
    finally:
        s.stop()


@pytest.fixture()
def transport():
    made = []

    def make(**kw):
        t = PooledTransport(**kw)
        made.append(t)
        return t

    try:
        yield make
    finally:
        for t in made:
            t.close()


def test_sequential_calls_reuse_one_connection(echo, transport):
    t = transport(pool_size=2)
    for _ in range(8):
        status, doc = t.get_json(f"{echo.url}/hello", 5)
        assert status == 200 and doc["ok"]
    status, doc = t.post_json(f"{echo.url}/echo", {"k": 1}, 5)
    assert status == 200 and doc["echo"] == {"k": 1}
    m = t.metrics()
    assert m["opened"] == 1, m
    assert m["reused"] == 8, m
    assert echo.accepts == 1


def test_pool_bounds_kept_connections(echo, transport):
    """A burst beyond pool_size opens extra connections but only
    pool_size survive checkin — the rest are closed, not hoarded."""
    t = transport(pool_size=2)
    barrier = threading.Barrier(5)
    statuses = []

    def one():
        barrier.wait()
        statuses.append(t.get_json(f"{echo.url}/x", 5)[0])

    threads = [threading.Thread(target=one) for _ in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert statuses == [200] * 5
    m = t.metrics()
    assert m["pooled"] <= 2, m
    assert m["opened"] >= 2, m  # a real burst happened


def test_idle_ttl_evicts_pooled_connections(echo, transport):
    clock = [0.0]
    t = transport(pool_size=2, idle_ttl_s=10.0, clock=lambda: clock[0])
    t.get_json(f"{echo.url}/a", 5)
    clock[0] = 5.0
    t.get_json(f"{echo.url}/b", 5)  # fresh enough: reused
    assert t.metrics()["reused"] == 1
    clock[0] = 20.0  # idle past the TTL: evicted, a new one opened
    t.get_json(f"{echo.url}/c", 5)
    m = t.metrics()
    assert m["evicted"] == 1, m
    assert m["opened"] == 2, m


def test_stale_pooled_connection_replayed_once(echo, transport):
    """The server closing a pooled connection between requests is
    invisible: the call replays once on a fresh connection."""
    t = transport(pool_size=2)
    echo.sneaky_close = True
    assert t.get_json(f"{echo.url}/a", 5)[0] == 200
    # wait until the server has really closed the pooled connection
    assert echo.closed.wait(30)
    echo.sneaky_close = False
    status, doc = t.get_json(f"{echo.url}/b", 5)
    assert status == 200 and doc["ok"]
    assert t.metrics()["retried"] == 1
    assert t.metrics()["opened"] == 2


def test_gzip_bodies_over_threshold(echo, transport):
    t = transport(gzip_min_bytes=64)
    status, doc = t.post_json(f"{echo.url}/echo", {"k": "v"}, 5)
    assert status == 200 and doc["gzip"] is False
    big = {"pad": "x" * 500}
    status, doc = t.post_json(f"{echo.url}/echo", big, 5)
    assert status == 200
    assert doc["gzip"] is True and doc["echo"] == big
    assert t.metrics()["gzip_bodies"] == 1


def test_http_error_statuses_are_returned_not_raised(echo, transport):
    status, doc = transport().get_json(f"{echo.url}/missing", 5)
    assert status == 404 and "error" in doc


def test_deadline_clamps_before_send(echo, transport):
    t = transport()
    with deadline_scope(Deadline.after(1e-9)):
        with pytest.raises(TimeoutError):
            t.get_json(f"{echo.url}/a", 5)
    assert echo.accepts == 0  # nothing was sent


def test_bytes_body_passthrough(echo, transport):
    """post_json ships pre-serialized bytes verbatim (the dispatcher's
    no-double-encode hot path)."""
    body = json.dumps({"pre": "serialized"}).encode()
    status, doc = transport().post_json(f"{echo.url}/echo", body, 5)
    assert status == 200 and doc["echo"] == {"pre": "serialized"}
    assert PooledTransport.post_json.accepts_bytes
    assert PooledTransport.post_bytes.accepts_bytes


def test_urllib_get_returns_status_on_http_error(echo):
    """urllib_get carries the HTTPError -> (code, body) handling of
    urllib_post: a 404 on a discovery GET is a countable answer."""
    status, doc = urllib_get(f"{echo.url}/missing", 5)
    assert status == 404 and "error" in doc
    status, doc = urllib_post(f"{echo.url}/echo", {"a": 1}, 5)
    assert status == 200 and doc["echo"] == {"a": 1}
