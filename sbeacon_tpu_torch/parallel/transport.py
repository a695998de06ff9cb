"""Pooled keep-alive HTTP transport for the coordinator-worker data plane.

Counterpart of ``sbeacon_tpu/parallel/transport.py``, all of it (it is
stdlib only): every coordinator->worker hop (the ``DistributedEngine``
search fan-out, discovery and digest GETs) rides a persistent channel
instead of a TCP handshake per call.

- :class:`PooledTransport` — a per-``scheme://netloc`` pool of
  ``http.client`` connections with a bounded size, idle-TTL eviction,
  retry-once semantics when a *reused* connection turns out to be stale
  (the server idle-closed it between requests — the one failure mode
  that is always safe to replay), deadline-clamped socket timeouts, and
  optional gzip request bodies over a size threshold.
- ``urllib_post`` / ``urllib_get`` / ``urllib_post_bytes`` — the
  unpooled stdlib fallbacks (this file is the single module of the
  package allowed to touch ``urllib.request.urlopen`` on the worker
  data plane — ``tools/check_transport_usage.py``'s rule, held on this
  package by ``tests/test_torch_transport_lint.py``). All three return
  ``(status, body)`` for HTTP error statuses instead of raising, so
  circuit breakers can count them.
- Process-wide transport telemetry (connections opened/reused/evicted,
  gzip bodies, hedges, per-worker RTT histogram) registered into an
  app's :class:`~sbeacon_tpu_torch.telemetry.MetricsRegistry` via
  :func:`register_transport_metrics`.

Everything here is stdlib-only and thread-safe; the pool is shaped for
the dispatcher's scatter pattern (a few long-lived worker hosts, many
short requests), not as a general HTTP client.
"""

from __future__ import annotations

import gzip
import http.client
import json
import logging
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from ..resilience import current_deadline

log = logging.getLogger(__name__)

#: connections kept alive per worker host (not a concurrency cap: a
#: burst beyond the pool opens extra connections that are closed, not
#: pooled, on return)
DEFAULT_POOL_SIZE = 4
#: pooled connections idle longer than this are closed on next touch
#: (workers reap their side a little later, so eviction happens here)
DEFAULT_IDLE_TTL_S = 60.0
#: request bodies at or over this size are gzip-compressed (0 disables)
DEFAULT_GZIP_MIN_BYTES = 32 * 1024


# -- process-wide transport telemetry -----------------------------------------


class _ProcessStats:
    """Aggregate counters across every live transport instance, so the
    app registry observes the whole process's data plane (every
    coordinator's pool is a separate instance but one operational
    surface)."""

    _KEYS = ("opened", "reused", "evicted", "retried", "gzip_bodies",
             "hedges")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self._KEYS, 0)
        self._hist = None  # bound by register_transport_metrics

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts[key]

    def bind_histogram(self, hist) -> None:
        # latest registry wins the observations (one app per process in
        # every deployment shape; tests that build several apps only
        # assert on the newest)
        self._hist = hist

    def observe_rtt(self, worker: str, ms: float) -> None:
        h = self._hist
        if h is not None:
            h.observe(ms, label_value=worker)

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(self._KEYS, 0)


_STATS = _ProcessStats()


def note_hedge() -> None:
    """Record one hedged request (fired by the replica-hedged search
    when the primary outlives the hedge delay)."""
    _STATS.bump("hedges")


def reset_transport_stats() -> None:
    """Zero the process-wide counters (test isolation)."""
    _STATS.reset()


def register_transport_metrics(registry) -> None:
    """Register the data-plane transport series into ``registry``.

    One literal registration site for the whole package (the
    metric-name lint rejects duplicates): both ``DistributedEngine``
    and the app's single-host fallback route through here. The series
    are process-wide aggregates — see :class:`_ProcessStats`."""
    registry.counter(
        "transport.conn.opened",
        "TCP connections opened to worker hosts",
        fn=lambda: _STATS.get("opened"),
    )
    registry.counter(
        "transport.conn.reused",
        "worker calls served over a pooled keep-alive connection",
        fn=lambda: _STATS.get("reused"),
    )
    registry.counter(
        "transport.conn.evicted",
        "pooled connections closed by idle-TTL eviction",
        fn=lambda: _STATS.get("evicted"),
    )
    registry.counter(
        "transport.conn.retried",
        "calls replayed on a fresh connection after a stale pooled one",
        fn=lambda: _STATS.get("retried"),
    )
    registry.counter(
        "transport.gzip_bodies",
        "request bodies gzip-compressed over the size threshold",
        fn=lambda: _STATS.get("gzip_bodies"),
    )
    registry.counter(
        "transport.hedges",
        "hedged worker requests fired after the hedge delay",
        fn=lambda: _STATS.get("hedges"),
    )
    _STATS.bind_histogram(
        registry.histogram(
            "transport.rtt_ms",
            "coordinator->worker HTTP round-trip time",
            label="worker",
        )
    )


# -- the pooled transport ------------------------------------------------------


class PooledTransport:
    """Bounded per-host connection pool over ``http.client``.

    ``request`` is the raw entry; :meth:`post_json` / :meth:`get_json` /
    :meth:`post_bytes` mirror the historical ``urllib_*`` transport
    signatures so they drop into the dispatcher's injectable seams.
    The JSON/bytes helpers accept a pre-serialized ``bytes`` body as
    well as a dict (``accepts_bytes`` attribute — the dispatcher checks
    it to skip the dict round-trip on the hot path).
    """

    def __init__(
        self,
        *,
        pool_size: int = DEFAULT_POOL_SIZE,
        idle_ttl_s: float = DEFAULT_IDLE_TTL_S,
        gzip_min_bytes: int = DEFAULT_GZIP_MIN_BYTES,
        clock=time.monotonic,
    ):
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        self.pool_size = pool_size
        self.idle_ttl_s = idle_ttl_s
        self.gzip_min_bytes = gzip_min_bytes
        self._clock = clock
        self._lock = threading.Lock()
        # "scheme://netloc" -> [(conn, last_checkin)] LIFO stack: the
        # most recently used connection is the least likely to have
        # been idle-closed by the server
        self._pools: dict[str, list[tuple]] = {}
        self._closed = False
        # per-instance counters (tests assert on these; _STATS carries
        # the process-wide aggregate for the app registry)
        self.opened = 0
        self.reused = 0
        self.evicted = 0
        self.retried = 0
        self.gzip_bodies = 0

    @classmethod
    def from_config(cls, tcfg) -> "PooledTransport":
        """Build from a :class:`~sbeacon_tpu_torch.config.TransportConfig`."""
        return cls(
            pool_size=tcfg.pool_size,
            idle_ttl_s=tcfg.idle_ttl_s,
            gzip_min_bytes=tcfg.gzip_min_bytes,
        )

    # -- pool plumbing -------------------------------------------------------

    def _checkout(self, key: str, parts, timeout_s, *, fresh: bool = False):
        """A live pooled connection for ``key``, or a fresh one
        (``fresh=True`` always opens — the stale-replay path must not
        pop ANOTHER possibly-stale pooled connection).
        Returns ``(conn, reused)``."""
        now = self._clock()
        stale = []
        conn = None
        with self._lock:
            stack = None if fresh else self._pools.get(key)
            while stack:
                cand, last = stack.pop()
                if now - last > self.idle_ttl_s:
                    stale.append(cand)
                    continue
                conn = cand
                self.reused += 1
                break
        for c in stale:  # close outside the lock
            self.evicted += 1
            _STATS.bump("evicted")
            try:
                c.close()
            except Exception:
                pass
        if conn is not None:
            _STATS.bump("reused")
            return conn, True
        cls = (
            http.client.HTTPSConnection
            if parts.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = cls(parts.hostname, parts.port, timeout=timeout_s)
        self.opened += 1
        _STATS.bump("opened")
        return conn, False

    def _drop_pool(self, key: str) -> None:
        """Close every pooled connection for ``key``: one stale
        connection means the worker restarted (or idle-closed its
        side), so its pooled siblings are almost certainly stale too —
        letting each later call discover that individually would cost
        one replay apiece."""
        with self._lock:
            stack = self._pools.pop(key, [])
        for conn, _last in stack:
            try:
                conn.close()
            except Exception:
                pass

    def _checkin(self, key: str, conn) -> None:
        with self._lock:
            if not self._closed:
                stack = self._pools.setdefault(key, [])
                if len(stack) < self.pool_size:
                    stack.append((conn, self._clock()))
                    return
        try:
            conn.close()
        except Exception:
            pass

    def close(self) -> None:
        """Drop every pooled connection (engine shutdown)."""
        with self._lock:
            self._closed = True
            pools, self._pools = self._pools, {}
        for stack in pools.values():
            for conn, _last in stack:
                try:
                    conn.close()
                except Exception:
                    pass

    def metrics(self) -> dict:
        with self._lock:
            pooled = sum(len(s) for s in self._pools.values())
        return {
            "opened": self.opened,
            "reused": self.reused,
            "evicted": self.evicted,
            "retried": self.retried,
            "gzip_bodies": self.gzip_bodies,
            "pooled": pooled,
        }

    # -- request path --------------------------------------------------------

    def request(
        self,
        method: str,
        url: str,
        body: bytes | None = None,
        headers: dict | None = None,
        timeout_s: float | None = None,
    ) -> tuple[int, bytes]:
        """One HTTP exchange -> ``(status, raw_body)``.

        HTTP error statuses are *returned*, never raised (the breaker
        counts them); only transport-level failures raise. A reused
        connection that fails before a response is replayed ONCE on a
        fresh connection — except on timeout, where the server may
        already be executing the request and a replay would
        double-submit work.
        """
        parts = urllib.parse.urlsplit(url)
        key = f"{parts.scheme}://{parts.netloc}"
        path = parts.path or "/"
        if parts.query:
            path = f"{path}?{parts.query}"
        hdrs = dict(headers or {})
        if (
            body is not None
            and self.gzip_min_bytes > 0
            and len(body) >= self.gzip_min_bytes
            and "Content-Encoding" not in hdrs
        ):
            body = gzip.compress(body, compresslevel=1)
            hdrs["Content-Encoding"] = "gzip"
            self.gzip_bodies += 1
            _STATS.bump("gzip_bodies")
        # the request deadline clamps the socket timeout even when the
        # caller forgot to (defense in depth; the dispatcher clamps
        # explicitly before every call)
        timeout_s = current_deadline().clamp(timeout_s)
        if timeout_s is not None and timeout_s <= 0:
            raise TimeoutError(f"{url}: deadline expired before send")
        attempt = 0
        while True:
            conn, reused = self._checkout(
                key, parts, timeout_s, fresh=attempt > 0
            )
            t0 = time.perf_counter()
            try:
                conn.timeout = timeout_s
                if conn.sock is not None:
                    conn.sock.settimeout(timeout_s)
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as e:
                try:
                    conn.close()
                except Exception:
                    pass
                if (
                    reused
                    and attempt == 0
                    and not isinstance(e, TimeoutError)
                ):
                    # stale keep-alive: the worker closed the pooled
                    # connection between requests. Nothing was
                    # processed, so one replay on a FRESH (never
                    # pooled — its siblings are just as stale)
                    # connection is safe and invisible to the caller;
                    # the rest of the key's pool is flushed for the
                    # same reason.
                    self._drop_pool(key)
                    attempt += 1
                    self.retried += 1
                    _STATS.bump("retried")
                    continue
                raise
            _STATS.observe_rtt(
                parts.netloc, (time.perf_counter() - t0) * 1e3
            )
            if resp.will_close:
                try:
                    conn.close()
                except Exception:
                    pass
            else:
                self._checkin(key, conn)
            return resp.status, data

    # -- dispatcher-shaped helpers ------------------------------------------

    def post_json(
        self, url: str, doc, timeout_s: float, headers: dict | None = None
    ) -> tuple[int, dict]:
        """JSON request -> JSON response; ``doc`` may be a dict or
        pre-serialized JSON bytes."""
        body = (
            bytes(doc)
            if isinstance(doc, (bytes, bytearray))
            else json.dumps(doc).encode()
        )
        status, data = self.request(
            "POST",
            url,
            body=body,
            headers={"Content-Type": "application/json", **(headers or {})},
            timeout_s=timeout_s,
        )
        return status, _parse_json(data)

    def get_json(
        self, url: str, timeout_s: float, headers: dict | None = None
    ) -> tuple[int, dict]:
        status, data = self.request(
            "GET", url, headers=headers, timeout_s=timeout_s
        )
        return status, _parse_json(data)

    def post_bytes(
        self, url: str, doc, timeout_s: float, headers: dict | None = None
    ) -> tuple[int, bytes]:
        """JSON request -> raw-bytes response (the slice-scan shape)."""
        body = (
            bytes(doc)
            if isinstance(doc, (bytes, bytearray))
            else json.dumps(doc).encode()
        )
        return self.request(
            "POST",
            url,
            body=body,
            headers={"Content-Type": "application/json", **(headers or {})},
            timeout_s=timeout_s,
        )


#: the dispatcher checks this attribute to pass pre-serialized payload
#: bytes instead of a dict (skipping the loads->dumps round-trip);
#: injected legacy transports lack it and keep receiving dicts
PooledTransport.post_json.accepts_bytes = True
PooledTransport.post_bytes.accepts_bytes = True


def _parse_json(data: bytes) -> dict:
    try:
        return json.loads(data)
    except Exception:
        return {"error": data[:200].decode("utf-8", errors="replace")}


# -- unpooled stdlib fallbacks -------------------------------------------------
#
# Kept for injectable test seams and one-shot CLI probes. All three
# return (status, body) on HTTP error statuses — urllib raises
# HTTPError for 4xx/5xx, which would bypass the callers' breaker
# accounting (a 401-answering worker is ALIVE; only transport failures
# should look like unreachability).


def urllib_post(
    url: str, doc, timeout_s: float, headers: dict | None = None
) -> tuple[int, dict]:
    data = (
        bytes(doc)
        if isinstance(doc, (bytes, bytearray))
        else json.dumps(doc).encode()
    )
    req = urllib.request.Request(
        url,
        data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except Exception:
            return e.code, {"error": str(e)}


def urllib_get(
    url: str, timeout_s: float, headers: dict | None = None
) -> tuple[int, dict]:
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        # a 4xx/5xx on a discovery/health GET comes back as (status,
        # body) like urllib_post's, not raised: raising would make auth
        # failures indistinguishable from network unreachability in the
        # breaker's accounting
        try:
            return e.code, json.loads(e.read())
        except Exception:
            return e.code, {"error": str(e)}


def urllib_post_bytes(
    url: str, doc, timeout_s: float, headers: dict | None = None
) -> tuple[int, bytes]:
    """JSON request -> raw-bytes response (the slice-scan transport)."""
    data = (
        bytes(doc)
        if isinstance(doc, (bytes, bytearray))
        else json.dumps(doc).encode()
    )
    req = urllib.request.Request(
        url,
        data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


urllib_post.accepts_bytes = True
urllib_get.accepts_bytes = False
urllib_post_bytes.accepts_bytes = True
