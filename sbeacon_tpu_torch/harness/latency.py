"""Endpoint latency harness.

Counterpart of ``sbeacon_tpu/harness/latency.py``, copied whole. The
role of the reference's ``simulations/test.py``: walk the live API —
datasets -> cohorts -> individuals -> biosamples -> runs -> analyses ->
g_variants, with a complex multi-scope filter query at the end — timing
each call (cold run skipped, like the reference's compute_times). Unlike
the reference it asserts on response sanity, not just prints.
"""

from __future__ import annotations

import json
import time



class Client:
    """Keep-alive HTTP client (one persistent connection per client).

    The server speaks HTTP/1.1 keep-alive (api/server.py); opening a
    fresh TCP connection per request — as urllib does — makes the
    ThreadingHTTPServer spawn a thread per REQUEST instead of per
    client, and on a small host that thread churn alone produced a
    >50x p50 soak tail with the kernels fully warm. Real load generators
    keep connections alive; so does this one.
    """

    def __init__(self, base_url: str, timeout: float = 60.0):
        import urllib.parse

        u = urllib.parse.urlparse(base_url)
        self.host = u.hostname
        self.port = u.port
        self.timeout = timeout
        self._conn = None

    def _connection(self):
        import http.client

        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
        return self._conn

    def _request(self, method, path, body=None, headers=None):
        import http.client
        import socket

        for attempt in (0, 1):  # retry once over a fresh connection
            conn = self._connection()
            try:
                conn.request(method, path, body=body, headers=headers or {})
                r = conn.getresponse()
                data = r.read()
                return r.status, json.loads(data)
            except socket.timeout:
                # the server may already be executing this request —
                # re-sending would double-submit work and report a
                # 2x-timeout latency sample; surface the timeout
                self._conn = None
                raise
            except (http.client.HTTPException, OSError):
                # stale keep-alive (server closed between requests,
                # reset, bad status line): safe to replay once on a
                # fresh connection
                self._conn = None
                if attempt:
                    raise

    def get(self, path: str, params: dict | None = None):
        if params:
            from urllib.parse import urlencode

            path += "?" + urlencode(params)
        return self._request("GET", path)

    def post(self, path: str, body: dict):
        return self._request(
            "POST",
            path,
            body=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )


def _timed(fn, *, reps: int = 3) -> tuple[float, object]:
    """Median latency over reps, first (cold) run excluded
    (reference compute_times:43-56 skips the cold run)."""
    times = []
    result = None
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        result = fn()
        times.append(time.perf_counter() - t0)
    times = sorted(times[1:])
    return times[len(times) // 2], result


def run_latency_suite(
    base_url: str, *, reps: int = 3, assembly_id: str = "GRCh38"
) -> dict[str, float]:
    """{check_name: median_seconds}; raises on any non-200/insane body."""
    c = Client(base_url)
    out: dict[str, float] = {}

    def check(name, fn, expect=None):
        t, (status, body) = _timed(fn, reps=reps)
        assert status == 200, (name, status, body)
        if expect is not None:
            assert expect(body), (name, body)
        out[name] = t

    check("info", lambda: c.get("/info"), lambda b: "response" in b)
    check("map", lambda: c.get("/map"))
    check("configuration", lambda: c.get("/configuration"))
    check("entry_types", lambda: c.get("/entry_types"))
    check(
        "filtering_terms",
        lambda: c.get("/filtering_terms"),
        lambda b: b["response"]["filteringTerms"],
    )

    record = {"requestedGranularity": "record", "limit": 10}
    for entity in (
        "datasets",
        "cohorts",
        "individuals",
        "biosamples",
        "runs",
        "analyses",
    ):
        check(
            f"{entity}[record]",
            lambda e=entity: c.get(f"/{e}", record),
            lambda b: b["responseSummary"]["exists"],
        )
        check(
            f"{entity}[count]",
            lambda e=entity: c.get(
                f"/{e}", {"requestedGranularity": "count"}
            ),
            lambda b: b["responseSummary"]["numTotalResults"] > 0,
        )

    # entity walk: dataset -> individuals -> biosamples -> runs
    _, body = c.get("/datasets", record)
    ds = body["response"]["resultSets"][0]["results"][0]["id"]
    check(
        "datasets/{id}/individuals",
        lambda: c.get(f"/datasets/{ds}/individuals", record),
        lambda b: b["responseSummary"]["exists"],
    )
    _, body = c.get(f"/datasets/{ds}/individuals", record)
    ind = body["response"]["resultSets"][0]["results"][0]["id"]
    check(
        "individuals/{id}/biosamples",
        lambda: c.get(f"/individuals/{ind}/biosamples", record),
    )

    # the reference's complex 5-scope filter query (test.py:118-139)
    complex_query = {
        "query": {
            "requestedGranularity": "count",
            "filters": [
                {"id": "NCIT:C16576", "scope": "individuals"},
                {"id": "UBERON:0000178", "scope": "biosamples"},
            ],
        }
    }
    check(
        "individuals[complex-filter]",
        lambda: c.post("/individuals", complex_query),
    )

    # variant queries: boolean + record over a broad window
    gv = {
        "query": {
            "requestedGranularity": "boolean",
            "requestParameters": {
                "assemblyId": assembly_id,
                "referenceName": "22",
                "start": [0],
                "end": [100_000_000],
                "alternateBases": "N",
            },
        }
    }
    check(
        "g_variants[boolean]",
        lambda: c.post("/g_variants", gv),
        lambda b: b["responseSummary"]["exists"],
    )
    gv_rec = json.loads(json.dumps(gv))
    gv_rec["query"]["requestedGranularity"] = "record"
    gv_rec["query"]["includeResultsetResponses"] = "HIT"
    check("g_variants[record]", lambda: c.post("/g_variants", gv_rec))
    return out


def run_concurrent_soak(
    base_url: str,
    *,
    queries: list[dict],
    n_clients: int = 16,
    requests_per_client: int = 50,
    engine=None,
    path: str = "/g_variants",
) -> dict:
    """N concurrent clients against the live HTTP server: p50/p95/p99
    per-request latency + sustained q/s, plus the micro-batcher's
    occupancy histogram when the serving engine is handed in — the
    evidence that batching engages under contention (reference shape:
    simulations/test.py, which measured a deployed API).

    ``queries`` are POST bodies cycled across clients so the batcher
    sees a mixed stream, as concurrent real clients would produce.
    NOTE: repeated identical bodies are answered by the query-job
    result cache without touching the kernel — pass one distinct query
    per request when the goal is measuring batching rather than cache
    hits.
    """
    import threading

    batcher = getattr(engine, "_batcher", None) if engine is not None else None
    before = batcher.occupancy() if batcher is not None else None
    lat: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()
    start = threading.Barrier(n_clients + 1)

    def client(k: int):
        c = Client(base_url)
        mine = []
        start.wait()
        for i in range(requests_per_client):
            body = queries[(k * requests_per_client + i) % len(queries)]
            t0 = time.perf_counter()
            try:
                status, _ = c.post(path, body)
                if status != 200:
                    raise RuntimeError(f"status {status}")
            except Exception as e:  # noqa: BLE001 - recorded, not raised
                with lock:
                    errors.append(f"client{k}:{e}")
                continue
            mine.append(time.perf_counter() - t0)
        with lock:
            lat.extend(mine)

    threads = [
        threading.Thread(target=client, args=(k,), daemon=True)
        for k in range(n_clients)
    ]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    lat.sort()

    def pct(p):
        if not lat:  # all requests failed: report, don't crash
            return None
        return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 2)

    out = {
        "n_clients": n_clients,
        "requests": len(lat),
        "errors": len(errors),
        "wall_s": round(wall, 2),
        "qps": round(len(lat) / wall, 1) if wall else 0.0,
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
    }
    if batcher is not None:
        after = batcher.occupancy()
        hist = {
            k: after["histogram"].get(k, 0) - before["histogram"].get(k, 0)
            for k in set(after["histogram"]) | set(before["histogram"])
        }
        hist = {k: v for k, v in sorted(hist.items()) if v}
        launches = sum(hist.values())
        submits = after["submits"] - before["submits"]
        out["batcher"] = {
            "submits": submits,
            "launches": launches,
            "mean_batch": round(submits / launches, 2) if launches else 0.0,
            "histogram": hist,
        }
        # tail attribution: server-side queue wait vs device execute,
        # split per stage (encode / launch, plus the engine's host
        # materialize) so p99 is explainable down to the stage that
        # owns it
        if hasattr(batcher, "timing_summary"):
            out["decomposition"] = batcher.timing_summary()
        if hasattr(engine, "stage_timing"):
            out.setdefault("decomposition", {}).update(
                engine.stage_timing()
            )
    if engine is not None and callable(getattr(engine, "cache_stats", None)):
        stats = engine.cache_stats()
        if stats is not None:
            out["response_cache"] = {
                k: stats[k]
                for k in ("hits", "misses", "hit_rate", "entries",
                          "negative_hits", "evictions")
            }
    if errors:
        out["first_errors"] = errors[:3]
    return out


def main():  # pragma: no cover - CLI
    import argparse

    ap = argparse.ArgumentParser(description="Beacon latency suite")
    ap.add_argument("--url", required=True)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    results = run_latency_suite(args.url, reps=args.reps)
    for name, t in results.items():
        print(f"{name:40s} {t * 1000:9.2f} ms")


if __name__ == "__main__":  # pragma: no cover
    main()
