"""Async variant-query job table: the VariantQuery state machine re-homed.

Counterpart of ``sbeacon_tpu/query_jobs.py``, copied whole: ``JobStatus``,
``hash_query``, ``QueryJobTable`` and ``AsyncQueryRunner``; the purge
sweep unpacks the in-memory handoff's three fields (the JAX copy's
unpacks two and raises).

The reference tracks each distributed variant query in two DynamoDB tables
(reference: dynamodb.tf:100-149): ``VariantQueries`` — one row per query
with an atomic ``fanOut`` counter, start/end/elapsed times and a 5-minute
TTL (shared_resources/dynamodb/variant_queries.py:29-59) — and
``VariantQueryResponses`` — one row per worker result, spilling any body
over 300 KB to ``variant-queries/{uuid}.json`` in S3 with a 24-hour TTL
(performQuery/search_variants.py:282-300; s3.tf:22-28). Queries are keyed
by an md5 of the request (apiutils/request_hash.py:6-13) and a stubbed
``get_job_status`` (variant_queries.py:94-103 — always ``NEW``, "TODO
implement caching") decides whether to recompute.

Here the fan-out/fan-in apparatus is gone — one compiled program answers
the whole query (SURVEY.md §2.5) — but the *job* semantics remain useful
and are implemented for real rather than stubbed: request-hash keyed
jobs, RUNNING detection (concurrent identical queries coalesce), COMPLETE
result caching with TTL, spill-to-file for oversized response sets, and a
crash-surviving sqlite ledger (same pattern as ``ingest.ledger``). The
``fan_out``/``responses`` counters are kept per job for observability
parity with the reference's table schema.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import sqlite3
import threading
import time
import uuid
from collections import deque
from enum import Enum
from pathlib import Path

from concurrent.futures import ThreadPoolExecutor

from .config import ResilienceConfig
from .harness.faults import fault_point
from .payloads import VariantSearchResponse
from .resilience import (
    AdmissionController,
    Overloaded,
    current_deadline,
    deadline_scope,
)
from .telemetry import (
    annotate,
    current_context,
    percentiles,
    request_context,
)
from .utils.trace import current_span_id, instant, record, span

#: ``runner.queue_wait_ms`` bucket bounds: geometric from 0.5 ms to
#: 10 s, each bucket under 25% wider than its lower bound, so a median
#: interpolated within one is off by less than that
RUNNER_WAIT_BUCKETS_MS = tuple(
    round(0.5 * 20000 ** (k / 45), 4) for k in range(46)
)


class _TableLock:
    """The job table's lock; waiting for it is a ``jobs.lock`` span."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()

    def __enter__(self):
        with span("jobs.lock"):
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


class JobStatus(Enum):
    """reference: variant_queries.py:88-92 (EXPIRED is implicit there via
    the DynamoDB TTL delete; explicit here)."""

    COMPLETED = 1
    RUNNING = 2
    NEW = 3
    EXPIRED = 4


def hash_query(doc: dict | str) -> str:
    """Stable md5 of a request document — reference
    apiutils/request_hash.py:6-13 (sorted-key json of the event)."""
    if not isinstance(doc, str):
        doc = json.dumps(doc, sort_keys=True, default=str)
    return hashlib.md5(doc.encode()).hexdigest()


class QueryJobTable:
    """Sqlite-backed VariantQueries + VariantQueryResponses equivalent.

    Thread-safe within a process (one lock around the shared connection,
    matching ``ingest.ledger``); durable across restarts. Each wait for
    the lock is a ``jobs.lock`` span.
    """

    def __init__(
        self,
        path: str | Path = ":memory:",
        *,
        spill_dir: str | Path | None = None,
        query_ttl_s: float = 300.0,  # VariantQuery timeToExist: 5 min
        response_ttl_s: float = 24 * 3600.0,  # VariantQueryResponses: 24 h
        inline_limit: int = 300 * 1024,  # performQuery spill threshold
    ):
        self._conn = sqlite3.connect(str(path), check_same_thread=False)
        # WAL + NORMAL sync: commit cost drops from per-commit fsync to
        # WAL append — right durability trade for a TTL'd cache table (the
        # reference's DynamoDB was eventually consistent too); harmless
        # no-op for :memory:
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        # NO auto-checkpoint: whichever commit crosses the page
        # threshold absorbs the full checkpoint fsync — on the serving
        # thread that was a >1 s p99 outlier with warm kernels. The
        # runner's background purge sweep calls checkpoint() instead
        # (WAL growth bounded by one sweep interval of TTL'd cache
        # traffic).
        self._conn.execute("PRAGMA wal_autocheckpoint=0")
        self._lock = _TableLock()
        self.spill_dir = Path(spill_dir) if spill_dir else None
        if self.spill_dir:
            self.spill_dir.mkdir(parents=True, exist_ok=True)
        self.query_ttl_s = query_ttl_s
        self.response_ttl_s = response_ttl_s
        self.inline_limit = inline_limit
        with self._lock:
            self._conn.executescript(
                """
                CREATE TABLE IF NOT EXISTS variant_queries (
                    id TEXT PRIMARY KEY,
                    claim TEXT NOT NULL,
                    complete INTEGER NOT NULL DEFAULT 0,
                    fan_out INTEGER NOT NULL DEFAULT 0,
                    responses INTEGER NOT NULL DEFAULT 0,
                    responses_counter INTEGER NOT NULL DEFAULT 0,
                    start_time REAL NOT NULL,
                    end_time REAL,
                    elapsed_time REAL NOT NULL DEFAULT -1,
                    expires_at REAL NOT NULL
                );
                CREATE TABLE IF NOT EXISTS variant_query_responses (
                    query_id TEXT NOT NULL,
                    response_number INTEGER NOT NULL,
                    body TEXT,
                    spill_path TEXT,
                    expires_at REAL NOT NULL,
                    PRIMARY KEY (query_id, response_number)
                );
                """
            )
            self._conn.commit()
        # crash recovery: incomplete rows are claims held by workers of a
        # dead process — no thread in this (or any new) process will ever
        # complete them, so identical queries would stall on RUNNING for
        # up to the full TTL. Drop them (and their partial responses) now;
        # the reference analogue is the TTL delete, just not lazily.
        with self._lock, self._conn:
            stale = [
                qid
                for (qid,) in self._conn.execute(
                    "SELECT id FROM variant_queries WHERE complete = 0"
                )
            ]
            spilled = []
            for qid in stale:
                spilled += self._conn.execute(
                    "SELECT spill_path FROM variant_query_responses"
                    " WHERE query_id = ? AND spill_path IS NOT NULL",
                    (qid,),
                ).fetchall()
                self._conn.execute(
                    "DELETE FROM variant_queries WHERE id = ?", (qid,)
                )
                self._conn.execute(
                    "DELETE FROM variant_query_responses WHERE query_id = ?",
                    (qid,),
                )
        for (p,) in spilled:
            Path(p).unlink(missing_ok=True)

    # -- job lifecycle -------------------------------------------------------

    def get_job_status(self, query_id: str) -> JobStatus:
        """The un-stubbed version of reference variant_queries.py:94-103."""
        now = time.time()
        with self._lock:
            row = self._conn.execute(
                "SELECT complete, expires_at FROM variant_queries"
                " WHERE id = ?",
                (query_id,),
            ).fetchone()
        if row is None:
            return JobStatus.NEW
        complete, expires_at = row
        if now >= expires_at:
            return JobStatus.EXPIRED
        return JobStatus.COMPLETED if complete else JobStatus.RUNNING

    def start(self, query_id: str, *, fan_out: int = 0) -> str | None:
        """Claim a query id for execution; returns an opaque claim token,
        or None when an unexpired job already holds the claim (the
        concurrent-identical-query coalescing the reference's stub never
        delivered). All subsequent writes require the token, so a worker
        whose claim was reclaimed after TTL expiry cannot corrupt the new
        owner's job (the reference's conditional-expression ownership,
        summariseSlice/main.cpp:367-368, re-expressed)."""
        now = time.time()
        claim = uuid.uuid4().hex
        with self._lock, self._conn:
            spilled = self._conn.execute(
                "SELECT r.spill_path FROM variant_query_responses r"
                " JOIN variant_queries q ON q.id = r.query_id"
                " WHERE q.id = ? AND q.expires_at <= ?"
                " AND r.spill_path IS NOT NULL",
                (query_id, now),
            ).fetchall()
            purged = self._conn.execute(
                "DELETE FROM variant_queries WHERE id = ? AND expires_at <= ?",
                (query_id, now),
            )
            if purged.rowcount:
                self._conn.execute(
                    "DELETE FROM variant_query_responses WHERE query_id = ?",
                    (query_id,),
                )
            try:
                self._conn.execute(
                    "INSERT INTO variant_queries"
                    " (id, claim, fan_out, start_time, expires_at)"
                    " VALUES (?,?,?,?,?)",
                    (query_id, claim, fan_out, now, now + self.query_ttl_s),
                )
            except sqlite3.IntegrityError:
                return None
        for (p,) in spilled:
            Path(p).unlink(missing_ok=True)
        return claim

    def _owns(self, query_id: str, claim: str) -> bool:
        row = self._conn.execute(
            "SELECT 1 FROM variant_queries WHERE id = ? AND claim = ?",
            (query_id, claim),
        ).fetchone()
        return row is not None

    def next_response_number(self, query_id: str, claim: str) -> int:
        """Atomic increment — reference VariantQuery.getResponseNumber
        (variant_queries.py:45-50). 0 when the claim has been lost."""
        with self._lock, self._conn:
            if not self._owns(query_id, claim):
                return 0
            self._conn.execute(
                "UPDATE variant_queries SET responses_counter ="
                " responses_counter + 1 WHERE id = ?",
                (query_id,),
            )
            (n,) = self._conn.execute(
                "SELECT responses_counter FROM variant_queries WHERE id = ?",
                (query_id,),
            ).fetchone()
        return int(n)

    def put_response(
        self,
        query_id: str,
        response_number: int,
        resp: VariantSearchResponse,
        claim: str,
    ) -> bool:
        """Store one worker response, spilling past ``inline_limit`` —
        reference performQuery/search_variants.py:282-300. Refused (False)
        when the claim is no longer held."""
        body = resp.dumps()
        spill_path = None
        if len(body) > self.inline_limit and self.spill_dir is not None:
            spill_path = str(self.spill_dir / f"{uuid.uuid4()}.json")
            Path(spill_path).write_text(body)
            body = None
        fault_point("sqlite.commit", "put_response")
        now = time.time()
        with self._lock, self._conn:
            if not self._owns(query_id, claim):
                ok = False
            else:
                ok = True
                self._conn.execute(
                    "INSERT OR REPLACE INTO variant_query_responses"
                    " (query_id, response_number, body, spill_path,"
                    " expires_at) VALUES (?,?,?,?,?)",
                    (
                        query_id,
                        response_number,
                        body,
                        spill_path,
                        now + self.response_ttl_s,
                    ),
                )
        if not ok and spill_path:
            Path(spill_path).unlink(missing_ok=True)
        return ok

    def mark_finished(self, query_id: str, claim: str) -> int:
        """Atomic fan-in decrement; returns remaining fan_out — reference
        VariantQuery.markFinished (variant_queries.py:53-59)."""
        with self._lock, self._conn:
            if not self._owns(query_id, claim):
                return -1
            self._conn.execute(
                "UPDATE variant_queries SET responses = responses + 1,"
                " fan_out = fan_out - 1, end_time = ? WHERE id = ?",
                (time.time(), query_id),
            )
            (remaining,) = self._conn.execute(
                "SELECT fan_out FROM variant_queries WHERE id = ?",
                (query_id,),
            ).fetchone()
        return int(remaining)

    def complete(self, query_id: str, claim: str) -> bool:
        fault_point("sqlite.commit", "complete")
        now = time.time()
        with self._lock, self._conn:
            if not self._owns(query_id, claim):
                return False
            self._conn.execute(
                "UPDATE variant_queries SET complete = 1, end_time = ?,"
                " elapsed_time = ? - start_time WHERE id = ?",
                (now, now, query_id),
            )
        return True

    def abandon(self, query_id: str, claim: str) -> None:
        """Drop a failed job so its id reads NEW again — a crashed worker
        must not cache an empty result set as the answer (the reference's
        analogue: a lost slice simply stays pending and is re-run)."""
        with self._lock, self._conn:
            if not self._owns(query_id, claim):
                return
            spilled = self._conn.execute(
                "SELECT spill_path FROM variant_query_responses"
                " WHERE query_id = ? AND spill_path IS NOT NULL",
                (query_id,),
            ).fetchall()
            self._conn.execute(
                "DELETE FROM variant_queries WHERE id = ?", (query_id,)
            )
            self._conn.execute(
                "DELETE FROM variant_query_responses WHERE query_id = ?",
                (query_id,),
            )
        for (p,) in spilled:
            Path(p).unlink(missing_ok=True)

    def wait(self, query_id: str, timeout_s: float = 600.0) -> bool:
        """Poll fan_out==0 / complete — the reference's fan-in loop
        (variantutils/search_variants.py:130-141), REQUEST_TIMEOUT 600 s.
        Clamped by the caller's ambient request deadline: a 600 s poll
        budget never outlives the request it serves."""
        timeout_s = current_deadline().clamp(timeout_s)
        deadline = time.time() + timeout_s
        delay = 0.002
        while time.time() < deadline:
            status = self.get_job_status(query_id)
            if status is JobStatus.COMPLETED:
                return True
            if status in (JobStatus.NEW, JobStatus.EXPIRED):
                return False
            time.sleep(delay)
            delay = min(delay * 2, 0.1)
        return False

    # -- results -------------------------------------------------------------

    def get_responses(self, query_id: str) -> list[VariantSearchResponse]:
        """Rehydrate all responses (spilled bodies read back from disk) —
        reference search_variants.py:142-155 batch_get + S3 fetch."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT body, spill_path FROM variant_query_responses"
                " WHERE query_id = ? ORDER BY response_number",
                (query_id,),
            ).fetchall()
        out = []
        for body, spill_path in rows:
            if body is None and spill_path:
                body = Path(spill_path).read_text()
            if body is not None:
                out.append(VariantSearchResponse.loads(body))
        return out

    def info(self, query_id: str) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, complete, fan_out, responses, responses_counter,"
                " start_time, end_time, elapsed_time, expires_at"
                " FROM variant_queries WHERE id = ?",
                (query_id,),
            ).fetchone()
        if row is None:
            return None
        keys = (
            "id",
            "complete",
            "fan_out",
            "responses",
            "responses_counter",
            "start_time",
            "end_time",
            "elapsed_time",
            "expires_at",
        )
        return dict(zip(keys, row))

    def purge_expired(self) -> int:
        """TTL enforcement — the DynamoDB TTL delete + S3 lifecycle rule
        (dynamodb.tf:111-115,144-148; s3.tf:22-28)."""
        now = time.time()
        with self._lock, self._conn:
            spilled = self._conn.execute(
                "SELECT spill_path FROM variant_query_responses"
                " WHERE expires_at <= ? AND spill_path IS NOT NULL",
                (now,),
            ).fetchall()
            n = self._conn.execute(
                "DELETE FROM variant_queries WHERE expires_at <= ?", (now,)
            ).rowcount
            n += self._conn.execute(
                "DELETE FROM variant_query_responses WHERE expires_at <= ?",
                (now,),
            ).rowcount
        for (p,) in spilled:
            Path(p).unlink(missing_ok=True)
        return n

    def checkpoint(self) -> None:
        """WAL checkpoint + truncate — called from the runner's
        background sweep so no serving-thread commit ever absorbs the
        checkpoint fsync (auto-checkpoint is disabled)."""
        with self._lock:
            self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class AsyncQueryRunner:
    """Background execution + result caching over a :class:`QueryJobTable`.

    ``submit`` hashes the payload, coalesces concurrent identical queries,
    runs ``engine.search`` on a worker thread, stores the per-(dataset,vcf)
    response set through the job table (spill included), and completes the
    job; ``poll``/``result`` give the async API surface the reference's
    RUNNING/COMPLETED envelope switch needs
    (route_g_variants.py:199-214 elif status == JobStatus.RUNNING).

    Spans (``utils.trace``): ``runner.submit`` on the caller's thread;
    on the pool thread, under the submitter's context and with
    ``runner.submit`` as parent, ``runner.queue_wait`` (submit to the
    job's start), ``query_jobs.run`` and the ``runner.done`` instant;
    ``runner.await`` around :meth:`result`'s wait.
    """

    #: seconds between opportunistic TTL sweeps piggybacked on submit()
    PURGE_INTERVAL_S = 60.0
    #: in-memory lifetime of a PARTIAL (replicas-down, degraded) result:
    #: long enough to hand to the waiters coalesced onto the job, far
    #: too short to serve as a cached answer after the routes heal
    PARTIAL_HANDOFF_TTL_S = 5.0

    def __init__(
        self,
        engine,
        table: QueryJobTable,
        *,
        workers: int | None = None,
        max_pending: int | None = None,
    ):
        self.engine = engine
        self.table = table
        res = getattr(
            getattr(engine, "config", None), "resilience", None
        )
        # explicit None checks, not `or`: a configured 0 must fail
        # loudly (ThreadPoolExecutor / AdmissionController raise), not
        # silently coerce to the default. Fallback defaults read the
        # ResilienceConfig field declarations — ONE source, so an env
        # override (BEACON_SHED_RETRY_AFTER_S etc.) can never diverge
        # between the server gate and this runner gate.
        if workers is None:
            workers = getattr(
                res, "runner_workers", ResilienceConfig.runner_workers
            )
        if max_pending is None:
            max_pending = getattr(
                res, "runner_max_pending", ResilienceConfig.runner_max_pending
            )
        self.workers = workers
        self.max_pending = max_pending
        self.shed_retry_after_s = getattr(
            res, "shed_retry_after_s", ResilienceConfig.shed_retry_after_s
        )
        # lane-aware admission (shaping.py lanes): the bulk lane may
        # hold at most this share of the pending slots, so a record-
        # retrieval flood saturates its share while interactive
        # submissions keep admitting
        bulk_share = getattr(
            res, "runner_bulk_share", ResilienceConfig.runner_bulk_share
        )
        self._bulk_cap = max(1, int(self.max_pending * bulk_share))
        self._bulk_active = 0
        # single-flight observability: identical in-flight queries
        # collapsed onto a leader's pending result
        self._coalesced = 0
        # bounded pool, NOT thread-per-query: a flood of distinct
        # queries used to spawn one unbounded thread each — under
        # adversarial load that is a fork bomb with extra steps. The
        # pool bounds concurrency; the admission gate bounds the queue
        # behind it (excess submissions shed 429, never silently pile
        # up) — same mechanism as the server-level gate, acquired here
        # and released from the pool thread.
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="query-runner"
        )
        self._gate = AdmissionController(
            self.max_pending, retry_after_s=self.shed_retry_after_s
        )
        # in-process completion events: waiters block on these instead of
        # polling sqlite; cross-process (or post-restart) waiters fall
        # back to the table's poll loop
        self._done: dict[str, threading.Event] = {}
        # in-process result handoff: (responses, expiry) — waiters read
        # these directly, skipping the sqlite round-trip + re-parse
        self._results: dict[str, tuple[list, float]] = {}
        self._lock = threading.Lock()
        self._last_purge = time.time()
        self._sweeper: threading.Thread | None = None
        # admission-wait decomposition: submit -> execution start on
        # the bounded pool (the stage BEFORE the batcher's queue wait).
        # Ring for exact percentiles; the runner.queue_wait_ms
        # histogram feeds once an app registry wires it
        self._wait_ms: deque = deque(maxlen=4096)
        self._wait_hist = None

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def metrics(self) -> dict:
        gate = self._gate.metrics()
        with self._lock:
            coalesced, bulk_active = self._coalesced, self._bulk_active
        return {
            "workers": self.workers,
            "max_pending": self.max_pending,
            "active": gate["in_flight"],
            "shed": gate["shed"],
            "coalesced": coalesced,
            "bulk_active": bulk_active,
            "bulk_cap": self._bulk_cap,
        }

    def register_metrics(self, registry) -> None:
        """The runner pool's typed instruments (its slice of the old
        hand-assembled ``/metrics`` dict, now stable named series)."""
        registry.gauge(
            "runner.workers",
            "async query runner pool size",
            fn=lambda: self.workers,
        )
        registry.gauge(
            "runner.max_pending",
            "runner admission cap",
            fn=lambda: self.max_pending,
        )
        registry.gauge(
            "runner.active",
            "queries executing or queued in the runner",
            fn=lambda: self._gate.metrics()["in_flight"],
        )
        registry.counter(
            "runner.shed",
            "runner submissions shed with 429",
            fn=lambda: self._gate.metrics()["shed"],
        )
        registry.counter(
            "runner.coalesced",
            "identical in-flight queries collapsed onto a leader",
            fn=lambda: self._coalesced,
        )
        registry.gauge(
            "runner.bulk_active",
            "bulk-lane submissions holding runner slots",
            fn=lambda: self._bulk_active,
        )
        # the admission-wait slice of the queue-wait decomposition
        # (/debug/status composes it ahead of the batcher stages)
        self._wait_hist = registry.histogram(
            "runner.queue_wait_ms",
            "async-runner submit -> execution-start wait",
            buckets=RUNNER_WAIT_BUCKETS_MS,
        )

    def _note_coalesced(self) -> None:
        with self._lock:
            self._coalesced += 1
        annotate(query_job="coalesced")

    def _release_bulk(self, bulk_slot: bool) -> None:
        if bulk_slot:
            with self._lock:
                self._bulk_active -= 1

    def _note_queue_wait(self, wait_ms: float) -> None:
        with self._lock:
            self._wait_ms.append(wait_ms)
        h = self._wait_hist
        if h is not None:
            h.observe(wait_ms)

    def queue_wait_summary(self) -> dict:
        """Percentiles of the runner's admission wait over the bounded
        ring (empty dict before any async execution) — same summary
        semantics as every other stage in /debug/status."""
        with self._lock:
            xs = list(self._wait_ms)
        return percentiles(xs)

    def _maybe_purge(self) -> None:
        now = time.time()
        with self._lock:
            if now - self._last_purge < self.PURGE_INTERVAL_S:
                return
            # one sweeper at a time: a slow sweep (WAL checkpoint on a
            # busy disk) must not stack a fresh thread every interval
            if self._sweeper is not None and self._sweeper.is_alive():
                self._last_purge = now  # re-check next interval, not
                return  # on every submit meanwhile

            # the sweep DELETEs + commits — run it off the serving
            # thread (piggybacked purges used to stall ~1 request per
            # minute by a full fsync; a soak run's tail caught it)
            def sweep():
                self.table.purge_expired()
                self.table.checkpoint()
                with self._lock:
                    # entries are (responses, expiry, unavailable): the
                    # JAX copy unpacks two and its sweep thread dies on
                    # the first purge, so the handoffs never expire
                    dead = [
                        q
                        for q, (_, exp, _u) in self._results.items()
                        if exp <= now
                    ]
                    for q in dead:
                        del self._results[q]

            self._last_purge = now
            t = threading.Thread(
                target=sweep, name="query-jobs-purge", daemon=True
            )
            self._sweeper = t
        t.start()

    def submit(
        self, payload, *, fingerprint: str | None = None
    ) -> tuple[str, JobStatus]:
        """``fingerprint`` (e.g. the engine's index fingerprint) is folded
        into the query hash so cached results die with the data they were
        computed from. A ``runner.submit`` span on the caller's thread
        (the hit checks, the admission gate and the table claim), noting
        the query id and the status handed back."""
        with span("runner.submit") as sp:
            query_id, status = self._submit(payload, fingerprint)
            sp.note(query_id=query_id, status=status.name)
        return query_id, status

    def _submit(self, payload, fingerprint):
        self._maybe_purge()
        query_id = hash_query(
            {"payload": dataclasses.asdict(payload), "fp": fingerprint}
        )
        # in-memory results are authoritative the moment the search
        # finished — the table may still be mid-persistence (background)
        with self._lock:
            hit = self._results.get(query_id)
        if hit is not None and hit[1] > time.time():
            # job-layer outcome notes (telemetry): a repeat served here
            # never reaches engine.search, so the slow-query log would
            # otherwise show an unexplained fast request
            annotate(query_job="memory_hit")
            return query_id, JobStatus.COMPLETED
        status = self.table.get_job_status(query_id)
        if status is JobStatus.COMPLETED:
            annotate(query_job="table_hit")
            return query_id, status
        if status is JobStatus.RUNNING:
            # single-flight: coalesce onto the in-flight execution —
            # consumes no pool slot, so it must happen before the
            # capacity gate (and before the bulk-lane cap: a follower
            # attaches to the leader's pending result, it adds no work)
            self._note_coalesced()
            return query_id, status
        # lane-aware admission: the ambient lane note (set by the API
        # layer's classifier) decides whether this submission draws
        # from the bulk share of the pending slots
        ctx = current_context()
        lane = (ctx.notes.get("lane") if ctx is not None else None) or (
            "interactive"
        )
        bulk_slot = False
        if lane == "bulk":
            with self._lock:
                if self._bulk_active >= self._bulk_cap:
                    raise Overloaded(
                        f"query runner bulk lane at capacity "
                        f"({self._bulk_cap} of {self.max_pending} slots)",
                        retry_after_s=self.shed_retry_after_s,
                    )
                self._bulk_active += 1
                bulk_slot = True
        # reserve a pool slot BEFORE claiming: shedding after a claim
        # would leave the job RUNNING with nobody executing it, stalling
        # coalesced waiters for the full TTL. Coalescing onto an
        # existing claim consumes no slot and is never shed.
        if not self._gate.try_acquire():
            self._release_bulk(bulk_slot)
            raise Overloaded(
                f"query runner at capacity ({self.max_pending} pending)",
                retry_after_s=self.shed_retry_after_s,
            )
        try:
            claim = self.table.start(query_id, fan_out=1)
        except BaseException:
            # a failed claim (sqlite locked, disk full) must release
            # the reserved slot, or leaks accumulate until every
            # submit sheds 429 against an idle pool
            self._gate.release()
            self._release_bulk(bulk_slot)
            raise
        if claim is None:
            # someone else holds an unexpired claim: coalesce
            self._gate.release()
            self._release_bulk(bulk_slot)
            self._note_coalesced()
            return query_id, JobStatus.RUNNING

        pl = dataclasses.replace(payload, query_id=query_id)
        done = threading.Event()
        with self._lock:
            self._done[query_id] = done
            self._results.pop(query_id, None)
        # the SPAWNING request's deadline rides into the worker thread
        # (thread-locals don't cross): the search abandons at its next
        # check-point once the deadline lapses — worker calls clamp,
        # expired batches refuse to launch. A coalescer with a longer
        # deadline simply sees the abandoned job and falls back to a
        # direct search under its own deadline. The request context
        # (trace id + outcome notes) crosses the same way, so spans
        # recorded on the pool thread — and the trace header on any
        # coordinator->worker hop — keep the ingress trace id.
        job_deadline = current_deadline()
        job_ctx = current_context()
        # the span open here (runner.submit) parents the job's spans on
        # the pool thread
        job_parent = current_span_id()
        t_enqueue = time.monotonic()

        def run():
            t_start = time.monotonic()
            self._note_queue_wait((t_start - t_enqueue) * 1e3)
            with request_context(job_ctx, span_id=job_parent):
                record("runner.queue_wait", t_enqueue, t_start,
                       query_id=query_id)
                self._run(pl, query_id, claim, done, job_ctx,
                          job_deadline, bulk_slot)

        try:
            self._pool.submit(run)
        except RuntimeError:
            # pool shut down (close() raced a late submit): release
            # everything so the job doesn't read RUNNING forever
            self._gate.release()
            self._release_bulk(bulk_slot)
            with self._lock:
                self._done.pop(query_id, None)
            self.table.abandon(query_id, claim)
            raise
        return query_id, JobStatus.RUNNING

    def _run(self, pl, query_id, claim, done, job_ctx, job_deadline,
             bulk_slot) -> None:
        """One job on a pool thread, under its submitter's request
        context: the search, the in-memory handoff, ``done`` (the
        ``runner.done`` instant), then the table's persistence."""
        with span("query_jobs.run", query_id=query_id):
            try:
                with deadline_scope(job_deadline):
                    responses = self.engine.search(pl)
                # a DEGRADED answer (some datasets had no reachable
                # replica — dispatch annotated unavailable_datasets
                # on the request context) must not be cached as THE
                # answer for the query TTL: it is handed to the
                # waiters coalesced onto this job, then the job is
                # dropped so later identical queries re-execute
                # against the (possibly healed) routes instead of
                # replaying a stale empty result
                unavailable = tuple(
                    job_ctx.notes.get("unavailable_datasets") or ()
                    if job_ctx is not None
                    else ()
                )
                partial = bool(unavailable)
                ttl = (
                    self.PARTIAL_HANDOFF_TTL_S
                    if partial
                    else self.table.query_ttl_s
                )
                # the unavailable set rides WITH the cached handoff:
                # a coalesced waiter (different request context)
                # must get the partial marking too, not a silently
                # incomplete answer
                with self._lock:
                    self._results[query_id] = (
                        responses,
                        time.time() + ttl,
                        unavailable,
                    )
                # waiters are served from the in-memory handoff the
                # moment the search finishes; the sqlite persistence
                # below exists for cross-process/restart consumers
                # and must not sit on the request's critical path
                # (a WAL checkpoint fsync here was a >1 s soak-tail
                # outlier with the kernels fully warm)
                instant("runner.done", query_id=query_id)
                done.set()
                if partial:
                    self.table.abandon(query_id, claim)
                else:
                    for resp in responses:
                        n = self.table.next_response_number(
                            query_id, claim
                        )
                        if n:
                            self.table.put_response(
                                query_id, n, resp, claim
                            )
                    self.table.mark_finished(query_id, claim)
                    self.table.complete(query_id, claim)
            except Exception:
                # never cache a failure as an empty result: drop the
                # job so pollers fall back to a direct search (which
                # surfaces the real error to the caller)
                logging.getLogger(__name__).exception(
                    "async query %s failed", query_id
                )
                with self._lock:
                    self._results.pop(query_id, None)
                self.table.abandon(query_id, claim)
            finally:
                if not done.is_set():
                    instant("runner.done", query_id=query_id)
                done.set()
                self._gate.release()
                self._release_bulk(bulk_slot)
                with self._lock:
                    self._done.pop(query_id, None)

    def poll(self, query_id: str) -> JobStatus:
        return self.table.get_job_status(query_id)

    def result(
        self, query_id: str, *, wait_s: float = 0.0
    ) -> list[VariantSearchResponse] | None:
        """Responses if COMPLETED (optionally waiting), else None.
        The wait is clamped by the caller's ambient request deadline,
        and is a ``runner.await`` span noting the query id: its end
        less the job's ``runner.done`` is the wake-up's delay."""
        if wait_s > 0:
            wait_s = current_deadline().clamp(wait_s)
            with span("runner.await", query_id=query_id):
                with self._lock:
                    ev = self._done.get(query_id)
                    handed_off = query_id in self._results
                if ev is not None:
                    # in-process job: block on its completion event
                    # (no poll)
                    ev.wait(wait_s)
                elif not handed_off and not self.table.wait(
                    query_id, timeout_s=wait_s
                ):
                    # no in-memory handoff either; the table never
                    # completed (a PARTIAL job is abandoned there by
                    # design, so the handoff check must come first)
                    return None
        # in-memory handoff FIRST: for in-process jobs the results exist
        # the moment the search finishes, before (and regardless of) the
        # background sqlite persistence
        with self._lock:
            hit = self._results.get(query_id)
        if hit is not None and hit[1] > time.time():
            if len(hit) > 2 and hit[2]:
                # replay the partial marking onto THIS caller's request
                # context — the job thread annotated the submitter's,
                # and a coalesced waiter has its own
                annotate(unavailable_datasets=hit[2])
            return hit[0]
        if self.table.get_job_status(query_id) is not JobStatus.COMPLETED:
            return None
        return self.table.get_responses(query_id)
