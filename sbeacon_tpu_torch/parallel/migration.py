"""Live shard migration: copy -> dual-serve -> canary-verify -> cut-over.

Counterpart of ``sbeacon_tpu/parallel/migration.py``, copied whole. It
moves a dataset between fleet workers with no gap in serving:

1. **copy** — stream the source's base and L1 artifacts and standing
   delta tail to the target over ``/migrate/fetch`` / ``/migrate/
   adopt``. Artifact identity is the epoch-ranged fingerprint the
   replica grouping already reads (``vcf|vc|cc|rows`` base parts,
   ``vcf#d<epoch>|rows`` tail parts), so a crashed copy RESUMES: the
   re-run's manifest diff skips everything the target already adopted.
   The target builds each adopted base on its card (``add_index``) and
   rebuilds its L0 index over an adopted tail (``adopt_delta``); a
   device failure there fails the adoption, and so the migration.
2. **dual-serve** — admit the target to the fleet and publish it into
   the routing table beside the source. The router's tail-superset
   relation (``dispatch.DistributedEngine._group_replicas``) keeps a
   target standing one delta behind a still-ingesting source a valid
   (slightly stale) copy.
3. **canary-verify** — drive known-answer probes (the canary prober's
   bracket grammar, carried in the migration manifest) at source and
   target through ``call_replica`` and require N consecutive clean
   rounds of byte-identical answers; any mismatch aborts and rolls the
   target back out.
4. **cut-over** — retire the source's route ATOMICALLY
   (``ReplicaRouter.retire`` pins the pair out in the same critical
   section that changes the table, and the pin survives rediscovery),
   drain the source's in-flight legs, then tell it to drop the dataset.

Every phase entry is a ``fault_point`` seam (``migration:copy``,
``migration:dual_serve``, ``migration:verify``, ``migration:cutover``).
The invariant the exception paths keep: **at every instant at least one
routable, fresh copy serves the dataset** — a copy-phase failure leaves
the source untouched and the partial target un-admitted; any later
failure rolls the target back out while the source keeps serving.

Stdlib only. This module never imports ``dispatch`` (the edge runs the
other way: ``DistributedEngine`` constructs the controller); transport
rides the engine's pooled keep-alive layer, inside the worker-token
boundary.
"""

from __future__ import annotations

import base64
import dataclasses
import itertools
import logging
import threading
import time

from ..harness.faults import fault_point
from ..payloads import VariantQueryPayload
from ..telemetry import publish_event
from .transport import urllib_post, urllib_post_bytes

log = logging.getLogger(__name__)

#: phases an in-flight migration moves through (terminal states below)
ACTIVE_PHASES = ("pending", "copy", "dual_serve", "verify", "cutover")
TERMINAL_PHASES = ("completed", "rolled_back", "failed")


class MigrationError(RuntimeError):
    """A migration aborted (after cleanup — rollback or abandon)."""


@dataclasses.dataclass
class Migration:
    """One migration's record (mutated under the controller lock)."""

    id: str
    dataset: str
    source: str
    target: str
    phase: str = "pending"
    started_mono: float = 0.0
    phase_mono: float = 0.0
    copy_s: float = 0.0
    bytes_copied: int = 0
    artifacts_copied: int = 0
    artifacts_skipped: int = 0
    verify_rounds: int = 0
    error: str | None = None


class MigrationController:
    """The coordinator side of the migration protocol.

    ``start()`` validates and runs one migration on a background
    thread (the ``POST /fleet/migrate`` entry); ``run()`` is the same
    protocol synchronous (tests, benches — and its ``on_phase`` hook
    is the corruption seam the verify-mismatch tests use).
    ``status()`` / ``stuck()`` feed the fleet digest, ``counters()``
    the ``migration.*`` metric series.
    """

    #: control-message budget (manifest/adopt/drop are small JSON)
    CONTROL_TIMEOUT_S = 10.0
    #: per-artifact fetch/adopt budget (a base shard is a real blob)
    FETCH_TIMEOUT_S = 60.0
    #: manifest re-diff rounds before declaring non-convergence (the
    #: source is still ingesting faster than the copier can mirror)
    MIRROR_ROUNDS = 8
    #: seconds the cut-over waits for the retired source's in-flight
    #: legs to drain before telling it to drop the dataset
    DRAIN_GRACE_S = 5.0
    #: finished migrations retained for /fleet/migrations history
    KEEP = 32

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._migrations: list[Migration] = []
        self._threads: list[threading.Thread] = []
        self._seq = itertools.count(1)
        self._closed = threading.Event()
        self._started = 0
        self._completed = 0
        self._rolled_back = 0
        self._bytes_copied = 0

    # -- knobs (read live: a rebuilt config object is picked up) ------------

    def _obs(self):
        return getattr(self.engine.config, "observability", None)

    def enabled(self) -> bool:
        return bool(getattr(self._obs(), "migration_enabled", True))

    def verify_rounds(self) -> int:
        return max(
            1, int(getattr(self._obs(), "migration_verify_rounds", 3))
        )

    def copy_timeout_s(self) -> float:
        return float(
            getattr(self._obs(), "migration_copy_timeout_s", 120.0)
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self, dataset: str, source: str, target: str) -> Migration:
        """Validate + launch one migration on a daemon thread; returns
        its registered record immediately (phase ``pending``)."""
        m = self._admit(dataset, source, target)
        t = threading.Thread(
            target=self._run_safe,
            args=(m,),
            daemon=True,
            name=f"migration-{m.id}",
        )
        with self._lock:
            self._threads = [
                th for th in self._threads if th.is_alive()
            ] + [t]
        t.start()
        return m

    def run(
        self, dataset: str, source: str, target: str, on_phase=None
    ) -> Migration:
        """The synchronous protocol (tests/benches): raises
        :class:`MigrationError` after cleanup on any failure."""
        m = self._admit(dataset, source, target)
        self._run(m, on_phase)
        return m

    def _admit(self, dataset: str, source: str, target: str) -> Migration:
        if not self.enabled():
            raise MigrationError(
                "migration disabled (BEACON_MIGRATION_ENABLED=0)"
            )
        dataset, source, target = str(dataset), str(source), str(target)
        if not dataset or not source or not target:
            raise MigrationError(
                "migrate needs dataset, source and target"
            )
        if source == target:
            raise MigrationError("source and target are the same worker")
        with self._lock:
            for m in self._migrations:
                if m.dataset == dataset and m.phase in ACTIVE_PHASES:
                    raise MigrationError(
                        f"dataset {dataset!r} already migrating ({m.id})"
                    )
            now = time.monotonic()
            m = Migration(
                id=f"mig-{next(self._seq)}",
                dataset=dataset,
                source=source,
                target=target,
                started_mono=now,
                phase_mono=now,
            )
            self._migrations.append(m)
            # bounded history: prune the OLDEST terminal records
            while len(self._migrations) > self.KEEP:
                for i, old in enumerate(self._migrations):
                    if old.phase in TERMINAL_PHASES:
                        del self._migrations[i]
                        break
                else:
                    break
            self._started += 1
        publish_event(
            "migration.started",
            id=m.id,
            dataset=dataset,
            source=source,
            target=target,
        )
        return m

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)

    def _check_abort(self) -> None:
        if self._closed.is_set():
            raise MigrationError("migration controller closing")

    # -- the protocol --------------------------------------------------------

    def _run_safe(self, m: Migration) -> None:
        try:
            self._run(m, None)
        except MigrationError as e:
            log.warning("migration %s aborted: %s", m.id, e)
        except Exception:
            log.exception("migration %s died unexpectedly", m.id)

    def _run(self, m: Migration, on_phase) -> None:
        # a copy-phase crash ABANDONS (source untouched + still routed,
        # adopted artifacts kept on the target so a re-run resumes);
        # any later crash ROLLS BACK (target routed out + dropped,
        # source keeps serving) — the never-half-routed invariant
        try:
            self._copy(m, on_phase)
        except BaseException as e:
            self._abandon(m, e)
            raise MigrationError(f"{m.id}: copy failed: {e}") from e
        try:
            self._dual_serve(m, on_phase)
            self._verify(m, on_phase)
            self._cutover(m, on_phase)
        except BaseException as e:
            self._rollback(m, e)
            raise MigrationError(f"{m.id}: rolled back: {e}") from e
        self._complete(m)

    def _enter_phase(self, m: Migration, phase: str) -> None:
        with self._lock:
            m.phase = phase
            m.phase_mono = time.monotonic()
        publish_event(
            "migration.phase",
            id=m.id,
            dataset=m.dataset,
            phase=phase,
            source=m.source,
            target=m.target,
        )

    def _tag(self, m: Migration) -> str:
        return f"{m.dataset}:{m.source}->{m.target}"

    def _copy(self, m: Migration, on_phase) -> None:
        self._enter_phase(m, "copy")
        fault_point("migration:copy", self._tag(m))
        if on_phase:
            on_phase("copy", m)
        t0 = time.monotonic()
        self._mirror(
            m,
            deadline=t0 + max(1.0, self.copy_timeout_s()),
            count_skips=True,
        )
        with self._lock:
            m.copy_s = time.monotonic() - t0

    def _dual_serve(self, m: Migration, on_phase) -> None:
        self._enter_phase(m, "dual_serve")
        fault_point("migration:dual_serve", self._tag(m))
        if on_phase:
            on_phase("dual_serve", m)
        # late arrivals between copy end and admission
        self._mirror(m, deadline=time.monotonic() + self.copy_timeout_s())
        if not self.engine.add_worker(m.target):
            # already a fleet member: republish so its new dataset
            # copy enters the table
            self.engine.replica_table(refresh=True)
        urls = self.engine.router.replicas(m.dataset)
        missing = {m.source, m.target} - set(urls)
        if missing:
            raise MigrationError(
                f"dual-serve did not route both copies of {m.dataset} "
                f"(absent: {sorted(missing)}; routed: {sorted(urls)}) — "
                "copies grouped divergent?"
            )

    def _verify(self, m: Migration, on_phase) -> None:
        self._enter_phase(m, "verify")
        fault_point("migration:verify", self._tag(m))
        if on_phase:
            on_phase("verify", m)
        rounds = self.verify_rounds()
        clean = 0
        attempts = 0
        while clean < rounds:
            self._check_abort()
            attempts += 1
            if attempts > rounds + self.MIRROR_ROUNDS:
                raise MigrationError(
                    f"verify never reached {rounds} consecutive clean "
                    "rounds (source manifest kept moving)"
                )
            src_man = self._manifest(m.source, m.dataset)
            tgt_man = self._manifest(m.target, m.dataset)
            if not self._covered(src_man, tgt_man):
                # the still-ingesting source published since the copy:
                # re-mirror; this round does NOT count toward N
                self._mirror(
                    m, deadline=time.monotonic() + self.copy_timeout_s()
                )
                continue
            for pay in self._verify_payloads(
                m.dataset, src_man.get("bracket")
            ):
                ref = self.engine.call_replica(m.source, pay)
                got = self.engine.call_replica(m.target, pay)
                if sorted(r.dumps() for r in ref) != sorted(
                    r.dumps() for r in got
                ):
                    raise MigrationError(
                        f"canary-verify mismatch ({pay.query_id}, "
                        f"{pay.requested_granularity}): target answer "
                        "diverges from source"
                    )
            clean += 1
            with self._lock:
                m.verify_rounds = clean

    def _cutover(self, m: Migration, on_phase) -> None:
        self._enter_phase(m, "cutover")
        # the seam fires BEFORE the retire: a crash here rolls back
        # with the source never having left the table
        fault_point("migration:cutover", self._tag(m))
        if on_phase:
            on_phase("cutover", m)
        src_man = self._manifest(m.source, m.dataset)
        tgt_man = self._manifest(m.target, m.dataset)
        if not self._covered(src_man, tgt_man):
            raise MigrationError(
                "cut-over refused: target no longer covers the source "
                "manifest (late publish after verify)"
            )
        router = self.engine.router
        # atomic retire: pin + table removal in ONE router critical
        # section, and the pin survives any concurrent rediscovery
        # republish. Everything after this point is non-raising: the
        # source must never stay retired because of a later exception
        # while the pin's cleanup was skipped.
        router.retire(m.dataset, m.source)
        t0 = time.monotonic()
        while (
            self.engine.inflight(m.source) > 0
            and time.monotonic() - t0 < self.DRAIN_GRACE_S
        ):
            time.sleep(0.01)
        dropped = False
        try:
            status, doc = self._post_json(
                m.source, "drop", {"dataset": m.dataset}
            )
            dropped = status == 200 and bool(doc.get("ok"))
            if not dropped:
                log.warning(
                    "migration %s: source %s refused drop (http %s: "
                    "%s) — keeping its route for %s retired",
                    m.id,
                    m.source,
                    status,
                    doc.get("error"),
                    m.dataset,
                )
        except Exception as e:
            log.warning(
                "migration %s: source %s drop failed (%s) — keeping "
                "its route for %s retired",
                m.id,
                m.source,
                e,
                m.dataset,
            )
        if dropped:
            # the source no longer advertises the dataset: the pin has
            # nothing left to filter and a future re-ingest on that
            # worker must be routable again
            router.unretire(m.dataset, m.source)
        try:
            self.engine.replica_table(refresh=True)
        except Exception:
            log.exception("post-cutover route refresh failed")

    def _complete(self, m: Migration) -> None:
        with self._lock:
            m.phase = "completed"
            m.phase_mono = time.monotonic()
            self._completed += 1
        publish_event(
            "migration.completed",
            id=m.id,
            dataset=m.dataset,
            source=m.source,
            target=m.target,
            bytes=m.bytes_copied,
            verifyRounds=m.verify_rounds,
        )

    def _abandon(self, m: Migration, err: BaseException) -> None:
        """Copy-phase failure: the source was never touched and the
        target never admitted — keep the adopted artifacts so a re-run
        resumes (its manifest diff skips them)."""
        with self._lock:
            m.phase = "failed"
            m.phase_mono = time.monotonic()
            m.error = str(err)[:500]
        publish_event(
            "migration.failed",
            id=m.id,
            dataset=m.dataset,
            source=m.source,
            target=m.target,
            error=str(err)[:200],
        )

    def _rollback(self, m: Migration, err: BaseException) -> None:
        """Route the target back out (atomically, pin-protected
        against rediscovery) and best-effort drop its copy; the source
        never stopped serving. A dead target (chaos kill) keeps its
        pin — it cannot re-enter this dataset's routes until an
        operator (or a fresh migration) lifts it."""
        router = self.engine.router
        router.retire(m.dataset, m.target)
        dropped = False
        try:
            status, doc = self._post_json(
                m.target, "drop", {"dataset": m.dataset}
            )
            dropped = status == 200 and bool(doc.get("ok"))
        except Exception:
            pass
        if dropped:
            router.unretire(m.dataset, m.target)
        try:
            self.engine.replica_table(refresh=True)
        except Exception:
            pass
        with self._lock:
            m.phase = "rolled_back"
            m.phase_mono = time.monotonic()
            m.error = str(err)[:500]
            self._rolled_back += 1
        publish_event(
            "migration.rolled_back",
            id=m.id,
            dataset=m.dataset,
            source=m.source,
            target=m.target,
            error=str(err)[:200],
        )

    # -- copy machinery ------------------------------------------------------

    @staticmethod
    def _art_key(art: dict) -> tuple:
        return (
            art.get("kind"),
            art.get("vcf"),
            art.get("epoch"),
            art.get("fingerprint"),
        )

    @classmethod
    def _covered(cls, src_man: dict, tgt_man: dict) -> bool:
        """Target covers source: every source artifact (by epoch-ranged
        fingerprint) stands on the target. The target may stand EXTRA
        stale deltas the source has since folded — adopting the folded
        base retires them, and until then the tail-superset relation
        keeps the copies routable together."""
        src = {cls._art_key(a) for a in src_man.get("artifacts", [])}
        tgt = {cls._art_key(a) for a in tgt_man.get("artifacts", [])}
        return src <= tgt

    def _mirror(
        self, m: Migration, deadline: float, count_skips: bool = False
    ) -> dict:
        """Diff manifests and stream every artifact the target lacks
        (bases before deltas — the manifest's order — so epoch
        monotonicity holds on adoption), re-diffing until covered.
        Returns the last source manifest."""
        for _ in range(self.MIRROR_ROUNDS):
            self._check_abort()
            src_man = self._manifest(m.source, m.dataset)
            if not src_man.get("artifacts"):
                raise MigrationError(
                    f"source {m.source} serves no artifacts for "
                    f"{m.dataset!r}"
                )
            tgt_man = self._manifest(m.target, m.dataset)
            tgt_keys = {
                self._art_key(a) for a in tgt_man.get("artifacts", [])
            }
            missing = [
                a
                for a in src_man["artifacts"]
                if self._art_key(a) not in tgt_keys
            ]
            if count_skips:
                with self._lock:
                    m.artifacts_skipped += len(
                        src_man["artifacts"]
                    ) - len(missing)
                count_skips = False
            if not missing:
                return src_man
            for art in missing:
                self._check_abort()
                if time.monotonic() > deadline:
                    raise MigrationError(
                        f"copy budget "
                        f"({self.copy_timeout_s():g}s) exhausted with "
                        f"{len(missing)} artifact(s) outstanding"
                    )
                blob = self._fetch(m.source, m.dataset, art)
                if blob is None:
                    # a racing fold retired the artifact between the
                    # diff and the fetch: re-diff and move on
                    break
                self._adopt(m, art, blob)
        raise MigrationError(
            f"source and target manifests for {m.dataset!r} failed to "
            f"converge in {self.MIRROR_ROUNDS} mirror rounds"
        )

    def _manifest(self, url: str, dataset: str) -> dict:
        status, doc = self._post_json(
            url, "manifest", {"dataset": dataset}
        )
        return self._checked(url, "manifest", status, doc)

    def _fetch(self, url: str, dataset: str, art: dict):
        body: dict = {"dataset": dataset, "vcf": art.get("vcf")}
        if art.get("kind") == "delta":
            body["epoch"] = art.get("epoch")
        t = getattr(self.engine, "transport", None)
        post_b = t.post_bytes if t is not None else urllib_post_bytes
        status, blob = post_b(
            f"{url}/migrate/fetch",
            body,
            self.FETCH_TIMEOUT_S,
            self._headers() or None,
        )
        if status == 404:
            return None
        if status != 200:
            raise MigrationError(
                f"fetch {self._art_key(art)} from {url}: http {status}"
            )
        return blob

    def _adopt(self, m: Migration, art: dict, blob: bytes) -> None:
        doc: dict = {
            "dataset": m.dataset,
            "kind": art.get("kind"),
            "blob": base64.b64encode(blob).decode("ascii"),
        }
        if art.get("kind") == "delta":
            doc["epoch"] = art.get("epoch")
        status, out = self._post_json(
            m.target, "adopt", doc, timeout_s=self.FETCH_TIMEOUT_S
        )
        self._checked(m.target, "adopt", status, out)
        if not out.get("ok"):
            raise MigrationError(
                f"adopt {self._art_key(art)} on {m.target}: "
                f"{out.get('error')}"
            )
        with self._lock:
            m.bytes_copied += len(blob)
            m.artifacts_copied += 1
            self._bytes_copied += len(blob)

    @staticmethod
    def _checked(url: str, op: str, status: int, doc) -> dict:
        if status == 404:
            raise MigrationError(
                f"worker {url} does not support migration "
                f"(/migrate/{op} answered 404 — engine without the "
                "migration seams?)"
            )
        if status in (401, 403):
            raise MigrationError(
                f"worker {url} rejected migration credentials "
                f"(http {status}): check BEACON_WORKER_TOKEN"
            )
        if status != 200 or not isinstance(doc, dict):
            err = doc.get("error") if isinstance(doc, dict) else doc
            raise MigrationError(
                f"/migrate/{op} on {url}: http {status}: {err}"
            )
        return doc

    # -- verify probes -------------------------------------------------------

    def _verify_payloads(
        self, dataset: str, bracket: dict | None
    ) -> list[VariantQueryPayload]:
        """Known-answer probes x query shapes, from the bracket the
        source's manifest carried (canary.py grammar): the known-hit
        row, a known-miss window past the coordinate ceiling, and a
        full-range row-count sweep — each in boolean and count shape.
        No bracket (artifact-less corner) -> manifest parity was the
        whole check and the round is clean by construction."""
        if not bracket:
            return []
        chrom = str(bracket.get("chrom"))
        max_end = int(bracket.get("maxEnd") or 0)
        shapes = ("boolean", "count")
        specs: list[tuple[str, dict]] = []
        if "pos" in bracket:
            pos = int(bracket["pos"])
            specs.append(
                (
                    "hit",
                    dict(
                        start_min=pos,
                        start_max=pos,
                        end_min=1,
                        end_max=max_end + 1_000_000,
                        alternate_bases=str(bracket.get("alt") or "N"),
                    ),
                )
            )
        specs.append(
            (
                "range",
                dict(
                    start_min=1,
                    start_max=max_end + 1_000_000,
                    end_min=1,
                    end_max=max_end + 2_000_000,
                    alternate_bases="N",
                ),
            )
        )
        specs.append(
            (
                "miss",
                dict(
                    start_min=max_end + 1_000,
                    start_max=max_end + 2_000,
                    end_min=1,
                    end_max=max_end + 2_000,
                    alternate_bases="N",
                ),
            )
        )
        return [
            VariantQueryPayload(
                dataset_ids=[dataset],
                reference_name=chrom,
                requested_granularity=shape,
                # the probe must read the LIVE plane on both replicas
                no_response_cache=True,
                query_id=f"migrate-{name}-{dataset}",
                **spec,
            )
            for name, spec in specs
            for shape in shapes
        ]

    # -- transport -----------------------------------------------------------

    def _headers(self) -> dict:
        tok = getattr(self.engine, "_token", "") or ""
        return {"Authorization": f"Bearer {tok}"} if tok else {}

    def _post_json(
        self, url: str, op: str, doc: dict, timeout_s: float | None = None
    ):
        t = getattr(self.engine, "transport", None)
        post = t.post_json if t is not None else urllib_post
        return post(
            f"{url}/migrate/{op}",
            doc,
            timeout_s or self.CONTROL_TIMEOUT_S,
            self._headers() or None,
        )

    # -- surfaces ------------------------------------------------------------

    def status(self) -> list[dict]:
        """Every retained migration, oldest first — the fleet digest's
        ``migrations`` section and ``GET /fleet/migrations``."""
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "id": m.id,
                    "dataset": m.dataset,
                    "source": m.source,
                    "target": m.target,
                    "phase": m.phase,
                    "phaseAgeS": round(now - m.phase_mono, 1),
                    "ageS": round(now - m.started_mono, 1),
                    "bytesCopied": m.bytes_copied,
                    "artifactsCopied": m.artifacts_copied,
                    "artifactsSkipped": m.artifacts_skipped,
                    "verifyRounds": m.verify_rounds,
                    "error": m.error,
                }
                for m in self._migrations
            ]

    def stuck(self) -> dict | None:
        """The first in-flight migration whose current phase outlived
        its bound — the copy budget for the copy phase, 2x the
        measured copy time (floor 1 s) for every later phase — or
        None. The fleet diagnosis names it, mirroring the
        stalest-replica pattern."""
        now = time.monotonic()
        with self._lock:
            for m in self._migrations:
                if m.phase not in ACTIVE_PHASES or m.phase == "pending":
                    continue
                bound = (
                    max(1.0, self.copy_timeout_s())
                    if m.phase == "copy"
                    else 2.0 * max(m.copy_s, 1.0)
                )
                age = now - m.phase_mono
                if age > bound:
                    return {
                        "id": m.id,
                        "dataset": m.dataset,
                        "source": m.source,
                        "target": m.target,
                        "phase": m.phase,
                        "phaseAgeS": round(age, 1),
                        "boundS": round(bound, 1),
                    }
        return None

    def counters(self) -> dict:
        """The ``migration.*`` metric values (dispatch_stats merges
        these; register_dispatch_metrics reads them through it)."""
        with self._lock:
            return {
                "started": self._started,
                "completed": self._completed,
                "rolled_back": self._rolled_back,
                "bytes_copied": self._bytes_copied,
            }
