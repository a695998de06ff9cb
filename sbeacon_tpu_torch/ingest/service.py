"""Ingestion service: VCF validation + summarisation into index shards.

Counterpart of ``sbeacon_tpu/ingest/service.py``, copied whole but for
the compactor's base fold, which takes the key's publish lock and its
snapshot again inside it (``_fold_base``). The engine side of a fold (``add_index`` with ``meta['delta_epoch']``,
``replace_delta_range``, ``delta_snapshot``, ``rebuild_stacks``) is the
port engine's.

Replaces the reference's submit-side VCF machinery — the ``tabix``
reachability probe (reference: lambda/submitDataset/lambda_function.py:
48-76 check_vcf_locations, shared_resources/utils/chrom_matching.py:43-61
get_vcf_chromosomes) and the SNS summarisation pipeline entry
(summariseDataset -> summariseVcf -> summariseSlice) — with direct calls
into the genomics layer. The scheduled path currently summarises
synchronously; the resumable job-ledger pipeline builds on this surface.

The service also owns the :class:`DeltaCompactor` — the background
half of ingest-while-serving. The pipeline publishes slices as
immediately-queryable delta shards; the compactor folds a key's tail
into its base shard OFF the request path (interval cadence + a
depth trigger), which is the only place the base fingerprint bumps,
the fused/mesh stacks rebuild, and the dataset's cache keys rotate —
once per fold instead of once per submit. The reference's equivalent
is the SNS-driven async summarisation chain with its minutes-long
freshness lag; here freshness is one delta publish (sub-second) and
the heavy work is amortised.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path

from ..config import BeaconConfig
from ..genomics.tabix import ensure_index, list_chromosomes
from ..harness.faults import fault_point
from ..index.columnar import load_index, merge_shards, save_index
from ..telemetry import publish_event
from ..utils.chrom import get_matching_chromosome  # noqa: F401 (API parity)
from .ledger import JobLedger
from .pipeline import SummarisationPipeline

log = logging.getLogger(__name__)


class VcfLocationError(ValueError):
    """A submitted VCF is missing or unindexed (400 at the API boundary)."""


def _shard_bytes(shard) -> int:
    """In-memory bytes of a shard's columns, blobs and planes — the
    compaction tier policy's size measure (file sizes would fold
    compression ratios into the byte-ratio trigger and the
    write-amplification record)."""
    if shard is None:
        return 0
    total = sum(int(c.nbytes) for c in shard.cols.values())
    for name in (
        "chrom_offsets",
        "ref_blob",
        "ref_off",
        "alt_blob",
        "alt_off",
        "vt_codes",
        "gt_bits",
        "gt_bits2",
        "tok_bits1",
        "tok_bits2",
        "gt_overflow",
        "tok_overflow",
    ):
        arr = getattr(shard, name, None)
        if arr is not None:
            total += int(arr.nbytes)
    return total


class DeltaCompactor:
    """Folds standing delta tails, off the request path — size-tiered
    (the classic LSM shape).

    With ``compact_base_ratio > 0`` a fold is tiered: raw delta shards
    first merge into an intermediate **L1 artifact** (persisted under
    the key's ``.l1/`` dir, epoch-ranged, adoptable after a crash) and
    swap into the delta registry atomically
    (``engine.replace_delta_range`` — the tail gets shallower, the
    base is untouched, write amplification ~1). Only once the
    accumulated L1 bytes reach ``compact_base_ratio`` of the base's
    bytes does a **full base merge** run: merge base + tail (or adopt
    the summarisation's already-merged on-disk artifact when it covers
    the tail), persist atomically, publish through
    ``engine.add_index`` — which swaps base-in/deltas-out in ONE
    critical section, so queries never see rows doubled or missing —
    then park the superseded base/L1 artifacts in ``.retired/`` and GC
    all but the newest ``artifact_retain`` generations (GC only ever
    touches ``.retired/``, never a serving path). With the ratio <= 0
    (default) every fold is a full base merge, the pre-tiering policy.

    A crash anywhere before a publish seam leaves base + L0 + deltas
    serving exactly as before and the next run adopts the persisted
    artifact or re-folds (the ``compaction.fold`` fault site's
    ``:merge``/``:publish`` and ``:l1:merge``/``:l1:publish`` details
    inject exactly that). After a base publish the fused/mesh stacks
    rebuild inline here, so the first post-fold query finds them warm.
    """

    def __init__(self, engine, pipeline, ledger, config: BeaconConfig):
        self.engine = engine
        self.pipeline = pipeline
        self.ledger = ledger
        self.config = config
        #: cost-accounting hook (accounting.CostAccounting, wired by
        #: the app): compaction runs on a background thread with no
        #: request context, so its cost is booked explicitly under the
        #: ``system`` tenant — the amortised price of ingest-while-
        #: serving shows up in /ops/costs next to the tenants it serves
        self.accounting = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._fold_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._runs = 0
        self._folded_rows = 0
        self._folded_shards = 0
        self._failures = 0
        # size-tiered fold accounting: folds by tier, cumulative fold
        # output bytes over folded tail bytes (the write-amplification
        # ratio tiering exists to bound), and retention-GC reclaim
        self._tier_folds: dict[str, int] = {}
        self._out_bytes = 0
        self._tail_bytes = 0
        self._gc_bytes = 0
        # depth-trigger scope: keys whose publish tripped the
        # threshold — the woken thread folds exactly these, not every
        # standing tail (the interval pass still sweeps everything)
        self._pending_keys: set[tuple[str, str]] = set()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Arm the background thread (interval cadence + wake events);
        idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="delta-compactor", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def notify(self, dataset_id: str, vcf: str, depth: int) -> None:
        """A delta published (pipeline hook): a tail at or past
        ``delta_max_shards`` kicks an early fold of THE KEY THAT
        TRIPPED IT — not a sweep of every standing tail (the old
        ``run_once()`` here folded unrelated keys' tails on another
        key's trigger, and did so inline on the publishing thread when
        the background thread was disabled). With the thread disabled
        (``compact_interval_s <= 0``) the scoped fold runs inline on
        the publishing thread — the tail depth stays bounded either
        way."""
        if depth < max(1, self.config.ingest.delta_max_shards):
            return
        key = (dataset_id, str(vcf))
        if self._thread is not None and self._thread.is_alive():
            with self._state_lock:
                self._pending_keys.add(key)
            self._wake.set()
            return
        try:
            self.run_once(key=key)
        except Exception:
            log.exception("inline depth-triggered compaction failed")

    def _loop(self) -> None:
        interval = self.config.ingest.compact_interval_s
        last_sweep = time.monotonic()
        while not self._stop.is_set():
            self._wake.wait(timeout=interval if interval > 0 else None)
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._state_lock:
                pending, self._pending_keys = self._pending_keys, set()
            try:
                if pending:
                    # depth-triggered wake: fold only the keys whose
                    # publishes tripped the threshold
                    for key in sorted(pending):
                        self.run_once(key=key)
                # the interval sweep is measured against ITS OWN
                # clock, not the wait timeout (which restarts on
                # every depth wake): a hot key tripping the trigger
                # faster than the interval must not starve the quiet
                # keys' sweep forever
                if not pending or (
                    interval > 0
                    and time.monotonic() - last_sweep >= interval
                ):
                    self.run_once()  # full sweep: every tail
                    last_sweep = time.monotonic()
            except Exception:
                log.exception("background compaction pass failed")

    # -- folding -------------------------------------------------------------

    def run_once(self, key: tuple | None = None) -> dict:
        """Fold every key with a standing delta tail (or ONE key when
        ``key`` is given — the depth-trigger scope); returns
        ``{key: folded_rows}`` for the keys folded. Failures are
        per-key isolated — one crashed fold (fault injection, disk
        error) leaves that key's base + deltas serving and the other
        keys still fold."""
        out: dict = {}
        with self._fold_lock:
            for k, base, tail in self.engine.delta_snapshot(key):
                try:
                    out[k] = self._fold(k, base, tail)
                except Exception:
                    with self._state_lock:
                        self._failures += 1
                    log.exception(
                        "compaction failed for %s; base + deltas keep "
                        "serving, next run retries", k
                    )
        return out

    def _fold(self, key, base_shard, tail) -> int:
        """One key's fold pass under the tier policy; returns the tail
        rows folded (L1 + base tiers combined)."""
        ratio = float(
            getattr(self.config.ingest, "compact_base_ratio", 0.0)
        )
        if ratio <= 0 or base_shard is None:
            # legacy policy — and the base-establishing first fold of
            # a deferred-base key: a full base merge per fold
            return self._fold_base(key, base_shard, tail)
        folded = 0
        # consolidate the WHOLE standing tail (raws AND earlier L1s)
        # into one L1 artifact: every sweep leaves at most ONE standing
        # entry per key, so tail depth stays bounded under tiering
        # exactly as the legacy sweep bounded it — only the base merge
        # is deferred to the byte-ratio trigger. A lone standing entry
        # is left alone (re-merging one artifact is pure churn); that
        # single entry is the designed steady state of a quiescent key
        # until the ratio trigger or new deltas arrive.
        if len(tail) >= 2:
            folded += self._fold_l1(key, list(tail))
            snap = self.engine.delta_snapshot(key)
            if not snap:
                return folded  # a racing base publish emptied the tail
            _k, base_shard, tail = snap[0]
            if base_shard is None:
                return folded
        # the byte-ratio trigger: the multi-GB base only re-merges
        # once enough TAIL bytes accumulated to amortise rewriting
        # it. The sum covers every standing entry — L1 artifacts AND
        # raw singletons alike — so a lone large raw delta triggers
        # exactly as a lone L1 of the same size would (only a tail
        # genuinely small relative to the base stands deferred)
        tail_bytes = sum(_shard_bytes(s) for _e, s in tail)
        if tail_bytes >= ratio * max(1, _shard_bytes(base_shard)):
            folded += self._fold_base(key, base_shard, tail)
        return folded

    def _l1_path(self, ds: str, vcf: str, lo: int, hi: int) -> Path:
        return self.pipeline.l1_dir(ds, vcf) / f"e{lo}-{hi}.npz"

    def _fold_l1(self, key, raws) -> int:
        """Merge the standing tail entries (raw deltas and/or earlier
        L1 artifacts) into ONE epoch-ranged L1 artifact (persisted
        first, swapped into the delta registry second — the
        ``:l1:merge``/``:l1:publish`` durability seam) and return the
        rows absorbed. The base shard is never read or written: this
        fold's write amplification is ~1 against the tail regardless
        of base size."""
        ds, vcf = key
        epochs = [e for e, _s in raws]
        lo, hi = min(epochs), max(epochs)
        rows = sum(s.n_rows for _e, s in raws)
        in_bytes = sum(_shard_bytes(s) for _e, s in raws)
        inputs = [[int(e), int(s.n_rows)] for e, s in raws]
        publish_event(
            "compaction.start",
            dataset=ds,
            vcf=vcf,
            tier="l1",
            shards=len(raws),
            rows=rows,
        )
        fault_point("compaction.fold", f"{ds}:{vcf}:l1:merge")
        path = self._l1_path(ds, vcf, lo, hi)
        merged = None
        if path.exists():
            # a previous run persisted this exact range and crashed
            # before the swap: adopt the artifact instead of
            # re-merging. The inputs fingerprint (epoch, rows pairs)
            # must match exactly — epochs restart after a process
            # restart, so a number-coincident stale artifact from an
            # earlier tail must NOT be adopted.
            try:
                cand = load_index(path)
                if (
                    cand.meta.get("l1_epochs") == [lo, hi]
                    and cand.meta.get("l1_inputs") == inputs
                ):
                    merged = cand
            except Exception:
                log.warning(
                    "unreadable L1 artifact %s; re-merging", path,
                    exc_info=True,
                )
        if merged is None:
            merged = merge_shards([s for _e, s in raws])
            merged.meta["dataset_id"] = ds
            merged.meta["vcf_location"] = vcf
            merged.meta["delta_epoch"] = hi
            merged.meta["l1_epochs"] = [lo, hi]
            merged.meta["l1_inputs"] = inputs
            path.parent.mkdir(parents=True, exist_ok=True)
            save_index(merged, path)
        fault_point("compaction.fold", f"{ds}:{vcf}:l1:publish")
        if not self.engine.replace_delta_range(key, epochs, merged):
            # the tail changed under us (racing fold/base publish):
            # nothing served changed; the artifact stays for adoption
            log.info(
                "L1 swap for %s lost a race; artifact kept at %s",
                key,
                path,
            )
            return 0
        out_bytes = _shard_bytes(merged)
        self._record_fold(
            key,
            tier="l1",
            folded_through=hi,
            folded_shards=len(raws),
            folded_rows=rows,
            in_bytes=in_bytes,
            out_bytes=out_bytes,
            tail_bytes=in_bytes,
        )
        publish_event(
            "compaction.complete",
            dataset=ds,
            vcf=vcf,
            tier="l1",
            shards=len(raws),
            rows=rows,
            foldedThrough=hi,
        )
        return rows

    def _fold_base(self, key, base_shard, tail) -> int:
        """The base tier, under the key's publish lock
        (``SummarisationPipeline.publish_lock``), on a snapshot taken
        again inside it: a summarisation's final publish that landed
        since the caller's snapshot is folded over, never undone."""
        with self.pipeline.publish_lock(*key):
            snap = self.engine.delta_snapshot(key)
            if not snap:
                return 0  # a base publish retired the whole tail
            _k, base_shard, tail = snap[0]
            return self._fold_base_locked(key, base_shard, tail)

    def _fold_base_locked(self, key, base_shard, tail) -> int:
        ds, vcf = key
        epochs = [e for e, _s in tail]
        folded_through = max(epochs)
        folded_rows = sum(s.n_rows for _e, s in tail)
        tail_bytes = sum(_shard_bytes(s) for _e, s in tail)
        publish_event(
            "compaction.start",
            dataset=ds,
            vcf=vcf,
            tier="base",
            shards=len(tail),
            rows=folded_rows,
        )
        # ONE generation stamp for everything this merge supersedes
        # (the old base AND its consumed L1s): retention then counts
        # GENERATIONS, not files — a merge that parks three files is
        # one rollback unit, and the base copy can never be the first
        # file GC'd out of its own generation
        gen_stamp = time.time_ns()
        fault_point("compaction.fold", f"{ds}:{vcf}:merge")
        final = self.pipeline.shard_path(ds, vcf)
        merged = None
        if final.exists():
            # the streamed summarisation already merged + persisted the
            # full artifact (base publish deferred to us): adopt it when
            # it provably covers the tail instead of re-merging
            try:
                cand = load_index(final)
                if (cand.meta.get("delta_epoch") or -1) >= folded_through:
                    merged = cand
            except Exception:
                log.warning(
                    "unreadable base artifact %s; re-merging", final,
                    exc_info=True,
                )
        if merged is None:
            # the superseded base artifact is retained as a hardlink
            # BEFORE the atomic overwrite (same inode, no copy; a
            # crash between link and save leaves the base intact) —
            # retention GC later reclaims old generations from
            # .retired/ only
            if final.exists():
                self._park_retired(
                    ds, vcf, final, kind="base", stamp=gen_stamp
                )
            parts = ([base_shard] if base_shard is not None else []) + [
                s for _e, s in tail
            ]
            merged = merge_shards(parts) if len(parts) > 1 else parts[0]
            merged.meta["dataset_id"] = ds
            merged.meta["vcf_location"] = vcf
            merged.meta["delta_epoch"] = folded_through
            merged.meta.pop("l1_epochs", None)
            merged.meta.pop("l1_inputs", None)
            save_index(merged, final)
        # the seam: everything above is reversible (pure merge + atomic
        # tmp-rename save); the publish below swaps base-in/deltas-out
        # in one engine critical section
        fault_point("compaction.fold", f"{ds}:{vcf}:publish")
        self.engine.add_index(merged)
        self.pipeline.clear_deferred(ds, vcf)
        # first post-fold query must find the dispatch stacks warm —
        # rebuilding here IS the "off the request path" contract
        rebuild = getattr(self.engine, "rebuild_stacks", None)
        if rebuild is not None:
            rebuild()
        try:
            self._gc_artifacts(ds, vcf, folded_through, gen_stamp)
        except Exception:  # GC must never fail a fold
            log.exception("artifact GC failed for %s", key)
        self._record_fold(
            key,
            tier="base",
            folded_through=folded_through,
            folded_shards=len(tail),
            folded_rows=folded_rows,
            in_bytes=_shard_bytes(base_shard) + tail_bytes,
            out_bytes=_shard_bytes(merged),
            tail_bytes=tail_bytes,
        )
        with self._state_lock:
            self._folded_rows += folded_rows
            self._folded_shards += len(tail)
        publish_event(
            "compaction.complete",
            dataset=ds,
            vcf=vcf,
            tier="base",
            shards=len(tail),
            rows=folded_rows,
            foldedThrough=folded_through,
        )
        return folded_rows

    def _record_fold(
        self,
        key,
        *,
        tier: str,
        folded_through: int,
        folded_shards: int,
        folded_rows: int,
        in_bytes: int,
        out_bytes: int,
        tail_bytes: int,
    ) -> None:
        """Ledger + counters + system-tenant accounting for one
        completed fold action (either tier)."""
        ds, vcf = key
        try:
            self.ledger.record_compaction(
                ds,
                vcf,
                folded_through=folded_through,
                folded_shards=folded_shards,
                folded_rows=folded_rows,
                tier=tier,
                in_bytes=in_bytes,
                out_bytes=out_bytes,
                write_amp=round(out_bytes / max(1, tail_bytes), 3),
            )
        except Exception:
            log.warning("compaction ledger record failed", exc_info=True)
        with self._state_lock:
            self._runs += 1
            self._tier_folds[tier] = self._tier_folds.get(tier, 0) + 1
            self._out_bytes += out_bytes
            self._tail_bytes += tail_bytes
        acct = self.accounting
        if acct is not None:
            try:
                # one fold's work, booked to the system tenant: the
                # merged rows were each read+written once (host_rows),
                # and the delta shards folded are the tail retired
                acct.record_system(
                    "compaction",
                    host_rows=folded_rows,
                    delta_shards=folded_shards,
                )
            except Exception:  # accounting must never fail a fold
                log.exception("compaction cost accounting failed")

    # -- artifact retention / GC ---------------------------------------------

    def _park_retired(
        self, ds: str, vcf: str, path: Path, *, kind: str, stamp: int
    ) -> None:
        """Park one superseded artifact in ``.retired/`` under its
        merge's generation ``stamp`` — hardlink when possible
        (zero-copy, crash-safe: the serving inode is untouched),
        rename only for already-dead files (consumed L1s).
        Best-effort: retention never blocks a fold."""
        retired = self.pipeline.retired_dir(ds, vcf)
        try:
            retired.mkdir(parents=True, exist_ok=True)
            target = retired / f"{stamp}-{kind}-{path.name}"
            # the .meta.json sidecar travels WITH its npz — a parked
            # generation must stay load_index-able, and a renamed L1
            # must not strand its sidecar in the .l1/ dir forever
            meta = Path(str(path) + ".meta.json")
            meta_target = Path(str(target) + ".meta.json")
            if kind == "base":
                os.link(path, target)
                if meta.exists():
                    os.link(meta, meta_target)
            else:
                path.rename(target)
                if meta.exists():
                    meta.rename(meta_target)
        except OSError:
            log.warning(
                "could not retire artifact %s", path, exc_info=True
            )

    def _gc_artifacts(
        self, ds: str, vcf: str, folded_through: int, stamp: int
    ) -> None:
        """After a base merge: park the consumed L1 artifacts (their
        epochs are now folded into the base) under the same
        generation ``stamp`` as the superseded base, and delete all
        but the newest ``artifact_retain`` retired GENERATIONS — the
        unit is one merge's stamp group (base + its L1s together, so
        a rollback generation is always complete), never a file
        count. Only ``.retired/`` is ever deleted from — the serving
        base at ``shard_path`` and any still-standing L1 range are
        structurally out of reach."""
        l1_dir = self.pipeline.l1_dir(ds, vcf)
        if l1_dir.exists():
            for p in sorted(l1_dir.glob("e*-*.npz")):
                try:
                    hi = int(p.stem.split("-")[-1])
                except ValueError:
                    continue
                if hi <= folded_through:
                    self._park_retired(
                        ds, vcf, p, kind="l1", stamp=stamp
                    )
        retired = self.pipeline.retired_dir(ds, vcf)
        if not retired.exists():
            return
        retain = max(
            0, int(getattr(self.config.ingest, "artifact_retain", 2))
        )
        by_gen: dict[str, list[Path]] = {}
        for p in retired.glob("*.npz"):
            by_gen.setdefault(p.name.split("-", 1)[0], []).append(p)
        keep = set(sorted(by_gen, reverse=True)[:retain])
        freed = 0
        for gen, files in by_gen.items():
            if gen in keep:
                continue
            for p in files:
                for victim in (p, Path(str(p) + ".meta.json")):
                    try:
                        n = victim.stat().st_size
                        victim.unlink()
                        freed += n
                    except OSError:
                        continue
        if freed:
            with self._state_lock:
                self._gc_bytes += freed
            publish_event(
                "compaction.gc", dataset=ds, vcf=vcf, bytes=freed
            )

    # -- observability -------------------------------------------------------

    def metrics(self) -> dict:
        with self._state_lock:
            return {
                "runs": self._runs,
                "folded_rows": self._folded_rows,
                "folded_shards": self._folded_shards,
                "failures": self._failures,
                "tier_folds": dict(self._tier_folds),
                "write_amplification": (
                    round(self._out_bytes / self._tail_bytes, 3)
                    if self._tail_bytes
                    else 0.0
                ),
                "gc_bytes": self._gc_bytes,
            }

    def stats(self) -> dict:
        """The ``/debug/status`` rollup: counters + live per-dataset
        delta-tail depth."""
        out = self.metrics()
        out["running"] = (
            self._thread is not None and self._thread.is_alive()
        )
        out["deltaTails"] = self.engine.delta_stats()
        l0 = getattr(self.engine, "l0_status", None)
        if l0 is not None:
            out["l0"] = l0()
        return out


def register_compaction_metrics(registry, supplier) -> None:
    """``compaction.*`` series; ``supplier`` returns
    :meth:`DeltaCompactor.metrics` or ``{}`` (no compactor wired) so
    the catalogue stays deployment-stable."""

    def field(name):
        def collect():
            stats = supplier() or {}
            return stats.get(name, 0)

        return collect

    registry.counter(
        "compaction.runs",
        "completed delta-tail folds",
        fn=field("runs"),
    )
    registry.counter(
        "compaction.folded_rows",
        "delta rows folded into base shards",
        fn=field("folded_rows"),
    )
    registry.counter(
        "compaction.tier_folds",
        "completed folds by tier (l1 = raw tail -> intermediate "
        "artifact, base = full base merge)",
        label="tier",
        fn=lambda: (supplier() or {}).get("tier_folds") or {},
    )
    registry.gauge(
        "compaction.write_amplification",
        "cumulative fold output bytes per delta-tail byte folded "
        "(what size-tiering bounds: a full base merge per fold makes "
        "this scale with base size)",
        fn=field("write_amplification"),
    )
    registry.counter(
        "ingest.gc_bytes",
        "superseded base/L1 artifact bytes reclaimed by retention GC",
        fn=field("gc_bytes"),
    )


class IngestService:
    def __init__(
        self,
        config: BeaconConfig | None = None,
        *,
        engine=None,
        store=None,
    ):
        # an explicit config means a real storage root: persist the ledger
        # there; the configless form stays fully in-memory (tests, ad hoc)
        persistent = config is not None
        self.config = config or BeaconConfig()
        self.engine = engine
        self.store = store
        self.ledger = JobLedger(
            self.config.storage.ledger_db if persistent else ":memory:"
        )
        self.pipeline = SummarisationPipeline(
            self.config, ledger=self.ledger, engine=engine, store=store
        )
        # ingest-while-serving: the compactor folds delta tails off the
        # request path; armed only for engines that host a delta
        # registry (a DistributedEngine coordinator passes its LOCAL
        # engine here — shard ownership lives on hosts)
        self.compactor: DeltaCompactor | None = None
        if engine is not None and getattr(engine, "add_delta", None):
            self.compactor = DeltaCompactor(
                engine, self.pipeline, self.ledger, self.config
            )
            self.pipeline.on_delta = self.compactor.notify
            if self.config.ingest.compact_interval_s > 0:
                self.compactor.start()

    def compaction_metrics(self) -> dict:
        return {} if self.compactor is None else self.compactor.metrics()

    def close(self) -> None:
        """Stop the background compactor and release the pipeline's
        scan pool (app teardown)."""
        if self.compactor is not None:
            self.compactor.close()
        self.pipeline.close()

    # -- submission-time checks --------------------------------------------

    def check_vcf_locations(self, vcf_locations: list[str]) -> list[dict]:
        """Probe every VCF; returns the chromosome map entries the dataset
        doc carries (reference VcfChromosomeMap items {vcf, chromosomes})."""
        from ..io import is_remote, open_source

        chrom_map = []
        errors = []
        for vcf in set(vcf_locations):
            if is_remote(vcf):
                # object-store location (http(s)/s3, the reference's
                # native habitat): probe reachability by ranged read
                try:
                    if not open_source(vcf).exists():
                        errors.append(f"Could not find object {vcf}")
                        continue
                except Exception as e:
                    errors.append(f"Could not reach {vcf}: {e}")
                    continue
            elif not Path(vcf).exists():
                errors.append(f"Could not find file {vcf}")
                continue
            try:
                # self-index when no .tbi/.csi accompanies a local file —
                # unlike the reference, submission does not require an
                # external ``tabix`` run (remote objects must ship theirs)
                ensure_index(vcf)
                chroms = list_chromosomes(vcf)
            except Exception as e:
                errors.append(f"Could not index {vcf}: {e}")
                continue
            chrom_map.append({"vcf": str(vcf), "chromosomes": chroms})
        if errors:
            raise VcfLocationError("; ".join(sorted(errors)))
        # keep submission order for the map
        order = {e["vcf"]: e for e in chrom_map}
        return [order[v] for v in dict.fromkeys(vcf_locations)]

    # -- summarisation ------------------------------------------------------

    def schedule_summarisation(self, dataset_id: str) -> list[str]:
        """Run the sliced summarisation pipeline for the dataset's VCFs and
        pin shards to the engine (the reference's SNS pipeline kick, run
        in-process); returns progress messages for the submit response."""
        if self.store is None:
            return []
        doc = self.store.get_by_id("datasets", dataset_id)
        if doc is None:
            return []
        vcfs = doc.get("_vcfLocations", [])
        if not vcfs:
            return []
        stats = self.pipeline.summarise_dataset(
            dataset_id, vcfs, vcf_groups=doc.get("_vcfGroups")
        )
        return [
            f"Summarised {len(vcfs)} VCF(s): "
            f"{stats['variantCount']} distinct variants, "
            f"{stats['callCount']} calls, {stats['sampleCount']} samples"
        ]

    def load_all(self) -> int:
        """Re-pin every persisted shard (startup / crash-resume); returns
        the number of shards loaded."""
        n = 0
        idx_dir = self.config.storage.index_dir
        if not idx_dir.exists() or self.engine is None:
            return 0
        for path in sorted(idx_dir.glob("*/*.npz")):
            if path.name.endswith(".tmp.npz"):  # interrupted atomic save
                continue
            self.engine.add_index(load_index(path))
            n += 1
        return n
