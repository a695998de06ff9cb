"""The summarisation pipeline: sliced, parallel, resumable.

Re-expresses the reference's four-stage SNS pipeline (reference:
summariseDataset -> summariseVcf -> summariseSlice (C++) ->
duplicateVariantSearch (C++); SURVEY.md §3.2) as one orchestrated run:

- summariseVcf's planning (chunk boundaries + Newton-optimal slice size)
  comes from ``planner.plan_slices``;
- summariseSlice's per-slice scan (BGZF range read, record parse,
  variant/call counting, index build) runs on a thread pool, each slice
  persisting a partial shard — the unit of crash-resume;
- the DynamoDB barrier set is the ``JobLedger``; a re-run processes only
  slices still pending (reference toUpdate semantics);
- duplicateVariantSearch's distinct-variant count is a set-union over the
  merged shards' (contig, pos, ref, alt) keys — the same hash-set count
  the C++ lambda computes per bp-range (duplicateVariantSearch.cpp:31-84),
  without the fan-out because shards are local.

Counterpart of ``sbeacon_tpu/ingest/pipeline.py``, copied whole. With
``IngestConfig.scan_worker_urls`` (or a ``scan_pool``) the slice scans
scatter over the fleet's workers (``parallel.dispatch.ScanWorkerPool``),
each worker's npz blob saved as it came; a failed remote scan is
scanned again on this host, the only failover of the path, and a host
one. The streamed slices publish onto the port engine's ``add_delta``;
the base reaches the card through ``add_index``; both raise on a device
failure. ``close`` releases a scan pool the pipeline built (the JAX
pipeline never closes it).
The base artifact's save and the base publish take the key's publish
lock (``publish_lock``), which the compactor's base fold takes too.
``parallel.distinct.distinct_count_device`` counts the same keys as
``distinct_variant_count`` on the card and is held against it.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..config import BeaconConfig
from ..genomics.bgzf import BgzfReader
from ..genomics.tabix import ensure_index
from ..genomics.vcf import parse_record, read_sample_names
from ..utils.trace import span
from ..index.columnar import (
    VariantIndexShard,
    build_index,
    build_index_from_text,
    load_index,
    merge_shards,
    save_index,
)
from .ledger import JobLedger
from .planner import plan_slices

log = logging.getLogger(__name__)


from ..io import is_remote


class _SliceDiskTracker:
    """Process-wide accounting of slice-shard temp bytes on disk
    (``ingest.slice_disk_bytes``). Slices used to coexist on disk until
    the post-merge bulk delete; now each file is deleted the moment its
    rows are folded (held in memory / merged), so a many-sample
    cohort's peak temp-disk is ~one slice — ``peak`` lets the bench
    assert that."""

    def __init__(self):
        self._lock = threading.Lock()
        self._current = 0
        self._peak = 0

    def add(self, n: int) -> None:
        with self._lock:
            self._current += int(n)
            self._peak = max(self._peak, self._current)

    def sub(self, n: int) -> None:
        with self._lock:
            self._current = max(0, self._current - int(n))

    def stats(self) -> dict:
        with self._lock:
            return {"current": self._current, "peak": self._peak}

    def reset(self) -> None:
        with self._lock:
            self._current = 0
            self._peak = 0


#: process-wide like ``transport._STATS`` — the ingest pipeline may be
#: driven by several services in one process, the disk is one
SLICE_DISK = _SliceDiskTracker()


class _NativeFallbackTracker:
    """Process-wide count of slice scans that fell back from the native
    codec to the pure-Python path (``ingest.native_fallbacks``). The
    fallback is PER BLOB — one malformed slice re-parses alone, it never
    demotes the dataset (let alone the process) off the fast path — so a
    non-zero rate with healthy throughput is tolerable, but a rate that
    tracks the slice rate means every scan pays a failed native attempt
    plus the Python re-parse: the silent ~3x ingest slowdown this series
    exists to surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def tick(self) -> None:
        with self._lock:
            self._count += 1

    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self) -> None:
        with self._lock:
            self._count = 0


NATIVE_FALLBACKS = _NativeFallbackTracker()


def register_ingest_metrics(registry) -> None:
    """The ingest pipeline's process-wide series."""
    registry.gauge(
        "ingest.slice_disk_bytes",
        "slice-shard temp bytes currently on disk",
        fn=lambda: SLICE_DISK.stats()["current"],
    )
    registry.counter(
        "ingest.native_fallbacks",
        "slice scans that fell back from the native codec to the "
        "pure-Python path (per blob, never per dataset)",
        fn=NATIVE_FALLBACKS.count,
    )


#: max size of one compressed BGZF block (BSIZE is u16): the remote
#: fetch must cover the whole block containing the slice's end voffset
_BLOCK_MAX = 1 << 16


def native_slice_text(vcf_path: str | Path, vstart: int, vend: int) -> bytes:
    """THE native decode seam: uncompressed slice text for the
    virtual-offset range [vstart, vend), local or remote.

    Local files stream through ``native.inflate_range`` (the file-path
    entry point). Remote scan blobs fetch their compressed span by one
    concurrent ranged GET — sockets release the GIL — and inflate it
    in place through ``native.inflate_buffer`` (ctypes releases the GIL
    too), so worker-count scaling moves ingest throughput instead of
    serialising on the interpreter. Raises on any native refusal; the
    caller owns the per-blob pure-Python fallback (and the
    ``ingest.native_fallbacks`` tick). Every native decode call site in
    the ingest plane routes through here (tools/check_native_seam.py)."""
    from .. import native

    if not is_remote(vcf_path):
        return native.inflate_range(str(vcf_path), vstart, vend)
    from ..genomics.bgzf import split_virtual_offset
    from ..io import open_source

    c0, u0 = split_virtual_offset(vstart)
    c1, u1 = split_virtual_offset(vend)
    src = open_source(vcf_path)
    fetch_end = min(c1 + _BLOCK_MAX, src.size())
    blob = src.read_range(c0, fetch_end, workers=4)
    return native.inflate_buffer(blob, u0, ((c1 - c0) << 16) | u1)


def read_slice_records(
    vcf_path: str | Path, vstart: int, vend: int
) -> list:
    """Parse all records in a virtual-offset slice [vstart, vend).

    Decompression goes through the native parallel BGZF codec when built
    (native.inflate_range), but a slice's text must include the record that
    *starts* before ``vend``'s block boundary finishes, so the tail is
    completed from the python reader's line iterator semantics: slices are
    planned on chunk boundaries (record starts), which makes the naive
    range exact here."""
    try:
        from .. import native

        if native.prefer_native_io():
            text = native_slice_text(vcf_path, vstart, vend)
            records = []
            for line in text.split(b"\n"):
                rec = parse_record(line)
                if rec is not None:
                    records.append(rec)
            return records
    except Exception:
        # fall back to the pure-python reader, per blob; the fallback
        # tick belongs to scan_slice_to_shard (the one scan entry), so
        # a decode failure that re-fails here is not counted twice
        pass
    reader = BgzfReader(vcf_path)
    records = []
    for _, line in reader.iter_lines(vstart, vend):
        rec = parse_record(line)
        if rec is not None:
            records.append(rec)
    return records


def scan_slice_to_shard(
    vcf_path,
    vstart: int,
    vend: int,
    *,
    dataset_id: str,
    sample_names: list[str],
) -> "VariantIndexShard":
    """One slice -> one index shard, on the fastest available path.

    With the native library: inflate the slice text, then the tokenizer
    + vectorised assembly (columnar.build_index_from_text — bit-identical
    to the python path, parity-fuzzed). Any fast-path refusal (e.g. AC=
    arity mismatch) or failure falls back to parse_record + build_index.
    """
    from .. import native

    if native.available():
        try:
            if native.prefer_native_io():
                # one seam for local AND remote: the remote leg streams
                # the fetched blob through the native decoder instead of
                # the GIL-bound pure-Python block loop
                text = native_slice_text(vcf_path, vstart, vend)
            else:
                text = BgzfReader(vcf_path).read_range(vstart, vend)
            return build_index_from_text(
                text,
                dataset_id=dataset_id,
                vcf_location=str(vcf_path),
                sample_names=sample_names,
            )
        except ValueError:
            # deliberate refusal (e.g. AC= arity mismatch): quiet
            NATIVE_FALLBACKS.tick()
            log.debug(
                "fast slice scan refused for %s [%d,%d); python path",
                vcf_path,
                vstart,
                vend,
                exc_info=True,
            )
        except Exception:
            # unexpected: every slice paying a failed fast attempt plus
            # the python re-parse is a silent ~3x ingest slowdown — say so
            NATIVE_FALLBACKS.tick()
            log.warning(
                "fast slice scan FAILED for %s [%d,%d); falling back to "
                "the python parser",
                vcf_path,
                vstart,
                vend,
                exc_info=True,
            )
    records = read_slice_records(vcf_path, vstart, vend)
    return build_index(
        records,
        dataset_id=dataset_id,
        vcf_location=str(vcf_path),
        sample_names=sample_names,
    )


class SummarisationPipeline:
    def __init__(
        self,
        config: BeaconConfig | None = None,
        *,
        ledger: JobLedger | None = None,
        engine=None,
        store=None,
        scan_pool=None,
    ):
        self.config = config or BeaconConfig()
        self.ledger = ledger or JobLedger(self.config.storage.ledger_db)
        self.engine = engine
        self.store = store
        # in-process serialisation per VCF: concurrent submissions of the
        # same dataset must not race-write the same shard files
        self._vcf_locks: dict[str, threading.Lock] = {}
        # per-(dataset, VCF) publish lock: the base artifact's save and
        # the base publish of a summarisation, and the compactor's base
        # fold, run under it (``publish_lock``)
        self._publish_locks: dict[tuple[str, str], threading.Lock] = {}
        self._locks_guard = threading.Lock()
        # streaming-ingest state: keys whose base publish was DEFERRED
        # (slices already serve as deltas; the compactor folds later),
        # and a hook the owning service wires to the compactor so a
        # deep delta tail kicks an early fold
        self._deferred: set[tuple[str, str]] = set()
        self.on_delta = None  # callable(dataset_id, vcf, depth) | None
        self.defer_base = bool(
            getattr(self.config.ingest, "defer_base_publish", False)
        )
        # cross-host slice scatter (the reference's <=1000-lambda
        # summariseSlice fan-out): slice jobs round-robin over the
        # configured scan workers; a worker failure falls back to a
        # local scan, so distribution affects throughput, not results
        self._owns_scan_pool = False
        if scan_pool is None and self.config.ingest.scan_worker_urls:
            from ..parallel.dispatch import ScanWorkerPool

            tcfg = self.config.transport
            scan_pool = ScanWorkerPool(
                list(self.config.ingest.scan_worker_urls),
                token=self.config.auth.worker_token,
                timeout_s=self.config.ingest.scan_timeout_s,
                retries=self.config.ingest.scan_retries,
                hedge_delay_s=tcfg.hedge_delay_s,
                transport_config=tcfg,
            )
            self._owns_scan_pool = True
        self.scan_pool = scan_pool

    def close(self) -> None:
        """Release the scan pool this pipeline built from its config (a
        caller-passed pool stays the caller's)."""
        if self._owns_scan_pool and self.scan_pool is not None:
            self.scan_pool.close()

    def _vcf_lock(self, vcf: str) -> threading.Lock:
        with self._locks_guard:
            return self._vcf_locks.setdefault(str(vcf), threading.Lock())

    def publish_lock(self, dataset_id: str, vcf: str) -> threading.Lock:
        """The key's publish lock. Without it a compactor base fold
        whose delta snapshot predates a summarisation's final publish
        could overwrite the full base artifact and republish a partial
        base, dropping every row streamed after its snapshot (the JAX
        package takes no such lock; ROADMAP Queue 3). Not held during
        the slice scan, so folds still run while a VCF streams."""
        with self._locks_guard:
            return self._publish_locks.setdefault(
                (dataset_id, str(vcf)), threading.Lock()
            )

    # -- paths --------------------------------------------------------------

    def _vcf_key(self, vcf: str) -> str:
        return str(vcf).replace("/", "%")

    def shard_path(self, dataset_id: str, vcf: str) -> Path:
        return (
            self.config.storage.index_dir
            / dataset_id
            / f"{self._vcf_key(vcf)}.npz"
        )

    def _slice_dir(self, dataset_id: str, vcf: str) -> Path:
        return (
            self.config.storage.index_dir
            / dataset_id
            / f"{self._vcf_key(vcf)}.slices"
        )

    def l1_dir(self, dataset_id: str, vcf: str) -> Path:
        """Standing intermediate (L1) compaction artifacts for the key
        — epoch-ranged merges of raw delta tails, persisted so a
        crashed fold's next run adopts instead of re-merging. A
        nested dir (depth 3): ``load_all``'s ``*/*.npz`` glob never
        repins an L1 as a base shard."""
        return (
            self.config.storage.index_dir
            / dataset_id
            / f"{self._vcf_key(vcf)}.l1"
        )

    def retired_dir(self, dataset_id: str, vcf: str) -> Path:
        """Superseded base/L1 artifacts parked at each base merge;
        retention GC deletes ONLY from here (never a serving path)."""
        return (
            self.config.storage.index_dir
            / dataset_id
            / f"{self._vcf_key(vcf)}.retired"
        )

    # -- per-VCF stage ------------------------------------------------------

    def summarise_vcf(self, dataset_id: str, vcf: str) -> VariantIndexShard:
        """Plan -> scan slices in parallel -> merge -> persist.

        Idempotent and resumable: finished shard short-circuits; a partial
        run re-processes only ledger-pending slices (persisted slice
        shards are reused). Concurrent in-process calls for the same VCF
        serialise on a lock — the second caller then takes the finished-
        shard short-circuit."""
        with span("ingest.summarise_vcf", vcf=str(vcf)):
            with self._vcf_lock(vcf):
                return self._summarise_vcf_locked(dataset_id, vcf)

    def _streaming(self, dataset_id: str, vcf: str) -> bool:
        """Whether this summarisation streams slices as delta shards:
        an engine that can host deltas, the knob on, and NO base shard
        already published for the key — re-summarising a served VCF
        must not stream, its slices would duplicate base rows until
        the fold."""
        eng = self.engine
        return (
            eng is not None
            and getattr(self.config.ingest, "stream_deltas", False)
            and getattr(eng, "add_delta", None) is not None
            and not getattr(eng, "has_index", lambda *_a: True)(
                dataset_id, str(vcf)
            )
        )

    def _unlink_slice(self, spath: Path) -> None:
        """Delete one slice temp file, keeping the disk gauge honest."""
        try:
            n = spath.stat().st_size
            spath.unlink()
            SLICE_DISK.sub(n)
        except OSError:
            pass

    def _summarise_vcf_locked(
        self, dataset_id: str, vcf: str
    ) -> VariantIndexShard:
        final = self.shard_path(dataset_id, vcf)
        if final.exists() and self.ledger.vcf_is_summarised(str(vcf)):
            return load_index(final)

        sample_names = read_sample_names(vcf)

        resumed = False
        plan = plan_slices(ensure_index(vcf), self.config.ingest)
        if not self.ledger.mark_updating(str(vcf), plan.slices):
            # a previous (crashed) run holds the claim: resume with the
            # slice plan *stored at claim time* — a freshly computed plan
            # may drift (config change, regenerated index) and would then
            # never match the pending slice strings
            resumed = True
            plan.slices = self.ledger.claimed_slices(str(vcf))
            log.info("resuming summarisation of %s", vcf)
        pending = set(self.ledger.pending_slices(str(vcf)))
        self.ledger.set_sample_count(str(vcf), len(sample_names))

        slice_dir = self._slice_dir(dataset_id, vcf)
        slice_dir.mkdir(parents=True, exist_ok=True)

        # streaming publication (ingest-while-serving): each slice
        # becomes queryable the moment it completes — the merge barrier
        # below no longer holds ALL visibility until the last slice
        # lands. The finished shards are kept in memory (they are the
        # published deltas anyway), which is what lets each slice temp
        # file be deleted immediately: peak temp-disk is ~one slice,
        # and a crash in the window degrades to a re-scan, not loss.
        stream = self._streaming(dataset_id, vcf)
        mem_lock = threading.Lock()
        shards_mem: dict[tuple[int, int], VariantIndexShard] = {}
        published_epochs: list[int] = []
        publish_failures: list = []

        def publish_delta(sl, shard) -> None:
            with mem_lock:
                shards_mem[sl] = shard
            if not stream:
                return
            try:
                epoch = self.engine.add_delta(shard)
            except Exception:
                with mem_lock:
                    publish_failures.append(sl)
                log.exception(
                    "delta publish failed for %s %s; rows stay "
                    "invisible until the merge publishes", vcf, sl
                )
                return
            with mem_lock:
                published_epochs.append(epoch)
            try:
                self.ledger.record_delta_publish(
                    dataset_id, str(vcf), epoch, shard.n_rows
                )
            except Exception:
                log.warning("delta-publish ledger record failed",
                            exc_info=True)
            hook = self.on_delta
            if hook is not None:
                depth = getattr(
                    self.engine, "delta_depth", lambda *_a: 0
                )(dataset_id, str(vcf))
                hook(dataset_id, str(vcf), depth)

        def run_slice(sl: tuple[int, int]):
            spath = slice_dir / f"{sl[0]}-{sl[1]}.npz"
            if sl not in pending and spath.exists():
                return  # finished in a previous run (merged below)
            if self.scan_pool is not None:
                from ..index.columnar import save_index_blob
                from ..payloads import SliceScanPayload

                try:
                    # the worker's npz blob is persisted verbatim: the
                    # coordinator relays bytes, it does not decompress
                    # and recompress each slice
                    blob = self.scan_pool.scan_blob(
                        SliceScanPayload(
                            dataset_id=dataset_id,
                            vcf_location=str(vcf),
                            vstart=sl[0],
                            vend=sl[1],
                            sample_names=sample_names,
                        )
                    )
                    meta = save_index_blob(blob, spath)
                    SLICE_DISK.add(spath.stat().st_size)
                    self.ledger.complete_slice(
                        str(vcf),
                        sl,
                        variant_count=meta["variant_count"],
                        call_count=meta["call_count"],
                    )
                    if stream:
                        # the blob landed as a file; lift it into the
                        # delta registry and drop the temp file now
                        shard = load_index(spath)
                        publish_delta(sl, shard)
                        self._unlink_slice(spath)
                    return
                except Exception:
                    log.exception(
                        "remote slice scan failed for %s %s; "
                        "scanning locally",
                        vcf,
                        sl,
                    )
            shard = scan_slice_to_shard(
                vcf,
                sl[0],
                sl[1],
                dataset_id=dataset_id,
                sample_names=sample_names,
            )
            # slice shards are merged and deleted moments later, so the
            # zlib pass is skipped UNLESS the genotype bit planes are
            # large: planes are mostly zeros (compress 10-50x) and the
            # crash-resume checkpoint briefly coexists with its
            # siblings, so an uncompressed many-sample cohort would
            # multiply peak temp-disk usage
            planes = sum(
                p.nbytes
                for p in (shard.gt_bits, shard.gt_bits2,
                          shard.tok_bits1, shard.tok_bits2)
                if p is not None
            )
            if spath.exists():
                # a crashed run's file: retire its tracked bytes before
                # re-saving, or the gauge drifts up permanently
                self._unlink_slice(spath)
            save_index(shard, spath, compress=planes > 16 * 1024 * 1024)
            SLICE_DISK.add(spath.stat().st_size)
            self.ledger.complete_slice(
                str(vcf),
                sl,
                variant_count=shard.meta["variant_count"],
                call_count=shard.meta["call_count"],
            )
            publish_delta(sl, shard)
            if stream:
                # the rows live in the delta registry; a crash before
                # the merge re-scans this slice (merge fallback below)
                self._unlink_slice(spath)

        workers = max(1, self.config.ingest.workers)
        if len(plan.slices) <= 1 or workers == 1:
            for sl in plan.slices:
                run_slice(sl)
        else:
            with ThreadPoolExecutor(workers) as pool:
                list(pool.map(run_slice, plan.slices))

        shards = []
        for sl in plan.slices:
            spath = slice_dir / f"{sl[0]}-{sl[1]}.npz"
            shard = shards_mem.get(sl)
            if shard is None and spath.exists():
                shard = load_index(spath)
            if shard is None:
                # completed in a crashed streaming run whose temp file
                # was already folded away: re-scan — the VCF itself is
                # the durable source of truth
                log.info(
                    "slice %s of %s missing on disk; re-scanning", sl, vcf
                )
                shard = scan_slice_to_shard(
                    vcf,
                    sl[0],
                    sl[1],
                    dataset_id=dataset_id,
                    sample_names=sample_names,
                )
            # fold-then-delete: each slice's temp file dies as soon as
            # its rows are in the merge working set, not after the full
            # merge — peak temp-disk during the merge is one slice
            if spath.exists():
                self._unlink_slice(spath)
            shards.append(shard)
        merged = (
            merge_shards(shards)
            if shards
            else build_index(
                [],
                dataset_id=dataset_id,
                vcf_location=str(vcf),
                sample_names=sample_names,
            )
        )
        # merged meta keeps the identity of this (dataset, vcf) pair.
        # delta_epoch marks how far this artifact folds the delta tail:
        # publishing it to the engine atomically retires exactly those
        # epochs (merge_shards copied shards[0].meta, which may carry a
        # single slice's epoch — it MUST be overwritten here).
        merged.meta["dataset_id"] = dataset_id
        merged.meta["vcf_location"] = str(vcf)
        if published_epochs:
            merged.meta["delta_epoch"] = max(published_epochs)
        else:
            merged.meta.pop("delta_epoch", None)
        with self.publish_lock(dataset_id, vcf):
            save_index(merged, final)
        if self.config.ingest.export_portable:
            # reference-layout binary region files (vcf-summaries/ role,
            # write_data_to_s3.h) alongside the primary npz shard
            from ..index.portable import export_region_files

            export_region_files(
                merged, self.config.storage.index_dir / "portable" / dataset_id
            )
        for p in slice_dir.glob("*"):
            self._unlink_slice(p)
        slice_dir.rmdir()
        if (
            stream
            and published_epochs
            and not publish_failures
            and self.defer_base
        ):
            # continuous-ingest mode: the rows already serve as deltas,
            # so the base publish (fingerprint bump + stack dirtying +
            # cache-key rotation) is deferred to the compactor cadence
            # instead of demolishing the warm query plane per submit.
            # Deferral requires EVERY slice's delta to have published —
            # a failed publish means some rows only exist in the merged
            # base, and deferring it would leave them unqueryable until
            # a fold that may never be triggered.
            with self._locks_guard:
                self._deferred.add((dataset_id, str(vcf)))
        if resumed:
            log.info("resumed summarisation of %s complete", vcf)
        return merged

    def base_deferred(self, dataset_id: str, vcf: str) -> bool:
        """Whether this key's base publish was deferred to the
        compactor (its slices already serve as delta shards)."""
        with self._locks_guard:
            return (dataset_id, str(vcf)) in self._deferred

    def clear_deferred(self, dataset_id: str, vcf: str) -> None:
        """The compactor folded this key's tail into a published base —
        future (re-)summarisations publish inline again."""
        with self._locks_guard:
            self._deferred.discard((dataset_id, str(vcf)))

    # -- dataset stage ------------------------------------------------------

    def summarise_dataset(
        self,
        dataset_id: str,
        vcf_locations: list[str],
        vcf_groups: list[list[str]] | None = None,
    ):
        """Summarise every VCF, compute dataset-level stats (distinct
        variants across VCFs = the duplicateVariantSearch role), pin
        shards to the engine; returns the stats dict.

        ``vcf_groups`` partitions the VCFs into groups sharing one sample
        cohort (VCFs split by chromosome); samples are counted once per
        group (reference summariseDataset:87-124), and the default is ONE
        group holding every VCF (reference submitDataset:93
        ``vcfGroups = [vcfLocations]``)."""
        self.ledger.start_dataset(dataset_id, vcf_locations)
        shards = []
        shard_by_vcf: dict[str, VariantIndexShard] = {}
        for vcf in vcf_locations:
            shard = self.summarise_vcf(dataset_id, vcf)
            shards.append(shard)
            shard_by_vcf[str(vcf)] = shard
            if self.engine is not None and not self.base_deferred(
                dataset_id, str(vcf)
            ):
                # publishing a merged shard whose meta carries
                # delta_epoch IS an inline fold: the engine swaps the
                # base in and retires the streamed slices' delta
                # shards in one critical section (duplicate-free)
                with self.publish_lock(dataset_id, vcf):
                    tail = getattr(
                        self.engine,
                        "delta_tail",
                        lambda *_a: {"shards": 0, "rows": 0},
                    )(dataset_id, str(vcf))
                    self.engine.add_index(shard)
                folded = shard.meta.get("delta_epoch")
                if tail["shards"] and folded is not None:
                    try:
                        # folded_rows counts TAIL rows only — the same
                        # semantics as DeltaCompactor._fold, so the
                        # ledger audit and compaction.folded_rows
                        # metric agree regardless of which path folds
                        self.ledger.record_compaction(
                            dataset_id,
                            str(vcf),
                            folded_through=int(folded),
                            folded_shards=tail["shards"],
                            folded_rows=tail["rows"],
                        )
                    except Exception:
                        log.warning(
                            "inline-fold ledger record failed",
                            exc_info=True,
                        )

        distinct = distinct_variant_count(
            shards, max_range_bytes=self.config.ingest.max_range_bytes
        )
        call_count = sum(s.meta["call_count"] for s in shards)
        # sample count: once per VCF group (all VCFs in a group carry the
        # same cohort — they are chromosome splits). A grouping that does
        # not partition the summarised VCFs would silently skew the count,
        # so it degrades to the default one-group-of-everything with a
        # warning (the API layer rejects bad groupings at submit).
        groups = vcf_groups if vcf_groups else [list(vcf_locations)]
        flat = sorted(str(v) for grp in groups for v in grp)
        if flat != sorted(shard_by_vcf):
            if vcf_groups:
                log.warning(
                    "vcf_groups does not partition the dataset's VCFs; "
                    "falling back to one group (dataset %s)",
                    dataset_id,
                )
            groups = [list(shard_by_vcf)]
        sample_count = 0
        for grp in groups:
            for vcf in grp:
                s = shard_by_vcf.get(str(vcf))
                if s is not None:
                    sample_count += s.meta["sample_count"]
                    break
        self.ledger.finish_dataset(
            dataset_id,
            variant_count=distinct,
            call_count=call_count,
            sample_count=sample_count,
        )
        if self.scan_pool is not None:
            # shared-storage fleets: tell the scan workers to re-pin the
            # newly persisted shards so the query fan-out serves them
            # (best-effort; workers also reload on restart)
            try:
                self.scan_pool.reload_workers()
            except Exception:
                log.warning("worker reload after ingest failed", exc_info=True)
        return {
            "datasetId": dataset_id,
            "variantCount": distinct,
            "callCount": call_count,
            "sampleCount": sample_count,
        }


def distinct_variant_count(
    shards: list[VariantIndexShard], *, max_range_bytes: int | None = None
) -> int:
    """Distinct (contig, pos, ref, alt) across shards — the reference's
    cross-VCF duplicate-variant tally (duplicateVariantSearch.cpp
    unordered_set<pos + ref_alt> insert loop), computed over the columnar
    index instead of re-downloading binary range files.

    Vectorised: rows are grouped by the fixed-width key
    (chrom_code, pos, ref_hash, alt_hash, ref_len, alt_len) with one
    np.unique; only rows sharing a key (true cross-VCF duplicates, or the
    astronomically rare double-FNV collision) fall back to exact byte
    comparison, so the count is exact without a per-row Python loop.

    ``max_range_bytes`` bounds peak memory the way the reference's
    ABS_MAX_DATA_SPLIT bounds its dup-search fan-out ranges
    (initDuplicateVariantSearch.py greedy packing): when the key matrix
    would exceed it, rows are partitioned into disjoint (contig, pos)
    chunks and counted chunk by chunk — distinctness over disjoint
    position ranges sums exactly."""
    import numpy as np

    if not shards:
        return 0
    key_parts = []
    for s in shards:
        codes = (
            np.searchsorted(
                s.chrom_offsets, np.arange(s.n_rows), side="right"
            )
            - 1
        ).astype(np.int64)
        key_parts.append(
            np.stack(
                [
                    codes,
                    s.cols["pos"].astype(np.int64),
                    s.cols["ref_hash"].astype(np.int64),
                    s.cols["alt_hash"].astype(np.int64),
                    s.cols["ref_len"].astype(np.int64),
                    s.cols["alt_len"].astype(np.int64),
                ],
                axis=1,
            )
        )
    keys = np.concatenate(key_parts)
    n = len(keys)
    if n == 0:
        return 0

    shard_of = np.concatenate(
        [np.full(s.n_rows, k, dtype=np.int32) for k, s in enumerate(shards)]
    )
    row_of = np.concatenate(
        [np.arange(s.n_rows, dtype=np.int64) for s in shards]
    )

    row_bytes = keys.dtype.itemsize * keys.shape[1]
    if max_range_bytes is not None and n * row_bytes > max_range_bytes:
        # partition into disjoint (code, pos) chunks and sum — bounded
        # peak memory, exact total
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        keys = keys[order]
        shard_of = shard_of[order]
        row_of = row_of[order]
        rows_per_range = max(1, max_range_bytes // row_bytes)
        total = 0
        start = 0
        while start < n:
            end = min(n, start + rows_per_range)
            # extend so equal (code, pos) rows stay in one chunk
            while end < n and (
                keys[end, 0] == keys[end - 1, 0]
                and keys[end, 1] == keys[end - 1, 1]
            ):
                end += 1
            total += _distinct_exact(
                keys[start:end],
                shard_of[start:end],
                row_of[start:end],
                shards,
            )
            start = end
        return total
    return _distinct_exact(keys, shard_of, row_of, shards)


def _distinct_exact(keys, shard_of, row_of, shards) -> int:
    """Exact distinct count of one key chunk: hash-grouped np.unique, byte
    verification only for rows whose key repeats."""
    import numpy as np

    n = len(keys)
    voids = np.ascontiguousarray(keys).view(
        np.dtype((np.void, keys.dtype.itemsize * keys.shape[1]))
    ).ravel()
    uniq, inverse, counts = np.unique(
        voids, return_inverse=True, return_counts=True
    )
    total = int((counts == 1).sum())
    if len(uniq) == n:
        return total
    dup_groups = np.flatnonzero(counts > 1)
    dup_mask = np.isin(inverse, dup_groups)
    per_group: dict[int, set] = {}
    for gi, sk, rk in zip(
        inverse[dup_mask], shard_of[dup_mask], row_of[dup_mask]
    ):
        s = shards[sk]
        allele = (
            bytes(s.ref_blob[s.ref_off[rk] : s.ref_off[rk + 1]]),
            bytes(s.alt_blob[s.alt_off[rk] : s.alt_off[rk + 1]]),
        )
        per_group.setdefault(int(gi), set()).add(allele)
    total += sum(len(v) for v in per_group.values())
    return total
