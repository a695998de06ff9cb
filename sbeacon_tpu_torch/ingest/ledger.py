"""Resumable ingestion job ledger.

Counterpart of ``sbeacon_tpu/ingest/ledger.py``, copied whole but for
its reads, which take the connection's lock here (``_read``).

Re-homes the reference's DynamoDB control tables (reference: dynamodb.tf —
``VcfSummaries`` with its ``toUpdate`` string set, ``Datasets``
``toUpdateFiles``, ``VariantDuplicates`` ``toUpdate`` ranges) into one
sqlite database with the same checkpoint/resume semantics (SURVEY.md §5):
the pending-work sets ARE the checkpoints. A crashed worker leaves its
slice in ``to_update``; re-running the stage processes only what remains;
counters are cleared on (re)start exactly as the reference REMOVEs the
count attributes when marking a VCF updating
(summariseVcf/lambda_function.py:159-186 mark_updating).

Concurrency control uses sqlite's atomicity the way the reference uses
DynamoDB conditional expressions: ``mark_updating`` is an INSERT that
fails when a summarisation is already running
(``attribute_not_exists(toUpdate)``), and ``complete_slice`` removes one
slice and reports whether it was the last (the reference's atomic
DELETE-from-set + last-deleter-advances-pipeline barrier,
summariseSlice/main.cpp:360-438).
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path


def _slice_str(s: tuple[int, int]) -> str:
    return f"{s[0]}-{s[1]}"


class _ImmediateTxn:
    """``with`` helper: threading lock + BEGIN IMMEDIATE, commit on clean
    exit, rollback on exception."""

    def __init__(self, conn: sqlite3.Connection, lock: threading.Lock):
        self.conn = conn
        self.lock = lock

    def __enter__(self):
        self.lock.acquire()
        try:
            self.conn.execute("BEGIN IMMEDIATE")
        except BaseException:
            self.lock.release()
            raise
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.conn.execute("COMMIT")
            else:
                self.conn.execute("ROLLBACK")
        finally:
            self.lock.release()
        return False


class JobLedger:
    def __init__(self, path: str | Path = ":memory:"):
        if path != ":memory:":
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.conn = sqlite3.connect(str(path), check_same_thread=False)
        self._lock = threading.Lock()
        self.conn.executescript(
            """
            CREATE TABLE IF NOT EXISTS vcf_summaries (
                vcf_location TEXT PRIMARY KEY,
                to_update TEXT,          -- JSON list of pending slice strings
                all_slices TEXT,         -- JSON list of the claimed plan
                variant_count INTEGER,
                call_count INTEGER,
                sample_count INTEGER,
                updated_at REAL
            );
            CREATE TABLE IF NOT EXISTS dataset_jobs (
                dataset_id TEXT PRIMARY KEY,
                to_update_files TEXT,    -- JSON list of pending VCFs
                variant_count INTEGER,   -- distinct across VCFs
                call_count INTEGER,
                sample_count INTEGER,
                state TEXT,
                updated_at REAL
            );
            CREATE TABLE IF NOT EXISTS delta_log (
                dataset_id TEXT,
                vcf_location TEXT,
                epoch INTEGER,           -- per-key delta epoch
                rows INTEGER,
                published_at REAL,
                folded_at REAL,          -- NULL while the delta stands
                PRIMARY KEY (dataset_id, vcf_location, epoch)
            );
            CREATE TABLE IF NOT EXISTS compactions (
                dataset_id TEXT,
                vcf_location TEXT,
                folded_through INTEGER,  -- highest epoch folded
                folded_shards INTEGER,
                folded_rows INTEGER,
                completed_at REAL
            );
            """
        )
        # size-tiered compaction columns: additive ALTERs so
        # a ledger file from an earlier build keeps working (NULL tier
        # reads as the legacy full-base fold)
        for col, typ in (
            ("tier", "TEXT"),
            ("in_bytes", "INTEGER"),
            ("out_bytes", "INTEGER"),
            ("write_amp", "REAL"),
        ):
            try:
                self.conn.execute(
                    f"ALTER TABLE compactions ADD COLUMN {col} {typ}"
                )
            except sqlite3.OperationalError:
                pass  # column already present
        self.conn.commit()

    # -- VCF summarisation state (reference VcfSummaries table) -------------

    def _read(self, sql: str, args: tuple = (), *, many: bool = False):
        """One read under the connection's lock. The connection is
        shared by the request, slice-worker and compactor threads; a
        read interleaved with another thread's open transaction would
        step its cursor and see its uncommitted rows (the JAX package
        reads unlocked; ROADMAP Queue 3)."""
        with self._lock:
            cur = self.conn.execute(sql, args)
            return cur.fetchall() if many else cur.fetchone()

    def _txn(self):
        """BEGIN IMMEDIATE context: write lock up front so read-modify-
        write sequences are atomic across *processes* sharing the ledger
        file, not just threads (the DynamoDB conditional-write equivalence
        the module docstring promises)."""
        return _ImmediateTxn(self.conn, self._lock)

    def mark_updating(
        self, vcf_location: str, slices: list[tuple[int, int]]
    ) -> bool:
        """Claim a VCF for summarisation; False when already in progress
        (the reference's attribute_not_exists(toUpdate) condition)."""
        pending = json.dumps([_slice_str(s) for s in slices])
        with self._txn():
            row = self.conn.execute(
                "SELECT to_update FROM vcf_summaries "
                "WHERE vcf_location = ?",
                (vcf_location,),
            ).fetchone()
            if row is not None and row[0] is not None and json.loads(row[0]):
                return False
            # counts cleared on (re)start, like the REMOVE of COUNTS
            self.conn.execute(
                "INSERT OR REPLACE INTO vcf_summaries VALUES "
                "(?, ?, ?, 0, 0, NULL, ?)",
                (vcf_location, pending, pending, time.time()),
            )
        return True

    def claimed_slices(self, vcf_location: str) -> list[tuple[int, int]]:
        """The slice plan stored at claim time — resume must use THIS,
        not a freshly computed plan (config/index drift would otherwise
        strand the pending set forever)."""
        row = self._read(
            "SELECT all_slices FROM vcf_summaries WHERE vcf_location = ?",
            (vcf_location,),
        )
        if row is None or row[0] is None:
            return []
        return [
            (int(s.split("-")[0]), int(s.split("-")[1]))
            for s in json.loads(row[0])
        ]

    def pending_slices(self, vcf_location: str) -> list[tuple[int, int]]:
        row = self._read(
            "SELECT to_update FROM vcf_summaries WHERE vcf_location = ?",
            (vcf_location,),
        )
        if row is None or row[0] is None:
            return []
        out = []
        for s in json.loads(row[0]):
            a, b = s.split("-")
            out.append((int(a), int(b)))
        return out

    def set_sample_count(self, vcf_location: str, n: int) -> None:
        with self._txn():
            self.conn.execute(
                "UPDATE vcf_summaries SET sample_count = ? "
                "WHERE vcf_location = ?",
                (n, vcf_location),
            )

    def complete_slice(
        self,
        vcf_location: str,
        sl: tuple[int, int],
        *,
        variant_count: int,
        call_count: int,
    ) -> bool:
        """Record one finished slice; True when it was the last pending
        (the atomic ADD-counts + DELETE-slice barrier,
        summariseSlice/main.cpp updateVcfSummary)."""
        s = _slice_str(sl)
        with self._txn():
            row = self.conn.execute(
                "SELECT to_update FROM vcf_summaries WHERE vcf_location = ?",
                (vcf_location,),
            ).fetchone()
            if row is None or row[0] is None:
                return False
            pending = json.loads(row[0])
            if s not in pending:  # already completed (idempotent redo)
                return False
            pending.remove(s)
            self.conn.execute(
                "UPDATE vcf_summaries SET to_update = ?, "
                "variant_count = variant_count + ?, "
                "call_count = call_count + ?, updated_at = ? "
                "WHERE vcf_location = ?",
                (
                    json.dumps(pending),
                    variant_count,
                    call_count,
                    time.time(),
                    vcf_location,
                ),
            )
            return not pending

    def vcf_summary(self, vcf_location: str) -> dict | None:
        row = self._read(
            "SELECT to_update, variant_count, call_count, sample_count "
            "FROM vcf_summaries WHERE vcf_location = ?",
            (vcf_location,),
        )
        if row is None:
            return None
        return {
            "pending": json.loads(row[0]) if row[0] else [],
            "variant_count": row[1],
            "call_count": row[2],
            "sample_count": row[3],
        }

    def vcf_is_summarised(self, vcf_location: str) -> bool:
        s = self.vcf_summary(vcf_location)
        return s is not None and not s["pending"] and s["sample_count"] is not None

    # -- delta / compaction bookkeeping (ingest-while-serving) --------------

    def record_delta_publish(
        self, dataset_id: str, vcf_location: str, epoch: int, rows: int
    ) -> None:
        """One delta shard became queryable (engine.add_delta). The log
        is observability + audit — correctness does not depend on it
        (a crashed tail is re-derived by re-summarising the VCF)."""
        with self._txn():
            self.conn.execute(
                "INSERT OR REPLACE INTO delta_log VALUES "
                "(?, ?, ?, ?, ?, NULL)",
                (dataset_id, vcf_location, epoch, rows, time.time()),
            )

    def record_compaction(
        self,
        dataset_id: str,
        vcf_location: str,
        *,
        folded_through: int,
        folded_shards: int,
        folded_rows: int,
        tier: str = "base",
        in_bytes: int = 0,
        out_bytes: int = 0,
        write_amp: float | None = None,
    ) -> None:
        """One completed fold: stamps the folded deltas and appends a
        compaction row (the audit trail /debug and the bench read).
        ``tier`` names the fold level (``l1`` = raw tail -> epoch-
        ranged intermediate artifact, ``base`` = full base merge);
        ``in_bytes``/``out_bytes``/``write_amp`` record the fold's IO
        and its write amplification (bytes written per delta byte
        folded — the number size-tiering exists to bound). An L1 fold
        only stamps ``folded_at`` at the base tier: an L1-absorbed
        delta still stands (as part of its artifact) until a base
        merge actually retires the range."""
        with self._txn():
            if tier == "base":
                self.conn.execute(
                    "UPDATE delta_log SET folded_at = ? "
                    "WHERE dataset_id = ? AND vcf_location = ? "
                    "AND epoch <= ? AND folded_at IS NULL",
                    (
                        time.time(),
                        dataset_id,
                        vcf_location,
                        folded_through,
                    ),
                )
            self.conn.execute(
                "INSERT INTO compactions (dataset_id, vcf_location, "
                "folded_through, folded_shards, folded_rows, "
                "completed_at, tier, in_bytes, out_bytes, write_amp) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (
                    dataset_id,
                    vcf_location,
                    folded_through,
                    folded_shards,
                    folded_rows,
                    time.time(),
                    tier,
                    int(in_bytes),
                    int(out_bytes),
                    write_amp,
                ),
            )

    def delta_summary(self) -> dict:
        """Aggregate delta/compaction counters: standing (unfolded)
        deltas, lifetime publishes, and completed compaction runs."""
        standing, published = self._read(
            "SELECT COALESCE(SUM(CASE WHEN folded_at IS NULL THEN 1 "
            "ELSE 0 END), 0), COUNT(*) FROM delta_log"
        )
        # folded_rows aggregates the BASE tier only (its pre-tiering
        # meaning: delta rows retired into base shards) — an L1 fold
        # and the base merge that later absorbs it would otherwise
        # count the same rows twice, and every L1 re-consolidation
        # would re-count its constituents
        runs, rows = self._read(
            "SELECT COUNT(*), COALESCE(SUM(CASE WHEN "
            "COALESCE(tier, 'base') = 'base' THEN folded_rows "
            "ELSE 0 END), 0) FROM compactions"
        )
        tiers = {
            str(t or "base"): int(n)
            for t, n in self._read(
                "SELECT COALESCE(tier, 'base'), COUNT(*) "
                "FROM compactions GROUP BY COALESCE(tier, 'base')",
                many=True,
            )
        }
        # aggregate write-amp under the SAME definition as the
        # per-fold column (out bytes per delta-TAIL byte folded): the
        # tail denominator is recovered from each row's out/write_amp
        # — summing in_bytes instead would fold the base's bytes into
        # the denominator and read ~1.0 even when every fold is a full
        # base merge, the exact signal this column exists to surface
        out_sum = 0.0
        tail_sum = 0.0
        for ob, ib, wa in self._read(
            "SELECT out_bytes, in_bytes, write_amp FROM compactions",
            many=True,
        ):
            ob = int(ob or 0)
            out_sum += ob
            tail_sum += ob / wa if wa else int(ib or 0)
        return {
            "standing_deltas": int(standing or 0),
            "delta_publishes": int(published or 0),
            "compaction_runs": int(runs or 0),
            "compaction_folded_rows": int(rows or 0),
            "compaction_tiers": tiers,
            "compaction_write_amp": (
                round(out_sum / tail_sum, 3) if tail_sum else 0.0
            ),
        }

    def compaction_log(self, dataset_id: str | None = None) -> list[dict]:
        """The per-fold audit rows, oldest first — tier, IO bytes and
        write amplification per fold (the bench's per-fold record)."""
        sql = (
            "SELECT dataset_id, vcf_location, folded_through, "
            "folded_shards, folded_rows, COALESCE(tier, 'base'), "
            "in_bytes, out_bytes, write_amp, completed_at "
            "FROM compactions"
        )
        args: tuple = ()
        if dataset_id is not None:
            sql += " WHERE dataset_id = ?"
            args = (dataset_id,)
        sql += " ORDER BY completed_at"
        return [
            {
                "dataset": r[0],
                "vcf": r[1],
                "foldedThrough": r[2],
                "foldedShards": r[3],
                "foldedRows": r[4],
                "tier": r[5],
                "inBytes": r[6],
                "outBytes": r[7],
                "writeAmp": r[8],
                "completedAt": r[9],
            }
            for r in self._read(sql, args, many=True)
        ]

    # -- dataset aggregation state (reference Datasets control item) --------

    def start_dataset(self, dataset_id: str, vcf_locations: list[str]) -> None:
        with self._txn():
            self.conn.execute(
                "INSERT OR REPLACE INTO dataset_jobs VALUES "
                "(?, ?, NULL, NULL, NULL, 'summarising', ?)",
                (dataset_id, json.dumps(vcf_locations), time.time()),
            )

    def finish_dataset(
        self,
        dataset_id: str,
        *,
        variant_count: int,
        call_count: int,
        sample_count: int,
    ) -> None:
        with self._txn():
            self.conn.execute(
                "UPDATE dataset_jobs SET to_update_files = '[]', "
                "variant_count = ?, call_count = ?, sample_count = ?, "
                "state = 'complete', updated_at = ? WHERE dataset_id = ?",
                (
                    variant_count,
                    call_count,
                    sample_count,
                    time.time(),
                    dataset_id,
                ),
            )

    def dataset_job(self, dataset_id: str) -> dict | None:
        row = self._read(
            "SELECT to_update_files, variant_count, call_count, "
            "sample_count, state FROM dataset_jobs WHERE dataset_id = ?",
            (dataset_id,),
        )
        if row is None:
            return None
        return {
            "pending_files": json.loads(row[0]) if row[0] else [],
            "variant_count": row[1],
            "call_count": row[2],
            "sample_count": row[3],
            "state": row[4],
        }

    def close(self) -> None:
        self.conn.close()
