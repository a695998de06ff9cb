"""Embedded columnar metadata engine.

Counterpart of ``sbeacon_tpu/metadata/store.py``, copied whole: the
sqlite schema is the same, so the port opens a ``metadata.sqlite`` the
JAX package wrote (and the reverse).

Plays the role of the reference's entire Athena/Glue metadata plane — the
six ORC entity tables, the terms/terms_index/relations CTAS products, and
the AthenaModel query API (reference: athena.tf:15-851; shared_resources/
athena/common.py AthenaModel.get_by_query/get_count_by_query/
get_existence_by_query) — as one sqlite database with the same query
surface and no polling: queries return in microseconds instead of the
reference's 0.1 s x 300 Athena poll loop (athena/common.py:151-165).

Entity documents are stored whole (JSON) plus one lowercased SQL column per
filterable field, so the filter compiler's generated SQL runs verbatim.
``rebuild_indexes`` is the indexer lambda equivalent (reference:
lambda/indexer/lambda_function.py index_terms/record_terms/record_relations):
it derives terms, terms_index and the six-way relations join from current
entity rows in three CREATE-AS statements.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from pathlib import Path

from .entities import ENTITY_COLUMNS, ENTITY_KINDS, extract_terms
from .filters import entity_search_conditions
from .ontology import OntologyStore


def _sql_value(doc: dict, col: str) -> str:
    """Column value from a doc: '_assemblyId' accepts either the private
    key or its public 'assemblyId' spelling (the reference models take
    assemblyId= and store _assemblyId)."""
    v = doc.get(col)
    if v is None and col.startswith("_"):
        v = doc.get(col[1:])
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    return json.dumps(v)


class MetadataStore:
    def __init__(
        self,
        path: str | Path = ":memory:",
        *,
        ontology: OntologyStore | None = None,
    ):
        self._path = str(path)
        if self._path != ":memory:":
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.conn = sqlite3.connect(self._path, check_same_thread=False)
        self._lock = threading.Lock()
        self._tlocal = threading.local()
        self._read_conns: list = []
        # per-kind row counts for the density heuristic: a COUNT(*) is
        # a full B-tree scan at 1M rows and was paid on EVERY
        # record-granularity fetch with one term filter (ADVICE r3);
        # invalidated by upsert/delete/rebuild_indexes
        self._kind_counts: dict[str, int] = {}
        if self._path != ":memory:":
            # WAL: writers never block readers, so per-thread read
            # connections can serve concurrently while upserts/rebuilds
            # proceed — one slow analytic count must not head-of-line
            # block the 0.13 ms boolean path (code-review r3)
            self.conn.execute("PRAGMA journal_mode=WAL")
            self.conn.execute("PRAGMA busy_timeout=10000")
        self.ontology = ontology
        self._create_tables()

    def _create_tables(self) -> None:
        cur = self.conn.cursor()
        for kind, cols in ENTITY_COLUMNS.items():
            col_defs = ", ".join(
                f"{c.lower()} TEXT" + (" PRIMARY KEY" if c == "id" else "")
                for c in cols
            )
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {kind} ({col_defs}, _doc TEXT)"
            )
        cur.executescript(
            """
            CREATE TABLE IF NOT EXISTS terms_cache (
                kind TEXT, id TEXT, term TEXT, label TEXT, type TEXT
            );
            CREATE INDEX IF NOT EXISTS terms_cache_kind_id
                ON terms_cache (kind, id);
            CREATE TABLE IF NOT EXISTS terms (
                term TEXT, label TEXT, type TEXT, kind TEXT
            );
            CREATE TABLE IF NOT EXISTS terms_index (
                id TEXT, term TEXT, kind TEXT
            );
            CREATE TABLE IF NOT EXISTS relations (
                datasetid TEXT, cohortid TEXT, individualid TEXT,
                biosampleid TEXT, runid TEXT, analysisid TEXT
            );
            """
        )
        self.conn.commit()

    def _read(self, sql: str, params=()):  # noqa: D401
        """Thread-safe read.

        File-backed stores: one sqlite connection PER READER THREAD
        (WAL mode), so reads run truly concurrently and never wait on
        the write lock. In-memory stores (tests): per-thread
        connections would each be a distinct empty database, so reads
        share the write connection under the lock — the lock is also
        what prevents the InterfaceError ('bad parameter or other API
        misuse') that concurrent cursor use on a shared connection
        raises under load (first seen as soak-test HTTP 500s)."""
        if self._path == ":memory:":
            with self._lock:
                return self.conn.execute(sql, params).fetchall()
        conn = getattr(self._tlocal, "conn", None)
        if conn is None:
            # check_same_thread=False: each reader connection is still
            # used only by its owning thread, but close() runs from the
            # closing thread — the default guard would raise there and
            # leak the file handle until GC
            conn = sqlite3.connect(self._path, check_same_thread=False)
            conn.execute("PRAGMA busy_timeout=10000")
            self._tlocal.conn = conn
            with self._lock:
                self._read_conns.append(conn)
        return conn.execute(sql, params).fetchall()

    # -- writes -------------------------------------------------------------

    def upsert(self, kind: str, docs: list[dict]) -> None:
        """Insert-or-replace entity documents; refresh their term cache rows
        (reference: per-entity upload_array ORC + terms-cache writes)."""
        if kind not in ENTITY_COLUMNS:
            raise ValueError(f"unknown entity kind {kind!r}")
        self._kind_counts.pop(kind, None)
        cols = ENTITY_COLUMNS[kind]
        col_names = ", ".join(c.lower() for c in cols) + ", _doc"
        placeholders = ", ".join("?" for _ in range(len(cols) + 1))
        with self._lock:
            cur = self.conn.cursor()
            for doc in docs:
                row = [_sql_value(doc, c) for c in cols]
                row.append(json.dumps(doc))
                cur.execute(
                    f"INSERT OR REPLACE INTO {kind} ({col_names}) "
                    f"VALUES ({placeholders})",
                    row,
                )
                cur.execute(
                    "DELETE FROM terms_cache WHERE kind = ? AND id = ?",
                    (kind, doc.get("id", "")),
                )
                cur.executemany(
                    "INSERT INTO terms_cache VALUES (?, ?, ?, ?, ?)",
                    [
                        (kind, doc.get("id", ""), term, label, typ)
                        for term, label, typ in extract_terms(doc)
                    ],
                )
            self.conn.commit()

    def delete(self, kind: str, entity_id: str) -> None:
        self._kind_counts.pop(kind, None)
        with self._lock:
            self._set_term_counts_clean(self.conn.cursor(), False)
            self.conn.execute(
                f"DELETE FROM {kind} WHERE id = ?", (entity_id,)
            )
            self.conn.execute(
                "DELETE FROM terms_cache WHERE kind = ? AND id = ?",
                (kind, entity_id),
            )
            self.conn.commit()

    # -- the indexer (reference lambda/indexer CTAS trio) -------------------

    _SECONDARY_INDEXES = {
        "terms_index_kind_term": "terms_index (kind, term, id)",
        "relations_dataset": "relations (datasetid)",
        "relations_cohort": "relations (cohortid)",
        "relations_individual": "relations (individualid)",
        "relations_biosample": "relations (biosampleid)",
        "relations_run": "relations (runid)",
        "relations_analysis": "relations (analysisid)",
        # cross-entity record pages (/datasets/{id}/individuals etc.,
        # _CROSS_ENTITY in api/app.py): each is WHERE <col> = ?
        # ORDER BY id LIMIT n — the (col, id) composite turns the 1M-row
        # scan-and-sort into an index range walk that stops at the page
        # boundary (the reference pattern to beat:
        # athena/common.py:37-48 ORDER BY id OFFSET/LIMIT full scans)
        "individuals_dataset_id": "individuals (_datasetid, id)",
        "individuals_cohort_id": "individuals (_cohortid, id)",
        "biosamples_individual_id": "biosamples (individualid, id)",
        "biosamples_dataset_id": "biosamples (_datasetid, id)",
        "runs_biosample_id": "runs (biosampleid, id)",
        "analyses_biosample_id": "analyses (biosampleid, id)",
        "analyses_run_id": "analyses (runid, id)",
    }

    def rebuild_indexes(self) -> None:
        self._kind_counts.clear()
        with self._lock:
            cur = self.conn.cursor()
            # drop secondary indexes first: maintaining them during the
            # bulk INSERTs below roughly doubles a full rebuild. Plain
            # execute (NOT executescript, which commits the pending
            # transaction) keeps the whole rebuild one atomic unit — a
            # mid-rebuild failure must roll back to the indexed state.
            for name in self._SECONDARY_INDEXES:
                cur.execute(f"DROP INDEX IF EXISTS {name}")
            cur.execute("DELETE FROM terms")
            cur.execute(
                "INSERT INTO terms "
                "SELECT DISTINCT term, label, type, kind FROM terms_cache "
                "ORDER BY term ASC"
            )
            cur.execute("DELETE FROM terms_index")
            cur.execute(
                "INSERT INTO terms_index "
                "SELECT DISTINCT id, term, kind FROM terms_cache"
            )
            cur.execute("DELETE FROM relations")
            # six-way entity join (reference generate_query_relations.py)
            cur.execute(
                """
                INSERT INTO relations
                SELECT
                    D.id AS datasetid,
                    C.id AS cohortid,
                    I.id AS individualid,
                    B.id AS biosampleid,
                    R.id AS runid,
                    A.id AS analysisid
                FROM datasets D
                LEFT OUTER JOIN individuals I ON D.id = I._datasetid
                LEFT OUTER JOIN biosamples B ON I.id = B.individualid
                LEFT OUTER JOIN runs R ON B.id = R.biosampleid
                LEFT OUTER JOIN analyses A ON R.id = A.runid
                FULL OUTER JOIN cohorts C ON C.id = I._cohortid
                """
            )
            # the indexes the filter plans need at scale (profiled at 1M
            # individuals: unindexed terms_index/relations turned every
            # filtered query into seconds of full scans) + fresh planner
            # statistics. Built after the bulk INSERTs — index-then-insert
            # is ~2x slower for the CTAS-style rebuild.
            for name, spec in self._SECONDARY_INDEXES.items():
                cur.execute(f"CREATE INDEX IF NOT EXISTS {name} ON {spec}")
            # precomputed term cardinalities: count
            # granularity with a single same-scope ontology-term filter
            # was a seconds-long id-IN materialisation at 1M rows; the
            # answer per (kind, term) is a rebuild-time aggregate. The
            # table derives ONLY from terms_index + relations, so it
            # shares their lifecycle exactly — upserts leave all three
            # equally stale until the next rebuild (the reference's
            # indexer-CTAS model, lambda/indexer/generate_query_terms.py).
            cur.execute("DROP TABLE IF EXISTS term_counts")
            cur.execute(
                "CREATE TABLE term_counts ("
                "kind TEXT, term TEXT, expanded INTEGER, n INTEGER, "
                "PRIMARY KEY (kind, term, expanded)) WITHOUT ROWID"
            )
            from .entities import RELATION_ID_COLUMN

            for kind, rel_col in RELATION_ID_COLUMN.items():
                # expanded=0: exact per-term cardinality
                cur.execute(
                    f"INSERT INTO term_counts "
                    f"SELECT '{kind}', TI.term, 0, "
                    f"COUNT(DISTINCT RI.{rel_col}) "
                    f"FROM relations RI JOIN terms_index TI "
                    f"ON RI.{rel_col} = TI.id "
                    f"WHERE TI.kind = '{kind}' GROUP BY TI.term"
                )
                # expanded=1: with-descendants cardinality for every
                # term a default filter could name (present terms and
                # their ancestors) — the multi-term COUNT DISTINCT was
                # still seconds at 1M, so the indexer precomputes it,
                # exactly like the reference's CTAS term tables
                # (lambda/indexer/generate_query_terms.py)
                if self.ontology is None:
                    continue
                present = [
                    r[0]
                    for r in cur.execute(
                        "SELECT DISTINCT term FROM terms_index "
                        "WHERE kind = ?",
                        (kind,),
                    )
                ]
                exact_n = dict(
                    cur.execute(
                        "SELECT term, n FROM term_counts "
                        "WHERE kind = ? AND expanded = 0",
                        (kind,),
                    ).fetchall()
                )
                candidates: set[str] = set(present)
                for t in present:
                    candidates |= self.ontology.term_ancestors(t)
                for t in sorted(candidates):
                    exp = sorted(self.ontology.term_descendants(t))
                    if len(exp) == 1:
                        n = exact_n.get(t, 0)
                    else:
                        ph = ", ".join("?" for _ in exp)
                        n = cur.execute(
                            f"SELECT COUNT(*) FROM ("
                            f"SELECT DISTINCT TI.id FROM terms_index TI "
                            f"WHERE TI.kind = ? AND TI.term IN ({ph})) d "
                            f"WHERE EXISTS(SELECT 1 FROM relations RI "
                            f"WHERE RI.{rel_col} = d.id)",
                            [kind, *exp],
                        ).fetchone()[0]
                    cur.execute(
                        "INSERT OR REPLACE INTO term_counts "
                        "VALUES (?, ?, 1, ?)",
                        (kind, t, int(n)),
                    )
            self._set_term_counts_clean(cur, True)
            cur.execute("ANALYZE")
            self.conn.commit()

    # -- query surface (AthenaModel equivalents) ----------------------------

    def _compile(self, filters, kind, **kw):
        return entity_search_conditions(
            filters, kind, kind, ontology=self.ontology, **kw
        )

    def _row_count(self, kind: str) -> int:
        """Cached COUNT(*) per entity table (write paths invalidate)."""
        n = self._kind_counts.get(kind)
        if n is None:
            n = self._read(f"SELECT COUNT(*) FROM {kind}")[0][0]
            self._kind_counts[kind] = n
        return n

    def _dense_single_term(self, filters, kind):
        """(expanded_terms, scope) when ``filters`` is exactly one
        ontology-term filter whose estimated match count is a large
        fraction of the table — the shape where the generic
        ``id IN (subquery)`` plan materialises hundreds of thousands of
        ids to return a 100-row page. None otherwise."""
        if not filters or len(filters) != 1 or self.ontology is None:
            return None
        f = filters[0]
        fid = f.get("id", "")
        parts = fid.split(".")
        from .entities import RELATION_ID_COLUMN

        if len(parts) != 1 or parts[0] in ENTITY_COLUMNS[kind]:
            return None  # own-column or malformed: generic path
        scope = f.get("scope", kind)
        if scope != kind or scope not in RELATION_ID_COLUMN:
            return None
        expanded = sorted(
            self.ontology.expand_filter_term(
                fid,
                include_descendants=f.get("includeDescendantTerms", True),
                similarity=f.get("similarity", "high"),
            )
        )
        ph = ", ".join("?" for _ in expanded)
        est = self._read(
            f"SELECT COUNT(*) FROM terms_index WHERE kind = ? "
            f"AND term IN ({ph})",
            [kind, *expanded],
        )[0][0]
        total = self._row_count(kind)
        if total and est >= total / 20:  # dense: walk beats materialise
            return expanded, scope
        return None

    def fetch(
        self,
        kind: str,
        filters: list[dict] | None = None,
        *,
        skip: int = 0,
        limit: int = 100,
        extra_where: str | None = None,
        extra_params: list | None = None,
    ) -> list[dict]:
        """Record-granularity page, ordered by id (reference
        get_record_query ORDER BY id OFFSET/LIMIT).

        Dense single-term filters switch from the reference-shaped
        ``id IN (subquery)`` plan to a correlated-EXISTS entity walk —
        logically identical (same relations semi-join), but it streams
        the PK in order and stops at the page boundary instead of
        materialising the full match set (1.8 s -> ms at 1M individuals
        for a 50%-selectivity filter)."""
        from .entities import RELATION_ID_COLUMN

        dense = self._dense_single_term(filters, kind)
        if dense is not None:
            expanded, scope = dense
            my_rel = RELATION_ID_COLUMN[kind]
            ph = ", ".join("?" for _ in expanded)
            where = (
                f"WHERE EXISTS(SELECT 1 FROM relations RI "
                f"JOIN terms_index TI ON RI.{RELATION_ID_COLUMN[scope]} = TI.id "
                f"WHERE RI.{my_rel} = {kind}.id AND TI.kind = '{scope}' "
                f"AND TI.term IN ({ph}))"
            )
            params: list = list(expanded)
            if extra_where:
                where += f" AND {extra_where}"
                params += list(extra_params or [])
            rows = self._read(
                f"SELECT _doc FROM {kind} {where} "
                f"ORDER BY id LIMIT ? OFFSET ?",
                [*params, limit, skip],
            )
            return [json.loads(r[0]) for r in rows]

        where, params = self._compile(filters or [], kind)
        if extra_where:
            where = (
                f"{where} AND {extra_where}"
                if where
                else f"WHERE {extra_where}"
            )
            params = params + list(extra_params or [])
        sql = (
            f"SELECT _doc FROM {kind} {where} "
            f"ORDER BY id LIMIT ? OFFSET ?"
        )
        rows = self._read(sql, [*params, limit, skip])
        return [json.loads(r[0]) for r in rows]

    def _single_term_filter(self, filters, kind):
        """The filter dict when ``filters`` is exactly one same-scope
        ontology-term filter (the count fast-path shape); None
        otherwise. Mirrors entity_search_parts' classification."""
        if not filters or len(filters) != 1 or self.ontology is None:
            return None
        f = filters[0]
        fid = f.get("id", "")
        parts = fid.split(".")
        from .entities import RELATION_ID_COLUMN

        if len(parts) != 1 or parts[0] in ENTITY_COLUMNS[kind]:
            return None
        scope = f.get("scope", kind)
        if scope != kind or scope not in RELATION_ID_COLUMN:
            return None
        return f

    def _has_term_counts(self) -> bool:
        return bool(
            self._read(
                "SELECT 1 FROM sqlite_master "
                "WHERE type='table' AND name='term_counts'"
            )
        )

    def _term_counts_clean(self) -> bool:
        """True when no delete() has happened since the last rebuild —
        the precomputed cardinalities still count deleted entities
        (upserts leave every derived table equally stale, deletes do
        not: the generic plan excludes a deleted entity immediately).
        Persisted in the database so a restarted process honours a
        prior process's deletes."""
        try:
            rows = self._read(
                "SELECT value FROM _store_meta "
                "WHERE key = 'term_counts_clean'"
            )
        except Exception:
            return False
        return bool(rows) and rows[0][0] == "1"

    def _set_term_counts_clean(self, cur, clean: bool) -> None:
        cur.execute(
            "CREATE TABLE IF NOT EXISTS _store_meta "
            "(key TEXT PRIMARY KEY, value TEXT)"
        )
        cur.execute(
            "INSERT OR REPLACE INTO _store_meta VALUES "
            "('term_counts_clean', ?)",
            ("1" if clean else "0",),
        )

    def count(
        self,
        kind: str,
        filters: list[dict] | None = None,
        *,
        extra_where: str | None = None,
        extra_params: list | None = None,
    ) -> int:
        from .entities import RELATION_ID_COLUMN

        f = (
            self._single_term_filter(filters, kind)
            if not extra_where
            else None
        )
        if f is not None and self._has_term_counts():
            fid = f["id"]
            desc = f.get("includeDescendantTerms", True)
            similarity = f.get("similarity", "high")
            if (not desc or similarity == "high") and (
                self._term_counts_clean()
            ):
                # O(1): the rebuild-time cardinality IS the answer —
                # expanded=0 (exact term) or expanded=1 (the indexer's
                # with-descendants precompute, keyed by the FILTER term)
                rows = self._read(
                    "SELECT n FROM term_counts WHERE kind = ? "
                    "AND term = ? AND expanded = ?",
                    [kind, fid, 1 if desc else 0],
                )
                if rows:
                    return int(rows[0][0])
            # uncached expansion (non-high similarity, or a term the
            # indexer has never seen): distinct-then-probe — ~5x the
            # generic id-IN plan at 1M rows, same semantics
            expanded = sorted(
                self.ontology.expand_filter_term(
                    fid, include_descendants=desc, similarity=similarity
                )
            )
            my_rel = RELATION_ID_COLUMN[kind]
            ph = ", ".join("?" for _ in expanded)
            # the extra entity-table EXISTS keeps this plan equivalent
            # to the generic id-IN count even for entities deleted
            # since the last rebuild (delete() removes the entity row
            # but not its terms_index/relations rows)
            rows = self._read(
                f"SELECT COUNT(*) FROM ("
                f"SELECT DISTINCT TI.id FROM terms_index TI "
                f"WHERE TI.kind = ? AND TI.term IN ({ph})) d "
                f"WHERE EXISTS(SELECT 1 FROM relations RI "
                f"WHERE RI.{my_rel} = d.id) "
                f"AND EXISTS(SELECT 1 FROM {kind} e WHERE e.id = d.id)",
                [kind, *expanded],
            )
            return int(rows[0][0])

        where, params = self._compile(filters or [], kind)
        if extra_where:
            where = (
                f"{where} AND {extra_where}"
                if where
                else f"WHERE {extra_where}"
            )
            params = params + list(extra_params or [])
        sql = f"SELECT COUNT(*) FROM {kind} {where}"
        return int(self._read(sql, params)[0][0])

    def exists(
        self,
        kind: str,
        filters: list[dict] | None = None,
        *,
        extra_where: str | None = None,
        extra_params: list | None = None,
    ) -> bool:
        """Boolean granularity without counting: streams the filter
        subqueries and stops at the first surviving row. At 1M
        individuals a 50%-selectivity filter answers in ~0 ms where
        ``count() > 0`` took seconds (the join subquery materialises
        fully under ``id IN (...)``; a streamed FROM-subquery with a
        correlated entity probe short-circuits instead, with identical
        semantics — the probe keeps the id-must-exist requirement).
        ``extra_where`` predicates (scoped routes) fold into the entity
        probe like own-column filters."""
        from .filters import entity_search_parts

        outer, outer_params, subs, join_params, my_rel = entity_search_parts(
            filters or [], kind, kind, ontology=self.ontology
        )
        if extra_where:
            outer = outer + [f"({extra_where})"]
            outer_params = outer_params + list(extra_params or [])
        if not subs:
            where = f"WHERE {' AND '.join(outer)}" if outer else ""
            rows = self._read(
                f"SELECT 1 FROM {kind} {where} LIMIT 1", outer_params
            )
            return bool(rows)
        comp = " INTERSECT ".join(subs)
        # unqualified outer-predicate columns resolve to ``e`` inside the
        # probe (the streamed row ``t`` exposes only the relation id)
        preds = "".join(f" AND {p}" for p in outer)
        rows = self._read(
            f"SELECT 1 FROM ({comp}) t WHERE EXISTS("
            f"SELECT 1 FROM {kind} e WHERE e.id = t.{my_rel}{preds}) "
            f"LIMIT 1",
            list(join_params) + list(outer_params),
        )
        return bool(rows)

    def get_by_id(self, kind: str, entity_id: str) -> dict | None:
        rows = self._read(
            f"SELECT _doc FROM {kind} WHERE id = ?", (entity_id,)
        )
        return json.loads(rows[0][0]) if rows else None

    def query(self, sql: str, params: list | tuple = ()) -> list[tuple]:
        """Raw parameterised SQL (the run_custom_query escape hatch)."""
        return self._read(sql, params)

    # -- filtering terms ----------------------------------------------------

    def filtering_terms(
        self, *, skip: int = 0, limit: int = 100, kinds: list[str] | None = None
    ) -> list[dict]:
        """Paginated distinct terms (reference getFilteringTerms SELECT
        DISTINCT term, label, type ORDER BY term)."""
        where = ""
        params: list = []
        if kinds:
            where = f"WHERE kind IN ({', '.join('?' for _ in kinds)})"
            params = list(kinds)
        rows = self._read(
            f"SELECT DISTINCT term, label, type FROM terms {where} "
            f"ORDER BY term ASC LIMIT ? OFFSET ?",
            [*params, limit, skip],
        )
        return [
            {"id": t, "label": lb, "type": ty} for t, lb, ty in rows
        ]

    # -- dataset helpers (reference athena/dataset.py get_datasets) ---------

    def datasets_for_assembly(
        self,
        assembly_id: str,
        *,
        dataset_ids: list[str] | None = None,
        filters: list[dict] | None = None,
        skip: int = 0,
        limit: int = 1_000_000,
    ) -> list[dict]:
        extra = "LOWER(_assemblyid) = LOWER(?)"
        params: list = [assembly_id]
        if dataset_ids:
            extra += f" AND id IN ({', '.join('?' for _ in dataset_ids)})"
            params.extend(dataset_ids)
        return self.fetch(
            "datasets",
            filters or [],
            skip=skip,
            limit=limit,
            extra_where=extra,
            extra_params=params,
        )

    def _sample_names_via_analyses(
        self, column: str, entity_id: str
    ) -> dict[str, list[str]]:
        """dataset_id -> vcf sample names via the analyses table
        (reference route_individuals_id_g_variants.py:23-34 Athena join)."""
        rows = self._read(
            f"SELECT _datasetid, _vcfsampleid FROM analyses "
            f"WHERE {column} = ? AND _vcfsampleid != ''",
            (entity_id,),
        )
        out: dict[str, list[str]] = {}
        for ds, sample in rows:
            out.setdefault(ds, []).append(sample)
        return out

    def sample_names_for_individual(
        self, individual_id: str
    ) -> dict[str, list[str]]:
        return self._sample_names_via_analyses("individualid", individual_id)

    def sample_names_for_biosample(
        self, biosample_id: str
    ) -> dict[str, list[str]]:
        return self._sample_names_via_analyses("biosampleid", biosample_id)

    def sample_names_for_run(self, run_id: str) -> dict[str, list[str]]:
        return self._sample_names_via_analyses("runid", run_id)

    def sample_names_for_analysis(
        self, analysis_id: str
    ) -> dict[str, list[str]]:
        return self._sample_names_via_analyses("id", analysis_id)

    def filtering_terms_for_entity(
        self, kind: str, entity_id: str, *, skip: int = 0, limit: int = 100
    ) -> list[dict]:
        """Terms attached to one dataset/cohort and every entity under it
        (reference route_datasets_id_filtering_terms.py:83-127 — the
        5-way UNION over the entity's own terms and its child entities)."""
        fk = "_datasetid" if kind == "datasets" else "_cohortid"
        union = [
            "SELECT term FROM terms_index WHERE id = ? AND kind = ?"
        ]
        params: list = [entity_id, kind]
        for child in ("individuals", "biosamples", "runs", "analyses"):
            union.append(
                f"SELECT TI.term FROM {child} E "
                f"JOIN terms_index TI ON TI.id = E.id "
                f"AND TI.kind = '{child}' WHERE E.{fk} = ?"
            )
            params.append(entity_id)
        rows = self._read(
            "SELECT DISTINCT term, label, type FROM terms WHERE term IN "
            f"({' UNION '.join(union)}) ORDER BY term LIMIT ? OFFSET ?",
            [*params, limit, skip],
        )
        return [{"id": t, "label": lb, "type": ty} for t, lb, ty in rows]

    def entities_for_samples(
        self,
        kind: str,
        dataset_id: str,
        sample_names: list[str],
        *,
        skip: int = 0,
        limit: int = 100,
    ) -> list[dict]:
        """Entities of ``kind`` whose analyses carry one of the VCF sample
        names in a dataset (reference route_g_variants_id_individuals.py
        get_record_query: individuals JOIN analyses ON individualid WHERE
        _vcfsampleid IN samples)."""
        join_col = {"individuals": "individualid", "biosamples": "biosampleid"}[
            kind
        ]
        if not sample_names:
            return []
        ph = ", ".join("?" for _ in sample_names)
        rows = self._read(
            f"SELECT DISTINCT E._doc FROM {kind} E "
            f"JOIN analyses A ON A.{join_col} = E.id "
            f"WHERE A._datasetid = ? AND A._vcfsampleid IN ({ph}) "
            f"ORDER BY E.id LIMIT ? OFFSET ?",
            [dataset_id, *sample_names, limit, skip],
        )
        return [json.loads(r[0]) for r in rows]

    def close(self) -> None:
        with self._lock:
            for c in self._read_conns:
                try:
                    c.close()
                except Exception:
                    pass
            self._read_conns.clear()
        self.conn.close()
