"""Ontology term-closure store.

Counterpart of ``sbeacon_tpu/metadata/ontology.py``, copied whole so the
port reads and writes the same ``ontology.sqlite``, with one repair: the
store's single connection is used under a lock (the JAX store relies on
the GIL, and concurrent requests filtering by ontology terms raise
sqlite's InterfaceError there).

Re-homes the reference's three DynamoDB ontology tables (reference:
dynamodb.tf Ontologies/Anscestors/Descendants; models in shared_resources/
dynamodb/ontologies.py) into one sqlite store, and replaces the indexer's
network calls to EBI OLS / CSIRO Ontoserver (reference: lambda/indexer/
lambda_function.py:62-97,137-192) with a pluggable resolver:

- ``register_edges``: load (child, parent) is-a edges from any local source
  (an OBO/OWL-derived edge list, a bundled subset, tests) and compute the
  full transitive closure in both directions.
- ``resolver``: optional callable term -> set[ancestor terms] for deployers
  with network access; results are cached in the same tables so the closure
  is fetched at index time, never at query time (same contract as the
  reference's indexer).

Terms with no known closure behave as their own singleton family —
identical to the reference's DoesNotExist fallback
(filter_functions.py:_get_term_descendants).
"""

from __future__ import annotations

import json
import sqlite3
import threading
from collections import defaultdict
from pathlib import Path
from typing import Callable, Iterable


class OntologyStore:
    def __init__(self, path: str | Path = ":memory:"):
        if path != ":memory:":
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        # served from HTTP worker threads: one connection, every use of
        # it (statement and fetch) under the lock — two threads stepping
        # one sqlite connection at once raise InterfaceError ("bad
        # parameter or other API misuse"), which 64 HTTP clients
        # filtering by ontology terms hit
        self.conn = sqlite3.connect(str(path), check_same_thread=False)
        self._lock = threading.RLock()
        self.conn.executescript(
            """
            CREATE TABLE IF NOT EXISTS ontologies (
                prefix TEXT PRIMARY KEY, data TEXT
            );
            CREATE TABLE IF NOT EXISTS ancestors (
                term TEXT PRIMARY KEY, terms TEXT
            );
            CREATE TABLE IF NOT EXISTS descendants (
                term TEXT PRIMARY KEY, terms TEXT
            );
            """
        )
        self.conn.commit()
        self.resolver: Callable[[str], set[str]] | None = None

    # -- ontology metadata (reference Ontologies table) ---------------------

    def put_ontology(self, prefix: str, data: dict) -> None:
        with self._lock:
            self.conn.execute(
                "INSERT OR REPLACE INTO ontologies VALUES (?, ?)",
                (prefix, json.dumps(data)),
            )
            self.conn.commit()

    def get_ontology(self, prefix: str) -> dict | None:
        with self._lock:
            row = self.conn.execute(
                "SELECT data FROM ontologies WHERE prefix = ?", (prefix,)
            ).fetchone()
        return json.loads(row[0]) if row else None

    def list_ontologies(self) -> list[dict]:
        with self._lock:
            rows = self.conn.execute(
                "SELECT data FROM ontologies ORDER BY prefix"
            ).fetchall()
        return [json.loads(r[0]) for r in rows]

    # -- closure ------------------------------------------------------------

    def register_edges(self, edges: Iterable[tuple[str, str]]) -> None:
        """(child, parent) is-a edges -> full bidirectional closure.

        Closures include the term itself (the reference stores ancestors
        including self: indexer records term->ancestors from the OLS
        hierarchicalAncestors + self).
        """
        parents: dict[str, set[str]] = defaultdict(set)
        terms: set[str] = set()
        for child, parent in edges:
            parents[child].add(parent)
            terms.add(child)
            terms.add(parent)

        anc: dict[str, set[str]] = {}

        def ancestors_of(t: str, stack: tuple = ()) -> set[str]:
            if t in anc:
                return anc[t]
            if t in stack:  # cycle guard
                return {t}
            out = {t}
            for p in parents.get(t, ()):
                out |= ancestors_of(p, stack + (t,))
            anc[t] = out
            return out

        for t in terms:
            ancestors_of(t)
        self._merge_closures(anc)

    def register_ancestors(self, term: str, ancestors: set[str]) -> None:
        """Directly record a term's ancestor set (resolver result shape)."""
        self._merge_closures({term: set(ancestors) | {term}})

    def _merge_closures(self, anc: dict[str, set[str]]) -> None:
        desc: dict[str, set[str]] = defaultdict(set)
        for t, ancs in anc.items():
            for a in ancs:
                desc[a].add(t)
        with self._lock:
            cur = self.conn.cursor()
            for t, ancs in anc.items():
                ancs |= self.get_ancestors(t) or set()
                cur.execute(
                    "INSERT OR REPLACE INTO ancestors VALUES (?, ?)",
                    (t, json.dumps(sorted(ancs))),
                )
            for t, descs in desc.items():
                descs |= self.get_descendants(t) or set()
                cur.execute(
                    "INSERT OR REPLACE INTO descendants VALUES (?, ?)",
                    (t, json.dumps(sorted(descs))),
                )
            self.conn.commit()

    def _get(self, table: str, term: str) -> set[str] | None:
        with self._lock:
            row = self.conn.execute(
                f"SELECT terms FROM {table} WHERE term = ?", (term,)
            ).fetchone()
        return set(json.loads(row[0])) if row else None

    def get_ancestors(self, term: str) -> set[str] | None:
        return self._get("ancestors", term)

    def get_descendants(self, term: str) -> set[str] | None:
        return self._get("descendants", term)

    # -- expansion (the filter compiler's entry points) ---------------------

    def term_ancestors(self, term: str) -> set[str]:
        """Ancestors incl. self; unknown term -> {term}
        (reference _get_term_ancestors fallback)."""
        got = self.get_ancestors(term)
        if got is None and self.resolver is not None:
            try:
                fetched = self.resolver(term)
            except Exception:
                fetched = None
            if fetched is not None:
                self.register_ancestors(term, fetched)
                got = self.get_ancestors(term)
        return got if got is not None else {term}

    def term_descendants(self, term: str) -> set[str]:
        """Descendants incl. self; unknown term -> {term}."""
        got = self.get_descendants(term)
        return got if got is not None else {term}

    def expand_filter_term(
        self,
        term: str,
        *,
        include_descendants: bool = True,
        similarity: str = "high",
    ) -> set[str]:
        """Beacon similarity tiers (reference filter_functions.py:100-117):

        high   -> the term's own descendants;
        medium -> descendants of the ancestor half way up the closure;
        low    -> descendants of the broadest ancestor.
        """
        if not include_descendants:
            return {term}
        if similarity == "high":
            return self.term_descendants(term)
        ancestors = self.term_ancestors(term)
        families = sorted(
            (self.term_descendants(a) for a in ancestors), key=len
        )
        if similarity == "medium":
            return families[len(families) // 2]
        return families[-1]  # low

    def close(self) -> None:
        with self._lock:
            self.conn.close()
