"""External ontology resolver clients: the indexer's OLS / Ontoserver role.

Counterpart of ``sbeacon_tpu/metadata/resolvers.py``, copied whole.

The reference's indexer builds the ancestor/descendant closure by calling
EBI OLS ``hierarchicalAncestors`` for CURIE-prefixed ontologies and the
CSIRO Ontoserver FHIR ``ValueSet/$expand`` (``generalizes`` filter) for
SNOMED, with per-ontology metadata discovery and a 10-retry loop
(reference: lambda/indexer/lambda_function.py:40-222). Here those are
concrete client classes over an injectable HTTP transport — production
deployments pass a real transport; air-gapped environments (like this
build/test box, zero egress) inject a fake or skip resolution, and every
fetched closure lands in the persistent :class:`OntologyStore` cache so
resolution is a one-time, offline-tolerant step.

``TermTreeIndexer`` is the driver (``index_terms_tree`` equivalent):
cluster the metadata store's distinct terms by ontology prefix, discover
ontology metadata, fetch missing ancestor sets on a thread pool, and
merge the closure (ancestors + inverted descendants) into the store.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

log = logging.getLogger(__name__)

#: transport signature: (method, url, json_body|None) -> (status, parsed json)
Transport = Callable[[str, str, dict | None], tuple[int, dict]]

from ..config import (
    DEFAULT_OLS_URL as DEFAULT_OLS,
    DEFAULT_ONTOSERVER_URL as DEFAULT_ONTOSERVER,
)

SNOMED_BASE_URI = "http://snomed.info/sct"

def urllib_transport(method: str, url: str, body: dict | None = None):
    """Default stdlib transport. On a zero-egress host every call raises,
    which the resolvers treat as 'term not resolvable now'."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url,
        data=data,
        method=method,
        headers={"Content-Type": "application/json"} if body else {},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def term_prefix(term: str) -> str:
    """Ontology cluster key. The reference's SNOMED sniff
    (``re.match(r'(?i)(^SNOMED)|([0-9]+)', term)``, indexer:126) routes
    terms starting with 'SNOMED' or with a bare digit (SNOMED codes are
    submitted non-CURIE) to Ontoserver; everything else clusters by its
    CURIE prefix."""
    if term.upper().startswith("SNOMED") or term[:1].isdigit():
        return "SNOMED"
    return term.split(":")[0].upper()


class OlsResolver:
    """EBI OLS client: ontology metadata + hierarchicalAncestors
    (reference threaded_request_ensemble, indexer:61-73,149-163)."""

    def __init__(
        self, base_url: str = DEFAULT_OLS, transport: Transport | None = None
    ):
        self.base_url = base_url.rstrip("/")
        self.transport = transport or urllib_transport

    def ontology_meta(self, prefix: str) -> dict | None:
        """{'id', 'baseUri'} for an ontology prefix, or None."""
        try:
            status, doc = self.transport(
                "GET", f"{self.base_url}/{prefix.lower()}", None
            )
        except Exception as e:
            log.warning("OLS meta fetch failed for %s: %s", prefix, e)
            return None
        if status != 200:
            return None
        try:
            return {
                "id": doc["ontologyId"].upper(),
                "baseUri": doc["config"]["baseUris"][0],
            }
        except (KeyError, IndexError):
            return None

    def ancestors(self, term: str, meta: dict) -> set[str] | None:
        """obo_ids of the term's hierarchical ancestors; None on failure
        (the reference silently drops unresolvable terms)."""
        prefix, _, local = term.partition(":")
        iri = meta["baseUri"] + local
        # OLS wants the IRI double-URL-encoded in the path
        enc = urllib.parse.quote_plus(urllib.parse.quote_plus(iri))
        url = (
            f"{self.base_url}/{prefix.lower()}/terms/{enc}"
            "/hierarchicalAncestors?size=500"
        )
        out: set[str] = set()
        # OLS paginates (default page size 20): follow _links.next so
        # deep closures (HPO/NCIT routinely exceed a page) aren't
        # silently truncated into the persistent cache
        for _ in range(100):  # hard page cap
            try:
                status, doc = self.transport("GET", url, None)
            except Exception as e:
                log.warning("OLS ancestors failed for %s: %s", term, e)
                return None
            if status != 200:
                return None
            for t in doc.get("_embedded", {}).get("terms", []):
                if t.get("obo_id"):
                    out.add(t["obo_id"])
            nxt = doc.get("_links", {}).get("next", {}).get("href")
            if not nxt:
                break
            url = nxt
        return out or None


class OntoserverResolver:
    """FHIR terminology-server client for SNOMED: ``ValueSet/$expand``
    with a ``generalizes`` filter = the term's ancestors (reference
    threaded_request_ontoserver, indexer:76-97), retried up to 10x."""

    def __init__(
        self,
        url: str = DEFAULT_ONTOSERVER,
        transport: Transport | None = None,
        *,
        retries: int = 10,
        retry_sleep_s: float = 1.0,
    ):
        self.url = url
        self.transport = transport or urllib_transport
        self.retries = retries
        self.retry_sleep_s = retry_sleep_s

    def ancestors(self, term: str, meta: dict) -> set[str] | None:
        snomed = "SNOMED" in term.upper()
        # strip the CURIE prefix case-insensitively: 'snomed:123' must
        # send code '123', not the whole term
        prefix, sep, local = term.partition(":")
        code = local if sep and prefix.upper() == "SNOMED" else term
        body = {
            "resourceType": "Parameters",
            "parameter": [
                {
                    "name": "valueSet",
                    "resource": {
                        "resourceType": "ValueSet",
                        "compose": {
                            "include": [
                                {
                                    "system": meta.get(
                                        "baseUri", SNOMED_BASE_URI
                                    ),
                                    "filter": [
                                        {
                                            "property": "concept",
                                            "op": "generalizes",
                                            "value": code,
                                        }
                                    ],
                                }
                            ]
                        },
                    },
                }
            ],
        }
        for attempt in range(self.retries):
            try:
                status, doc = self.transport("POST", self.url, body)
            except Exception as e:
                # transport raise (urllib HTTPError on non-2xx, resets) is
                # as retryable as an error status — the reference's loop
                # retries any non-200 up to 10x (indexer:79-95)
                log.warning(
                    "ontoserver attempt %d failed for %s: %s",
                    attempt + 1,
                    term,
                    e,
                )
                if attempt + 1 < self.retries:
                    time.sleep(self.retry_sleep_s)
                continue
            if status == 200:
                out = set()
                for entry in doc.get("expansion", {}).get("contains", []):
                    c = entry.get("code")
                    if c:
                        out.add(f"SNOMED:{c}" if snomed else c)
                return out or None
            if attempt + 1 < self.retries:
                time.sleep(self.retry_sleep_s)
        log.warning("ontoserver gave up on %s", term)
        return None


class TermTreeIndexer:
    """The indexer's ``index_terms_tree`` driver over local stores.

    Pulls distinct terms from the metadata store, clusters by prefix,
    discovers per-ontology metadata (cached in the ontology store),
    resolves missing ancestor sets on a thread pool (SNOMED via
    Ontoserver, the rest via OLS), and merges the closure — ancestors
    plus inverted descendants — into the ontology store
    (reference indexer:202-222 batch writes)."""

    def __init__(
        self,
        store,
        ontology_store,
        *,
        ols: OlsResolver | None = None,
        ontoserver: OntoserverResolver | None = None,
        workers: int = 8,
    ):
        self.store = store
        self.ontology = ontology_store
        self.ols = ols or OlsResolver()
        self.ontoserver = ontoserver or OntoserverResolver()
        self.workers = workers

    def distinct_terms(self) -> list[str]:
        rows = self.store.query("SELECT DISTINCT term FROM terms")
        return [t for (t,) in rows if t]

    def _meta_for(self, prefix: str) -> dict | None:
        cached = self.ontology.get_ontology(prefix)
        if cached:
            return cached
        if prefix == "SNOMED":
            meta = {"id": "SNOMED", "baseUri": SNOMED_BASE_URI}
        else:
            meta = self.ols.ontology_meta(prefix)
        if meta:
            self.ontology.put_ontology(prefix, meta)
        return meta

    def run(self) -> dict:
        """Returns {'resolved': n, 'skipped': n, 'failed': n}."""
        clusters: dict[str, set[str]] = {}
        for term in self.distinct_terms():
            clusters.setdefault(term_prefix(term), set()).add(term)

        jobs: list[tuple[str, dict, object]] = []
        skipped = failed = 0
        for prefix, terms in sorted(clusters.items()):
            meta = self._meta_for(prefix)
            if meta is None:
                failed += len(terms)
                continue
            resolver = self.ontoserver if prefix == "SNOMED" else self.ols
            for term in sorted(terms):
                # fetch only closures not already cached (reference
                # Anscestors.DoesNotExist gate, indexer:168-186)
                if self.ontology.get_ancestors(term) is not None:
                    skipped += 1
                    continue
                jobs.append((term, meta, resolver))

        resolved = 0
        if jobs:
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                results = pool.map(
                    lambda j: (j[0], j[2].ancestors(j[0], j[1])), jobs
                )
                for term, ancestors in results:
                    if ancestors:
                        self.ontology.register_ancestors(term, ancestors)
                        resolved += 1
                    else:
                        failed += 1
        return {"resolved": resolved, "skipped": skipped, "failed": failed}
