"""Fingerprint-keyed response cache in front of ``VariantEngine.search``.

Counterpart of ``sbeacon_tpu/response_cache.py``, copied whole (it is
stdlib only): ``ResponseCache``, ``response_cache_key``,
``response_cache_scope``, ``copy_response`` and
``register_cache_metrics``. A repeated query (same normalized spec, same
response-shaping fields, same loaded index set) is answered from host
memory with no device launch. Keys are equal tuples in both packages
for the same engine state and payload.

Correctness model:

- The key embeds the engine's per-dataset fingerprint components
  (``engine.cache_fingerprint(dataset_ids)``): a base publish of a
  dataset the query touches changes the key. Delta publishes do not
  change it; freshness is kept by scoped invalidation instead: a delta
  publish calls :meth:`ResponseCache.invalidate_scope` with the new
  rows' dataset and coordinate envelope, evicting exactly the entries
  whose dataset set AND region overlap. A cached negative dies the
  moment an overlapping variant arrives.
- Entries are stored AND returned as copies: neither a caller mutating
  its response nor a later hit can corrupt the cached value.
- Negative entries are first-class: a query matching nothing caches its
  response set like any other.
- Publish/put races cannot resurrect stale data: ``put`` takes the
  invalidation generation observed before the search executed and
  re-checks it against the ring of invalidations that landed since.

Bounded by ``max_entries`` (LRU eviction) and ``ttl_s`` (per-entry
expiry; 0 disables).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque

from .payloads import VariantQueryPayload, VariantSearchResponse
from .telemetry import charge_cost, publish_event


def copy_response(r: VariantSearchResponse) -> VariantSearchResponse:
    """A safe-to-mutate copy (fresh list objects, shared strings)."""
    return dataclasses.replace(
        r,
        variants=list(r.variants),
        sample_indices=list(r.sample_indices),
        sample_names=list(r.sample_names),
    )


def response_cache_key(
    fingerprint: str, payload: VariantQueryPayload
) -> tuple:
    """Hashable cache key: index identity + the normalized QuerySpec
    fields + every response-shaping field.

    Normalization mirrors the matcher's semantics — allele compares are
    case-insensitive (``engine._blob_eq`` uppercases both sides), so
    ``refA``/``REFA`` must share an entry; dataset order is irrelevant
    to the response SET, so ids sort. ``query_id`` is correctly absent:
    it names the request, not the answer.
    """
    ref = payload.reference_bases
    alt = payload.alternate_bases
    return (
        fingerprint,
        # -- normalized QuerySpec ------------------------------------
        payload.reference_name,
        payload.start_min,
        payload.start_max,
        payload.end_min,
        payload.end_max,
        None if ref is None else ref.upper(),
        None if alt is None else alt.upper(),
        payload.variant_type,
        payload.variant_min_length,
        payload.variant_max_length,
        # -- response shaping ----------------------------------------
        tuple(sorted(payload.dataset_ids)),
        payload.requested_granularity,
        payload.include_datasets,
        payload.include_samples,
        payload.selected_samples_only,
        tuple(
            (ds, tuple(sorted(names)))
            for ds, names in sorted(payload.sample_names.items())
        ),
    )


def response_cache_scope(payload: VariantQueryPayload) -> tuple:
    """The entry's invalidation scope: ``(dataset_set|None, chrom,
    (lo, hi))``. ``None`` datasets means the query ranged over every
    loaded dataset (overlaps any publish). The coordinate span is the
    query's full bracket envelope — conservatively wide, so a publish
    that could possibly change the answer always overlaps it."""
    ds = frozenset(payload.dataset_ids) if payload.dataset_ids else None
    lo = min(payload.start_min, payload.end_min)
    hi = max(payload.start_max, payload.end_max)
    return (ds, payload.reference_name, (int(lo), int(hi)))


def _scopes_overlap(entry_scope: tuple, inv_scope: tuple) -> bool:
    """Could rows described by ``inv_scope`` change the answer cached
    under ``entry_scope``? Conservative in every unknown direction —
    a missing chrom/span/dataset component means "overlaps"."""
    e_ds, e_chrom, e_span = entry_scope
    i_ds, i_chrom, i_span = inv_scope
    if e_ds is not None and i_ds is not None and not (e_ds & i_ds):
        return False
    if e_chrom and i_chrom and e_chrom != i_chrom:
        return False
    if e_span and i_span and (
        e_span[1] < i_span[0] or i_span[1] < e_span[0]
    ):
        return False
    return True


class ResponseCache:
    """Thread-safe LRU with TTL, scoped invalidation and counters."""

    #: scoped invalidations remembered for the put-race check — a put
    #: whose pre-search generation fell off this window is dropped
    #: conservatively rather than risked
    INVALIDATION_RING = 256

    def __init__(self, max_entries: int = 4096, ttl_s: float = 300.0):
        self.max_entries = max(1, int(max_entries))
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        # key -> (t_put, responses, scope)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._expirations = 0
        self._invalidations = 0
        self._scoped_invalidations = 0
        self._negative_hits = 0
        # monotonically increasing invalidation generation + the recent
        # scoped invalidations (seq, scope) for the put-race check
        self._gen = 0
        self._recent_inv: deque = deque(maxlen=self.INVALIDATION_RING)

    def generation(self) -> int:
        """The invalidation generation — capture BEFORE executing a
        search and pass to :meth:`put` so a publish that landed while
        the search ran cannot be outrun by a stale store."""
        with self._lock:
            return self._gen

    def get(self, key: tuple) -> list[VariantSearchResponse] | None:
        """Cached response set (fresh copies) or None. The outcome is
        stamped onto the ambient request's cost vector — a tenant
        whose traffic always hits costs near-nothing, and the
        accounting plane can show exactly that."""
        now = time.monotonic()
        with self._lock:
            item = self._entries.get(key)
            if item is None:
                self._misses += 1
                outcome = "miss"
                hit = None
            else:
                t_put, responses, _scope = item
                if self.ttl_s > 0 and (now - t_put) > self.ttl_s:
                    del self._entries[key]
                    self._expirations += 1
                    self._misses += 1
                    outcome = "miss"
                    hit = None
                else:
                    self._entries.move_to_end(key)
                    self._hits += 1
                    if not any(r.exists for r in responses):
                        self._negative_hits += 1
                        outcome = "negative_hit"
                    else:
                        outcome = "hit"
                    hit = [copy_response(r) for r in responses]
        charge_cost(cache=outcome)
        return hit

    def put(
        self,
        key: tuple,
        responses: list[VariantSearchResponse],
        *,
        scope: tuple | None = None,
        gen: int | None = None,
    ) -> bool:
        """Store one entry; returns False when the store was refused
        because an invalidation overlapping ``scope`` landed after
        ``gen`` (the entry would be stale-at-birth)."""
        value = (
            time.monotonic(),
            [copy_response(r) for r in responses],
            scope,
        )
        with self._lock:
            if gen is not None and gen < self._gen:
                # invalidations landed while the search ran: admit the
                # entry only if EVERY one since ``gen`` provably misses
                # its scope; a generation older than the ring window
                # cannot be checked, so it drops conservatively
                if self._recent_inv and self._recent_inv[0][0] > gen + 1:
                    return False
                newer = [s for q, s in self._recent_inv if q > gen]
                if len(newer) < self._gen - gen:
                    return False  # some invalidation rolled off the ring
                for inv_scope in newer:
                    if (
                        scope is None
                        or inv_scope is None
                        or _scopes_overlap(scope, inv_scope)
                    ):
                        return False
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self._evictions += 1
        return True

    def invalidate(self) -> None:
        """Drop everything (index set changed wholesale: the
        fingerprint in the key already makes old entries unreachable,
        this frees them — and bumps the generation so racing puts of
        pre-publish results are refused)."""
        with self._lock:
            dropped = len(self._entries)
            self._entries.clear()
            self._invalidations += 1
            self._gen += 1
            self._recent_inv.append((self._gen, None))
        publish_event("response_cache.invalidated", entries=dropped)

    def invalidate_scope(
        self,
        dataset_ids,
        reference_name: str | None,
        span: tuple | None,
    ) -> int:
        """Evict only entries whose dataset set AND coordinate bracket
        overlap the published rows; returns the evicted count. A None
        ``reference_name``/``span`` means "every region" (base
        republish); ``dataset_ids`` empty/None means "every dataset".
        The critical correctness case is the cached negative: a "no"
        for a bracket the new variant lands in MUST die here."""
        inv_scope = (
            frozenset(dataset_ids) if dataset_ids else None,
            reference_name,
            (int(span[0]), int(span[1])) if span else None,
        )
        with self._lock:
            doomed = [
                k
                for k, (_t, _r, scope) in self._entries.items()
                if scope is None or _scopes_overlap(scope, inv_scope)
            ]
            for k in doomed:
                del self._entries[k]
            self._invalidations += 1
            self._scoped_invalidations += 1
            self._gen += 1
            self._recent_inv.append((self._gen, inv_scope))
        publish_event(
            "response_cache.invalidated",
            entries=len(doomed),
            scoped=True,
            datasets=sorted(dataset_ids) if dataset_ids else [],
            referenceName=reference_name or "",
        )
        return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            lookups = self._hits + self._misses
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "ttl_s": self.ttl_s,
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate": (
                    round(self._hits / lookups, 4) if lookups else 0.0
                ),
                "negative_hits": self._negative_hits,
                "evictions": self._evictions,
                "expirations": self._expirations,
                "invalidations": self._invalidations,
                "scoped_invalidations": self._scoped_invalidations,
            }


def register_cache_metrics(registry, supplier) -> None:
    """Typed instruments over a ResponseCache. ``supplier`` returns the
    cache or None (disabled) — disabled caches render zeros so the
    series stay stable for dashboards."""

    def field(name):
        def collect():
            cache = supplier()
            return 0 if cache is None else cache.stats()[name]

        return collect

    registry.gauge("response_cache.entries", fn=field("entries"))
    registry.gauge("response_cache.max_entries", fn=field("max_entries"))
    registry.gauge("response_cache.ttl_s", fn=field("ttl_s"))
    registry.gauge("response_cache.hit_rate", fn=field("hit_rate"))
    registry.counter("response_cache.hits", fn=field("hits"))
    registry.counter("response_cache.misses", fn=field("misses"))
    registry.counter(
        "response_cache.negative_hits", fn=field("negative_hits")
    )
    registry.counter("response_cache.evictions", fn=field("evictions"))
    registry.counter("response_cache.expirations", fn=field("expirations"))
    registry.counter(
        "response_cache.invalidations", fn=field("invalidations")
    )
    registry.counter(
        "response_cache.scoped_invalidations",
        fn=field("scoped_invalidations"),
    )
