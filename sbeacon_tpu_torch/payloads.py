"""Typed query/response contracts.

Counterpart of ``sbeacon_tpu/payloads.py``: the variant search payload
(with its wire form, ``payloads.py:58-92`` there: the body a fleet
coordinator POSTs to a worker's ``/search``), its per-(dataset, vcf)
response (with the response's JSON form, in which the query job table
stores it) and the ingest slice-scan job a coordinator POSTs to a
worker's ``/scan`` (``SliceScanPayload``, ``:122-144`` there). Field names, order and defaults are the
JAX package's, so ``dataclasses.asdict`` of a response compares equal
across the two packages and either package's worker answers the
other's coordinator.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class VariantQueryPayload:
    """One variant search against one-or-more datasets.

    Coordinates are **1-based inclusive**, already converted from Beacon's
    0-based request form (the +1 dance at reference variantutils/
    search_variants.py:65-68 happens in the API layer before this payload is
    built).
    """

    dataset_ids: list[str] = field(default_factory=list)
    reference_name: str = ""  # canonical chromosome, e.g. "22"
    reference_bases: str | None = None
    alternate_bases: str | None = None
    start_min: int = 0
    start_max: int = 0
    end_min: int = 0
    end_max: int = 0
    variant_type: str | None = None
    variant_min_length: int = 0
    variant_max_length: int = -1  # -1 = unbounded
    requested_granularity: str = "boolean"
    include_datasets: str = "NONE"  # NONE/HIT/MISS/ALL
    include_samples: bool = False
    sample_names: dict[str, list[str]] = field(default_factory=dict)
    # restrict to these samples per dataset (selected-samples path)
    selected_samples_only: bool = False
    # bypass the response cache: known-answer canary probes
    # must observe the LIVE data plane — a warm cached answer would
    # mask exactly the silent corruption they exist to catch. Normal
    # traffic never sets this.
    no_response_cache: bool = False
    query_id: str = "TEST"

    @property
    def include_details(self) -> bool:
        # reference splitQuery: check_all = include_datasets in (HIT, ALL)
        return self.include_datasets in ("HIT", "ALL")

    def dumps(self) -> str:
        d = dataclasses.asdict(self)
        # wire compat: the probe-only flag rides the wire ONLY when set,
        # so a worker that predates it keeps parsing every other body
        if not d.get("no_response_cache"):
            d.pop("no_response_cache", None)
        return json.dumps(d)

    @staticmethod
    def from_doc(doc: dict) -> "VariantQueryPayload":
        """Build from a wire dict, DROPPING unknown keys: a worker keeps
        answering a coordinator one payload field ahead of it. A
        non-empty doc with no known field at all is malformed, not
        newer, and raises."""
        known = {f.name for f in dataclasses.fields(VariantQueryPayload)}
        kept = {k: v for k, v in doc.items() if k in known}
        if doc and not kept:
            raise ValueError(
                "payload has no known fields: " + ", ".join(sorted(doc))
            )
        return VariantQueryPayload(**kept)

    @staticmethod
    def loads(s: str) -> "VariantQueryPayload":
        return VariantQueryPayload.from_doc(json.loads(s))


@dataclass
class VariantSearchResponse:
    """Per-(dataset, vcf) search result.

    Field-compatible with the reference's PerformQueryResponse
    (lambda_responses.py:15-24): ``variants`` entries are the same
    tab-joined '{chrom}\\t{pos}\\t{ref}\\t{alt}\\t{vt}' strings the route
    aggregation layer parses back (reference: getGenomicVariants/
    route_g_variants.py:162-171).
    """

    dataset_id: str = ""
    vcf_location: str = ""
    exists: bool = False
    all_alleles_count: int = 0
    call_count: int = 0
    variants: list[str] = field(default_factory=list)
    sample_indices: list[int] = field(default_factory=list)
    sample_names: list[str] = field(default_factory=list)

    def dumps(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def loads(s: str) -> "VariantSearchResponse":
        return VariantSearchResponse(**json.loads(s))


@dataclass
class SliceScanPayload:
    """One ingest slice-scan job for a remote worker: the worker
    range-reads ``[vstart, vend)`` of ``vcf_location`` (a shared path or
    an object-store URL), builds the slice's index shard, and returns it
    as one npz blob (``index.columnar.dumps_index``)."""

    dataset_id: str = ""
    vcf_location: str = ""
    vstart: int = 0
    vend: int = 0
    sample_names: list[str] = field(default_factory=list)

    def dumps(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def loads(s: str) -> "SliceScanPayload":
        return SliceScanPayload(**json.loads(s))
