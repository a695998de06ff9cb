"""Typed query/response contracts.

Counterpart of ``sbeacon_tpu/payloads.py``, trimmed to the variant
search payload and its per-(dataset, vcf) response. Field names, order
and defaults are the JAX package's, so ``dataclasses.asdict`` of a
response compares equal across the two packages.
"""

from __future__ import annotations

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
