"""Variant query orchestration for the API layer.

Counterpart of ``sbeacon_tpu/api/variants.py``, trimmed to the
cross-dataset aggregation (``VariantAggregation``) and
``run_variant_search``: the Beacon aggregation loop over an engine's
per-(dataset, vcf) responses. Dataset resolution through the metadata
store, the async query runner and the explain plane are not ported yet:
the caller passes the resolved dataset list, and the search always runs
directly on the engine.
"""

from __future__ import annotations

import base64

from ..payloads import VariantQueryPayload
from ..utils.chrom import normalize_chromosome
from .envelopes import variant_entry
from .requests import BeaconRequest, RequestError


class VariantAggregation:
    """The cross-dataset aggregation accumulator of route_g_variants."""

    def __init__(self, assembly_id: str):
        self.assembly_id = assembly_id
        self.exists = False
        self.variants: set[str] = set()
        self.results: list[dict] = []
        self._found: set[str] = set()
        # sample hits per dataset (used by /g_variants/{id}/{entity} routes)
        self.sample_names_by_dataset: dict[str, list[str]] = {}

    def add(self, responses, *, granularity: str, check_all: bool) -> None:
        for qr in responses:
            self.exists = self.exists or qr.exists
            if not self.exists:
                continue
            if granularity == "boolean":
                return
            if qr.sample_names:
                seen = self.sample_names_by_dataset.setdefault(
                    qr.dataset_id, []
                )
                seen_set = set(seen)
                seen.extend(
                    s for s in qr.sample_names if s not in seen_set
                )
            if not check_all:
                continue
            self.variants.update(qr.variants)
            for variant in qr.variants:
                chrom, pos, ref, alt, typ = variant.split("\t")
                internal_id = f"{self.assembly_id}\t{chrom}\t{pos}\t{ref}\t{alt}"
                if internal_id not in self._found:
                    self._found.add(internal_id)
                    self.results.append(
                        variant_entry(
                            base64.b64encode(internal_id.encode()).decode(),
                            self.assembly_id,
                            ref,
                            alt,
                            int(pos),
                            int(pos) + len(alt),
                            typ,
                        )
                    )


def run_variant_search(
    engine,
    datasets: list[dict],
    req: BeaconRequest,
    *,
    start_min: int,
    start_max: int,
    end_min: int,
    end_max: int,
    reference_name: str | None = None,
    reference_bases: str | None = None,
    alternate_bases: str | None = None,
    variant_type: str | None = None,
    samples_by_dataset: dict[str, list[str]] | None = None,
    include_resultset_responses: str | None = None,
) -> VariantAggregation:
    """Dispatch one search over the resolved datasets and aggregate
    (a direct engine call)."""
    reference_name = (
        reference_name if reference_name is not None else req.reference_name
    )
    if reference_name is None:
        raise RequestError("referenceName must be specified")
    include = (
        include_resultset_responses
        if include_resultset_responses is not None
        else req.include_resultset_responses
    )
    check_all = include in ("HIT", "ALL")
    samples_by_dataset = samples_by_dataset or {}
    # selected-samples mode iff every dataset came with samples
    # (reference search_variants.py:88-91 gates per dataset on
    # len(dataset_samples) == len(datasets))
    selected = bool(samples_by_dataset) and all(
        samples_by_dataset.get(d["id"]) for d in datasets
    )
    payload = VariantQueryPayload(
        dataset_ids=[d["id"] for d in datasets],
        reference_name=normalize_chromosome(reference_name),
        reference_bases=(
            reference_bases
            if reference_bases is not None
            else req.reference_bases
        ),
        alternate_bases=(
            alternate_bases
            if alternate_bases is not None
            else req.alternate_bases
        ),
        start_min=start_min,
        start_max=start_max,
        end_min=end_min,
        end_max=end_max,
        variant_type=(
            variant_type if variant_type is not None else req.variant_type
        ),
        variant_min_length=req.variant_min_length,
        variant_max_length=req.variant_max_length,
        requested_granularity=req.granularity,
        include_datasets=include,
        include_samples=True,
        sample_names=samples_by_dataset if selected else {},
        selected_samples_only=selected,
    )
    responses = engine.search(payload)
    agg = VariantAggregation(req.assembly_id or "")
    agg.add(
        responses,
        granularity=req.granularity,
        check_all=check_all,
    )
    return agg
