"""Variant query orchestration for the API layer.

Counterpart of ``sbeacon_tpu/api/variants.py``: dataset
resolution through the metadata store (``resolve_datasets``: a filter
switches the search into selected-samples mode), the variant id codec
(``encode_internal_id`` / ``decode_internal_id``), the cross-dataset
aggregation (``VariantAggregation``) and ``run_variant_search``, which
runs the search through the async query runner when one is given (its
job table coalesces identical queries and caches their results) or
directly on the engine; an explained request (``?explain=1``) runs
live on the engine, past both caches.
"""

from __future__ import annotations

import base64
import dataclasses

from ..metadata.filters import entity_search_conditions
from ..payloads import VariantQueryPayload
from ..plan import explain_active
from ..utils.chrom import normalize_chromosome
from .envelopes import variant_entry
from .requests import BeaconRequest, RequestError


def resolve_datasets(
    store,
    ontology,
    assembly_id: str | None,
    filters: list[dict],
    *,
    dataset_ids: list[str] | None = None,
):
    """(dataset_docs, samples_by_dataset) for a variant query.

    With filters the analyses are joined to their datasets and
    ``_vcfsampleid`` is aggregated per dataset, which switches the
    search into selected-samples mode; without filters it is a plain
    assembly scan.
    """
    if assembly_id is None:
        raise RequestError("assemblyId must be specified")
    samples_by_dataset: dict[str, list[str]] = {}
    if filters:
        conditions, params = entity_search_conditions(
            filters, "analyses", "analyses", ontology=ontology, id_modifier="A.id"
        )
        rows = store.query(
            f"SELECT A._datasetid, A._vcfsampleid FROM analyses A "
            f"{conditions}",
            params,
        )
        for ds, sample in rows:
            samples_by_dataset.setdefault(ds, [])
            if sample:
                samples_by_dataset[ds].append(sample)
        ids = sorted(samples_by_dataset)
        if dataset_ids:
            allowed = set(dataset_ids)
            ids = [i for i in ids if i in allowed]
        if not ids:
            return [], {}
        datasets = store.datasets_for_assembly(assembly_id, dataset_ids=ids)
    else:
        datasets = store.datasets_for_assembly(
            assembly_id, dataset_ids=dataset_ids
        )
    return datasets, samples_by_dataset


def encode_internal_id(
    assembly_id: str, chrom: str, pos: str | int, ref: str, alt: str
) -> str:
    internal = f"{assembly_id}\t{chrom}\t{pos}\t{ref}\t{alt}"
    return base64.b64encode(internal.encode()).decode()


def decode_internal_id(variant_id: str) -> tuple[str, str, int, str, str]:
    """(assembly, chrom, pos0, ref, alt); pos0 already 0-based."""
    try:
        decoded = base64.b64decode(variant_id.encode()).decode()
        assembly, chrom, pos, ref, alt = decoded.split("\t")
        return assembly, chrom, int(pos) - 1, ref, alt
    except Exception:
        raise RequestError(f"malformed variant id {variant_id!r}") from None


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
    runner=None,
) -> VariantAggregation:
    """Dispatch one search over the resolved datasets and aggregate.

    With ``runner`` (an ``AsyncQueryRunner``) the search goes through the
    query job table: concurrent identical queries coalesce onto one
    execution and completed results are served from the TTL'd cache.
    Without it, a direct engine call."""
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
    if explain_active():
        # an explained request must describe a LIVE execution of
        # exactly this query: never served from (or written to) the
        # response cache, and never coalesced onto a query job whose
        # plan belongs to some earlier request
        payload = dataclasses.replace(payload, no_response_cache=True)
        runner = None
    if runner is not None:
        from ..query_jobs import JobStatus
        from ..resilience import current_deadline

        query_id, _ = runner.submit(
            payload, fingerprint=engine.index_fingerprint()
        )
        responses = runner.result(
            query_id, wait_s=engine.config.engine.request_timeout_s
        )
        if responses is None:
            # the result wait is deadline-clamped: distinguish "the
            # request ran out of time" (504, retryable with a longer
            # deadline) from "the engine exceeded request_timeout_s"
            current_deadline().check("variant query")
            if runner.poll(query_id) is JobStatus.RUNNING:
                # still executing past request_timeout_s: a second
                # identical search would double device load exactly when
                # the engine is slowest — report the timeout instead
                raise TimeoutError(
                    f"variant query {query_id} timed out after "
                    f"{engine.config.engine.request_timeout_s}s"
                )
            # job abandoned (its search failed): run directly so the
            # real error surfaces to this caller
            responses = engine.search(payload)
    else:
        responses = engine.search(payload)
    agg = VariantAggregation(req.assembly_id or "")
    agg.add(
        responses,
        granularity=req.granularity,
        check_all=check_all,
    )
    return agg
