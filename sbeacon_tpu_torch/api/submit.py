"""Dataset submission: POST/PATCH /submit.

The reference's submitDataset lambda (reference: lambda/submitDataset/
lambda_function.py:191-261 submit_dataset/update_dataset + :79-188
create_dataset): validate against a JSON Schema, verify every VCF is
reachable and indexed, write the dataset + chromosome map, fan the metadata
entities out to the store, and optionally kick the indexer. Here the
summarisation pipeline hook replaces the commented-out SNS kick
(reference :216-218 — wired unconditionally, as SURVEY.md directs).

Counterpart of ``sbeacon_tpu/api/submit.py``, copied whole but for the
schema check: the JAX package validates with ``jsonschema``'s
``Draft7Validator``, which the port does not import (the GPU host has
none); ``api.requests._schema_errors`` checks the same schemas with
jsonschema 4.x's messages, and the errors are ordered as there (sorted
by path, schema order within a path, the first five joined by "; ").
"""

from __future__ import annotations

from ..metadata import ENTITY_KINDS  # noqa: F401  (re-export convenience)
from .requests import RequestError, _schema_errors

_ENTITY_ARRAY = {"type": "array", "items": {"type": "object"}}

# compact schema with the same required surface as the reference's
# submitDataset-schema-new.json / -update.json pair
SUBMIT_SCHEMA_NEW = {
    "type": "object",
    "properties": {
        "datasetId": {"type": "string", "minLength": 1},
        "assemblyId": {"type": "string", "minLength": 1},
        "vcfLocations": {
            "type": "array",
            "items": {"type": "string", "minLength": 1},
        },
        "vcfGroups": {
            "type": "array",
            "items": {"type": "array", "items": {"type": "string"}},
        },
        "dataset": {"type": "object"},
        "cohortId": {"type": "string"},
        "cohort": {"type": "object"},
        "individuals": _ENTITY_ARRAY,
        "biosamples": _ENTITY_ARRAY,
        "runs": _ENTITY_ARRAY,
        "analyses": _ENTITY_ARRAY,
        "index": {"type": "boolean"},
    },
    "required": ["datasetId", "assemblyId", "vcfLocations", "dataset"],
    "additionalProperties": False,
}

SUBMIT_SCHEMA_UPDATE = {
    **SUBMIT_SCHEMA_NEW,
    "required": ["datasetId"],
}


def _raise_schema_errors(schema: dict, body: dict) -> None:
    errors = sorted(_schema_errors(schema, body, ()), key=lambda e: list(e[0]))
    if errors:
        raise RequestError("; ".join(message for _, message in errors[:5]))


def validate_submission(body: dict, *, update: bool) -> None:
    _raise_schema_errors(
        SUBMIT_SCHEMA_UPDATE if update else SUBMIT_SCHEMA_NEW, body
    )


PAYLOAD_REF_SCHEMA = {
    "type": "object",
    "properties": {"payloadRef": {"type": "string", "minLength": 1}},
    "required": ["payloadRef"],
    "additionalProperties": False,
}

#: ceiling for dereferenced submission payloads (a wrong/hostile ref must
#: not OOM the server); generous vs the reference's motivating limit (API
#: Gateway's ~10 MB request cap is WHY s3Payload exists)
MAX_PAYLOAD_REF_BYTES = 512 * 1024 * 1024


def resolve_payload_ref(body: dict) -> dict:
    """``{"payloadRef": "<file path or URL>"}`` -> the real submission.

    The reference accepts ``s3Payload`` bodies pointing at an S3 object so
    submissions can exceed the API gateway's request-size cap (reference:
    submitDataset/lambda_function.py:278-282). The equivalent here is a
    local path or object-store URL (http(s)/s3 via the ``io`` sources)
    holding the JSON document."""
    import json

    from ..io import is_remote, open_source

    ref = body["payloadRef"]
    try:
        # remote refs get a hard byte budget BEFORE any body is read — a
        # hostile Range-less server must not stream past the cap
        src = (
            open_source(ref, max_object_bytes=MAX_PAYLOAD_REF_BYTES)
            if is_remote(ref)
            else open_source(ref)
        )
        n = src.size()
        if n > MAX_PAYLOAD_REF_BYTES:
            raise RequestError(
                f"payloadRef object is {n} bytes "
                f"(limit {MAX_PAYLOAD_REF_BYTES})"
            )
        raw = src.read_range(0, n, workers=4)
    except RequestError:
        raise
    except Exception as e:
        raise RequestError(f"could not read payloadRef {ref}: {e}")
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise RequestError(f"payloadRef {ref} is not valid JSON: {e}")
    if not isinstance(doc, dict):
        raise RequestError(f"payloadRef {ref} must hold a JSON object")
    if "payloadRef" in doc:
        raise RequestError("payloadRef must not nest another payloadRef")
    return doc


def submit_dataset(
    app,
    body: dict,
    *,
    update: bool = False,
) -> dict:
    """Validate and ingest one submission; returns the progress summary."""
    if not isinstance(body, dict):
        raise RequestError("body must be a JSON object")
    if "payloadRef" in body:
        # large-body indirection (the reference's s3Payload form): the
        # inline body is only the pointer; the real submission is
        # fetched, then validated exactly like an inline one
        ref_errors = list(_schema_errors(PAYLOAD_REF_SCHEMA, body, ()))
        if ref_errors:
            raise RequestError(
                "; ".join(message for _, message in ref_errors[:5])
            )
        body = resolve_payload_ref(body)
    validate_submission(body, update=update)

    dataset_id = body["datasetId"]
    cohort_id = body.get("cohortId")
    completed: list[str] = []
    pending: list[str] = []

    existing = app.store.get_by_id("datasets", dataset_id) if update else None

    vcf_locations = body.get("vcfLocations", [])
    # VCF reachability + chromosome map (reference check_vcf_locations
    # :48-76 + get_vcf_chromosomes); delegated to the ingestion layer so
    # the API has no direct file-format knowledge
    chrom_map = []
    if vcf_locations:
        chrom_map = app.ingest.check_vcf_locations(vcf_locations)
        completed.append("Verified VCF locations")
    elif existing:
        # PATCH without vcfLocations keeps the registered VCFs
        vcf_locations = existing.get("_vcfLocations", [])
        chrom_map = existing.get("_vcfChromosomeMap", [])

    groups_given = body.get("vcfGroups")
    if groups_given is not None:
        # an explicit grouping must partition vcfLocations exactly —
        # a spelling mismatch or omission would silently skew sampleCount
        flat = [str(v) for grp in groups_given for v in grp]
        if sorted(flat) != sorted(str(v) for v in vcf_locations):
            raise RequestError(
                "vcfGroups must partition vcfLocations exactly "
                "(every VCF in exactly one group, same spelling)"
            )

    if body.get("dataset") is not None or (
        existing and (body.get("vcfLocations") or groups_given)
    ):
        # a PATCH carrying only new vcfLocations (or only a corrected
        # vcfGroups) must still land on the stored doc, else it verifies
        # but never persists/summarises
        doc = dict(existing or {})
        doc.update(body.get("dataset") or {})
        doc["id"] = dataset_id
        doc["_assemblyId"] = body.get(
            "assemblyId",
            (existing or {}).get("_assemblyId", "UNKNOWN"),
        )
        doc["_vcfLocations"] = vcf_locations
        # default: one group holding every VCF — all VCFs share one
        # sample cohort unless the submitter says otherwise (reference
        # submitDataset:93 vcfGroups = [vcfLocations]). A stored default
        # (explicit flag unset) is recomputed whenever vcfLocations
        # change; a submitter-specified grouping is kept only while it
        # still matches the locations.
        if groups_given is not None:
            doc["_vcfGroups"] = groups_given
            doc["_vcfGroupsExplicit"] = True
        else:
            stored = (existing or {}).get("_vcfGroups")
            stored_flat = sorted(
                str(v) for grp in (stored or []) for v in grp
            )
            keep = (
                (existing or {}).get("_vcfGroupsExplicit")
                and stored_flat == sorted(str(v) for v in vcf_locations)
            )
            if not keep:
                doc["_vcfGroups"] = [list(vcf_locations)]
                doc["_vcfGroupsExplicit"] = False
        doc["_vcfChromosomeMap"] = chrom_map
        app.store.upsert("datasets", [doc])
        completed.append("Added dataset metadata")

    if cohort_id and body.get("cohort") is not None:
        doc = dict(body["cohort"])
        doc["id"] = cohort_id
        app.store.upsert("cohorts", [doc])
        completed.append("Added cohorts")

    if dataset_id:
        # the reference drops these silently without a cohortId
        # (lambda_function.py:122 gates on both); here a dataset-only
        # submission still lands its entities, with _cohortId left unset
        for kind in ("individuals", "biosamples", "runs", "analyses"):
            docs = body.get(kind, [])
            if not docs:
                continue
            for doc in docs:
                doc["_datasetId"] = dataset_id
                if cohort_id:
                    doc["_cohortId"] = cohort_id
            app.store.upsert(kind, list(docs))
            completed.append(f"Added {kind}")

    if body.get("index", False):
        app.store.rebuild_indexes()
        completed.append("Rebuilt indexes")
        rcfg = app.config.resolvers
        if rcfg.enabled:
            # ontology closure build (the indexer's index_terms_tree,
            # reference indexer:60-222); failures per-term are logged and
            # counted, never fatal to the submission
            from ..metadata.resolvers import (
                OlsResolver,
                OntoserverResolver,
                TermTreeIndexer,
            )

            stats = TermTreeIndexer(
                app.store,
                app.ontology,
                ols=OlsResolver(rcfg.ols_url),
                ontoserver=OntoserverResolver(rcfg.ontoserver_url),
                workers=rcfg.workers,
            ).run()
            completed.append(
                "Resolved ontology closures "
                f"({stats['resolved']} new, {stats['skipped']} cached, "
                f"{stats['failed']} failed)"
            )

    # ingestion pipeline kick (unconditional, unlike the reference's
    # commented-out SNS publish)
    if vcf_locations:
        pending.extend(app.ingest.schedule_summarisation(dataset_id))

    return {"completed": completed, "pending": pending}
