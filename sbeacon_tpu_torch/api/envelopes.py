"""Beacon v2 response envelopes.

The three result envelopes (boolean / count / resultSets) plus the error
envelope and the VRS-style variant entry, matching the reference's
apiutils (reference: shared_resources/apiutils/responses.py:145-254
get_boolean_response/get_counts_response/get_result_sets_response,
api_response.py:13-46 bad_request, entries.py:1-24 get_variant_entry).
Envelope shape is the GA4GH Beacon v2 framework response model.

Counterpart of ``sbeacon_tpu/api/envelopes.py``; the per-entity model
schema table it points record responses at is the JAX package's
``api/model_schemas.py``, of which only the entity names and the URL
form are needed here.
"""

from __future__ import annotations

from ..config import BeaconInfo

SCHEMA = "https://json-schema.org/draft/2020-12/schema"

#: the entities with a served default model schema
ENTITY_SCHEMAS = (
    "dataset",
    "cohort",
    "individual",
    "biosample",
    "run",
    "analysis",
    "genomicVariant",
)
PATH_TO_ENTITY = {
    "datasets": "dataset",
    "cohorts": "cohort",
    "individuals": "individual",
    "biosamples": "biosample",
    "runs": "run",
    "analyses": "analysis",
    "g_variants": "genomicVariant",
}


def schema_url(base_uri: str, entity: str) -> str:
    return f"{base_uri.rstrip('/')}/schemas/{entity}"


class Envelopes:
    """Envelope factory bound to one beacon identity."""

    def __init__(self, info: BeaconInfo):
        self.info = info

    def _meta(
        self,
        *,
        granularity: str,
        req_granularity: str | None = None,
        pagination: dict | None = None,
        schemas: list | None = None,
    ) -> dict:
        return {
            "beaconId": self.info.beacon_id,
            "apiVersion": self.info.api_version,
            "returnedSchemas": (
                schemas
                if schemas is not None
                else [{"entityType": "info", "schema": "beacon-map-v2.0.0"}]
            ),
            "returnedGranularity": granularity,
            "receivedRequestSummary": {
                "apiVersion": self.info.api_version,
                "requestedSchemas": [],
                "pagination": pagination or {},
                "requestedGranularity": req_granularity or granularity,
            },
        }

    def boolean(self, *, exists: bool, info: dict | None = None) -> dict:
        return {
            "$schema": SCHEMA,
            "info": info or {},
            "meta": self._meta(granularity="boolean"),
            "responseSummary": {"exists": bool(exists)},
        }

    def count(
        self, *, exists: bool, count: int, info: dict | None = None
    ) -> dict:
        return {
            "$schema": SCHEMA,
            "info": info or {},
            "meta": self._meta(granularity="count"),
            "responseSummary": {
                "exists": bool(exists),
                "numTotalResults": int(count),
            },
        }

    def _entity_schemas(self, set_type: str) -> list | None:
        """returnedSchemas entries pointing at the served per-entity
        default model schema, so record responses reference resolvable
        documents."""
        # setType values mix singular/plural; the path table is the
        # single normalisation source
        entity = PATH_TO_ENTITY.get(set_type, set_type)
        if entity not in ENTITY_SCHEMAS:
            return None
        return [
            {
                "entityType": entity,
                "schema": schema_url(self.info.uri, entity),
            }
        ]

    def result_sets(
        self,
        *,
        results: list,
        set_type: str,
        exists: bool | None = None,
        total: int | None = None,
        skip: int = 0,
        limit: int = 100,
        info: dict | None = None,
    ) -> dict:
        if exists is None:
            exists = len(results) > 0
        if total is None:
            total = len(results)
        return {
            "$schema": SCHEMA,
            "info": info or {},
            "meta": self._meta(
                granularity="record",
                pagination={"skip": skip, "limit": limit},
                schemas=self._entity_schemas(set_type),
            ),
            "response": {
                "resultSets": [
                    {
                        "exists": len(results) > 0,
                        "id": "redacted",
                        "results": results,
                        "resultsCount": len(results),
                        "resultsHandovers": [],
                        "setType": set_type,
                    }
                ]
            },
            "responseSummary": {
                "exists": bool(exists),
                "numTotalResults": int(total),
            },
        }

    def by_granularity(
        self,
        granularity: str,
        *,
        exists: bool,
        count: int = 0,
        results: list | None = None,
        set_type: str = "",
        skip: int = 0,
        limit: int = 100,
    ) -> dict:
        """Dispatch on requestedGranularity the way every reference route
        does (boolean -> exists, count -> numTotalResults,
        record/aggregated -> resultSets)."""
        if granularity == "boolean":
            return self.boolean(exists=exists)
        if granularity == "count":
            return self.count(exists=exists, count=count)
        return self.result_sets(
            results=results or [],
            set_type=set_type,
            exists=exists,
            total=count,
            skip=skip,
            limit=limit,
        )


def variant_entry(
    internal_id: str,
    seq_id: str,
    ref: str,
    alt: str,
    start: int,
    end: int,
    typ: str | None,
) -> dict:
    """VRS-ish genomicVariant entry (reference entries.py:1-24)."""
    return {
        "variantInternalId": internal_id,
        "variation": {
            "referenceBases": ref,
            "alternateBases": alt,
            "location": {
                "interval": {
                    "start": {"type": "Number", "value": start},
                    "end": {"type": "Number", "value": end},
                    "type": "SequenceInterval",
                },
                "sequence_id": seq_id,
                "type": "SequenceLocation",
            },
            "variantType": typ,
        },
    }
