"""Beacon v2 response envelopes.

The three result envelopes (boolean / count / resultSets) plus the error
envelope and the VRS-style variant entry, matching the reference's
apiutils (reference: shared_resources/apiutils/responses.py:145-254
get_boolean_response/get_counts_response/get_result_sets_response,
api_response.py:13-46 bad_request, entries.py:1-24 get_variant_entry).
Envelope shape is the GA4GH Beacon v2 framework response model.

Counterpart of ``sbeacon_tpu/api/envelopes.py``, copied whole.
"""

from __future__ import annotations

from ..config import BeaconInfo

SCHEMA = "https://json-schema.org/draft/2020-12/schema"


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
        default model schema (api/model_schemas.py), so record responses
        reference resolvable documents."""
        from .model_schemas import (
            ENTITY_SCHEMAS,
            PATH_TO_ENTITY,
            schema_url,
        )

        # setType values mix singular/plural (app._SET_TYPE); the path
        # table is the single normalisation source
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

    def filtering_terms(
        self, terms: list[dict], *, skip: int = 0, limit: int = 100
    ) -> dict:
        return {
            "$schema": SCHEMA,
            "info": {},
            "meta": self._meta(
                granularity="record",
                pagination={"skip": skip, "limit": limit},
                schemas=[],
            ),
            "response": {"filteringTerms": terms},
        }

    def error(self, status: int, message: str) -> dict:
        return {
            "$schema": SCHEMA,
            "error": {"errorCode": status, "errorMessage": str(message)},
            "meta": {
                "apiVersion": self.info.api_version,
                "beaconId": self.info.beacon_id,
                "receivedRequestSummary": {},
                "returnedSchemas": [],
            },
        }


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
