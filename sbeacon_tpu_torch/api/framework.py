"""Beacon v2 framework endpoints: /info, /configuration, /map, /entry_types.

Counterpart of ``sbeacon_tpu/api/framework.py``, copied whole.

The reference serves these as four lambdas of hand-written model JSON
(reference: lambda/getInfo/lambda_function.py:20-57, getConfiguration,
getMap/lambda_function.py, getEntryTypes). Here the Beacon v2 default-model
entry-type descriptors are generated from one compact table so the four
documents stay mutually consistent and the beacon identity comes from the
typed config instead of env vars.
"""

from __future__ import annotations

from datetime import datetime, timezone

from ..config import BeaconInfo
from .envelopes import SCHEMA

_MODEL_URL = (
    "https://github.com/ga4gh-beacon/beacon-v2/blob/main/models/json/"
    "beacon-v2-default-model"
)

# entry type id -> (name, plural path part, description, ontology id, label)
ENTRY_TYPES: dict[str, dict] = {
    "analysis": {
        "name": "Bioinformatics analysis",
        "path": "analyses",
        "description": (
            "Apply analytical methods to existing data of a specific type."
        ),
        "ontology": ("edam:operation_2945", "Analysis"),
    },
    "biosample": {
        "name": "Biological Sample",
        "path": "biosamples",
        "description": (
            "Any material sample taken from a biological entity for testing, "
            "diagnostic, propagation, treatment or research purposes."
        ),
        "ontology": ("NCIT:C70699", "Biospecimen"),
    },
    "cohort": {
        "name": "Cohort",
        "path": "cohorts",
        "description": (
            "A group of individuals, identified by a common characteristic."
        ),
        "ontology": ("NCIT:C61512", "Cohort"),
        "collection_of": [{"id": "individual", "name": "Individuals"}],
    },
    "dataset": {
        "name": "Dataset",
        "path": "datasets",
        "description": (
            "A data collection with some shared context: provenance, "
            "granted access, or contained data types."
        ),
        "ontology": ("NCIT:C47824", "Data set"),
        "collection_of": [{"id": "genomicVariant", "name": "Genomic Variants"}],
    },
    "genomicVariant": {
        "name": "Genomic Variants",
        "path": "g_variants",
        "description": "The location of a sequence.",
        "ontology": ("ENSGLOSSARY:0000092", "Variant"),
    },
    "individual": {
        "name": "Individual",
        "path": "individuals",
        "description": "A human being.",
        "ontology": ("NCIT:C25190", "Person"),
    },
    "run": {
        "name": "Sequencing run",
        "path": "runs",
        "description": (
            "The valid and completed operation of a high-throughput "
            "sequencing instrument for a single sequencing process."
        ),
        "ontology": ("NCIT:C148088", "Sequencing run"),
    },
}

# per-entry-type sub-endpoints exposed under /{path}/{id}/... — mirrors the
# reference API Gateway resource tree (api-*.tf; SURVEY.md L1 path table)
_SUB_ENDPOINTS: dict[str, list[str]] = {
    "analysis": ["genomicVariant"],
    "biosample": ["analysis", "genomicVariant", "run"],
    "cohort": ["individual"],
    "dataset": ["biosample", "genomicVariant", "individual"],
    "genomicVariant": ["biosample", "individual"],
    "individual": ["biosample", "genomicVariant"],
    "run": ["analysis", "genomicVariant"],
}


def _default_schema(entry_id: str, base_uri: str | None = None) -> dict:
    """Entry-type default schema descriptor pointing at THIS beacon's
    served schema document (/schemas/{entityType} — api/model_schemas.py),
    so returned schema references resolve without reaching external model
    repositories."""
    from .model_schemas import schema_url

    info = ENTRY_TYPES[entry_id]
    return {
        "id": f"ga4gh-beacon-{entry_id.lower()}-v2.0.0",
        "name": f"Default schema for {info['name'].lower()}",
        "referenceToSchemaDefinition": schema_url(
            base_uri or "", entry_id
        ),
        "schemaVersion": "v2.0.0",
    }


def _entry_type_descriptor(entry_id: str, base_uri: str = "") -> dict:
    info = ENTRY_TYPES[entry_id]
    desc = {
        "additionallySupportedSchemas": [],
        "defaultSchema": _default_schema(entry_id, base_uri),
        "description": info["description"],
        "id": entry_id,
        "name": info["name"],
        "ontologyTermForThisType": {
            "id": info["ontology"][0],
            "label": info["ontology"][1],
        },
        "partOfSpecification": "Beacon v2.0.0",
    }
    if "collection_of" in info:
        desc["aCollectionOf"] = info["collection_of"]
    return desc


def _framework_meta(info: BeaconInfo) -> dict:
    return {
        "apiVersion": info.api_version,
        "beaconId": info.beacon_id,
        "returnedSchemas": [
            {"entityType": "info", "schema": "beacon-map-v2.0.0"}
        ],
    }


def info_response(info: BeaconInfo) -> dict:
    """GET / and /info (reference getInfo/lambda_function.py:20-57)."""
    now = datetime.now(timezone.utc).isoformat()
    return {
        "$schema": SCHEMA,
        "info": {},
        "meta": {
            **_framework_meta(info),
            "returnedSchemas": [
                {"entityType": "info", "schema": "beacon-info-v2.0.0"}
            ],
        },
        "response": {
            "alternativeUrl": info.alternative_url,
            "apiVersion": info.api_version,
            "createDateTime": now,
            "description": info.description,
            "environment": info.environment,
            "id": info.beacon_id,
            "info": {},
            "name": info.beacon_name,
            "organization": {
                "address": info.org_address,
                "contactUrl": info.org_contact_url,
                "description": info.org_description,
                "id": info.org_id,
                "info": {},
                "logoUrl": info.org_logo_url,
                "name": info.org_name,
                "welcomeUrl": info.org_welcome_url,
            },
            "updateDateTime": now,
            "version": info.version,
            "welcomeUrl": info.welcome_url,
        },
    }


def entry_types_response(info: BeaconInfo) -> dict:
    """GET /entry_types (reference getEntryTypes)."""
    return {
        "$schema": SCHEMA,
        "info": {},
        "meta": _framework_meta(info),
        "response": {
            "entryTypes": {
                eid: _entry_type_descriptor(eid, info.uri) for eid in ENTRY_TYPES
            }
        },
    }


def configuration_response(info: BeaconInfo) -> dict:
    """GET /configuration (reference getConfiguration)."""
    return {
        "$schema": SCHEMA,
        "info": {},
        "meta": _framework_meta(info),
        "response": {
            "$schema": SCHEMA,
            "entryTypes": {
                eid: _entry_type_descriptor(eid, info.uri) for eid in ENTRY_TYPES
            },
            "maturityAttributes": {"productionStatus": "DEV"},
            "securityAttributes": {
                "defaultGranularity": info.default_granularity,
                "securityLevels": ["PUBLIC"],
            },
        },
    }


def map_response(info: BeaconInfo) -> dict:
    """GET /map (reference getMap) — endpoint sets generated from the same
    table that drives the actual router, so the map cannot drift from the
    served routes."""
    base = info.uri.rstrip("/")
    endpoint_sets = {}
    for eid, einfo in ENTRY_TYPES.items():
        path = einfo["path"]
        endpoints = {
            sub: {
                "returnedEntryType": sub,
                "url": f"{base}/{path}/{{id}}/{ENTRY_TYPES[sub]['path']}",
            }
            for sub in _SUB_ENDPOINTS.get(eid, [])
        }
        endpoint_sets[eid] = {
            "endpoints": endpoints,
            "entryType": eid,
            "filteringTermsUrl": f"{base}/{path}/filtering_terms",
            "openAPIEndpointsDefinition": (
                f"{_MODEL_URL}/{path}/endpoints.json"
            ),
            "rootUrl": f"{base}/{path}",
            "singleEntryUrl": f"{base}/{path}/{{id}}",
        }
    return {
        "$schema": SCHEMA,
        "info": {},
        "meta": _framework_meta(info),
        "response": {"$schema": SCHEMA, "endpointSets": endpoint_sets},
    }
