"""Per-entity default model schemas, served at ``/schemas/{entityType}``.

Counterpart of ``sbeacon_tpu/api/model_schemas.py``, copied whole.

The reference vendors the GA4GH Beacon v2 default model as ~8.2k lines of
JSON under shared_resources/schemas/ and points entry-type descriptors at
the upstream model URLs (SURVEY.md §2.3 'schemas'). Here the same role is
filled by compact hand-authored JSON Schema documents describing exactly
the fields this framework stores and returns (metadata/entities.py +
api/envelopes.py), self-hosted so ``returnedSchemas`` and
``/map``/``/entry_types`` reference resolvable documents instead of
external URLs. Written against the published Beacon v2 model structure —
a GA4GH standard — not copied from the reference's vendored files.
"""

from __future__ import annotations

SCHEMA_VERSION = "v2.0.0"


def schema_id(entity: str) -> str:
    return f"beacon-{entity}-{SCHEMA_VERSION}"


_ONTOLOGY_TERM = {
    "type": "object",
    "description": "CURIE-identified ontology term",
    "properties": {
        "id": {
            "type": "string",
            "pattern": "^\\w[^:]*:.+$",
            "description": "CURIE, e.g. NCIT:C20197 or HP:0000001",
        },
        "label": {"type": "string"},
    },
    "required": ["id"],
}

_DEFS = {"ontologyTerm": _ONTOLOGY_TERM}
_TERM_REF = {"$ref": "#/$defs/ontologyTerm"}
_TERM_LIST = {"type": "array", "items": _TERM_REF}


def _doc(entity: str, title: str, description: str, properties: dict,
         required: list[str]) -> dict:
    return {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "$id": schema_id(entity),
        "title": title,
        "description": description,
        "type": "object",
        "$defs": _DEFS,
        "properties": properties,
        "required": required,
        "additionalProperties": True,
    }


ENTITY_SCHEMAS: dict[str, dict] = {
    "dataset": _doc(
        "dataset",
        "Dataset",
        "A coherent collection of genomic data grouped for sharing "
        "(Beacon v2 datasets collection).",
        {
            "id": {"type": "string", "minLength": 1},
            "name": {"type": "string", "minLength": 1},
            "description": {"type": "string"},
            "createDateTime": {"type": "string", "format": "date-time"},
            "updateDateTime": {"type": "string", "format": "date-time"},
            "dataUseConditions": {
                "type": "object",
                "properties": {
                    "duoDataUse": {
                        "type": "array",
                        "items": {
                            "allOf": [
                                _TERM_REF,
                                {
                                    "properties": {
                                        "version": {"type": "string"},
                                        "modifiers": _TERM_LIST,
                                    }
                                },
                            ]
                        },
                    }
                },
            },
            "externalUrl": {"type": "string"},
            "info": {"type": "object"},
            "version": {"type": "string"},
        },
        ["id", "name"],
    ),
    "cohort": _doc(
        "cohort",
        "Cohort",
        "A group of individuals analysed together (Beacon v2 cohorts "
        "collection).",
        {
            "id": {"type": "string", "minLength": 1},
            "name": {"type": "string", "minLength": 1},
            "cohortType": {
                "type": "string",
                "enum": ["study-defined", "beacon-defined", "user-defined"],
            },
            "cohortDesign": _TERM_REF,
            "cohortSize": {"type": "integer"},
            "inclusionCriteria": {"type": "object"},
            "exclusionCriteria": {"type": "object"},
            "cohortDataTypes": _TERM_LIST,
        },
        ["id", "name"],
    ),
    "individual": _doc(
        "individual",
        "Individual",
        "A human subject carrying biosamples (Beacon v2 individuals "
        "entry type).",
        {
            "id": {"type": "string", "minLength": 1},
            "sex": _TERM_REF,
            "karyotypicSex": {
                "type": "string",
                "enum": [
                    "UNKNOWN_KARYOTYPE", "XX", "XY", "XO", "XXY", "XXX",
                    "XXYY", "XXXY", "XXXX", "XYY", "OTHER_KARYOTYPE",
                ],
            },
            "ethnicity": _TERM_REF,
            "geographicOrigin": _TERM_REF,
            "diseases": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "diseaseCode": _TERM_REF,
                        "ageOfOnset": {"type": "object"},
                        "familyHistory": {"type": "boolean"},
                        "severity": _TERM_REF,
                        "stage": _TERM_REF,
                    },
                    "required": ["diseaseCode"],
                },
            },
            "measures": {"type": "array", "items": {"type": "object"}},
            "phenotypicFeatures": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "featureType": _TERM_REF,
                        "excluded": {"type": "boolean"},
                    },
                    "required": ["featureType"],
                },
            },
            "interventionsOrProcedures": {
                "type": "array", "items": {"type": "object"},
            },
        },
        ["id", "sex"],
    ),
    "biosample": _doc(
        "biosample",
        "Biosample",
        "A biological sample from which genomic data derives (Beacon v2 "
        "biosamples entry type).",
        {
            "id": {"type": "string", "minLength": 1},
            "individualId": {"type": "string"},
            "biosampleStatus": _TERM_REF,
            "sampleOriginType": _TERM_REF,
            "sampleOriginDetail": _TERM_REF,
            "collectionDate": {"type": "string", "format": "date"},
            "collectionMoment": {"type": "string"},
            "obtentionProcedure": {"type": "object"},
            "tumorProgression": _TERM_REF,
            "tumorGrade": _TERM_REF,
            "pathologicalStage": _TERM_REF,
            "histologicalDiagnosis": _TERM_REF,
            "diagnosticMarkers": _TERM_LIST,
            "phenotypicFeatures": {
                "type": "array", "items": {"type": "object"},
            },
            "notes": {"type": "string"},
        },
        ["id", "biosampleStatus"],
    ),
    "run": _doc(
        "run",
        "Run",
        "One sequencing experiment on a biosample (Beacon v2 runs entry "
        "type).",
        {
            "id": {"type": "string", "minLength": 1},
            "biosampleId": {"type": "string"},
            "individualId": {"type": "string"},
            "runDate": {"type": "string", "format": "date"},
            "libraryLayout": {
                "type": "string", "enum": ["PAIRED", "SINGLE"],
            },
            "librarySelection": {"type": "string"},
            "librarySource": _TERM_REF,
            "libraryStrategy": {"type": "string"},
            "platform": {"type": "string"},
            "platformModel": _TERM_REF,
        },
        ["id", "biosampleId", "runDate"],
    ),
    "analysis": _doc(
        "analysis",
        "Analysis",
        "A bioinformatics analysis of a sequencing run (Beacon v2 "
        "analyses entry type).",
        {
            "id": {"type": "string", "minLength": 1},
            "runId": {"type": "string"},
            "biosampleId": {"type": "string"},
            "individualId": {"type": "string"},
            "analysisDate": {"type": "string", "format": "date"},
            "pipelineName": {"type": "string"},
            "pipelineRef": {"type": "string"},
            "aligner": {"type": "string"},
            "variantCaller": {"type": "string"},
            "vcfSampleId": {
                "type": "string",
                "description": "sample column this analysis maps to in "
                "the dataset's VCFs (drives the selected-samples search)",
            },
        },
        ["id", "analysisDate", "pipelineName"],
    ),
    "genomicVariant": _doc(
        "genomicVariant",
        "Genomic Variant",
        "A genomic variant entry as returned by /g_variants (Beacon v2 "
        "genomicVariations entry type, VRS-flavoured variation).",
        {
            "variantInternalId": {
                "type": "string",
                "description": "opaque stable id; decodable via "
                "/g_variants/{id}",
            },
            "variation": {
                "type": "object",
                "properties": {
                    "referenceBases": {"type": "string"},
                    "alternateBases": {"type": "string"},
                    "variantType": {"type": "string"},
                    "location": {
                        "type": "object",
                        "properties": {
                            "interval": {
                                "type": "object",
                                "properties": {
                                    "start": {
                                        "type": "object",
                                        "properties": {
                                            "type": {"type": "string"},
                                            "value": {"type": "integer"},
                                        },
                                    },
                                    "end": {
                                        "type": "object",
                                        "properties": {
                                            "type": {"type": "string"},
                                            "value": {"type": "integer"},
                                        },
                                    },
                                    "type": {"type": "string"},
                                },
                            },
                            "sequence_id": {"type": "string"},
                            "type": {"type": "string"},
                        },
                    },
                },
                "required": ["location"],
            },
            "caseLevelData": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "biosampleId": {"type": "string"},
                        "individualId": {"type": "string"},
                    },
                },
            },
            "frequencyInPopulations": {
                "type": "array", "items": {"type": "object"},
            },
        },
        ["variantInternalId", "variation"],
    ),
}

#: path-part -> entityType (the router's plural paths)
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
