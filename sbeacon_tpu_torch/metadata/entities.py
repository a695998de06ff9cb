"""Entity schemas + ontology-term extraction.

Counterpart of ``sbeacon_tpu/metadata/entities.py``, copied whole so the
port imports nothing of the JAX package.

The six Beacon entity kinds and their filterable columns, matching the
reference's Athena models (reference: shared_resources/athena/{dataset,
cohort,individual,biosample,run,analysis}.py `_table_columns`). Columns
keep their camelCase spelling for filter-id matching (the Beacon filter
``{"id": "karyotypicSex", ...}`` must hit the column verbatim) and are
lowercased only at the SQL layer, exactly as Athena lowercases ORC struct
fields.
"""

from __future__ import annotations

import re

ENTITY_COLUMNS: dict[str, list[str]] = {
    "datasets": [
        "id",
        "_assemblyId",
        "_vcfLocations",
        "_vcfChromosomeMap",
        "createDateTime",
        "dataUseConditions",
        "description",
        "externalUrl",
        "info",
        "name",
        "updateDateTime",
        "version",
    ],
    "cohorts": [
        "id",
        "cohortDataTypes",
        "cohortDesign",
        "cohortSize",
        "cohortType",
        "collectionEvents",
        "exclusionCriteria",
        "inclusionCriteria",
        "name",
    ],
    "individuals": [
        "id",
        "_datasetId",
        "_cohortId",
        "diseases",
        "ethnicity",
        "exposures",
        "geographicOrigin",
        "info",
        "interventionsOrProcedures",
        "karyotypicSex",
        "measures",
        "pedigrees",
        "phenotypicFeatures",
        "sex",
        "treatments",
    ],
    "biosamples": [
        "id",
        "_datasetId",
        "_cohortId",
        "individualId",
        "biosampleStatus",
        "collectionDate",
        "collectionMoment",
        "diagnosticMarkers",
        "histologicalDiagnosis",
        "measurements",
        "obtentionProcedure",
        "pathologicalStage",
        "pathologicalTnmFinding",
        "phenotypicFeatures",
        "sampleOriginDetail",
        "sampleOriginType",
        "sampleProcessing",
        "sampleStorage",
        "tumorGrade",
        "tumorProgression",
        "info",
        "notes",
    ],
    "runs": [
        "id",
        "_datasetId",
        "_cohortId",
        "biosampleId",
        "individualId",
        "info",
        "libraryLayout",
        "librarySelection",
        "librarySource",
        "libraryStrategy",
        "platform",
        "platformModel",
        "runDate",
    ],
    "analyses": [
        "id",
        "_datasetId",
        "_cohortId",
        "_vcfSampleId",
        "individualId",
        "biosampleId",
        "runId",
        "aligner",
        "analysisDate",
        "info",
        "pipelineName",
        "pipelineRef",
        "variantCaller",
    ],
}

ENTITY_KINDS = list(ENTITY_COLUMNS)

# relations-table column per entity kind (reference filter_functions.py
# type_relations_table_id)
RELATION_ID_COLUMN = {
    "individuals": "individualid",
    "biosamples": "biosampleid",
    "runs": "runid",
    "analyses": "analysisid",
    "datasets": "datasetid",
    "cohorts": "cohortid",
}

# CURIE-shaped ontology term ids, e.g. 'HP:0000001', 'SNOMED:123'
# (reference athena/common.py:20 pattern)
TERM_PATTERN = re.compile(r"^\w[^:]+:.+$")


def extract_terms(value):
    """Yield (term, label, type) triples from anywhere in an entity doc.

    A dict whose 'id' looks like a CURIE contributes a term, labelled by
    its sibling 'label'/'type' fields; the walk recurses through every
    nested dict and list (reference: athena/common.py:108-124).
    """
    if isinstance(value, dict):
        label = value.get("label", "")
        typ = value.get("type", "string")
        for key, sub in value.items():
            if (
                key == "id"
                and isinstance(sub, str)
                and TERM_PATTERN.match(sub)
            ):
                yield sub, label, typ
            if isinstance(sub, (dict, list)):
                yield from extract_terms(sub)
    elif isinstance(value, list):
        for item in value:
            yield from extract_terms(item)
