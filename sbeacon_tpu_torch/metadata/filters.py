"""Beacon filtering-terms -> SQL compiler.

Counterpart of ``sbeacon_tpu/metadata/filters.py``, copied whole: the
same filters compile to the same SQL and parameters in both packages.

Re-implements the reference's filter classification and SQL generation
(reference: shared_resources/athena/filter_functions.py:66-133,
`new_entity_search_conditions`) against the local sqlite metadata store:

Each filter id is classified as
1. an own-column of the queried entity  -> outer WHERE predicate,
2. ``Entity.column`` of a linked entity -> relations-join subquery,
3. otherwise an ontology term           -> descendant-expanded terms_index
                                           + relations-join subquery,
and the join subqueries are INTERSECTed, so multiple filters mean set
intersection over entity ids. All values travel as ``?`` parameters
(the reference's Athena execution-parameters sanitisation).
"""

from __future__ import annotations

from .entities import ENTITY_COLUMNS, RELATION_ID_COLUMN
from .ontology import OntologyStore

# filter ids of the form 'Individual.sex' name a linked entity class
# (reference queried_athena_models keys are the class names)
_CLASS_TO_KIND = {
    "Analysis": "analyses",
    "Biosample": "biosamples",
    "Individual": "individuals",
    "Cohort": "cohorts",
    "Dataset": "datasets",
    "Run": "runs",
}


class FilterError(ValueError):
    pass


def _comparison(f: dict) -> tuple[str, object, bool]:
    """(operator, value, is_numeric) for a filter
    (reference _get_comparrison_fragment). Numeric values keep their type
    so the SQL layer can CAST the TEXT column and compare numerically."""
    if "value" not in f:
        raise FilterError("filter missing 'value'")
    if "operator" not in f:
        raise FilterError("filter missing 'operator'")
    value = f["value"]
    operator = f["operator"]
    numeric = isinstance(value, (int, float)) and not isinstance(value, bool)
    if numeric:
        operator = "!=" if operator == "!" else operator
        if operator not in ("=", "<", ">", "<=", ">=", "!="):
            raise FilterError(f"unsupported numeric operator {operator!r}")
    else:
        if operator not in ("=", "!"):
            raise FilterError(f"unsupported string operator {operator!r}")
        operator = "LIKE" if operator == "=" else "NOT LIKE"
        value = str(value)
    return operator, value, numeric


def _predicate(column: str, op: str, numeric: bool) -> str:
    if numeric:
        # columns are TEXT; CAST for a true numeric compare, and exclude
        # absent ('') values so they don't coerce to 0
        return f"({column} != '' AND CAST({column} AS NUMERIC) {op} ?)"
    return f"{column} {op} ?"


def entity_search_parts(
    filters: list[dict],
    id_type: str,
    default_scope: str,
    *,
    ontology: OntologyStore | None = None,
):
    """Classify filters into structured SQL parts — the single source of
    truth for filter semantics: (outer_predicates, outer_params,
    join_subqueries, join_params, relation_id_column).

    ``entity_search_conditions`` assembles the reference-shaped WHERE
    fragment from these; the store's shape-specific fast paths (e.g.
    streaming ``exists``) consume them directly, so the two can never
    disagree on classification.
    """
    if id_type not in ENTITY_COLUMNS:
        raise FilterError(f"unknown id_type {id_type!r}")
    own_columns = ENTITY_COLUMNS[id_type]
    my_rel = RELATION_ID_COLUMN[id_type]

    join_subqueries: list[str] = []
    join_params: list[str] = []
    outer_predicates: list[str] = []
    outer_params: list[str] = []

    for f in filters:
        if "id" not in f:
            raise FilterError("filter missing 'id'")
        parts = f["id"].split(".")

        if len(parts) == 1 and parts[0] in own_columns:
            op, value, numeric = _comparison(f)
            outer_predicates.append(_predicate(parts[0].lower(), op, numeric))
            outer_params.append(value)
            continue

        linked = _CLASS_TO_KIND.get(parts[0]) if len(parts) == 2 else None
        if linked is not None and parts[1] in ENTITY_COLUMNS[linked]:
            op, value, numeric = _comparison(f)
            join_params.append(value)
            pred = _predicate(f"TI.{parts[1].lower()}", op, numeric)
            join_subqueries.append(
                f"SELECT RI.{my_rel} FROM relations RI "
                f"JOIN {linked} TI ON RI.{RELATION_ID_COLUMN[linked]} = TI.id "
                f"WHERE {pred}"
            )
            continue

        # ontology term
        if ontology is not None:
            expanded = sorted(
                ontology.expand_filter_term(
                    f["id"],
                    include_descendants=f.get("includeDescendantTerms", True),
                    similarity=f.get("similarity", "high"),
                )
            )
        else:
            expanded = [f["id"]]
        scope = f.get("scope", default_scope)
        if scope not in RELATION_ID_COLUMN:
            raise FilterError(f"unknown filter scope {scope!r}")
        join_params.extend(expanded)
        placeholders = " , ".join("?" for _ in expanded)
        join_subqueries.append(
            f"SELECT RI.{my_rel} FROM relations RI "
            f"JOIN terms_index TI ON RI.{RELATION_ID_COLUMN[scope]} = TI.id "
            f"WHERE TI.kind = '{scope}' AND TI.term IN ({placeholders})"
        )
    return outer_predicates, outer_params, join_subqueries, join_params, my_rel


def entity_search_conditions(
    filters: list[dict],
    id_type: str,
    default_scope: str,
    *,
    ontology: OntologyStore | None = None,
    id_modifier: str = "id",
    with_where: bool = True,
) -> tuple[str, list[str]]:
    """(sql_fragment, params) constraining ``id_type`` rows by ``filters``."""
    outer_predicates, outer_params, join_subqueries, join_params, _ = (
        entity_search_parts(
            filters, id_type, default_scope, ontology=ontology
        )
    )
    clauses: list[str] = []
    if join_subqueries:
        joined = " INTERSECT ".join(join_subqueries)
        clauses.append(f"{id_modifier} IN ({joined})")
    clauses.extend(outer_predicates)
    if not clauses:
        return "", []
    fragment = " AND ".join(clauses)
    return ("WHERE " if with_where else "") + fragment, join_params + outer_params
