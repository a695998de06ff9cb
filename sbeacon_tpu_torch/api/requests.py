"""Beacon v2 request parsing + validation.

Counterpart of ``sbeacon_tpu/api/requests.py``. The JAX package checks
POST bodies with ``jsonschema``; this package keeps the same
``QUERY_BODY_SCHEMA`` and checks it with a small validator of its own
(the keywords the schema uses: type, enum, minimum, maxItems, pattern,
anyOf, required, properties, items), raising the same ``RequestError``
at the same location with the same message.

One parser for the GET/POST duality every reference route re-implements
(reference: each route's paired ``if event['httpMethod'] == 'GET'/'POST'``
blocks, e.g. getGenomicVariants/route_g_variants.py:50-116): GET flattens
query parameters (comma-joined filters/start/end), POST nests them under
``meta`` / ``query.requestParameters`` / ``query.pagination``.

Also owns the Beacon start/end coordinate interpretation — the 1- vs
2-element bracket forms and the 0->1-based ``+1`` dance (reference:
shared_resources/variantutils/search_variants.py:48-68).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class RequestError(ValueError):
    """400-worthy request problem; message is user-facing."""


# POST body schema — the requestBody.json / gVariantsRequestParameters.json
# role (reference: shared_resources/schemas/, enforced per-route at e.g.
# getGenomicVariants/lambda_function.py:13-15,27-37), authored compactly:
# structure + enums + the allele patterns, with unknown extras tolerated
# the way the reference's additionalProperties:true does.
_ALLELE_PATTERN = r"^([ACGTUNRYSWKMBDHV\-\.acgtunryswkmbdhv]*)$"

QUERY_BODY_SCHEMA = {
    "type": "object",
    "properties": {
        "meta": {"type": "object"},
        "query": {
            "type": "object",
            "properties": {
                "requestedGranularity": {
                    "enum": ["boolean", "count", "record", "aggregated"]
                },
                "includeResultsetResponses": {
                    "enum": ["ALL", "HIT", "MISS", "NONE"]
                },
                "pagination": {
                    "type": "object",
                    "properties": {
                        "skip": {"type": "integer", "minimum": 0},
                        "limit": {"type": "integer", "minimum": 0},
                    },
                },
                "filters": {
                    "type": "array",
                    "items": {
                        "anyOf": [
                            {"type": "string"},
                            {
                                "type": "object",
                                "required": ["id"],
                                "properties": {
                                    "id": {"type": "string"},
                                    "scope": {"type": "string"},
                                    "includeDescendantTerms": {
                                        "type": "boolean"
                                    },
                                    "similarity": {
                                        "enum": [
                                            "exact",
                                            "high",
                                            "medium",
                                            "low",
                                        ]
                                    },
                                },
                            },
                        ]
                    },
                },
                "requestParameters": {
                    "type": "object",
                    "properties": {
                        "assemblyId": {"type": "string"},
                        "referenceName": {"type": "string"},
                        "referenceBases": {
                            "type": "string",
                            "pattern": _ALLELE_PATTERN,
                        },
                        "alternateBases": {
                            "type": "string",
                            "pattern": _ALLELE_PATTERN,
                        },
                        "variantType": {"type": "string"},
                        "start": {
                            "type": "array",
                            "items": {"type": "integer", "minimum": 0},
                            "maxItems": 2,
                        },
                        "end": {
                            "type": "array",
                            "items": {"type": "integer", "minimum": 0},
                            "maxItems": 2,
                        },
                        "variantMinLength": {
                            "type": "integer",
                            "minimum": 0,
                        },
                        "variantMaxLength": {
                            "type": "integer",
                            "minimum": 0,
                        },
                    },
                },
            },
        },
    },
}

_TYPES = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "boolean": lambda v: isinstance(v, bool),
    # JSON Schema integers: ints (not bools) and integral floats
    "integer": lambda v: (
        isinstance(v, int) and not isinstance(v, bool)
    ) or (isinstance(v, float) and v.is_integer()),
}


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _schema_errors(schema: dict, value, path: tuple):
    """Yield (path, message) for every violation of ``schema`` by
    ``value``, keyword by keyword in schema order (Draft 7 semantics
    for the keywords QUERY_BODY_SCHEMA uses; jsonschema's messages)."""
    for kw, arg in schema.items():
        if kw == "type":
            if not _TYPES[arg](value):
                yield path, f"{value!r} is not of type {arg!r}"
        elif kw == "enum":
            if not any(
                value == e and type(value) is type(e) for e in arg
            ):
                yield path, f"{value!r} is not one of {arg!r}"
        elif kw == "minimum":
            if _is_number(value) and value < arg:
                yield path, f"{value!r} is less than the minimum of {arg!r}"
        elif kw == "maxItems":
            if isinstance(value, list) and len(value) > arg:
                yield path, f"{value!r} is too long"
        elif kw == "pattern":
            if isinstance(value, str) and not re.search(arg, value):
                yield path, f"{value!r} does not match {arg!r}"
        elif kw == "required":
            if isinstance(value, dict):
                for prop in arg:
                    if prop not in value:
                        yield path, f"{prop!r} is a required property"
        elif kw == "properties":
            if isinstance(value, dict):
                for prop, sub in arg.items():
                    if prop in value:
                        yield from _schema_errors(
                            sub, value[prop], path + (prop,)
                        )
        elif kw == "items":
            if isinstance(value, list):
                for i, item in enumerate(value):
                    yield from _schema_errors(arg, item, path + (i,))
        elif kw == "anyOf":
            if not any(
                next(_schema_errors(sub, value, path), None) is None
                for sub in arg
            ):
                yield path, (
                    f"{value!r} is not valid under any of the given schemas"
                )
        else:
            raise ValueError(f"schema keyword {kw!r} is not supported")


def validate_query_body(body: dict) -> None:
    """Schema-check a POST body before parsing (the first error by path,
    as the JAX package reports it)."""
    errors = sorted(
        _schema_errors(QUERY_BODY_SCHEMA, body, ()), key=lambda e: list(e[0])
    )
    if errors:
        path, message = errors[0]
        where = "/".join(str(p) for p in path) or "body"
        raise RequestError(f"invalid request at {where}: {message}")


def _int(value, name: str, default: int | None = None) -> int:
    if value is None or value == "":
        if default is None:
            raise RequestError(f"{name} must be specified")
        return default
    try:
        return int(value)
    except (TypeError, ValueError):
        raise RequestError(f"{name} must be an integer") from None


def _int_list(value, name: str) -> list[int]:
    if value is None:
        return []
    if isinstance(value, str):
        parts = [p for p in value.split(",") if p != ""]
    elif isinstance(value, (list, tuple)):
        parts = list(value)
    else:
        parts = [value]
    try:
        return [int(p) for p in parts]
    except (TypeError, ValueError):
        raise RequestError(f"{name} must be a list of integers") from None


def _upper(value):
    """Allele case normalisation: the index hashes record alleles
    uppercased, so queries must be uppercased too or lowercase input
    (legal per the allele alphabet) silently never matches."""
    return value.upper() if isinstance(value, str) else value


def _parse_filters(raw) -> list[dict]:
    """GET form 'A,B' -> [{'id': 'A'}, {'id': 'B'}]; POST form passes
    through the filter dicts."""
    if raw is None:
        return []
    if isinstance(raw, str):
        return [{"id": fid} for fid in raw.split(",") if fid]
    if isinstance(raw, list):
        out = []
        for f in raw:
            if isinstance(f, str):
                out.append({"id": f})
            elif isinstance(f, dict):
                if "id" not in f:
                    raise RequestError("filter missing 'id'")
                out.append(f)
            else:
                raise RequestError("filters must be strings or objects")
        return out
    raise RequestError("filters must be a list or comma-joined string")


@dataclass
class BeaconRequest:
    """Normalised request: both HTTP methods collapse into this."""

    method: str = "GET"
    granularity: str = "boolean"
    skip: int = 0
    limit: int = 100
    filters: list[dict] = field(default_factory=list)
    include_resultset_responses: str = "NONE"
    # g_variants request parameters
    start: list[int] = field(default_factory=list)
    end: list[int] = field(default_factory=list)
    assembly_id: str | None = None
    reference_name: str | None = None
    reference_bases: str | None = None
    alternate_bases: str | None = None
    variant_type: str | None = None
    variant_min_length: int = 0
    variant_max_length: int = -1

    def coordinates(self) -> tuple[int, int, int, int]:
        """(start_min, start_max, end_min, end_max), 1-based inclusive.

        The exact bracket interpretation + the '+1' conversion of
        reference search_variants.py:48-68: a 2-element start/end is a
        bracket range; 1-element start with 1-element end is a
        start-anchored range whose end list bounds the variant end.
        """
        start, end = self.start, self.end
        if not start:
            raise RequestError("start must be specified")
        if len(start) > 2 or len(end) > 2:
            raise RequestError("start and end accept at most 2 values")
        if len(start) == 2:
            start_min, start_max = start
        else:
            start_min = start[0]
        if len(end) == 2:
            end_min, end_max = end
        elif len(end) == 1:
            end_min = start_min
            end_max = end[0]
        else:
            raise RequestError("end must be specified")
        if len(start) != 2:
            start_max = end_max
        return start_min + 1, start_max + 1, end_min + 1, end_max + 1


def parse_request(
    method: str,
    query_params: dict | None,
    body: dict | None,
) -> BeaconRequest:
    req = BeaconRequest(method=method.upper())
    if req.method == "POST":
        params = body or {}
        validate_query_body(params)
        query = params.get("query") or {}
        pagination = query.get("pagination") or {}
        rp = query.get("requestParameters") or {}
        req.granularity = query.get("requestedGranularity", "boolean")
        req.skip = _int(pagination.get("skip"), "skip", 0)
        req.limit = _int(pagination.get("limit"), "limit", 100)
        req.filters = _parse_filters(query.get("filters"))
        req.include_resultset_responses = query.get(
            "includeResultsetResponses", "NONE"
        )
        req.start = _int_list(rp.get("start"), "start")
        req.end = _int_list(rp.get("end"), "end")
        req.assembly_id = rp.get("assemblyId")
        req.reference_name = rp.get("referenceName")
        req.reference_bases = _upper(rp.get("referenceBases"))
        req.alternate_bases = _upper(rp.get("alternateBases"))
        req.variant_type = _upper(rp.get("variantType"))
        req.variant_min_length = _int(
            rp.get("variantMinLength"), "variantMinLength", 0
        )
        req.variant_max_length = _int(
            rp.get("variantMaxLength"), "variantMaxLength", -1
        )
    else:
        params = query_params or {}
        req.granularity = params.get("requestedGranularity", "boolean")
        req.skip = _int(params.get("skip"), "skip", 0)
        req.limit = _int(params.get("limit"), "limit", 100)
        req.filters = _parse_filters(params.get("filters"))
        req.include_resultset_responses = params.get(
            "includeResultsetResponses", "NONE"
        )
        req.start = _int_list(params.get("start"), "start")
        req.end = _int_list(params.get("end"), "end")
        req.assembly_id = params.get("assemblyId")
        req.reference_name = params.get("referenceName")
        req.reference_bases = _upper(params.get("referenceBases"))
        req.alternate_bases = _upper(params.get("alternateBases"))
        req.variant_type = _upper(params.get("variantType"))
        req.variant_min_length = _int(
            params.get("variantMinLength"), "variantMinLength", 0
        )
        req.variant_max_length = _int(
            params.get("variantMaxLength"), "variantMaxLength", -1
        )
    if req.granularity not in ("boolean", "count", "record", "aggregated"):
        raise RequestError(
            f"unknown requestedGranularity {req.granularity!r}"
        )
    if req.skip < 0 or req.limit < 0:
        raise RequestError("skip and limit must be non-negative")
    return req
