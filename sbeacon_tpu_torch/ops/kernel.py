"""Query encoding and result containers (numpy, host side).

Counterpart of the numpy parts of ``sbeacon_tpu/ops/kernel.py``:
``QuerySpec``, ``encode_queries``, the ``MODE_*`` / ``VT_*`` codes,
``_PAD_FILLS`` and ``QueryResults``. The XLA bisection kernel of that
module (``_bisect`` / ``_query_one``, which serves fused multi-dataset
stacks and the L0 delta tail) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.columnar import INT32_MAX, fnv1a32, pack_prefix16, prefix_mask
from ..utils.chrom import chromosome_code

# variant_type codes for the type-dispatch mode
VT_DEL, VT_INS, VT_DUP, VT_DUP_TANDEM, VT_CNV, VT_OTHER = range(6)
_VT_CODES = {
    "DEL": VT_DEL,
    "INS": VT_INS,
    "DUP": VT_DUP,
    "DUP:TANDEM": VT_DUP_TANDEM,
    "CNV": VT_CNV,
}

# alt matching modes
MODE_EXACT, MODE_ANY_BASE, MODE_TYPE = range(3)


@dataclass
class QuerySpec:
    """One Beacon variant query, coordinates 1-based inclusive."""

    chrom: str
    start_min: int
    start_max: int
    end_min: int
    end_max: int
    reference_bases: str | None = None
    alternate_bases: str | None = None
    variant_type: str | None = None
    variant_min_length: int = 0
    variant_max_length: int = -1


def encode_queries(queries: list[QuerySpec]) -> dict[str, np.ndarray]:
    """Host-side encoding of a query batch into per-field arrays."""
    b = len(queries)
    enc = {
        "chrom": np.zeros(b, np.int32),
        "start_min": np.zeros(b, np.int32),
        "start_max": np.zeros(b, np.int32),
        "end_min": np.zeros(b, np.int32),
        "end_max": np.zeros(b, np.int32),
        "ref_wild": np.zeros(b, np.bool_),
        "ref_hash": np.zeros(b, np.int32),
        "ref_len": np.zeros(b, np.int32),
        "alt_mode": np.zeros(b, np.int32),
        "alt_hash": np.zeros(b, np.int32),
        "alt_len": np.zeros(b, np.int32),
        "vt_code": np.zeros(b, np.int32),
        "vprefix": np.zeros((b, 4), np.uint32),
        "vprefix_mask": np.zeros((b, 4), np.uint32),
        "min_len": np.zeros(b, np.int32),
        "max_len": np.zeros(b, np.int32),
    }
    for i, q in enumerate(queries):
        enc["chrom"][i] = chromosome_code(q.chrom)
        enc["start_min"][i] = q.start_min
        enc["start_max"][i] = q.start_max
        enc["end_min"][i] = q.end_min
        enc["end_max"][i] = q.end_max
        wild = q.reference_bases is None or q.reference_bases == "N"
        enc["ref_wild"][i] = wild
        if not wild:
            enc["ref_hash"][i] = fnv1a32(q.reference_bases.encode())
            enc["ref_len"][i] = len(q.reference_bases)
        if q.alternate_bases is None:
            enc["alt_mode"][i] = MODE_TYPE
            vt = q.variant_type
            enc["vt_code"][i] = _VT_CODES.get(vt, VT_OTHER)
            # '<' + str(vt): variant_type=None yields '<None', which matches
            # no alt — the reference's exact formatting artifact
            vpref = ("<" + str(vt)).encode()
            enc["vprefix"][i] = pack_prefix16(vpref)
            enc["vprefix_mask"][i] = prefix_mask(min(len(vpref), 16))
        elif q.alternate_bases == "N":
            enc["alt_mode"][i] = MODE_ANY_BASE
        else:
            enc["alt_mode"][i] = MODE_EXACT
            enc["alt_hash"][i] = fnv1a32(q.alternate_bases.encode())
            enc["alt_len"][i] = len(q.alternate_bases)
        enc["min_len"][i] = q.variant_min_length
        enc["max_len"][i] = (
            int(INT32_MAX) if q.variant_max_length < 0 else q.variant_max_length
        )
    return enc


# per-column padding fill values (pos/rec_end/rec_id = INT32_MAX so no
# searchsorted window ever selects a padding row)
_PAD_FILLS = {
    "pos": INT32_MAX,
    "rec_end": INT32_MAX,
    "ref_len": 0,
    "alt_len": 0,
    "ref_hash": 0,
    "alt_hash": 0,
    "ref_repeat_k": -1,
    "flags": 0,
    "ac": 0,
    "an": 0,
    "rec_id": INT32_MAX,
    "alt_prefix": 0,
}


@dataclass
class QueryResults:
    """Per-query aggregates + matched row ids (numpy, host-side)."""

    exists: np.ndarray  # bool[B]
    call_count: np.ndarray  # int32[B] — sum of AC over matched rows
    n_variants: np.ndarray  # int32[B] — matched rows with AC != 0
    all_alleles_count: np.ndarray  # int32[B] — AN summed once per record
    n_matched: np.ndarray  # int32[B]
    overflow: np.ndarray  # bool[B] — window_cap exceeded, host fallback
    rows: np.ndarray  # int32[B, record_cap] global row ids, -1 padded
    # genotype-plane outputs (not produced by this package yet; kept so
    # the container matches the JAX package's field for field)
    pc_call: np.ndarray | None = None
    pc_tok: np.ndarray | None = None
    or_words: np.ndarray | None = None

