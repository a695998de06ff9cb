"""The host distinct-variant count: the byte-exact oracle.

Counterpart of ``sbeacon_tpu/ingest/pipeline.py``, trimmed to
``distinct_variant_count`` and ``_distinct_exact``. The summarisation
pipeline around them (BGZF/tabix reads, VCF parsing, slicing, the job
ledger and the span tracer) is not ported.

The count is the reference's cross-VCF duplicate-variant tally
(duplicateVariantSearch.cpp, an ``unordered_set<pos + ref_alt>`` insert
loop) over the columnar index. Rows are grouped by the fixed-width key
(chrom_code, pos, ref_hash, alt_hash, ref_len, alt_len) with one
``np.unique``; only rows sharing a key (true cross-VCF duplicates, or a
double FNV collision) are compared on their REF/ALT bytes, so the count
is exact. ``parallel.distinct.distinct_count_device`` counts the same
keys on the card and is held against this function.
"""

from __future__ import annotations

import numpy as np

from ..index.columnar import VariantIndexShard


def distinct_variant_count(
    shards: list[VariantIndexShard], *, max_range_bytes: int | None = None
) -> int:
    """Distinct (contig, pos, ref, alt) across shards.

    ``max_range_bytes`` bounds peak memory the way the reference's
    ABS_MAX_DATA_SPLIT bounds its dup-search fan-out ranges: when the key
    matrix would exceed it, rows are partitioned into disjoint
    (contig, pos) chunks and counted chunk by chunk; distinctness over
    disjoint position ranges sums exactly."""
    if not shards:
        return 0
    key_parts = []
    for s in shards:
        codes = (
            np.searchsorted(
                s.chrom_offsets, np.arange(s.n_rows), side="right"
            )
            - 1
        ).astype(np.int64)
        key_parts.append(
            np.stack(
                [
                    codes,
                    s.cols["pos"].astype(np.int64),
                    s.cols["ref_hash"].astype(np.int64),
                    s.cols["alt_hash"].astype(np.int64),
                    s.cols["ref_len"].astype(np.int64),
                    s.cols["alt_len"].astype(np.int64),
                ],
                axis=1,
            )
        )
    keys = np.concatenate(key_parts)
    n = len(keys)
    if n == 0:
        return 0

    shard_of = np.concatenate(
        [np.full(s.n_rows, k, dtype=np.int32) for k, s in enumerate(shards)]
    )
    row_of = np.concatenate(
        [np.arange(s.n_rows, dtype=np.int64) for s in shards]
    )

    row_bytes = keys.dtype.itemsize * keys.shape[1]
    if max_range_bytes is not None and n * row_bytes > max_range_bytes:
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        keys = keys[order]
        shard_of = shard_of[order]
        row_of = row_of[order]
        rows_per_range = max(1, max_range_bytes // row_bytes)
        total = 0
        start = 0
        while start < n:
            end = min(n, start + rows_per_range)
            # extend so equal (code, pos) rows stay in one chunk
            while end < n and (
                keys[end, 0] == keys[end - 1, 0]
                and keys[end, 1] == keys[end - 1, 1]
            ):
                end += 1
            total += _distinct_exact(
                keys[start:end],
                shard_of[start:end],
                row_of[start:end],
                shards,
            )
            start = end
        return total
    return _distinct_exact(keys, shard_of, row_of, shards)


def _distinct_exact(keys, shard_of, row_of, shards) -> int:
    """Exact distinct count of one key chunk: hash-grouped np.unique, byte
    verification only for rows whose key repeats."""
    n = len(keys)
    voids = np.ascontiguousarray(keys).view(
        np.dtype((np.void, keys.dtype.itemsize * keys.shape[1]))
    ).ravel()
    uniq, inverse, counts = np.unique(
        voids, return_inverse=True, return_counts=True
    )
    total = int((counts == 1).sum())
    if len(uniq) == n:
        return total
    dup_groups = np.flatnonzero(counts > 1)
    dup_mask = np.isin(inverse, dup_groups)
    per_group: dict[int, set] = {}
    for gi, sk, rk in zip(
        inverse[dup_mask], shard_of[dup_mask], row_of[dup_mask]
    ):
        s = shards[sk]
        allele = (
            bytes(s.ref_blob[s.ref_off[rk] : s.ref_off[rk + 1]]),
            bytes(s.alt_blob[s.alt_off[rk] : s.alt_off[rk + 1]]),
        )
        per_group.setdefault(int(gi), set()).add(allele)
    total += sum(len(v) for v in per_group.values())
    return total
