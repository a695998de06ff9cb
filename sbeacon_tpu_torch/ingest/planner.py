"""Ingest slice planning: cost-optimal BGZF virtual-offset slicing.

Counterpart of ``sbeacon_tpu/ingest/planner.py``, copied whole.

Re-implements the reference's slice planner (reference:
lambda/summariseVcf/lambda_function.py — ``get_chunk_boundaries`` :90-104,
``find_best_split`` Newton optimisation :69-87, ``next_newton_approximation``
:189-194, ``partition_chunks`` :197-214) against the native tabix layer.
The planner chooses a slice size minimising ``total_time * cost`` for the
given cost model, snaps slices to index chunk boundaries (so every slice
starts at a record boundary), and packs base-pair ranges for the
distinct-variant reduction (reference: initDuplicateVariantSearch.py
``calcRangeSplits`` greedy packing under ABS_MAX_DATA_SPLIT).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..config import IngestConfig
from ..genomics.tabix import TabixIndex


def chunk_boundaries(index: TabixIndex) -> dict[str, list[int]]:
    """{ref_name: sorted unique virtual offsets} from the bin index,
    excluding pseudo-bins (reference get_chunk_boundaries :90-104 filters
    ``bin < bin_limit``)."""
    # max real bin number for (min_shift, depth): sum of 8^l for l<=depth
    bin_limit = ((1 << (3 * (index.depth + 1))) - 1) // 7
    out = {}
    for name, ref in zip(index.names, index.refs):
        offsets = {
            v
            for bin_no, chunks in ref.bins.items()
            if bin_no < bin_limit
            for ck in chunks
            for v in (ck.beg, ck.end)
        }
        if offsets:
            # the 16kb linear index adds record-boundary offsets between
            # coarse bin chunks — finer slicing for sparse/self-built
            # indexes (every linear entry is the voffset of a record start
            # inside the bin span, so slices still cut on record edges)
            lo, hi = min(offsets), max(offsets)
            offsets.update(v for v in ref.linear if lo < v < hi)
            out[name] = sorted(offsets)
    return out


def next_newton_approximation(
    total_size: float, split_size: float, cost: IngestConfig
) -> float:
    """One Newton step on d/ds [time(s) * cost(s)] (reference :189-194,
    with the cost constants injected instead of module globals)."""
    t0 = cost.min_task_time
    rate = cost.scan_rate
    sns = cost.dispatch_cost
    d = (
        -(t0**2) / split_size**2
        + 1 / rate**2
        - 2 * sns * total_size * t0 / split_size**3
        - sns * total_size / split_size**2 / rate
    )
    dd = (
        2 * t0**2 / split_size**3
        + 6 * sns * total_size * t0 / split_size**4
        + 2 * sns * total_size / split_size**3 / rate
    )
    return split_size - d / dd


def find_best_split(
    total_size: float, epsilon: float, cost: IngestConfig | None = None
) -> float:
    """Newton iteration to convergence (reference find_best_split :69-87,
    including the negative-overshoot halving and the geometric error
    bound)."""
    cost = cost or IngestConfig()
    next_size = total_size**0.5
    sizes: list[float] = []
    while True:
        sizes.append(next_size)
        next_size = next_newton_approximation(total_size, next_size, cost)
        if next_size <= 0:
            next_size = sizes[-1] / 2
        if len(sizes) >= 2:
            last_difference = next_size - sizes[-1]
            denom = sizes[-1] - sizes[-2]
            if denom == 0:
                return next_size
            rate = last_difference / denom
            if abs(rate) < 1:
                max_error = last_difference / (1 - rate)
                if abs(max_error) < epsilon:
                    return next_size


def partition_chunks(
    boundaries: dict[str, list[int]], slice_size: float
) -> list[tuple[int, int]]:
    """Snap the target slice size to chunk boundaries (reference
    partition_chunks :197-214 — compressed block offsets ``voffset >> 16``
    drive the size accounting; slices never span contigs)."""
    slices: list[tuple[int, int]] = []
    for ref_boundaries in boundaries.values():
        start_virtual = ref_boundaries[0]
        start_block = start_virtual >> 16
        for virtual in ref_boundaries:
            if (virtual >> 16) - start_block >= slice_size:
                slices.append((start_virtual, virtual))
                start_virtual = virtual
                start_block = virtual >> 16
        if ref_boundaries[-1] != start_virtual:
            slices.append((start_virtual, ref_boundaries[-1]))
    return slices


@dataclass
class SlicePlan:
    slices: list[tuple[int, int]]  # (virtual_start, virtual_end)
    total_size: int  # compressed bytes spanned
    split_size: float  # chosen target slice size


def plan_slices(index: TabixIndex, cost: IngestConfig | None = None) -> SlicePlan:
    """Full planning pass for one VCF (reference summarise_vcf :258-268)."""
    cost = cost or IngestConfig()
    boundaries = chunk_boundaries(index)
    if not boundaries:
        return SlicePlan(slices=[], total_size=0, split_size=0.0)
    first = min(b[0] for b in boundaries.values()) >> 16
    last = (max(b[-1] for b in boundaries.values()) >> 16) + 2**16
    num_chunks = max(1, sum(len(b) for b in boundaries.values()) - 1)
    total_size = last - first
    avg_chunk = total_size / num_chunks
    best = find_best_split(total_size, avg_chunk / 2, cost)
    if total_size / best > cost.max_concurrency:
        best = total_size / cost.max_concurrency
    return SlicePlan(
        slices=partition_chunks(boundaries, best),
        total_size=total_size,
        split_size=best,
    )


def pack_ranges(
    items: list[tuple[int, int, int]], max_bytes: int
) -> list[tuple[int, int]]:
    """Greedy base-pair range packing: items are (start_bp, end_bp,
    size_bytes) sorted-by-start work units; returns contiguous
    (start_bp, end_bp) bins whose members total <= max_bytes (reference
    initDuplicateVariantSearch.calcRangeSplits / addRange greedy packing
    under ABS_MAX_DATA_SPLIT). This is the shard planner for the
    mesh-distributed dedupe reduction (SURVEY.md §2.5 range-packed
    reduce), where each bin becomes one device-shard task; the local
    distinct count bounds memory with plain row chunking instead."""
    if not items:
        return []
    items = sorted(items)
    ranges: list[tuple[int, int]] = []
    cur_start = items[0][0]
    cur_end = items[0][1]
    cur_bytes = 0
    for start, end, size in items:
        if cur_bytes and cur_bytes + size > max_bytes:
            ranges.append((cur_start, cur_end))
            cur_start = start
            cur_bytes = 0
            cur_end = end
        cur_bytes += size
        cur_end = max(cur_end, end)
    ranges.append((cur_start, cur_end))
    return ranges
