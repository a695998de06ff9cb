#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sbeacon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows 20000000] [--requests 384] [--threads 64]
                          [--cohorts 3] [--cohort-rows 5000000]
                          [--fused-requests 256] [--samples 2504]
                          [--plane-rows 2000000] [--selected-requests 256]
                          [--seed 0] [--parent DIR]

Phases, each printing one JSON line (any failure raises and exits
non-zero, without the final line):

1. environment: the card, its power limit (nvidia-smi), torch and CUDA;
2. build: compiles every CUDA kernel with nvcc for sm_90a, one nvcc
   process per source, all at once;
3. kernel vs twin (scatter_match): at a full batch of every tier and at
   the main path's launch shape (1, 6 or 15 queries padded to 64 slots,
   on 0xDEADBEEF-filled outputs), against its plain-PyTorch twin on the
   same inputs on the card (integers: equal outputs, tolerance 0);
4. main path: a 1000-Genomes-shaped index (2e7 rows across chr1-22, no
   genotype planes) behind the port's VariantEngine, answering
   single-dataset Beacon requests from many threads through
   parse_request -> run_variant_search -> Envelopes, each response
   checked against the host matcher; kernel launch counts are zeroed
   just before and read just after;
4a. hooks cost: the main path's first 128 payloads served one at a
    time without a request context (every serving hook a no-op) and
    under one, in turns off, on, on, off; the hooks' calls per request
    and each no-op hook's cost a call (host clock);
5. timing (scatter_match): each kernel tier with CUDA events at a full
   batch and at the main path's launch shape (the tier's mean real
   queries in phase 4 padded to 64 slots, L2 cold), beside its bound
   (the least bytes and operations the launch's own inputs need) and its
   twin's time; the main path's card time is each tier's launches times
   its cold time at that shape;
5a. cache_path: the main shard behind an engine of the JAX default
   config (the response cache on): 96 bodies of the main mix, each sent
   4 times, shuffled, from many threads; then one delta of about 4000
   rows over one body's bracket (``add_delta``) and the 96 bodies once
   more. Every answer equals the cache-off engine's of phase 4 for the
   same body (the delta published there too, its answers held against
   the host matcher and the monolith); a body whose cache scope overlaps
   the delta misses and one shows its rows, the others hit. Hits,
   misses, scoped evictions, scatter_match launches per request,
   requests/s and p50/p99;
6. fused setup: three more cohorts (5e6 rows each) join the engine and
   the fused stack of all four (3.5e7 rows) is built inline;
7. kernel vs twin (bisect_query): on that stack and on a small stack of
   crafted shards, at 8, 64 and 512 queries, every alt mode included,
   and on window-edge stacks of 3 and 11 shards (windows of 1, 255-257,
   1400, 2048 lanes and past W, records cut by chunk and cluster-rank
   edges, R below the matches), on 0xDEADBEEF-filled outputs;
8. fused path: requests with no datasetIds (every dataset) from many
   threads, each of the four responses per request checked against the
   host matcher; launch counts zeroed just before and read just after;
9. timing (bisect_query): at the batch sizes phase 8 launched, point and
   bracket batches, cycling 16 query sets (``ms``), with the L2 flushed before each launch (``ms_flushed``) and
   one set back to back (``warm_ms``), beside the bound and the twin's
   time;
9a. kernel vs twin (bisect_query, L0 form): composites of 1, 4 and 16
    keys' delta tails (``testing.l0_tail_keys``; 16, 64 and 512 padded
    shards, the segment table read from global memory), windows of
    256-4096 lanes, record caps below the matches, queries on pad rows,
    on 0xDEADBEEF-filled outputs;
9b. delta setup: the fused path's four datasets behind an engine with
    the response cache on, each given 40 delta shards of 1000-8000
    seeded rows across chr1-22 (``add_delta``; every tail past the L0
    threshold, the composite over all four keys);
9c. warmup: ``VariantEngine.warmup`` on that engine, its seconds and
    launches (scatter_match per shard, bisect_query on the fused stack
    and on the L0 index);
9d. delta path: the fused path's mix, 40% of it aimed at delta rows,
    from many threads, while a writer publishes 16 more deltas; every
    response against the host matcher on its shard, the envelope,
    read-your-writes on the delta epochs each request saw, and each
    dataset against ``merge_shards`` of its base and the deltas seen
    (inside the request's bracket); fused_l0 launches per request,
    tail shards matched on the host, L0 rebuilds per key;
9e. kernel vs twin and timing (bisect_query, L0 form): the delta path's
    composite at its median launch, 16 sets of its own specs on
    0xDEADBEEF-filled outputs held equal to the twin (overflow and match
    counts too), then timed L2 cold and warm, beside the bound and the
    twin;
10. selected setup: dataset A is the 2e7-row shard with a 2504-sample gt
    plane (6.3 GB), dataset B a 2e6-row shard with all four planes
    (2.5 GB; 30% of its records count from genotypes); the plane bits
    come from a seeded generator on the card, copied to the host shard.
    Both behind an engine with device_planes on; their planes must be
    on the card;
11. kernel vs twin (scatter_selected): every tier, exact and not, both
    twin forms, with and without counts, all-ones, sparse and empty
    masks, B = 1, 16 and 64, on dataset B and on a crafted shard
    (ploidy > 2, 12-alt records, 40 samples: a tail word); on dataset A
    without counts, every tier at B = 1 and at B = 16 on its last 5% of
    rows (plane offsets past 4 GiB);
12. kernel vs twin (plane_stats): row sets of 1, 128, 1000 and 20000
    rows, or_sel none, some and all, with and without counts, on dataset
    B; 5000-row sets on dataset A's gt plane, one on its last 20000 rows;
    the grid's edges on B (0-70001 rows, clamped row ids, three launches
    in a row), all on 0xDEADBEEF-filled outputs;
13. selected path: selected-samples, sample-extraction, N-wildcard-ref,
    wide and plane-free requests over datasets A and B from many
    threads, each response checked against the host matcher and the
    host planes; launch counts zeroed just before and read just after;
14. timing (scatter_selected, plane_stats): at the batch and row-set
    sizes phase 13 launched, with the L2 flushed before each launch (and
    back to back), beside the bound and the twin's time;
15. distinct setup: the keys of every shard built so far (A, the three
    cohorts, B) and of three seeded row subsets of A (40-70% of its rows
    each: the same sites submitted again), about 7e7 keys on the card;
16. kernel vs twin (distinct_count): crafted key sets (every key equal,
    one column differing, high-bit patterns, pad rows, 0-1000 keys),
    partition_keys blocks, and the full key set, at tolerance 0, each
    with the passes its buckets spilled to;
17. distinct path: distinct_count_device over every shard on the card,
    equal to the count without the subsets and to the host oracle
    distinct_variant_count on the shards without them; launch counts
    zeroed just before and read just after;
17a. distinct path over the two-entry mesh [card, card]: one
    ``partition_keys`` block and one distinct_count launch per entry,
    summed on the first, equal to the host oracle; ``shard_keys`` timed
    beside the earlier per-shard key build (the same bytes);
18. timing: distinct_count at the full key set (L2 cold and warm) beside
    its bound, its twin and torch.unique(keys, dim=0), and the device ms
    of each of its four kernels from a torch.profiler trace; the device time
    probes on the main-path index (phase 4's query mix, and C=1 exact
    points, which must agree with phase 5's time within 1.5x) and on
    phase 14's plane-stats row set;
19. mesh setup: one-card stacks (parallel.mesh.StackedIndex) of the
    columns of A and the three cohorts (each padded to A's 2e7 rows), of
    the gt planes of B and A (A's plane rows past 2^31 words), and of all
    four planes of B and two re-submitted row subsets of it;
20. kernel vs twin (stacked_query, stacked_selected): B = 1, 16, 64 and
    512 in every alt mode, all-ones, sparse and empty masks, counts both
    ways, crafted stacks with a padding dataset, rows near A's end,
    blocks of 1, 3 and 4 datasets (stacked_query's clusters), and the
    two-entry mesh [card, card] against the twins' sum;
21. mesh path: engines whose mesh is patched to list the card twice (the
    engine takes the mesh leg only at two devices, as the JAX engine
    does): A and the cohorts answering the fused-path mix, then A and B
    with their planes answering the selected-path mix, every response
    checked against the host matcher and host planes; launch counts
    zeroed just before each run and read just after;
22. timing (stacked_query, stacked_selected): one query a launch on each
    mesh entry's block as phase 21 launched, and 64, L2 cold and warm,
    beside the bound and the twin's time; with counts on phase 19's
    count-plane stack;
23. mesh-fused setup: MeshFusedIndexes on [card, card] (A and the
    cohorts; A and B with gt planes; B and two row subsets with four
    planes) and a crafted one on three entries with an empty group;
24. kernel vs twin (mesh_fused, ring_gather): every layout, batch size
    and plane form on every entry (on 0xDEADBEEF-filled outputs), the
    match-only cluster at 1-14 slots on entries of d_local 2 and 10; the
    ring on 2-4-entry rings of the
    card, aligned and not, and ring_step alone in and out of place,
    with and without next, against the twin's sum, inputs unchanged;
25. mesh-fused paths: a MeshDispatchTier over [card, card] in front of
    each engine, the fused mix with owner outputs (mesh_fused alone)
    and the selected mix sliced and combined (mesh_fused, then the
    ring), every response checked; launch counts zeroed just before
    each run and read just after;
25a. the tier's delta leg: after mesh_fused_path's traffic,
    ``l0_min_shards`` deltas published to each of its datasets and a
    burst of 64 requests (60% aimed at delta rows) served through the
    tier: base rows on mesh_fused, the tail on the engine's L0 index
    (bisect_query, fused_l0); every response against the host matcher
    on its shard, and every base and delta shard answered;
26. timing: mesh_fused at phase 25's slot counts (match-only every one,
    with planes the two most launched), and ring_step in its
    three forms (with next, last, first out of place) at phase 24's
    and phase 25's blocks beside acc.add_(src) (+ nxt.copy_(src)) or
    torch.add(own, src, out=acc), and a whole two-entry ring_gather
    beside [p0 + p1, p1 + p0], each beside its bound.

Each timing phase also prints a ``profile`` line: the kernels one call
of the wrapper ran, from a ``torch.profiler`` trace (scatter_match,
bisect_query, scatter_selected, plane_stats,
stacked_query, stacked_selected, match-only mesh_fused and ring_step
must run their one kernel and nothing else).
With ``--parent DIR`` (another
checkout, e.g. the parent commit unpacked from ``git archive``, which
must lie under this checkout's ``build/``: its kernels build into
``DIR/build/kernels``), phases
5, 9, 14, 22 and 26 build that checkout's seven kernels (scatter_match,
bisect_query, scatter_selected, plane_stats, stacked_query,
stacked_selected, mesh_fused) from its sources and time them on the
same inputs in turns with this tree's (parent, this, this, parent),
reported as ``parent_ms`` / ``parent_warm_ms`` and each take under
``turns``.

The serving phases of earlier slices (4, 8, 13, 21, 25) run engines
with the response cache off, so their numbers stay comparable across
PRs; each line says so (``response_cache``).

Then one ``{"kernels": [...]}`` line (the nine CUDA kernels; bisect_query
carries its L0 form under ``l0``, distinct_count its mesh run under
``mesh``), the
nvidia-smi line as it prints it, and as the last line ``{"ok": true,
"device": {...}}``. The script exits non-zero, printing no result, when
no CUDA device is available. Device times come from CUDA events
(``sbeacon_tpu_torch.ops.timing``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks at the 700 W limit: HBM3 bytes/s (NVIDIA data sheet),
# and 32-bit integer operations/s outside the tensor cores (132 SMs x 64
# int32 lanes per SM (Hopper whitepaper) x the 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations per window lane of the match kernel: 6 loads, about
# 20 compares/ands for the predicates and the type chain, the sums and
# the mask packing
MATCH_OPS_PER_LANE = 40
# bytes of one memory sector, the least the device reads: 8 lanes of
# one packed row of a tile
SECTOR_BYTES = 32
# packed rows every window lane's predicates read (rec_end, ref_hash,
# alt_hash, lens, flags, ac); AN is read at first-matched lanes only
ROWS_PER_LANE = 6

NSLOTS = 2048  # scatter_kernel.CHUNK: the slots of a full batch
# integer operations per valid window lane of the bisection kernel
# (about 10 loads, the predicate chain, the sums and the compaction),
# and per probe of its two searches
BISECT_OPS_PER_LANE = 30
BISECT_OPS_PER_PROBE = 4
# variantType values outside the five the device types: each one is
# answered on the device by the fused path as a symbolic-prefix match
OTHER_TYPES = ["CN", "DE", "CN0", "INV", "SNP"]
GENOME_BP = 2.875e9  # chr1-22, GRCh38
MICROBATCH_WAIT_MS = 2.0
#: cache_path: distinct bodies of the main mix, each sent this many
#: times, and the rows of the delta published over one bracket
CACHE_BODIES = 96
CACHE_REPEATS = 4
DELTA_REGION_ROWS = 4000
#: delta_path: delta shards a key before the traffic, their row range,
#: the publishes made while it runs, and the share of its bodies aimed
#: at delta rows
DELTA_SHARDS = 40
DELTA_ROWS = (1000, 8000)
DELTA_WRITES = 16
#: requests of the tier's delta leg (phase 25a)
TIER_DELTA_REQUESTS = 64
P_DELTA = 0.4
#: the engines of the serving phases of earlier slices: the response
#: cache off, so their requests/s and launch counts stay comparable
#: across PRs (cache_path and delta_path run with it on)
SERVING_PHASE_CONFIG = {"microbatch_wait_ms": MICROBATCH_WAIT_MS,
                        "response_cache": False}
# integer operations per plane word a matched row reads (load, and,
# popcount, add)
PLANE_OPS_PER_WORD = 4
PLANE_DENSITY = 0.01  # about 1% of a plane's genotype bits set
# integer operations per key of the distinct count (three 8-byte loads,
# the hash, a probe, six compares)
DISTINCT_OPS_PER_KEY = 40
RESUBMITTED = 3  # seeded row subsets of dataset A in the distinct path
P_DERIVED = 0.3  # dataset B's share of records counted from genotypes
# the plane budget of the mesh path's selected engine: A's and B's planes
# (8.85 GB) and the stack's per-device bytes (6.3 GB; twice that on the
# card, whose two mesh entries are one device)
MESH_PLANE_BUDGET_GB = 40.0


# the kernels timed beside the parent's with --parent
PARENT_TIMED = ("scatter_match", "bisect_query", "scatter_selected",
                "plane_stats", "stacked_query", "stacked_selected",
                "mesh_fused")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def crafted_records():
    """A small corpus holding the shapes the big corpus lacks: records
    of 12 alts (longer than the twin's K-shift regime), a length-clamped
    row, and dense multi-alt records straddling tile boundaries."""
    from sbeacon_tpu_torch.genomics.vcf import VcfRecord
    from sbeacon_tpu_torch.testing import random_records

    rng = random.Random(5)
    recs = random_records(
        rng, chrom="1", n=3000, n_samples=0, spacing=10, p_symbolic=0.15,
        p_multiallelic=0.3,
    )
    for i in range(400):
        recs.append(
            VcfRecord(
                chrom="5", pos=1000 + 3 * i, ref="A",
                alts=["T"] if i % 2 else ["C", "G", "TT"],
                vt="N/A", ac=[1] if i % 2 else [1, 2, 0], an=10, genotypes=[],
            )
        )
    for i in range(30):
        recs.append(
            VcfRecord(
                chrom="5", pos=5000 + 7 * i, ref="AC",
                alts=[b * k for k in (1, 2, 3) for b in "ACGT"],
                vt="N/A", ac=[(i + j) % 4 for j in range(12)], an=40,
                genotypes=[],
            )
        )
    recs.append(
        VcfRecord(
            chrom="5", pos=5050, ref="A" * 9000, alts=["C" * 8500],
            vt="N/A", ac=[1], an=4, genotypes=[],
        )
    )
    return recs


def tier_specs(shard, rng, n, lo_rows, hi_rows, exact, row_lo=0):
    """n QuerySpecs on random rows (from ``row_lo`` on) of ``shard`` whose
    windows span lo_rows..hi_rows rows; every spec hits its own row
    (exact ref/alt when ``exact``, else any-base, a variant type, or a
    typed alt)."""
    from sbeacon_tpu_torch.ops.kernel import QuerySpec

    pos = shard.cols["pos"]
    offs = shard.chrom_offsets
    out = []
    for _ in range(n):
        i = rng.randrange(row_lo, shard.n_rows)
        code = int(np.searchsorted(offs, i, side="right")) - 1
        last = min(i + rng.randint(lo_rows, hi_rows) - 1, int(offs[code + 1]) - 1)
        kw = dict(
            chrom=shard.row_chrom(i), start_min=int(pos[i]),
            start_max=int(pos[last]), end_min=1, end_max=1 << 30,
        )
        if exact:
            kw.update(
                reference_bases=rng.choice(["N", shard.row_ref(i)]),
                alternate_bases=shard.row_alt(i),
            )
        else:
            kind = rng.randrange(3)
            if kind == 0:
                kw.update(alternate_bases="N")
            elif kind == 1:
                kw.update(variant_type=rng.choice(
                    ["DEL", "INS", "DUP", "DUP:TANDEM", "CNV"]))
            else:
                kw.update(reference_bases=shard.row_ref(i),
                          alternate_bases=shard.row_alt(i))
        out.append(QuerySpec(**kw))
    return out


def kernel_inputs(index, specs, device):
    """(tile_ids, q8) device tensors for specs, as run_queries_scattered
    packs them."""
    import torch

    from sbeacon_tpu_torch.ops.kernel import encode_queries
    from sbeacon_tpu_torch.ops.query_pack import pack_q8, window_bounds

    enc = encode_queries(specs)
    lo, hi = window_bounds(index, enc)
    q8, _ = pack_q8(enc, lo, hi)
    ids = (lo // index.tile).astype(np.int32)
    return (
        torch.from_numpy(ids).to(device),
        torch.from_numpy(np.ascontiguousarray(q8)).to(device),
    )


def padded_inputs(index, specs, device):
    """(tile_ids, q8) device tensors of specs padded as _launch_tier pads
    a batch of at most CHUNK_SMALL queries: to CHUNK_SMALL slots, q8 all
    zeros and tile 0 in the pad slots."""
    import torch

    from sbeacon_tpu_torch.ops import scatter_kernel as sk

    ids, q8 = (x.cpu().numpy() for x in kernel_inputs(index, specs, "cpu"))
    pad = sk.CHUNK_SMALL - len(specs)
    ids = np.concatenate([ids, np.zeros(pad, np.int32)])
    q8 = np.concatenate([q8, np.zeros((pad, 8), np.int32)])
    return torch.from_numpy(ids).to(device), torch.from_numpy(q8).to(device)


class DeadbeefOutputs:
    """Within the block, int32 buffers from torch.empty come filled with
    0xDEADBEEF, so a kernel output word the launch leaves unwritten
    shows."""

    def __enter__(self):
        import torch

        self.empty = empty = torch.empty

        def filled(*a, **kw):
            out = empty(*a, **kw)
            if out.dtype == torch.int32:
                out.fill_(-0x21524111)
            return out

        torch.empty = filled
        return self

    def __exit__(self, *exc):
        import torch

        torch.empty = self.empty


def tiers(T):
    """(C, cap, rows_lo, rows_hi) of every specialisation the serving
    path launches at the default window_cap: the single-tile tier and
    each window-cap tier of _tier_caps."""
    return [(1, T, 1, 1), (2, T, 1, T), (5, 4 * T, T + 1, 4 * T),
            (17, 16 * T, 4 * T + 1, 16 * T)]


def compare_kernel(index, device, rng, n_slots, label):
    """Kernel vs twin for every (C, exact_only) and both twin forms;
    returns (max_abs_err, rows of the comparison report)."""
    import torch

    from sbeacon_tpu_torch.ops import scatter_kernel as sk

    T = index.tile
    report = []
    worst = 0
    for C, cap, r_lo, r_hi in tiers(T):
        for exact in (True, False):
            specs = tier_specs(index.shard, rng, n_slots, r_lo, r_hi, exact)
            ids, q8 = kernel_inputs(index, specs, device)
            agg, masks, _seq = sk.scatter_match(
                index.tiles, ids, q8, T=T, CAP=cap, C=C, exact_only=exact
            )
            torch.cuda.synchronize()
            hits = int(agg[:, 4].sum())
            check(hits > 0, f"{label} C={C} exact={exact}: no lane matched")
            for form, seg_k in (("shift", index.seg_k), ("scan", None)):
                want_agg, want_masks = sk.scatter_core_reference(
                    index.tiles, ids, q8, T=T, CAP=cap, C=C,
                    exact_only=exact, seg_k=seg_k,
                )
                err = max(
                    int((agg - want_agg).abs().max()),
                    int((masks - want_masks).abs().max()),
                )
                worst = max(worst, err)
                equal = torch.equal(agg, want_agg) and torch.equal(
                    masks, want_masks
                )
                check(equal, f"{label} C={C} exact={exact} {form}: kernel != twin")
                report.append(
                    {"index": label, "C": C, "cap": cap, "exact_only": exact,
                     "form": form, "slots": n_slots, "matched_lanes": hits,
                     "equal": equal}
                )
            # the main path's launch: a few queries padded to 64 slots,
            # on 0xDEADBEEF-filled outputs
            for n_real in (1, 6, 15):
                specs = tier_specs(index.shard, rng, n_real, r_lo, r_hi, exact)
                ids, q8 = padded_inputs(index, specs, device)
                with DeadbeefOutputs():
                    agg, masks, _seq = sk.scatter_match(
                        index.tiles, ids, q8, T=T, CAP=cap, C=C,
                        exact_only=exact)
                    torch.cuda.synchronize()
                want_agg, want_masks = sk.scatter_core_reference(
                    index.tiles, ids, q8, T=T, CAP=cap, C=C,
                    exact_only=exact, seg_k=None)
                err = max(int((agg - want_agg).abs().max()),
                          int((masks - want_masks).abs().max()))
                worst = max(worst, err)
                equal = torch.equal(agg, want_agg) and torch.equal(
                    masks, want_masks)
                check(equal, f"{label} C={C} exact={exact} {n_real} of "
                      f"{sk.CHUNK_SMALL} slots: kernel != twin")
                report.append(
                    {"index": label, "C": C, "cap": cap, "exact_only": exact,
                     "form": "scan", "slots": sk.CHUNK_SMALL,
                     "real_slots": n_real,
                     "matched_lanes": int(agg[:, 4].sum()), "equal": equal})
    return worst, report


def request_bodies(shard, rng, n, window_cap, p_other=0.0):
    """Beacon POST bodies in the BASELINE mix: SNV points with exact
    ref/alt picked to hit, start-end brackets spanning the tier caps,
    typed and any-base queries, and a few wider than window_cap. A
    share ``p_other`` asks for a variantType outside the five."""
    pos = shard.cols["pos"]
    bodies = []
    for k in range(n):
        i = rng.randrange(shard.n_rows)
        p = int(pos[i])
        ref = shard.row_ref(i)
        rp = {"assemblyId": "GRCh38", "referenceName": shard.row_chrom(i)}
        r = rng.random()
        if p_other and rng.random() < p_other:
            w = rng.choice([5_000, 30_000])
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w + 10_000],
                      variantType=rng.choice(OTHER_TYPES))
        elif r < 0.4:
            while not (len(ref) == 1 and shard.row_alt(i) in "ACGT"):
                i = rng.randrange(shard.n_rows)  # an SNV row
                ref = shard.row_ref(i)
            p = int(pos[i])
            rp.update(referenceName=shard.row_chrom(i), start=[p - 1],
                      end=[p + len(ref) + 5], referenceBases=ref,
                      alternateBases=shard.row_alt(i))
        elif r < 0.65:
            w = rng.choice([2_000, 20_000, 60_000, 200_000])
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w + 10_000],
                      alternateBases=rng.choice(["N", "A", "C", "G", "T"]))
        elif r < 0.9:
            w = rng.choice([500, 5_000, 30_000])
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w + 10_000])
            if rng.random() < 0.6:
                rp["variantType"] = rng.choice(["DEL", "INS", "DUP", "CNV"])
            else:
                rp["alternateBases"] = "N"
        else:
            # about 4x window_cap rows: the host path answers these
            w = int(4 * window_cap * GENOME_BP / shard.n_rows)
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w],
                      alternateBases="N")
        gran = ("boolean", "count", "record")[k % 3]
        bodies.append(
            {"meta": {"apiVersion": "2.0"},
             "query": {"requestedGranularity": gran,
                       "includeResultsetResponses": "HIT",
                       "requestParameters": rp}}
        )
    return bodies


class RecordingEngine:
    """Forwards search() to the engine and keeps the calling thread's
    last (payload, responses), so each response can be checked."""

    def __init__(self, engine):
        self.engine = engine
        self.last = threading.local()

    def search(self, payload):
        responses = self.engine.search(payload)
        self.last.call = (payload, responses)
        return responses


def serve(rec, env, datasets, body, samples_by_dataset=None):
    """One Beacon request through the port's API path (selected samples
    when ``samples_by_dataset`` names some for every dataset); returns
    (envelope, ms, payload, responses)."""
    from sbeacon_tpu_torch.api.requests import parse_request
    from sbeacon_tpu_torch.api.variants import run_variant_search

    t0 = time.perf_counter()
    req = parse_request("POST", None, body)
    s_min, s_max, e_min, e_max = req.coordinates()
    agg = run_variant_search(
        rec, datasets, req, start_min=s_min, start_max=s_max,
        end_min=e_min, end_max=e_max, samples_by_dataset=samples_by_dataset,
    )
    doc = env.by_granularity(
        req.granularity, exists=agg.exists, count=len(agg.variants),
        results=agg.results[req.skip : req.skip + req.limit],
        set_type="genomicVariant", skip=req.skip, limit=req.limit,
    )
    ms = (time.perf_counter() - t0) * 1e3
    return (doc, ms) + rec.last.call


def payload_spec(payload):
    """The QuerySpec of a request's payload."""
    from sbeacon_tpu_torch.ops.kernel import QuerySpec

    return QuerySpec(
        chrom=payload.reference_name, start_min=payload.start_min,
        start_max=payload.start_max, end_min=payload.end_min,
        end_max=payload.end_max, reference_bases=payload.reference_bases,
        alternate_bases=payload.alternate_bases,
        variant_type=payload.variant_type,
        variant_min_length=payload.variant_min_length,
        variant_max_length=payload.variant_max_length,
    )


def expected_envelope(shards, env, body, payload):
    """The responses (one per shard, in the engine's order) and the
    envelope the host matcher and the host planes give for one request
    (for selected samples: the N-wildcard ref compare and the selected
    sample indices)."""
    from sbeacon_tpu_torch.api.requests import parse_request
    from sbeacon_tpu_torch.api.variants import VariantAggregation
    from sbeacon_tpu_torch.engine import host_match_rows, materialize_response

    spec = payload_spec(payload)
    selected = payload.selected_samples_only

    def selected_idx(shard):
        if not selected:
            return None
        idx = {s: k for k, s in enumerate(shard.meta["sample_names"])}
        names = payload.sample_names.get(shard.meta["dataset_id"], [])
        return [idx[s] for s in names if s in idx]

    resps = [
        materialize_response(
            shard, host_match_rows(shard, spec, ref_wildcard=selected),
            payload,
            chrom_label=shard.meta["chrom_native"][payload.reference_name],
            dataset_id=shard.meta["dataset_id"],
            vcf_location=shard.meta["vcf_location"],
            selected_idx=selected_idx(shard),
        )
        for shard in shards
    ]
    req = parse_request("POST", None, body)
    agg = VariantAggregation(req.assembly_id or "")
    agg.add(resps, granularity=req.granularity,
            check_all=req.include_resultset_responses in ("HIT", "ALL"))
    doc = env.by_granularity(
        req.granularity, exists=agg.exists, count=len(agg.variants),
        results=agg.results[req.skip : req.skip + req.limit],
        set_type="genomicVariant", skip=req.skip, limit=req.limit,
    )
    return resps, doc


def run_main_path(engine, env, shards, bodies, threads):
    """Serve every body over the datasets of ``shards`` from
    ``threads`` threads; returns ([(envelope, ms, payload, responses)],
    wall s)."""
    datasets = [{"id": s.meta["dataset_id"]} for s in shards]
    return run_jobs(engine, env, [(datasets, b, None) for b in bodies],
                    threads)


def run_jobs(engine, env, jobs, threads):
    """Serve every (datasets, body, samples_by_dataset) job from
    ``threads`` threads; returns ([(envelope, ms, payload, responses)],
    wall s)."""
    rec = RecordingEngine(engine)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        out = list(pool.map(lambda j: serve(rec, env, *j), jobs))
    return out, time.perf_counter() - t0


def check_served(shards, env, bodies, served):
    """(requests that hit, mismatches): every response of every request
    against the host matcher's, and its envelope. A request is checked
    against the shards of the datasets its payload names."""
    from sbeacon_tpu_torch.payloads import VariantSearchResponse

    n_hit = mismatches = 0
    for body, (doc, _ms, payload, responses) in zip(bodies, served):
        mine = [s for s in shards if s.meta["dataset_id"] in payload.dataset_ids]
        want_resps, want_doc = expected_envelope(mine, env, body, payload)
        check(len(responses) == len(mine)
              and all(isinstance(r, VariantSearchResponse)
                      for r in responses),
              "one response per dataset")
        ok = ([dataclasses.asdict(r) for r in responses]
              == [dataclasses.asdict(r) for r in want_resps]
              and json.dumps(doc, sort_keys=True)
              == json.dumps(want_doc, sort_keys=True))
        mismatches += not ok
        n_hit += any(r.exists for r in want_resps)
    return n_hit, mismatches


def percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def needed_bytes(index, ids, q8, masks, C, cap, io=None):
    """(bytes, window lanes) one launch needs at the least: the sectors
    of the six packed rows the predicates read, over the distinct window
    lanes of all its slots; the AN sector of each record's first matched
    lane (the kernel's rule, taken from its masks); the slot inputs read
    once and the outputs written once (``io`` bytes, by default the
    match kernel's). Lanes outside a slot's window need no input."""
    import torch

    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.ops.query_pack import Q_HI, Q_LO

    T = index.tile
    span = C * T
    b = ids.shape[0]
    dev = ids.device
    gidx = ids[:, None].long() * T + torch.arange(span, device=dev)[None, :]
    lo = q8[:, Q_LO : Q_LO + 1].long()
    hi = q8[:, Q_HI : Q_HI + 1].long()
    win = (gidx >= lo) & (gidx < torch.minimum(hi, lo + cap))
    # a sector holds 8 lanes of one row: lane g of every row lies in
    # sector group g // 8
    row_groups = torch.unique(gidx[win] // 8).numel()

    bit = torch.arange(16, device=dev, dtype=torch.int32)
    m = ((masks[:, :, None] >> bit) & 1).reshape(b, span).bool()
    tile = (ids[:, None] + torch.arange(C, device=dev, dtype=ids.dtype)).clamp(
        0, index.n_tiles - 1
    )
    flags = index.tiles[tile.long(), sk.P_FLAGS, :].reshape(b, span)
    seg_begin = ((flags & sk.SAME_PREV) == 0) | (gidx == lo)
    mi = m.long()
    before = torch.cumsum(mi, dim=1) - mi
    base = torch.cummax(
        torch.where(seg_begin, before, torch.full_like(before, -1)), dim=1
    ).values
    first = m & (before == base)
    an_groups = torch.unique(gidx[first] // 8).numel()

    if io is None:
        io = b * (4 + 32) + b * (32 + span // 16 * 4)
    nbytes = (row_groups * ROWS_PER_LANE + an_groups) * SECTOR_BYTES + io
    return nbytes, int(win.sum())


def match_bound(index, sets, C, cap, exact):
    """Bound fields (bound_ms, bound_by, bytes) of one scatter_match
    launch, the mean over the (tile_ids, q8) ``sets``: the larger of its
    needed bytes at the HBM rate and its window lanes' operations at the
    int32 rate."""
    from sbeacon_tpu_torch.ops import scatter_kernel as sk

    need = []
    for ids, q8 in sets:
        _agg, masks, _seq = sk.scatter_match(
            index.tiles, ids, q8, T=index.tile, CAP=cap, C=C,
            exact_only=exact)
        need.append(needed_bytes(index, ids, q8, masks, C, cap))
    nbytes = float(np.mean([n for n, _l in need]))
    lanes = float(np.mean([l for _n, l in need]))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = lanes * MATCH_OPS_PER_LANE / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def time_kernel(index, device, rng, C, cap, r_lo, r_hi, exact, n_sets=16,
                parent=None):
    """Timing fields (ms, plain_ms, bound_ms, bound_by, bytes) per launch
    of one tier at NSLOTS slots. The launches cycle over ``n_sets``
    distinct random query sets so the gathered tiles (>= 8 MB a set) do
    not stay in the 50 MB L2, as for random serving traffic. With
    ``parent`` (``load_parent``) its kernel is timed in turns beside
    this one (``parent_ms``)."""
    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.ops import timing

    T = index.tile
    sets = [
        kernel_inputs(
            index, tier_specs(index.shard, rng, NSLOTS, r_lo, r_hi, exact),
            device,
        )
        for _ in range(n_sets)
    ]
    runs = {"this": sk.scatter_match}
    if parent is not None:
        runs = {"parent": parent.sk.scatter_match, **runs}
    fields = turn_fields(timed_in_turns(
        lambda fn: (timing.device_ms(
            lambda s: fn(index.tiles, s[0], s[1], T=T, CAP=cap, C=C,
                         exact_only=exact),
            sets, reps=4),), runs), ("ms",))
    plain_ms = timing.device_ms(
        lambda s: sk.scatter_core_reference(
            index.tiles, s[0], s[1], T=T, CAP=cap, C=C, exact_only=exact,
            seg_k=sk._static_seg_k(index),
        ),
        sets[:4], reps=1,
    )

    return {**fields, "plain_ms": plain_ms,
            **match_bound(index, sets, C, cap, exact)}


def time_kernel_padded(index, device, rng, C, cap, r_lo, r_hi, exact, n_real,
                       n_sets=16, parent=None):
    """Timing fields per launch of one tier at the main path's shape:
    ``n_real`` queries padded to CHUNK_SMALL slots as _launch_tier pads
    them. ``ms`` with the L2 flushed before each launch (the index far
    outgrows the L2, and a 64-slot set would stay in it), ``warm_ms``
    back to back, over ``n_sets`` random query sets; with ``parent``
    its kernel in turns beside this one (``parent_ms``,
    ``parent_warm_ms``)."""
    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.ops import timing

    T = index.tile
    sets = [padded_inputs(
        index, tier_specs(index.shard, rng, n_real, r_lo, r_hi, exact),
        device) for _ in range(n_sets)]
    runs = {"this": sk.scatter_match}
    if parent is not None:
        runs = {"parent": parent.sk.scatter_match, **runs}

    def measure(fn):
        call = lambda s: fn(index.tiles, s[0], s[1], T=T, CAP=cap, C=C,
                            exact_only=exact)
        return (timing.cold_device_ms(call, sets, device),
                timing.device_ms(call, sets, reps=4))

    fields = turn_fields(timed_in_turns(measure, runs), ("ms", "warm_ms"))
    plain_ms = timing.device_ms(
        lambda s: sk.scatter_core_reference(
            index.tiles, s[0], s[1], T=T, CAP=cap, C=C, exact_only=exact,
            seg_k=sk._static_seg_k(index)),
        sets[:4], reps=1)
    return {**fields, "plain_ms": plain_ms,
            **match_bound(index, sets, C, cap, exact)}


def fused_specs(shards, rng, n, kinds=None):
    """(specs, shard ids) of n queries spread over the stacked shards
    (some aimed at a chromosome a shard lacks), in every alt mode: exact
    points that hit, any-base brackets with wildcard or fixed refs, the
    five device types, types outside them (VT_OTHER), length bounds,
    windows wider than the kernel's, and dense brackets whose matches
    exceed record_cap."""
    from sbeacon_tpu_torch.ops.kernel import QuerySpec

    kinds = kinds or ("exact", "any", "typed", "other", "lengths", "wide",
                      "dense")
    specs, sids = [], []
    for _ in range(n):
        sid = rng.randrange(len(shards))
        sh = shards[sid]
        i = rng.randrange(sh.n_rows)
        p = int(sh.cols["pos"][i])
        chrom = sh.row_chrom(i) if rng.random() < 0.9 else rng.choice(
            ["1", "5", "22"])
        kind = rng.choice(kinds)
        w = rng.choice([0, 100, 2_000, 20_000])
        kw = dict(chrom=chrom, start_min=max(1, p - w), start_max=p + w,
                  end_min=1, end_max=1 << 30)
        if kind == "exact":
            kw.update(chrom=sh.row_chrom(i), start_min=p, start_max=p,
                      reference_bases=rng.choice([None, "N", sh.row_ref(i)]),
                      alternate_bases=sh.row_alt(i))
        elif kind == "any":
            kw.update(alternate_bases="N",
                      reference_bases=rng.choice([None, "N", "A", "C"]))
        elif kind == "typed":
            kw.update(variant_type=rng.choice(
                ["DEL", "INS", "DUP", "DUP:TANDEM", "CNV"]))
        elif kind == "other":
            kw.update(variant_type=rng.choice(OTHER_TYPES + [None]))
        elif kind == "lengths":
            kw.update(alternate_bases=rng.choice(["N", None]),
                      variant_min_length=rng.randint(0, 3),
                      variant_max_length=rng.choice([-1, 1, 5]))
        elif kind == "wide":
            kw.update(start_min=1, start_max=(1 << 31) - 1,
                      alternate_bases="N")
        else:  # dense: a bracket of about 1.7 window_caps of rows
            span = int(sh.cols["pos"][min(i + 1800, sh.n_rows - 1)]) - p
            kw.update(start_min=p, start_max=p + max(span, 0),
                      alternate_bases="N")
        specs.append(QuerySpec(**kw))
        sids.append(sid)
    return specs, sids


def bisect_inputs(index, specs, sids):
    import torch

    from sbeacon_tpu_torch.ops import kernel as tk

    enc = tk.encode_queries(specs, shard_ids=sids)
    return torch.from_numpy(tk.pack_queries(enc, fused=True)).to(index.device)


def compare_bisect(index, shards, rng, label, record_cap, batches=None,
                   W=None):
    """bisect_query vs its twin on 0xDEADBEEF-filled outputs, at 8, 64
    and 512 queries of ``fused_specs`` (or the given (specs, sids)
    batches) and window cap W (default min(2048, the index's window
    hint)); returns (max_abs_err, report rows)."""
    import torch

    from sbeacon_tpu_torch.ops import kernel as tk

    W = W or min(2048, index.window_hint)
    kw = dict(window_cap=W, record_cap=record_cap, n_iters=index.n_iters)
    args = (index.columns, index.alt_prefix, index.offsets)
    batches = batches or [fused_specs(shards, rng, b) for b in (8, 64, 512)]
    report, worst = [], 0
    for specs, sids in batches:
        q = bisect_inputs(index, specs, sids)
        want = tk.query_batch_reference(*args, q, **kw)
        agg = want[:, : tk.N_AGG].cpu().numpy()
        with DeadbeefOutputs():
            out, _seq = tk.bisect_query(*args, q, **kw)
            torch.cuda.synchronize()
        err = int((out.long() - want.long()).abs().max())
        worst = max(worst, err)
        equal = torch.equal(out, want)
        check(equal, f"{label} B={q.shape[0]} W={W} R={record_cap}: "
              "bisect_query != twin")
        report.append({
            "index": label, "queries": q.shape[0], "window": W,
            "record_cap": record_cap, "equal": equal,
            "matched": int(agg[:, 4].sum()),
            "overflow": int(agg[:, 5].sum()),
            "over_record_cap": int((agg[:, 4] > min(record_cap, W)).sum()),
            "empty": int((agg[:, 4] == 0).sum()),
        })
    return worst, report


def compare_bisect_edges(device):
    """bisect_query vs its twin on the window-edge stacks of 3 and 11
    shards (``testing.window_edge_shards``: windows of 1, 255-257, 1400,
    2048 lanes and past W, records of up to 40 rows cut by chunk and
    cluster-rank edges, 11 shards past the 9 segment rows loaded beside
    the query row), at window caps and record caps around those edges;
    returns (max_abs_err, report rows)."""
    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.testing import window_edge_shards, window_edge_specs

    worst, report = 0, []
    for n in (3, 11):
        shards = window_edge_shards(n)
        index = tk.FusedDeviceIndex(shards, device)
        for W, R in ((2048, 1024), (2048, 1), (700, 257), (257, 255),
                     (256, 16), (3000, 3000)):
            err, rep = compare_bisect(
                index, shards, None, f"edges{n}", R,
                [window_edge_specs(shards, seed=W + R + n)], W=W)
            worst, report = max(worst, err), report + rep
    return worst, report


def bound_of(nbytes, ops):
    """(bound ms, bound_by): the larger of the bytes at the HBM rate and
    the operations at the int32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def bisect_bound(index, q, out, W, R):
    """(bound ms, bound_by, bytes) of one bisect_query launch."""
    nbytes, ops = bisect_need(index, q, out, W, R)
    return (*bound_of(nbytes, ops), nbytes)


def bisect_need(index, q, out, W, R):
    """(bytes, operations) one bisect_query launch needs at the least.
    Bytes: the distinct 32-B sectors of the columns each query's
    predicates read over its valid lanes (rec_end, alt_len and rec_id
    always; ref hash and length for a fixed ref; alt hash for an exact
    alt; flags for the other modes, with ref length, repeat count and
    the 16-byte alt_prefix of symbolic rows for a typed one), AC at
    matched lanes and AN at first-matched lanes; 2 x n_iters probe
    sectors per query; the packed queries read once and the outputs
    written once."""
    import torch

    from sbeacon_tpu_torch.index.columnar import FLAG
    from sbeacon_tpu_torch.ops import kernel as tk

    dev = q.device
    cols = index.columns
    k = index.offsets.shape[0]
    sid = q[:, tk.QF_SHARD].long().clamp(0, k - 1)
    chrom = q[:, tk.QF_CHROM].long()
    seg_lo = index.offsets[sid, chrom.clamp(0, 26)].long()
    seg_hi = index.offsets[sid, (chrom + 1).clamp(0, 26)].long()
    pos = cols[tk.C_POS]
    lo = tk._bisect_reference(pos, q[:, tk.QF_START_MIN], seg_lo, seg_hi,
                              index.n_iters, upper=False)
    hi = tk._bisect_reference(pos, q[:, tk.QF_START_MAX], seg_lo, seg_hi,
                              index.n_iters, upper=True)
    nv = (hi - lo).clamp(0, W)
    lane = torch.arange(W, device=dev)[None, :]
    valid = lane < nv[:, None]
    rows = (lo[:, None] + lane)[valid]  # every valid lane's row
    qi = torch.arange(q.shape[0], device=dev)[:, None].expand(-1, W)[valid]
    mode = q[qi, tk.QF_ALT_MODE]
    fixed_ref = q[qi, tk.QF_REF_WILD] == 0
    sym = (cols[tk.C_FLAGS][rows] & FLAG.SYMBOLIC) != 0
    typed = (mode != tk.MODE_EXACT) & (mode != tk.MODE_ANY_BASE)
    need = {
        tk.C_REC_END: rows, tk.C_ALT_LEN: rows, tk.C_REC_ID: rows,
        tk.C_REF_HASH: rows[fixed_ref],
        tk.C_REF_LEN: rows[fixed_ref | typed],
        tk.C_ALT_HASH: rows[mode == tk.MODE_EXACT],
        tk.C_FLAGS: rows[mode != tk.MODE_EXACT],
        tk.C_REPEAT_K: rows[typed & ~sym],
    }
    sectors = sum(torch.unique(r // 8).numel() for r in need.values())
    sectors += torch.unique(rows[typed & sym] // 2).numel()  # alt_prefix
    # matched and first-matched lanes from the kernel's own row output
    # (a launch with R = W holds every matched lane)
    matched = out[:, tk.N_AGG:].long()
    m = matched >= 0
    rec = cols[tk.C_REC_ID][matched.clamp(min=0)]
    prev = torch.cat([torch.full_like(rec[:, :1], -1), rec[:, :-1]], dim=1)
    first = m & (rec != prev)
    sectors += torch.unique(matched[m] // 8).numel()  # AC
    sectors += torch.unique(matched[first] // 8).numel()  # AN
    b = q.shape[0]
    probes = 2 * index.n_iters * b
    io = q.numel() * 4 + b * (R + tk.N_AGG) * 4
    nbytes = (sectors + probes) * SECTOR_BYTES + io
    ops = (int(valid.sum()) * BISECT_OPS_PER_LANE
           + probes * BISECT_OPS_PER_PROBE)
    return nbytes, ops


def time_bisect(index, shards, rng, b, kind, record_cap, n_sets=16,
                parent=None):
    """Timing fields per launch of b queries of one kind ('point': exact
    SNV points; 'bracket': any-base and typed brackets of 2-200 kb) over
    n_sets query sets, with ``parent`` in turns beside the parent's
    kernel: ``ms`` cycling the sets back to back (the segment table and
    the top search levels stay in L2), ``ms_flushed`` with the L2
    flushed before each launch, ``warm_ms`` one set back to back (its
    rows in L2); the twin's ms, the bound, bound_by and bytes."""
    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.ops import timing

    W = min(2048, index.window_hint)
    kinds = ("exact",) if kind == "point" else ("any", "typed")
    sets = []
    for _ in range(n_sets):
        specs, sids = fused_specs(shards, rng, b, kinds)
        if kind == "bracket":
            for s in specs:
                w = rng.choice([2_000, 20_000, 60_000, 200_000])
                s.start_max = s.start_min + w
        sets.append(bisect_inputs(index, specs, sids))
    args = (index.columns, index.alt_prefix, index.offsets)
    kw = dict(window_cap=W, record_cap=record_cap, n_iters=index.n_iters)
    runs = {"this": lambda q: tk.bisect_query(*args, q, **kw)}
    if parent is not None:
        runs = {"parent": lambda q: parent.tk.bisect_query(*args, q, **kw),
                **runs}
    fields = turn_fields(timed_in_turns(
        lambda fn: (timing.device_ms(fn, sets, reps=4),
                    timing.cold_device_ms(fn, sets, index.device),
                    timing.device_ms(fn, sets[:1], reps=16)), runs),
        ("ms", "ms_flushed", "warm_ms"))
    # the twin enqueues about 600 small kernels a call, and a held
    # stream takes about 1000 before a launch blocks: one call per hold
    twin = lambda q: tk.query_batch_reference(*args, q, **kw)
    plain_ms = float(np.mean([timing.device_ms(twin, [q], reps=1)
                              for q in sets[:2]]))
    bounds = []
    for q in sets:
        full, _seq = tk.bisect_query(*args, q, window_cap=W, record_cap=W,
                                     n_iters=index.n_iters)
        bounds.append(bisect_bound(index, q, full, W, min(record_cap, W)))
    bound_ms = float(np.mean([x[0] for x in bounds]))
    nbytes = float(np.mean([x[2] for x in bounds]))
    by = "bytes" if all(x[1] == "bytes" for x in bounds) else "operations"
    return {**fields, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes}


def attach_planes(shard, n_samples, seed, device, *, counts, dataset_id):
    """A copy of ``shard`` (columns shared) with ``n_samples`` samples'
    genotype planes, their bits drawn by a seeded generator on
    ``device`` (about PLANE_DENSITY set, the tail word masked) and
    copied to the host shard. With ``counts``: gt2 = gt & random, tok1
    all ones, tok2 all ones but about 6% (haploid calls), and AC_INFO /
    AN_INFO cleared on a P_DERIVED share of the records, so those count
    from the planes."""
    import torch

    from sbeacon_tpu_torch.index.columnar import FLAG

    n = shard.n_rows
    w = (n_samples + 31) // 32
    gen = torch.Generator(device=device).manual_seed(seed)
    tail = torch.full((w,), -1, dtype=torch.int32, device=device)
    if n_samples % 32:
        tail[-1] = (1 << (n_samples % 32)) - 1
    k_and = max(1, int(round(-np.log2(PLANE_DENSITY))))

    def rand(m):
        return torch.randint(-(2**31), 2**31, (m, w), dtype=torch.int32,
                             device=device, generator=gen)

    def plane(make):
        host = np.empty((n, w), np.uint32)
        step = 1 << 20
        for i in range(0, n, step):
            m = min(step, n - i)
            host[i : i + m] = (make(m) & tail).cpu().numpy().view(np.uint32)
        return host

    def gt_bits(m):
        x = rand(m)
        for _ in range(k_and - 1):
            x &= rand(m)
        return x

    meta = dict(shard.meta, dataset_id=dataset_id,
                vcf_location=f"synthetic://{dataset_id}",
                sample_names=[f"S{i}" for i in range(n_samples)],
                sample_count=n_samples)
    cols = dict(shard.cols)
    planes = {"gt_bits": plane(gt_bits)}
    if counts:
        ones = lambda m: torch.full((m, w), -1, dtype=torch.int32,
                                    device=device)
        planes.update(
            gt_bits2=plane(lambda m: gt_bits(m) & rand(m)),
            tok_bits1=plane(ones),
            tok_bits2=plane(lambda m: ~(rand(m) & rand(m) & rand(m)
                                        & rand(m))),
        )
        derived = np.random.default_rng(seed).random(meta["n_records"])
        clear = derived[cols["rec_id"]] < P_DERIVED
        cols["flags"] = np.where(
            clear, cols["flags"] & ~np.int32(FLAG.AC_INFO | FLAG.AN_INFO),
            cols["flags"]).astype(np.int32)
    empty = np.zeros((0, 3), np.int64)
    return dataclasses.replace(shard, meta=meta, cols=cols, gt_overflow=empty,
                               tok_overflow=empty, **planes)


def crafted_plane_records():
    """40 samples (two plane words, a tail word), half the records
    without INFO AC/AN, ploidy > 2 genotypes ("1|1|1|1") and 12-alt
    records, for the fused kernel's twin comparison."""
    from sbeacon_tpu_torch.genomics.vcf import VcfRecord
    from sbeacon_tpu_torch.testing import random_records

    rng = random.Random(7)
    recs = random_records(rng, chrom="1", n=3000, n_samples=40, spacing=10,
                          p_symbolic=0.1, p_multiallelic=0.3, p_no_acan=0.5)
    for rec in recs[::9]:
        rec.genotypes[rng.randrange(40)] = "1|1|1|1"
        rec.ac = rec.an = None
    for i in range(30):
        recs.append(VcfRecord(
            chrom="1", pos=recs[-1].pos + 7, ref="AC",
            alts=[b * k for k in (1, 2, 3) for b in "ACGT"], vt="N/A",
            ac=None if i % 2 else [(i + j) % 4 for j in range(12)],
            an=None if i % 2 else 80,
            genotypes=[f"{rng.randint(0, 12)}/{rng.randint(0, 12)}"
                       for _ in range(40)],
        ))
    return recs


def mask_rows(rng, b, w, n_samples):
    """[b, w] uint32 masks cycling all-ones, sparse (1-500 samples) and
    empty."""
    out = np.zeros((b, w), np.uint32)
    for k in range(b):
        kind = k % 3
        if kind == 0:
            out[k] = 0xFFFFFFFF
        elif kind == 1:
            for si in rng.sample(range(n_samples),
                                 rng.randint(1, min(500, n_samples))):
                out[k, si // 32] |= np.uint32(1 << (si % 32))
    return out


def plane_args(pidx, with_counts):
    gt = pidx.gt
    return (gt, pidx.gt2, pidx.tok1, pidx.tok2) if with_counts else (gt,) * 4


def compare_selected(index, pidx, rng, label, record_cap, cases, row_lo=0):
    """scatter_selected vs its twin (both first-match forms) over
    ``cases`` of (C, cap, rows_lo, rows_hi, exact, with_counts, B), the
    queries on rows from ``row_lo`` on; returns (max_abs_err, report
    rows)."""
    import torch

    from sbeacon_tpu_torch.ops import scatter_kernel as sk

    T = index.tile
    n_samples = len(index.shard.meta["sample_names"])
    report, worst = [], 0
    for ci, (C, cap, r_lo, r_hi, exact, with_counts, b) in enumerate(cases):
        specs = tier_specs(index.shard, rng, b, r_lo, r_hi, exact, row_lo)
        ids, q8 = kernel_inputs(index, specs, index.device)
        # every mask kind in each batch; the single slots take them in turn
        masks = mask_rows(rng, max(b, 3), pidx.n_words, n_samples)
        masks = masks[ci % 3 : ci % 3 + 1] if b == 1 else masks
        mask = torch.from_numpy(masks.view(np.int32)).to(index.device)
        R = min(record_cap, cap)
        planes = plane_args(pidx, with_counts)
        got = sk.scatter_selected(
            index.tiles, *planes, ids, q8, mask, T=T, CAP=cap, C=C,
            exact_only=exact, R=R, with_counts=with_counts)
        torch.cuda.synchronize()
        for form, seg_k in (("shift", index.seg_k), ("scan", None)):
            want = sk.scatter_selected_reference(
                index.tiles, *planes, ids, q8, mask, T=T, CAP=cap, C=C,
                exact_only=exact, R=R, with_counts=with_counts, seg_k=seg_k)
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got[:5], want))
            worst = max(worst, err)
            equal = all(torch.equal(g, w) for g, w in zip(got[:5], want))
            check(equal, f"{label} C={C} exact={exact} counts={with_counts} "
                  f"B={b} {form}: scatter_selected != twin")
            report.append({
                "index": label, "C": C, "cap": cap, "R": R, "exact_only": exact,
                "with_counts": with_counts, "slots": b, "form": form,
                "equal": equal, "matched": int(got[0][:, 4].sum()),
                "rows": int((got[1] >= 0).sum()),
                "max_row": int(got[1].max()),
                "or_bits": int(sum(bin(int(x) & 0xFFFFFFFF).count("1")
                                   for x in got[4].flatten().tolist())),
            })
    return worst, report


def row_sets(rng, n_rows, size, n_sets, lo=0):
    """``n_sets`` ascending row sets of ``size`` rows from ``lo`` on, each
    drawn from a window of about twice its size (the shape of a
    matched-row set)."""
    out = []
    for _ in range(n_sets):
        span = min(n_rows - lo, 2 * size)
        a = rng.randrange(lo, n_rows - span + 1)
        out.append(np.sort(np.asarray(rng.sample(range(a, a + span), size),
                                      np.int32)))
    return out


def compare_plane_stats(pidx, rng, label, sizes, sels, counts_opts, lo=0):
    """plane_stats vs its twin over row sets of ``sizes`` rows from row
    ``lo`` on, each or_sel kind of ``sels`` and each of ``counts_opts``;
    returns (max_abs_err, report rows)."""
    import torch

    from sbeacon_tpu_torch.ops import plane_kernel as pk

    dev = pidx.device
    report, worst = [], 0
    n_samples = pidx.n_words * 32
    masks = mask_rows(rng, 3, pidx.n_words, n_samples)  # ones, sparse, empty
    for size in sizes:
        rows_np = row_sets(rng, pidx.n_rows, size, 1, lo)[0]
        rows = torch.from_numpy(rows_np).to(dev)
        for sel in sels:
            or_sel = {"none": np.zeros(size, np.int32),
                      "all": np.ones(size, np.int32),
                      "some": (np.arange(size) % 3 == 0).astype(np.int32)}[sel]
            or_sel = torch.from_numpy(or_sel).to(dev)
            for with_counts in counts_opts:
                m = masks[len(report) % 3]
                mask = torch.from_numpy(m.view(np.int32)).to(dev)
                kw = dict(with_counts=with_counts, with_or=sel != "none")
                planes = plane_args(pidx, with_counts)
                with DeadbeefOutputs():
                    counts, ow, _seq = pk.plane_stats(*planes, rows, or_sel,
                                                      mask, **kw)
                    torch.cuda.synchronize()
                want = pk.plane_stats_reference(*planes, rows, or_sel, mask,
                                                **kw)
                err = max(int((counts - want[0]).abs().max()),
                          int((ow.long() - want[1].long()).abs().max()))
                worst = max(worst, err)
                equal = torch.equal(counts, want[0]) and torch.equal(ow, want[1])
                check(equal, f"{label} rows={size} or_sel={sel} "
                      f"counts={with_counts}: plane_stats != twin")
                report.append({"index": label, "rows": size,
                               "max_row": int(rows_np[-1]), "or_sel": sel,
                               "with_counts": with_counts,
                               "mask": ("ones", "sparse", "empty")[
                                   len(report) % 3], "equal": equal,
                               "popcount": int(counts.sum())})
    return worst, report


def compare_plane_edges(pidx, rng, label):
    """plane_stats vs its twin at the grid's edges on 0xDEADBEEF-filled
    outputs: R of 0, 1, below one block's rows, not a multiple of a
    warp's row group, and past the grid's cap, row ids past both ends of
    the plane (they clamp), or_sel none, some and all, with and without
    counts (where the planes have them), each case launched three times
    in a row (the fold's ticket resets); returns (max_abs_err, report
    rows)."""
    import torch

    from sbeacon_tpu_torch.ops import plane_kernel as pk

    dev = pidx.device
    report, worst = [], 0
    masks = mask_rows(rng, 3, pidx.n_words, pidx.n_words * 32)
    counts_opts = (True, False) if pidx.has_counts else (False,)
    for size in (0, 1, 5, 7, 9, 63, 65, 2047, 70001):
        g = np.random.default_rng(size)
        rows = torch.from_numpy(g.integers(
            -5, pidx.n_rows + 5, size).astype(np.int32)).to(dev)
        for sel in ("none", "some", "all"):
            or_sel = torch.from_numpy({
                "none": np.zeros(size, np.int32),
                "all": np.ones(size, np.int32),
                "some": (g.random(size) < 0.01).astype(np.int32)}[sel]).to(
                    dev)
            for with_counts in counts_opts:
                kw = dict(with_counts=with_counts, with_or=sel != "none")
                planes = plane_args(pidx, with_counts)
                for k in range(3):
                    mask = torch.from_numpy(masks[k].view(np.int32)).to(dev)
                    with DeadbeefOutputs():
                        counts, ow, _seq = pk.plane_stats(
                            *planes, rows, or_sel, mask, **kw)
                        torch.cuda.synchronize()
                    want = pk.plane_stats_reference(*planes, rows, or_sel,
                                                    mask, **kw)
                    err = max(int((counts - want[0]).abs().max())
                              if size else 0,
                              int((ow.long() - want[1].long()).abs().max()))
                    worst = max(worst, err)
                    equal = (torch.equal(counts, want[0])
                             and torch.equal(ow, want[1]))
                    check(equal, f"{label} edge rows={size} or_sel={sel} "
                          f"counts={with_counts} take {k}: plane_stats != "
                          "twin")
                report.append({"index": label, "rows": size, "or_sel": sel,
                               "with_counts": with_counts, "takes": 3,
                               "equal": equal})
    return worst, report


def selected_jobs(shards, rng, n, window_cap):
    """(jobs, classes) for the selected path over datasets A and B: half
    name one dataset, half name none (both). The mix: 35% selected
    samples (1-500 per dataset), 30% sample extraction (record, HIT), 10%
    selected samples with an N in referenceBases, 10% about 4x
    window_cap rows wide (record), 15% boolean/count."""
    jobs, classes = [], []
    by_id = {s.meta["dataset_id"]: s for s in shards}
    for _ in range(n):
        named = ([rng.choice(sorted(by_id))] if rng.random() < 0.5
                 else sorted(by_id))
        shard = by_id[rng.choice(named)]
        r = rng.random()
        cls = ("selected" if r < 0.35 else "extract" if r < 0.65
               else "n_ref" if r < 0.75 else "wide" if r < 0.85 else "plain")
        i = rng.randrange(shard.n_rows)
        p = int(shard.cols["pos"][i])
        rp = {"assemblyId": "GRCh38", "referenceName": shard.row_chrom(i)}
        gran = "record"
        if cls == "wide":
            # about 4x window_cap rows of the densest dataset named
            dense = max(by_id[d].n_rows for d in named)
            w = int(4 * window_cap * GENOME_BP / dense)
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w],
                      alternateBases="N")
        elif cls == "n_ref":
            w = rng.choice([2_000, 20_000])
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w + 10_000],
                      referenceBases=rng.choice(["N", "AN", "NA", "NC"]),
                      alternateBases="N")
        elif rng.random() < 0.5:
            while not (len(shard.row_ref(i)) == 1 and shard.row_alt(i) in "ACGT"):
                i = rng.randrange(shard.n_rows)  # an SNV row
            p = int(shard.cols["pos"][i])
            rp.update(referenceName=shard.row_chrom(i), start=[p - 1],
                      end=[p + 6], referenceBases=shard.row_ref(i),
                      alternateBases=shard.row_alt(i))
        else:
            w = rng.choice([2_000, 20_000, 60_000])
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w + 10_000],
                      alternateBases=rng.choice(["N", "A", "C", "G", "T"]))
        if cls == "plain":
            gran = rng.choice(["boolean", "count"])
        elif cls == "selected" and rng.random() < 0.3:
            gran = "count"
        samples = None
        if cls in ("selected", "n_ref") or (cls == "wide" and rng.random() < 0.5):
            samples = {
                d: rng.sample(by_id[d].meta["sample_names"], rng.randint(
                    1, min(500, len(by_id[d].meta["sample_names"]))))
                for d in named
            }
        body = {"meta": {"apiVersion": "2.0"},
                "query": {"requestedGranularity": gran,
                          "includeResultsetResponses": "HIT",
                          "requestParameters": rp}}
        jobs.append(([{"id": d} for d in named], body, samples))
        classes.append(cls)
    return jobs, classes


def plane_sector_count(rows, w):
    """Distinct 32-B sectors of the W-word plane rows ``rows``."""
    import torch

    rows = torch.as_tensor(rows).long().flatten()
    rows = rows[rows >= 0]
    if not rows.numel():
        return 0
    first = rows * w * 4 // SECTOR_BYTES
    last = ((rows + 1) * w * 4 - 1) // SECTOR_BYTES
    n_max = int((last - first).max()) + 1
    sec = first[:, None] + torch.arange(n_max, device=rows.device)[None, :]
    return int(torch.unique(sec[sec <= last[:, None]]).numel())


def time_selected(index, pidx, rng, C, cap, b, exact, with_counts,
                  record_cap, n_sets=64, parent=None):
    """Timing fields (ms, warm_ms, plain_ms, bound_ms, bound_by, bytes)
    per launch of ``b`` slots of one (tier, exact) split over ``n_sets``
    query sets (selected masks of 1-500 samples with counts, all-ones
    without). The kernel ms finds the L2 cold, as a serving launch that
    reads its own query's plane rows does; the warm ms cycles the sets
    back to back, their few KB each staying in L2. With ``parent``, the
    parent's kernel (``parent_ms``) is timed in turns beside it.
    Bound, from 16 of the sets: the match kernel's window sectors, the
    32-B sectors of the plane rows each launch's matched rows read (x4
    with counts), and its inputs and outputs once."""
    import torch

    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.ops import timing

    T = index.tile
    span = C * T
    R = min(record_cap, cap)
    w = pidx.n_words
    n_samples = len(index.shard.meta["sample_names"])
    lo_r, hi_r = next((lo, hi) for c, _cp, lo, hi in tiers(T) if c == C)
    sets = []
    for _ in range(n_sets):
        ids, q8 = kernel_inputs(
            index, tier_specs(index.shard, rng, b, lo_r, hi_r, exact),
            index.device)
        masks = mask_rows(rng, 2, w, n_samples)[1 if with_counts else 0]
        mask = torch.from_numpy(np.tile(masks, (b, 1)).view(np.int32)).to(
            index.device)
        sets.append((ids, q8, mask))
    planes = plane_args(pidx, with_counts)
    kw = dict(T=T, CAP=cap, C=C, exact_only=exact, R=R,
              with_counts=with_counts)
    run = lambda s: sk.scatter_selected(index.tiles, *planes, *s, **kw)
    runs = {"this": run}
    if parent is not None:
        runs = {"parent": lambda s: parent.sk.scatter_selected(
            index.tiles, *planes, *s, **kw), **runs}
    fields = turn_fields(timed_in_turns(
        lambda fn: (timing.cold_device_ms(fn, sets, index.device),
                    timing.device_ms(fn, sets, reps=4)), runs),
        ("ms", "warm_ms"))
    twin = lambda s: sk.scatter_selected_reference(
        index.tiles, *planes, *s, T=T, CAP=cap, C=C, exact_only=exact, R=R,
        with_counts=with_counts, seg_k=sk._static_seg_k(index))
    plain_ms = float(np.mean([timing.device_ms(twin, [s], reps=1)
                              for s in sets[:2]]))
    k = 4 if with_counts else 1
    io = b * (4 + 32 + 4 * w) + b * (32 + 12 * R + 4 * w)
    need = []
    for ids, q8, mask in sets[:16]:
        _agg, masks, _seq = sk.scatter_match(index.tiles, ids, q8, T=T,
                                             CAP=cap, C=C, exact_only=exact)
        win_bytes, lanes = needed_bytes(index, ids, q8, masks, C, cap, io=io)
        rows = run((ids, q8, mask))[1]
        n_rows = int((rows >= 0).sum())
        nbytes = win_bytes + k * plane_sector_count(rows, w) * SECTOR_BYTES
        ops = lanes * MATCH_OPS_PER_LANE + n_rows * w * k * PLANE_OPS_PER_WORD
        need.append((nbytes, ops))
    nbytes = float(np.mean([x for x, _o in need]))
    ops = float(np.mean([o for _x, o in need]))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {**fields, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def time_plane_stats(pidx, rng, size, with_counts, with_or, n_sets=16,
                     parent=None):
    """Timing fields (ms, warm_ms, plain_ms, bound_ms, bound_by, bytes)
    per launch over ``size`` rows of ``n_sets`` row sets: the kernel ms
    with a cold L2, the warm ms cycling the sets back to back; with
    ``parent`` its kernel in turns beside (``parent_ms``,
    ``parent_warm_ms``). Bound: the distinct 32-B sectors of the rows'
    W-word plane rows (x4 with counts), the row ids, or_sel and mask
    read once, counts and OR words written once."""
    import torch

    from sbeacon_tpu_torch.ops import plane_kernel as pk
    from sbeacon_tpu_torch.ops import timing

    dev = pidx.device
    w = pidx.n_words
    n_samples = w * 32
    sets = []
    for rows in row_sets(rng, pidx.n_rows, size, n_sets):
        m = mask_rows(rng, 2, w, n_samples)[1 if with_counts else 0]
        sets.append((torch.from_numpy(rows).to(dev),
                     torch.ones(size, dtype=torch.int32, device=dev),
                     torch.from_numpy(m.view(np.int32)).to(dev)))
    planes = plane_args(pidx, with_counts)
    kw = dict(with_counts=with_counts, with_or=with_or)
    runs = {"this": lambda s: pk.plane_stats(*planes, *s, **kw)}
    if parent is not None:
        runs = {"parent": lambda s: parent.pk.plane_stats(*planes, *s, **kw),
                **runs}
    fields = turn_fields(timed_in_turns(
        lambda fn: (timing.cold_device_ms(fn, sets, dev, reps=4),
                    timing.device_ms(fn, sets, reps=4)), runs),
        ("ms", "warm_ms"))
    twin = lambda s: pk.plane_stats_reference(*planes, *s, **kw)
    plain_ms = float(np.mean([timing.device_ms(twin, [s], reps=1)
                              for s in sets[:2]]))
    k = 4 if with_counts else 1
    io = size * (4 + 4) + 4 * w + size * 16 + 4 * w
    nbytes = float(np.mean([
        k * plane_sector_count(s[0], w) * SECTOR_BYTES + io for s in sets]))
    ops = size * w * k * PLANE_OPS_PER_WORD
    bound_ms, by = bound_of(nbytes, ops)
    return {**fields, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes}


def resubmitted(shard, seed, n):
    """``n`` seeded row subsets of ``shard``, each 40-70% of its rows: the
    same sites submitted again in further VCFs of the dataset, the
    duplication the distinct-variant count removes."""
    from sbeacon_tpu_torch.testing import subset_shard

    g = np.random.default_rng(seed)
    out = []
    for k in range(n):
        rows = np.flatnonzero(g.random(shard.n_rows) < g.uniform(0.4, 0.7))
        out.append(subset_shard(
            shard, rows, dataset_id=f"{shard.meta['dataset_id']}_again{k}"))
    return out


def compare_distinct(keys, device):
    """distinct_count vs its twin on the card: the crafted key sets (every
    key equal, one column differing, high-bit patterns, pad rows, 0, 1,
    2 and 1000 keys), ``partition_keys`` blocks of the first 1e6 keys (one
    padded block, and four), and the full key set ``keys`` (a device
    tensor), each with the passes its buckets spilled to; returns
    (max_abs_err, report rows)."""
    import torch

    from sbeacon_tpu_torch.parallel import distinct as dc
    from sbeacon_tpu_torch.testing import distinct_key_cases

    head = keys[:1_000_000].cpu().numpy()
    cases = [(f"crafted:{k}", v) for k, v in distinct_key_cases().items()]
    cases += [("partition_keys:1", dc.partition_keys(head, 1)[0])]
    cases += [(f"partition_keys:4:{i}", b)
              for i, b in enumerate(dc.partition_keys(head, 4))]
    report, worst = [], 0
    for label, k in cases + [("full", keys)]:
        t = torch.as_tensor(k).to(device)
        spills = torch.zeros((), dtype=torch.int64, device=device)
        count, _seq = dc.distinct_count(t, spills=spills)
        torch.cuda.synchronize()
        got = int(count)
        want = int(dc.distinct_count_reference(t))
        worst = max(worst, abs(got - want))
        check(got == want, f"{label}: distinct_count {got} != twin {want}")
        report.append({"case": label, "keys": int(t.shape[0]),
                       "distinct": want, "equal": got == want,
                       "spill_passes": int(spills)})
    return worst, report


def event_ms(fn, arg, reps=3):
    """Mean device ms of ``fn(arg)`` between an event pair, for a call
    that synchronises inside (a warm call first)."""
    import torch

    fn(arg)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return float(np.mean(out))


def kernel_name(signature):
    """A kernel's bare name from the signature a profiler trace gives
    it ("void (anonymous namespace)::k<true>(int const*, ...)" -> "k")."""
    bare = signature.replace("(anonymous namespace)::", "")
    return bare.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


def profiled_call(fn, arg):
    """The ``torch.profiler`` trace of the card over one call of
    ``fn(arg)``, after a warm call. The call sits 50 ms inside each end
    of the traced window: with the window ending right after the call, a
    trace now and then (2 of 30 in a row on the H100) held no device
    event at all; padded, none of 60 did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn(arg)
        torch.cuda.synchronize()
        time.sleep(0.05)
    return prof


def kernel_breakdown(fn, arg):
    """Device ms of each CUDA kernel that one call of ``fn(arg)`` runs
    (a warm call first), by kernel name, from a ``torch.profiler`` trace
    of the card; an empty dict when the trace holds no device time."""
    out = {}
    for ev in profiled_call(fn, arg).key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us:
            name = kernel_name(ev.key)
            out[name] = out.get(name, 0.0) + us / 1e3
    return out


def kernels_run(fn, arg):
    """The names of the CUDA kernels one call of ``fn(arg)`` runs (a warm
    call first), in launch order, from a ``torch.profiler`` trace of the
    card."""
    import torch

    return [kernel_name(ev.name) for ev in profiled_call(fn, arg).events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def profile_line(kernel, fn, arg, expect=None, tries=3):
    """One ``profile`` line: the kernels one wrapper call ran, traced
    again (at most ``tries`` traces) while a trace holds no device event
    at all, which shows nothing of the call. With ``expect`` (a kernel
    function name) a trace that holds events must show that kernel and
    nothing else; when every trace was empty (``traced`` false) the
    check falls to the wrapper's launch records: one launch of
    ``kernel`` for each of the take's two calls (warm and traced)."""
    from sbeacon_tpu_torch import telemetry

    for n_traces in range(1, tries + 1):
        before = telemetry.launch_count(kernel)
        ran = kernels_run(fn, arg)
        launches = telemetry.launch_count(kernel) - before
        if ran:
            break
    emit("profile", kernel=kernel, ran=ran, traced=bool(ran),
         traces=n_traces, launches=launches)
    if expect is None:
        return
    if ran:
        check(ran == [expect], f"one {kernel} call ran {ran}, not one "
              f"{expect}")
    else:
        check(launches == 2, f"{n_traces} traces of {kernel} held no "
              f"device event, and its two calls recorded {launches} "
              "launches")


def profile_kernels(device):
    """One ``profile`` line per kernel: the kernels one wrapper call runs
    on small seeded inputs (three 20000-row shards of 70 samples with all
    four planes), each call in a ``torch.profiler`` session of its own.
    Meant for a process of its own (``profiled_kernels``): once a process
    has run one profiler session, later sessions that follow about a
    million other kernel launches record no device event."""
    import torch

    from sbeacon_tpu_torch.ops import gather_kernel as tg
    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.ops import plane_kernel as pk
    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.parallel import distinct as dc
    from sbeacon_tpu_torch.parallel import mesh as tm
    from sbeacon_tpu_torch.testing import synthetic_shard

    rng = random.Random(27)
    n_samples = 70
    shards = [attach_planes(
        synthetic_shard(20_000, seed=27 + i, n_samples=n_samples,
                        dataset_id=f"p{i}"),
        n_samples, 27 + i, device, counts=True, dataset_id=f"p{i}")
        for i in range(3)]
    s0 = shards[0]
    index = sk.ScatterDeviceIndex(s0, device)
    pidx = pk.PlaneDeviceIndex(s0, device)
    w = pidx.n_words
    ones = lambda *shape: torch.full(shape, -1, dtype=torch.int32,
                                     device=device)
    T = index.tile

    a = kernel_inputs(index, tier_specs(s0, rng, 16, 1, 1, True), device)
    profile_line(sk.KERNEL, lambda a: sk.scatter_match(
        index.tiles, *a, T=T, CAP=T, C=1, exact_only=True), a,
        expect="scatter_match_kernel")
    fused = tk.FusedDeviceIndex(shards, device)
    specs, sids = fused_specs(shards, rng, 16)
    profile_line(tk.KERNEL, lambda q: tk.bisect_query(
        fused.columns, fused.alt_prefix, fused.offsets, q, window_cap=2048,
        record_cap=1024, n_iters=fused.n_iters),
        bisect_inputs(fused, specs, sids), expect="bisect_query_kernel")
    for counts_on in (False, True):
        a = (*kernel_inputs(index, tier_specs(s0, rng, 1, 1, 1, True),
                            device), ones(1, w))
        profile_line(sk.SELECTED_KERNEL, lambda a: sk.scatter_selected(
            index.tiles, *plane_args(pidx, counts_on), *a, T=T, CAP=T, C=1,
            exact_only=True, R=T, with_counts=counts_on), a,
            expect="scatter_selected_kernel")
    rows = torch.arange(0, 7097 * 2, 2, dtype=torch.int32, device=device)
    for counts_on in (False, True):
        profile_line(pk.KERNEL, lambda a: pk.plane_stats(
            *plane_args(pidx, counts_on), *a, with_counts=counts_on,
            with_or=True), (rows, ones(rows.numel()).neg(), ones(w)),
            expect="plane_stats_kernel")
    keys = torch.from_numpy(dc.shard_keys(shards)).to(device)
    profile_line(dc.KERNEL, dc.distinct_count, keys)
    one = tm.make_mesh(devices=[device])
    (qblk,) = tm.StackedIndex(shards).shard_to_mesh(one)
    pstack = tm.StackedIndex(shards, with_planes=True)
    (pblk,) = pstack.shard_to_mesh(one)
    q = stack_q(fused_specs(shards, rng, 64)[0], device)
    profile_line(tm.QUERY_KERNEL, lambda q: tm.stacked_query(
        qblk.columns, qblk.alt_prefix, qblk.offsets, q, window_cap=2048,
        record_cap=1024, n_iters=pstack.n_iters), q,
        expect="stacked_query_kernel")
    masks = ones(pblk.n_datasets, pstack.plane_words)
    for counts_on in (False, True):
        profile_line(tm.SELECTED_KERNEL, lambda q: tm.stacked_selected(
            pblk.columns, pblk.alt_prefix, pblk.offsets,
            *block_planes(pblk, counts_on), masks, q, window_cap=2048,
            record_cap=1024, n_iters=pstack.n_iters, has_counts=counts_on),
            q, expect="stacked_selected_kernel")
    mfi = tm.MeshFusedIndex(shards, tm.Mesh([device, device]),
                            with_planes=True, layout=tm.LAYOUT_SLICED)
    specs, sids = fused_specs(shards, rng, 8)
    (_g, blk, kw), *_rest = fused_entry_inputs(
        mfi, specs, sids, mfi.layout,
        np.full((8, mfi.plane_words), 0xFFFFFFFF, np.uint32),
        np.ones(8, np.bool_))
    profile_line(tm.FUSED_KERNEL, lambda a: run_fused(
        a[0], a[1], tm.mesh_fused, 2048, 1024), (blk, kw))
    plain = tm.MeshFusedIndex(shards, tm.Mesh([device, device]))
    specs, sids = fused_specs(shards, rng, 8)
    (_g, blk, kw), *_rest = fused_entry_inputs(plain, specs, sids,
                                               tm.LAYOUT_OWNER)
    profile_line(tm.FUSED_KERNEL, lambda a: run_fused(
        a[0], a[1], tm.mesh_fused, 2048, 1024), (blk, kw),
        expect="mesh_fused_kernel")
    blocks = [ones(1, 12604) for _ in range(3)]
    profile_line(tg.KERNEL, lambda b: tg.ring_step(b[0], None, b[1],
                                                   own=b[2]),
                 blocks, expect="ring_step_vec")
    return 0


def profiled_kernels():
    """Run ``profile_kernels`` in a child process (the card's first
    profiler sessions there) and relay its lines; raises when the child
    fails. The child is waited for."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, torch, chip_smoke; sys.exit("
         "chip_smoke.profile_kernels(torch.device('cuda', 0)))"],
        cwd=here, capture_output=True, text=True, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    for l in lines:
        print(l, flush=True)
    check(proc.returncode == 0 and len(lines) == 13,
          f"the profiled kernel calls failed (rc {proc.returncode}): "
          f"{proc.stderr[-2000:]}")


def timed_in_turns(measure, runs):
    """``measure(run)`` for each run of ``runs`` (name -> callable) in
    turns: one take when there is one run, else the order A, B, ..., ...,
    B, A, so a drift of the card over the phase weighs on each run alike.
    Returns name -> the list of takes."""
    names = list(runs)
    order = names if len(names) == 1 else names + names[::-1]
    takes = {n: [] for n in names}
    for n in order:
        takes[n].append(measure(runs[n]))
    return takes


def turn_fields(takes, keys):
    """Case fields from ``timed_in_turns``: the mean of each key (the
    entries of a take) for run "this", ``<run>_<key>`` for the others,
    and the takes themselves when there are several runs."""
    out = {}
    for name, ts in takes.items():
        for i, k in enumerate(keys):
            v = float(np.mean([t[i] for t in ts]))
            out[k if name == "this" else f"{name}_{k}"] = v
    if len(takes) > 1:
        out["turns"] = {n: [list(t) for t in ts] for n, ts in takes.items()}
    return out


BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def parent_dir_ok(root):
    """Whether ``root`` lies under this checkout's ignored ``build/``, the
    one place ``--parent`` may build into."""
    from pathlib import Path

    return Path(root).resolve().is_relative_to(Path(BUILD_DIR).resolve())


def load_parent(root):
    """The port package of another checkout at ``root`` (the parent
    commit, for same-call timings), imported as
    ``parent_sbeacon_tpu_torch`` with its own kernel builds under
    ``root/build/kernels``: a namespace of its ``scatter_kernel``
    (``sk``), ``kernel`` (``tk``), ``plane_kernel`` (``pk``),
    ``parallel.mesh`` (``tm``) and ``_build``. The package
    imports only relatively, so the alias holds."""
    import importlib
    import importlib.util
    import types
    from pathlib import Path

    name = "parent_sbeacon_tpu_torch"
    pkg = Path(root).resolve() / "sbeacon_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(
        root=str(Path(root).resolve()),
        sk=importlib.import_module(name + ".ops.scatter_kernel"),
        tk=importlib.import_module(name + ".ops.kernel"),
        pk=importlib.import_module(name + ".ops.plane_kernel"),
        tm=importlib.import_module(name + ".parallel.mesh"),
        build=importlib.import_module(name + ".ops._build"))


# -- the serving hooks' cost (hooks_cost) -------------------------------------

#: the serving hooks the engine and the batcher call on every request
HOOKS = ("annotate", "plan_stage", "charge_cost", "charge_cost_to", "span",
         "fault_point", "current_deadline", "current_context",
         "request_context")


def hooks_cost(engine, payloads, kind, smi):
    """Phase 4a: what the serving hooks cost a request on the host. The
    payloads are served one at a time, without a request context (as
    the serving phases run: every hook is a no-op) and under one (the
    hooks record), in turns off, on, on, off; each hook's calls per
    request are counted over the payloads, and each no-op hook's cost
    a call taken with ``timeit`` beside an empty call."""
    import timeit

    from sbeacon_tpu_torch import engine as engine_mod
    from sbeacon_tpu_torch import serving as serving_mod
    from sbeacon_tpu_torch import telemetry
    from sbeacon_tpu_torch.harness.faults import fault_point
    from sbeacon_tpu_torch.plan import plan_stage
    from sbeacon_tpu_torch.resilience import current_deadline
    from sbeacon_tpu_torch.utils.trace import span

    def serial(with_ctx):
        t0 = time.perf_counter()
        for p in payloads:
            if with_ctx:
                ctx = telemetry.RequestContext(route="g_variants")
                with telemetry.request_context(ctx):
                    engine.search(p)
            else:
                engine.search(p)
        return (time.perf_counter() - t0) * 1e3 / len(payloads)

    turns = [(arm, serial(arm == "on")) for arm in ("off", "on", "on", "off")]
    calls = {}
    saved = []
    for mod in (engine_mod, serving_mod):
        for name in HOOKS:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        serial(False)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    def with_span():
        with span("engine.search"):
            pass

    n = 200_000
    each = {
        "empty_call": lambda: None,
        "annotate": lambda: telemetry.annotate(response_cache="miss"),
        "plan_stage": lambda: plan_stage("cache", decision="miss"),
        "charge_cost": lambda: telemetry.charge_cost(host_rows=1),
        "span": with_span,
        "fault_point": lambda: fault_point("kernel.launch"),
        "current_deadline": current_deadline,
        "current_context": telemetry.current_context,
    }
    ns = {k: timeit.timeit(f, number=n) / n * 1e9 for k, f in each.items()}
    per_req = {k: v / len(payloads) for k, v in sorted(calls.items())}
    off = [ms for arm, ms in turns if arm == "off"]
    on = [ms for arm, ms in turns if arm == "on"]
    emit("hooks_cost", engine="main_path's", requests=len(payloads),
         response_cache=engine.config.engine.response_cache,
         serial_ms_per_request=[{"arm": a, "ms": ms} for a, ms in turns],
         off_mean_ms=float(np.mean(off)), on_mean_ms=float(np.mean(on)),
         on_minus_off_ms=float(np.mean(on) - np.mean(off)),
         hook_calls_per_request=per_req, noop_ns_per_call=ns,
         noop_us_per_request_upper=sum(
             per_req.get(k, 0) * ns.get(k, ns["span"]) for k in per_req)
         / 1e3,
         note="host clock; off: no request context (every hook a no-op, "
              "as in the serving phases), on: one RequestContext a "
              "request; request_context and charge_cost_to take the "
              "span's cost a call in the upper estimate",
         device=kind, nvidia_smi=smi)


# -- the response cache and the delta tail (cache_path, delta_path) -----------


class ContextEngine:
    """Forwards search() to the engine under a fresh request context per
    call and keeps the calling thread's last (payload, responses) and
    (context, admit time, done time); counts the searches done."""

    def __init__(self, engine):
        self.engine = engine
        self.last = threading.local()
        self.done = 0
        self._lock = threading.Lock()

    def search(self, payload):
        from sbeacon_tpu_torch.telemetry import RequestContext, request_context

        ctx = RequestContext(route="g_variants")
        t0 = time.perf_counter()
        with request_context(ctx):
            responses = self.engine.search(payload)
        self.last.call = (payload, responses)
        self.last.extra = (ctx, t0, time.perf_counter())
        with self._lock:
            self.done += 1
        return responses


def run_ctx_jobs(rec, env, jobs, threads):
    """``run_jobs`` through a ContextEngine: ([(envelope, ms, payload,
    responses, context, admit, done)], wall s)."""
    def one(job):
        return serve(rec, env, *job) + rec.last.extra

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        out = list(pool.map(one, jobs))
    return out, time.perf_counter() - t0


def same_answer(a, b):
    """Two (envelope, ms, payload, responses, ...) records answer alike:
    equal envelopes, and equal responses once those that hold nothing
    (no match, no count) are left out. An entry cached before a delta
    whose region it does not overlap keeps answering without that
    delta's response, which can only be such an empty one (the JAX
    engine's scoped invalidation does the same)."""
    def held(rec):
        return [dataclasses.asdict(r) for r in rec[3]
                if r.exists or r.variants or r.call_count
                or r.all_alleles_count]

    return (held(a) == held(b)
            and json.dumps(a[0], sort_keys=True)
            == json.dumps(b[0], sort_keys=True))


def squeeze_into(shard, lo, hi):
    """``shard`` with its positions mapped monotonically into [lo, hi]
    (record ends moved with them): a delta over one bracketed region."""
    pos = shard.cols["pos"].astype(np.int64)
    span = max(1, int(pos.max() - pos.min()))
    new = lo + (pos - pos.min()) * (hi - lo) // span
    cols = dict(shard.cols)
    cols["rec_end"] = (shard.cols["rec_end"].astype(np.int64) - pos
                       + new).astype(np.int32)
    cols["pos"] = new.astype(np.int32)
    return dataclasses.replace(shard, cols=cols, meta=dict(shard.meta))


def body_bracket(body):
    """(chrom, lo, hi): the envelope of a body's start and end brackets,
    1-based."""
    rp = body["query"]["requestParameters"]
    start, end = rp["start"], rp["end"]
    lo = min(start[0], end[0]) + 1
    hi = max(start[-1], end[-1]) + 1
    return rp["referenceName"], lo, hi


def delta_expected(shard_of, env, body, payload, responses):
    """The host matcher's answer for the targets one request saw: a
    response per (dataset, label) of ``responses`` from the shard that
    label names (``shard_of``), and their envelope."""
    from sbeacon_tpu_torch.api.requests import parse_request
    from sbeacon_tpu_torch.api.variants import VariantAggregation
    from sbeacon_tpu_torch.engine import host_match_rows, materialize_response

    spec = payload_spec(payload)
    resps = []
    for r in responses:
        s = shard_of[(r.dataset_id, r.vcf_location)]
        resps.append(materialize_response(
            s, host_match_rows(s, spec), payload,
            chrom_label=s.meta["chrom_native"][payload.reference_name],
            dataset_id=r.dataset_id, vcf_location=r.vcf_location))
    req = parse_request("POST", None, body)
    agg = VariantAggregation(req.assembly_id or "")
    agg.add(resps, granularity=req.granularity,
            check_all=req.include_resultset_responses in ("HIT", "ALL"))
    doc = env.by_granularity(
        req.granularity, exists=agg.exists, count=len(agg.variants),
        results=agg.results[req.skip : req.skip + req.limit],
        set_type="genomicVariant", skip=req.skip, limit=req.limit,
    )
    return resps, doc


def bracket_monolith(shards, payload, dataset_id, vcf):
    """``materialize_response`` over ``host_match_rows`` on
    ``merge_shards`` of the rows of ``shards`` inside the payload's
    start bracket on its chromosome (the only rows the matcher reads,
    so the answer is the whole merge's)."""
    from sbeacon_tpu_torch.engine import host_match_rows, materialize_response
    from sbeacon_tpu_torch.index.columnar import merge_shards
    from sbeacon_tpu_torch.testing import subset_shard
    from sbeacon_tpu_torch.utils.chrom import chromosome_code

    spec = payload_spec(payload)
    code = chromosome_code(spec.chrom)
    subs = []
    for s in shards:
        lo, hi = int(s.chrom_offsets[code]), int(s.chrom_offsets[code + 1])
        pos = s.cols["pos"][lo:hi]
        a = lo + int(np.searchsorted(pos, spec.start_min, side="left"))
        b = lo + int(np.searchsorted(pos, spec.start_max, side="right"))
        subs.append(subset_shard(s, np.arange(a, b), dataset_id=dataset_id))
    merged = merge_shards(subs)
    return materialize_response(
        merged, host_match_rows(merged, spec), payload,
        chrom_label=shards[0].meta["chrom_native"][spec.chrom],
        dataset_id=dataset_id, vcf_location=vcf)


def monolith_agrees(mono, responses, granularity):
    """The split responses of one dataset add up to the monolith's:
    exists, and for count and record granularity the matched variants
    (as a multiset), the call count and the allele count."""
    if any(r.exists for r in responses) != mono.exists:
        return False
    if granularity == "boolean":
        return True
    return (sorted(v for r in responses for v in r.variants)
            == sorted(mono.variants)
            and sum(r.call_count for r in responses) == mono.call_count
            and sum(r.all_alleles_count for r in responses)
            == mono.all_alleles_count)


def delta_label_epoch(label):
    base, sep, epoch = label.rpartition("#d")
    return (base, int(epoch)) if sep else (label, None)


def check_delta_served(base_of, shard_of, published, env, jobs, served):
    """(mismatches, requests checked against the monolith, hits): every
    response of every request of the delta path against the host
    matcher on the shard its label names, and the envelope; the delta
    epochs a request saw against read-your-writes (every publish that
    ended before it was admitted, none that began after it was done);
    and each dataset's responses against the monolith: merge_shards of
    its base and the deltas the request saw, inside the bracket."""
    mismatches = hits = 0
    for (_datasets, body, _s), rec in zip(jobs, served):
        doc, _ms, payload, responses, _ctx, t_admit, t_done = rec
        want_resps, want_doc = delta_expected(shard_of, env, body, payload,
                                              responses)
        ok = ([dataclasses.asdict(r) for r in responses]
              == [dataclasses.asdict(r) for r in want_resps]
              and json.dumps(doc, sort_keys=True)
              == json.dumps(want_doc, sort_keys=True))
        seen = {}
        for r in responses:
            vcf, epoch = delta_label_epoch(r.vcf_location)
            if epoch is not None:
                seen.setdefault((r.dataset_id, vcf), set()).add(epoch)
        for (key, epoch), (t0, t1) in published.items():
            got = epoch in seen.get(key, set())
            if (t1 < t_admit and not got) or (t0 > t_done and got):
                ok = False
        for (ds, vcf), base in base_of.items():
            mine = [r for r in responses if r.dataset_id == ds]
            shards = [base] + [shard_of[(ds, r.vcf_location)] for r in mine
                               if r.vcf_location != vcf]
            mono = bracket_monolith(shards, payload, ds, vcf)
            ok &= monolith_agrees(mono, mine, payload.requested_granularity)
        mismatches += not ok
        hits += any(r.exists for r in want_resps)
    return mismatches, hits


def delta_aimed_bodies(shard, deltas, rng, n, window_cap, p_delta=0.4):
    """The fused_path mix over ``shard``, ``p_delta`` of it re-aimed at
    rows of the delta shards: SNV points with the row's ref and alt,
    and any-base or typed brackets of 2-60 kb starting at the row."""
    bodies = request_bodies(shard, rng, n, window_cap, p_other=0.05)
    for k in range(n):
        if rng.random() >= p_delta:
            continue
        d = rng.choice(deltas)
        i = rng.randrange(d.n_rows)
        p = int(d.cols["pos"][i])
        ref = d.row_ref(i)
        rp = {"assemblyId": "GRCh38", "referenceName": d.row_chrom(i)}
        if rng.random() < 0.4:
            rp.update(start=[p - 1], end=[p + len(ref) + 5],
                      referenceBases=ref, alternateBases=d.row_alt(i))
        else:
            w = rng.choice([2_000, 20_000, 60_000])
            rp.update(start=[p - 1, p - 1 + w], end=[p - 1, p + w + 10_000])
            if rng.random() < 0.5:
                rp["variantType"] = rng.choice(["DEL", "INS", "DUP", "CNV"])
            else:
                rp["alternateBases"] = "N"
        bodies[k]["query"]["requestParameters"] = rp
    return bodies


def legacy_shard_keys(shards):
    """The earlier key build (a stack per shard, then one
    concatenation), kept to time beside ``distinct.shard_keys`` and to
    hold its bytes equal."""
    parts = []
    for s in shards:
        n = s.n_rows
        codes = (np.searchsorted(s.chrom_offsets, np.arange(n), side="right")
                 - 1).astype(np.int32)
        parts.append(np.stack([
            codes, s.cols["pos"].astype(np.int32),
            s.cols["ref_hash"].astype(np.uint32).view(np.int32),
            s.cols["alt_hash"].astype(np.uint32).view(np.int32),
            s.cols["ref_len"].astype(np.int32),
            s.cols["alt_len"].astype(np.int32)], axis=1))
    return np.concatenate(parts) if parts else np.zeros((0, 6), np.int32)


def compare_l0(device):
    """bisect_query vs its twin on L0 composites of 1, 4 and 16 keys (16,
    64 and 512 padded shards, ``testing.l0_tail_keys``), windows of
    256-4096 lanes, record caps below the matches, queries on pad rows,
    on 0xDEADBEEF-filled outputs; returns (max_abs_err, report rows)."""
    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.testing import l0_tail_keys, l0_tail_specs

    worst, report = 0, []
    for n_keys, per_key in ((1, 12), (4, 14), (16, 20)):
        keys = l0_tail_keys(n_keys, per_key, seed=n_keys, max_records=200)
        index = tk.CompositeL0DeviceIndex(
            [tk.L0DeviceIndex(s, device) for s in keys])
        check(index.n_shards_padded == {1: 16, 4: 64, 16: 512}[n_keys],
              "the L0 composite's padded shards")
        for W, R in ((256, 1), (256, 60), (512, 16), (1024, 1024),
                     (2048, 100), (4096, 300), (4096, 4096)):
            err, rep = compare_bisect(
                index, None, None, f"l0_{n_keys}keys", R,
                [l0_tail_specs(index, keys, seed=W + R + n_keys)], W=W)
            for r in rep:
                r["padded_shards"] = index.n_shards_padded
            worst, report = max(worst, err), report + rep
    return worst, report


def time_l0(index, sets, record_cap):
    """Timing fields of the L0 launch (bisect_query on the delta path's
    composite at its own window) over query sets: ``ms`` with the L2
    flushed before each launch, ``warm_ms`` one set back to back; the
    twin's ms and the bound of the bytes a launch needs."""
    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.ops import timing

    W = min(2048, index.window_hint)
    args = (index.columns, index.alt_prefix, index.offsets)
    kw = dict(window_cap=W, record_cap=record_cap, n_iters=index.n_iters,
              family="fused_l0")
    fn = lambda q: tk.bisect_query(*args, q, **kw)
    ms = timing.cold_device_ms(fn, sets, index.device)
    warm_ms = timing.device_ms(fn, sets[:1], reps=16)
    twin = lambda q: tk.query_batch_reference(
        *args, q, window_cap=W, record_cap=record_cap, n_iters=index.n_iters)
    plain_ms = float(np.mean([timing.device_ms(twin, [q], reps=1)
                              for q in sets[:2]]))
    bounds = []
    for q in sets:
        full, _seq = tk.bisect_query(*args, q, window_cap=W, record_cap=W,
                                     n_iters=index.n_iters, family="fused_l0")
        bounds.append(bisect_bound(index, q, full, W, min(record_cap, W)))
    by = "bytes" if all(x[1] == "bytes" for x in bounds) else "operations"
    return {"ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": float(np.mean([x[0] for x in bounds])),
            "bound_by": by, "bytes": float(np.mean([x[2] for x in bounds])),
            "window": W, "queries": int(sets[0].shape[0]),
            "padded_shards": index.n_shards_padded,
            "padded_rows": index.n_padded}


def run_cache_path(ref, shard, env, args, device, kind, smi):
    """The cache_path phase (5a) over ``shard``, ``ref`` the cache-off
    engine of phase 4; returns the scatter_match launches of its first
    run."""
    from collections import Counter

    from sbeacon_tpu_torch import telemetry
    from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
    from sbeacon_tpu_torch.engine import VariantEngine, shard_regions
    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.response_cache import response_cache_scope
    from sbeacon_tpu_torch.testing import synthetic_shard

    window_cap = ref.config.engine.window_cap
    rng = random.Random(args.seed + 30)
    bodies = request_bodies(shard, rng, CACHE_BODIES, window_cap)
    jobs = [b for b in bodies for _ in range(CACHE_REPEATS)]
    rng.shuffle(jobs)
    datasets = [{"id": shard.meta["dataset_id"]}]
    key = lambda b: json.dumps(b, sort_keys=True)
    want, _wall = run_main_path(ref, env, [shard], bodies, args.threads)
    _hits, bad = check_served([shard], env, bodies, want)
    check(bad == 0, f"{bad} uncached answers differ from the host matcher")
    want_of = {key(b): w for b, w in zip(bodies, want)}
    t0 = time.perf_counter()
    engine = VariantEngine(BeaconConfig(engine=EngineConfig()), device=device)
    try:
        engine.add_index(shard)
        t_index = time.perf_counter() - t0
        cfg = engine.config.engine
        check(cfg.response_cache, "the JAX default config caches responses")
        rec = ContextEngine(engine)
        telemetry.reset_launch_counts()
        served, wall = run_ctx_jobs(
            rec, env, [(datasets, b, None) for b in jobs], args.threads)
        launches = telemetry.launch_count(sk.KERNEL)
        stats = engine.cache_stats()
        outcomes = Counter(r[4].cost.cache for r in served)
        bad = sum(not same_answer(r, want_of[key(b)])
                  for b, r in zip(jobs, served))
        lat = [r[1] for r in served]
        check(bad == 0, f"{bad} cached-engine answers differ from the "
              "uncached engine's")
        check(stats["hits"] + stats["misses"] == len(jobs),
              "one cache lookup a request")
        check(stats["misses"] >= len(bodies) and stats["hits"] > 0,
              "every body missed once and repeats hit")
        check(0 < launches < stats["misses"] + 1,
              "the misses launched scatter_match, the hits nothing")
        first = {"requests": len(jobs), "bodies": len(bodies),
                 "hits": stats["hits"], "misses": stats["misses"],
                 "negative_hits": stats["negative_hits"],
                 "outcomes": dict(outcomes), "mismatches": bad,
                 "scatter_match_launches": launches,
                 "launches_per_request": launches / len(jobs),
                 "wall_s": wall, "requests_per_s": len(jobs) / wall,
                 "latency_ms": {"p50": percentile(lat, 0.5),
                                "p99": percentile(lat, 0.99)}}

        # one delta over one bracketed region (a body's bracket of at
        # least 20 kb), published to both engines
        chrom, lo, hi = next(
            body_bracket(b) for b in bodies
            if len(b["query"]["requestParameters"]["start"]) == 2
            and body_bracket(b)[2] - body_bracket(b)[1] >= 20_000)
        gen = synthetic_shard(DELTA_REGION_ROWS, seed=args.seed + 31,
                              dataset_id=shard.meta["dataset_id"],
                              chroms=[chrom])
        delta = squeeze_into(gen, lo, hi)
        (_c, d_lo, d_hi), = shard_regions(delta)
        entries0 = stats["entries"]
        t0 = time.perf_counter()
        engine.add_delta(delta)
        t_pub = time.perf_counter() - t0
        ref.add_delta(dataclasses.replace(delta, meta=dict(delta.meta)))
        evicted = entries0 - engine.cache_stats()["entries"]
        label = f"{shard.meta['vcf_location']}#d1"
        vcf = shard.meta["vcf_location"]
        base_of = {(shard.meta["dataset_id"], vcf): shard}
        shard_of = {(shard.meta["dataset_id"], vcf): shard,
                    (shard.meta["dataset_id"], label): delta}
        ref_rec = ContextEngine(ref)
        want2, _w = run_ctx_jobs(ref_rec, env,
                                 [(datasets, b, None) for b in bodies],
                                 args.threads)
        bad_ref, _h = check_delta_served(
            base_of, shard_of, {}, env,
            [(datasets, b, None) for b in bodies], want2)
        check(bad_ref == 0, f"{bad_ref} uncached answers after the publish "
              "differ from the host matcher and the monolith")
        telemetry.reset_launch_counts()
        served2, wall2 = run_ctx_jobs(
            rec, env, [(datasets, b, None) for b in bodies], args.threads)
        launches2 = telemetry.launch_count(sk.KERNEL)
        # the bodies whose cache scope the publish's scope overlaps
        overlap = [sc[1] == chrom and sc[2][0] <= d_hi and d_lo <= sc[2][1]
                   for sc in (response_cache_scope(r[2]) for r in served2)]
        outcomes2 = [r[4].cost.cache for r in served2]
        bad2 = sum(not same_answer(r, w) for r, w in zip(served2, want2))
        check(bad2 == 0, f"{bad2} answers after the publish differ from "
              "the uncached engine's")
        check(all(o == "miss" for o, ov in zip(outcomes2, overlap) if ov),
              "every body overlapping the delta missed")
        check(all(o != "miss" for o, ov in zip(outcomes2, overlap)
                  if not ov), "every other body hit")
        shows = [any(r.vcf_location == label and r.exists for r in s[3])
                 for s, ov in zip(served2, overlap) if ov]
        check(any(shows), "an overlapping body shows the delta's rows")
        lat2 = [r[1] for r in served2]
        emit("cache_path", config="EngineConfig() (JAX defaults, response "
             "cache on)", shard_rows=shard.n_rows, add_index_s=t_index,
             threads=args.threads, first=first,
             publish={"rows": delta.n_rows, "chrom": chrom,
                      "region": [d_lo, d_hi], "add_delta_s": t_pub,
                      "scoped_evictions": evicted,
                      "overlapping_bodies": sum(overlap),
                      "bodies_showing_delta_rows": sum(shows)},
             replay={"requests": len(bodies),
                     "outcomes": dict(Counter(outcomes2)),
                     "mismatches": bad2,
                     "scatter_match_launches": launches2,
                     "launches_per_request": launches2 / len(bodies),
                     "wall_s": wall2,
                     "requests_per_s": len(bodies) / wall2,
                     "latency_ms": {"p50": percentile(lat2, 0.5),
                                    "p99": percentile(lat2, 0.99)}},
             cache=engine.cache_stats(), device=kind, nvidia_smi=smi)
    finally:
        engine.close()
    return launches


def run_delta_path(bases, env, args, device, kind, smi):
    """The warmup and delta_path phases (9c, 9d) over the fused path's
    corpus ``bases``; returns the L0 launch's fields for the kernels
    line (its launches on the path, its error against the twin at the
    path's own shapes and its timing, phase 9e)."""
    from collections import Counter

    from sbeacon_tpu_torch import telemetry
    from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
    from sbeacon_tpu_torch.engine import VariantEngine
    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.testing import synthetic_shard

    rng = random.Random(args.seed + 40)
    seeds = iter(range(args.seed + 1000, args.seed + 100_000))

    def make_delta(base):
        n = rng.randint(*DELTA_ROWS)
        return synthetic_shard(n, seed=next(seeds),
                               dataset_id=base.meta["dataset_id"])

    engine = VariantEngine(BeaconConfig(engine=EngineConfig(
        microbatch_wait_ms=MICROBATCH_WAIT_MS)), device=device)
    try:
        t0 = time.perf_counter()
        for s in bases:
            engine.add_index(s)
        check(engine.warm_fused() is not None, "the fused stack is built")
        t_index = time.perf_counter() - t0
        base_of = {(s.meta["dataset_id"], s.meta["vcf_location"]): s
                   for s in bases}
        shard_of = dict(base_of)
        # publishes made before the traffic: ended before any admission
        published = {}
        t0 = time.perf_counter()
        for _j in range(DELTA_SHARDS):
            for s in bases:
                d = make_delta(s)
                key = (s.meta["dataset_id"], s.meta["vcf_location"])
                epoch = engine.add_delta(d)
                shard_of[(key[0], f"{key[1]}#d{epoch}")] = d
                published[(key, epoch)] = (0.0, 0.0)
        t_deltas = time.perf_counter() - t0
        status = engine.l0_status()
        check(status["built"] and status["shards"] == DELTA_SHARDS
              * len(bases), "every key's tail rides the L0 index")
        padded = engine._l0_state[0].n_shards_padded

        # 9c. warmup: every kernel built, each family launched once a
        # loaded index
        telemetry.reset_launch_counts()
        t0 = time.perf_counter()
        n_warm = engine.warmup()
        t_warm = time.perf_counter() - t0
        warm_recs = telemetry.recent_launches()
        check(n_warm == len(bases) + 2, "warmup launched scatter_match per "
              "shard and bisect_query on the fused stack and the L0 index")
        check(all(r.get("warmup") for r in warm_recs),
              "warmup's launches are marked as warmup")
        emit("warmup", engine="delta_path's", seconds=t_warm,
             launches=n_warm,
             by_kernel=dict(Counter(r["kernel"] for r in warm_recs)),
             by_family=telemetry.launches_by_family(),
             note="the JAX engine compiles its shape ladder here; the "
                  "kernels compile no shapes, so one launch a family and "
                  "index loads each", device=kind, nvidia_smi=smi)

        # 9d. the traffic, with a writer publishing DELTA_WRITES more
        # deltas once a quarter of the requests are done
        window_cap = engine.config.engine.window_cap
        deltas = [s for k, s in shard_of.items() if "#d" in k[1]]
        bodies = delta_aimed_bodies(bases[0], deltas, rng,
                                    args.fused_requests, window_cap, P_DELTA)
        datasets = [{"id": s.meta["dataset_id"]} for s in bases]
        jobs = [(datasets, b, None) for b in bodies]
        rec = ContextEngine(engine)
        writes = []
        errors = []

        def writer():
            try:
                while rec.done < len(jobs) // 4:
                    time.sleep(0.005)
                for i in range(DELTA_WRITES):
                    s = bases[i % len(bases)]
                    key = (s.meta["dataset_id"], s.meta["vcf_location"])
                    d = make_delta(s)
                    t0 = time.perf_counter()
                    epoch = engine.add_delta(d)
                    t1 = time.perf_counter()
                    shard_of[(key[0], f"{key[1]}#d{epoch}")] = d
                    published[(key, epoch)] = (t0, t1)
                    writes.append(t1 - t0)
                    time.sleep(0.05)
            except BaseException as e:  # raised below, on the main thread
                errors.append(e)

        telemetry.reset_launch_counts()
        w = threading.Thread(target=writer, name="delta-writer")
        w.start()
        served, wall = run_ctx_jobs(rec, env, jobs, args.threads)
        w.join()
        if errors:
            raise errors[0]
        recs = [r for r in telemetry.recent_launches()
                if not r.get("warmup")]
        l0_recs = [r for r in recs if r.get("family") == "fused_l0"]
        l0_launches = len(l0_recs)
        fused_launches = sum(r.get("family") == "fused" for r in recs)
        j1 = telemetry.launch_count(sk.KERNEL)
        host_walked = sum(r[4].cost.delta_shards for r in served)
        mismatches, n_hit = check_delta_served(base_of, shard_of, published,
                                               env, jobs, served)
        check(len(writes) == DELTA_WRITES, "the writer published every delta")
        check(mismatches == 0, f"{mismatches} delta-path responses differ "
              "from the host matcher, read-your-writes or the monolith")
        check(l0_launches > 0, "the delta tail rode bisect_query (fused_l0)")
        check(fused_launches > 0,
              "the base shards rode bisect_query on the fused stack")
        lat = [r[1] for r in served]
        status = engine.l0_status()
        cache = engine.cache_stats()
        emit("delta_path", config="microbatch_wait_ms 2, the response cache "
             "on (default)", requests=len(jobs), threads=args.threads,
             datasets=len(bases), hits=n_hit, mismatches=mismatches,
             delta_shards_before=DELTA_SHARDS * len(bases),
             delta_rows=list(DELTA_ROWS), writes_during_run=len(writes),
             add_delta_ms={"p50": percentile(writes, 0.5) * 1e3,
                           "max": max(writes) * 1e3},
             aimed_at_deltas=P_DELTA, l0_padded_shards=padded,
             fused_l0_launches=l0_launches,
             fused_l0_launches_per_request=l0_launches / len(jobs),
             fused_l0_queries_per_launch={
                 "min": min(r["specs"] for r in l0_recs),
                 "p50": percentile([r["specs"] for r in l0_recs], 0.5),
                 "max": max(r["specs"] for r in l0_recs)},
             fused_launches=fused_launches, scatter_match_launches=j1,
             host_walked_tail_shards=host_walked,
             cache_outcomes=dict(Counter(r[4].cost.cache for r in served)),
             l0_rebuilds_per_key={k: v["builds"]
                                  for k, v in status["keys"].items()},
             l0_builds=status["builds"], l0_block_reuses=status[
                 "blockReuses"],
             cache={k: cache[k] for k in ("hits", "misses",
                                          "scoped_invalidations")},
             setup={"add_index_s": t_index, "deltas_s": t_deltas},
             check="each response vs the host matcher on its shard, the "
                   "envelope, read-your-writes on the epochs seen, and each "
                   "dataset vs merge_shards of its base and the deltas "
                   "seen, inside the bracket",
             wall_s=wall, requests_per_s=len(jobs) / wall,
             latency_ms={"p50": percentile(lat, 0.5),
                         "p99": percentile(lat, 0.99)},
             stage_ms=engine.stage_timing(), device=kind, nvidia_smi=smi)

        # 9e. the L0 launch at the path's median batch, on its composite,
        # specs of the path's delta-aimed bodies over random covered
        # shards: each set against the twin (every output word, the
        # overflow and match counts too), then timed
        findex, sid_of = engine._l0_state[0], engine._l0_state[1]
        record_cap = engine.config.engine.record_cap
        b = percentile([r["specs"] for r in l0_recs], 0.5)
        sids = sorted(sid_of.values())
        specs = [payload_spec(r[2]) for r in served]
        batches = [([rng.choice(specs) for _ in range(b)],
                    [rng.choice(sids) for _ in range(b)]) for _ in range(16)]
        err, rep = compare_bisect(findex, None, None, "delta_path_l0",
                                  record_cap, batches)
        emit("kernel_vs_twin", kernel=tk.KERNEL,
             form="l0 (delta_path's composite and median batch)",
             tolerance=0, max_abs_err=err, cases=len(rep),
             all_equal=all(r["equal"] for r in rep),
             padded_shards=findex.n_shards_padded,
             padded_rows=findex.n_padded, report=rep)
        sets = [bisect_inputs(findex, sp, ss) for sp, ss in batches]
        t = time_l0(findex, sets, record_cap)
        emit("timing", kernel=tk.KERNEL, form="l0 (fused_l0)",
             library_ms=None, delta_path_launches=l0_launches,
             delta_path_kernel_ms=l0_launches * t["ms"],
             delta_path_busy_share=l0_launches * t["ms"] / (wall * 1e3),
             **t, bound_share=t["bound_ms"] / t["ms"],
             library_note="no single PyTorch call computes this function",
             device=kind, nvidia_smi=smi)
        return {"launches": l0_launches, "path_max_abs_err": err, **t}
    finally:
        engine.close()


def time_distinct(keys, device):
    """(kernel ms, warm ms, twin ms, library ms, bound ms, bound_by) of
    one distinct count over the device tensor ``keys``. The kernel ms
    finds the L2 cold (the keys alone exceed it); the warm ms is back to
    back. Library: ``torch.unique(keys, dim=0)``, one PyTorch call that
    gives the same count (it synchronises inside, so an event pair times
    each call). Bound: the keys read once and the count written once at
    the HBM rate; operations (about 40 integer operations a key) at the
    int32 rate."""
    import torch

    from sbeacon_tpu_torch.ops import timing
    from sbeacon_tpu_torch.parallel import distinct as dc

    ms = timing.cold_device_ms(dc.distinct_count, [keys], device, reps=3)
    warm_ms = timing.device_ms(dc.distinct_count, [keys], reps=3)
    plain_ms = timing.device_ms(dc.distinct_count_reference, [keys], reps=1)
    library_ms = event_ms(lambda k: torch.unique(k, dim=0), keys)
    n = keys.shape[0]
    bytes_ms = (n * 24 + 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * DISTINCT_OPS_PER_KEY / INT32_OPS_PER_S * 1e3
    return (ms, warm_ms, plain_ms, library_ms, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def with_plane_rows(shard, rows, dataset_id):
    """A ``subset_shard`` of ``shard`` at ``rows`` that keeps those rows'
    four genotype planes (the same sites and calls submitted again)."""
    from sbeacon_tpu_torch.testing import subset_shard

    empty = np.zeros((0, 3), np.int64)
    return dataclasses.replace(
        subset_shard(shard, rows, dataset_id=dataset_id),
        gt_bits=shard.gt_bits[rows], gt_bits2=shard.gt_bits2[rows],
        tok_bits1=shard.tok_bits1[rows], tok_bits2=shard.tok_bits2[rows],
        gt_overflow=empty, tok_overflow=empty)


def stack_view(blk, lo, hi):
    """Datasets [lo, hi) of a mesh block as a block of their own (views
    of its tensors, no copy)."""
    from sbeacon_tpu_torch.parallel.mesh import StackBlock

    n = blk.n_pad
    planes = (None if blk.planes is None
              else tuple(p[lo * n : hi * n] for p in blk.planes))
    return StackBlock(device=blk.device, columns=blk.columns[lo:hi],
                      alt_prefix=blk.alt_prefix[lo:hi],
                      offsets=blk.offsets[lo:hi], planes=planes)


def stack_q(specs, device):
    """A query batch packed for the stacked kernels, on ``device``."""
    import torch

    from sbeacon_tpu_torch.ops import kernel as tk

    enc = tk.encode_queries(specs)
    return torch.from_numpy(tk.pack_queries(enc, fused=False)).to(device)


def block_planes(blk, has_counts):
    return blk.planes if has_counts else (blk.planes[0],) * 4


def compare_stacked_query(blk, n_iters, specs, label, window_cap=2048,
                          record_cap=1024):
    """stacked_query vs its twin on one block; returns (max_abs_err,
    report row)."""
    import torch

    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.parallel import mesh as tm

    q = stack_q(specs, blk.device)
    kw = dict(window_cap=window_cap, record_cap=record_cap, n_iters=n_iters)
    out, agg, _seq = tm.stacked_query(blk.columns, blk.alt_prefix,
                                      blk.offsets, q, **kw)
    torch.cuda.synchronize()
    want_out, want_agg = tm.local_query_reference(
        blk.columns, blk.alt_prefix, blk.offsets, q, **kw)
    err = max(int((out.long() - want_out.long()).abs().max()),
              int((agg.long() - want_agg.long()).abs().max()))
    equal = torch.equal(out, want_out) and torch.equal(agg, want_agg)
    check(equal, f"{label} B={len(specs)}: stacked_query != twin")
    a = out[:, :, : tk.N_AGG].cpu().numpy()
    R = out.shape[2] - tk.N_AGG
    return err, {
        "stack": label, "datasets": blk.n_datasets, "queries": len(specs),
        "window": window_cap, "record_cap": record_cap, "equal": equal,
        "matched": int(a[:, :, 4].sum()), "overflow": int(a[:, :, 5].sum()),
        "over_record_cap": int((a[:, :, 4] > R).sum()),
        "empty": int((a[:, :, 4] == 0).sum()),
        "max_row": int(out[:, :, tk.N_AGG :].max()),
    }


def compare_stacked_selected(blk, n_iters, specs, masks, has_counts, label,
                             window_cap=2048, record_cap=1024):
    """stacked_selected vs its twin on one block, ``masks`` uint32
    [d_local, W]; returns (max_abs_err, report row)."""
    import torch

    from sbeacon_tpu_torch.parallel import mesh as tm

    q = stack_q(specs, blk.device)
    m = torch.from_numpy(np.ascontiguousarray(masks).view(np.int32)).to(
        blk.device)
    planes = block_planes(blk, has_counts)
    kw = dict(window_cap=window_cap, record_cap=record_cap, n_iters=n_iters,
              has_counts=has_counts)
    got = tm.stacked_selected(blk.columns, blk.alt_prefix, blk.offsets,
                              *planes, m, q, **kw)[:-1]
    torch.cuda.synchronize()
    want = tm.local_selected_reference(blk.columns, blk.alt_prefix,
                                       blk.offsets, *planes, m, q, **kw)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    check(equal, f"{label} B={len(specs)} counts={has_counts}: "
          "stacked_selected != twin")
    scal, rows = got[0].cpu().numpy(), got[1]
    d_idx = torch.arange(blk.n_datasets, device=blk.device)[:, None, None]
    prow = torch.where(rows >= 0, d_idx * blk.n_pad + rows.long(), -1)
    return err, {
        "stack": label, "datasets": blk.n_datasets, "queries": len(specs),
        "with_counts": has_counts, "record_cap": record_cap, "equal": equal,
        "matched": int(scal[:, :, 3].sum()),
        "overflow": int(scal[:, :, 2].sum()),
        "rows": int((rows >= 0).sum()),
        "max_plane_word": int(prow.max()) * blk.planes[0].shape[1],
        "or_bits": int(sum(bin(int(x) & 0xFFFFFFFF).count("1")
                           for x in got[4].flatten().tolist())),
    }


def mesh_vs_twin(blocks, mesh, n_iters, specs, masks=None, has_counts=False):
    """The mesh entry point over ``blocks`` (kernels, and the per-device
    sum on the first mesh device) against the twins of each block and
    the sum of their partials; returns (equal, max_abs_err)."""
    import torch

    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.parallel import mesh as tm

    if masks is None:
        per, agg = tm.sharded_query(blocks, specs, mesh=mesh, n_iters=n_iters)
        got = [np.stack([per["exists"], per["call_count"], per["n_variants"],
                         per["all_alleles_count"], per["n_matched"],
                         per["overflow"]], -1).astype(np.int32), per["rows"]]
        got_agg = np.stack([agg[k] for k in (
            "call_count", "all_alleles_count", "n_variants",
            "n_datasets_hit", "n_overflow")], 1)
        twins = [tm.local_query_reference(b.columns, b.alt_prefix, b.offsets,
                                          stack_q(specs, b.device),
                                          window_cap=2048, record_cap=1024,
                                          n_iters=n_iters) for b in blocks]
        out = torch.cat([t[0] for t in twins]).cpu().numpy()
        want = [out[:, :, : tk.N_AGG], out[:, :, tk.N_AGG :]]
    else:
        per, agg = tm.sharded_selected_query(
            blocks, specs, masks, mesh=mesh, n_iters=n_iters,
            has_counts=has_counts)
        got = [np.stack([per["call_count"], per["all_alleles_count"],
                         per["overflow"], per["n_matched"]],
                        -1).astype(np.int32)] + [
            per[k] for k in ("rows", "pc_call", "pc_tok", "or_words")]
        got_agg = np.stack([agg[k] for k in (
            "call_count", "all_alleles_count", "n_overflow")], 1)
        twins, start = [], 0
        for b in blocks:
            m = torch.from_numpy(masks[start : start + b.n_datasets].view(
                np.int32)).to(b.device)
            start += b.n_datasets
            twins.append(tm.local_selected_reference(
                b.columns, b.alt_prefix, b.offsets,
                *block_planes(b, has_counts), m, stack_q(specs, b.device),
                window_cap=2048, record_cap=1024, n_iters=n_iters,
                has_counts=has_counts))
        want = [torch.cat([t[i] for t in twins]).cpu().numpy()
                for i in range(5)]
    want_agg = sum(t[-1].long().cpu() for t in twins).numpy()
    pairs = list(zip(got, want)) + [(got_agg, want_agg)]
    err = max(int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max())
              for g, w in pairs)
    return all(np.array_equal(g, w) for g, w in pairs), err


def mask_sets(rng, n, d_local, w, n_samples):
    """n uint32 [d_local, W] mask stacks cycling all-ones, sparse and
    empty."""
    return [np.stack([mask_rows(rng, 3, w, n_samples)[k % 3]] * d_local)
            for k in range(n)]


def stacked_need(blk, n_iters, q, W, R):
    """(bytes, operations) one stacked_query launch of the packed
    queries ``q`` needs at the least: bisect_need per local dataset
    (its own columns and matched rows, from a launch that returns every
    matched row) and the [B, 5] aggregates written once."""
    import types

    from sbeacon_tpu_torch.parallel import mesh as tm

    full = tm.stacked_query(blk.columns, blk.alt_prefix, blk.offsets, q,
                            window_cap=W, record_cap=W, n_iters=n_iters)[0]
    nbytes = q.shape[0] * tm.N_STACK_AGG * 4
    ops = 0
    for d in range(blk.n_datasets):
        view = types.SimpleNamespace(columns=blk.columns[d],
                                     offsets=blk.offsets[d : d + 1],
                                     n_iters=n_iters)
        nb, op = bisect_need(view, q, full[d], W, R)
        nbytes += nb
        ops += op
    return nbytes, ops


def time_stacked_query(blk, n_iters, spec_sets, W, R, parent=None):
    """Timing fields (ms, warm_ms, plain_ms, bound_ms, bound_by, bytes)
    per stacked_query launch over the query sets: the kernel ms with the
    L2 flushed before each launch, the warm ms back to back, with
    ``parent`` its kernel in turns beside (``parent_ms``); the twin by an
    event pair around each call (it enqueues too many small kernels for a
    held stream)."""
    from sbeacon_tpu_torch.ops import timing
    from sbeacon_tpu_torch.parallel import mesh as tm

    sets = [stack_q(specs, blk.device) for specs in spec_sets]
    kw = dict(window_cap=W, record_cap=R, n_iters=n_iters)
    args = (blk.columns, blk.alt_prefix, blk.offsets)
    runs = {"this": lambda q: tm.stacked_query(*args, q, **kw)}
    if parent is not None:
        runs = {"parent": lambda q: parent.tm.stacked_query(*args, q, **kw),
                **runs}
    fields = turn_fields(timed_in_turns(
        lambda fn: (timing.cold_device_ms(fn, sets, blk.device),
                    timing.device_ms(fn, sets, reps=4)), runs),
        ("ms", "warm_ms"))
    twin = lambda q: tm.local_query_reference(
        blk.columns, blk.alt_prefix, blk.offsets, q, window_cap=W,
        record_cap=R, n_iters=n_iters)
    plain_ms = float(np.mean([event_ms(twin, q) for q in sets[:2]]))
    need = [stacked_need(blk, n_iters, q, W, R) for q in sets[:16]]
    nbytes = float(np.mean([x for x, _o in need]))
    bound_ms, by = bound_of(nbytes, float(np.mean([o for _x, o in need])))
    return {**fields, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes}


def time_stacked_selected(blk, n_iters, sets, has_counts, W, record_cap,
                          parent=None):
    """Timing fields (ms, warm_ms, plain_ms, bound_ms, bound_by, bytes)
    per stacked_selected launch over ``sets`` of (specs, masks uint32
    [d_local, W]): L2 cold and warm as time_stacked_query, with the
    parent's kernel in turns beside. Bound: the query part's
    (stacked_need), the 32-B sectors of the plane rows the matched rows
    read (x4 with counts), the masks read once and the outputs written
    once."""
    import torch

    from sbeacon_tpu_torch.ops import timing
    from sbeacon_tpu_torch.parallel import mesh as tm

    dev = blk.device
    packed = [(stack_q(specs, dev),
               torch.from_numpy(np.ascontiguousarray(m).view(np.int32)).to(dev))
              for specs, m in sets]
    planes = block_planes(blk, has_counts)
    kw = dict(window_cap=W, record_cap=record_cap, n_iters=n_iters,
              has_counts=has_counts)
    args = (blk.columns, blk.alt_prefix, blk.offsets, *planes)
    run = lambda s: tm.stacked_selected(*args, s[1], s[0], **kw)
    runs = {"this": run}
    if parent is not None:
        runs = {"parent": lambda s: parent.tm.stacked_selected(
            *args, s[1], s[0], **kw), **runs}
    fields = turn_fields(timed_in_turns(
        lambda fn: (timing.cold_device_ms(fn, packed, dev),
                    timing.device_ms(fn, packed, reps=4)), runs),
        ("ms", "warm_ms"))
    twin = lambda s: tm.local_selected_reference(
        blk.columns, blk.alt_prefix, blk.offsets, *planes, s[1], s[0], **kw)
    plain_ms = float(np.mean([event_ms(twin, s) for s in packed[:2]]))
    w = blk.planes[0].shape[1]
    k = 4 if has_counts else 1
    R = min(record_cap, W)
    need = []
    for q, m in packed[:16]:
        nbytes, ops = stacked_need(blk, n_iters, q, W, R)
        rows = run((q, m))[1]
        d_idx = torch.arange(blk.n_datasets, device=dev)[:, None, None]
        prow = (d_idx * blk.n_pad + rows.long())[rows >= 0]
        b, dl = q.shape[0], blk.n_datasets
        nbytes += (k * plane_sector_count(prow, w) * SECTOR_BYTES
                   + dl * w * 4 + dl * b * (16 + 12 * R + 4 * w) + b * 12)
        ops += int(prow.numel()) * w * k * PLANE_OPS_PER_WORD
        need.append((nbytes, ops))
    nbytes = float(np.mean([x for x, _o in need]))
    bound_ms, by = bound_of(nbytes, float(np.mean([o for _x, o in need])))
    return {**fields, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes}


class TierFront:
    """The engine with the pod dispatch tier consulted first, as the JAX
    package's DistributedEngine consults its MeshDispatchTier for a
    local engine: the datasets the tier resolves ride its one launch,
    the rest take the engine's own paths; responses in the engine's
    (dataset, vcf) order."""

    def __init__(self, engine, tier):
        self.engine = engine
        self.tier = tier

    def search(self, payload):
        ds = list(payload.dataset_ids) or self.engine.datasets()
        covered = self.tier.resolve(ds, payload)
        out = self.tier.search(payload, covered) if covered else []
        rest = [d for d in ds if d not in covered]
        if rest:
            out = out + self.engine.search(
                dataclasses.replace(payload, dataset_ids=rest))
        return sorted(out, key=lambda r: (r.dataset_id, r.vcf_location))


def run_tier_delta_leg(engine, tier, bases, env, args, kind, smi):
    """Phase 25a: the pod tier's delta leg. ``l0_min_shards`` deltas are
    published to each of ``bases`` behind a tier whose stack holds
    their base rows (the base fingerprint does not move, so the stack
    stays current); a burst of the fused mix, most of it aimed at the
    delta rows, is served through the tier: its base rows ride
    mesh_fused, its tail the engine's L0 index (bisect_query,
    ``fused_l0``). Every response is held against the host matcher on
    the shard its label names, and every request must answer every
    shard, base and delta, that holds its chromosome. The tier refuses
    some shapes (planes, too few shards); those take the engine's own
    paths, and each is counted."""
    from sbeacon_tpu_torch import telemetry
    from sbeacon_tpu_torch.parallel import mesh as tm
    from sbeacon_tpu_torch.testing import synthetic_shard

    rng = random.Random(args.seed + 27)
    shard_of = {(s.meta["dataset_id"], s.meta["vcf_location"]): s
                for s in bases}
    deltas = []
    for _j in range(engine.config.engine.l0_min_shards):
        for s in bases:
            d = synthetic_shard(rng.randint(*DELTA_ROWS),
                                seed=args.seed + 3000 + len(deltas),
                                dataset_id=s.meta["dataset_id"])
            epoch = engine.add_delta(d)
            shard_of[(s.meta["dataset_id"],
                      f"{s.meta['vcf_location']}#d{epoch}")] = d
            deltas.append(d)
    status = engine.l0_status()
    check(status["built"] and status["shards"] == len(deltas),
          "mesh_fused_path: every delta rides the L0 index")
    bodies = delta_aimed_bodies(bases[0], deltas, rng, TIER_DELTA_REQUESTS,
                                2048, p_delta=0.6)
    datasets = [{"id": s.meta["dataset_id"]} for s in bases]
    jobs = [(datasets, b, None) for b in bodies]
    st0 = tier.stats()
    telemetry.reset_launch_counts()
    served, wall = run_ctx_jobs(ContextEngine(TierFront(engine, tier)), env,
                                jobs, args.threads)
    fams = telemetry.launches_by_family()
    n_mesh = telemetry.launch_count(tm.FUSED_KERNEL)
    st = tier.stats()
    dispatches = st["dispatches"] - st0["dispatches"]
    refusals = {k: v - st0["refusals"].get(k, 0)
                for k, v in st["refusals"].items()
                if v != st0["refusals"].get(k, 0)}
    # tail shards the tier answered: on its L0 launch, and in all
    tail_l0 = sum(r[4].notes.get("mesh_tail_l0", 0) for r in served)
    tail = sum(r[4].notes.get("mesh_delta_tail", 0) for r in served)
    mismatches = hits = 0
    for (_d, body, _s), rec in zip(jobs, served):
        doc, _ms, payload, responses = rec[:4]
        want_resps, want_doc = delta_expected(shard_of, env, body, payload,
                                              responses)
        labels = {(r.dataset_id, r.vcf_location) for r in responses}
        want_labels = {k for k, sh in shard_of.items()
                       if payload.reference_name
                       in sh.meta.get("chrom_native", {})}
        ok = (labels == want_labels and len(labels) == len(responses)
              and [dataclasses.asdict(r) for r in responses]
              == [dataclasses.asdict(r) for r in want_resps]
              and json.dumps(doc, sort_keys=True)
              == json.dumps(want_doc, sort_keys=True))
        mismatches += not ok
        hits += any(r.exists for r in want_resps)
    check(mismatches == 0, f"{mismatches} responses of the tier's delta leg "
          "differ from the host matcher or miss a shard")
    check(dispatches + sum(refusals.values()) == len(jobs),
          "every request of the delta leg was served by the tier or "
          "refused with a counted reason")
    check(n_mesh > 0 and tail_l0 > 0 and fams.get("fused_l0", 0) > 0,
          "the tier's delta leg launched mesh_fused for the base rows and "
          "bisect_query (fused_l0) for the tail")
    lat = [r[1] for r in served]
    emit("mesh_fused_delta_leg", engine="mesh_fused_path's",
         response_cache=engine.config.engine.response_cache,
         requests=len(jobs), threads=args.threads, hits=hits,
         mismatches=mismatches, deltas_published=len(deltas),
         delta_rows=list(DELTA_ROWS), aimed_at_deltas=0.6,
         tier_dispatches=dispatches, tier_refusals=refusals,
         tier_tail_shards=tail, tier_tail_shards_on_l0=tail_l0,
         mesh_fused_launches=n_mesh,
         launches_by_family=fams,
         l0_padded_shards=engine._l0_state[0].n_shards_padded,
         check="each response vs the host matcher on the shard its label "
               "names, the envelope, and every base and delta shard that "
               "holds the chromosome answered",
         wall_s=wall, requests_per_s=len(jobs) / wall,
         latency_ms={"p50": percentile(lat, 0.5),
                     "p99": percentile(lat, 0.99)},
         device=kind, nvidia_smi=smi)


def fused_entry_inputs(mfi, specs, sids, layout, masks=None, counts=None):
    """[(entry, block, mesh_fused keyword arguments with the packed
    slots as ``qpack``)] of one batch in ``layout``, laid out by
    MeshFusedIndex.launch_inputs as run_mesh_queries lays it out
    (``masks`` uint32 [B, W] and ``counts`` bool [B] arm the planes)."""
    from sbeacon_tpu_torch.ops import kernel as tk

    entries = mfi.launch_inputs(tk.encode_queries(specs, shard_ids=sids),
                                layout, sample_masks=masks,
                                mask_counts=counts)[0]
    return [(g, blk, dict(kw, qpack=q)) for g, (blk, q, kw)
            in enumerate(entries)]


def run_fused(blk, kw, fn, window_cap, record_cap):
    """``fn`` (mesh_fused or its twin) on one entry's inputs."""
    kw = dict(kw)
    q = kw.pop("qpack")
    return fn(blk.columns, blk.alt_prefix, blk.offsets, blk.seg_base, q,
              window_cap=window_cap, record_cap=record_cap, **kw)


def compare_mesh_fused(mfi, specs, sids, layout, label, masks=None,
                       counts=None, window_cap=2048, record_cap=1024):
    """mesh_fused (on 0xDEADBEEF-filled outputs) vs its twin on every
    entry of one batch; returns (max_abs_err, report row)."""
    import torch

    from sbeacon_tpu_torch.parallel import mesh as tm

    err, equal = 0, True
    stats = dict(matched=0, overflow=0, rows=0, max_row=-1, or_bits=0,
                 fillers=0, not_owned=0)
    R = min(record_cap, window_cap)
    for g, blk, kw in fused_entry_inputs(mfi, specs, sids, layout, masks,
                                         counts):
        with DeadbeefOutputs():
            got, _seq = run_fused(blk, kw, tm.mesh_fused, window_cap,
                                  record_cap)
            torch.cuda.synchronize()
        want = run_fused(blk, kw, tm.local_fused_reference, window_cap,
                         record_cap)
        for k, w in want.items():
            err = max(err, int((got[k].long() - w.long()).abs().max())
                      if w.numel() else 0)
            equal = equal and torch.equal(got[k], w)
        q = kw["qpack"]
        sid = q[:, 1].long() - g * mfi.d_local
        stats["not_owned"] += int(((sid < 0) | (sid >= mfi.d_local)).sum())
        stats["fillers"] += int((q[:, 0] == 0).sum())
        agg = got["agg"]
        stats["matched"] += int(agg[:, 3].sum())
        stats["overflow"] += int(agg[:, 4].sum())
        rows = got["rows"] - (0 if layout == tm.LAYOUT_OWNER else 1)
        stats["rows"] += int((rows >= 0).sum())
        stats["max_row"] = max(stats["max_row"], int(rows.max())
                               if rows.numel() else -1)
        if "or_words" in got:
            stats["or_bits"] += int(sum(
                bin(int(x) & 0xFFFFFFFF).count("1")
                for x in got["or_words"].flatten().tolist()))
    check(equal, f"{label} B={len(specs)} layout={layout}: mesh_fused != twin")
    return err, {"index": label, "entries": mfi.n_dev, "queries": len(specs),
                 "layout": layout, "planes": masks is not None,
                 "counts": None if counts is None else bool(counts.any()),
                 "record_cap": record_cap, "equal": equal, **stats}


def compare_ring(n, shape, device, seed, misaligned=False):
    """ring_gather on an n-entry ring of one card vs the twin (the sum),
    with int32 wraparound; the inputs must stay unchanged. Returns
    (equal, max_abs_err)."""
    import torch

    from sbeacon_tpu_torch.ops import gather_kernel as tg

    g = np.random.default_rng(seed)
    numel = int(np.prod(shape))
    parts = []
    for _ in range(n):
        host = g.integers(-2**31, 2**31, size=numel, dtype=np.int64)
        t = torch.from_numpy(host.astype(np.int32))
        if misaligned:  # a 4-byte offset: the kernel's word-at-a-time path
            base = torch.empty(numel + 1, dtype=torch.int32, device=device)
            base[1:] = t.to(device)
            parts.append(base[1:].view(shape))
        else:
            parts.append(t.to(device).view(shape))
    keep = [p.clone() for p in parts]
    got = tg.ring_gather(parts)
    torch.cuda.synchronize()
    want = tg.gather_partials_portable(parts)
    equal = (all(torch.equal(x, want) for x in got)
             and all(torch.equal(a, b) for a, b in zip(parts, keep)))
    err = max(int((x.long() - want.long()).abs().max()) for x in got)
    return equal, err


def mesh_need(mfi, g, blk, q, W, R, with_planes):
    """(bytes, operations) one mesh_fused launch on entry g of the packed
    slots ``q`` needs at the least: bisect_need over the owned slots
    (their columns and matched rows, from a twin search that returns
    every matched row), the other slots' query rows and outputs once,
    and with planes the 32-B sectors of the matched rows' plane words
    (x4 with counts), the masks read and the plane outputs written."""
    import types

    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.parallel import mesh as tm

    sid = q[:, tk.QF_SHARD].long() - g * mfi.d_local
    own = (sid >= 0) & (sid < mfi.d_local)
    ql = q[own].clone()
    ql[:, tk.QF_SHARD] = sid[own].to(ql.dtype)
    b, n_own = q.shape[0], int(own.sum())
    nbytes = (b - n_own) * (tk.N_QFIELDS + R + tm.N_MESH_AGG) * 4
    ops = 0
    full = None
    if n_own:
        view = types.SimpleNamespace(columns=blk.columns, offsets=blk.offsets,
                                     n_iters=mfi.n_iters)
        full = tk.query_batch_reference(
            blk.columns, blk.alt_prefix, blk.offsets, ql, window_cap=W,
            record_cap=W, n_iters=mfi.n_iters)
        nb, op = bisect_need(view, ql, full, W, R)
        nbytes, ops = nbytes + nb + n_own * 4, ops + op  # + seg_base
    if with_planes and full is not None:
        rows = full[:, tk.N_AGG : tk.N_AGG + R]
        w = blk.planes[0].shape[1]
        k = 4 if mfi.has_count_planes else 1
        nbytes += (k * plane_sector_count(rows, w) * SECTOR_BYTES
                   + b * (2 * w * 4 + 8 * R + 4))
        ops += int((rows >= 0).sum()) * w * k * PLANE_OPS_PER_WORD
    return nbytes, ops


def time_mesh_fused(mfi, sets, layout, window_cap, record_cap, with_planes,
                    parent=None):
    """Timing fields (ms, warm_ms, plain_ms, bound_ms, bound_by, bytes,
    slots) per mesh_fused launch over every entry's launch of ``sets`` of
    (specs, sids, masks, counts): ``ms`` with the L2 flushed before each
    launch, ``warm_ms`` back to back, the twin by an event pair around
    each call. With ``parent`` (``load_parent``) its kernel in turns
    beside this one (``parent_ms``, ``parent_warm_ms``)."""
    from sbeacon_tpu_torch.ops import timing
    from sbeacon_tpu_torch.parallel import mesh as tm

    items = [(blk, kw, g) for specs, sids, m, c in sets
             for g, blk, kw in fused_entry_inputs(mfi, specs, sids, layout,
                                                  m, c)]
    dev = items[0][0].device
    runs = {"this": tm.mesh_fused}
    if parent is not None:
        runs = {"parent": parent.tm.mesh_fused, **runs}

    def measure(fn):
        run = lambda it: run_fused(it[0], it[1], fn, window_cap, record_cap)
        return (timing.cold_device_ms(run, items, dev),
                timing.device_ms(run, items, reps=4))

    fields = turn_fields(timed_in_turns(measure, runs), ("ms", "warm_ms"))
    twin = lambda it: run_fused(it[0], it[1], tm.local_fused_reference,
                                window_cap, record_cap)
    plain_ms = float(np.mean([event_ms(twin, it) for it in items[:2]]))
    R = min(record_cap, window_cap)
    need = [mesh_need(mfi, g, blk, kw["qpack"], window_cap, R, with_planes)
            for blk, kw, g in items[:16]]
    nbytes = float(np.mean([x for x, _o in need]))
    bound_ms, by = bound_of(nbytes, float(np.mean([o for _x, o in need])))
    slots = float(np.mean([kw["qpack"].shape[0] for _b, kw, _g in items]))
    return {**fields, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes, "slots": slots}


RING_STEP_FORMS = ("next", "last", "first")


def time_ring_step(shape, device, form):
    """(kernel ms, warm ms, twin ms, bound ms, bytes, library ms, library
    warm ms) of one ring step launch on blocks of ``shape`` in one of
    its three forms: "next" (acc += src, next = src: 16 bytes a word),
    "last" (acc += src: 12) and "first" (acc = own + src out of place,
    no next, as every launch of a two-entry ring: 12), at the HBM rate.
    The kernel ms with the L2 flushed before each launch, the warm ms
    back to back; the twin (the sum of two blocks) by an event pair;
    PyTorch's own elementwise calls for the same step (``acc.add_(src)``,
    then ``nxt.copy_(src)`` for "next"; ``torch.add(own, src, out=acc)``
    for "first") under the kernel's cold and warm regimes."""
    import torch

    from sbeacon_tpu_torch.ops import gather_kernel as tg
    from sbeacon_tpu_torch.ops import timing

    g = np.random.default_rng(26)
    blocks = [torch.from_numpy(g.integers(-1000, 1000, size=shape,
                                          dtype=np.int32)).to(device)
              for _ in range(4)]
    src, nxt, acc, own = blocks
    if form == "first":
        run = lambda _i: tg.ring_step(src, None, acc, own=own)
    else:
        run = lambda _i: tg.ring_step(src, nxt if form == "next" else None,
                                      acc)
    ms = timing.cold_device_ms(run, range(16), device)
    warm_ms = timing.device_ms(run, range(16), reps=4)
    plain_ms = event_ms(tg.gather_partials_portable, [src, acc])

    def library(_i):
        if form == "first":
            torch.add(own, src, out=acc)
            return
        acc.add_(src)
        if form == "next":
            nxt.copy_(src)

    lib_ms = timing.cold_device_ms(library, range(16), device)
    lib_warm_ms = timing.device_ms(library, range(16), reps=4)
    nbytes = (16 if form == "next" else 12) * src.numel()
    return (ms, warm_ms, plain_ms, nbytes / HBM_BYTES_PER_S * 1e3, nbytes,
            lib_ms, lib_warm_ms)


def time_ring_pair(shape, device):
    """A whole ring_gather over two entries of ``shape`` on the card: its
    launches (from the launch count of one call) and its cold and warm
    device ms, beside the same sums as two PyTorch calls (``[p0 + p1, p1
    + p0]``) under the same regimes, and its bound (two out-of-place
    steps, 12 bytes a word each, at the HBM rate)."""
    import torch

    from sbeacon_tpu_torch import telemetry
    from sbeacon_tpu_torch.ops import gather_kernel as tg
    from sbeacon_tpu_torch.ops import timing

    g = np.random.default_rng(25)
    parts = [torch.from_numpy(g.integers(-2**31, 2**31, size=shape,
                                         dtype=np.int64).astype(np.int32))
             .to(device) for _ in range(2)]
    telemetry.reset_launch_counts()
    got = tg.ring_gather(parts)
    torch.cuda.synchronize()
    launches = tg.ring_gather_launches
    want = tg.gather_partials_portable(parts)
    equal = all(torch.equal(x, want) for x in got)
    run = lambda _i: tg.ring_gather(parts)
    library = lambda _i: [parts[0] + parts[1], parts[1] + parts[0]]
    nbytes = 2 * 12 * parts[0].numel()
    return {"shape": list(shape), "entries": 2, "launches": launches,
            "equal": equal,
            "ms": timing.cold_device_ms(run, range(16), device),
            "warm_ms": timing.device_ms(run, range(16), reps=4),
            "library_ms": timing.cold_device_ms(library, range(16), device),
            "library_warm_ms": timing.device_ms(library, range(16), reps=4),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}


def compare_ring_steps(shape, device, seed, misaligned=False):
    """ring_step alone, out of place (own != acc) and in place (own is
    acc), each with and without next, vs the twin's sum; src and own
    must stay unchanged and next must equal src. Returns (equal,
    max_abs_err)."""
    import torch

    from sbeacon_tpu_torch.ops import gather_kernel as tg

    g = np.random.default_rng(seed)
    numel = int(np.prod(shape))
    blocks = []
    for _ in range(4):
        t = torch.from_numpy(g.integers(-2**31, 2**31, size=numel,
                                        dtype=np.int64).astype(np.int32))
        base = torch.empty(numel + int(misaligned), dtype=torch.int32,
                           device=device)
        base[int(misaligned):] = t.to(device)
        blocks.append(base[int(misaligned):].view(shape))
    src, own, acc, nxt = blocks
    src0, own0, acc0 = src.clone(), own.clone(), acc.clone()
    equal, err = True, 0
    for in_place in (False, True):
        for with_next in (False, True):
            acc.copy_(acc0)
            nxt.zero_()
            tg.ring_step(src, nxt if with_next else None, acc,
                         own=acc if in_place else own)
            torch.cuda.synchronize()
            want = tg.gather_partials_portable([acc0 if in_place else own0,
                                                src0])
            equal &= (torch.equal(acc, want) and torch.equal(src, src0)
                      and torch.equal(own, own0)
                      and (not with_next or torch.equal(nxt, src0)))
            err = max(err, int((acc.long() - want.long()).abs().max()))
    return equal, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--requests", type=int, default=384)
    ap.add_argument("--threads", type=int, default=64)
    ap.add_argument("--cohorts", type=int, default=3)
    ap.add_argument("--cohort-rows", type=int, default=5_000_000)
    ap.add_argument("--fused-requests", type=int, default=256)
    ap.add_argument("--samples", type=int, default=2504)
    ap.add_argument("--plane-rows", type=int, default=2_000_000)
    ap.add_argument("--selected-requests", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="another checkout (e.g. the parent commit): its "
                         "scatter_match, bisect_query, scatter_selected, "
                         "plane_stats, stacked_query, stacked_selected and "
                         "mesh_fused kernels are built from its sources "
                         "and timed in turns beside this tree's; DIR must "
                         "lie under this checkout's build/")
    args = ap.parse_args(argv)
    if args.parent and not parent_dir_ok(args.parent):
        ap.error(f"--parent {args.parent}: not under {BUILD_DIR}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    return run(args, torch.device("cuda", 0))


def run(args, device) -> int:
    """Every phase, on ``device``."""
    import torch

    from sbeacon_tpu_torch import telemetry
    from sbeacon_tpu_torch.api.envelopes import Envelopes
    from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
    from sbeacon_tpu_torch.engine import VariantEngine
    from sbeacon_tpu_torch.index.columnar import FLAG, build_index
    from sbeacon_tpu_torch.ingest.pipeline import distinct_variant_count
    from sbeacon_tpu_torch.ops import _build
    from sbeacon_tpu_torch.ops import gather_kernel as tg
    from sbeacon_tpu_torch.ops import kernel as tk
    from sbeacon_tpu_torch.ops import plane_kernel as pk
    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.ops.query_pack import window_bounds
    from sbeacon_tpu_torch.parallel import distinct as dc
    from sbeacon_tpu_torch.parallel import mesh as tm
    from sbeacon_tpu_torch.testing import random_records, synthetic_shard

    rng = random.Random(args.seed)

    # 1. environment
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("environment", device=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    _build.build_all()
    libs = {name: _build.load(name)._name for name in _build.SIGNATURES}
    emit("build", kernels=sorted(libs), seconds=time.perf_counter() - t0,
         flags=" ".join(_build.NVCC_FLAGS), libraries=libs,
         nvcc_seconds={n: _build.build_log.get(n, {}).get("seconds")
                       for n in libs},
         ptxas={n: _build.build_log.get(n, {}).get("ptxas", "")[-1500:]
                for n in libs})
    parent = None
    if args.parent:
        t0 = time.perf_counter()
        parent = load_parent(args.parent)
        parent.build.build_all()
        emit("build", parent=parent.root, seconds=time.perf_counter() - t0,
             ptxas={n: parent.build.build_log.get(n, {}).get("ptxas",
                                                             "")[-1500:]
                    for n in PARENT_TIMED})

    # the 1000-Genomes-shaped corpus and the engine that serves it
    t0 = time.perf_counter()
    shard = synthetic_shard(args.rows, seed=args.seed, dataset_id="g1k")
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    # defaults (window_cap 2048, record_cap 1024, micro-batcher on, fused
    # dispatch on), the leader holding a batch open 2 ms for followers
    engine = VariantEngine(
        BeaconConfig(engine=EngineConfig(**SERVING_PHASE_CONFIG)),
        device=device,
    )
    engine.add_index(shard)
    t_index = time.perf_counter() - t0
    (_ds, _vcf, (_s, index, _p)), = list(engine.indexes_for([]))
    emit("setup", rows=shard.n_rows, records=shard.meta["n_records"],
         chroms="1-22", genotype_planes=False, generate_s=t_gen,
         pack_upload_s=t_index, index_bytes=index.nbytes(),
         seg_k=index.seg_k, window_cap=engine.config.engine.window_cap,
         record_cap=engine.config.engine.record_cap,
         microbatch=engine.config.engine.microbatch,
         microbatch_wait_ms=engine.config.engine.microbatch_wait_ms)

    try:
        # 3. scatter_match vs twin at the main path's shapes, and on a
        # crafted shard (12-alt records -> scan form, clamped row,
        # straddlers)
        err_big, rep_big = compare_kernel(index, device, rng, NSLOTS, "g1k")
        crafted_shard = build_index(crafted_records(), dataset_id="crafted")
        crafted = sk.ScatterDeviceIndex(crafted_shard, device)
        check(crafted.seg_k > sk.SEG_K_MAX, "crafted shard lacks long records")
        err_cr, rep_cr = compare_kernel(crafted, device, rng, 256, "crafted")
        max_err = max(err_big, err_cr)
        emit("kernel_vs_twin", kernel=sk.KERNEL, tolerance=0,
             max_abs_err=max_err, cases=len(rep_big) + len(rep_cr),
             all_equal=all(r["equal"] for r in rep_big + rep_cr),
             crafted_seg_k=crafted.seg_k, report=rep_big + rep_cr)
        del crafted

        # 4. the single-dataset main path
        env = Envelopes(engine.config.info)
        bodies = request_bodies(
            shard, rng, args.requests, engine.config.engine.window_cap
        )
        fallbacks0 = engine.host_fallbacks
        telemetry.reset_launch_counts()
        served, wall = run_main_path(engine, env, [shard], bodies,
                                     args.threads)
        launches = telemetry.launch_count(sk.KERNEL)
        by_tier: dict = {}
        real_by_tier: dict = {}  # the real queries of each launch
        for r in telemetry.recent_launches():
            if r["kernel"] == sk.KERNEL:
                key = (r["C"], r["exact_only"])
                by_tier[key] = by_tier.get(key, 0) + 1
                real_by_tier.setdefault(key, []).append(
                    r.get("specs_real", r["slots"]))
        fallbacks = engine.host_fallbacks - fallbacks0
        occ = engine.batcher.occupancy()
        stages = engine.stage_timing()
        lat = [ms for _d, ms, _p, _r in served]
        n_hit, mismatches = check_served([shard], env, bodies, served)
        check(mismatches == 0, f"{mismatches} responses differ from the host matcher")
        check(launches > 0, "the main path launched the scatter match kernel")
        check(launches < len(bodies),
              "launches below the request count (requests coalesced)")
        check(fallbacks > 0, "wide requests took the host path")
        # the phase's query mix, for the device time probe of phase 18
        main_specs = [payload_spec(p) for _d, _ms, p, _r in served]
        window_cap = engine.config.engine.window_cap
        emit("main_path",
             response_cache=engine.config.engine.response_cache,
             requests=len(bodies), threads=args.threads,
             hits=n_hit, mismatches=mismatches,
             scatter_match_launches=launches,
             launches_per_request=launches / len(bodies),
             launches_by_tier={f"C{c}_{'exact' if e else 'any'}": n
                               for (c, e), n in sorted(by_tier.items())},
             slots_by_tier={f"C{c}_{'exact' if e else 'any'}": {
                 "real_mean": float(np.mean(v)), "real_max": int(max(v))}
                 for (c, e), v in sorted(real_by_tier.items())},
             batcher=occ, host_fallbacks=fallbacks, wall_s=wall,
             requests_per_s=len(bodies) / wall,
             latency_ms={"p50": percentile(lat, 0.5),
                         "p99": percentile(lat, 0.99)},
             stage_ms=stages, device=kind, nvidia_smi=smi)

        # 4a. what the serving hooks cost a request (host clock), on the
        # main path's first 128 payloads served one at a time
        hooks_cost(engine, [p for _d, _ms, p, _r in served][:128], kind, smi)

        # 5. scatter_match timing at the 2e7-row shape, every tier: a full
        # batch (NSLOTS slots), and the main path's own launch shape (its
        # mean real queries of the tier, padded to CHUNK_SMALL slots)
        timings = []
        for C, cap, r_lo, r_hi in tiers(index.tile):
            for exact in (True, False):
                t = time_kernel(index, device, rng, C, cap, r_lo, r_hi,
                                exact, parent=parent)
                n_real = max(1, round(float(np.mean(
                    real_by_tier.get((C, exact), [6])))))
                t64 = time_kernel_padded(index, device, rng, C, cap, r_lo,
                                         r_hi, exact, n_real, parent=parent)
                n = by_tier.get((C, exact), 0)
                timings.append(
                    {"C": C, "cap": cap, "exact_only": exact,
                     "slots": NSLOTS, **t,
                     "bound_share": t["bound_ms"] / t["ms"],
                     "main_path_launches": n,
                     "main_path_shape": {
                         "slots": sk.CHUNK_SMALL, "real_slots": n_real,
                         **t64, "bound_share": t64["bound_ms"] / t64["ms"],
                         "launches_x_ms": n * t64["ms"],
                         **({"parent_launches_x_ms": n * t64["parent_ms"]}
                            if parent is not None else {})}}
                )

        # the card's busy time in the main path: each tier's launches at
        # the cold time of the shape they launched
        busy_ms = sum(t["main_path_shape"]["launches_x_ms"] for t in timings)
        parent_busy = ({"main_path_kernel_ms_parent": sum(
            t["main_path_shape"]["parent_launches_x_ms"] for t in timings)}
            if parent is not None else {})
        emit("timing", kernel=sk.KERNEL, library_ms=None,
             main_path_kernel_ms=busy_ms, **parent_busy,
             main_path_busy_share=busy_ms / (wall * 1e3),
             library_note="no single PyTorch call computes this function",
             tiers=timings, device=kind, nvidia_smi=smi)

        # 5a. cache_path: the main shard behind an engine of the JAX
        # default config (the response cache on), CACHE_BODIES bodies of
        # the main mix each sent CACHE_REPEATS times, shuffled, on many
        # threads; then one delta of about DELTA_REGION_ROWS rows over one
        # bracketed region and the bodies once more. The cache-off engine
        # above is the uncached answer (the delta published there too),
        # held against the host matcher
        cache_launches = run_cache_path(engine, shard, env, args, device,
                                        kind, smi)
    finally:
        engine.close()

    # 6. an engine over the g1k shard and more cohorts (defaults, fused
    # dispatch on); the fused stack of all of them is built inline,
    # before any timed request
    t0 = time.perf_counter()
    cohorts = [
        synthetic_shard(args.cohort_rows, seed=args.seed + i,
                        dataset_id=f"cohort{i}")
        for i in range(1, args.cohorts + 1)
    ]
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = VariantEngine(
        BeaconConfig(engine=EngineConfig(**SERVING_PHASE_CONFIG)),
        device=device,
    )
    try:
        for s in [shard] + cohorts:
            engine.add_index(s)
        t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        findex = engine.warm_fused()
        t_fused = time.perf_counter() - t0
        check(findex is not None and findex.n_shards == len(cohorts) + 1,
              "the fused stack covers every dataset")
        served_shards = [s for _d, _v, (s, _i, _p) in engine.indexes_for([])]
        emit("fused_setup", datasets=[s.meta["dataset_id"] for s in served_shards],
             stacked_rows=findex.n_rows, padded_rows=findex.n_padded,
             fused_bytes=findex.nbytes(), n_iters=findex.n_iters,
             window_hint=findex.window_hint, generate_s=t_gen,
             pack_upload_s=t_index, fused_build_s=t_fused)

        # 7. bisect_query vs twin: on the stack above, and on a small
        # stack of the crafted shard (12-alt records), a cohort lacking
        # chromosome 5 and a shard of other symbolic types
        err_fused, rep_fused = compare_bisect(
            findex, served_shards, rng, "fused", 1024
        )
        small_shards = [
            crafted_shard,
            synthetic_shard(100_000, seed=args.seed + 9, dataset_id="no5",
                            chroms=["1", "2"]),
            build_index(random_records(random.Random(args.seed), chrom="5",
                                       n=2000, n_samples=0, p_symbolic=0.3),
                        dataset_id="sym"),
        ]
        small = tk.FusedDeviceIndex(small_shards, device)
        err_small, rep_small = compare_bisect(small, small_shards, rng,
                                              "crafted_stack", 16)
        del small
        err_edges, rep_edges = compare_bisect_edges(device)
        bisect_err = max(err_fused, err_small, err_edges)
        reports = rep_fused + rep_small + rep_edges
        check(all(sum(r[k] for r in reports) > 0
                  for k in ("matched", "overflow", "over_record_cap", "empty")),
              "the cases reach matches, overflow, matches past record_cap "
              "and empty windows")
        emit("kernel_vs_twin", kernel=tk.KERNEL, tolerance=0,
             max_abs_err=bisect_err, cases=len(reports),
             all_equal=all(r["equal"] for r in reports), report=reports)

        # 8. the fused path: every request asks every dataset
        bodies = request_bodies(shard, rng, args.fused_requests,
                                engine.config.engine.window_cap, p_other=0.05)
        fused0 = engine.fused_searches
        fallbacks0 = engine.host_fallbacks
        occ0 = engine.batcher.occupancy()
        telemetry.reset_launch_counts()
        served, wall = run_main_path(engine, env, served_shards, bodies,
                                     args.threads)
        bisect_launches = telemetry.launch_count(tk.KERNEL)
        scatter_in_fused = telemetry.launch_count(sk.KERNEL)
        fused_searches = engine.fused_searches - fused0
        occ = engine.batcher.occupancy()
        # queries per batched call of the phase: each call is one launch
        batch_sizes = [
            size
            for size, n in occ["fused_hist"].items()
            for _ in range(n - occ0["fused_hist"].get(size, 0))
        ]
        check(len(batch_sizes) == bisect_launches,
              "one bisect_query launch per batched call")
        stages = engine.stage_timing()
        lat = [ms for _d, ms, _p, _r in served]
        n_hit, mismatches = check_served(served_shards, env, bodies, served)
        check(mismatches == 0, f"{mismatches} fused responses differ from "
              "the host matcher")
        check(bisect_launches > 0, "the fused path launched bisect_query")
        check(bisect_launches < len(bodies),
              "bisect_query launches below the request count (requests "
              "for different datasets coalesced)")
        check(fused_searches > 0, "requests rode the fused stack")
        emit("fused_path",
             response_cache=engine.config.engine.response_cache,
             requests=len(bodies), threads=args.threads,
             datasets=len(served_shards), hits=n_hit, mismatches=mismatches,
             bisect_query_launches=bisect_launches,
             scatter_match_launches=scatter_in_fused,
             launches_per_request=bisect_launches / len(bodies),
             fused_searches=fused_searches,
             host_fallbacks=engine.host_fallbacks - fallbacks0,
             queries_per_launch={
                 "min": min(batch_sizes), "p50": percentile(batch_sizes, 0.5),
                 "max": max(batch_sizes)},
             batched_calls=occ["launches"] - occ0["launches"],
             wall_s=wall, requests_per_s=len(bodies) / wall,
             latency_ms={"p50": percentile(lat, 0.5),
                         "p99": percentile(lat, 0.99)},
             stage_ms=stages, device=kind, nvidia_smi=smi)

        # 9. bisect_query timing at the batch sizes phase 8 launched,
        # beside the parent's kernel
        sizes = sorted({min(batch_sizes), percentile(batch_sizes, 0.5),
                        max(batch_sizes)})
        btimings = []
        for b in sizes:
            for what in ("point", "bracket"):
                t = time_bisect(findex, served_shards, rng, b, what,
                                engine.config.engine.record_cap,
                                parent=parent)
                btimings.append({"queries": b, "kind": what, **t,
                                 "bound_share": t["bound_ms"]
                                 / t["ms_flushed"]})
        # upper estimate of the card's busy share in the fused path:
        # every launch at the slowest flushed time measured at or above
        # its size
        slowest = {b: max(t["ms_flushed"] for t in btimings
                          if t["queries"] == b)
                   for b in sizes}
        busy_ms = sum(slowest[min((s for s in sizes if s >= b),
                                  default=sizes[-1])]
                      for b in batch_sizes)
        emit("timing", kernel=tk.KERNEL, library_ms=None,
             fused_path_kernel_ms_upper=busy_ms,
             fused_path_busy_share_upper=busy_ms / (wall * 1e3),
             library_note="no single PyTorch call computes this function: "
                          "torch.searchsorted gives only the window bounds",
             batches=btimings, device=kind, nvidia_smi=smi)
    finally:
        engine.close()

    # 9a. bisect_query vs its twin on L0 composites (the delta tail's
    # index: segment tables of 16-512 padded shards, read from global
    # memory), 9c-9e. warmup, the delta path and the L0 launch's timing
    l0_err, rep_l0 = compare_l0(device)
    emit("kernel_vs_twin", kernel=tk.KERNEL, form="l0", tolerance=0,
         max_abs_err=l0_err, cases=len(rep_l0),
         all_equal=all(r["equal"] for r in rep_l0), report=rep_l0)
    del engine, findex, served_shards
    torch.cuda.empty_cache()
    l0 = run_delta_path([shard] + cohorts, env, args, device, kind, smi)
    l0["max_abs_err"] = max(l0_err, l0["path_max_abs_err"])

    # 10. datasets A (the main shard with a 2504-sample gt plane) and B
    # (all four planes, genotype-derived counts) behind an engine with
    # device planes on (the default), and the fused stack of both
    t0 = time.perf_counter()
    shard_a = attach_planes(shard, args.samples, args.seed + 20, device,
                            counts=False, dataset_id="g1kA")
    shard_b = attach_planes(
        synthetic_shard(args.plane_rows, seed=args.seed + 21,
                        n_samples=args.samples, dataset_id="cohortB"),
        args.samples, args.seed + 22, device, counts=True,
        dataset_id="cohortB")
    t_gen = time.perf_counter() - t0
    engine = VariantEngine(
        BeaconConfig(engine=EngineConfig(**SERVING_PHASE_CONFIG)),
        device=device,
    )
    try:
        t0 = time.perf_counter()
        for s in (shard_a, shard_b):
            engine.add_index(s)
        torch.cuda.synchronize()
        t_add = time.perf_counter() - t0
        served = list(engine.indexes_for([]))
        sel_shards = [s for _d, _v, (s, _i, _p) in served]
        planes = {d: p for d, _v, (_s, _i, p) in served}
        check(all(p is not None and p.gt.device.type == device.type
                  for p in planes.values()),
              "both datasets' planes are on the card")
        check(not planes["g1kA"].has_counts and planes["cohortB"].has_counts,
              "dataset A uploads gt only, dataset B all four planes")
        findex = engine.warm_fused()
        check(findex is not None, "the fused stack covers A and B")
        emit("selected_setup", datasets={
            d: {"rows": p.n_rows, "words": p.n_words,
                "planes": 4 if p.has_counts else 1,
                "plane_bytes": p.nbytes_hbm()} for d, p in planes.items()},
             samples=args.samples,
             plane_bytes_resident=engine.plane_hbm_resident(),
             budget_gb=engine.config.engine.plane_hbm_budget_gb,
             derived_row_share=float(np.mean(
                 (shard_b.cols["flags"] & FLAG.AC_INFO) == 0)),
             generate_s=t_gen, add_upload_s=t_add,
             device_memory_gb=torch.cuda.memory_allocated() / 1e9)

        # 11. scatter_selected vs twin: dataset B (2504 samples, counts),
        # dataset A (gt only; its 6.3 GB plane puts row offsets past
        # 4 GiB from row 13.6e6 on: every tier at one slot, the serving
        # path's shape, and at 16 slots on its last 5% of rows) and a
        # crafted 40-sample shard (tail word, ploidy > 2, 12-alt records)
        record_cap = engine.config.engine.record_cap
        (_s, index_a, pidx_a), = [t for d, _v, t in served if d == "g1kA"]
        (_s, index_b, pidx_b), = [t for d, _v, t in served if d == "cohortB"]
        cases = [
            (C, cap, lo_r, hi_r, exact, counts, (1, 16, 64)[k % 3])
            for k, ((C, cap, lo_r, hi_r), exact, counts) in enumerate(
                (t, e, c) for t in tiers(index_b.tile) for e in (True, False)
                for c in (True, False))
        ]
        err_b, rep_b = compare_selected(index_b, pidx_b, rng, "cohortB",
                                        record_cap, cases)
        err_a, rep_a = 0, []
        tail_lo = int(0.95 * pidx_a.n_rows)
        for b, row_lo in ((1, 0), (16, tail_lo)):
            err, rep = compare_selected(
                index_a, pidx_a, rng, "g1kA", record_cap,
                [(C, cap, lo_r, hi_r, exact, False, b)
                 for C, cap, lo_r, hi_r in tiers(index_a.tile)
                 for exact in (True, False)], row_lo)
            err_a, rep_a = max(err_a, err), rep_a + rep
        check(max(r["max_row"] for r in rep_a) >= tail_lo,
              "dataset A's cases read rows near the end of its plane")
        crafted_p = build_index(crafted_plane_records(), dataset_id="craftedP",
                                sample_names=[f"S{i}" for i in range(40)])
        c_index = sk.ScatterDeviceIndex(crafted_p, device)
        c_planes = pk.PlaneDeviceIndex(crafted_p, device)
        check(c_index.seg_k > sk.SEG_K_MAX and c_planes.has_counts
              and len(crafted_p.gt_overflow), "the crafted shard's shapes")
        err_c, rep_c = compare_selected(c_index, c_planes, rng, "crafted",
                                        record_cap, cases)
        del c_index, c_planes
        sel_err = max(err_a, err_b, err_c)
        reports = rep_a + rep_b + rep_c
        check(sum(r["rows"] for r in reports) > 0
              and sum(r["or_bits"] for r in reports) > 0,
              "the cases matched rows and extracted samples")
        emit("kernel_vs_twin", kernel=sk.SELECTED_KERNEL, tolerance=0,
             max_abs_err=sel_err, cases=len(reports),
             all_equal=all(r["equal"] for r in reports), report=reports)

        # 12. plane_stats vs twin on dataset B's planes, and on dataset
        # A's gt plane at the row-set size of the serving path's overflow
        # and N-ref requests, anywhere and on its last 20000 rows
        ps_err, rep_ps = compare_plane_stats(
            pidx_b, rng, "cohortB", (1, 128, 1000, 20000),
            ("none", "some", "all"), (True, False))
        for lo in (0, pidx_a.n_rows - 20000):
            err, rep = compare_plane_stats(pidx_a, rng, "g1kA", (5000,),
                                           ("some", "all"), (False,), lo)
            ps_err, rep_ps = max(ps_err, err), rep_ps + rep
        check(max(r["max_row"] for r in rep_ps) >= pidx_a.n_rows - 20000,
              "plane_stats read rows near the end of dataset A's plane")
        err, rep = compare_plane_edges(pidx_b, rng, "cohortB")
        ps_err, rep_ps = max(ps_err, err), rep_ps + rep
        emit("kernel_vs_twin", kernel=pk.KERNEL, tolerance=0,
             max_abs_err=ps_err, cases=len(rep_ps),
             all_equal=all(r["equal"] for r in rep_ps), report=rep_ps)

        # 13. the selected path (its own generator: the request mix does
        # not move when the phases before it draw more cases)
        jobs, classes = selected_jobs(
            sel_shards, random.Random(args.seed + 13), args.selected_requests,
            engine.config.engine.window_cap)
        fallbacks0 = engine.host_fallbacks
        telemetry.reset_launch_counts()
        served_sel, sel_wall = run_jobs(engine, env, jobs, args.threads)
        counts = {k: telemetry.launch_count(k) for k in
                  (sk.SELECTED_KERNEL, pk.KERNEL, sk.KERNEL, tk.KERNEL)}
        recs = telemetry.recent_launches()
        sel_recs = [r for r in recs if r["kernel"] == sk.SELECTED_KERNEL]
        ps_recs = [r for r in recs if r["kernel"] == pk.KERNEL]
        fallbacks = engine.host_fallbacks - fallbacks0
        lat = [ms for _d, ms, _p, _r in served_sel]
        n_hit, mismatches = check_served(
            sel_shards, env, [b for _d, b, _s in jobs], served_sel)
        check(mismatches == 0, f"{mismatches} selected-path responses differ "
              "from the host matcher and host planes")
        check(counts[sk.SELECTED_KERNEL] > 0,
              "the selected path launched scatter_selected")
        check(counts[pk.KERNEL] > 0, "the selected path launched plane_stats")
        check(all(p is not None for _d, _v, (_s, _i, p)
                  in engine.indexes_for([])), "the planes stayed on the card")
        n = len(jobs)
        emit("selected_path",
             response_cache=engine.config.engine.response_cache,
             requests=n, threads=args.threads, hits=n_hit,
             mismatches=mismatches,
             classes={c: classes.count(c) for c in sorted(set(classes))},
             selected_requests=sum(s is not None for _d, _b, s in jobs),
             launches=counts,
             launches_per_request={k: v / n for k, v in counts.items()},
             scatter_selected_by_tier={
                 f"C{c}_{'counts' if w else 'gt'}": sum(
                     1 for r in sel_recs if (r["C"], r["with_counts"]) == (c, w))
                 for c, w in sorted({(r["C"], r["with_counts"])
                                     for r in sel_recs})},
             scatter_selected_slots=sorted({r["slots"] for r in sel_recs}),
             plane_stats_rows={"min": min((r["rows"] for r in ps_recs),
                                          default=0),
                               "max": max((r["rows"] for r in ps_recs),
                                          default=0)},
             plane_bytes_read={
                 sk.SELECTED_KERNEL: sum(r.get("plane_bytes", 0)
                                         for r in sel_recs),
                 pk.KERNEL: sum(r["plane_bytes"] for r in ps_recs)},
             host_fallbacks=fallbacks, wall_s=sel_wall,
             requests_per_s=n / sel_wall,
             latency_ms={"p50": percentile(lat, 0.5),
                         "p99": percentile(lat, 0.99)},
             stage_ms=engine.stage_timing(), device=kind, nvidia_smi=smi)

        # 14. timing at the shapes phase 13 launched: scatter_selected at
        # its slot counts per (tier, counts) it used, dataset A without
        # counts and B with; plane_stats at the median row-set size of
        # each (counts, or) combination it used. "ms" finds the L2 cold
        # (a memset between launches), "warm_ms" is back to back
        by_case: dict = {}
        for r in sel_recs:
            key = (r["C"], r["cap"], r["slots"], r["exact_only"],
                   r["with_counts"])
            by_case[key] = by_case.get(key, 0) + 1
        stimings = []
        for (C, cap, b, exact, counts_on), launched in sorted(by_case.items()):
            idx, pidx = (index_b, pidx_b) if counts_on else (index_a, pidx_a)
            t = time_selected(idx, pidx, rng, C, cap, b, exact, counts_on,
                              record_cap, parent=parent)
            stimings.append(
                {"C": C, "cap": cap, "slots": b, "exact_only": exact,
                 "with_counts": counts_on,
                 "selected_path_launches": launched, **t,
                 "bound_share": t["bound_ms"] / t["ms"]})
        emit("timing", kernel=sk.SELECTED_KERNEL, library_ms=None,
             library_note="no single PyTorch call computes this function",
             cases=stimings, device=kind, nvidia_smi=smi)
        by_combo: dict = {}
        for r in ps_recs:
            by_combo.setdefault((r["with_counts"], r["with_or"]), []).append(
                r["rows"])
        ptimings = []
        for (counts_on, with_or), sizes in sorted(by_combo.items()):
            pidx = pidx_b if counts_on else pidx_a
            size = int(percentile(sizes, 0.5))
            t = time_plane_stats(pidx, rng, size, counts_on, with_or,
                                 parent=parent)
            ptimings.append(
                {"rows": size, "with_counts": counts_on, "with_or": with_or,
                 "selected_path_launches": len(sizes), **t,
                 "bound_share": t["bound_ms"] / t["ms"]})
        # estimate of the card's busy share in the selected path: every
        # launch of the two plane kernels at its case's timed per-launch
        # ms (J1 and J3 launches of the phase left out)
        busy_ms = sum(t["ms"] * t["selected_path_launches"]
                      for t in stimings + ptimings)
        emit("timing", kernel=pk.KERNEL, library_ms=None,
             library_note="no single PyTorch call computes this function",
             cases=ptimings, selected_path_plane_kernel_ms_est=busy_ms,
             selected_path_plane_busy_share_est=busy_ms / (sel_wall * 1e3),
             device=kind, nvidia_smi=smi)
    finally:
        engine.close()
    del engine, findex
    j2 = max(stimings, key=lambda t: t["selected_path_launches"])
    j4 = max(ptimings, key=lambda t: t["selected_path_launches"])

    # 15. the distinct path's keys: every shard built so far (A, the three
    # cohorts, B) and RESUBMITTED seeded row subsets of A, the same
    # sites submitted again in further VCFs of the dataset
    t0 = time.perf_counter()
    again = resubmitted(shard, args.seed + 15, RESUBMITTED)
    t_sub = time.perf_counter() - t0
    base_shards = [shard] + cohorts + [shard_b]
    all_shards = base_shards + again
    keys_np = dc.shard_keys(all_shards)
    keys = torch.from_numpy(keys_np).to(device)
    del keys_np
    plan = dc.bucket_plan(
        keys.shape[0], torch.cuda.get_device_properties(device)
        .multi_processor_count)
    value_keys_n = int(keys.shape[0])
    emit("distinct_setup", shards={s.meta["dataset_id"]: s.n_rows
                                   for s in all_shards},
         keys=int(keys.shape[0]), key_bytes=keys.numel() * 4,
         buckets=plan["buckets"], scratch_bytes=plan["scratch_bytes"],
         hist_blocks=plan["blocks"], table_limit=plan["table_limit"],
         subset_s=t_sub)

    # 16. distinct_count vs its twin at tolerance 0
    dc_err, rep_dc = compare_distinct(keys, device)
    emit("kernel_vs_twin", kernel=dc.KERNEL, tolerance=0, max_abs_err=dc_err,
         cases=len(rep_dc), all_equal=all(r["equal"] for r in rep_dc),
         report=rep_dc)

    # 17. the distinct path: the count over every shard on the card. The
    # subsets add no key, so it equals the count without them, and the
    # host oracle on the shards without them (its byte-verified groups
    # are few there)
    telemetry.reset_launch_counts()
    t0 = time.perf_counter()
    value = dc.distinct_count_device(all_shards, device=device)
    device_s = time.perf_counter() - t0
    dc_launches = telemetry.launch_count(dc.KERNEL)
    rec, = [r for r in telemetry.recent_launches() if r["kernel"] == dc.KERNEL]
    check(dc_launches == 1, "the distinct path launched distinct_count once")
    base_value = dc.distinct_count_device(base_shards, device=device)
    check(value == base_value, f"the row subsets added keys: {value} != "
          f"{base_value} without them")
    t0 = time.perf_counter()
    host = distinct_variant_count(base_shards)
    host_s = time.perf_counter() - t0
    check(host == value, f"device count {value} != host oracle {host}")
    emit("distinct_path", keys=int(keys.shape[0]), value=value,
         parity=value == host, device_s=device_s, host_s=host_s,
         host_keys=sum(s.n_rows for s in base_shards),
         host_shards="A, the cohorts and B (the subsets add no key)",
         distinct_count_launches=dc_launches,
         breakdown={"shard_keys_s": rec["keys_ms"] / 1e3,
                    "h2d_s": rec["upload_ms"] / 1e3,
                    "launch_to_result_ms": rec["count_ms"]},
         device=kind, nvidia_smi=smi)

    # 17a. the same count over the two-entry mesh [card, card]: one
    # partition_keys block and one launch per entry, summed on the
    # first; shard_keys timed beside the earlier per-shard key build
    # (equal bytes)
    t0 = time.perf_counter()
    legacy = legacy_shard_keys(all_shards)
    t_legacy = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = dc.shard_keys(all_shards)
    t_fresh = time.perf_counter() - t0
    check(legacy.tobytes() == fresh.tobytes(),
          "shard_keys gives the bytes of the earlier key build")
    del legacy, fresh
    dmesh = tm.make_mesh(devices=[device, device])
    telemetry.reset_launch_counts()
    t0 = time.perf_counter()
    dmesh_value = dc.distinct_count_device(all_shards, mesh=dmesh)
    dmesh_s = time.perf_counter() - t0
    dmesh_launches = telemetry.launch_count(dc.KERNEL)
    mrec = [r for r in telemetry.recent_launches() if r["kernel"] == dc.KERNEL]
    check(dmesh_launches == 2, "one distinct_count launch per mesh entry")
    check(dmesh_value == host,
          f"mesh count {dmesh_value} != host oracle {host}")
    emit("distinct_path", mesh=[str(d) for d in dmesh.devices],
         keys=value_keys_n, value=dmesh_value, parity=dmesh_value == host,
         device_s=dmesh_s, distinct_count_launches=dmesh_launches,
         block_rows=[r["rows"] for r in mrec],
         breakdown={"shard_keys_s": mrec[0]["keys_ms"] / 1e3,
                    "partition_and_h2d_s": mrec[0]["upload_ms"] / 1e3,
                    "launch_to_result_ms": mrec[0]["count_ms"]},
         shard_keys_s={"this": t_fresh, "prs_4_11": t_legacy},
         device=kind, nvidia_smi=smi)
    distinct_mesh = {"entries": dmesh.size, "launches": dmesh_launches,
                     "device_s": dmesh_s, "value": dmesh_value}

    # 18. timing: distinct_count at the full key set (cold, warm, twin,
    # torch.unique), then the device time probes (J9) on the main-path
    # index and on phase 14's plane-stats row set
    dms, dwarm, dplain, dlib, dbound, dby = time_distinct(keys, device)
    check(torch.unique(keys, dim=0).shape[0] == value,
          "torch.unique counts the same keys")
    emit("timing", kernel=dc.KERNEL, keys=int(keys.shape[0]), ms=dms,
         warm_ms=dwarm, plain_ms=dplain, library_ms=dlib,
         library_call="torch.unique(keys, dim=0)", bound_ms=dbound,
         bound_by=dby, bound_share=dbound / dms,
         stages_ms=kernel_breakdown(dc.distinct_count, keys),
         device=kind, nvidia_smi=smi)
    value_keys = int(keys.shape[0])
    del keys
    torch.cuda.empty_cache()

    telemetry.reset_launch_counts()
    mix_s, mix_bytes = sk.device_time_probe(index, main_specs,
                                            window_cap=window_cap)
    mix_launches = telemetry.launch_count(sk.KERNEL)
    # C=1 exact points alone: single-tile windows only
    points = tier_specs(shard, rng, NSLOTS, 1, 1, True)
    lo, hi = window_bounds(index, tk.encode_queries(points))
    single = (np.maximum(hi, lo + 1) - 1) // index.tile <= lo // index.tile
    points = [q for q, one in zip(points, single) if one]
    pt_s, pt_bytes = sk.device_time_probe(index, points, window_cap=window_cap)
    p5 = next(t for t in timings if t["C"] == 1 and t["exact_only"])
    ratio = pt_s * 1e3 / p5["ms"]
    check(1 / 1.5 <= ratio <= 1.5, f"the C=1 exact probe ({pt_s * 1e3:.5f} "
          f"ms) is not within 1.5x of phase 5's ({p5['ms']:.5f} ms)")
    pidx = pidx_b if j4["with_counts"] else pidx_a
    n_samples = pidx.n_words * 32
    plane_s = pk.device_plane_probe(
        pidx, row_sets(rng, pidx.n_rows, j4["rows"], 1)[0],
        mask_rows(rng, 2, pidx.n_words, n_samples)[
            1 if j4["with_counts"] else 0])
    emit("timing", kernel="device_time_probe",
         mix={"queries": len(main_specs), "ms_per_batch": mix_s * 1e3,
              "bytes_gathered": mix_bytes, "launches": mix_launches,
              "phase5_tiers": [{k: t[k] for k in ("C", "exact_only", "ms")}
                               for t in timings]},
         points={"queries": len(points), "ms_per_batch": pt_s * 1e3,
                 "bytes_gathered": pt_bytes, "phase5_ms": p5["ms"],
                 "ratio": ratio},
         plane={"rows": j4["rows"], "with_counts": pidx.has_counts,
                "ms": plane_s * 1e3, "phase14_ms": j4["ms"],
                "phase14_warm_ms": j4["warm_ms"]},
         device=kind, nvidia_smi=smi)
    del again, all_shards, base_shards, index, index_a, index_b, pidx_a, pidx_b
    del pidx
    torch.cuda.empty_cache()

    # 19. mesh setup: one-card stacks of the dataset-sharded leg. The
    # columns of A and the three cohorts (each padded to A's rows); the gt
    # planes of B and A, in that order, so A's plane rows sit past 2^31
    # words; all four planes of B and two re-submitted row subsets of it.
    # The host copies go once the card holds the blocks.
    one = tm.make_mesh(devices=[device])
    t0 = time.perf_counter()
    qstack = tm.StackedIndex([shard] + cohorts)
    (qblk,) = qstack.shard_to_mesh(one)
    qstack.arrays.clear()
    t_q = time.perf_counter() - t0
    t0 = time.perf_counter()
    pstack = tm.StackedIndex([shard_b, shard_a], with_planes=True)
    (pblk,) = pstack.shard_to_mesh(one)
    pstack.arrays.clear()
    t_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = np.random.default_rng(args.seed + 19)
    b_again = [
        with_plane_rows(shard_b, np.flatnonzero(
            g.random(shard_b.n_rows) < g.uniform(0.4, 0.7)),
            f"cohortB_again{k}")
        for k in range(2)
    ]
    cstack = tm.StackedIndex([shard_b] + b_again, with_planes=True)
    (cblk,) = cstack.shard_to_mesh(one)
    cstack.arrays.clear()
    t_c = time.perf_counter() - t0
    torch.cuda.synchronize()
    a_first_word = pstack.n_padded * pstack.plane_words
    check(2 * a_first_word > 2**31 and cstack.has_count_planes
          and not pstack.has_count_planes, "the stacks' shapes")
    emit("mesh_setup", cut="none", samples=args.samples, stacks={
        "columns": {"datasets": qstack.n_datasets, "rows_padded":
                    qstack.n_padded, "bytes": qblk.columns.numel() * 4
                    + qblk.alt_prefix.numel() * 4, "seconds": t_q},
        "planes": {"datasets": pstack.n_datasets, "rows_padded":
                   pstack.n_padded, "words": pstack.plane_words,
                   "bytes": pblk.planes[0].numel() * 4,
                   "a_first_word": a_first_word,
                   "a_last_word": 2 * a_first_word, "seconds": t_p},
        "count_planes": {"datasets": cstack.n_datasets,
                         "rows": [s.n_rows for s in cstack.shards],
                         "rows_padded": cstack.n_padded,
                         "bytes": sum(p.numel() * 4 for p in cblk.planes),
                         "seconds": t_c}},
         device_memory_gb=torch.cuda.memory_allocated() / 1e9)

    # 20. stacked_query and stacked_selected vs their twins: B = 1, 16,
    # 64 and 512 over every alt mode and VT_OTHER; all-ones, sparse and
    # empty masks; counts both ways; crafted stacks (12-alt records,
    # ploidy > 2, a 40-sample tail word, a padding dataset); queries near
    # the end of A's rows; and the two-entry mesh [card, card], whose
    # per-device sum runs on the card
    tail_lo = int(0.95 * shard.n_rows)
    qshards = [shard] + cohorts
    rep_q, err_q = [], 0
    for b in (1, 16, 64, 512):
        for caps in ((2048, 1024),) + (((256, 16),) if b == 64 else ()):
            err, row = compare_stacked_query(
                qblk, qstack.n_iters, fused_specs(qshards, rng, b)[0],
                "g1k+cohorts", *caps)
            err_q, rep_q = max(err_q, err), rep_q + [row]
    err, row = compare_stacked_query(
        qblk, qstack.n_iters,
        tier_specs(shard, rng, 64, 1, 3000, False, tail_lo), "g1k_tail")
    err_q, rep_q = max(err_q, err), rep_q + [row]
    # clusters of one and of three blocks (d_local 1 and 3)
    for lo, hi in ((0, 1), (1, 4)):
        for b in (1, 64):
            err, row = compare_stacked_query(
                stack_view(qblk, lo, hi), qstack.n_iters,
                fused_specs(qshards, rng, b)[0], f"g1k+cohorts[{lo}:{hi}]")
            err_q, rep_q = max(err_q, err), rep_q + [row]
    small_stack = tm.StackedIndex(small_shards, n_datasets_padded=4)
    (sblk,) = small_stack.shard_to_mesh(one)
    for b, caps in ((16, (2048, 1024)), (64, (2048, 16)), (512, (256, 64))):
        err, row = compare_stacked_query(
            sblk, small_stack.n_iters, fused_specs(small_shards, rng, b)[0],
            "crafted", *caps)
        err_q, rep_q = max(err_q, err), rep_q + [row]
    mesh2 = tm.Mesh([device, device])
    equal2, err = mesh_vs_twin([stack_view(qblk, 0, 2), stack_view(qblk, 2, 4)],
                               mesh2, qstack.n_iters,
                               fused_specs(qshards, rng, 64)[0])
    check(equal2, "sharded_query on [card, card] != the twins' sum")
    err_q = max(err_q, err)
    check(all(sum(r[k] for r in rep_q) > 0
              for k in ("matched", "overflow", "over_record_cap", "empty")),
          "the stacked_query cases reach matches, overflow, matches past "
          "record_cap and empty windows")
    check(max(r["max_row"] for r in rep_q) >= tail_lo,
          "stacked_query read rows near the end of A")
    emit("kernel_vs_twin", kernel=tm.QUERY_KERNEL, tolerance=0,
         max_abs_err=err_q, cases=len(rep_q) + 1,
         all_equal=all(r["equal"] for r in rep_q) and equal2,
         two_entry_mesh_equal=equal2, report=rep_q)

    rep_s, err_s = [], 0
    pshards = [shard_b, shard_a]
    w_p = pstack.plane_words
    for k, b in enumerate((1, 16, 64, 512)):
        for m in mask_sets(rng, 3 if b < 512 else 1, 2, w_p, args.samples):
            err, row = compare_stacked_selected(
                pblk, pstack.n_iters, fused_specs(pshards, rng, b)[0], m,
                False, "B+A")
            err_s, rep_s = max(err_s, err), rep_s + [row]
    for b in (16, 64):
        for m in mask_sets(rng, 3, 2, w_p, args.samples):
            err, row = compare_stacked_selected(
                pblk, pstack.n_iters,
                tier_specs(shard_a, rng, b, 1, 3000, False, tail_lo), m,
                False, "B+A_tail")
            err_s, rep_s = max(err_s, err), rep_s + [row]
    for b in (1, 16, 64):
        for counts_on in (True, False):
            for m in mask_sets(rng, 3, 3, w_p, args.samples):
                err, row = compare_stacked_selected(
                    cblk, cstack.n_iters,
                    fused_specs(cstack.shards, rng, b)[0], m, counts_on,
                    "B+subsets", record_cap=1024 if b < 64 else 32)
                err_s, rep_s = max(err_s, err), rep_s + [row]
    crafted_again = with_plane_rows(
        crafted_p, np.arange(0, crafted_p.n_rows, 2), "craftedP_again")
    crafted_stack = tm.StackedIndex([crafted_p, crafted_again],
                                    n_datasets_padded=3, with_planes=True)
    (csblk,) = crafted_stack.shard_to_mesh(one)
    for b in (16, 64):
        for counts_on in (True, False):
            for m in mask_sets(rng, 3, 3, crafted_stack.plane_words, 40):
                err, row = compare_stacked_selected(
                    csblk, crafted_stack.n_iters,
                    fused_specs([crafted_p, crafted_again], rng, b)[0], m,
                    counts_on, "crafted", record_cap=64)
                err_s, rep_s = max(err_s, err), rep_s + [row]
    del csblk, sblk
    masks2 = mask_sets(rng, 1, 2, w_p, args.samples)[0]
    masks2[1] = mask_rows(rng, 2, w_p, args.samples)[1]
    equal2s, err = mesh_vs_twin(
        [stack_view(pblk, 0, 1), stack_view(pblk, 1, 2)], mesh2,
        pstack.n_iters, fused_specs(pshards, rng, 64)[0], masks2)
    check(equal2s, "sharded_selected_query on [card, card] != the twins' sum")
    err_s = max(err_s, err)
    check(sum(r["rows"] for r in rep_s) > 0
          and sum(r["or_bits"] for r in rep_s) > 0
          and sum(r["overflow"] for r in rep_s) > 0,
          "the stacked_selected cases matched rows, extracted samples and "
          "overflowed")
    check(max(r["max_plane_word"] for r in rep_s) >= 2**31,
          "stacked_selected read plane rows past 2^31 words")
    emit("kernel_vs_twin", kernel=tm.SELECTED_KERNEL, tolerance=0,
         max_abs_err=err_s, cases=len(rep_s) + 1,
         all_equal=all(r["equal"] for r in rep_s) and equal2s,
         two_entry_mesh_equal=equal2s, report=rep_s)
    del qblk, pblk
    torch.cuda.empty_cache()

    # 21. the mesh path: engines whose mesh lists the card twice (the
    # engine takes the mesh leg only at two or more devices, as the JAX
    # engine does); launch counts zeroed just before each run and read
    # just after
    real_mesh_devices = tm.mesh_devices
    tm.mesh_devices = lambda dev: [torch.device(dev)] * 2
    try:
        engine = VariantEngine(
            BeaconConfig(engine=EngineConfig(**SERVING_PHASE_CONFIG)),
            device=device,
        )
        try:
            t0 = time.perf_counter()
            for s in qshards:
                engine.add_index(s)
            t_add = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh_q, stack_q1, qblocks = engine.warm_mesh()
            t_build = time.perf_counter() - t0
            check(mesh_q.size == 2 and len(qblocks) == 2,
                  "the mesh lists the card twice")
            mesh_shards = [s for _d, _v, (s, _i, _p)
                           in engine.indexes_for([])]
            bodies = request_bodies(
                shard, random.Random(args.seed + 21), args.fused_requests,
                engine.config.engine.window_cap, p_other=0.05)
            m0 = engine.mesh_searches
            telemetry.reset_launch_counts()
            served, mq_wall = run_main_path(engine, env, mesh_shards, bodies,
                                            args.threads)
            mq_counts = {k: telemetry.launch_count(k) for k in (
                tm.QUERY_KERNEL, tm.SELECTED_KERNEL, tk.KERNEL, sk.KERNEL)}
            mq_searches = engine.mesh_searches - m0
            lat = [ms for _d, ms, _p, _r in served]
            n_hit, mismatches = check_served(mesh_shards, env, bodies, served)
            check(mismatches == 0, f"{mismatches} mesh-path responses differ "
                  "from the host matcher")
            check(mq_searches > 0 and mq_counts[tm.QUERY_KERNEL] > 0,
                  "the mesh path launched stacked_query")
            emit("mesh_path",
                 response_cache=engine.config.engine.response_cache,
                 requests=len(bodies), threads=args.threads,
                 datasets=len(mesh_shards), mesh=[str(d) for d in
                                                  mesh_q.devices],
                 hits=n_hit, mismatches=mismatches, launches=mq_counts,
                 launches_per_request={k: v / len(bodies)
                                       for k, v in mq_counts.items()},
                 mesh_searches=mq_searches, add_s=t_add,
                 mesh_build_s=t_build, wall_s=mq_wall,
                 requests_per_s=len(bodies) / mq_wall,
                 latency_ms={"p50": percentile(lat, 0.5),
                             "p99": percentile(lat, 0.99)},
                 stage_ms=engine.stage_timing(), device=kind, nvidia_smi=smi)
            mq_specs = [payload_spec(p) for _d, _ms, p, _r in served]
            mq_n_iters = stack_q1.n_iters
        finally:
            engine.close()
        del engine, stack_q1

        # the second engine: A and B with their planes, the plane budget
        # raised to admit the stack's (the two mesh entries are one card:
        # the stack takes twice its per-device bytes there)
        engine = VariantEngine(
            BeaconConfig(engine=EngineConfig(
                **SERVING_PHASE_CONFIG,
                plane_hbm_budget_gb=MESH_PLANE_BUDGET_GB)),
            device=device,
        )
        try:
            t0 = time.perf_counter()
            for s in (shard_a, shard_b):
                engine.add_index(s)
            t_add = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh_s, stack_s, sblocks = engine.warm_mesh()
            t_build = time.perf_counter() - t0
            check(stack_s.has_planes, "the selected stack holds the planes")
            jobs, classes = selected_jobs(
                sel_shards, random.Random(args.seed + 22),
                args.selected_requests, engine.config.engine.window_cap)
            m0 = engine.mesh_searches
            s0 = engine.mesh_selected_searches
            telemetry.reset_launch_counts()
            served_ms, ms_wall = run_jobs(engine, env, jobs, args.threads)
            ms_counts = {k: telemetry.launch_count(k) for k in (
                tm.SELECTED_KERNEL, tm.QUERY_KERNEL, sk.SELECTED_KERNEL,
                pk.KERNEL, sk.KERNEL, tk.KERNEL)}
            ms_searches = engine.mesh_searches - m0
            ms_selected = engine.mesh_selected_searches - s0
            lat = [ms for _d, ms, _p, _r in served_ms]
            n_hit, mismatches = check_served(
                sel_shards, env, [b for _d, b, _s in jobs], served_ms)
            check(mismatches == 0, f"{mismatches} mesh selected-path "
                  "responses differ from the host matcher and host planes")
            check(ms_selected > 0 and ms_counts[tm.SELECTED_KERNEL] > 0,
                  "the selected mix launched stacked_selected")
            n = len(jobs)
            emit("mesh_selected_path",
                 response_cache=engine.config.engine.response_cache,
                 requests=n, threads=args.threads,
                 hits=n_hit, mismatches=mismatches,
                 classes={c: classes.count(c) for c in sorted(set(classes))},
                 launches=ms_counts,
                 launches_per_request={k: v / n for k, v in ms_counts.items()},
                 mesh_searches=ms_searches,
                 mesh_selected_searches=ms_selected,
                 plane_budget=engine._plane_budget_verdict,
                 stack_plane_bytes=sum(b.planes[0].numel() * 4
                                       for b in sblocks),
                 add_upload_s=t_add, mesh_build_s=t_build, wall_s=ms_wall,
                 requests_per_s=n / ms_wall,
                 latency_ms={"p50": percentile(lat, 0.5),
                             "p99": percentile(lat, 0.99)},
                 stage_ms=engine.stage_timing(), device=kind, nvidia_smi=smi)
            # the mesh-served selected requests' (query, per-dataset
            # masks), for phase 22
            sel_sets = []
            for _d, _ms, p, _r in served_ms:
                if p.selected_samples_only and len(p.dataset_ids) == 2:
                    m = np.zeros((2, stack_s.plane_words), np.uint32)
                    for i, s in enumerate(stack_s.shards):
                        names = set(p.sample_names.get(s.meta["dataset_id"],
                                                       []))
                        m[i] = pk.sample_mask_words(
                            [k for k, nm in enumerate(s.meta["sample_names"])
                             if nm in names], stack_s.plane_words)
                    sel_sets.append(([payload_spec(p)], m))
            ms_n_iters = stack_s.n_iters
            sel_names = [s.meta["dataset_id"] for s in stack_s.shards]
        finally:
            engine.close()
        del engine, stack_s
    finally:
        tm.mesh_devices = real_mesh_devices

    # 22. timing at phase 21's batch sizes (one query a launch, on each
    # mesh entry's block) and at 64 queries, L2 cold ("ms") and warm,
    # beside the bound and the twin's time; stacked_selected with counts
    # on the count-plane stack of phase 19
    window_cap = 2048
    record_cap = 1024
    qtimings = []
    for g, blk in enumerate(qblocks):
        for b in (1, 64):
            sets = [mq_specs[(i * b) % len(mq_specs):][:b] or mq_specs[:b]
                    for i in range(64 if b == 1 else 8)]
            t = time_stacked_query(blk, mq_n_iters, sets, window_cap,
                                   record_cap, parent=parent)
            qtimings.append({
                "block": g, "datasets": blk.n_datasets, "queries": b,
                "mesh_path_launches": (mq_counts[tm.QUERY_KERNEL] // 2
                                       if b == 1 else 0),
                **t, "bound_share": t["bound_ms"] / t["ms"]})
    busy_q = sum(t["ms"] * t["mesh_path_launches"] for t in qtimings)
    emit("timing", kernel=tm.QUERY_KERNEL, library_ms=None,
         library_note="no single PyTorch call computes this function: "
                      "torch.searchsorted gives only the window bounds",
         cases=qtimings, mesh_path_kernel_ms_est=busy_q,
         mesh_path_busy_share_est=busy_q / (mq_wall * 1e3),
         device=kind, nvidia_smi=smi)
    check(len(sel_sets) > 0, "phase 21 served selected requests on the mesh")
    stimings = []
    for g, blk in enumerate(sblocks):
        sets = [(specs, m[g : g + 1]) for specs, m in sel_sets[:64]]
        t = time_stacked_selected(blk, ms_n_iters, sets, False, window_cap,
                                  record_cap, parent=parent)
        stimings.append({
            "block": g, "dataset": sel_names[g], "queries": 1,
            "with_counts": False,
            "mesh_path_launches": ms_counts[tm.SELECTED_KERNEL] // 2,
            **t, "bound_share": t["bound_ms"] / t["ms"]})
    for b in (1, 64):
        sets = [(fused_specs(cstack.shards, rng, b, ("exact", "any"))[0], m)
                for m in mask_sets(rng, 16, 3, cstack.plane_words,
                                   args.samples)]
        t = time_stacked_selected(cblk, cstack.n_iters, sets, True,
                                  window_cap, record_cap, parent=parent)
        stimings.append({
            "block": "B+subsets", "queries": b, "with_counts": True,
            "mesh_path_launches": 0, **t,
            "bound_share": t["bound_ms"] / t["ms"]})
    busy_s = sum(t["ms"] * t["mesh_path_launches"] for t in stimings)
    emit("timing", kernel=tm.SELECTED_KERNEL, library_ms=None,
         library_note="no single PyTorch call computes this function",
         cases=stimings, mesh_selected_path_kernel_ms_est=busy_s,
         mesh_selected_path_busy_share_est=busy_s / (ms_wall * 1e3),
         device=kind, nvidia_smi=smi)
    del qblocks, sblocks, cblk
    j7q = next(t for t in qtimings if t["block"] == 0 and t["queries"] == 1)
    j7s = next(t for t in stimings if t["block"] == 1)

    # 23. mesh-fused setup on the two-entry mesh [card, card]: the
    # MeshFusedIndex of A and the three cohorts (d_local 2, each entry's
    # block padded to A + one cohort's rows), of A and B with the gt
    # planes (one shard an entry, about 6.3 GB of plane each), of B and
    # its two re-submitted subsets with all four planes, and a crafted
    # one on three entries of the card whose last group is empty
    fdevs = [device, device]
    t0 = time.perf_counter()
    fq = tm.MeshFusedIndex([shard] + cohorts, tm.Mesh(fdevs))
    t_fq = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp = tm.MeshFusedIndex([shard_a, shard_b], tm.Mesh(fdevs),
                           with_planes=True)
    t_fp = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc = tm.MeshFusedIndex([shard_b] + b_again, tm.Mesh(fdevs),
                           with_planes=True)
    t_fc = time.perf_counter() - t0
    crafted3 = tm.MeshFusedIndex([crafted_p, crafted_again],
                                 tm.Mesh([device] * 3), with_planes=True)
    torch.cuda.synchronize()
    check(fq.d_local == 2 and fp.has_planes and not fp.has_count_planes
          and fc.has_count_planes and crafted3.n_shards < crafted3.n_dev
          * crafted3.d_local and crafted3.blocks[2].offsets.abs().sum() == 0,
          "the mesh-fused indexes' shapes")
    fp_bytes = fp.blocks[0].planes[0].numel() * 4
    emit("mesh_fused_setup", cut="none", mesh=[str(d) for d in fdevs],
         indexes={
             "columns": {"shards": fq.n_shards, "d_local": fq.d_local,
                         "rows_padded": fq.n_padded,
                         "window_hint": fq.window_hint,
                         "bytes": sum((b.columns.numel()
                                       + b.alt_prefix.numel()) * 4
                                      for b in fq.blocks),
                         "seconds": t_fq},
             "planes": {"shards": fp.n_shards, "rows_padded": fp.n_padded,
                        "words": fp.plane_words,
                        "plane_bytes_per_entry": fp_bytes,
                        "plane_bytes_device": fp.plane_bytes_device,
                        "seconds": t_fp},
             "count_planes": {"shards": fc.n_shards, "d_local": fc.d_local,
                              "rows_padded": fc.n_padded,
                              "plane_bytes_per_entry": sum(
                                  p.numel() * 4 for p in fc.blocks[0].planes),
                              "seconds": t_fc},
             "crafted": {"entries": crafted3.n_dev,
                         "shards": crafted3.n_shards}},
         device_memory_gb=torch.cuda.memory_allocated() / 1e9)

    # 24. mesh_fused vs its twin on every entry: B = 1, 16, 64 and 512 in
    # every alt mode and the three layouts; all-ones, sparse and empty
    # masks; counts both ways; filler slots, an empty trailing group and
    # rows near A's end. Then ring_gather on 2-, 3- and 4-entry rings of
    # the card, for the rows-only block and the concatenated block
    layouts = (tm.LAYOUT_OWNER, tm.LAYOUT_SLICED, tm.LAYOUT_REPLICATED)
    rep_f, err_f = [], 0

    def fused_case(mfi, shards_of, b, layout, label, planes=False,
                   counts=None, specs_sids=None, n_samples=None, **caps):
        nonlocal err_f, rep_f
        specs, sids = specs_sids or fused_specs(shards_of, rng, b)
        masks = c = None
        if planes:
            masks = mask_rows(rng, len(specs), mfi.plane_words,
                              n_samples or args.samples)
            c = np.full(len(specs), bool(counts))
        err, row = compare_mesh_fused(mfi, specs, sids, layout, label, masks,
                                      c, **caps)
        err_f, rep_f = max(err_f, err), rep_f + [row]

    for b in (1, 16, 64, 512):
        for layout in layouts:
            fused_case(fq, [shard] + cohorts, b, layout, "g1k+cohorts")
            fused_case(fp, [shard_a, shard_b], b, layout, "A+B", planes=True)
    for layout in layouts:
        fused_case(fq, [shard] + cohorts, 64, layout, "g1k+cohorts",
                   window_cap=256, record_cap=16)
        tail = tier_specs(shard, rng, 64, 1, 3000, False, tail_lo)
        fused_case(fq, None, 64, layout, "g1k_tail",
                   specs_sids=(tail, [0] * 64))
        fused_case(fp, None, 16, layout, "A_tail", planes=True,
                   specs_sids=(tail[:16], [0] * 16))
        for b in (1, 16, 64):
            for counts_on in (True, False):
                fused_case(fc, [shard_b] + b_again, b, layout, "B+subsets",
                           planes=True,
                           counts=counts_on,
                           record_cap=1024 if b < 64 else 32)
        for b in (16, 64):
            for counts_on in (True, False):
                fused_case(crafted3, [crafted_p, crafted_again], b, layout,
                           "crafted3", planes=True, counts=counts_on,
                           n_samples=40, record_cap=64)
    # the match-only cluster launch at the pod tier's slot counts (1-14),
    # on entries of d_local 2 and 10 (past the 9 datasets whose segment
    # rows load beside the query row)
    wide = resubmitted(crafted_shard, args.seed + 24, 20)
    fw = tm.MeshFusedIndex(wide, tm.Mesh(fdevs))
    check(fw.d_local == 10, "the wide mesh-fused index has d_local 10")
    for b in (1, 2, 4, 6, 8, 10, 12, 14):
        for layout in layouts:
            fused_case(fq, [shard] + cohorts, b, layout, "g1k+cohorts")
            fused_case(fw, wide, b, layout, "crafted_x20")
    del fw, wide
    check(all(sum(r[k] for r in rep_f) > 0 for k in (
        "matched", "overflow", "rows", "or_bits", "fillers", "not_owned")),
        "the mesh_fused cases matched, overflowed, extracted samples and "
        "ran filler and foreign slots")
    check(max(r["max_row"] for r in rep_f if r["index"] == "g1k_tail")
          >= tail_lo, "mesh_fused read rows near the end of A")
    emit("kernel_vs_twin", kernel=tm.FUSED_KERNEL, tolerance=0,
         max_abs_err=err_f, cases=len(rep_f),
         all_equal=all(r["equal"] for r in rep_f), report=rep_f)
    rep_r, err_r = [], 0
    for n in (2, 3, 4):
        for shape in ((512, 1024), (512, 3 * 1024 + fp.plane_words), (7, 13)):
            for mis in (False, True):
                equal, err = compare_ring(n, shape, device, seed=n,
                                          misaligned=mis)
                check(equal, f"ring_gather n={n} {shape} != twin")
                err_r = max(err_r, err)
                rep_r.append({"entries": n, "shape": list(shape),
                              "misaligned": mis, "equal": equal})
    for shape in ((512, 1024), (1, 12604), (7, 13)):
        for mis in (False, True):
            equal, err = compare_ring_steps(shape, device, seed=24,
                                            misaligned=mis)
            check(equal, f"ring_step {shape} != twin")
            err_r = max(err_r, err)
            rep_r.append({"steps": "in and out of place, with and without "
                          "next", "shape": list(shape), "misaligned": mis,
                          "equal": equal})
    emit("kernel_vs_twin", kernel=tg.KERNEL, tolerance=0, max_abs_err=err_r,
         cases=len(rep_r), all_equal=all(r["equal"] for r in rep_r),
         report=rep_r)
    del fq, fp, fc, crafted3
    torch.cuda.empty_cache()

    # 25. the mesh-fused path: a MeshDispatchTier over [card, card] behind
    # each engine's micro-batcher, consulted first for every request (the
    # datasets it resolves ride its launch, the rest the engine's paths).
    # A and the cohorts answer the fused-path mix under the default
    # owner-sharded outputs (J6 alone); A and B with their planes answer
    # the selected-path mix in LAYOUT_SLICED (the sliced batch combined
    # over the entries: J6, then P1). Launch counts zeroed just
    # before each run and read just after
    from sbeacon_tpu_torch.parallel.dispatch import MeshDispatchTier

    fused_runs = {}
    tier_index = {}
    for name, shards_of, layout, over, jobs_of in (
        ("mesh_fused_path", [shard] + cohorts, tm.LAYOUT_OWNER, {},
         lambda shards_of: [
             ([{"id": s.meta["dataset_id"]} for s in shards_of], b, None)
             for b in request_bodies(shard, random.Random(args.seed + 25),
                                     args.fused_requests,
                                     2048, p_other=0.05)]),
        ("mesh_fused_selected_path", [shard_a, shard_b], tm.LAYOUT_SLICED,
         dict(plane_hbm_budget_gb=MESH_PLANE_BUDGET_GB),
         lambda shards_of: selected_jobs(
             shards_of, random.Random(args.seed + 26),
             args.selected_requests, 2048)[0]),
    ):
        engine = VariantEngine(
            BeaconConfig(engine=EngineConfig(**SERVING_PHASE_CONFIG,
                                             **over)),
            device=device,
        )
        tier = MeshDispatchTier(engine, devices=fdevs, layout=layout)
        try:
            t0 = time.perf_counter()
            for s_ in shards_of:
                engine.add_index(s_)
            engine.warm_fused()
            t_add = time.perf_counter() - t0
            t0 = time.perf_counter()
            check(tier.warmup() > 0, f"{name}: the tier built")
            t_build = time.perf_counter() - t0
            served_shards = [s_ for _d, _v, (s_, _i, _p)
                             in engine.indexes_for([])]
            jobs = jobs_of(served_shards)
            front = TierFront(engine, tier)
            telemetry.reset_launch_counts()
            served, wall = run_jobs(front, env, jobs, args.threads)
            counts25 = {k: telemetry.launch_count(k) for k in (
                tm.FUSED_KERNEL, tg.KERNEL, tk.KERNEL, sk.KERNEL,
                sk.SELECTED_KERNEL, pk.KERNEL)}
            shapes = {}
            for r in telemetry.recent_launches():
                if r["kernel"] == tm.FUSED_KERNEL:
                    key = (r["slots"], r["layout"], r["words"] > 0)
                    shapes[key] = shapes.get(key, 0) + 1
                elif r["kernel"] == tg.KERNEL:
                    key = ("ring", r["words"])
                    shapes[key] = shapes.get(key, 0) + 1
            lat = [ms for _d, ms, _p, _r in served]
            n_hit, mismatches = check_served(
                served_shards, env, [b for _d, b, _s in jobs], served)
            st = tier.stats()
            check(mismatches == 0, f"{mismatches} {name} responses differ "
                  "from the host matcher and host planes")
            check(st["dispatches"] > 0 and counts25[tm.FUSED_KERNEL] > 0,
                  f"{name}: the tier served requests through mesh_fused")
            check(layout == tm.LAYOUT_OWNER or counts25[tg.KERNEL] > 0,
                  f"{name}: the combined layout launched ring_gather")
            n = len(jobs)
            emit(name,
                 response_cache=engine.config.engine.response_cache,
                 requests=n, threads=args.threads, hits=n_hit,
                 mismatches=mismatches, mesh=[str(d) for d in fdevs],
                 layout=layout, tier=st,
                 launches=counts25,
                 launches_per_request={k: v / n for k, v in counts25.items()},
                 launch_shapes={str(k): v for k, v in sorted(
                     shapes.items(), key=lambda kv: -kv[1])},
                 batcher=engine.batcher.occupancy(), add_s=t_add,
                 tier_build_s=t_build, wall_s=wall, requests_per_s=n / wall,
                 latency_ms={"p50": percentile(lat, 0.5),
                             "p99": percentile(lat, 0.99)},
                 stage_ms=engine.stage_timing(), device=kind,
                 nvidia_smi=smi)
            fused_runs[name] = dict(
                counts=counts25, shapes=shapes, wall=wall,
                specs=[(payload_spec(p), [s_.meta["dataset_id"]
                                          for s_ in served_shards
                                          if s_.meta["dataset_id"]
                                          in p.dataset_ids], p)
                       for _d, _ms, p, _r in served],
                order=[s_.meta["dataset_id"] for s_ in served_shards],
                shards={s_.meta["dataset_id"]: s_ for s_ in served_shards})
            tier_index[name] = tier._state[0]
            if layout == tm.LAYOUT_OWNER:
                # 25a. the tier's delta leg, after the path's own traffic
                run_tier_delta_leg(engine, tier, served_shards, env, args,
                                   kind, smi)
        finally:
            tier.close()
            engine.close()
        del engine, tier
    torch.cuda.empty_cache()

    # 26. timing: mesh_fused at the slot counts phase 25 launched (the
    # served requests' own queries), L2 cold and warm, beside the bound
    # and the twin's time; ring_gather per step at phase 24's block
    # shapes and phase 25's, beside its bound (bytes at the HBM rate)
    ftimings = []
    for name, with_planes in (("mesh_fused_path", False),
                              ("mesh_fused_selected_path", True)):
        run25, mfi = fused_runs[name], tier_index[name]

        def selected_of(p, d, run25=run25):
            names = set(p.sample_names.get(d, []))
            return [k for k, nm in enumerate(
                run25["shards"][d].meta["sample_names"]) if nm in names]
        layout = mfi.layout
        tier_reqs = [(spec, ds, p) for spec, ds, p in run25["specs"]
                     if len(ds) >= 2 and not (with_planes and any(
                         c in "Nn" for c in (p.reference_bases or "")))]
        top = sorted(((v, k) for k, v in run25["shapes"].items()
                      if k[0] != "ring" and k[2] == with_planes),
                     reverse=True)
        # match-only: every slot count phase 25 launched; with planes its
        # two most launched
        for n_launch, (slots, _lay, _pl) in (top[:2] if with_planes
                                              else top):
            per_req = max(1, -(-len(run25["order"]) // mfi.n_dev))
            k_req = max(1, slots // per_req)
            sets = []
            for i in range(16 if slots <= 8 else 4):
                reqs = tier_reqs[(i * k_req) % len(tier_reqs):][:k_req]
                specs, sids, masks, cnt = [], [], [], []
                for spec, ds, p in reqs:
                    for d in ds:
                        specs.append(spec)
                        sids.append(run25["order"].index(d))
                        if with_planes:
                            masks.append(np.full(mfi.plane_words, 0xFFFFFFFF,
                                                 np.uint32)
                                         if not p.selected_samples_only else
                                         pk.sample_mask_words(
                                             selected_of(p, d),
                                             mfi.plane_words))
                            cnt.append(p.selected_samples_only)
                sets.append((specs, sids,
                             np.stack(masks) if with_planes else None,
                             np.array(cnt, np.bool_) if with_planes else None))
            t = time_mesh_fused(mfi, sets, layout, 2048, 1024, with_planes,
                                parent=parent)
            ftimings.append({
                "path": name, "planes": with_planes, "layout": layout,
                "phase25_slots": slots, "phase25_launches": n_launch, **t,
                "bound_share": t["bound_ms"] / t["ms"]})
    busy = {name: sum(t["ms"] * t["phase25_launches"] for t in ftimings
                      if t["path"] == name) for name in fused_runs}
    parent_busy = ({"busy_ms_parent": {
        name: sum(t["parent_ms"] * t["phase25_launches"] for t in ftimings
                  if t["path"] == name) for name in fused_runs}}
        if parent is not None else {})
    emit("timing", kernel=tm.FUSED_KERNEL, library_ms=None,
         library_note="no single PyTorch call computes this function",
         cases=ftimings, busy_ms=busy, **parent_busy,
         busy_share_est={k: v / (fused_runs[k]["wall"] * 1e3)
                         for k, v in busy.items()},
         device=kind, nvidia_smi=smi)
    rtimings = []
    ring25 = sorted((v, k[1]) for k, v in
                    fused_runs["mesh_fused_selected_path"]["shapes"].items()
                    if k[0] == "ring")
    # phase 24's block shapes, and phase 25's most launched one
    ring_shapes = [(512, 1024), (512, 3 * 1024 + w_p)] + [
        (1, words) for _n, words in ring25[-1:]]
    for shape in ring_shapes:
        for form in RING_STEP_FORMS:
            (ms, warm_ms, plain_ms, bound_ms, nbytes, lib_ms,
             lib_warm_ms) = time_ring_step(shape, device, form)
            rtimings.append({"shape": list(shape), "form": form,
                             "last_step": form != "next",
                             "ms": ms, "warm_ms": warm_ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": "bytes", "bound_share": bound_ms / ms,
                             "bytes": nbytes, "library_ms": lib_ms,
                             "library_warm_ms": lib_warm_ms})
    # every launch of phase 25's two-entry ring is a first step (out of
    # place, no next) on its most launched block
    p1 = next(t for t in reversed(rtimings) if t["form"] == "first")
    pair = time_ring_pair(ring_shapes[-1], device)
    check(pair["equal"] and pair["launches"] == 2,
          "ring_gather on two entries: the sum in 2 launches")
    emit("timing", kernel=tg.KERNEL, library_ms=p1["library_ms"],
         library_note="one ring step on one card is acc.add_(src), plus "
                      "nxt.copy_(src) before the last step (two calls "
                      "there), and torch.add(own, src, out=acc) for the "
                      "first step out of place; each case carries its own "
                      "library_ms",
         cases=rtimings, ring_of_two=pair, device=kind, nvidia_smi=smi)
    del tier_index
    j6 = max((t for t in ftimings), key=lambda t: t["phase25_launches"])

    # which kernels one call of each wrapper runs
    profiled_kernels()

    # the main path's most-launched tier stands for the scatter kernel;
    # the median fused batch of brackets for the bisection kernel; the
    # selected path's most-launched shape for the two plane kernels
    top = max(timings, key=lambda t: (t["main_path_launches"], -t["C"]))
    top64 = top["main_path_shape"]
    mid = next(t for t in btimings
               if t["queries"] == percentile(batch_sizes, 0.5)
               and t["kind"] == "bracket")
    print(json.dumps({"kernels": [{
        "name": sk.KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/scatter_match.cu",
        "replaces": "sbeacon_tpu/ops/scatter_kernel.py:217",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": top64["ms"],
        "plain_ms": top64["plain_ms"],
        "bound_ms": top64["bound_ms"],
        "bound_by": top64["bound_by"],
        "library_ms": None,
        "tier": {"C": top["C"], "exact_only": top["exact_only"],
                 "slots": top64["slots"], "real_slots": top64["real_slots"]},
    }, {
        "name": tk.KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/bisect_query.cu",
        "replaces": "sbeacon_tpu/ops/kernel.py:502",
        "launches": bisect_launches,
        "max_abs_err": bisect_err,
        "ms": mid["ms_flushed"],
        "plain_ms": mid["plain_ms"],
        "bound_ms": mid["bound_ms"],
        "bound_by": mid["bound_by"],
        "library_ms": None,
        "batch": {"queries": mid["queries"], "kind": mid["kind"]},
        "l0": {k: l0[k] for k in (
            "launches", "max_abs_err", "ms", "warm_ms", "plain_ms",
            "bound_ms", "bound_by", "queries", "window", "padded_shards")},
    }, {
        "name": sk.SELECTED_KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/scatter_selected.cu",
        "replaces": "sbeacon_tpu/ops/scatter_kernel.py:454",
        "launches": counts[sk.SELECTED_KERNEL],
        "max_abs_err": sel_err,
        "ms": j2["ms"],
        "plain_ms": j2["plain_ms"],
        "bound_ms": j2["bound_ms"],
        "bound_by": j2["bound_by"],
        "library_ms": None,
        "case": {k: j2[k] for k in ("C", "slots", "exact_only",
                                    "with_counts")},
    }, {
        "name": pk.KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/plane_stats.cu",
        "replaces": "sbeacon_tpu/ops/plane_kernel.py:164",
        "launches": counts[pk.KERNEL],
        "max_abs_err": ps_err,
        "ms": j4["ms"],
        "plain_ms": j4["plain_ms"],
        "bound_ms": j4["bound_ms"],
        "bound_by": j4["bound_by"],
        "library_ms": None,
        "case": {k: j4[k] for k in ("rows", "with_counts", "with_or")},
    }, {
        "name": dc.KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/distinct_count.cu",
        "replaces": "sbeacon_tpu/parallel/distinct.py:126",
        "launches": dc_launches,
        "max_abs_err": dc_err,
        "ms": dms,
        "plain_ms": dplain,
        "bound_ms": dbound,
        "bound_by": dby,
        "library_ms": dlib,
        "case": {"keys": value_keys},
        "mesh": distinct_mesh,
    }, {
        "name": tm.QUERY_KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/stacked_query.cu",
        "replaces": "sbeacon_tpu/parallel/mesh.py:309",
        "launches": mq_counts[tm.QUERY_KERNEL],
        "max_abs_err": err_q,
        "ms": j7q["ms"],
        "plain_ms": j7q["plain_ms"],
        "bound_ms": j7q["bound_ms"],
        "bound_by": j7q["bound_by"],
        "library_ms": None,
        "case": {k: j7q[k] for k in ("datasets", "queries")},
    }, {
        "name": tm.SELECTED_KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/stacked_selected.cu",
        "replaces": "sbeacon_tpu/parallel/mesh.py:460",
        "launches": ms_counts[tm.SELECTED_KERNEL],
        "max_abs_err": err_s,
        "ms": j7s["ms"],
        "plain_ms": j7s["plain_ms"],
        "bound_ms": j7s["bound_ms"],
        "bound_by": j7s["bound_by"],
        "library_ms": None,
        "case": {k: j7s[k] for k in ("dataset", "queries", "with_counts")},
    }, {
        "name": tm.FUSED_KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/mesh_fused.cu",
        "replaces": "sbeacon_tpu/parallel/mesh.py:1401",
        "launches": sum(r["counts"][tm.FUSED_KERNEL]
                        for r in fused_runs.values()),
        "max_abs_err": err_f,
        "ms": j6["ms"],
        "plain_ms": j6["plain_ms"],
        "bound_ms": j6["bound_ms"],
        "bound_by": j6["bound_by"],
        "library_ms": None,
        "case": {k: j6[k] for k in ("path", "planes", "layout", "slots")},
    }, {
        "name": tg.KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/ring_gather.cu",
        "replaces": "sbeacon_tpu/ops/gather_kernel.py:70",
        "launches": sum(r["counts"][tg.KERNEL] for r in fused_runs.values()),
        "max_abs_err": err_r,
        "ms": p1["ms"],
        "plain_ms": p1["plain_ms"],
        "bound_ms": p1["bound_ms"],
        "bound_by": p1["bound_by"],
        "library_ms": p1["library_ms"],
        "case": {"shape": p1["shape"], "form": p1["form"]},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
