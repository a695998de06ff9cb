#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sbeacon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows 20000000] [--requests 384] [--threads 64]
                          [--seed 0]

Phases, each printing one JSON line (any failure raises and exits
non-zero, without the final line):

1. environment: the card, its power limit (nvidia-smi), torch and CUDA;
2. build: compiles every CUDA kernel of the path with nvcc for sm_90a;
3. kernel vs twin: every kernel, at the main path's shapes, against its
   plain-PyTorch twin on the same inputs on the card (integers: equal
   outputs, tolerance 0);
4. main path: a 1000-Genomes-shaped index (2e7 rows across chr1-22, no
   genotype planes) behind the port's VariantEngine, answering Beacon
   requests from many threads through parse_request ->
   run_variant_search -> Envelopes, each response checked against the
   host matcher; kernel launch counts are zeroed just before and read
   just after;
5. timing: each kernel tier with CUDA events, beside its bound (the
   least bytes and operations the launch's own inputs need) and its
   twin's time.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line as it prints
it, and as the last line ``{"ok": true, "device": {...}}``. The script
exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
# spin-kernel hold while timed launches are enqueued (about 100 ms at
# the H100's 1.98 GHz boost clock)
HOLD_CYCLES = 200_000_000
GENOME_BP = 2.875e9  # chr1-22, GRCh38
MICROBATCH_WAIT_MS = 2.0


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


def tier_specs(shard, rng, n, lo_rows, hi_rows, exact):
    """n QuerySpecs on random rows of ``shard`` whose windows span
    lo_rows..hi_rows rows; every spec hits its own row (exact ref/alt
    when ``exact``, else any-base, a variant type, or a typed alt)."""
    from sbeacon_tpu_torch.ops.kernel import QuerySpec

    pos = shard.cols["pos"]
    offs = shard.chrom_offsets
    out = []
    for _ in range(n):
        i = rng.randrange(shard.n_rows)
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
    return worst, report


def request_bodies(shard, rng, n, window_cap):
    """Beacon POST bodies in the BASELINE mix: SNV points with exact
    ref/alt picked to hit, start-end brackets spanning the tier caps,
    typed and any-base queries, and a few wider than window_cap."""
    pos = shard.cols["pos"]
    bodies = []
    for k in range(n):
        i = rng.randrange(shard.n_rows)
        p = int(pos[i])
        ref = shard.row_ref(i)
        rp = {"assemblyId": "GRCh38", "referenceName": shard.row_chrom(i)}
        r = rng.random()
        if r < 0.4:
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


def serve(rec, env, datasets, body):
    """One Beacon request through the port's API path; returns
    (envelope, ms, payload, responses)."""
    from sbeacon_tpu_torch.api.requests import parse_request
    from sbeacon_tpu_torch.api.variants import run_variant_search

    t0 = time.perf_counter()
    req = parse_request("POST", None, body)
    s_min, s_max, e_min, e_max = req.coordinates()
    agg = run_variant_search(
        rec, datasets, req, start_min=s_min, start_max=s_max,
        end_min=e_min, end_max=e_max,
    )
    doc = env.by_granularity(
        req.granularity, exists=agg.exists, count=len(agg.variants),
        results=agg.results[req.skip : req.skip + req.limit],
        set_type="genomicVariant", skip=req.skip, limit=req.limit,
    )
    ms = (time.perf_counter() - t0) * 1e3
    return (doc, ms) + rec.last.call


def expected_envelope(shard, env, body, payload):
    """The response and envelope the host matcher gives for one
    request."""
    from sbeacon_tpu_torch.api.requests import parse_request
    from sbeacon_tpu_torch.api.variants import VariantAggregation
    from sbeacon_tpu_torch.engine import host_match_rows, materialize_response
    from sbeacon_tpu_torch.ops.kernel import QuerySpec

    spec = QuerySpec(
        chrom=payload.reference_name, start_min=payload.start_min,
        start_max=payload.start_max, end_min=payload.end_min,
        end_max=payload.end_max, reference_bases=payload.reference_bases,
        alternate_bases=payload.alternate_bases,
        variant_type=payload.variant_type,
        variant_min_length=payload.variant_min_length,
        variant_max_length=payload.variant_max_length,
    )
    resp = materialize_response(
        shard, host_match_rows(shard, spec), payload,
        chrom_label=shard.meta["chrom_native"][payload.reference_name],
        dataset_id=shard.meta["dataset_id"],
        vcf_location=shard.meta["vcf_location"],
    )
    req = parse_request("POST", None, body)
    agg = VariantAggregation(req.assembly_id or "")
    agg.add([resp], granularity=req.granularity,
            check_all=req.include_resultset_responses in ("HIT", "ALL"))
    doc = env.by_granularity(
        req.granularity, exists=agg.exists, count=len(agg.variants),
        results=agg.results[req.skip : req.skip + req.limit],
        set_type="genomicVariant", skip=req.skip, limit=req.limit,
    )
    return resp, doc


def run_main_path(engine, env, shard, bodies, threads):
    """Serve every body from ``threads`` threads; returns ([(envelope,
    ms, payload, responses)], wall s)."""
    rec = RecordingEngine(engine)
    datasets = [{"id": shard.meta["dataset_id"]}]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        out = list(pool.map(lambda b: serve(rec, env, datasets, b), bodies))
    return out, time.perf_counter() - t0


def percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def device_ms(fn, items, reps):
    """Device ms per call of ``fn`` over ``items``. A spin kernel holds
    the stream while the host enqueues every call, so the events time
    the device's back-to-back execution rather than the host's launch
    rate; a check fails if the enqueue outlasted the hold."""
    import torch

    for it in items:  # warm-up (allocator, first launch)
        fn(it)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    stop.record()
    torch.cuda.synchronize()
    hold_ms = start.elapsed_time(stop)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        for it in items:
            fn(it)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    check(enqueue_ms < hold_ms, f"enqueue {enqueue_ms:.1f} ms outlasted the "
          f"{hold_ms:.1f} ms hold: the timing would be host-bound")
    return start.elapsed_time(stop) / (reps * len(items))


def needed_bytes(index, ids, q8, masks, C, cap):
    """(bytes, window lanes) one launch needs at the least: the sectors
    of the six packed rows the predicates read, over the distinct window
    lanes of all its slots; the AN sector of each record's first matched
    lane (the kernel's rule, taken from its masks); the slot inputs read
    once and the outputs written once. Lanes outside a slot's window
    need no input."""
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

    io = b * (4 + 32) + b * (32 + span // 16 * 4)
    nbytes = (row_groups * ROWS_PER_LANE + an_groups) * SECTOR_BYTES + io
    return nbytes, int(win.sum())


def time_kernel(index, device, rng, C, cap, r_lo, r_hi, exact, n_sets=16):
    """(kernel ms, twin ms, bound ms, bound_by, bytes) per launch of one
    tier at NSLOTS slots. The launches cycle over ``n_sets`` distinct
    random query sets so the gathered tiles (>= 8 MB a set) do not stay
    in the 50 MB L2, as for random serving traffic."""
    from sbeacon_tpu_torch.ops import scatter_kernel as sk

    T = index.tile
    sets = [
        kernel_inputs(
            index, tier_specs(index.shard, rng, NSLOTS, r_lo, r_hi, exact),
            device,
        )
        for _ in range(n_sets)
    ]
    ms = device_ms(
        lambda s: sk.scatter_match(
            index.tiles, s[0], s[1], T=T, CAP=cap, C=C, exact_only=exact
        ),
        sets, reps=4,
    )
    plain_ms = device_ms(
        lambda s: sk.scatter_core_reference(
            index.tiles, s[0], s[1], T=T, CAP=cap, C=C, exact_only=exact,
            seg_k=sk._static_seg_k(index),
        ),
        sets[:4], reps=1,
    )

    need = []
    for ids, q8 in sets:
        _agg, masks, _seq = sk.scatter_match(
            index.tiles, ids, q8, T=T, CAP=cap, C=C, exact_only=exact
        )
        need.append(needed_bytes(index, ids, q8, masks, C, cap))
    nbytes = float(np.mean([n for n, _l in need]))
    lanes = float(np.mean([l for _n, l in need]))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = lanes * MATCH_OPS_PER_LANE / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return ms, plain_ms, bound_ms, "bytes" if bytes_ms >= ops_ms else "operations", nbytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--requests", type=int, default=384)
    ap.add_argument("--threads", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
    from sbeacon_tpu_torch.index.columnar import build_index
    from sbeacon_tpu_torch.ops import _build
    from sbeacon_tpu_torch.ops import scatter_kernel as sk
    from sbeacon_tpu_torch.payloads import VariantSearchResponse
    from sbeacon_tpu_torch.testing import synthetic_shard

    rng = random.Random(args.seed)

    # 1. environment
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("environment", device=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build every kernel of the path
    t0 = time.perf_counter()
    lib = _build.load(sk.KERNEL)
    info = _build.build_log.get(sk.KERNEL, {})
    emit("build", kernel=sk.KERNEL, seconds=time.perf_counter() - t0,
         nvcc_seconds=info.get("seconds"), flags=" ".join(_build.NVCC_FLAGS),
         library=lib._name, ptxas=info.get("ptxas", "")[-1500:])

    # the 1000-Genomes-shaped corpus and the engine that serves it
    t0 = time.perf_counter()
    shard = synthetic_shard(args.rows, seed=args.seed, dataset_id="g1k")
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    # defaults (window_cap 2048, record_cap 1024, micro-batcher on),
    # the leader holding a batch open 2 ms for followers
    engine = VariantEngine(
        BeaconConfig(engine=EngineConfig(microbatch_wait_ms=MICROBATCH_WAIT_MS)),
        device=device,
    )
    engine.add_index(shard)
    t_index = time.perf_counter() - t0
    (_ds, _vcf, (_s, index)), = list(engine.indexes_for([]))
    emit("setup", rows=shard.n_rows, records=shard.meta["n_records"],
         chroms="1-22", genotype_planes=False, generate_s=t_gen,
         pack_upload_s=t_index, index_bytes=index.nbytes(),
         seg_k=index.seg_k, window_cap=engine.config.engine.window_cap,
         record_cap=engine.config.engine.record_cap,
         microbatch=engine.config.engine.microbatch,
         microbatch_wait_ms=engine.config.engine.microbatch_wait_ms)

    try:
        # 3. kernel vs twin at the main path's shapes, and on a crafted
        # shard (12-alt records -> scan form, clamped row, straddlers)
        err_big, rep_big = compare_kernel(index, device, rng, NSLOTS, "g1k")
        crafted = sk.ScatterDeviceIndex(
            build_index(crafted_records(), dataset_id="crafted"), device
        )
        check(crafted.seg_k > sk.SEG_K_MAX, "crafted shard lacks long records")
        err_cr, rep_cr = compare_kernel(crafted, device, rng, 256, "crafted")
        max_err = max(err_big, err_cr)
        emit("kernel_vs_twin", kernel=sk.KERNEL, tolerance=0,
             max_abs_err=max_err, cases=len(rep_big) + len(rep_cr),
             all_equal=all(r["equal"] for r in rep_big + rep_cr),
             crafted_seg_k=crafted.seg_k, report=rep_big + rep_cr)
        del crafted

        # 4. the main path
        env = Envelopes(engine.config.info)
        bodies = request_bodies(
            shard, rng, args.requests, engine.config.engine.window_cap
        )
        fallbacks0 = engine.host_fallbacks
        telemetry.reset_launch_counts()
        served, wall = run_main_path(engine, env, shard, bodies, args.threads)
        launches = telemetry.launch_count(sk.KERNEL)
        by_tier: dict = {}
        for r in telemetry.recent_launches():
            if r["kernel"] == sk.KERNEL:
                key = (r["C"], r["exact_only"])
                by_tier[key] = by_tier.get(key, 0) + 1
        fallbacks = engine.host_fallbacks - fallbacks0
        occ = engine.batcher.occupancy()
        stages = engine.stage_timing()
        lat = [ms for _d, ms, _p, _r in served]

        n_hit = mismatches = 0
        for body, (doc, _ms, payload, responses) in zip(bodies, served):
            want_resp, want_doc = expected_envelope(shard, env, body, payload)
            check(len(responses) == 1
                  and isinstance(responses[0], VariantSearchResponse),
                  "one response per request")
            ok = (dataclasses.asdict(responses[0])
                  == dataclasses.asdict(want_resp)
                  and json.dumps(doc, sort_keys=True)
                  == json.dumps(want_doc, sort_keys=True))
            mismatches += not ok
            n_hit += bool(want_resp.exists)
        check(mismatches == 0, f"{mismatches} responses differ from the host matcher")
        check(launches > 0, "the main path launched the scatter match kernel")
        check(launches < len(bodies),
              "launches below the request count (requests coalesced)")
        check(fallbacks > 0, "wide requests took the host path")
        emit("main_path", requests=len(bodies), threads=args.threads,
             hits=n_hit, mismatches=mismatches,
             scatter_match_launches=launches,
             launches_per_request=launches / len(bodies),
             launches_by_tier={f"C{c}_{'exact' if e else 'any'}": n
                               for (c, e), n in sorted(by_tier.items())},
             batcher=occ, host_fallbacks=fallbacks, wall_s=wall,
             requests_per_s=len(bodies) / wall,
             latency_ms={"p50": percentile(lat, 0.5),
                         "p99": percentile(lat, 0.99)},
             stage_ms=stages, device=kind, nvidia_smi=smi)

        # 5. kernel timing at the 2e7-row shape, every tier
        timings = []
        for C, cap, r_lo, r_hi in tiers(index.tile):
            for exact in (True, False):
                ms, plain_ms, bound_ms, bound_by, nbytes = time_kernel(
                    index, device, rng, C, cap, r_lo, r_hi, exact
                )
                timings.append(
                    {"C": C, "cap": cap, "exact_only": exact,
                     "slots": NSLOTS, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / ms, "bytes": nbytes,
                     "main_path_launches": by_tier.get((C, exact), 0)}
                )
        # upper estimate of the card's busy share in the main path:
        # its launches at the full-batch per-launch time of their tier
        busy_ms = sum(t["ms"] * t["main_path_launches"] for t in timings)
        emit("timing", kernel=sk.KERNEL, library_ms=None,
             main_path_kernel_ms_upper=busy_ms,
             main_path_busy_share_upper=busy_ms / (wall * 1e3),
             library_note="no single PyTorch call computes this function",
             tiers=timings, device=kind, nvidia_smi=smi)
    finally:
        engine.close()

    # the main path's most-launched tier stands for the kernel
    top = max(timings, key=lambda t: (t["main_path_launches"], -t["C"]))
    print(json.dumps({"kernels": [{
        "name": sk.KERNEL,
        "route": "cuda",
        "source": "sbeacon_tpu_torch/csrc/scatter_match.cu",
        "replaces": "sbeacon_tpu/ops/scatter_kernel.py:217",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "tier": {"C": top["C"], "exact_only": top["exact_only"],
                 "slots": NSLOTS},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
