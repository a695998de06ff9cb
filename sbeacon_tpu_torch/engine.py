"""VariantEngine: the query orchestrator.

Counterpart of ``sbeacon_tpu/engine.py``. ``_blob_eq``,
``host_match_rows``, ``shard_regions`` and ``materialize_response``
(with their numpy helpers) are copies of the JAX package's. ``search``
answers from the response cache (``response_cache.ResponseCache``, on by
default as in the JAX package) when it can, else ``_search`` serves one
response per (dataset, vcf) target through these device legs:

- single dataset: ``_search`` -> ``_device_rows`` -> the micro-batcher
  -> ``run_queries_auto`` -> the scatter match kernel ->
  ``materialize_response``;
- several datasets on a mesh of two or more devices (``use_mesh``,
  the JAX engine's gate): ``_search`` -> ``_mesh_ready`` (the
  ``parallel.mesh.StackedIndex`` over every loaded base shard, built on
  the request path and cached until a base publish) -> ``_mesh_search``
  -> ONE ``sharded_query`` per request, the stacked query kernel on
  each mesh device; a selected-samples request on a stack with planes
  takes ``sharded_selected_query``, the stacked selected kernel with
  its plane reduction, and materialises through
  ``materialize_response(fused=)``. The mesh lists every visible CUDA
  device (``parallel.mesh.mesh_devices``), so one card keeps serving
  through the fused stack;
- several datasets otherwise (``fused_dispatch``): ``_search`` ->
  ``_fused_multi_rows`` -> ONE micro-batcher submission against the
  ``FusedDeviceIndex`` stacked over every base shard -> the bisection
  query kernel; the stack is built off the request path once two or
  more shards are loaded, and until it is ready each dataset takes its
  own scatter launch (the thread-scatter leg);
- requests that read genotype planes (the selected-samples leaf, and
  sample-hit extraction on record/aggregated granularity) on a shard
  whose planes are on the device (``device_planes``): ``_one_target`` ->
  ``_fused_selected`` -> ``run_selected_scattered`` -> the fused
  match + planes kernel, one launch that hands ``materialize_response``
  its rows, per-row popcounts and sample-hit words. When that query
  overflows, or its ref has an N wildcard, its rows come from the split
  path and ``materialize_response(plane_index=)`` reads the planes with
  the plane-stats kernel;
- the delta tail of continuous ingest (``add_delta``): each delta shard
  serves under a ``vcf#d<epoch>`` label beside its base. Past the
  ``l0_min_shards`` / ``l0_min_rows`` threshold a key's tail stacks
  into its own ``L0DeviceIndex`` block, and the blocks of every covered
  key join into one ``CompositeL0DeviceIndex``: ``l0_pre_rows`` answers
  every covered tail target of a request with ONE bisection-query
  launch (the ``fused_l0`` family) through the micro-batcher; the tail
  below the threshold is matched on the host, as in the JAX package.
  A delta publish leaves the base stacks warm and the base fingerprint
  unchanged, and evicts only the cached answers whose dataset and
  region overlap its rows.

A query whose window exceeds ``window_cap`` or whose matches exceed
``record_cap`` falls back to ``host_match_rows``, a vectorised numpy
twin of the kernels with no caps and byte-exact allele comparison.

A failed mesh build, upload or launch raises on the request, where the
JAX engine logs it and falls back to thread scatter; a dataset that
arrived after the stack was built is served by the other legs. A failed
L0 block build or composite raises on the publish that triggered it and
on every request with delta-tail targets until a rebuild succeeds, and a
failed L0 launch raises on its request, where the JAX engine logs them
and walks the tail on the host.

The hooks the JAX engine calls on every request are here too: request
annotations (``telemetry.annotate``), cost charges (host rows walked,
delta shards walked on the host), ``plan_stage`` entries (``cache``,
``split``), the ``engine.search`` span, and ``register_metrics``.
``warmup`` builds every kernel and launches each kernel family once
against each loaded index (the JAX engine compiles its shape ladder).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .config import BeaconConfig
from .harness.faults import fault_point
from .index.columnar import FLAG, VariantIndexShard
from .ops import (
    CompositeL0DeviceIndex,
    FusedDeviceIndex,
    L0DeviceIndex,
    make_device_index,
    resolve_device,
    run_queries_auto,
)
from .ops.kernel import QuerySpec, encode_queries
from .ops.plane_kernel import (
    PlaneDeviceIndex,
    plane_row_stats,
    sample_mask_words,
)
from .ops.scatter_kernel import run_selected_scattered
from .parallel import mesh as _mesh
from .payloads import VariantQueryPayload, VariantSearchResponse
from .plan import plan_stage
from .response_cache import (
    ResponseCache,
    register_cache_metrics,
    response_cache_key,
    response_cache_scope,
)
from .telemetry import (
    DEFAULT_MAX_LABEL_VALUES,
    OVERFLOW_LABEL,
    annotate,
    charge_cost,
    current_context,
    device_warmup_phase,
    percentiles,
    publish_event,
    request_context,
)
from .utils.chrom import CODE_TO_CHROMOSOME, chromosome_code
from .utils.trace import span

# uppercase LUT for vectorised case-insensitive byte compares
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[97:123] -= 32


def _blob_eq(
    blob: np.ndarray,
    off: np.ndarray,
    idx: np.ndarray,
    lens: np.ndarray,
    want: bytes,
    *,
    upper: bool,
    prefix: bool = False,
    wildcard_n: bool = False,
) -> np.ndarray:
    """Vectorised per-row compare of blob slices against one query string.

    Equality mode: row bytes (uppercased when ``upper``) == want.
    Prefix mode: row starts with ``want``.
    Wildcard mode: an 'N' in ``want`` accepts any of A/C/G/T/N at that
    position (the selected-samples ref regex, reference
    search_variants_in_samples.py:87-91).
    No per-row Python: rows are first narrowed by length, then compared as a
    2D fixed-width gather.
    """
    wlen = len(want)
    out = np.zeros(len(idx), dtype=bool)
    cand = lens >= wlen if prefix else lens == wlen
    if not cand.any() or wlen == 0:
        if wlen == 0:
            out[:] = True if prefix else lens == 0
        return out
    rows = idx[cand]
    starts = off[rows].astype(np.int64)
    mat = blob[starts[:, None] + np.arange(wlen)]
    if upper:
        mat = _UPPER[mat]
    wanted = np.frombuffer(want, dtype=np.uint8)
    eq = mat == wanted
    if wildcard_n:
        acgtn = np.isin(mat, np.frombuffer(b"ACGTN", dtype=np.uint8))
        eq |= (wanted == ord("N")) & acgtn
    out[cand] = eq.all(axis=1)
    return out


def host_match_rows(
    shard: VariantIndexShard, q: QuerySpec, *, ref_wildcard: bool = False
) -> np.ndarray:
    """All matching row ids, numpy-vectorised, no caps, byte-exact alleles.

    ``ref_wildcard`` switches the ref compare to the selected-samples
    N-wildcard semantics."""
    c = shard.cols
    code = chromosome_code(q.chrom)
    lo = int(shard.chrom_offsets[code])
    hi = int(shard.chrom_offsets[code + 1])
    if lo == hi:
        return np.empty(0, dtype=np.int64)
    pos = c["pos"][lo:hi]
    a = int(np.searchsorted(pos, q.start_min, side="left"))
    b = int(np.searchsorted(pos, q.start_max, side="right"))
    if a >= b:
        return np.empty(0, dtype=np.int64)
    # the candidate bracket is exactly the rows this scan walks: charged
    # to the ambient request's cost vector
    charge_cost(host_rows=b - a)
    sl = slice(lo + a, lo + b)
    idx = np.arange(lo + a, lo + b)

    rec_end = c["rec_end"][sl]
    ok = (q.end_min <= rec_end) & (rec_end <= q.end_max)

    if q.reference_bases is not None and q.reference_bases != "N":
        ok &= _blob_eq(
            shard.ref_blob,
            shard.ref_off,
            idx,
            c["ref_len"][sl],
            q.reference_bases.encode(),
            upper=True,
            wildcard_n=ref_wildcard,
        )

    alt_len = c["alt_len"][sl]
    max_len = 2**31 - 1 if q.variant_max_length < 0 else q.variant_max_length
    ok &= (q.variant_min_length <= alt_len) & (alt_len <= max_len)

    flags = c["flags"][sl]
    f = lambda bit: (flags & bit) != 0
    if q.alternate_bases is None:
        sym = f(FLAG.SYMBOLIC)
        k = c["ref_repeat_k"][sl]
        ref_len = c["ref_len"][sl]
        vt = q.variant_type
        # '<' + str(vt): None formats to '<None' and matches nothing
        # (reference performQuery/search_variants.py:54)
        vpref = ("<" + str(vt)).encode()
        pm = _blob_eq(
            shard.alt_blob,
            shard.alt_off,
            idx,
            alt_len,
            vpref,
            upper=False,
            prefix=True,
        )
        if vt == "DEL":
            alt_ok = np.where(sym, pm | f(FLAG.CN0), alt_len < ref_len)
        elif vt == "INS":
            alt_ok = np.where(sym, pm, alt_len > ref_len)
        elif vt == "DUP":
            alt_ok = np.where(
                sym, pm | (f(FLAG.CN_PREFIX) & ~f(FLAG.CN0) & ~f(FLAG.CN1)), k >= 2
            )
        elif vt == "DUP:TANDEM":
            alt_ok = np.where(sym, pm | f(FLAG.CN2), k == 2)
        elif vt == "CNV":
            alt_ok = np.where(
                sym,
                pm | f(FLAG.CN_PREFIX) | f(FLAG.DEL_PREFIX) | f(FLAG.DUP_PREFIX),
                f(FLAG.DOT) | (k >= 1),
            )
        else:
            alt_ok = sym & pm
        ok &= alt_ok.astype(bool)
    elif q.alternate_bases == "N":
        ok &= f(FLAG.SINGLE_BASE)
    else:
        ok &= _blob_eq(
            shard.alt_blob,
            shard.alt_off,
            idx,
            alt_len,
            q.alternate_bases.encode(),
            upper=True,
        )
    return idx[ok]


def shard_regions(shard: VariantIndexShard) -> list[tuple[str, int, int]]:
    """Per-chromosome coordinate envelope ``[(chrom, lo, hi), ...]`` of
    a shard's rows: the scope a delta publish invalidates the response
    cache with. ``hi`` covers both start positions and record ends, so
    any query bracket that could match a row overlaps its envelope."""
    out: list[tuple[str, int, int]] = []
    off = shard.chrom_offsets
    pos = shard.cols["pos"]
    rec_end = shard.cols["rec_end"]
    for code in range(len(off) - 1):
        lo, hi = int(off[code]), int(off[code + 1])
        if lo == hi:
            continue
        chrom = CODE_TO_CHROMOSOME.get(code, "")
        out.append(
            (
                chrom,
                int(pos[lo:hi].min()),
                int(max(pos[lo:hi].max(), rec_end[lo:hi].max())),
            )
        )
    return out


def _popcounts(words: np.ndarray, mask: np.ndarray | None) -> np.ndarray:
    """Per-row popcount of (words & mask): [k, w] uint32 -> [k] int64."""
    if mask is not None:
        words = words & mask
    return np.bitwise_count(words).sum(axis=1, dtype=np.int64)


def _overflow_extras(
    shard: VariantIndexShard,
    which: str,
    target_rows: np.ndarray,
    sel_mask: np.ndarray,
) -> np.ndarray:
    """[len(target_rows)] extra copies beyond the 2-bit planes for the
    given rows, restricted to selected samples (ploidy>2 side table)."""
    out = np.zeros(len(target_rows), dtype=np.int64)
    ov = shard.gt_overflow if which == "gt" else shard.tok_overflow
    if ov is None or not len(ov) or not len(target_rows):
        return out
    hit = np.isin(ov[:, 0], target_rows) & sel_mask[ov[:, 1]]
    if not hit.any():
        return out
    ov = ov[hit]
    order = np.argsort(target_rows, kind="stable")
    pos = order[np.searchsorted(target_rows[order], ov[:, 0])]
    np.add.at(out, pos, ov[:, 2] - 2)
    return out


def materialize_response(
    shard: VariantIndexShard,
    rows: np.ndarray,
    payload: VariantQueryPayload,
    *,
    chrom_label: str,
    dataset_id: str = "",
    vcf_location: str = "",
    selected_idx: list[int] | None = None,
    plane_index: PlaneDeviceIndex | None = None,
    fused=None,
) -> VariantSearchResponse:
    """Vectorised row-id materialisation (cumulative-order semantics).

    Same contract as the JAX package's ``materialize_response_loop``
    (the executable spec), computed without per-row Python: per-row call contributions in
    one ``np.bitwise_count`` pass, record grouping via ``reduceat``, the
    reference's cumulative truncation points (first record that flips
    ``exists``) from one cumsum, and sample-hit extraction as a single
    OR-reduction over the genotype plane slice. Matched-variant strings
    remain a comprehension over matched rows only — they ARE the response
    payload, so their count is already bounded by what the client asked
    to receive.

    ``plane_index`` (a ``PlaneDeviceIndex``) moves the plane reads to the
    device: per-row masked popcounts and the sample-hit OR run as one or
    two plane-stats kernel launches over the device planes. The
    truncation/AN/overflow semantics stay on the host, from the
    device-returned numbers, and are identical to the host path (the
    ploidy>2 overflow side tables are host-applied either way).

    ``fused`` short-circuits BOTH plane reads with what the fused
    match + planes kernel already computed in the match launch: a
    ``(pc_call, pc_tok, or_words)`` triple, pc_call/pc_tok per-row
    masked popcounts aligned with ``rows`` and or_words the sample-hit
    OR over the grp >= k0 subset. It takes precedence over
    ``plane_index``.
    """
    c = shard.cols
    rows = np.asarray(rows, dtype=np.int64)
    granularity = payload.requested_granularity
    include_details = payload.include_details

    n_words = shard.gt_bits.shape[1] if shard.gt_bits is not None else 0
    mask = None
    if selected_idx is not None and shard.gt_bits is not None:
        mask = sample_mask_words(selected_idx, n_words)
    count_planes = mask is not None and shard.has_count_planes
    n_samples = len(shard.meta.get("sample_names", []))
    sel_mask = np.zeros(max(n_samples, 1), dtype=bool)
    if selected_idx is not None:
        sel_mask[np.asarray(selected_idx, dtype=np.int64)] = True

    n = len(rows)
    if n == 0:
        return VariantSearchResponse(
            dataset_id=dataset_id,
            vcf_location=vcf_location,
            exists=False,
            all_alleles_count=0,
            call_count=0,
            variants=[],
            sample_indices=[],
            sample_names=[],
        )

    rec = c["rec_id"][rows]
    new_grp = np.empty(n, dtype=bool)
    new_grp[0] = True
    np.not_equal(rec[1:], rec[:-1], out=new_grp[1:])
    starts = np.flatnonzero(new_grp)  # index into rows of each record
    grp_of = np.cumsum(new_grp) - 1  # record-group index per row
    n_grp = len(starts)

    # per-row call contribution (the loop's rc)
    ac_rows = c["ac"][rows].astype(np.int64)
    rc = ac_rows.copy()
    r0 = rows[starts]
    gt_rows = (
        np.flatnonzero((c["flags"][rows] & FLAG.AC_INFO) == 0)
        if count_planes
        else np.zeros(0, np.int64)
    )
    tok_grps = (
        np.flatnonzero((c["flags"][r0] & FLAG.AN_INFO) == 0)
        if count_planes
        else np.zeros(0, np.int64)
    )
    dev_counts = None
    if (
        fused is None
        and plane_index is not None
        and plane_index.has_counts
        and (len(gt_rows) or len(tok_grps))
    ):
        # ONE device call covers both popcount target sets (matched
        # rows needing genotype-derived AC, record-first rows needing
        # token-derived AN)
        cat = np.concatenate([rows[gt_rows], r0[tok_grps]])
        dev_counts, _ = plane_row_stats(plane_index, cat, mask)
    if count_planes and len(gt_rows):
        rr = rows[gt_rows]
        extras = _overflow_extras(shard, "gt", rr, sel_mask)
        if fused is not None:
            rc[gt_rows] = fused[0][gt_rows].astype(np.int64) + extras
        elif dev_counts is not None:
            pc = dev_counts[: len(gt_rows)]
            rc[gt_rows] = pc[:, 0] + pc[:, 1] + extras
        else:
            rc[gt_rows] = (
                _popcounts(shard.gt_bits[rr], mask)
                + _popcounts(shard.gt_bits2[rr], mask)
                + extras
            )

    rc_grp = np.add.reduceat(rc, starts)
    cum = np.cumsum(rc_grp)
    exists = bool(cum[-1] > 0)
    k0 = int(np.argmax(cum > 0)) if exists else n_grp - 1

    # per-record AN (from each record's first row)
    an_grp = c["an"][r0].astype(np.int64)
    if count_planes and len(tok_grps):
        rr = r0[tok_grps]
        extras = _overflow_extras(shard, "tok", rr, sel_mask)
        if fused is not None:
            an_grp[tok_grps] = (
                fused[1][starts[tok_grps]].astype(np.int64) + extras
            )
        elif dev_counts is not None:
            tk = dev_counts[len(gt_rows) :]
            an_grp[tok_grps] = tk[:, 2] + tk[:, 3] + extras
        else:
            an_grp[tok_grps] = (
                _popcounts(shard.tok_bits1[rr], mask)
                + _popcounts(shard.tok_bits2[rr], mask)
                + extras
            )

    # cumulative truncation: which records the loop would process
    if not exists:
        last_grp = n_grp - 1  # all records; AN accumulates for each
        call_count = 0
        an_through = n_grp  # exclusive end
    elif not include_details:
        last_grp = k0
        call_count = int(cum[k0])
        an_through = k0  # breaks BEFORE adding record k0's AN
    elif granularity == "boolean":
        last_grp = k0
        call_count = int(cum[k0])
        an_through = k0 + 1  # boolean breaks AFTER the AN add
    else:
        last_grp = n_grp - 1
        call_count = int(cum[-1])
        an_through = n_grp
    all_alleles = int(an_grp[:an_through].sum())

    # matched-variant strings, row order, records <= last_grp only
    keep = (rc != 0) & (grp_of <= last_grp)
    vrows = rows[keep]
    pos_v = c["pos"][vrows]
    ro, re = shard.ref_off[vrows], shard.ref_off[vrows + 1]
    ao, ae = shard.alt_off[vrows], shard.alt_off[vrows + 1]
    vt = shard.vt_codes[vrows]
    vocab = shard.meta["vt_vocab"]
    rb, ab = shard.ref_blob, shard.alt_blob
    variants = [
        (
            f"{chrom_label}\t{pos_v[i]}"
            f"\t{rb[ro[i]:re[i]].tobytes().decode()}"
            f"\t{ab[ao[i]:ae[i]].tobytes().decode()}\t{vocab[vt[i]]}"
        )
        for i in range(len(vrows))
    ]

    # sample-hit extraction: all rows of records from k0 onward
    sample_indices: list[int] = []
    resolved: list[str] = []
    if (
        exists
        and include_details
        and granularity in ("record", "aggregated")
        and payload.include_samples
        and shard.gt_bits is not None
    ):
        srows = rows[grp_of >= k0]
        if fused is not None:
            # the fused kernel already OR-reduced the grp >= k0 subset in
            # the match launch (rc positivity, and so k0 and the subset,
            # does not depend on the ploidy extras)
            agg = np.asarray(fused[2], dtype=np.uint32)
            if mask is not None:
                agg = agg & mask
        elif plane_index is not None:
            # device OR over the exact grp >= k0 subset
            _cnts, agg = plane_row_stats(
                plane_index,
                srows,
                mask,
                or_sel=np.ones(len(srows), np.int32),
                with_counts=False,
            )
        else:
            agg = np.bitwise_or.reduce(shard.gt_bits[srows], axis=0)
            if mask is not None:
                agg = agg & mask
        bits = np.unpackbits(
            agg.view(np.uint8), bitorder="little"
        ).astype(bool)
        if selected_idx is not None:
            sample_indices = [
                k for k, si in enumerate(selected_idx) if bits[si]
            ]
        else:
            sample_indices = np.flatnonzero(bits).tolist()
    if (
        granularity in ("record", "aggregated")
        and payload.include_samples
        and shard.meta.get("sample_names")
    ):
        names = shard.meta["sample_names"]
        if selected_idx is not None:
            names = [names[si] for si in selected_idx]
        hit = set(sample_indices)
        resolved = [s for k, s in enumerate(names) if k in hit]

    return VariantSearchResponse(
        dataset_id=dataset_id,
        vcf_location=vcf_location,
        exists=exists,
        all_alleles_count=all_alleles,
        call_count=call_count,
        variants=variants,
        sample_indices=sorted(sample_indices),
        sample_names=resolved,
    )


def register_delta_metrics(registry, supplier) -> None:
    """The ingest-while-serving delta-tail series. ``supplier`` returns
    :meth:`VariantEngine.delta_metrics` (or ``{}``): the series exist
    as zeros on every engine so the catalogue stays stable."""

    def field(name):
        def collect():
            stats = supplier() or {}
            return stats.get(name, 0)

        return collect

    registry.counter(
        "ingest.delta_publishes",
        "delta shards published for immediate serving",
        fn=field("publishes"),
    )
    registry.gauge(
        "ingest.delta_shards",
        "delta shards currently standing (awaiting compaction)",
        fn=field("shards"),
    )
    registry.counter(
        "ingest.l0_builds",
        "delta-tail L0 index builds (tail stacked past the depth/row "
        "threshold)",
        fn=field("l0_builds"),
    )
    registry.counter(
        "ingest.l0_served_queries",
        "queries whose delta-tail targets rode the L0 index launch "
        "instead of per-shard host scans",
        fn=field("l0_served"),
    )
    # the engine bounds its own key set at DEFAULT_MAX_LABEL_VALUES
    # (overflow collapses to the sentinel)
    registry.counter(
        "ingest.l0_key_builds",
        "per-(dataset/vcf) L0 block stacks: a publish to one key "
        "rebuilds only that key's block",
        label="key",
        fn=field("l0_key_builds"),
    )
    registry.counter(
        "ingest.l0_block_reuses",
        "standing L0 blocks reused as-is by a composite rebuild "
        "(untouched keys are never restacked)",
        fn=field("l0_block_reuses"),
    )


class VariantEngine:
    """Holds device-resident indexes and answers variant queries.

    ``device`` defaults to the GPU; the constructor raises when no GPU
    is present unless the caller passes ``device="cpu"``, where every
    kernel runs its plain-PyTorch twin.
    """

    def __init__(self, config: BeaconConfig | None = None, device=None):
        self.config = config or BeaconConfig()
        eng = self.config.engine
        self.device = resolve_device(device)
        # (dataset_id, vcf_location) -> (shard, ScatterDeviceIndex,
        # PlaneDeviceIndex | None): the BASE shards
        self._indexes: dict[tuple[str, str], tuple] = {}
        self._lock = threading.Lock()
        # device bytes of plane uploads in flight, by reservation token:
        # the budget gate counts them with the resident planes
        self._plane_reserved: dict = {}
        if eng.microbatch:
            from .serving import MicroBatcher

            self._batcher = MicroBatcher(
                max_batch=eng.microbatch_max,
                max_wait_ms=eng.microbatch_wait_ms,
                default_timeout_s=self.config.resilience.batch_timeout_s,
                timing_window=eng.timing_window,
            )
        else:
            self._batcher = None
        # the response cache: repeated queries answer from host memory
        # with no device launch; keys embed per-dataset base
        # fingerprints and publishes invalidate, so a stale answer is
        # unreachable
        if eng.response_cache and eng.response_cache_size > 0:
            self._response_cache = ResponseCache(
                max_entries=eng.response_cache_size,
                ttl_s=eng.response_cache_ttl_s,
            )
        else:
            self._response_cache = None
        # host materialisation timing (the post-fetch stage)
        self._mat_lock = threading.Lock()
        self._mat_ms: deque = deque(maxlen=eng.timing_window)
        #: queries answered by host_match_rows after a device overflow
        self.host_fallbacks = 0
        # fused multi-dataset stack (FusedDeviceIndex over every loaded
        # base shard), rebuilt off the request path after each base
        # publish: _fused_state is (findex, key -> shard id, key ->
        # shard), or None while no stack serves; a build only publishes
        # if no add_index happened since its inputs were snapshotted
        self._fused_state = None
        self._fused_dirty = True
        self._fused_gen = 0
        #: the exception of a failed background build: multi-dataset
        #: requests raise it until the next publish
        self._fused_error: BaseException | None = None
        self._fused_builds: "weakref.WeakSet[threading.Thread]" = (
            weakref.WeakSet()
        )
        #: multi-dataset queries answered by one fused launch
        self.fused_searches = 0
        # dataset-sharded mesh stack (parallel.mesh.StackedIndex over
        # every loaded base shard), rebuilt on the request path after a
        # base publish: _mesh_state is (mesh, stacked, blocks, key ->
        # stack position, key -> shard, key -> planes), or None while no
        # mesh serves (use_mesh off, fewer than two mesh devices or
        # shards)
        self._mesh_lock = threading.Lock()
        self._mesh_state = None
        self._mesh_dirty = True
        #: the plane-budget gate's last verdict for the mesh stack
        self._plane_budget_verdict: dict | None = None
        #: multi-dataset queries answered by the mesh leg, and those of
        #: them that ran the stacked selected kernel
        self.mesh_searches = 0
        self.mesh_selected_searches = 0
        # persistent per-dataset scatter pool (no per-request threads)
        self._scatter = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="engine-scatter"
        )
        # the delta tail: base_key -> {epoch: shard}. A delta is a small
        # (dataset, vcf)-keyed shard with no device index of its own,
        # tagged with a per-key epoch. Deltas publish without touching
        # the stacks' dirty flags or the base fingerprint; a base
        # publish drops the epochs it folded. The registry, the serving
        # list and the fingerprints are rebound copy-on-write under
        # _lock, so the query path never iterates a dict being mutated.
        self._deltas: dict[tuple[str, str], dict[int, object]] = {}
        self._delta_seq: dict[tuple[str, str], int] = {}
        self.delta_publishes = 0
        # the L0 tier: a key whose tail passed the threshold keeps its
        # own standing L0DeviceIndex block (rebuilt only when that key's
        # tail changes); the published state's CompositeL0DeviceIndex
        # joins the blocks on the device. State tuple: (findex,
        # {serve_key: sid}, {serve_key: shard}, rows, built_at).
        self._l0_state: tuple | None = None
        # key -> (block, [(serve_key, shard), ...], built_at)
        self._l0_blocks: dict[tuple[str, str], tuple] = {}
        # publish generations: a build whose inputs predate any
        # delta/base publish must not publish over fresher state; a
        # publish to key B racing a rebuild bumps only B's key
        # generation, so the rebuild still adopts the other keys' blocks
        self._l0_gen = 0
        self._l0_key_gens: dict[tuple[str, str], int] = {}
        # per-key block builds ("dataset/vcf" labels, capped)
        self._l0_key_builds: dict[str, int] = {}
        self.l0_block_reuses = 0
        # (index class, padded rows, padded shards, window, record_cap)
        # shapes already launched once by _l0_warm
        self._l0_warmed: set = set()
        self.l0_builds = 0
        self.l0_searches = 0
        #: (generation, exception) of a failed L0 build: raised by every
        #: request with delta-tail targets until a rebuild succeeds
        self._l0_error: tuple | None = None
        # copy-on-write serving views (rebuilt at every publish): the
        # sorted serving list (base + delta), the base fingerprint, the
        # full fingerprint (base + tail) and the per-dataset components
        self._serve_list: list = []
        self._base_fingerprint = ""
        self._fingerprint = ""
        self._ds_fingerprints: dict[str, str] = {}
        self._ds_full_fingerprints: dict[str, str] = {}

    # -- index management ---------------------------------------------------

    def add_index(self, shard: VariantIndexShard) -> None:
        """Build the shard's device index and its device planes, then
        publish them as the key's BASE shard: initial ingest, re-ingest,
        or the fold of a delta tail (``meta['delta_epoch']`` = the
        highest folded epoch; absent means wholesale replacement, and
        every delta of the key dies with it). The base stacks go dirty,
        the key's L0 coverage is retired in the same critical section
        that drops the folded epochs, and the cache is invalidated for
        the dataset. A device failure (index build or plane upload)
        raises: serving never moves to the host on its own. Only the
        plane budget keeps a plane set on the host."""
        key = (
            shard.meta.get("dataset_id", ""),
            shard.meta.get("vcf_location", ""),
        )
        dindex = make_device_index(shard, self.device)
        planes = self._build_planes(key, shard)
        with self._lock:
            # epochs stay monotonic past what a base folded
            baked = shard.meta.get("delta_epoch") or 0
            if baked > self._delta_seq.get(key, 0):
                self._delta_seq[key] = baked
            tail = self._deltas.get(key)
            if tail:
                folded = shard.meta.get("delta_epoch")
                kept = (
                    {}
                    if folded is None
                    else {e: s for e, s in tail.items() if e > folded}
                )
                deltas = dict(self._deltas)
                if kept:
                    deltas[key] = kept
                else:
                    deltas.pop(key, None)
                self._deltas = deltas
            self._l0_touch_key_locked(key)
            self._retire_l0_key_locked(key)
            self._publish_locked(key, (shard, dindex, planes))
            # the upload's reservation turns into residency in the same
            # critical section: never counted twice, never nowhere
            self._plane_reserved.pop(
                getattr(planes, "_hbm_reservation", None), None
            )
        # the per-dataset fingerprint component in every cache key makes
        # this dataset's old entries unreachable; the scoped
        # invalidation frees them without dropping other datasets'
        self._invalidate_cache(key[0], None)

    def _publish_locked(self, key, triple) -> None:
        """Publish ``triple`` as ``key``'s base under ``_lock`` and
        rebuild the serving views; the fused and mesh stacks no longer
        cover this shard snapshot."""
        self._indexes[key] = triple
        self._fused_dirty = True
        self._fused_gen += 1
        self._mesh_dirty = True
        self._rebuild_serving_state_locked()

    def _rebuild_serving_state_locked(self) -> None:
        """Recompute the serving list and the fingerprint views under
        ``_lock``: the base fingerprint (base shards only, the staleness
        signal of the fused and mesh stacks and the pod tier, stable
        across delta publishes), the per-dataset base components
        (response-cache keys) and the full fingerprint (base + tail).
        Each is rebound as a fresh object, so lock-free readers never
        see a half-built one."""
        serve: list = []
        base_parts: list[str] = []
        ds_fp: dict[str, str] = {}
        for (ds, vcf), (s, d, p) in sorted(self._indexes.items()):
            comp = (
                f"{vcf}|{s.meta.get('variant_count')}"
                f"|{s.meta.get('call_count')}|{s.n_rows}"
            )
            base_parts.append(f"{ds}|{comp}")
            ds_fp[ds] = f"{ds_fp[ds]}&{comp}" if ds in ds_fp else comp
            serve.append((ds, vcf, (s, d, p)))
        ds_full = dict(ds_fp)
        delta_parts: list[str] = []
        for (ds, vcf), tail in sorted(self._deltas.items()):
            for epoch, s in sorted(tail.items()):
                serve.append((ds, f"{vcf}#d{epoch}", (s, None, None)))
                delta_parts.append(f"{ds}|{vcf}#d{epoch}|{s.n_rows}")
                part = f"{vcf}#d{epoch}|{s.n_rows}"
                ds_full[ds] = (
                    f"{ds_full[ds]}&{part}" if ds in ds_full else part
                )
        serve.sort(key=lambda t: (t[0], t[1]))
        self._serve_list = serve
        self._base_fingerprint = "&".join(base_parts)
        self._fingerprint = self._base_fingerprint + (
            "&" + "&".join(delta_parts) if delta_parts else ""
        )
        self._ds_fingerprints = ds_fp
        self._ds_full_fingerprints = ds_full

    def _invalidate_cache(self, dataset_id: str, regions) -> None:
        """Evict the cached answers a publish could change: scoped to
        (dataset, per-chromosome coordinate envelope) when scoped
        invalidation is on, wholesale otherwise. ``regions`` is
        ``[(chrom, lo, hi), ...]``, or None for every region."""
        cache = self._response_cache
        if cache is None:
            return
        if not self.config.engine.scoped_invalidation:
            cache.invalidate()
            return
        if regions is None:
            cache.invalidate_scope([dataset_id], None, None)
            return
        for chrom, lo, hi in regions:
            cache.invalidate_scope([dataset_id], chrom, (lo, hi))

    def _build_planes(self, key, shard) -> PlaneDeviceIndex | None:
        """Device-resident genotype planes for the selected-samples leaf
        and sample-hit extraction, gated on the device budget: a plane
        set that would take the resident planes plus the uploads in
        flight past ``plane_hbm_budget_gb`` stays on the host (logged)
        and materialisation reads the host planes. A failed upload
        releases its reservation and raises.

        The gate is cumulative: the reservation is taken under the lock
        before the upload, so two concurrent add_index calls cannot both
        pass it and together exceed the budget. Re-ingestion republishes
        the key plane-less first, so its old planes stop counting; an
        in-flight search may still hold them, so the budget is a
        watermark, not a hard cap, across that window. The upload holds
        the plane set once on the device (``staged_upload``), so the
        reservation is its size."""
        eng = self.config.engine
        if shard.gt_bits is None or not eng.device_planes:
            return None
        budget = eng.plane_hbm_budget_gb * 1e9
        est = PlaneDeviceIndex.estimate_hbm(shard)
        token = object()  # unique per upload: same-key races each hold one
        with self._lock:
            prior = self._indexes.get(key)
            if prior is not None and prior[2] is not None:
                self._publish_locked(key, (prior[0], prior[1], None))
            used = self._plane_hbm_resident_locked()
            over = used + est > budget
            if not over:
                self._plane_reserved[token] = est
        if over:
            logging.getLogger(__name__).info(
                "genotype planes for %s exceed the device budget "
                "(%.1f GB resident+reserved); host-resident",
                key,
                used / 1e9,
            )
            return None
        try:
            planes = PlaneDeviceIndex(shard, self.device)
        except BaseException:
            with self._lock:
                self._plane_reserved.pop(token, None)
            raise
        planes._hbm_reservation = token
        return planes

    def _plane_hbm_resident_locked(self) -> int:
        """Resident per-dataset planes + every reservation, under the
        publish lock: the one summation the budget gate reads."""
        return sum(
            p.nbytes_hbm() for _s, _d, p in self._indexes.values()
            if p is not None
        ) + sum(self._plane_reserved.values())

    def plane_hbm_resident(self) -> int:
        """Device bytes committed to genotype planes (resident plane
        indexes + uploads in flight)."""
        with self._lock:
            return self._plane_hbm_resident_locked()

    def register_plane_bytes(self, token, nbytes: int) -> None:
        """Account an external standing plane allocation (the mesh
        dispatch tier's group-stacked planes) on the plane budget's
        reservation ledger, so a later per-dataset upload cannot
        overcommit the device by the stack's size. ``nbytes <= 0``
        releases; registering the same token again replaces."""
        with self._lock:
            if nbytes > 0:
                self._plane_reserved[token] = int(nbytes)
            else:
                self._plane_reserved.pop(token, None)

    def try_reserve_plane_bytes(self, token, nbytes: int, budget: float) -> bool:
        """Atomic check-and-reserve for an external plane allocation: the
        headroom test and the ledger write under one lock hold, as the
        per-dataset upload gate does. The token's own earlier reservation
        is left out of the headroom (``nbytes`` replaces it). Returns
        False, the ledger untouched, when ``nbytes`` does not fit."""
        with self._lock:
            prev = self._plane_reserved.get(token, 0)
            used = self._plane_hbm_resident_locked() - prev
            if used + nbytes > budget:
                return False
            self._plane_reserved[token] = int(nbytes)
            return True

    def shard_snapshot(self) -> list:
        """Sorted ``[((dataset_id, vcf_location), shard), ...]`` of the
        base shards under the publish lock: the dispatch tier builds its
        stack from this instead of iterating ``_indexes`` mid-ingest."""
        with self._lock:
            return [(k, v[0]) for k, v in sorted(self._indexes.items())]

    def index_snapshot(self) -> list:
        """Sorted ``[((dataset_id, vcf_location), shard, planes), ...]``
        under the publish lock: :meth:`shard_snapshot` plus each key's
        device plane index of the same publish."""
        with self._lock:
            return [(k, v[0], v[2]) for k, v in sorted(self._indexes.items())]

    def base_fingerprint(self) -> str:
        """Identity of the BASE shards, the JAX package's string: ``ds|
        vcf|variant_count|call_count|n_rows`` per key, sorted, joined by
        ``&``. Stable across delta publishes; the stacks and the
        dispatch tier key their staleness on it."""
        return self._base_fingerprint

    def index_fingerprint(self) -> str:
        """Identity of the whole served data set: the base fingerprint
        plus a ``ds|vcf#d<epoch>|n_rows`` part per standing delta."""
        return self._fingerprint

    def cache_fingerprint(self, dataset_ids) -> str:
        """The response-cache key's fingerprint component for a query
        over ``dataset_ids`` (empty: every loaded dataset): per-dataset
        BASE components only. A delta publish leaves it unchanged (its
        freshness is the scoped invalidation's), so it does not rotate
        every key."""
        if not dataset_ids:
            return self._base_fingerprint
        ds_fp = self._ds_fingerprints
        return "&".join(
            f"{ds}={ds_fp.get(ds, '')}" for ds in sorted(set(dataset_ids))
        )

    def dataset_fingerprints(self) -> dict[str, str]:
        """Per-dataset identity: the base components of
        :meth:`index_fingerprint` grouped by dataset, plus the delta
        tail's. Lock-free (copy-on-write)."""
        return dict(self._ds_full_fingerprints)

    def close(self) -> None:
        """Join any fused build in flight (a daemon thread caught inside
        a torch call at interpreter exit aborts the process), then
        release the scatter pool and the batcher's pools."""
        for t in list(self._fused_builds):
            t.join()
        self._scatter.shutdown(wait=False, cancel_futures=True)
        if self._batcher is not None:
            self._batcher.close()

    def datasets(self) -> list[str]:
        # the serving list (base + delta tail): a dataset whose first
        # rows arrived as deltas is already served
        return sorted({ds for ds, _vcf, _t in self._serve_list})

    @property
    def batcher(self):
        """The serving micro-batcher (None when microbatch is off)."""
        return self._batcher

    def indexes_for(self, dataset_ids: list[str]):
        """Every serving (shard, index, planes) triple, base and delta,
        for the datasets (all of them for an empty list), in sorted key
        order; a delta's label is ``vcf#d<epoch>`` and its index and
        planes are None; planes is None where a base shard's planes are
        not on the device."""
        for ds, vcf, triple in self._serve_list:
            if not dataset_ids or ds in dataset_ids:
                yield ds, vcf, triple

    def stage_timing(self) -> dict:
        """The batcher's stage quantiles (when it serves) plus host
        materialisation."""
        out: dict = {}
        if self._batcher is not None:
            out.update(self._batcher.timing_summary())
        out["materialize_ms"] = self._materialize_timing()
        return out

    def _materialize_timing(self) -> dict:
        with self._mat_lock:
            xs = list(self._mat_ms)
        return percentiles(xs)

    def cache_stats(self) -> dict | None:
        """Response-cache counters; None when the cache is off."""
        return (
            None
            if self._response_cache is None
            else self._response_cache.stats()
        )

    def register_metrics(self, registry) -> None:
        """Register this engine's instruments: its dispatch counters and
        materialisation quantiles, and the batcher's, the response
        cache's and the delta tail's."""
        registry.counter(
            "engine.fused_searches",
            "multi-dataset queries answered by one fused launch",
            fn=lambda: self.fused_searches,
        )
        registry.counter(
            "engine.mesh_searches",
            "queries answered by the mesh leg",
            fn=lambda: self.mesh_searches,
        )
        registry.gauge(
            "engine.materialize_ms",
            "host materialisation quantiles",
            label="quantile",
            fn=self._materialize_timing,
        )
        if self._batcher is not None:
            self._batcher.register_metrics(registry)
        register_cache_metrics(registry, lambda: self._response_cache)
        register_delta_metrics(registry, self.delta_metrics)

    # -- the delta tail -------------------------------------------------------

    def add_delta(self, shard: VariantIndexShard) -> int:
        """Publish a small delta shard for immediate serving
        (read-your-writes): its rows answer the next search, the base
        stacks stay warm, the base fingerprint is unchanged, and only
        the cached answers whose dataset AND region overlap the new rows
        are evicted. Returns the assigned epoch. The caller asserts the
        rows are new (not in the key's base). Past the L0 threshold the
        key's tail restacks on this thread; a failed L0 build raises
        here, after the rows were published, and on the requests that
        read the tail until a rebuild succeeds."""
        key = (
            shard.meta.get("dataset_id", ""),
            shard.meta.get("vcf_location", ""),
        )
        regions = shard_regions(shard)
        with self._lock:
            epoch = self._delta_seq.get(key, 0) + 1
            self._delta_seq[key] = epoch
            shard.meta["delta_epoch"] = epoch
            tail = dict(self._deltas.get(key, {}))
            tail[epoch] = shard
            deltas = dict(self._deltas)
            deltas[key] = tail
            self._deltas = deltas
            self._l0_touch_key_locked(key)
            self._rebuild_serving_state_locked()
            self.delta_publishes += 1
        self._invalidate_cache(key[0], regions)
        publish_event(
            "ingest.delta_publish",
            dataset=key[0],
            vcf=key[1],
            epoch=epoch,
            rows=shard.n_rows,
        )
        self._rebuild_l0()
        return epoch

    def delta_depth(self, dataset_id: str, vcf_location: str) -> int:
        """Delta shards standing for the key (the compaction trigger)."""
        return len(self._deltas.get((dataset_id, vcf_location), ()))

    def delta_snapshot(self, key: tuple | None = None):
        """``[(key, base_shard | None, [(epoch, shard), ...]), ...]`` for
        every key with a standing delta tail (``key`` scopes it to one
        ``(dataset, vcf)``), under the publish lock: a fold reads this."""
        with self._lock:
            out = []
            for k, tail in sorted(self._deltas.items()):
                if key is not None and k != key:
                    continue
                base = self._indexes.get(k)
                out.append(
                    (k, base[0] if base else None, sorted(tail.items()))
                )
            return out

    def replace_delta_range(self, key, epochs, shard) -> bool:
        """Swap a contiguous set of standing tail ``epochs`` for ONE
        merged shard in one publish critical section (the size-tiered
        fold's L1 seam): the merged shard takes the highest replaced
        epoch and carries ``meta['l1_epochs'] = [lo, hi]``. Returns
        False, nothing changed, when an epoch no longer stands."""
        epochs = sorted(int(e) for e in epochs)
        lo, hi = epochs[0], epochs[-1]
        shard.meta["dataset_id"] = key[0]
        shard.meta["vcf_location"] = key[1]
        shard.meta["delta_epoch"] = hi
        shard.meta["l1_epochs"] = [lo, hi]
        regions = shard_regions(shard)
        with self._lock:
            tail = self._deltas.get(key, {})
            if any(e not in tail for e in epochs):
                return False
            new_tail = {
                e: s for e, s in tail.items() if e not in epochs
            }
            new_tail[hi] = shard
            deltas = dict(self._deltas)
            deltas[key] = new_tail
            self._deltas = deltas
            self._l0_touch_key_locked(key)
            self._retire_l0_key_locked(key)
            self._rebuild_serving_state_locked()
        # the same rows under new serving labels: evict the overlapping
        # cached answers as a delta publish would
        self._invalidate_cache(key[0], regions)
        self._rebuild_l0()
        return True

    def drop_dataset(self, dataset_id: str) -> int:
        """Retire every shard (base and standing tail) of one dataset in
        one publish critical section. Returns the base shards removed
        (0: the dataset is unknown)."""
        with self._lock:
            base_keys = [k for k in self._indexes if k[0] == dataset_id]
            delta_keys = [k for k in self._deltas if k[0] == dataset_id]
            if not base_keys and not delta_keys:
                return 0
            if base_keys:
                indexes = dict(self._indexes)
                for k in base_keys:
                    indexes.pop(k, None)
                self._indexes = indexes
            if delta_keys:
                deltas = dict(self._deltas)
                for k in delta_keys:
                    deltas.pop(k, None)
                self._deltas = deltas
            for k in set(base_keys) | set(delta_keys):
                self._delta_seq.pop(k, None)
                self._l0_touch_key_locked(k)
                self._retire_l0_key_locked(k)
            self._mesh_dirty = True
            self._fused_dirty = True
            self._fused_gen += 1
            self._rebuild_serving_state_locked()
        self._invalidate_cache(dataset_id, None)
        publish_event(
            "ingest.dataset_drop", dataset=dataset_id, shards=len(base_keys)
        )
        self._rebuild_l0()
        return len(base_keys)

    def delta_stats(self) -> dict:
        """Per-dataset delta-tail depth: ``{dataset: {"shards": n,
        "rows": m}}``, lock-free over the copy-on-write registry."""
        deltas = self._deltas
        out: dict = {}
        for (ds, _vcf), tail in deltas.items():
            agg = out.setdefault(ds, {"shards": 0, "rows": 0})
            agg["shards"] += len(tail)
            agg["rows"] += sum(s.n_rows for s in tail.values())
        return out

    def delta_tail(self, dataset_id: str, vcf_location: str) -> dict:
        """One key's standing tail: ``{"shards": n, "rows": m}``."""
        tail = self._deltas.get((dataset_id, vcf_location), {})
        return {
            "shards": len(tail),
            "rows": sum(s.n_rows for s in tail.values()),
        }

    def delta_metrics(self) -> dict:
        """The ``ingest.*`` series values (``register_delta_metrics``),
        lock-free."""
        deltas = self._deltas
        return {
            "publishes": self.delta_publishes,
            "shards": sum(len(t) for t in deltas.values()),
            "l0_builds": self.l0_builds,
            "l0_served": self.l0_searches,
            "l0_key_builds": dict(self._l0_key_builds),
            "l0_block_reuses": self.l0_block_reuses,
        }

    # -- the L0 tier of the delta tail ------------------------------------------

    def _l0_covered_keys(self, deltas) -> list:
        """Keys whose standing tail is past the L0 threshold (depth in
        shards OR total rows; a 0 disables that trigger, both 0 disable
        the tier)."""
        eng = self.config.engine
        min_shards = eng.l0_min_shards
        min_rows = eng.l0_min_rows
        if min_shards <= 0 and min_rows <= 0:
            return []
        out = []
        for key, tail in sorted(deltas.items()):
            if min_shards > 0 and len(tail) >= min_shards:
                out.append(key)
                continue
            if min_rows > 0 and (
                sum(s.n_rows for s in tail.values()) >= min_rows
            ):
                out.append(key)
        return out

    def _l0_touch_key_locked(self, key) -> None:
        """Record under ``_lock`` that ``key``'s tail moved: bumps the
        global L0 generation (a racing composite publish loses) and the
        key's own (a rebuild racing a publish to another key still
        adopts the blocks whose inputs did not move)."""
        self._l0_gen += 1
        self._l0_key_gens[key] = self._l0_key_gens.get(key, 0) + 1

    def _retire_l0_key_locked(self, key) -> None:
        """Drop one key's entries from the L0 coverage map under
        ``_lock``: its epochs were folded into a base, replaced by an L1
        shard, or dropped. Coverage and the serving list change in the
        same critical section; the stacked columns may keep dead rows
        until the next build, and nothing routes to them."""
        if key in self._l0_blocks:
            blocks = dict(self._l0_blocks)
            blocks.pop(key, None)
            self._l0_blocks = blocks
        state = self._l0_state
        if state is None:
            return
        ds, vcf = key
        prefix = f"{vcf}#d"
        findex, sid_of, shard_of, rows, built_at = state
        kept = {
            k: sid
            for k, sid in sid_of.items()
            if not (k[0] == ds and k[1].startswith(prefix))
        }
        if len(kept) == len(sid_of):
            return
        if not kept:
            self._l0_state = None
        else:
            self._l0_state = (
                findex,
                kept,
                {k: shard_of[k] for k in kept},
                rows,
                built_at,
            )

    def _rebuild_l0(self) -> None:
        """Stack every past-threshold tail into a fresh L0 index and
        publish it copy-on-write, generation-checked like the fused
        stack's build (a publish racing the build wins; the next trigger
        rebuilds). Runs on the publishing thread, never a request
        thread. Each covered key keeps a standing block, restacked only
        when its tail changed; the published index is a
        ``CompositeL0DeviceIndex`` over the blocks. A failed block build
        or composite is recorded (the requests that read the tail raise
        it) and raised here."""
        with self._lock:
            gen = self._l0_gen
            key_gens = dict(self._l0_key_gens)
            deltas = self._deltas
            blocks = self._l0_blocks
        keys = self._l0_covered_keys(deltas)
        if not keys:
            with self._lock:
                if self._l0_gen == gen:
                    self._l0_state = None
                    self._l0_blocks = {}
                    self._l0_error = None
            return
        fresh: dict = {}  # key -> (block, entries, built_at)
        per_key: dict = {}
        reused = 0
        try:
            for key in keys:
                ds, vcf = key
                entries = [
                    ((ds, f"{vcf}#d{epoch}"), shard)
                    for epoch, shard in sorted(deltas[key].items())
                ]
                standing = blocks.get(key)
                if standing is not None:
                    _b, old_entries, _t = standing
                    if len(old_entries) == len(entries) and all(
                        a[0] == b[0] and a[1] is b[1]
                        for a, b in zip(old_entries, entries)
                    ):
                        per_key[key] = standing
                        reused += 1
                        continue
                block = L0DeviceIndex([s for _k, s in entries], self.device)
                standing = (block, entries, time.time())
                per_key[key] = standing
                fresh[key] = standing
            state = self._l0_state
            if not fresh and state is not None:
                all_entries = [e for key in keys for e in per_key[key][1]]
                sid_of, shard_of = state[1], state[2]
                if len(sid_of) == len(all_entries) and all(
                    shard_of.get(k) is s for k, s in all_entries
                ):
                    # coverage identical (a sub-threshold key published)
                    # and every block standing: nothing to stack
                    return
            findex = CompositeL0DeviceIndex([per_key[k][0] for k in keys])
            sid_of = {}
            shard_of = {}
            for key, off in zip(keys, findex.block_sid_offsets):
                for j, (serve_key, shard) in enumerate(per_key[key][1]):
                    sid_of[serve_key] = off + j
                    shard_of[serve_key] = shard
            # one launch before publishing: the kernel is loaded off the
            # request path
            self._l0_warm(findex)
        except BaseException as e:
            with self._lock:
                if self._l0_gen == gen:
                    self._l0_error = (gen, e)
            raise
        state = (findex, sid_of, shard_of, int(findex.n_rows), time.time())
        with self._lock:
            # adopt fresh blocks whose own key did not move: a publish to
            # key B racing this build must not discard key A's block
            adoptable = {
                k: v
                for k, v in fresh.items()
                if self._l0_key_gens.get(k, 0) == key_gens.get(k, 0)
            }
            if adoptable:
                nb = dict(self._l0_blocks)
                nb.update(adoptable)
                self._l0_blocks = nb
                for k in adoptable:
                    self._l0_count_key_build_locked(k)
            if self._l0_gen != gen:
                return  # a publish raced the build: rebuilt on its trigger
            self._l0_state = state
            self._l0_error = None
            self.l0_builds += 1
            self.l0_block_reuses += reused
        publish_event(
            "ingest.l0_build",
            keys=len(keys),
            shards=len(sid_of),
            rows=int(findex.n_rows),
            rebuilt=len(fresh),
            reused=reused,
        )

    def _l0_count_key_build_locked(self, key) -> None:
        """Attribute one block stack to its ``dataset/vcf`` label, the
        label set bounded at the registry's cardinality cap (past it,
        new keys collapse into the overflow sentinel)."""
        label = f"{key[0]}/{key[1]}"
        builds = self._l0_key_builds
        if label not in builds and len(builds) >= DEFAULT_MAX_LABEL_VALUES:
            label = OVERFLOW_LABEL
        builds[label] = builds.get(label, 0) + 1

    def _l0_window(self, findex) -> int:
        """The L0 launch's window: the index's tail-sized hint under the
        engine-wide cap (a tail shard's hit range never exceeds its row
        count, so it only shrinks the lanes; overflow keeps the host
        contract either way)."""
        return min(self.config.engine.window_cap, findex.window_hint)

    def _l0_warm(self, findex) -> int:
        """One launch of the L0 index inside a warmup phase, once per
        (index class, padded rows, padded shards, window, record_cap):
        the kernel is built and loaded before the index serves. The JAX
        engine compiles its batch-tier ladder here; the kernel compiles
        no shapes. Returns the launches made (0 or 1); a failure
        raises."""
        eng = self.config.engine
        win = self._l0_window(findex)
        shape = (
            type(findex).__name__,
            findex.n_padded,
            findex.n_shards_padded,
            win,
            eng.record_cap,
        )
        if shape in self._l0_warmed:
            return 0
        with device_warmup_phase():
            run_queries_auto(
                findex,
                encode_queries([QuerySpec("1", 1, 1, 1, 2)], shard_ids=[0]),
                window_cap=win,
                record_cap=eng.record_cap,
            )
        self._l0_warmed.add(shape)
        return 1

    def l0_status(self) -> dict:
        """The L0 tier's state, lock-free: built, builds, served
        queries, shards and rows covered, age, the per-key blocks (their
        shards, rows and builds) and the block reuses."""
        state = self._l0_state
        doc: dict = {
            "built": state is not None,
            "builds": self.l0_builds,
            "servedQueries": self.l0_searches,
        }
        if state is not None:
            doc["shards"] = len(state[1])
            doc["rows"] = state[3]
            doc["ageS"] = round(time.time() - state[4], 1)
        blocks = self._l0_blocks
        if blocks:
            doc["keys"] = {
                f"{ds}/{vcf}": {
                    "shards": len(entries),
                    "rows": int(b.n_rows),
                    "builds": self._l0_key_builds.get(f"{ds}/{vcf}", 0),
                }
                for (ds, vcf), (b, entries, _t) in sorted(blocks.items())
            }
        doc["blockReuses"] = self.l0_block_reuses
        return doc

    def l0_pre_rows(self, tail_targets, spec_base, payload) -> dict:
        """``{serve_key: shard-local row ids | None}`` for the delta-tail
        targets the standing L0 index covers: ONE launch through the
        micro-batcher answers them all, across keys. None marks window
        or record overflow (the caller matches that shard uncapped on
        the host). The targets left to the host (absent: below the
        threshold, a racing republish, an N-wildcard ref; or None)
        charge ``delta_shards`` to the calling request here, the one
        seam the engine and the pod tier both consult.

        ``tail_targets`` is ``[((dataset, vcf_label), shard), ...]`` with
        the serving list's ``vcf#d<epoch>`` labels. A failed L0 build
        raises here while it stands, and a failed launch raises."""
        out = self._l0_pre_rows(tail_targets, spec_base, payload)
        n_host = sum(1 for key, _s in tail_targets if out.get(key) is None)
        if n_host:
            charge_cost(delta_shards=n_host)
        return out

    def _l0_pre_rows(self, tail_targets, spec_base, payload) -> dict:
        err = self._l0_error
        if err is not None and tail_targets:
            raise RuntimeError(
                "the delta tail's L0 index failed to build"
            ) from err[1]
        state = self._l0_state
        if state is None or not tail_targets:
            return {}
        if payload.selected_samples_only and not self._device_ref_ok(
            payload, spec_base
        ):
            return {}  # N-wildcard ref: host regex semantics only
        findex, sid_of, shard_of = state[0], state[1], state[2]
        routes = []
        for key, shard in tail_targets:
            sid = sid_of.get(key)
            if sid is not None and shard_of[key] is shard:
                routes.append((key, sid))
        if not routes:
            return {}
        eng = self.config.engine
        specs = [spec_base] * len(routes)
        sids = [sid for _k, sid in routes]
        win = self._l0_window(findex)
        if self._batcher is not None:
            res = self._batcher.submit_many(
                findex,
                specs,
                shard_ids=sids,
                window_cap=win,
                record_cap=eng.record_cap,
            )
        else:
            fault_point("kernel.launch")
            res = run_queries_auto(
                findex,
                encode_queries(specs, shard_ids=sids),
                window_cap=win,
                record_cap=eng.record_cap,
            )
        out = {}
        for i, (key, sid) in enumerate(routes):
            if res.overflow[i] or res.n_matched[i] > eng.record_cap:
                out[key] = None
            else:
                rows = res.rows[i][res.rows[i] >= 0]
                out[key] = findex.to_local_rows(rows, sid)
        with self._mat_lock:
            self.l0_searches += 1
        annotate(dispatch_l0=len(routes))
        return out

    # -- warmup -------------------------------------------------------------

    def warmup(self) -> int:
        """Build every kernel of the port (on a CUDA device) and launch
        each kernel family once against each loaded index: the scatter
        match per base shard, the fused match + planes and the plane
        stats per shard with device planes, the bisection query on the
        fused stack and on the L0 index, and the stacked query (and the
        stacked selected kernel, with planes) on the mesh stack. Runs
        inside a warmup phase (its launch records say so). Returns the
        number of launches; a failure raises. The JAX engine compiles
        its batch-tier ladder here; the kernels compile no shapes, so
        one launch a family and index loads each kernel."""
        if self.device.type == "cuda":
            from .ops import _build

            _build.build_all()
        with device_warmup_phase():
            return self._warmup()

    def _warmup(self) -> int:
        eng = self.config.engine
        probe = QuerySpec("1", 1, 1, 1, 2)
        n = 0
        with self._lock:
            snapshot = list(self._indexes.values())
        for _shard, dindex, planes in snapshot:
            run_queries_auto(
                dindex,
                [probe],
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )
            n += 1
            if planes is not None:
                run_selected_scattered(
                    dindex,
                    planes,
                    [probe],
                    np.zeros((1, planes.n_words), np.uint32),
                    window_cap=eng.window_cap,
                    record_cap=eng.record_cap,
                    with_counts=planes.has_counts,
                )
                plane_row_stats(
                    planes,
                    np.zeros(1, np.int64),
                    np.zeros(planes.n_words, np.uint32),
                    or_sel=np.ones(1, np.int32),
                    with_counts=planes.has_counts,
                )
                n += 2
        fst = self._fused_ready(wait=True)
        if fst is not None:
            run_queries_auto(
                fst[0],
                encode_queries([probe], shard_ids=[0]),
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )
            n += 1
        l0 = self._l0_state
        if l0 is not None:
            run_queries_auto(
                l0[0],
                encode_queries([probe], shard_ids=[0]),
                window_cap=self._l0_window(l0[0]),
                record_cap=eng.record_cap,
            )
            n += 1
        state = self._mesh_ready()
        if state is not None:
            mesh, stacked, blocks = state[:3]
            _mesh.sharded_query(
                blocks,
                [probe],
                mesh=mesh,
                n_iters=stacked.n_iters,
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )
            n += 1
            if stacked.has_planes:
                _mesh.sharded_selected_query(
                    blocks,
                    [probe],
                    np.zeros(
                        (stacked.n_datasets_padded, stacked.plane_words),
                        np.uint32,
                    ),
                    mesh=mesh,
                    n_iters=stacked.n_iters,
                    window_cap=eng.window_cap,
                    record_cap=eng.record_cap,
                    has_counts=stacked.has_count_planes,
                )
                n += 1
        return n


    # -- fused multi-dataset stack -----------------------------------------

    def warm_fused(self) -> FusedDeviceIndex | None:
        """Build the fused stack now, on the caller's thread (the JAX
        engine's warmup path), and return it; None when fused dispatch
        is off, fewer than 2 shards are loaded or the stack would exceed
        ``fused_max_rows``. A failed build raises."""
        state = self._fused_ready(wait=True)
        return None if state is None else state[0]

    def _fused_ready(self, wait: bool = False):
        """(FusedDeviceIndex, key -> shard id, key -> shard) over every
        loaded shard, cached until the index set changes; None when
        fused dispatch is off, fewer than 2 shards are loaded, the
        stacked row count exceeds ``fused_max_rows``, or a rebuild is
        still in flight (``wait=False``, the request path: the build
        runs on a background thread, and per-shard dispatch serves
        until it publishes). ``wait=True`` builds inline. A failed
        background build is not served around: its exception is raised
        here until the next publish."""
        eng = self.config.engine
        if not eng.fused_dispatch:
            return None
        # lock-free fast path: a clean state costs one bool and one
        # reference read
        if not wait and not self._fused_dirty:
            self._raise_fused_error()
            return self._fused_state
        with self._lock:
            if not self._fused_dirty:
                state = self._fused_state
                if not wait:
                    self._raise_fused_error()
                    return state
                if state is not None:
                    return state
                # wait=True with a build in flight (or a failed or
                # skipped one): build inline anyway
            else:
                # claim the rebuild: snapshot the inputs and mark clean
                # under the lock, then build off-lock
                self._fused_dirty = False
                self._fused_state = None
                self._fused_error = None
            gen = self._fused_gen
            keys = sorted(self._indexes)
            shards = [self._indexes[k][0] for k in keys]
        if len(keys) < 2:
            return None
        if sum(s.n_rows for s in shards) > eng.fused_max_rows:
            # the stack duplicates the columns on the device: past the
            # budget, per-shard dispatch serves
            return None
        if wait:
            return self._build_fused(keys, shards, gen, inline=True)
        t = threading.Thread(
            target=self._build_fused,
            args=(keys, shards, gen),
            name="fused-build",
            daemon=True,
        )
        self._fused_builds.add(t)
        t.start()
        return None

    def _raise_fused_error(self) -> None:
        err = self._fused_error
        if err is not None:
            raise RuntimeError(
                "the fused multi-dataset index failed to build"
            ) from err

    def _build_fused(self, keys, shards, gen, *, inline: bool = False):
        """Build and publish the fused stack. ``gen`` is the publish
        generation the inputs were snapshotted at: a build that an
        add_index overtook is dropped, never published over a newer
        index set. A failure raises when inline; on the background
        thread it is stored for the next request to raise."""
        try:
            findex = FusedDeviceIndex(shards, self.device)
        except Exception as e:
            if inline:
                raise
            with self._lock:
                if self._fused_gen == gen:
                    self._fused_error = e
            return None
        # the state carries its own shard snapshot: stacked row ids are
        # only valid against the exact shard objects it was built from
        state = (
            findex,
            {k: i for i, k in enumerate(keys)},
            dict(zip(keys, shards)),
        )
        with self._lock:
            if self._fused_gen != gen:
                return None
            self._fused_state = state
            self._fused_error = None
        return state

    def _fused_multi_rows(self, targets, spec_base, payload):
        """{key: shard-local row ids | None} for every target of a
        multi-dataset query that the fused stack covers, computed by
        ONE stacked-index launch (None marks window/record overflow: the
        caller host-matches that shard uncapped, the per-shard
        contract). Returns None, and per-target dispatch serves, when
        the query needs host-only ref-wildcard semantics, no stack is
        ready, or fewer than 2 targets are covered. Targets the fused
        match + planes kernel will serve whole (``_fused_selected``:
        the request reads planes and the shard's are on the device) are
        left out: their stacked match would be thrown away."""
        if payload.selected_samples_only and not self._device_ref_ok(
            payload, spec_base
        ):
            return None
        # resolve the snapshot ONCE, so shard ids and shard_base come
        # from one stack
        fst = self._fused_ready()
        if fst is None:
            return None
        findex, sid_of, shard_of = fst
        wants_planes = self._wants_planes(payload)
        routes = []
        for ds, vcf, shard, _dindex, planes, _native in targets:
            if wants_planes and planes is not None:
                continue  # _fused_selected serves this target whole
            sid = sid_of.get((ds, vcf))
            if sid is not None and shard_of[(ds, vcf)] is shard:
                routes.append(((ds, vcf), sid))
        if len(routes) < 2:
            return None
        eng = self.config.engine
        specs = [spec_base] * len(routes)
        sids = [sid for _k, sid in routes]
        if self._batcher is not None:
            res = self._batcher.submit_many(
                findex,
                specs,
                shard_ids=sids,
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )
        else:
            fault_point("kernel.launch")
            res = run_queries_auto(
                findex,
                encode_queries(specs, shard_ids=sids),
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )
        out = {}
        for i, (key, sid) in enumerate(routes):
            if res.overflow[i] or res.n_matched[i] > eng.record_cap:
                out[key] = None
            else:
                rows = res.rows[i][res.rows[i] >= 0]
                out[key] = findex.to_local_rows(rows, sid)
        with self._mat_lock:
            self.fused_searches += 1
        annotate(dispatch="fused")
        return out

    # -- dataset-sharded mesh stack ------------------------------------------

    def warm_mesh(self):
        """Build the mesh stack now, on the caller's thread (the JAX
        engine's warmup path), and return (mesh, stacked index, device
        blocks); None when the mesh leg is off (``use_mesh`` off, fewer
        than two mesh devices or shards). A failed build raises."""
        state = self._mesh_ready()
        return None if state is None else state[:3]

    def _mesh_ready(self):
        """(mesh, stacked, blocks, key -> stack position, key -> shard,
        key -> planes) over every loaded shard, built on the calling
        thread and cached until the index set changes; None when
        ``use_mesh`` is off or fewer than two mesh devices or shards are
        there (the JAX engine's gate). A failed build or upload raises,
        on this request and the next ones until a build succeeds."""
        if not self.config.engine.use_mesh:
            return None
        with self._mesh_lock:
            with self._lock:
                if not self._mesh_dirty:
                    return self._mesh_state
                self._mesh_state = None
                self._mesh_dirty = False
                keys = sorted(self._indexes)
                shards = [self._indexes[k][0] for k in keys]
                planes_of = {k: self._indexes[k][2] for k in keys}
            devices = _mesh.mesh_devices(self.device)
            if len(devices) < 2 or len(keys) < 2:
                return None
            try:
                state = self._build_mesh(devices, keys, shards, planes_of)
            except BaseException:
                with self._lock:
                    self._mesh_dirty = True
                raise
            # a publish during the build left the flag dirty: this
            # request serves the snapshot, the next one rebuilds
            self._mesh_state = state
            return state

    def _build_mesh(self, devices, keys, shards, planes_of):
        """The mesh state over ``shards``: the stack, with the genotype
        planes when every shard has them and their bytes on the engine's
        device (one block's per mesh entry there) fit the plane budget
        beside the resident planes, uploaded to the mesh."""
        eng = self.config.engine
        mesh = _mesh.make_mesh(devices=devices)
        d_pad = -(-len(shards) // mesh.size) * mesh.size
        with_planes = all(s.gt_bits is not None for s in shards)
        if with_planes:
            per_dev = _mesh.StackedIndex.plane_bytes_per_device(
                shards, n_datasets_padded=d_pad, n_mesh=mesh.size
            ) * _mesh.entries_on(mesh, self.device)
            with self._lock:
                resident = self._plane_hbm_resident_locked()
            verdict = _mesh.plane_budget_verdict(
                per_dev, resident, eng.plane_hbm_budget_gb * 1e9
            )
            self._plane_budget_verdict = verdict
            with_planes = verdict["fits"]
        stacked = _mesh.StackedIndex(
            shards, n_datasets_padded=d_pad, with_planes=with_planes
        )
        blocks = stacked.shard_to_mesh(mesh)
        # the state carries its own shard snapshot: stacked row ids are
        # only valid against the exact shard objects it was built from
        return (
            mesh,
            stacked,
            blocks,
            {k: i for i, k in enumerate(keys)},
            dict(zip(keys, shards)),
            planes_of,
        )

    def _mesh_search(self, state, targets, spec_base, payload):
        """A multi-dataset query as one ``sharded_query`` (or, for the
        selected-samples leaf on a stack with planes,
        ``sharded_selected_query``) over the dataset-sharded stack: one
        stacked-kernel launch per mesh device. Per-dataset rows (and
        masked popcounts and sample-hit words) materialise on the host
        with the scatter path's semantics; window or record_cap
        overflow, and an N-wildcard ref, take the uncapped host
        matcher."""
        mesh, stacked, blocks, index_of, shard_of, planes_of = state
        eng = self.config.engine
        device_ref_ok = self._device_ref_ok(payload, spec_base)
        ref_wild = payload.selected_samples_only
        selected_mesh = (
            payload.selected_samples_only
            and stacked.has_planes
            and device_ref_ok
        )
        sel_idx_of: dict = {}
        if selected_mesh:
            W = stacked.plane_words
            masks = np.zeros((stacked.n_datasets_padded, W), np.uint32)
            for ds, vcf, *_rest in targets:
                key = (ds, vcf)
                sel_idx_of[key] = self._selected_idx(shard_of[key], payload, ds)
                masks[index_of[key]] = sample_mask_words(sel_idx_of[key], W)
            per_ds, _agg = _mesh.sharded_selected_query(
                blocks,
                [spec_base],
                masks,
                mesh=mesh,
                n_iters=stacked.n_iters,
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
                has_counts=stacked.has_count_planes,
            )
        else:
            per_ds, _agg = _mesh.sharded_query(
                blocks,
                [spec_base],
                mesh=mesh,
                n_iters=stacked.n_iters,
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )

        def _one(target):
            ds, vcf, _shard, _dindex, _planes, native = target
            # rows from the stack materialise against the shard the
            # stack was built from
            shard = shard_of[(ds, vcf)]
            di = index_of[(ds, vcf)]
            selected_idx = (
                sel_idx_of.get(
                    (ds, vcf), self._selected_idx(shard, payload, ds)
                )
                if payload.selected_samples_only
                else None
            )
            overflow = (
                bool(per_ds["overflow"][di, 0])
                or int(per_ds["n_matched"][di, 0]) > eng.record_cap
            )
            fused = None
            if not device_ref_ok or overflow:
                rows = host_match_rows(shard, spec_base, ref_wildcard=ref_wild)
            else:
                r = per_ds["rows"][di, 0]
                keep = r >= 0
                rows = r[keep].astype(np.int64)
                # the device outputs are exact for this shard only when
                # its count-plane availability matches the stack-wide
                # one (a shard with count planes in a stack without them
                # was counted full-cohort: the plane index serves it)
                if selected_mesh and (
                    stacked.has_count_planes or not shard.has_count_planes
                ):
                    # or_words are stack-wide (the widest shard's W):
                    # truncate to this shard's own width (the tail words
                    # are zero by the stack's padding and the mask)
                    w_shard = shard.gt_bits.shape[1]
                    fused = (
                        per_ds["pc_call"][di, 0][keep],
                        per_ds["pc_tok"][di, 0][keep],
                        np.asarray(per_ds["or_words"][di, 0])
                        .view(np.uint32)[:w_shard],
                    )
            return materialize_response(
                shard,
                rows,
                payload,
                chrom_label=native,
                dataset_id=ds,
                vcf_location=vcf,
                selected_idx=selected_idx,
                plane_index=planes_of.get((ds, vcf)),
                fused=fused,
            )

        if len(targets) == 1:
            responses = [_one(targets[0])]
        else:
            responses = list(self._scatter.map(_one, targets))
        with self._mat_lock:
            self.mesh_searches += 1
            if selected_mesh:
                self.mesh_selected_searches += 1
        annotate(dispatch="mesh")
        return responses

    # -- query path ---------------------------------------------------------

    def search(self, payload: VariantQueryPayload) -> list[VariantSearchResponse]:
        """One response per (dataset, vcf) target, base and delta, in
        sorted key order.

        Fronted by the response cache: a repeated query (a repeated miss
        too) answers from host memory with no device launch. Keys embed
        the per-dataset BASE fingerprint components
        (``cache_fingerprint``): a base publish rotates the touched
        dataset's keys; a delta publish rotates none and evicts the
        overlapping entries instead. The generation captured before
        dispatch keeps a publish that lands mid-search from being
        outrun by a stale store. ``payload.no_response_cache`` bypasses
        the cache."""
        cache = None if payload.no_response_cache else self._response_cache
        key = None
        scope = None
        gen = None
        if cache is not None:
            key = response_cache_key(
                self.cache_fingerprint(payload.dataset_ids), payload
            )
            hit = cache.get(key)
            if hit is not None:
                annotate(response_cache="hit")
                plan_stage("cache", decision="hit")
                return hit
            scope = response_cache_scope(payload)
            gen = cache.generation()
        outcome = "miss" if cache is not None else "off"
        annotate(response_cache=outcome)
        plan_stage("cache", decision=outcome)
        with span("engine.search") as sp:
            responses = self._search(payload, sp)
        if key is not None:
            cache.put(key, responses, scope=scope, gen=gen)
        return responses

    def _device_rows(
        self,
        shard: VariantIndexShard,
        dindex,
        spec: QuerySpec,
        *,
        ref_wildcard: bool = False,
    ) -> np.ndarray:
        """Matched row ids via the shard's scatter kernel (micro-batched
        when enabled), host fallback on window/record overflow.

        The JAX engine routes a single-dataset query through the fused
        stack when the shard's own index is an XLA ``DeviceIndex``
        (``_fused_route``); this package serves every single shard with
        a ``ScatterDeviceIndex``, which keeps its own kernel there as in
        the JAX engine, so that branch has no counterpart."""
        eng = self.config.engine
        if self._batcher is not None:
            # concurrent searches coalesce into one kernel launch
            res = self._batcher.submit(
                dindex,
                spec,
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )
        else:
            fault_point("kernel.launch")
            res = run_queries_auto(
                dindex,
                [spec],
                window_cap=eng.window_cap,
                record_cap=eng.record_cap,
            )
        if res.overflow[0] or res.n_matched[0] > eng.record_cap:
            with self._mat_lock:
                self.host_fallbacks += 1
            return host_match_rows(shard, spec, ref_wildcard=ref_wildcard)
        return res.rows[0][res.rows[0] >= 0]

    def _search(self, payload: VariantQueryPayload, sp=None):
        spec_base = QuerySpec(
            chrom=payload.reference_name,
            start_min=payload.start_min,
            start_max=payload.start_max,
            end_min=payload.end_min,
            end_max=payload.end_max,
            reference_bases=payload.reference_bases,
            alternate_bases=payload.alternate_bases,
            variant_type=payload.variant_type,
            variant_min_length=payload.variant_min_length,
            variant_max_length=payload.variant_max_length,
        )
        targets = []
        for ds, vcf, (shard, dindex, planes) in self.indexes_for(
            payload.dataset_ids
        ):
            native = shard.meta.get("chrom_native", {}).get(payload.reference_name)
            if native is None:
                # VCF has no matching chromosome: skipped
                continue
            targets.append((ds, vcf, shard, dindex, planes, native))
        if not targets:
            return []
        # the submitting request's context: _one_target runs on the
        # scatter pool, whose threads do not inherit thread-locals, so it
        # is installed there for the charges and the batcher's lane note
        req_ctx = current_context()

        # the mesh leg serves the base targets whose shard is the one its
        # stack was built from; the delta tail (and a racing publish)
        # takes the legs below
        mesh_responses = None
        if len(targets) > 1:
            state = self._mesh_ready()
            if state is not None:
                shard_of = state[4]
                covered = [
                    t for t in targets if shard_of.get((t[0], t[1])) is t[2]
                ]
                if covered:
                    got = self._mesh_search(state, covered, spec_base, payload)
                    mesh_responses = {
                        (t[0], t[1]): r for t, r in zip(covered, got)
                    }
                    targets = [
                        t for t in targets
                        if (t[0], t[1]) not in mesh_responses
                    ]
                    if not targets:
                        plan_stage(
                            "split",
                            decision="mesh_all",
                            mesh=len(mesh_responses),
                        )
                        return list(mesh_responses.values())

        # the L0 leg of the three-way split: the delta-tail targets the
        # L0 index covers ride ONE launch; the rest (below the
        # threshold, racing republishes, overflow marked None) are
        # matched on the host. l0_pre_rows charges the host-walked ones.
        tail_targets = [
            ((t[0], t[1]), t[2]) for t in targets if "#d" in t[1]
        ]
        l0_rows = (
            self.l0_pre_rows(tail_targets, spec_base, payload)
            if tail_targets
            else {}
        )

        # cross-shard fused dispatch: ONE stacked-index launch answers
        # this query for every covered base target; uncovered targets
        # take their own path inside _one_target
        pre_rows = (
            self._fused_multi_rows(targets, spec_base, payload)
            if len(targets) > 1
            else None
        )
        plan_stage(
            "split",
            decision="fanout",
            mesh=len(mesh_responses) if mesh_responses else 0,
            l0=sum(1 for r in l0_rows.values() if r is not None),
            delta_tail_host=sum(1 for r in l0_rows.values() if r is None),
            fused=sum(
                1
                for k, r in (pre_rows or {}).items()
                if r is not None and k not in l0_rows
            ),
            fused_overflow_host=sum(
                1
                for k, r in (pre_rows or {}).items()
                if r is None and k not in l0_rows
            ),
            scatter=len(targets),
        )

        def _one_target(target):
            with request_context(req_ctx):
                return _one_target_inner(target)

        def _one_target_inner(target):
            ds, vcf, shard, dindex, planes, native = target
            selected_idx = None
            fused = None
            rows = None
            if payload.selected_samples_only:
                selected_idx = self._selected_idx(shard, payload, ds)
            if planes is not None and self._wants_planes(payload):
                # the fused match + planes kernel: the whole
                # selected-samples (or sample-extraction) leaf in ONE
                # launch. Overflow and N-wildcard refs take the split
                # path below.
                got = self._fused_selected(
                    shard, dindex, planes, spec_base, payload, selected_idx
                )
                if got is not None:
                    rows, fused = got
            if rows is None and (ds, vcf) in l0_rows:
                # the L0 launch already matched this tail target; None
                # marks window/record overflow -> the uncapped host
                # matcher (already charged)
                rows = l0_rows[(ds, vcf)]
                if rows is None:
                    with self._mat_lock:
                        self.host_fallbacks += 1
                    rows = host_match_rows(
                        shard,
                        spec_base,
                        ref_wildcard=payload.selected_samples_only,
                    )
            if rows is None and pre_rows is not None and (ds, vcf) in pre_rows:
                # the fused launch already matched this target; None
                # marks window/record overflow -> the uncapped host
                # matcher, exactly like the per-shard contract
                rows = pre_rows[(ds, vcf)]
                if rows is None:
                    with self._mat_lock:
                        self.host_fallbacks += 1
                    rows = host_match_rows(
                        shard,
                        spec_base,
                        ref_wildcard=payload.selected_samples_only,
                    )
            if rows is None and payload.selected_samples_only:
                # selected-samples leaf: device row matching unless the
                # ref carries an N wildcard (regex semantics, host
                # only) or the target is a delta shard below the L0
                # threshold; counting is sample-restricted in
                # materialize_response via the genotype bit planes
                if dindex is not None and self._device_ref_ok(
                    payload, spec_base
                ):
                    rows = self._device_rows(
                        shard, dindex, spec_base, ref_wildcard=True
                    )
                else:
                    rows = host_match_rows(
                        shard, spec_base, ref_wildcard=True
                    )
            elif rows is None and dindex is None:
                # a delta shard below the L0 threshold: the host scan
                rows = host_match_rows(shard, spec_base)
            elif rows is None:
                rows = self._device_rows(shard, dindex, spec_base)
            t_mat = time.perf_counter()
            resp = materialize_response(
                shard,
                rows,
                payload,
                chrom_label=native,
                dataset_id=ds,
                vcf_location=vcf,
                selected_idx=selected_idx,
                plane_index=planes,
                fused=fused,
            )
            with self._mat_lock:
                self._mat_ms.append((time.perf_counter() - t_mat) * 1e3)
            return resp

        if len(targets) == 1:
            responses = [_one_target(targets[0])]
        elif not l0_rows:
            # per-dataset scatter: overlaps the per-shard device
            # round-trips instead of serialising them
            responses = list(self._scatter.map(_one_target, targets))
        else:
            # L0-covered tail targets have no device work left (their
            # rows are in hand), so they materialise on the request
            # thread while the pool overlaps the targets that still
            # launch
            pooled = [t for t in targets if (t[0], t[1]) not in l0_rows]
            pooled_iter = (
                self._scatter.map(_one_target, pooled)
                if len(pooled) > 1
                else map(_one_target, pooled)
            )
            got = {
                (t[0], t[1]): _one_target(t)
                for t in targets
                if (t[0], t[1]) in l0_rows
            }
            for t, r in zip(pooled, pooled_iter):
                got[(t[0], t[1])] = r
            responses = [got[(t[0], t[1])] for t in targets]
        if mesh_responses is not None:
            # mesh-served and other responses in sorted target order
            by_key = dict(mesh_responses)
            by_key.update(
                {(t[0], t[1]): r for t, r in zip(targets, responses)}
            )
            responses = [by_key[k] for k in sorted(by_key)]
        if sp is not None:
            sp.note(targets=len(targets), responses=len(responses))
        return responses

    @staticmethod
    def _selected_idx(shard, payload, ds: str) -> list[int]:
        wanted = payload.sample_names.get(ds, [])
        universe = shard.meta.get("sample_names", [])
        name_to_idx = {s: k for k, s in enumerate(universe)}
        return [name_to_idx[s] for s in wanted if s in name_to_idx]

    @staticmethod
    def _wants_planes(payload) -> bool:
        """Queries whose response READS genotype planes: the selected-
        samples leaf, or sample-hit extraction on record/aggregated
        granularity with details (materialize's extraction block needs
        include_details). Every other query never touches the planes and
        takes the (micro-batched) match-only path."""
        return payload.selected_samples_only or (
            payload.include_samples
            and payload.include_details
            and payload.requested_granularity in ("record", "aggregated")
        )

    def _fused_selected(
        self, shard, dindex, planes, spec_base, payload, selected_idx
    ):
        """ONE-launch match + plane reduction via the fused kernel.

        Returns (rows, (pc_call, pc_tok, or_words)) for
        materialize_response, or None when this query takes the split
        path: an N-wildcard ref (regex semantics, host only) or window /
        record overflow (the uncapped host matcher then answers, the
        match kernel's overflow contract). A failed launch raises: the
        split path never hides the kernel."""
        if not self._device_ref_ok(payload, spec_base):
            return None
        eng = self.config.engine
        if selected_idx is not None:
            mask = sample_mask_words(selected_idx, planes.n_words)
        else:
            mask = np.full(planes.n_words, 0xFFFFFFFF, np.uint32)
        res = run_selected_scattered(
            dindex,
            planes,
            [spec_base],
            mask[None, :],
            window_cap=eng.window_cap,
            record_cap=eng.record_cap,
            with_counts=selected_idx is not None and planes.has_counts,
        )
        if res.overflow[0]:
            return None
        keep = res.rows[0] >= 0
        rows = res.rows[0][keep].astype(np.int64)
        fused = (res.pc_call[0][keep], res.pc_tok[0][keep], res.or_words[0])
        return rows, fused

    @staticmethod
    def _device_ref_ok(payload, spec_base) -> bool:
        """Device row-matching is exact for selected-samples queries unless
        the query ref carries an N wildcard (regex semantics, host only)."""
        if not payload.selected_samples_only:
            return True
        ref = spec_base.reference_bases
        return ref is None or "N" not in ref.upper()
