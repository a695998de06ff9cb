"""VariantEngine: the query orchestrator.

Counterpart of ``sbeacon_tpu/engine.py``. ``_blob_eq``,
``host_match_rows`` and ``materialize_response`` (with their numpy
helpers) are copies of the JAX package's. ``VariantEngine`` serves four
device legs:

- single dataset: ``search`` -> ``_search`` -> ``_device_rows`` -> the
  micro-batcher -> ``run_queries_auto`` -> the scatter match kernel ->
  ``materialize_response``;
- several datasets on a mesh of two or more devices (``use_mesh``,
  the JAX engine's gate): ``_search`` -> ``_mesh_ready`` (the
  ``parallel.mesh.StackedIndex`` over every loaded shard, built on the
  request path and cached until a publish) -> ``_mesh_search`` -> ONE
  ``sharded_query`` per request, the stacked query kernel on each mesh
  device; a selected-samples request on a stack with planes takes
  ``sharded_selected_query``, the stacked selected kernel with its plane
  reduction, and materialises through ``materialize_response(fused=)``.
  The mesh lists every visible CUDA device (``parallel.mesh.
  mesh_devices``), so one card keeps serving through the fused stack;
- several datasets otherwise (``fused_dispatch``): ``_search`` ->
  ``_fused_multi_rows`` -> ONE micro-batcher submission against the
  ``FusedDeviceIndex`` stacked over every shard -> the bisection query
  kernel; the stack is built off the request path once two or more
  shards are loaded, and until it is ready each dataset takes its own
  scatter launch (the thread-scatter leg);
- requests that read genotype planes (the selected-samples leaf, and
  sample-hit extraction on record/aggregated granularity) on a shard
  whose planes are on the device (``device_planes``): ``_one_target`` ->
  ``_fused_selected`` -> ``run_selected_scattered`` -> the fused
  match + planes kernel, one launch that hands ``materialize_response``
  its rows, per-row popcounts and sample-hit words. When that query
  overflows, or its ref has an N wildcard, its rows come from the split
  path and ``materialize_response(plane_index=)`` reads the planes with
  the plane-stats kernel.

A query whose window exceeds ``window_cap`` or whose matches exceed
``record_cap`` falls back to ``host_match_rows``, a vectorised numpy
twin of the kernels with no caps and byte-exact allele comparison.

A failed mesh build, upload or launch raises on the request, where the
JAX engine logs it and falls back to thread scatter; a dataset that
arrived after the stack was built is served by the other legs.

Not ported yet, and refused when switched on: the response cache; the
L0 delta tail is absent as well.
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
from .index.columnar import FLAG, VariantIndexShard
from .ops import (
    FusedDeviceIndex,
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
from .telemetry import percentiles
from .utils.chrom import chromosome_code

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


#: EngineConfig switches for features this package has not ported yet
_UNPORTED = ("response_cache",)


class VariantEngine:
    """Holds device-resident indexes and answers variant queries.

    ``device`` defaults to the GPU; the constructor raises when no GPU
    is present unless the caller passes ``device="cpu"``, where every
    kernel runs its plain-PyTorch twin.
    """

    def __init__(self, config: BeaconConfig | None = None, device=None):
        self.config = config or BeaconConfig()
        eng = self.config.engine
        on = [name for name in _UNPORTED if getattr(eng, name)]
        if on:
            raise NotImplementedError(
                "EngineConfig options not ported to the PyTorch engine "
                f"yet: {', '.join(on)}"
            )
        self.device = resolve_device(device)
        # (dataset_id, vcf_location) -> (shard, ScatterDeviceIndex,
        # PlaneDeviceIndex | None)
        self._indexes: dict[tuple[str, str], tuple] = {}
        self._lock = threading.Lock()
        # device bytes of plane uploads in flight, by reservation token:
        # the budget gate counts them with the resident planes
        self._plane_reserved: dict = {}
        # sorted serving list, rebuilt copy-on-write at every publish so
        # the query path never iterates a dict an ingest is mutating
        self._serve_list: list = []
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
        # host materialisation timing (the post-fetch stage)
        self._mat_lock = threading.Lock()
        self._mat_ms: deque = deque(maxlen=eng.timing_window)
        #: queries answered by host_match_rows after a device overflow
        self.host_fallbacks = 0
        # fused multi-dataset stack (FusedDeviceIndex over every loaded
        # shard), rebuilt off the request path after each publish:
        # _fused_state is (findex, key -> shard id, key -> shard), or
        # None while no stack serves; a build only publishes if no
        # add_index happened since its inputs were snapshotted
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
        # every loaded shard), rebuilt on the request path after a
        # publish: _mesh_state is (mesh, stacked, blocks, key -> stack
        # position, key -> shard, key -> planes), or None while no mesh
        # serves (use_mesh off, fewer than two mesh devices or shards)
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

    # -- index management ---------------------------------------------------

    def add_index(self, shard: VariantIndexShard) -> None:
        """Build the shard's device index and its device planes, then
        publish them. A device failure (index build or plane upload)
        raises: serving never moves to the host on its own. Only the
        plane budget keeps a plane set on the host."""
        key = (
            shard.meta.get("dataset_id", ""),
            shard.meta.get("vcf_location", ""),
        )
        dindex = make_device_index(shard, self.device)
        planes = self._build_planes(key, shard)
        with self._lock:
            self._publish_locked(key, (shard, dindex, planes))
            # the upload's reservation turns into residency in the same
            # critical section: never counted twice, never nowhere
            self._plane_reserved.pop(
                getattr(planes, "_hbm_reservation", None), None
            )

    def _publish_locked(self, key, triple) -> None:
        """Publish ``triple`` under ``key`` and rebuild the serving list;
        the fused and mesh stacks no longer cover this shard snapshot."""
        self._indexes[key] = triple
        self._serve_list = [
            (ds, vcf, t) for (ds, vcf), t in sorted(self._indexes.items())
        ]
        self._fused_dirty = True
        self._fused_gen += 1
        self._mesh_dirty = True

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
        """Sorted ``[((dataset_id, vcf_location), shard), ...]`` under
        the publish lock: the dispatch tier builds its stack from this
        instead of iterating ``_indexes`` mid-ingest."""
        with self._lock:
            return [(k, v[0]) for k, v in sorted(self._indexes.items())]

    def index_snapshot(self) -> list:
        """Sorted ``[((dataset_id, vcf_location), shard, planes), ...]``
        under the publish lock: :meth:`shard_snapshot` plus each key's
        device plane index of the same publish."""
        with self._lock:
            return [(k, v[0], v[2]) for k, v in sorted(self._indexes.items())]

    def base_fingerprint(self) -> str:
        """Identity of the published base shards, the JAX package's
        base-fingerprint string: ``ds|vcf|variant_count|call_count|
        n_rows`` per key, sorted, joined by ``&``. The dispatch tier keys
        its staleness on it."""
        with self._lock:
            items = sorted(self._indexes.items())
        return "&".join(
            f"{ds}|{vcf}|{s.meta.get('variant_count')}"
            f"|{s.meta.get('call_count')}|{s.n_rows}"
            for (ds, vcf), (s, _d, _p) in items
        )

    def index_fingerprint(self) -> str:
        """Identity of the whole served data set. This package has no
        delta tail yet, so it equals :meth:`base_fingerprint`."""
        return self.base_fingerprint()

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
        return sorted({ds for ds, _vcf, _t in self._serve_list})

    @property
    def batcher(self):
        """The serving micro-batcher (None when microbatch is off)."""
        return self._batcher

    def indexes_for(self, dataset_ids: list[str]):
        """Every serving (shard, index, planes) triple for the datasets
        (all of them for an empty list), in sorted key order; planes is
        None where the shard's planes are not on the device."""
        for ds, vcf, triple in self._serve_list:
            if not dataset_ids or ds in dataset_ids:
                yield ds, vcf, triple

    def stage_timing(self) -> dict:
        """The batcher's stage quantiles (when it serves) plus host
        materialisation."""
        out: dict = {}
        if self._batcher is not None:
            out.update(self._batcher.timing_summary())
        with self._mat_lock:
            out["materialize_ms"] = percentiles(self._mat_ms)
        return out

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
        return responses

    # -- query path ---------------------------------------------------------

    def search(self, payload: VariantQueryPayload) -> list[VariantSearchResponse]:
        """One response per (dataset, vcf), in sorted key order."""
        return self._search(payload)

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

    def _search(self, payload: VariantQueryPayload):
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

        # the mesh leg serves the targets whose shard is the one its
        # stack was built from; a dataset that arrived after the build
        # (a racing publish) takes the legs below
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
                        return list(mesh_responses.values())

        # cross-shard fused dispatch: ONE stacked-index launch answers
        # this query for every covered target; uncovered targets take
        # their own path inside _one_target
        pre_rows = (
            self._fused_multi_rows(targets, spec_base, payload)
            if len(targets) > 1
            else None
        )

        def _one_target(target):
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
            elif rows is None and payload.selected_samples_only:
                # selected-samples leaf: device row matching unless the
                # ref carries an N wildcard (regex semantics, host
                # only); counting is sample-restricted in
                # materialize_response via the genotype bit planes
                if self._device_ref_ok(payload, spec_base):
                    rows = self._device_rows(
                        shard, dindex, spec_base, ref_wildcard=True
                    )
                else:
                    rows = host_match_rows(
                        shard, spec_base, ref_wildcard=True
                    )
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
        else:
            # per-dataset scatter: overlaps the per-shard device
            # round-trips instead of serialising them
            responses = list(self._scatter.map(_one_target, targets))
        if mesh_responses is not None:
            # mesh-served and other responses in sorted target order
            by_key = dict(mesh_responses)
            by_key.update(
                {(t[0], t[1]): r for t, r in zip(targets, responses)}
            )
            responses = [by_key[k] for k in sorted(by_key)]
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
