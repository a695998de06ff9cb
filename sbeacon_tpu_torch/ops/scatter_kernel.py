"""Scattered-window variant-query kernels: the match and the fused
match + genotype planes.

Counterpart of ``sbeacon_tpu/ops/scatter_kernel.py`` (``ScatterDeviceIndex``,
``_tier_caps``, ``_static_seg_k``, ``_launch_tier``,
``run_queries_scattered``, ``SelectedResults``,
``run_selected_scattered``) with the XLA programs
``_scatter_core`` / ``_scatter_batch`` / ``_scatter_many`` replaced by
the hand-written CUDA kernel ``csrc/scatter_match.cu`` and
``_selected_batch`` by ``csrc/scatter_selected.cu`` (both include the
window match of ``csrc/scatter_core.cuh``).

The index columns are bit-packed from 16 int32 rows down to 8 (pos,
rec_end, ref_hash, alt_hash, packed lens, packed flags+repeat_k+record
chaining, ac, an) and laid out tile-major, ``tiles[t] = packed[:, t*T :
(t+1)*T]`` with shape ``[n_tiles, 8, T]``, on the device the caller
names. A query whose capped window is ``cap`` rows wide gathers
``C = cap//T + 1`` consecutive tiles from ``lo // T``; batches split
into window-cap tiers so point queries never pay a wide bracket's
gather. Each (tier, exact) split of a batch is ONE kernel launch over
all its chunk-padded slots (the JAX package's ``lax.map`` over chunks
is the grid axis here).

``scatter_match`` is the match kernel's wrapper: on a CUDA tensor it
launches the kernel (or raises), on a CPU tensor it runs the
plain-PyTorch twin ``scatter_core_reference``, an op-by-op mirror of
``_scatter_core`` including both of its first-match forms. Every CUDA
launch adds one to the ``scatter_match`` launch count
(``scatter_match_launches``). ``scatter_selected`` is the fused kernel's
wrapper, by the same rule, with the twin ``scatter_selected_reference``
(an op-by-op mirror of ``_selected_batch``) and the launch count
``scatter_selected_launches``. ``device_time_probe`` times the match
kernel on a query mix (the JAX package's probe, on CUDA events).

Lossless bit-packing, by two guards: row alt_len clamps to 0xFFFF and
ref_len to 0x1FFF in the packed matrix, ``pack_q8`` host-flags any query
whose length fields could see the clamp, and any row that was clamped
carries ROW_CLAMPED, which overflows every query whose window contains
it. Either way the affected query takes the uncapped host path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..index.columnar import FLAG, INT32_MAX, VariantIndexShard
from ..telemetry import launch_count, note_device_stage, record_device_launch
from . import _build, timing
from .kernel import (
    MODE_ANY_BASE,
    MODE_EXACT,
    QueryResults,
    VT_CNV,
    VT_DEL,
    VT_DUP,
    VT_DUP_TANDEM,
    VT_INS,
    _PAD_FILLS,
    _SMEM_MAX,
    _wrap32,
    encode_queries,
)
from .plane_kernel import or_reduce, popcount32
from .query_pack import (
    PM_CNV,
    PM_DUPT,
    PM_INS,
    Q_ALT_HASH,
    Q_END_MAX,
    Q_END_MIN,
    Q_HI,
    Q_LENS,
    Q_LO,
    Q_META,
    Q_REF_HASH,
    pack_q8,
    rows_from_masks,
    stage_symbolic_flags,
    window_bounds,
)

# packed hot-matrix rows
P_POS = 0
P_REC_END = 1
P_REF_HASH = 2
P_ALT_HASH = 3
P_LENS = 4  # alt_len(16, clamped) | ref_len(13, clamped) << 16
P_FLAGS = 5  # FLAG/PM bits(0..18) | (repeat_k+1)(7) << 19 | SAME_PREV << 26
P_AC = 6
P_AN = 7
N_PACKED = 8

SAME_PREV = 1 << 26  # row belongs to the same record as the previous row
# row had ref_len/alt_len clamped in the packed matrix: any query whose
# candidate window contains one overflows to the exact host matcher
ROW_CLAMPED = 1 << 27

_ALT_LEN_CLAMP = 0xFFFF
_REF_LEN_CLAMP = 0x1FFF

# fixed device-batch sizes
CHUNK = 2048
CHUNK_SMALL = 64

# longest record (in SAME_PREV-chained rows minus one) the twin's K-shift
# first-match form handles; longer records take the segmented-scan form
SEG_K_MAX = 8

#: a tile must be a multiple of this many lanes: the fused kernel's
#: block size, and whole 32-lane groups and 16-byte row copies of the
#: match kernel
THREADS = 128
#: shared memory one block of the match kernel may take (the H100's
#: 227 KB, opted into above 48 KB)
_SMEM_LIMIT = 227 * 1024

KERNEL = "scatter_match"
SELECTED_KERNEL = "scatter_selected"


def __getattr__(name: str):
    """``scatter_match_launches`` / ``scatter_selected_launches``: CUDA
    launches of each kernel since the last
    ``telemetry.reset_launch_counts()``."""
    if name == "scatter_match_launches":
        return launch_count(KERNEL)
    if name == "scatter_selected_launches":
        return launch_count(SELECTED_KERNEL)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ScatterDeviceIndex:
    """Non-overlapped packed tiles of one shard, on ``device``.

    ``tiles[t]`` covers global rows ``[t*T, (t+1)*T)``. ``MAX_C`` tail
    padding tiles keep every gather in range. Storage is the packed
    columns verbatim (32 B/row, about 640 MB at 2e7 rows).
    """

    MAX_C = 17  # supports caps up to 2048 lanes at T=128

    def __init__(
        self, shard: VariantIndexShard, device, tile: int = 128
    ):
        if tile % THREADS:
            raise ValueError(f"tile must be a multiple of {THREADS} lanes")
        self.tile = tile
        self.device = torch.device(device)
        n = shard.n_rows
        c = shard.cols
        n_tiles = n // tile + 1 + self.MAX_C
        L = n_tiles * tile
        packed = np.empty((N_PACKED, L), dtype=np.int32)

        def fill(row, values, pad):
            packed[row, :n] = values
            packed[row, n:] = pad

        fill(P_POS, c["pos"], _PAD_FILLS["pos"])
        fill(P_REC_END, c["rec_end"], _PAD_FILLS["rec_end"])
        fill(P_REF_HASH, c["ref_hash"], 0)
        fill(P_ALT_HASH, c["alt_hash"], 0)
        lens = np.minimum(
            c["alt_len"].astype(np.int64), _ALT_LEN_CLAMP
        ) | (
            np.minimum(c["ref_len"].astype(np.int64), _REF_LEN_CLAMP) << 16
        )
        fill(P_LENS, lens.astype(np.int32), 0)
        flags = stage_symbolic_flags(c["flags"], c["alt_prefix"])
        k1 = np.clip(c["ref_repeat_k"].astype(np.int64) + 1, 0, 127)
        flags |= k1 << 19
        clamped = (c["ref_len"].astype(np.int64) > _REF_LEN_CLAMP) | (
            c["alt_len"].astype(np.int64) > _ALT_LEN_CLAMP
        )
        flags |= np.where(clamped, np.int64(ROW_CLAMPED), 0)
        rec = c["rec_id"]
        same = np.zeros(n, dtype=np.int64)
        if n > 1:
            same[1:] = (rec[1:] == rec[:-1]).astype(np.int64)
        flags |= same * SAME_PREV
        fill(P_FLAGS, flags.astype(np.int32), 0)
        fill(P_AC, c["ac"], 0)
        fill(P_AN, c["an"], 0)

        # longest SAME_PREV run = (max rows per record) - 1: the twin's
        # K-shift first-match form applies when it is small
        z = np.flatnonzero(
            np.concatenate(([0], same.astype(np.int8), [0])) == 0
        )
        self.seg_k = int(np.diff(z).max()) - 1

        # tile-major layout: tiles[t] = packed[:, t*T : (t+1)*T]
        host = np.ascontiguousarray(
            packed.reshape(N_PACKED, n_tiles, tile).transpose(1, 0, 2)
        )
        del packed
        self.tiles = torch.from_numpy(host).to(self.device)  # [n_tiles, 8, T]
        self.n_rows = n
        self.n_tiles = n_tiles
        self.shard = shard
        self.pos_host = c["pos"]
        self.offsets_host = shard.chrom_offsets.astype(np.int64)

    def nbytes(self) -> int:
        return self.tiles.numel() * 4


def _sum32(x: torch.Tensor) -> torch.Tensor:
    """Row sums [B, N] -> [B, 1] int32, wrapping like an int32 reduce."""
    return _wrap32(x.sum(dim=1, keepdim=True, dtype=torch.int64))


def _shift_lanes(x: torch.Tensor, k: int) -> torch.Tensor:
    """Lane i of the result is lane i-k of ``x`` (zeros shifted in)."""
    span = x.shape[1]
    k = min(k, span)
    zeros = torch.zeros((x.shape[0], k), dtype=x.dtype, device=x.device)
    return torch.cat([zeros, x[:, : span - k]], dim=1)


def _scatter_core_parts(
    tiles, tile_ids, qarr, *, T, CAP, C=None, exact_only=False, seg_k=None
):
    """The body of ``scatter_core_reference``, returning what JAX's
    ``_scatter_core`` returns but its unused ``lo``: ``(agg, masks, m_i,
    win, gidx)``. m_i/win/gidx let the selected-samples twin reduce the
    genotype planes over the same gathered window (one source of truth
    for the predicate stack)."""
    i32 = torch.int32
    dev = tiles.device
    if C is None:
        C = CAP // T + 1
    span = C * T
    n_tiles = tiles.shape[0]
    # out-of-range tile ids clamp like an XLA gather
    idx = (
        tile_ids[:, None] + torch.arange(C, dtype=i32, device=dev)[None, :]
    ).clamp(0, n_tiles - 1)
    gat = tiles[idx.long()]  # [B, C, 8, T]
    win = gat.permute(0, 2, 1, 3).reshape(-1, N_PACKED, span)
    row = lambda r: win[:, r, :]  # [B, C*T]
    q = lambda f: qarr[:, f : f + 1]  # [B, 1]

    lo = q(Q_LO)
    hi = q(Q_HI)
    gidx = tile_ids[:, None] * T + torch.arange(span, dtype=i32, device=dev)[None, :]

    meta = q(Q_META)
    ref_wild = meta & 1
    mode = (meta >> 1) & 3
    vt = (meta >> 3) & 7
    ref_len_q = (meta >> 6) & 0x1FFF
    min_len_q = (meta >> 19) & 0x1FFF
    lens_q = q(Q_LENS)
    alt_len_q = lens_q & 0xFFFF
    max_len_q = (lens_q >> 16) & 0xFFFF
    max_len_q = max_len_q.masked_fill(max_len_q == 0xFFFF, int(INT32_MAX))

    b2i = lambda cond: cond.to(i32)
    valid = b2i(gidx >= lo) & b2i(gidx < torch.minimum(hi, lo + CAP))

    rec_end = row(P_REC_END)
    end_ok = b2i(q(Q_END_MIN) <= rec_end) & b2i(rec_end <= q(Q_END_MAX))

    lens = row(P_LENS)
    alt_len = lens & 0xFFFF
    ref_len = (lens >> 16) & 0x1FFF

    ref_ok = b2i(ref_wild != 0) | (
        b2i(row(P_REF_HASH) == q(Q_REF_HASH)) & b2i(ref_len == ref_len_q)
    )
    len_ok = b2i(min_len_q <= alt_len) & b2i(alt_len <= max_len_q)

    flags = row(P_FLAGS)
    f = lambda bit: b2i((flags & bit) != 0)
    exact_ok = b2i(row(P_ALT_HASH) == q(Q_ALT_HASH)) & b2i(
        alt_len == alt_len_q
    )
    if exact_only:
        alt_ok = exact_ok
    else:
        sym = f(FLAG.SYMBOLIC)
        nsym = 1 - sym
        k = ((flags >> 19) & 0x7F) - 1

        del_ok = (sym & (f(FLAG.DEL_PREFIX) | f(FLAG.CN0))) | (
            nsym & b2i(alt_len < ref_len)
        )
        ins_ok = (sym & f(PM_INS)) | (nsym & b2i(alt_len > ref_len))
        dup_ok = (
            sym
            & (
                f(FLAG.DUP_PREFIX)
                | (f(FLAG.CN_PREFIX) & (1 - f(FLAG.CN0)) & (1 - f(FLAG.CN1)))
            )
        ) | (nsym & b2i(k >= 2))
        dupt_ok = (sym & (f(PM_DUPT) | f(FLAG.CN2))) | (nsym & b2i(k == 2))
        cnv_ok = (
            sym
            & (
                f(PM_CNV)
                | f(FLAG.CN_PREFIX)
                | f(FLAG.DEL_PREFIX)
                | f(FLAG.DUP_PREFIX)
            )
        ) | (nsym & (f(FLAG.DOT) | b2i(k >= 1)))
        other_ok = torch.zeros_like(valid)
        type_ok = torch.where(
            vt == VT_DEL,
            del_ok,
            torch.where(
                vt == VT_INS,
                ins_ok,
                torch.where(
                    vt == VT_DUP,
                    dup_ok,
                    torch.where(
                        vt == VT_DUP_TANDEM,
                        dupt_ok,
                        torch.where(vt == VT_CNV, cnv_ok, other_ok),
                    ),
                ),
            ),
        )
        anyb_ok = f(FLAG.SINGLE_BASE)
        alt_ok = torch.where(
            mode == MODE_EXACT,
            exact_ok,
            torch.where(mode == MODE_ANY_BASE, anyb_ok, type_ok),
        )

    m_i = valid & end_ok & ref_ok & len_ok & alt_ok  # [B, C*T] 0/1

    ac = row(P_AC)
    call_count = _sum32(m_i * ac)
    n_variants = _sum32(m_i & b2i(ac != 0))
    n_matched = _sum32(m_i)

    # AN once per record with >= 1 matched row (see the JAX module for
    # the derivation of both forms)
    if seg_k is not None:
        same_prev = f(SAME_PREV)
        same_before = torch.zeros_like(m_i)
        chain = same_prev
        for kk in range(1, seg_k + 1):
            same_before = same_before | (chain & _shift_lanes(m_i, kk))
            if kk < seg_k:
                chain = chain & _shift_lanes(same_prev, kk)
        first_match = m_i & (1 - same_before)
    else:
        seg_begin = (1 - f(SAME_PREV)) | b2i(gidx == lo)
        cs = torch.cumsum(m_i, dim=1, dtype=i32)
        before = cs - m_i
        seg_base = torch.cummax(
            torch.where(seg_begin != 0, before, -1), dim=1
        ).values
        first_match = m_i & b2i(before == seg_base)
    all_alleles = _sum32(first_match * row(P_AN))

    overflow = b2i((hi - lo) > CAP) | b2i(
        _sum32(valid & f(ROW_CLAMPED)) > 0
    )
    zero = torch.zeros_like(overflow)
    agg = torch.cat(
        [
            b2i(call_count > 0),
            call_count,
            n_variants,
            all_alleles,
            n_matched,
            overflow,
            zero,
            zero,
        ],
        dim=1,
    )
    # bit-pack the match mask: [B, C*T] -> [B, C*T/16] words, bit l of
    # word w = window lane w*16 + l
    nw = span // 16
    weights = (1 << torch.arange(16, dtype=i32, device=dev))[None, None, :]
    masks = (m_i.reshape(-1, nw, 16) * weights).sum(dim=2, dtype=i32)
    return agg, masks, m_i, win, gidx


def scatter_core_reference(
    tiles, tile_ids, qarr, *, T, CAP, C=None, exact_only=False, seg_k=None
):
    """Plain-PyTorch twin of the scatter match kernel: an op-by-op
    mirror of ``sbeacon_tpu/ops/scatter_kernel.py::_scatter_core``.

    ``tiles`` int32 [n_tiles, 8, T]; ``tile_ids`` int32 [B]; ``qarr``
    int32 [B, 8] (``pack_q8`` encoding). Returns (agg int32 [B, 8],
    masks int32 [B, C*T/16]). ``seg_k`` selects the K-shift first-match
    form (records of at most seg_k+1 rows); None selects the segmented
    cumsum/cummax form. Runs on whatever device its inputs lie on."""
    agg, masks, _m, _w, _g = _scatter_core_parts(
        tiles, tile_ids, qarr, T=T, CAP=CAP, C=C, exact_only=exact_only,
        seg_k=seg_k,
    )
    return agg, masks


def scatter_match(
    tiles, tile_ids, qarr, *, T, CAP, C=None, exact_only=False, seg_k=None
):
    """The scatter match kernel: (agg, masks, seq) for one tier.

    CUDA tensors launch ``csrc/scatter_match.cu`` on the current stream
    (asynchronously; the outputs are ready when the stream reaches
    them) and record the launch, ``seq`` being its launch record. CPU
    tensors run ``scatter_core_reference`` and ``seq`` is None. Any
    other device, or inputs the kernel does not take, raise."""
    if C is None:
        C = CAP // T + 1
    if tiles.device.type == "cpu":
        agg, masks = scatter_core_reference(
            tiles, tile_ids, qarr, T=T, CAP=CAP, C=C,
            exact_only=exact_only, seg_k=seg_k,
        )
        return agg, masks, None
    if tiles.device.type != "cuda":
        raise ValueError(f"scatter_match runs on cuda or cpu, not {tiles.device}")
    dev = tiles.device
    span = C * T
    b = tile_ids.shape[0]
    for name, x, shape in (
        ("tiles", tiles, (tiles.shape[0], N_PACKED, T)),
        ("tile_ids", tile_ids, (b,)),
        ("qarr", qarr, (b, 8)),
    ):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int32 tensor on {dev}"
            )
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
    lib = _build.load(KERNEL)
    smem = lib.scatter_match_smem(C, T)
    if T % THREADS or C < 1 or smem > _SMEM_LIMIT:
        raise ValueError(
            f"unsupported tier T={T} C={C}: T must be a multiple of "
            f"{THREADS} and the block's {smem} bytes of shared memory at "
            f"most {_SMEM_LIMIT}"
        )
    if tiles.data_ptr() % 16:
        raise ValueError("tiles must start on a 16-byte boundary (bulk copies)")
    agg = torch.empty((b, 8), dtype=torch.int32, device=dev)
    masks = torch.empty((b, span // 16), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        rc = lib.scatter_match_launch(
            tiles.data_ptr(),
            tile_ids.data_ptr(),
            qarr.data_ptr(),
            agg.data_ptr(),
            masks.data_ptr(),
            b,
            tiles.shape[0],
            T,
            C,
            CAP,
            int(bool(exact_only)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"scatter_match launch failed: CUDA error {rc}")
    seq = record_device_launch(
        KERNEL,
        slots=b,
        C=C,
        cap=CAP,
        exact_only=bool(exact_only),
        launch_ms=(time.perf_counter() - t0) * 1e3,
    )
    return agg, masks, seq


def _tier_caps(sindex: ScatterDeviceIndex, window_cap: int) -> list[int]:
    """Window-cap tiers: T, 4T, ... up to the engine's window cap
    (bounded by the MAX_C gather width). Queries run in the smallest
    tier that fits their candidate window."""
    T = sindex.tile
    # the top tier rounds UP to a tile multiple: the gather span is
    # C*T = cap + T lanes, and a non-multiple cap would leave a window
    # starting late in its first tile short of gathered lanes. Queries
    # wider than the caller's window_cap still overflow.
    top = min(-(-window_cap // T) * T, (sindex.MAX_C - 1) * T)
    caps = []
    c = T
    while c < top:
        caps.append(c)
        c *= 4
    caps.append(top)
    return caps


def _static_seg_k(sindex) -> int | None:
    """The K-shift static for this index, or None (scan form) when the
    longest record exceeds the cheap-shift regime."""
    k = getattr(sindex, "seg_k", None)
    return k if k is not None and k <= SEG_K_MAX else None


def _launch_tier(sindex, tile_ids, q8, *, cap, C=None, exact_only=False):
    """One launch for one tier: the queries pad to a multiple of the
    chunk size (CHUNK_SMALL up to 64 queries, else CHUNK) and every
    chunk rides the same launch. Returns (agg, masks, seq) on the
    index's device, shaped [padded, ...]. ``C=1`` is the single-tile
    fast tier."""
    b = len(tile_ids)
    nslots = CHUNK_SMALL if b <= CHUNK_SMALL else CHUNK
    pad = (-b) % nslots
    if pad:
        tile_ids = np.concatenate([tile_ids, np.zeros(pad, np.int32)])
        q8 = np.concatenate([q8, np.zeros((pad, 8), np.int32)])
    dev = sindex.device
    agg, masks, seq = scatter_match(
        sindex.tiles,
        torch.from_numpy(np.ascontiguousarray(tile_ids)).to(dev),
        torch.from_numpy(np.ascontiguousarray(q8)).to(dev),
        T=sindex.tile,
        CAP=cap,
        C=C,
        exact_only=exact_only,
        seg_k=_static_seg_k(sindex),
    )
    note_device_stage(seq, specs_real=b, nslots=nslots)
    return agg, masks, seq


def run_queries_scattered(
    sindex: ScatterDeviceIndex,
    queries,
    *,
    window_cap: int | None = None,
    record_cap: int = 1024,
    with_rows: bool = True,
) -> QueryResults:
    """Execute a query batch via the scatter match kernel.

    Aggregates + matched row ids; ``overflow`` marks queries needing
    the uncapped host path. Queries split across window-cap tiers
    (``_tier_caps``) and exact vs non-exact alt modes; every split is
    launched before anything is fetched, and windows wider than the top
    tier overflow to the host.
    """
    enc = encode_queries(queries) if isinstance(queries, list) else queries
    T = sindex.tile
    window_cap = window_cap or T
    b = len(enc["chrom"])
    if b == 0:
        z = np.zeros(0, np.int32)
        return QueryResults(
            exists=np.zeros(0, bool),
            call_count=z,
            n_variants=z,
            all_alleles_count=z,
            n_matched=z,
            overflow=np.zeros(0, bool),
            rows=np.zeros((0, record_cap), np.int32),
        )
    lo, hi = window_bounds(sindex, enc)
    q8, needs_host = pack_q8(enc, lo, hi)
    tile_ids_all = (lo // T).astype(np.int32)
    caps = _tier_caps(sindex, window_cap)
    width = hi - lo
    # smallest tier that fits; oversize windows run (and overflow) in
    # the top tier so their aggregate slots still exist
    tier_of = np.searchsorted(np.asarray(caps), width, side="left")
    tier_of = np.minimum(tier_of, len(caps) - 1)
    # single-tile fast tier (tier -1): a window wholly inside one tile
    # needs a C=1 gather, half the bytes of the base C=2 tier. Empty
    # windows (hi <= lo) qualify trivially.
    single = (np.maximum(hi, lo + 1) - 1) // T <= tile_ids_all
    tier_of = np.where(single & (tier_of == 0), -1, tier_of)

    agg = np.zeros((b, 8), np.int32)
    rows = (
        np.full((b, record_cap), -1, np.int32)
        if with_rows
        else np.zeros((b, 0), np.int32)
    )
    # each tier further splits exact-mode queries from the rest so the
    # dominant point-lookup shape runs the exact-only specialisation
    is_exact = enc["alt_mode"] == MODE_EXACT
    launched = []
    for ti, cap in [(-1, T)] + list(enumerate(caps)):
        in_tier = tier_of == ti
        for exact in (True, False):
            sel = np.flatnonzero(in_tier & (is_exact == exact))
            if not len(sel):
                continue
            a_dev, m_dev, seq = _launch_tier(
                sindex,
                tile_ids_all[sel],
                q8[sel],
                cap=cap,
                C=1 if ti == -1 else None,
                exact_only=exact,
            )
            launched.append((sel, a_dev, m_dev, seq))
    if launched:
        t_fetch = time.perf_counter()
        fetched = [
            (a.cpu().numpy(), m.cpu().numpy() if with_rows else None)
            for _s, a, m, _q in launched
        ]
        fetch_ms = (time.perf_counter() - t_fetch) * 1e3
        for (sel, _ad, _md, seq), (a, masks) in zip(launched, fetched):
            note_device_stage(seq, fetch_ms=fetch_ms)
            agg[sel] = a[: len(sel)]
            if with_rows:
                base_rows = tile_ids_all[sel].astype(np.int64) * T
                rows[sel] = rows_from_masks(
                    masks[: len(sel)], base_rows, record_cap
                )

    # overflow honours the CALLER's window_cap, not the tile-rounded
    # top tier
    overflow = (
        (agg[:, 5] > 0)
        | (width > min(window_cap, caps[-1]))
        | needs_host
    )
    return QueryResults(
        exists=agg[:, 0] > 0,
        call_count=agg[:, 1],
        n_variants=agg[:, 2],
        all_alleles_count=agg[:, 3],
        n_matched=agg[:, 4],
        overflow=overflow,
        rows=rows,
    )


def scatter_selected_reference(
    tiles,
    gt,
    gt2,
    tok1,
    tok2,
    tile_ids,
    qarr,
    mask,
    *,
    T,
    CAP,
    C=None,
    exact_only=False,
    R=64,
    with_counts=False,
    seg_k=None,
):
    """Plain-PyTorch twin of the fused match + planes kernel: an
    op-by-op mirror of ``sbeacon_tpu/ops/scatter_kernel.py::
    _selected_batch``.

    The match of ``scatter_core_reference``; the first R matched lanes
    by a stable argsort; their plane rows gathered, masked per query
    (``mask`` int32 [B, W]) and popcounted; the sample-hit OR over the
    ``or_sel`` rows from the same forward and backward segmented scans,
    in int32 with wraparound. Returns (agg [B, 8], rows [B, R] global row
    ids (-1 pad), pc_call [B, R], pc_tok [B, R], or_words [B, W]), all
    int32. One deliberate difference: the pad lanes of pc_call/pc_tok
    are 0, where the JAX program writes row 0's popcounts (its pad lanes
    gather row 0; no caller reads them)."""
    i32 = torch.int32
    agg, _masks, m_i, win, gidx = _scatter_core_parts(
        tiles, tile_ids, qarr, T=T, CAP=CAP, C=C, exact_only=exact_only,
        seg_k=seg_k,
    )
    # top-R matched lanes, ascending (a stable sort keeps lane order)
    order = torch.argsort(1 - m_i, dim=1, stable=True)[:, :R]
    matched = torch.gather(m_i, 1, order) != 0  # [B, R]
    rows = torch.where(matched, torch.gather(gidx.expand_as(m_i), 1, order), -1)
    take = lambda r: torch.gather(win[:, r, :], 1, order)
    ac_r = take(P_AC)
    flags_r = take(P_FLAGS)
    # record segments within the window: cumsum of the SAME_PREV breaks
    seg_id = torch.cumsum(
        1 - ((win[:, P_FLAGS, :] & SAME_PREV) != 0).to(i32), dim=1, dtype=i32
    )
    rec_r = torch.gather(seg_id, 1, order)

    safe = rows.long().clamp(0, gt.shape[0] - 1)
    m = mask[:, None, :]  # [B, 1, W]
    g = gt[safe] & m  # [B, R, W]
    pcw = lambda x: popcount32(x).sum(dim=-1).to(i32)
    pc_gt = pcw(g)
    if with_counts:
        pc_call = pc_gt + pcw(gt2[safe] & m)
        pc_tok = pcw(tok1[safe] & m) + pcw(tok2[safe] & m)
        rc = torch.where((flags_r & FLAG.AC_INFO) != 0, ac_r, pc_call)
    else:
        pc_call = pc_gt
        pc_tok = torch.zeros_like(pc_gt)
        rc = ac_r
    mi = matched.to(i32)
    rc = rc * mi
    pc_call = pc_call * mi
    pc_tok = pc_tok * mi

    # or_sel == (record index >= k0) for matched lanes: the segmented
    # forward/backward scans of the JAX program
    rec_eff = torch.where(matched, rec_r, -2)
    ones = torch.ones_like(matched[:, :1])
    first = matched & torch.cat([ones, rec_eff[:, 1:] != rec_eff[:, :-1]], 1)
    c = _wrap32(torch.cumsum(rc.long(), dim=1))
    before = _wrap32(c.long() - rc.long())
    base = torch.cummax(torch.where(first, before, -1), dim=1).values
    fwd_any = _wrap32(c.long() - base.long()) > 0
    rc_f = torch.flip(rc, [1])
    rec_f = torch.flip(rec_eff, [1])
    first_f = torch.flip(matched, [1]) & torch.cat(
        [ones, rec_f[:, 1:] != rec_f[:, :-1]], 1
    )
    c_f = _wrap32(torch.cumsum(rc_f.long(), dim=1))
    base_f = torch.cummax(
        torch.where(first_f, _wrap32(c_f.long() - rc_f.long()), -1), dim=1
    ).values
    bwd_any = torch.flip(_wrap32(c_f.long() - base_f.long()) > 0, [1])
    or_sel = matched & ((base > 0) | fwd_any | bwd_any)
    or_words = or_reduce(
        torch.where(or_sel[:, :, None], g, torch.zeros_like(g)), 1
    )  # [B, W]
    return agg, rows, pc_call, pc_tok, or_words


def scatter_selected(
    tiles,
    gt,
    gt2,
    tok1,
    tok2,
    tile_ids,
    qarr,
    mask,
    *,
    T,
    CAP,
    C=None,
    exact_only=False,
    R=64,
    with_counts=False,
    seg_k=None,
):
    """The fused match + planes kernel: (agg, rows, pc_call, pc_tok,
    or_words, seq) for one tier.

    CUDA tensors launch ``csrc/scatter_selected.cu`` on the current
    stream (asynchronously) and record the launch, ``seq`` being its
    launch record. CPU tensors run ``scatter_selected_reference`` and
    ``seq`` is None. Any other device, or inputs the kernel does not
    take, raise. Without counts the caller passes ``gt`` for the three
    count planes."""
    if C is None:
        C = CAP // T + 1
    if tiles.device.type == "cpu":
        out = scatter_selected_reference(
            tiles, gt, gt2, tok1, tok2, tile_ids, qarr, mask, T=T, CAP=CAP,
            C=C, exact_only=exact_only, R=R, with_counts=with_counts,
            seg_k=seg_k,
        )
        return (*out, None)
    if tiles.device.type != "cuda":
        raise ValueError(
            f"scatter_selected runs on cuda or cpu, not {tiles.device}"
        )
    dev = tiles.device
    span = C * T
    b = tile_ids.shape[0]
    n_plane, w = gt.shape
    for name, x, shape in (
        ("tiles", tiles, (tiles.shape[0], N_PACKED, T)),
        ("gt", gt, (n_plane, w)),
        ("gt2", gt2, (n_plane, w)),
        ("tok1", tok1, (n_plane, w)),
        ("tok2", tok2, (n_plane, w)),
        ("tile_ids", tile_ids, (b,)),
        ("qarr", qarr, (b, 8)),
        ("mask", mask, (b, w)),
    ):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int32 tensor on {dev}"
            )
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
    lib = _build.load(SELECTED_KERNEL)
    smem = lib.scatter_selected_smem(T, C, R, w)
    if (
        T % THREADS or C < 1 or not 1 <= R <= span or w < 1
        or smem > _SMEM_MAX
    ):
        raise ValueError(
            f"unsupported tier T={T} C={C} R={R} W={w}: T must be a "
            f"multiple of {THREADS}, 1 <= R <= C*T, and the block's "
            f"{smem} bytes of shared memory at most {_SMEM_MAX}"
        )
    agg = torch.empty((b, 8), dtype=torch.int32, device=dev)
    rows = torch.empty((b, R), dtype=torch.int32, device=dev)
    pc_call = torch.empty((b, R), dtype=torch.int32, device=dev)
    pc_tok = torch.empty((b, R), dtype=torch.int32, device=dev)
    or_words = torch.empty((b, w), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        rc = lib.scatter_selected_launch(
            tiles.data_ptr(),
            gt.data_ptr(),
            gt2.data_ptr(),
            tok1.data_ptr(),
            tok2.data_ptr(),
            tile_ids.data_ptr(),
            qarr.data_ptr(),
            mask.data_ptr(),
            agg.data_ptr(),
            rows.data_ptr(),
            pc_call.data_ptr(),
            pc_tok.data_ptr(),
            or_words.data_ptr(),
            b,
            tiles.shape[0],
            T,
            C,
            CAP,
            int(bool(exact_only)),
            R,
            w,
            n_plane,
            int(bool(with_counts)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"scatter_selected launch failed: CUDA error {rc}")
    seq = record_device_launch(
        SELECTED_KERNEL,
        slots=b,
        C=C,
        cap=CAP,
        R=R,
        exact_only=bool(exact_only),
        with_counts=bool(with_counts),
        launch_ms=(time.perf_counter() - t0) * 1e3,
    )
    return agg, rows, pc_call, pc_tok, or_words, seq


class SelectedResults:
    """run_selected_scattered outputs: QueryResults fields + the fused
    per-row plane reductions (aligned with ``rows``)."""

    __slots__ = (
        "exists",
        "call_count",
        "n_variants",
        "all_alleles_count",
        "n_matched",
        "overflow",
        "rows",
        "pc_call",
        "pc_tok",
        "or_words",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


def run_selected_scattered(
    sindex: ScatterDeviceIndex,
    pindex,
    queries,
    mask_words: np.ndarray,
    *,
    window_cap: int | None = None,
    record_cap: int = 1024,
    with_counts: bool | None = None,
) -> SelectedResults:
    """Selected-samples query batch in ONE kernel launch per split.

    ``pindex``: an ``ops.plane_kernel.PlaneDeviceIndex`` of the SAME
    shard as ``sindex``, on its device. ``mask_words``: uint32 [B, W]
    per-query selected-sample masks (all-ones rows extract the full
    cohort). Tiers and (tier, exact) splits are the match kernel's; each
    split launches at its own size (the JAX package pads to 64-slot
    chunks, whose pad slots it discards, so the outputs are the same),
    and every split is launched before anything is fetched. A query
    whose matched-row count exceeds min(record_cap, its tier cap) reports
    ``overflow`` (its plane outputs would be truncated) and must take
    the host path, exactly like the match kernel's window overflow."""
    enc = encode_queries(queries) if isinstance(queries, list) else queries
    T = sindex.tile
    window_cap = window_cap or T
    b = len(enc["chrom"])
    if with_counts is None:
        with_counts = bool(pindex.has_counts)
    W = pindex.n_words
    mask_words = np.ascontiguousarray(mask_words, dtype=np.uint32)
    if mask_words.shape != (b, W):
        raise ValueError(f"mask_words must be [{b}, {W}]")
    if b == 0:
        z = np.zeros(0, np.int32)
        return SelectedResults(
            exists=np.zeros(0, bool),
            call_count=z,
            n_variants=z,
            all_alleles_count=z,
            n_matched=z,
            overflow=np.zeros(0, bool),
            rows=np.zeros((0, 0), np.int32),
            pc_call=np.zeros((0, 0), np.int32),
            pc_tok=np.zeros((0, 0), np.int32),
            or_words=np.zeros((0, W), np.uint32),
        )
    lo, hi = window_bounds(sindex, enc)
    q8, needs_host = pack_q8(enc, lo, hi)
    tile_ids_all = (lo // T).astype(np.int32)
    caps = _tier_caps(sindex, window_cap)
    width = hi - lo
    tier_of = np.searchsorted(np.asarray(caps), width, side="left")
    tier_of = np.minimum(tier_of, len(caps) - 1)
    single = (np.maximum(hi, lo + 1) - 1) // T <= tile_ids_all
    tier_of = np.where(single & (tier_of == 0), -1, tier_of)

    R_top = min(record_cap, caps[-1])
    agg = np.zeros((b, 8), np.int32)
    rows = np.full((b, R_top), -1, np.int32)
    pc_call = np.zeros((b, R_top), np.int32)
    pc_tok = np.zeros((b, R_top), np.int32)
    or_words = np.zeros((b, W), np.uint32)
    is_exact = enc["alt_mode"] == MODE_EXACT
    dev = sindex.device
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    gt = pindex.gt
    planes = (
        (gt, pindex.gt2, pindex.tok1, pindex.tok2)
        if with_counts
        else (gt, gt, gt, gt)
    )
    launched = []
    for ti, cap in [(-1, T)] + list(enumerate(caps)):
        in_tier = tier_of == ti
        R = min(record_cap, cap)
        for exact in (True, False):
            sel = np.flatnonzero(in_tier & (is_exact == exact))
            if not len(sel):
                continue
            out = scatter_selected(
                sindex.tiles,
                *planes,
                to_dev(tile_ids_all[sel]),
                to_dev(q8[sel]),
                to_dev(mask_words[sel].view(np.int32)),
                T=T,
                CAP=cap,
                C=1 if ti == -1 else None,
                exact_only=exact,
                R=R,
                with_counts=with_counts,
                seg_k=_static_seg_k(sindex),
            )
            launched.append((sel, R, out))
    if launched:
        t_fetch = time.perf_counter()
        fetched = [
            [x.cpu().numpy() for x in out[:5]] for _s, _r, out in launched
        ]
        fetch_ms = (time.perf_counter() - t_fetch) * 1e3
        per_row = W * 4 * (4 if with_counts else 1)
        for (sel, R, out), (a, r, pc, pt, ow) in zip(launched, fetched):
            agg[sel] = a
            rows[sel, :R] = r
            pc_call[sel, :R] = pc
            pc_tok[sel, :R] = pt
            or_words[sel] = ow.view(np.uint32)
            n_read = int((r >= 0).sum())
            note_device_stage(
                out[5], fetch_ms=fetch_ms, plane_rows=n_read,
                plane_bytes=n_read * per_row,
            )

    # a truncated row set would silently under-reduce the planes: the
    # per-tier R bound makes truncation part of the overflow contract
    r_of = np.where(
        tier_of == -1,
        min(record_cap, T),
        np.minimum(record_cap, np.asarray(caps)[np.maximum(tier_of, 0)]),
    )
    overflow = (
        (agg[:, 5] > 0)
        | (width > min(window_cap, caps[-1]))
        | needs_host
        | (agg[:, 4] > r_of)
    )
    return SelectedResults(
        exists=agg[:, 0] > 0,
        call_count=agg[:, 1],
        n_variants=agg[:, 2],
        all_alleles_count=agg[:, 3],
        n_matched=agg[:, 4],
        overflow=overflow,
        rows=rows,
        pc_call=pc_call,
        pc_tok=pc_tok,
        or_words=or_words,
    )


#: window shifts a device time probe cycles through per tier: their
#: gathered tiles together exceed the card's 50 MB L2
PROBE_SHIFTS = 16


def _probe_one_tier(
    sindex, tile_ids, q8, *, cap, C, iters, exact_only=False
) -> tuple[float, int]:
    """(seconds per batch, bytes gathered per batch) for ONE tier batch
    (tile_ids/q8 already nslots-sized): ``iters`` match launches, timed
    with CUDA events behind a spin-kernel hold on a CUDA index
    (``ops.timing.device_ms``), with the host clock around the twin on a
    CPU index.

    The launches cycle through ``PROBE_SHIFTS`` copies of the batch whose
    windows are moved by whole tiles, spread over the index (each slot
    keeps its window width, its queries and its tier), so the gathered
    tiles do not stay in L2, as for random serving traffic. The JAX
    program's drifting carry moved its tile ids in the same way."""
    T = sindex.tile
    nslots = len(tile_ids)
    dev = sindex.device
    seg_k = _static_seg_k(sindex)
    span = sindex.n_tiles - sindex.MAX_C  # tiles a window may start in
    tile_ids = np.asarray(tile_ids, np.int64)
    items = []
    for j in range(PROBE_SHIFTS):
        moved = (tile_ids + j * (span // PROBE_SHIFTS)) % span
        q = np.array(q8, np.int64)
        q[:, Q_LO] += (moved - tile_ids) * T
        q[:, Q_HI] += (moved - tile_ids) * T
        items.append((
            torch.from_numpy(moved.astype(np.int32)).to(dev),
            torch.from_numpy(q.astype(np.int32)).to(dev),
        ))

    def launch(item):
        return scatter_match(
            sindex.tiles, *item, T=T, CAP=cap, C=C, exact_only=exact_only,
            seg_k=seg_k,
        )

    per_call = timing.device_ms if dev.type == "cuda" else timing.host_ms
    reps = max(1, iters // PROBE_SHIFTS)
    seconds = per_call(launch, items, reps=reps) / 1e3
    n_gather_tiles = C if C is not None else cap // T + 1
    gathered = nslots * N_PACKED * n_gather_tiles * T * 4
    return seconds, gathered


def device_time_probe(
    sindex: ScatterDeviceIndex,
    queries,
    *,
    window_cap: int | None = None,
    iters: int = 128,
) -> tuple[float, int]:
    """(seconds per batch on the device, bytes gathered per batch) of the
    match kernel for a query mix.

    Times the SAME tier mix serving runs, as the JAX package's probe
    does: queries whose window sits in one tile are timed in the C=1
    tier, the rest in the windowed tier at ``window_cap`` (rounded up to
    tiles), each split exact against not; every tier is probed as a full
    batch of its own queries cycled to the batch size, and the figures
    are share-weighted. Each tier is ``iters`` back-to-back launches
    timed by CUDA events (``_probe_one_tier``); the JAX package's two-chain
    differencing existed only because its transport's
    ``block_until_ready`` returned early."""
    enc = encode_queries(queries) if isinstance(queries, list) else queries
    T = sindex.tile
    # round UP like _tier_caps does for serving, so the probe times the
    # same gather width serving performs
    cap = min(-(-(window_cap or T) // T) * T, (sindex.MAX_C - 1) * T)
    lo, hi = window_bounds(sindex, enc)
    q8, _nh = pack_q8(enc, lo, hi)
    tile_ids = (lo // T).astype(np.int32)
    b = len(tile_ids)
    nslots = CHUNK_SMALL if b <= CHUNK_SMALL else CHUNK
    single = (np.maximum(hi, lo + 1) - 1) // T <= tile_ids
    is_exact = enc["alt_mode"] == MODE_EXACT

    def cycle(sel):
        reps = -(-nslots // len(sel))
        idx = np.tile(sel, reps)[:nslots]
        return tile_ids[idx], q8[idx]

    per = 0.0
    gathered = 0.0
    for mask, C, tier_cap in ((single, 1, T), (~single, None, cap)):
        for exact in (True, False):
            sel = np.flatnonzero(mask & (is_exact == exact))
            share = len(sel) / b
            if share == 0.0:
                continue
            t_ids, qs = cycle(sel)
            p, g = _probe_one_tier(
                sindex, t_ids, qs, cap=tier_cap, C=C, iters=iters,
                exact_only=exact,
            )
            per += share * p
            gathered += share * g
    return per, int(gathered)
