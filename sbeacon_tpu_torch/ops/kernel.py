"""Query encoding, the bisection kernel's device indexes, and its dispatch.

Counterpart of ``sbeacon_tpu/ops/kernel.py``: ``QuerySpec``,
``encode_queries``, the ``MODE_*`` / ``VT_*`` codes, ``_PAD_FILLS``,
``QueryResults``, the padding helpers (``pad_columns``,
``pad_shard_columns``, ``padded_rows``, ``window_hint_for``,
``bisect_iters``), ``DeviceIndex``, ``FusedDeviceIndex``, the delta
tail's ``L0DeviceIndex`` and ``CompositeL0DeviceIndex``, and
``run_queries``. The XLA program ``_bisect`` / ``_query_one`` /
``_query_batch`` is replaced by the hand-written CUDA kernel
``csrc/bisect_query.cu``; it answers every multi-dataset query against
the fused stack of all warm shards in one launch, and every delta-tail
target the L0 index covers in one launch across keys.

``bisect_query`` is the kernel's wrapper: on a CUDA tensor it launches
the kernel (or raises), on a CPU tensor it runs the plain-PyTorch twin
``query_batch_reference``, an op-by-op mirror of ``_bisect`` and
``_query_one`` (the fixed-depth masked bisection, the ``[B, W]``
gather, the predicate stack, the cumsum/searchsorted first match for AN
and the sort-and-truncate of the matched row ids). Every CUDA launch
adds one to the ``bisect_query`` launch count.

The index columns live on an explicit device as int32 tensors: the 11
``DEVICE_COLUMNS`` stacked into one ``[11, n_pad]`` tensor and
``alt_prefix`` as an ``[n_pad, 4]`` int32 bit pattern (torch has little
uint32 support; XOR, AND and ``== 0`` are the same on the bit pattern).
Each launch record names its index's ``flight_family``: ``fused`` for
the fused stack, ``fused_l0`` for the L0 indexes.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..index.columnar import (
    DEVICE_COLUMNS,
    FLAG,
    INT32_MAX,
    VariantIndexShard,
    fnv1a32,
    pack_prefix16,
    prefix_mask,
    stack_shard_columns,
)
from ..telemetry import launch_count, note_device_stage, record_device_launch
from ..utils.chrom import chromosome_code
from . import _build

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


def encode_queries(
    queries: list[QuerySpec], shard_ids: list[int] | None = None
) -> dict[str, np.ndarray]:
    """Host-side encoding of a query batch into per-field arrays.

    ``shard_ids`` targets each query at one shard segment of a
    :class:`FusedDeviceIndex` (the ``shard`` field selects the row of
    its 2D ``chrom_offsets``); omitted for single-shard indexes."""
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
    if shard_ids is not None:
        enc["shard"] = np.asarray(shard_ids, dtype=np.int32)
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
    # genotype-plane outputs (mesh plane program only; None on every
    # match-only path): per-row masked popcounts aligned with ``rows``
    # and the grp>=k0 sample-hit OR, the materialize_response
    # ``fused=(pc_call, pc_tok, or_words)`` triple, per query
    pc_call: np.ndarray | None = None  # int32[B, record_cap]
    pc_tok: np.ndarray | None = None  # int32[B, record_cap]
    or_words: np.ndarray | None = None  # int32[B, plane_words]


def pad_columns(
    cols: dict[str, np.ndarray], n: int, n_pad: int
) -> dict[str, np.ndarray]:
    """``_PAD_FILLS``-padded copies of a device-column dict (single
    shard or stacked): the one pad-and-fill implementation, so the
    per-shard and fused indexes never drift on pad-row sentinels."""
    if n > n_pad:
        raise ValueError(f"{n} rows > pad target {n_pad}")
    out = {}
    for name, fill in _PAD_FILLS.items():
        col = cols[name]
        padded = np.full((n_pad,) + col.shape[1:], fill, dtype=col.dtype)
        padded[:n] = col
        out[name] = padded
    return out


def pad_shard_columns(
    shard: VariantIndexShard, n_pad: int
) -> dict[str, np.ndarray]:
    """Host-side padded column dict of one shard (``chrom_offsets``
    included), numpy only: the per-dataset rows of the mesh stack."""
    out = pad_columns(shard.cols, shard.n_rows, n_pad)
    out["chrom_offsets"] = shard.chrom_offsets.astype(np.int32)
    return out


def padded_rows(n: int, pad_unit: int) -> int:
    return max(pad_unit, ((n + pad_unit - 1) // pad_unit) * pad_unit)


def window_hint_for(chrom_offsets, floor: int = 256) -> int:
    """Power-of-two window bound from a chromosome segment table.

    A query's candidate range always lies in ONE (shard, chromosome)
    segment (the bisection never leaves ``[seg_lo, seg_hi)``), so the
    widest segment bounds every ``hi - lo``. ``run_queries`` clamps its
    window to this, which never adds an overflow."""
    offs = np.asarray(chrom_offsets)
    widest = (
        int(np.diff(offs, axis=-1).max(initial=0)) if offs.size else 0
    )
    hint = floor
    while hint < widest:
        hint *= 2
    return hint


def bisect_iters(n_pad: int) -> int:
    """Fixed bisection depth covering a padded row count."""
    return max(1, math.ceil(math.log2(n_pad + 1)))


# rows of the stacked column tensor (DEVICE_COLUMNS order; the CUDA
# kernel's C_* constants)
COLUMNS = tuple(DEVICE_COLUMNS)
(
    C_POS,
    C_REC_END,
    C_REF_LEN,
    C_ALT_LEN,
    C_REF_HASH,
    C_ALT_HASH,
    C_REPEAT_K,
    C_FLAGS,
    C_AC,
    C_AN,
    C_REC_ID,
) = range(len(COLUMNS))


def _upload_columns(cols: dict, n: int, n_pad: int, device):
    """(columns int32 [11, n_pad], alt_prefix int32 [n_pad, 4]) on
    ``device``, padded with ``_PAD_FILLS``."""
    padded = pad_columns(cols, n, n_pad)
    ap = padded.pop("alt_prefix").astype(np.uint32, copy=False)
    host = np.stack([padded.pop(name) for name in COLUMNS]).astype(
        np.int32, copy=False
    )
    columns = torch.from_numpy(host).to(device)
    del host
    alt_prefix = torch.from_numpy(ap.view(np.int32)).to(device)
    return columns, alt_prefix


class _BisectIndex:
    """Columns, segment table and static bounds every index of the
    bisection kernel carries; ``arrays`` names the columns as the JAX
    package's index does (views, no copies)."""

    PAD_UNIT = 8192
    #: launch-record family (the JAX flight recorder's program family)
    flight_family = "fused"
    #: the batch carries per-query shard ids (a stacked index)
    stacked = False

    def _place(self, cols, chrom_offsets, n, n_pad, device):
        self.device = torch.device(device)
        self.n_rows = n
        self.n_padded = n_pad
        self.n_iters = bisect_iters(n_pad)
        self.columns, self.alt_prefix = _upload_columns(
            cols, n, n_pad, self.device
        )
        offs = np.ascontiguousarray(chrom_offsets, dtype=np.int32)
        self.chrom_offsets = torch.from_numpy(offs).to(self.device)
        #: the widest (shard, chromosome) segment bounds every
        #: candidate range: run_queries clamps its window_cap to this
        self.window_hint = window_hint_for(offs)
        self.arrays = {
            name: self.columns[i] for i, name in enumerate(COLUMNS)
        }
        self.arrays["alt_prefix"] = self.alt_prefix
        self.arrays["chrom_offsets"] = self.chrom_offsets

    @property
    def offsets(self) -> torch.Tensor:
        """The segment table as the kernel reads it, ``[k, 27]``."""
        return self.chrom_offsets.reshape(-1, self.chrom_offsets.shape[-1])

    def nbytes(self) -> int:
        return (
            self.columns.numel() + self.alt_prefix.numel()
            + self.chrom_offsets.numel()
        ) * 4


class DeviceIndex(_BisectIndex):
    """One shard's device columns, padded to a multiple of ``pad_unit``
    rows (padding rows carry pos=INT32_MAX, so no window selects them;
    ``chrom_offsets`` keeps the real row extents). The serving path
    builds ``ScatterDeviceIndex`` for single shards; this is the k=1
    form of the fused index."""

    def __init__(
        self, shard: VariantIndexShard, device, pad_unit: int | None = None
    ):
        n = shard.n_rows
        n_pad = padded_rows(n, pad_unit or self.PAD_UNIT)
        self.shard = shard
        self.n_shards = 1
        self._place(shard.cols, shard.chrom_offsets, n, n_pad, device)


class FusedDeviceIndex(_BisectIndex):
    """ALL warm shards stacked into one device index for fused dispatch.

    Shard rows stay contiguous and in their original order
    (``index.columnar.stack_shard_columns``); ``chrom_offsets`` becomes
    a ``[k, 27]`` per-shard segment table and each encoded query
    carries a ``shard`` id selecting its row. One ``bisect_query``
    launch then answers (shard, query) pairs against any mix of shards:
    a k-dataset query costs one launch instead of k, and the
    micro-batcher coalesces queries for different datasets into the
    same launch.

    Row ids come back as stacked ids; ``to_local_rows`` maps them back
    to shard-local ids with ``shard_base``. The index holds its own
    column copy (60 B/row; the per-shard scatter indexes stay for
    single-dataset traffic).
    """

    stacked = True

    def __init__(
        self,
        shards: list[VariantIndexShard],
        device,
        pad_unit: int | None = None,
    ):
        cols, chrom_offsets, base = stack_shard_columns(shards)
        n = int(base[-1])
        n_pad = padded_rows(n, pad_unit or self.PAD_UNIT)
        self.n_shards = len(shards)
        self.shard_base = base  # int64[k+1]
        self._place(cols, chrom_offsets, n, n_pad, device)

    def to_local_rows(self, rows: np.ndarray, sid: int) -> np.ndarray:
        """Stacked row ids (already -1-filtered) -> shard-local ids."""
        return rows.astype(np.int64) - int(self.shard_base[sid])


class L0DeviceIndex(FusedDeviceIndex):
    """The delta-tail index (the LSM ``memtable -> L0`` tier), stacked
    over one key's standing delta shards.

    :class:`FusedDeviceIndex`'s layout, with the ``[k, 27]`` segment
    table padded up to a shard-count tier of ``SHARD_TIERS`` with
    all-zero rows (every segment empty, so a pad shard can never match)
    and ``window_hint`` the least power of two from 256 up that holds the
    widest tail shard: a tail shard's candidate range never exceeds its
    row count. JAX pads so that successive tail builds reuse one
    compiled program; the kernel compiles no shapes, and the pad is kept
    so that the segment tables (``chrom_offsets_host``) and the shard
    ids equal the JAX package's. Launches report the ``fused_l0``
    family."""

    flight_family = "fused_l0"

    #: pad-to tiers for the segment table's shard axis
    SHARD_TIERS = (8, 16, 32, 64, 128, 256, 512)

    def __init__(
        self,
        shards: list[VariantIndexShard],
        device,
        pad_unit: int | None = None,
    ):
        cols, chrom_offsets, base = stack_shard_columns(shards)
        n = int(base[-1])
        n_pad = padded_rows(n, pad_unit or self.PAD_UNIT)
        k = len(shards)
        k_pad = next((t for t in self.SHARD_TIERS if k <= t), k)
        co = np.asarray(chrom_offsets, dtype=np.int32)
        if k_pad != k:
            co = np.concatenate(
                [co, np.zeros((k_pad - k, co.shape[1]), np.int32)]
            )
        self.n_shards = k
        self.n_shards_padded = k_pad
        self.shard_base = base  # int64[k+1]
        self._place(cols, co, n, n_pad, device)
        #: host copy of the padded segment table: the composite shifts
        #: and restacks it without reading the device
        self.chrom_offsets_host = co
        widest = max((s.n_rows for s in shards), default=1)
        hint = 256
        while hint < widest:
            hint *= 2
        self.window_hint = hint


class CompositeL0DeviceIndex(_BisectIndex):
    """Per-key L0 blocks assembled into ONE serving index.

    Each covered (dataset, vcf) key keeps a standing
    :class:`L0DeviceIndex` block, so a delta publish to key A restacks
    only key A's block; this class joins the blocks for the single
    launch: their device columns concatenate on the device (no host
    restack of untouched keys), each block's padded segment table
    shifts by the block's row offset and stacks along the shard axis (a
    pad shard's all-zero row shifts to ``[off, off)``: still empty), and
    composite shard ids index the stacked table. ``block_sid_offsets``
    gives each block's first composite shard id; ``to_local_rows`` maps
    stacked rows back as the fused index does. ``window_hint`` is the
    widest block's."""

    flight_family = "fused_l0"
    stacked = True

    def __init__(self, blocks: list[L0DeviceIndex]):
        if not blocks:
            raise ValueError("CompositeL0DeviceIndex needs >= 1 block")
        dev = blocks[0].device
        co_parts: list[np.ndarray] = []
        base_parts: list[np.ndarray] = []
        #: composite sid of each block's shard 0 (block order preserved)
        self.block_sid_offsets: list[int] = []
        row_off = 0
        sid_off = 0
        for b in blocks:
            if b.device != dev:
                raise ValueError("L0 blocks on different devices")
            self.block_sid_offsets.append(sid_off)
            co = b.chrom_offsets_host
            co_parts.append((co.astype(np.int64) + row_off).astype(np.int32))
            sb = np.asarray(b.shard_base, dtype=np.int64)
            # pad shards (sid past the block's real count) clamp to the
            # block's end base: never routed, but index-aligned with the
            # stacked table
            clamp = np.minimum(np.arange(b.n_shards_padded), b.n_shards)
            base_parts.append(sb[clamp] + row_off)
            row_off += b.n_padded
            sid_off += b.n_shards_padded
        self.device = dev
        if len(blocks) == 1:
            self.columns = blocks[0].columns
            self.alt_prefix = blocks[0].alt_prefix
        else:
            self.columns = torch.cat([b.columns for b in blocks], dim=1)
            self.alt_prefix = torch.cat([b.alt_prefix for b in blocks])
        offs = np.ascontiguousarray(np.concatenate(co_parts), np.int32)
        self.chrom_offsets = torch.from_numpy(offs).to(dev)
        self.arrays = {
            name: self.columns[i] for i, name in enumerate(COLUMNS)
        }
        self.arrays["alt_prefix"] = self.alt_prefix
        self.arrays["chrom_offsets"] = self.chrom_offsets
        self.blocks = list(blocks)
        self.n_rows = sum(b.n_rows for b in blocks)
        self.n_padded = row_off
        self.n_iters = bisect_iters(row_off)
        self.n_shards = sum(b.n_shards for b in blocks)
        self.n_shards_padded = sid_off
        self.shard_base = np.concatenate(
            base_parts + [np.asarray([row_off], dtype=np.int64)]
        )
        self.window_hint = max(b.window_hint for b in blocks)

    def to_local_rows(self, rows: np.ndarray, sid: int) -> np.ndarray:
        """Stacked row ids (already -1-filtered) -> shard-local ids."""
        return rows.astype(np.int64) - int(self.shard_base[sid])


# fields of one packed query, int32 [B, N_QFIELDS] (the CUDA kernel's
# QF_* constants); vprefix / vprefix_mask are uint32 bit patterns
(
    QF_CHROM,
    QF_SHARD,
    QF_START_MIN,
    QF_START_MAX,
    QF_END_MIN,
    QF_END_MAX,
    QF_REF_WILD,
    QF_REF_HASH,
    QF_REF_LEN,
    QF_ALT_MODE,
    QF_ALT_HASH,
    QF_ALT_LEN,
    QF_VT_CODE,
    QF_MIN_LEN,
    QF_MAX_LEN,
) = range(15)
QF_VPREFIX = 15  # 4 words
QF_VMASK = 19  # 4 words
N_QFIELDS = 24  # 23 used; rows stay 16-byte aligned
#: aggregate columns of the kernel's output rows
N_AGG = 6

_SCALAR_FIELDS = (
    (QF_CHROM, "chrom"),
    (QF_START_MIN, "start_min"),
    (QF_START_MAX, "start_max"),
    (QF_END_MIN, "end_min"),
    (QF_END_MAX, "end_max"),
    (QF_REF_WILD, "ref_wild"),
    (QF_REF_HASH, "ref_hash"),
    (QF_REF_LEN, "ref_len"),
    (QF_ALT_MODE, "alt_mode"),
    (QF_ALT_HASH, "alt_hash"),
    (QF_ALT_LEN, "alt_len"),
    (QF_VT_CODE, "vt_code"),
    (QF_MIN_LEN, "min_len"),
    (QF_MAX_LEN, "max_len"),
)


def pack_queries(enc: dict[str, np.ndarray], *, fused: bool) -> np.ndarray:
    """An ``encode_queries`` batch as the kernel's int32 [B, N_QFIELDS]
    rows. ``fused`` batches must carry their ``shard`` ids; single-shard
    batches target segment row 0."""
    b = len(enc["chrom"])
    q = np.zeros((b, N_QFIELDS), np.int32)
    for f, name in _SCALAR_FIELDS:
        q[:, f] = enc[name]
    if fused:
        if "shard" not in enc:
            raise ValueError(
                "a FusedDeviceIndex batch must be encoded with shard_ids"
            )
        q[:, QF_SHARD] = enc["shard"]
    q[:, QF_VPREFIX : QF_VPREFIX + 4] = np.ascontiguousarray(
        enc["vprefix"], dtype=np.uint32
    ).view(np.int32)
    q[:, QF_VMASK : QF_VMASK + 4] = np.ascontiguousarray(
        enc["vprefix_mask"], dtype=np.uint32
    ).view(np.int32)
    return q


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (XLA's int32 sum)."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def _bisect_reference(pos, target, lo0, hi0, n_iters, *, upper: bool):
    """Fixed-depth masked bisection over pos[lo0:hi0] (``_bisect``).

    upper=False: first index with pos[idx] >= target (lower bound);
    upper=True: first index with pos[idx] > target (upper bound), so
    target=INT32_MAX cannot wrap. Probes clamp into range like an XLA
    gather; an inactive lane's probe is discarded."""
    n = pos.shape[0]
    lo, hi = lo0, hi0
    for _ in range(n_iters):
        active = lo < hi
        mid = (lo + hi) // 2
        probe = pos[mid.clamp(0, n - 1)]
        less = probe <= target if upper else probe < target
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def query_batch_reference(
    columns, alt_prefix, offsets, qpack, *, window_cap, record_cap, n_iters
):
    """Plain-PyTorch twin of the bisection kernel: an op-by-op mirror of
    ``sbeacon_tpu/ops/kernel.py::_query_one`` over a batch.

    ``columns`` int32 [11, n_pad]; ``alt_prefix`` int32 [n_pad, 4];
    ``offsets`` int32 [k, 27]; ``qpack`` int32 [B, N_QFIELDS]
    (``pack_queries``). Returns int32 [B, N_AGG + R], R =
    min(record_cap, window_cap): per query the aggregates (exists,
    call_count, n_variants, all_alleles_count, n_matched, overflow)
    and then its first R matched stacked row ids, ascending, -1 padded.
    Runs on whatever device its inputs lie on."""
    i32, i64 = torch.int32, torch.int64
    dev = columns.device
    n = columns.shape[1]
    k, n_off = offsets.shape
    W = window_cap
    qv = lambda f: qpack[:, f]  # [B]
    qc = lambda f: qpack[:, f : f + 1]  # [B, 1]

    # segment of the query's (shard, chrom); indices clamp like an XLA
    # gather
    sid = qv(QF_SHARD).to(i64).clamp(0, k - 1)
    chrom = qv(QF_CHROM).to(i64)
    seg_lo = offsets[sid, chrom.clamp(0, n_off - 1)].to(i64)
    seg_hi = offsets[sid, (chrom + 1).clamp(0, n_off - 1)].to(i64)
    pos = columns[C_POS]
    lo = _bisect_reference(pos, qv(QF_START_MIN), seg_lo, seg_hi, n_iters,
                           upper=False)
    hi = _bisect_reference(pos, qv(QF_START_MAX), seg_lo, seg_hi, n_iters,
                           upper=True)

    idxs = lo[:, None] + torch.arange(W, dtype=i64, device=dev)[None, :]
    valid = idxs < hi[:, None]
    safe = idxs.clamp(0, n - 1)
    g = lambda c: columns[c][safe]  # [B, W]

    rec_end = g(C_REC_END)
    end_ok = (qc(QF_END_MIN) <= rec_end) & (rec_end <= qc(QF_END_MAX))
    ref_len = g(C_REF_LEN)
    ref_ok = (qc(QF_REF_WILD) != 0) | (
        (g(C_REF_HASH) == qc(QF_REF_HASH)) & (ref_len == qc(QF_REF_LEN))
    )
    alt_len = g(C_ALT_LEN)
    len_ok = (qc(QF_MIN_LEN) <= alt_len) & (alt_len <= qc(QF_MAX_LEN))

    flags = g(C_FLAGS)
    f = lambda bit: (flags & bit) != 0
    sym = f(FLAG.SYMBOLIC)
    k_rep = g(C_REPEAT_K)

    # symbolic-prefix match: first L bytes of alt equal '<'+variant_type
    ap = alt_prefix[safe]  # [B, W, 4]
    vp = qpack[:, None, QF_VPREFIX : QF_VPREFIX + 4]
    vm = qpack[:, None, QF_VMASK : QF_VMASK + 4]
    pm = (((ap ^ vp) & vm) == 0).all(dim=2)

    del_ok = torch.where(sym, pm | f(FLAG.CN0), alt_len < ref_len)
    ins_ok = torch.where(sym, pm, alt_len > ref_len)
    dup_ok = torch.where(
        sym, pm | (f(FLAG.CN_PREFIX) & ~f(FLAG.CN0) & ~f(FLAG.CN1)),
        k_rep >= 2,
    )
    dupt_ok = torch.where(sym, pm | f(FLAG.CN2), k_rep == 2)
    cnv_ok = torch.where(
        sym,
        pm | f(FLAG.CN_PREFIX) | f(FLAG.DEL_PREFIX) | f(FLAG.DUP_PREFIX),
        f(FLAG.DOT) | (k_rep >= 1),
    )
    other_ok = sym & pm
    vt = qc(QF_VT_CODE)
    # jnp.select: the first true condition wins, other_ok is the default
    type_ok = other_ok
    for code, ok in (
        (VT_CNV, cnv_ok),
        (VT_DUP_TANDEM, dupt_ok),
        (VT_DUP, dup_ok),
        (VT_INS, ins_ok),
        (VT_DEL, del_ok),
    ):
        type_ok = torch.where(vt == code, ok, type_ok)
    exact_ok = (g(C_ALT_HASH) == qc(QF_ALT_HASH)) & (
        alt_len == qc(QF_ALT_LEN)
    )
    anyb_ok = f(FLAG.SINGLE_BASE)
    mode = qc(QF_ALT_MODE)
    alt_ok = torch.where(
        mode == MODE_EXACT,
        exact_ok,
        torch.where(mode == MODE_ANY_BASE, anyb_ok, type_ok),
    )

    matched = valid & end_ok & ref_ok & len_ok & alt_ok

    sum32 = lambda x: _wrap32(x.sum(dim=1, dtype=i64))
    ac = g(C_AC)
    call_count = sum32(torch.where(matched, ac, 0))
    n_variants = sum32(matched & (ac != 0))
    n_matched = sum32(matched)

    # AN once per record with >= 1 matched row: segmented first-match scan
    rec_w = torch.where(valid, g(C_REC_ID), int(INT32_MAX))
    m_i = matched.to(i32)
    cums = torch.cumsum(m_i, dim=1, dtype=i32)
    seg_start = torch.searchsorted(rec_w, rec_w, side="left")
    before_all = cums - m_i  # matched strictly before lane i
    before_seg = torch.where(
        seg_start > 0, cums.gather(1, (seg_start - 1).clamp(min=0)), 0
    )
    first_match = matched & ((before_all - before_seg) == 0)
    all_alleles = sum32(torch.where(first_match, g(C_AN), 0))

    # matched row ids, ascending, -1 padded, capped at record_cap
    marked = torch.where(matched, idxs, int(INT32_MAX))
    topk = torch.sort(marked, dim=1).values[:, :record_cap]
    rows = torch.where(topk == int(INT32_MAX), -1, topk).to(i32)

    overflow = (hi - lo) > W
    agg = torch.stack(
        [
            (call_count > 0).to(i32),
            call_count,
            n_variants,
            all_alleles,
            n_matched,
            overflow.to(i32),
        ],
        dim=1,
    )
    return torch.cat([agg, rows], dim=1)


KERNEL = "bisect_query"
#: dynamic shared memory a block may take after the opt-in attribute
_SMEM_MAX = 227 * 1024


def __getattr__(name: str):
    """``bisect_query_launches``: CUDA launches of the bisection kernel
    since the last ``telemetry.reset_launch_counts()``."""
    if name == "bisect_query_launches":
        return launch_count(KERNEL)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def bisect_query(
    columns,
    alt_prefix,
    offsets,
    qpack,
    *,
    window_cap: int,
    record_cap: int,
    n_iters: int,
    family: str = "fused",
):
    """The bisection query kernel: (out, seq) for one batch, ``out``
    laid out as ``query_batch_reference`` returns it. ``family`` names
    the launch record's program family (``fused`` or ``fused_l0``).

    CUDA tensors launch ``csrc/bisect_query.cu`` on the current stream
    (asynchronously) and record the launch, ``seq`` being its launch
    record; a launch the card refuses raises. CPU tensors run
    ``query_batch_reference`` and ``seq`` is None. Any other device, or
    inputs the kernel does not take, raise. ``n_iters`` is the twin's
    bisection depth; the kernel's search ends by itself."""
    if columns.device.type == "cpu":
        out = query_batch_reference(
            columns, alt_prefix, offsets, qpack, window_cap=window_cap,
            record_cap=record_cap, n_iters=n_iters,
        )
        return out, None
    if columns.device.type != "cuda":
        raise ValueError(f"bisect_query runs on cuda or cpu, not {columns.device}")
    dev = columns.device
    n_pad = columns.shape[1]
    b = qpack.shape[0]
    for name, x, shape in (
        ("columns", columns, (len(COLUMNS), n_pad)),
        ("alt_prefix", alt_prefix, (n_pad, 4)),
        ("offsets", offsets, (offsets.shape[0], offsets.shape[-1])),
        ("qpack", qpack, (b, N_QFIELDS)),
    ):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
    W = int(window_cap)
    R = min(int(record_cap), W)
    if W < 1 or R < 0:
        raise ValueError(f"unsupported window_cap={window_cap}, "
                         f"record_cap={record_cap}")
    lib = _build.load(KERNEL)
    smem = lib.bisect_query_smem(W, R)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"unsupported window_cap={window_cap}, record_cap={record_cap}: "
            f"a block keeps {smem} bytes of matched rows in shared memory, "
            f"at most {_SMEM_MAX}"
        )
    # the launch writes every word of out: no fill before it
    out = torch.empty((b, N_AGG + R), dtype=torch.int32, device=dev)
    if b == 0:
        return out, None
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        rc = lib.bisect_query_launch(
            columns.data_ptr(),
            n_pad,
            alt_prefix.data_ptr(),
            offsets.data_ptr(),
            offsets.shape[0],
            qpack.data_ptr(),
            out.data_ptr(),
            b,
            W,
            R,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bisect_query launch failed: CUDA error {rc}")
    seq = record_device_launch(
        KERNEL,
        family=family,
        specs=b,
        window=W,
        record_cap=R,
        launch_ms=(time.perf_counter() - t0) * 1e3,
    )
    return out, seq


def run_queries(
    dindex: _BisectIndex,
    queries: list[QuerySpec] | dict[str, np.ndarray],
    *,
    window_cap: int = 2048,
    record_cap: int = 1024,
) -> QueryResults:
    """Execute a query batch against a ``DeviceIndex``, a stacked
    ``FusedDeviceIndex`` or an L0 index (stacked batches arrive encoded
    with their ``shard`` ids) with ONE ``bisect_query`` launch, recorded
    under the index's ``flight_family``, and read the results back.

    ``window_cap`` clamps to the index's ``window_hint`` first: the
    clamp decides the window width W, hence ``overflow`` and the width
    of ``rows`` (``min(record_cap, W)``), exactly as in the JAX package.
    The JAX package pads the batch up to a tier of its ladder and
    donates the upload buffers so XLA compiles few shapes; a CUDA kernel
    has no shapes to compile, and the padded rows were trimmed anyway,
    so the batch launches at its own size with the same outputs.
    """
    enc = encode_queries(queries) if isinstance(queries, list) else queries
    window_cap = min(window_cap, dindex.window_hint)
    dev = dindex.device
    qpack = torch.from_numpy(
        pack_queries(enc, fused=dindex.stacked)
    ).to(dev)
    out, seq = bisect_query(
        dindex.columns,
        dindex.alt_prefix,
        dindex.offsets,
        qpack,
        window_cap=window_cap,
        record_cap=record_cap,
        n_iters=dindex.n_iters,
        family=dindex.flight_family,
    )
    t_fetch = time.perf_counter()
    host = out.cpu().numpy()
    note_device_stage(seq, fetch_ms=(time.perf_counter() - t_fetch) * 1e3)
    agg = np.ascontiguousarray(host[:, :N_AGG].T)
    return QueryResults(
        exists=agg[0] != 0,
        call_count=agg[1],
        n_variants=agg[2],
        all_alleles_count=agg[3],
        n_matched=agg[4],
        overflow=agg[5] != 0,
        rows=np.ascontiguousarray(host[:, N_AGG:]),
    )
