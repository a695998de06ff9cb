"""Shared query-side packing for the device kernels (kernel-neutral).

Counterpart of ``sbeacon_tpu/ops/query_pack.py``, a copy (it is pure
numpy) with its imports pointed at the port's own modules.

The 8-word device query encoding, the host-side searchsorted window
bounds, the symbolic-prefix flag staging, and the packed-match-mask
unpacker, shared by the device kernels; the serving path
(``scatter_kernel``/``engine``) imports only this module.

Encoding recap (vs the legacy 24-word layout): symbolic-type prefix
matching is index-side flag bits (PM_*), start_min/start_max are
replaced by host-searchsorted lo/hi, chrom is host-only, and length
fields are bit-packed with lossless clamps — queries whose fields
cannot be represented exactly are host-flagged (``needs_host``) and
take the uncapped host path, never a silently-wrong device verdict.
"""

from __future__ import annotations

import numpy as np

from ..index.columnar import INT32_MAX
from .kernel import MODE_TYPE, VT_OTHER

(
    Q_LO,
    Q_HI,
    Q_END_MIN,
    Q_END_MAX,
    Q_REF_HASH,
    Q_ALT_HASH,
    Q_META,  # ref_wild(1) | alt_mode(2) | vt_code(3) | ref_len(13) | min_len(13)
    Q_LENS,  # alt_len(16) | max_len(16)
) = range(8)
N_QWORDS = 8

# extra flag bits staged into the device matrix's flags row only (never
# persisted): per-row symbolic-prefix matches. '<DEL'/'<DUP' prefixes
# reuse the shard's own FLAG.DEL_PREFIX/DUP_PREFIX bits; these cover
# the rest.
PM_INS = 1 << 16  # alt starts with '<INS'
PM_DUPT = 1 << 17  # alt starts with '<DUP:TANDEM'
PM_CNV = 1 << 18  # alt starts with '<CNV'


def stage_symbolic_flags(
    flags: np.ndarray, alt_prefix: np.ndarray
) -> np.ndarray:
    """Return ``flags`` with the PM_* symbolic-prefix bits staged from
    the 16-byte alt prefixes — the device-matrix-only bits every kernel
    index builder needs. One shared implementation so kernels can never
    drift on prefix semantics."""
    from ..index.columnar import pack_prefix16, prefix_mask

    out = flags.astype(np.int64, copy=True)
    for prefix, bit in (
        (b"<INS", PM_INS),
        (b"<DUP:TANDEM", PM_DUPT),
        (b"<CNV", PM_CNV),
    ):
        want = pack_prefix16(prefix)
        m = prefix_mask(min(len(prefix), 16))
        hit = (((alt_prefix ^ want) & m) == 0).all(axis=1)
        out |= np.where(hit, np.int64(bit), 0)
    return out


def window_bounds(
    index, enc: dict[str, np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised host-side searchsorted window bounds per query.

    ``index`` is any device index exposing ``pos_host`` (the sorted
    position column) and ``offsets_host`` (per-chromosome row offsets);
    B·log N numpy searchsorted is microseconds."""
    pos = index.pos_host
    offs = index.offsets_host
    b = len(enc["chrom"])
    chrom = enc["chrom"].astype(np.int64)
    lo = np.zeros(b, np.int64)
    hi = np.zeros(b, np.int64)
    for c in np.unique(chrom):
        m = chrom == c
        a, e = int(offs[c]), int(offs[c + 1])
        seg = pos[a:e]
        lo[m] = a + np.searchsorted(seg, enc["start_min"][m], side="left")
        hi[m] = a + np.searchsorted(seg, enc["start_max"][m], side="right")
    return lo, hi


def pack_q8(
    enc: dict[str, np.ndarray], lo: np.ndarray, hi: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Compact 8-word device encoding + host-fallback flags.

    Returns (q8[B, 8] int32, needs_host[B] bool). ``needs_host`` marks
    queries the compact encoding cannot represent exactly — VT_OTHER
    symbolic-type matching (the '<'+str(vt) artifact for arbitrary type
    strings, host-resolved) and out-of-range length fields; the caller
    folds it into ``overflow`` so those queries take the uncapped host
    path, never a silently-wrong device verdict.
    """
    b = len(enc["chrom"])
    q = np.zeros((b, N_QWORDS), np.int64)
    q[:, Q_LO] = lo
    q[:, Q_HI] = hi
    q[:, Q_END_MIN] = enc["end_min"]
    q[:, Q_END_MAX] = enc["end_max"]
    q[:, Q_REF_HASH] = enc["ref_hash"]
    q[:, Q_ALT_HASH] = enc["alt_hash"]
    ref_len = np.minimum(enc["ref_len"].astype(np.int64), 0x1FFF)
    min_len = np.minimum(enc["min_len"].astype(np.int64), 0x1FFF)
    q[:, Q_META] = (
        enc["ref_wild"].astype(np.int64)
        | (enc["alt_mode"].astype(np.int64) << 1)
        | (np.minimum(enc["vt_code"].astype(np.int64), 7) << 3)
        | (ref_len << 6)
        | (min_len << 19)
    )
    # alt_len: row alt_len is an UNCLAMPED int32 column (columnar.py
    # stores len(alt) verbatim — multi-kb insertions are legal rows), so
    # only the query-side fields are range-limited. max_len uses 0xFFFF
    # as the unbounded sentinel (decoded to INT32_MAX in-kernel);
    # anything the 16-bit fields cannot represent exactly is host-flagged.
    alt_len = np.minimum(enc["alt_len"].astype(np.int64), 0xFFFF)
    unbounded = enc["max_len"].astype(np.int64) >= INT32_MAX
    max_len = np.where(
        unbounded, 0xFFFF, np.minimum(enc["max_len"].astype(np.int64), 0xFFFE)
    )
    q[:, Q_LENS] = alt_len | (max_len << 16)
    q8 = (q & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    needs_host = (
        ((enc["alt_mode"] == MODE_TYPE) & (enc["vt_code"] == VT_OTHER))
        # >= the clamp values (not >): the scattered kernel clamps the
        # ROW length columns to the same widths, so a query sitting
        # exactly at a clamp could otherwise hash-match a longer row
        | (enc["ref_len"] >= 0x1FFF)
        | (enc["min_len"] > 0x1FFF)
        | (enc["alt_len"] >= 0xFFFF)
        | (~unbounded & (enc["max_len"].astype(np.int64) > 0xFFFE))
    )
    return q8, needs_host


def rows_from_masks(
    masks: np.ndarray,
    base_rows: np.ndarray,
    record_cap: int,
) -> np.ndarray:
    """Packed per-query match masks -> [B, record_cap] global row ids
    (-1 padded), one vectorised unpackbits for the whole batch. Bit l
    of word w == window lane w*16 + l (the shared wire format)."""
    b, nw = masks.shape
    halves = np.ascontiguousarray(masks.astype(np.uint16))
    bits = np.unpackbits(
        halves.view(np.uint8).reshape(b, nw * 2), axis=1, bitorder="little"
    )  # [B, 2W], bit l of word w == window lane w*16+l
    qi_idx, lane_idx = np.nonzero(bits)
    counts = bits.sum(axis=1).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    k = np.arange(len(lane_idx)) - np.repeat(cum, counts)
    keep = k < record_cap
    rows = np.full((b, record_cap), -1, np.int32)
    rows[qi_idx[keep], k[keep]] = (
        base_rows[qi_idx[keep]] + lane_idx[keep]
    ).astype(np.int32)
    return rows
