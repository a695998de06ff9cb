"""Columnar variant index: one row per (record, alt) pair.

Counterpart of ``sbeacon_tpu/index/columnar.py``, trimmed to what the
query path reads: ``FLAG``, the allele hashes and prefixes,
``VariantIndexShard``, ``build_index``, ``stack_shard_columns`` (the
fused multi-dataset stack) and ``merge_shards`` (the fold of a delta
tail into its base). Rows are sorted by
(chrom_code, pos); every variable-length predicate of the matcher is
pre-computed into fixed-width columns (allele hash + length, symbolic
flag bits, ``ref_repeat_k``, AC per alt, AN per record), and host-only
blobs keep the REF/ALT bytes for materialising variant strings.

``shard_from_reference`` carries an index built elsewhere (any object
with the same numpy fields, e.g. the JAX package's shard) into this
package's ``VariantIndexShard`` without importing its module, so both
packages can be fed one index.

The native genotype-plane builder, the native text build and
save/load belong to the ingest slice and are not ported.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..genomics.vcf import _calls_for
from ..utils.chrom import CODE_TO_CHROMOSOME, chromosome_code, normalize_chromosome

N_CHROM_CODES = 26  # codes 1..25 valid; offsets array has 27 entries

INT32_MAX = np.int32(2**31 - 1)


class FLAG:
    SYMBOLIC = 1  # alt starts with '<'
    CN_PREFIX = 2  # alt starts with '<CN'
    CN0 = 4  # alt == '<CN0>'
    CN1 = 8  # alt == '<CN1>'
    CN2 = 16  # alt == '<CN2>'
    DOT = 32  # alt == '.'
    DEL_PREFIX = 64  # alt starts with '<DEL'
    DUP_PREFIX = 128  # alt starts with '<DUP'
    SINGLE_BASE = 256  # alt.upper() in {A,C,G,T,N}
    AC_INFO = 512  # row's ac came from INFO AC (not genotype tally)
    AN_INFO = 1024  # row's an came from INFO AN (not genotype tally)


def fnv1a32(data: bytes) -> int:
    """FNV-1a 32-bit, returned as int32 bit pattern."""
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return int(np.uint32(h).view(np.int32))


def pack_prefix16(data: bytes) -> np.ndarray:
    """First 16 bytes as 4 big-endian uint32 words (zero padded)."""
    buf = data[:16].ljust(16, b"\x00")
    return np.frombuffer(buf, dtype=">u4").astype(np.uint32)


def prefix_mask(length: int) -> np.ndarray:
    """uint32[4] mask selecting the first ``length`` bytes of a prefix16."""
    out = np.zeros(4, dtype=np.uint32)
    for w in range(4):
        covered = max(0, min(4, length - 4 * w))
        if covered == 4:
            out[w] = 0xFFFFFFFF
        elif covered > 0:
            out[w] = np.uint32(0xFFFFFFFF) << np.uint32(8 * (4 - covered))
    return out


def _ref_repeat_k(ref: str, alt: str) -> int:
    """k such that alt == ref * k (k >= 1), else -1. Covers the DUP
    '(ref){2,}' / DUP:TANDEM 'ref+ref' / CNV '(ref)*' regex family."""
    lr, la = len(ref), len(alt)
    if lr == 0 or la == 0 or la % lr != 0:
        return -1
    k = la // lr
    if alt == ref * k:
        return min(k, 120)
    return -1


def _alt_flags(alt: str) -> int:
    f = 0
    if alt.startswith("<"):
        f |= FLAG.SYMBOLIC
        if alt.startswith("<CN"):
            f |= FLAG.CN_PREFIX
        if alt == "<CN0>":
            f |= FLAG.CN0
        elif alt == "<CN1>":
            f |= FLAG.CN1
        elif alt == "<CN2>":
            f |= FLAG.CN2
        if alt.startswith("<DEL"):
            f |= FLAG.DEL_PREFIX
        if alt.startswith("<DUP"):
            f |= FLAG.DUP_PREFIX
    else:
        if alt == ".":
            f |= FLAG.DOT
        if len(alt) == 1 and alt.upper() in "ACGTN":
            f |= FLAG.SINGLE_BASE
    return f


# Device-bound columns: name -> dtype
DEVICE_COLUMNS = {
    "pos": np.int32,
    "rec_end": np.int32,  # pos + ref_len - 1
    "ref_len": np.int32,
    "alt_len": np.int32,
    "ref_hash": np.int32,  # fnv1a32(ref.upper())
    "alt_hash": np.int32,  # fnv1a32(alt.upper())
    "ref_repeat_k": np.int32,
    "flags": np.int32,
    "ac": np.int32,
    "an": np.int32,
    "rec_id": np.int32,
}

_SHARD_PLANES = (
    "gt_bits",
    "gt_bits2",
    "tok_bits1",
    "tok_bits2",
    "gt_overflow",
    "tok_overflow",
)


@dataclass
class VariantIndexShard:
    """One dataset+VCF's worth of index rows (a shard of the global index)."""

    meta: dict
    cols: dict[str, np.ndarray]  # DEVICE_COLUMNS + alt_prefix uint32[n,4]
    chrom_offsets: np.ndarray  # int32[27]: row span per chrom code
    # host-only materialisation data
    ref_blob: np.ndarray  # uint8
    ref_off: np.ndarray  # uint32[n+1]
    alt_blob: np.ndarray
    alt_off: np.ndarray
    vt_codes: np.ndarray  # int16[n] into meta['vt_vocab']
    gt_bits: np.ndarray | None = None  # uint32[n, ceil(n_samples/32)]
    # extra genotype planes for the selected-samples restricted path:
    # gt_bits2 — sample carries >=2 copies of the row's alt;
    # tok_bits1/tok_bits2 — sample's GT has >=1/>=2 numeric allele tokens
    gt_bits2: np.ndarray | None = None
    tok_bits1: np.ndarray | None = None
    tok_bits2: np.ndarray | None = None
    # exact values where the 2-bit planes saturate (ploidy > 2):
    # int64[k, 3] rows of (row, sample, copies) / (row, sample, tokens)
    gt_overflow: np.ndarray | None = None
    tok_overflow: np.ndarray | None = None

    @property
    def has_count_planes(self) -> bool:
        """All three restricted-counting planes present."""
        return (
            self.gt_bits2 is not None
            and self.tok_bits1 is not None
            and self.tok_bits2 is not None
        )

    @property
    def n_rows(self) -> int:
        return len(self.cols["pos"])

    def row_ref(self, i: int) -> str:
        return bytes(
            self.ref_blob[self.ref_off[i] : self.ref_off[i + 1]]
        ).decode()

    def row_alt(self, i: int) -> str:
        return bytes(
            self.alt_blob[self.alt_off[i] : self.alt_off[i + 1]]
        ).decode()

    def row_chrom(self, i: int) -> str:
        # recover canonical chromosome from the offsets table
        code = int(np.searchsorted(self.chrom_offsets, i, side="right")) - 1
        return CODE_TO_CHROMOSOME.get(code, "?")


def shard_from_reference(obj) -> VariantIndexShard:
    """This package's ``VariantIndexShard`` over the numpy fields of any
    shard-shaped object (duck typed: ``meta``, ``cols``,
    ``chrom_offsets``, the REF/ALT blobs and offsets, ``vt_codes`` and
    the optional genotype planes). Arrays are shared, not copied; the
    meta dict and the column dict are fresh, so the two shards never
    alias their caches."""
    return VariantIndexShard(
        meta=dict(obj.meta),
        cols=dict(obj.cols),
        chrom_offsets=np.asarray(obj.chrom_offsets),
        ref_blob=np.asarray(obj.ref_blob),
        ref_off=np.asarray(obj.ref_off),
        alt_blob=np.asarray(obj.alt_blob),
        alt_off=np.asarray(obj.alt_off),
        vt_codes=np.asarray(obj.vt_codes),
        **{plane: getattr(obj, plane, None) for plane in _SHARD_PLANES},
    )


def build_index(
    records,
    *,
    dataset_id: str = "",
    vcf_location: str = "",
    sample_names: list[str] | None = None,
) -> VariantIndexShard:
    """Explode VcfRecords into sorted columnar rows.

    Records may arrive in any chromosome order (rows are stably re-sorted by
    (chrom_code, pos) so per-record row groups stay contiguous); unknown
    contigs are dropped (they are unreachable through Beacon's canonical
    referenceName anyway).
    """
    sample_names = sample_names or []
    n_samples = len(sample_names)
    gt_words = (n_samples + 31) // 32 if n_samples else 0

    rows: list[tuple] = []  # (chrom_code, pos, rec_ord, alt_ord, record)
    vt_vocab: list[str] = ["N/A"]
    vt_index = {"N/A": 0}
    records = list(records)
    dropped = 0
    chrom_native: dict[str, str] = {}  # canonical -> native spelling in file
    for rec_ord, rec in enumerate(records):
        code = chromosome_code(rec.chrom)
        if code == 0:
            dropped += 1
            continue
        canon = normalize_chromosome(rec.chrom)
        chrom_native.setdefault(canon, rec.chrom)
        for alt_ord in range(len(rec.alts)):
            rows.append((code, rec.pos, rec_ord, alt_ord, rec))

    # stable sort keeps a record's alts adjacent and in file order
    rows.sort(key=lambda r: (r[0], r[1], r[2], r[3]))

    n = len(rows)
    cols = {name: np.zeros(n, dtype=dt) for name, dt in DEVICE_COLUMNS.items()}
    alt_prefix = np.zeros((n, 4), dtype=np.uint32)
    vt_codes = np.zeros(n, dtype=np.int16)
    gt_bits = (
        np.zeros((n, gt_words), dtype=np.uint32) if gt_words else None
    )
    gt_bits2 = np.zeros_like(gt_bits) if gt_bits is not None else None
    tok_bits1 = np.zeros_like(gt_bits) if gt_bits is not None else None
    tok_bits2 = np.zeros_like(gt_bits) if gt_bits is not None else None
    gt_overflow: list[tuple[int, int, int]] = []
    tok_overflow: list[tuple[int, int, int]] = []
    ref_parts: list[bytes] = []
    alt_parts: list[bytes] = []
    chrom_offsets = np.zeros(N_CHROM_CODES + 1, dtype=np.int32)

    # rec_id must be nondecreasing in row order for the windowed
    # first-match-per-record scan on device; re-number by first appearance.
    rec_renumber: dict[int, int] = {}
    used_records: list = []  # record object per renumbered id
    an_cache: dict[int, int] = {}
    ac_cache: dict[int, list[int]] = {}
    row_rec = np.zeros(n, dtype=np.int32)
    row_allele = np.zeros(n, dtype=np.int32)

    # per-build memoization: cohort alleles repeat massively, so hash
    # and prefix-pack per UNIQUE string instead of per row
    allele_hash = functools.cache(lambda s: fnv1a32(s.upper().encode()))
    alt_prefix_of = functools.cache(lambda s: pack_prefix16(s.encode()))
    alt_flags_of = functools.cache(_alt_flags)
    repeat_k_of = functools.cache(_ref_repeat_k)

    for i, (code, pos, rec_ord, alt_ord, rec) in enumerate(rows):
        alt = rec.alts[alt_ord]
        ref = rec.ref
        if rec_ord not in rec_renumber:
            rec_renumber[rec_ord] = len(rec_renumber)
            used_records.append(rec)
            ac_cache[rec_ord] = rec.effective_ac()
            an_cache[rec_ord] = rec.effective_an()
        cols["pos"][i] = pos
        cols["rec_end"][i] = pos + len(ref) - 1
        cols["ref_len"][i] = len(ref)
        cols["alt_len"][i] = len(alt)
        cols["ref_hash"][i] = allele_hash(ref)
        cols["alt_hash"][i] = allele_hash(alt)
        cols["ref_repeat_k"][i] = repeat_k_of(ref, alt)
        cols["flags"][i] = (
            alt_flags_of(alt)
            | (FLAG.AC_INFO if rec.ac is not None else 0)
            | (FLAG.AN_INFO if rec.an is not None else 0)
        )
        cols["ac"][i] = ac_cache[rec_ord][alt_ord]
        cols["an"][i] = an_cache[rec_ord]
        cols["rec_id"][i] = rec_renumber[rec_ord]
        alt_prefix[i] = alt_prefix_of(alt)
        if rec.vt not in vt_index:
            vt_index[rec.vt] = len(vt_vocab)
            vt_vocab.append(rec.vt)
        vt_codes[i] = vt_index[rec.vt]
        ref_parts.append(ref.encode())
        alt_parts.append(alt.encode())
        row_rec[i] = rec_renumber[rec_ord]
        row_allele[i] = alt_ord + 1

    if gt_bits is not None and n:
        _fill_gt_planes(
            used_records,
            n_samples,
            gt_words,
            row_rec,
            row_allele,
            gt_bits,
            gt_bits2,
            tok_bits1,
            tok_bits2,
            gt_overflow,
            tok_overflow,
        )

    # chrom offsets: chrom_offsets[c] = first row of code c
    codes = np.array([r[0] for r in rows], dtype=np.int32)
    for c in range(N_CHROM_CODES + 1):
        chrom_offsets[c] = np.searchsorted(codes, c, side="left")

    ref_off = np.zeros(n + 1, dtype=np.uint32)
    alt_off = np.zeros(n + 1, dtype=np.uint32)
    np.cumsum([len(p) for p in ref_parts], out=ref_off[1:] if n else None)
    np.cumsum([len(p) for p in alt_parts], out=alt_off[1:] if n else None)

    meta = {
        "dataset_id": dataset_id,
        "vcf_location": vcf_location,
        "sample_names": sample_names,
        "vt_vocab": vt_vocab,
        "n_rows": n,
        "n_records": len(rec_renumber),
        "dropped_records": dropped,
        # dataset summary stats (variantCount = #alts, callCount = sum
        # AN, sampleCount)
        "variant_count": n,
        "call_count": int(sum(an_cache[r] for r in rec_renumber)),
        "sample_count": n_samples,
        "chrom_native": chrom_native,
        "format_version": 1,
    }
    return VariantIndexShard(
        meta=meta,
        cols={**cols, "alt_prefix": alt_prefix},
        chrom_offsets=chrom_offsets,
        ref_blob=np.frombuffer(b"".join(ref_parts), dtype=np.uint8).copy(),
        ref_off=ref_off,
        alt_blob=np.frombuffer(b"".join(alt_parts), dtype=np.uint8).copy(),
        alt_off=alt_off,
        vt_codes=vt_codes,
        gt_bits=gt_bits,
        gt_bits2=gt_bits2,
        tok_bits1=tok_bits1,
        tok_bits2=tok_bits2,
        gt_overflow=(
            np.array(gt_overflow, dtype=np.int64).reshape(-1, 3)
            if gt_bits is not None
            else None
        ),
        tok_overflow=(
            np.array(tok_overflow, dtype=np.int64).reshape(-1, 3)
            if gt_bits is not None
            else None
        ),
    )


def stack_shard_columns(
    shards: list[VariantIndexShard],
) -> tuple[dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Stacked-shard device columns for the fused multi-dataset index.

    Every shard's rows stay contiguous and in their original order, and
    a per-shard segment table lets the fused kernel answer a (shard,
    query) pair by bisecting inside ``chrom_offsets[shard]`` exactly as
    the single-shard kernel bisects inside its own offsets.

    Returns ``(cols, chrom_offsets, shard_base)``:

    - ``cols``: every device column (incl. ``alt_prefix``) concatenated
      in shard order,
    - ``chrom_offsets``: int32[k, 27], shard i's chromosome segment
      table rebased to absolute stacked row ids,
    - ``shard_base``: int64[k+1], shard i's rows live at
      ``[shard_base[i], shard_base[i+1])``; stacked row ids map back to
      shard-local ids by subtracting ``shard_base[i]``.
    """
    if not shards:
        raise ValueError("stack_shard_columns needs at least one shard")
    base = np.zeros(len(shards) + 1, dtype=np.int64)
    for i, s in enumerate(shards):
        base[i + 1] = base[i] + s.n_rows
    if base[-1] > int(INT32_MAX):
        raise ValueError(
            f"stacked index exceeds int32 row ids ({int(base[-1])} rows)"
        )
    names = list(DEVICE_COLUMNS) + ["alt_prefix"]
    cols = {
        name: np.concatenate([s.cols[name] for s in shards])
        for name in names
    }
    chrom_offsets = np.stack(
        [
            s.chrom_offsets.astype(np.int64) + base[i]
            for i, s in enumerate(shards)
        ]
    ).astype(np.int32)
    return cols, chrom_offsets, base


def merge_shards(shards: list[VariantIndexShard]) -> VariantIndexShard:
    """Merge per-VCF shards into one globally sorted shard (vectorised).

    Counterpart of the JAX package's ``merge_shards``, line for line:
    rows ordered by (chromosome code, pos), then shard, then original
    row, so each record's alt rows stay adjacent; records renumbered;
    variant-type vocabularies unioned; genotype planes (and their
    overflow side tables) kept when every shard has them over the same
    sample universe, else dropped. The fold of a delta tail into its
    base (``VariantEngine.add_index`` with ``meta['delta_epoch']``)
    and the tests' monolith oracles use it.
    """
    if len(shards) == 1:
        return shards[0]

    # per-shard chrom codes, concatenated
    codes_parts, shard_ord_parts = [], []
    for s_ord, s in enumerate(shards):
        codes_parts.append(
            (
                np.searchsorted(
                    s.chrom_offsets, np.arange(s.n_rows), side="right"
                )
                - 1
            ).astype(np.int32)
        )
        shard_ord_parts.append(np.full(s.n_rows, s_ord, dtype=np.int32))
    codes_all = np.concatenate(codes_parts)
    shard_all = np.concatenate(shard_ord_parts)
    pos_all = np.concatenate([s.cols["pos"] for s in shards])
    row_all = np.concatenate(
        [np.arange(s.n_rows, dtype=np.int64) for s in shards]
    )
    # stable order by (code, pos), shard then original row as tiebreakers —
    # keeps each record's alt rows adjacent (lexsort: last key is primary)
    order = np.lexsort((row_all, shard_all, pos_all, codes_all))

    n = len(order)
    out_cols = {}
    for name in DEVICE_COLUMNS:
        out_cols[name] = np.concatenate([s.cols[name] for s in shards])[order]
    out_prefix = np.concatenate([s.cols["alt_prefix"] for s in shards])[order]

    # rec_id renumber: records stay contiguous after the stable sort, so a
    # change-flag cumsum yields nondecreasing ids
    old_rec = np.concatenate([s.cols["rec_id"] for s in shards])[order]
    old_shard = shard_all[order]
    if n:
        change = np.ones(n, dtype=np.int64)
        change[1:] = (old_rec[1:] != old_rec[:-1]) | (
            old_shard[1:] != old_shard[:-1]
        )
        out_cols["rec_id"] = (np.cumsum(change) - 1).astype(np.int32)
        n_records = int(change.sum())
    else:
        n_records = 0

    # vt vocab union + per-shard remap
    vt_vocab: list[str] = ["N/A"]
    vt_idx = {"N/A": 0}
    vt_parts = []
    for s in shards:
        lut = np.zeros(len(s.meta["vt_vocab"]), dtype=np.int16)
        for j, vt in enumerate(s.meta["vt_vocab"]):
            if vt not in vt_idx:
                vt_idx[vt] = len(vt_vocab)
                vt_vocab.append(vt)
            lut[j] = vt_idx[vt]
        vt_parts.append(lut[s.vt_codes])
    vt_codes = np.concatenate(vt_parts)[order]

    same_samples = all(
        s.meta["sample_names"] == shards[0].meta["sample_names"] for s in shards
    )
    planes: dict[str, np.ndarray | None] = {}
    for plane in ("gt_bits", "gt_bits2", "tok_bits1", "tok_bits2"):
        planes[plane] = None
        if same_samples and all(
            getattr(s, plane) is not None for s in shards
        ):
            planes[plane] = np.concatenate(
                [getattr(s, plane) for s in shards]
            )[order]
    # overflow side-tables: remap old per-shard rows to merged positions
    inv_order = np.empty(n, dtype=np.int64)
    inv_order[order] = np.arange(n)
    row_base = np.cumsum([0] + [s.n_rows for s in shards[:-1]])
    for plane in ("gt_overflow", "tok_overflow"):
        planes[plane] = None
        if same_samples and all(
            getattr(s, plane) is not None for s in shards
        ):
            parts = []
            for base, s in zip(row_base, shards):
                arr = getattr(s, plane)
                if len(arr):
                    remapped = arr.copy()
                    remapped[:, 0] = inv_order[arr[:, 0] + base]
                    parts.append(remapped)
            planes[plane] = (
                np.concatenate(parts)
                if parts
                else np.zeros((0, 3), dtype=np.int64)
            )

    # blobs: offset each shard's row ids into the concatenated blob space
    ref_blob_cat = np.concatenate([s.ref_blob for s in shards])
    alt_blob_cat = np.concatenate([s.alt_blob for s in shards])

    def _cat_offsets(get_off):
        parts = []
        base = 0
        for s in shards:
            off = get_off(s).astype(np.int64)
            parts.append(off[:-1] + base)
            base += int(off[-1])
        ends = []
        base = 0
        for s in shards:
            off = get_off(s).astype(np.int64)
            ends.append(off[1:] + base)
            base += int(off[-1])
        return np.concatenate(parts), np.concatenate(ends)

    ref_starts, ref_ends = _cat_offsets(lambda s: s.ref_off)
    alt_starts, alt_ends = _cat_offsets(lambda s: s.alt_off)

    def _regather(blob, starts, ends, order):
        off2 = np.zeros(n + 1, dtype=np.int64)
        lens = (ends - starts)[order]
        np.cumsum(lens, out=off2[1:])
        total = int(off2[-1])
        idx = np.repeat(starts[order] - off2[:-1], lens) + np.arange(
            total, dtype=np.int64
        )
        return blob[idx] if total else np.zeros(0, np.uint8), off2.astype(
            np.uint32
        )

    ref_blob, ref_off = _regather(ref_blob_cat, ref_starts, ref_ends, order)
    alt_blob, alt_off = _regather(alt_blob_cat, alt_starts, alt_ends, order)

    chrom_offsets = np.zeros(N_CHROM_CODES + 1, dtype=np.int32)
    sorted_codes = codes_all[order]
    for c in range(N_CHROM_CODES + 1):
        chrom_offsets[c] = np.searchsorted(sorted_codes, c, side="left")

    chrom_native: dict[str, str] = {}
    for s in shards:
        for canon, native in s.meta.get("chrom_native", {}).items():
            chrom_native.setdefault(canon, native)

    meta = dict(shards[0].meta)
    meta.update(
        n_rows=n,
        n_records=n_records,
        vt_vocab=vt_vocab,
        variant_count=n,
        call_count=int(sum(s.meta["call_count"] for s in shards)),
        dropped_records=int(
            sum(s.meta.get("dropped_records", 0) for s in shards)
        ),
        chrom_native=chrom_native,
        merged_from=[s.meta.get("vcf_location", "") for s in shards],
    )
    return VariantIndexShard(
        meta=meta,
        cols={**out_cols, "alt_prefix": out_prefix},
        chrom_offsets=chrom_offsets,
        ref_blob=ref_blob,
        ref_off=ref_off,
        alt_blob=alt_blob,
        alt_off=alt_off,
        vt_codes=vt_codes,
        **planes,
    )


def _fill_gt_planes(
    used_records,
    n_samples: int,
    gt_words: int,
    row_rec: np.ndarray,
    row_allele: np.ndarray,
    gt_bits: np.ndarray,
    gt_bits2: np.ndarray,
    tok_bits1: np.ndarray,
    tok_bits2: np.ndarray,
    gt_overflow: list,
    tok_overflow: list,
) -> None:
    """Resolve the genotype planes for all rows (vectorised per record).

    Genotype columns are normalised to exactly n_samples entries (extra
    entries dropped, missing padded empty)."""
    if not any(rec.genotypes for rec in used_records):
        return  # all-zero planes; skip the whole pass

    def norm_gts(rec) -> list[str]:
        gts = list(rec.genotypes[:n_samples]) if rec.genotypes else []
        return gts + [""] * (n_samples - len(gts))

    calls_cache: dict[int, tuple] = {}
    for i in range(len(row_rec)):
        rid = int(row_rec[i])
        rec = used_records[rid]
        if not rec.genotypes:
            continue
        if rid not in calls_cache:
            calls_cache[rid] = _gt_matrix(norm_gts(rec), gt_words)
        M, _ntok, tok1, tok2, tok_over = calls_cache[rid]
        allele = int(row_allele[i])
        copies = (M == allele).sum(axis=1).astype(np.int32)
        gt_bits[i] = _pack_bits(copies >= 1, gt_words)
        gt_bits2[i] = _pack_bits(copies >= 2, gt_words)
        for s_idx in np.nonzero(copies > 2)[0]:
            # ploidy > 2: keep the exact count
            gt_overflow.append((i, int(s_idx), int(copies[s_idx])))
        tok_bits1[i] = tok1
        tok_bits2[i] = tok2
        for s_idx, t in tok_over:
            tok_overflow.append((i, s_idx, t))


def _pack_bits(mask: np.ndarray, words: int) -> np.ndarray:
    """bool[n_samples] -> uint32[words], bit s = sample s (little-bit
    order within each word, matching the scalar ``1 << (s % 32)``)."""
    padded = np.zeros(words * 32, dtype=np.uint32)
    padded[: len(mask)] = mask
    return (padded.reshape(words, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32
    )


def _gt_matrix(genotypes: list[str], gt_words: int):
    """Per-record genotype parse, done once and shared by all alt rows:
    (calls matrix [n_samples, max_ploidy] with -1 padding, token counts,
    packed tok>=1 / tok>=2 planes, [(sample, tokens)] overflow)."""
    calls = [_calls_for(gt) for gt in genotypes]
    n = len(calls)
    lens = [len(c) for c in calls]
    ploidy = max(lens, default=0)
    if ploidy and min(lens) == ploidy:
        # uniform ploidy (the overwhelmingly common case): one array call
        M = np.array(calls, dtype=np.int32)
        ntok = np.full(n, ploidy, dtype=np.int32)
    else:
        M = np.full((n, max(ploidy, 1)), -1, dtype=np.int32)
        ntok = np.zeros(n, dtype=np.int32)
        for s, toks in enumerate(calls):
            ntok[s] = len(toks)
            M[s, : len(toks)] = toks
    tok1 = _pack_bits(ntok >= 1, gt_words)
    tok2 = _pack_bits(ntok >= 2, gt_words)
    tok_over = [
        (int(s), int(ntok[s])) for s in np.nonzero(ntok > 2)[0]
    ]
    return M, ntok, tok1, tok2, tok_over
