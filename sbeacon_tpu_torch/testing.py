"""Synthetic corpora for tests and the chip smoke run.

Counterpart of ``sbeacon_tpu/testing.py``, trimmed to ``random_records``
(structured-random VCF records covering every branch of the matcher:
SNPs, indels, multi-alt records, symbolic alleles, records with and
without INFO AC/AN, genotype columns) and ``synthetic_shard`` (a
vectorised, 1000-Genomes-shaped ``VariantIndexShard`` at any scale),
plus the port's own ``subset_shard`` (a row subset of a shard, standing
for a re-submitted VCF), ``distinct_key_cases`` (crafted key sets for
the distinct count) and ``window_edge_shards`` / ``window_edge_specs``
(window edges of the bisection query).
"""

from __future__ import annotations

import itertools
import random

from .genomics.vcf import VcfRecord

BASES = "ACGT"

SYMBOLIC_ALTS = [
    "<DEL>",
    "<INS>",
    "<DUP>",
    "<DUP:TANDEM>",
    "<CN0>",
    "<CN1>",
    "<CN2>",
    "<CN3>",
    "<INV>",
]


def _random_seq(rng: random.Random, lo: int, hi: int) -> str:
    return "".join(rng.choice(BASES) for _ in range(rng.randint(lo, hi)))


def random_records(
    rng: random.Random,
    chrom: str = "1",
    n: int = 500,
    start: int = 1000,
    spacing: int = 30,
    n_samples: int = 8,
    p_multiallelic: float = 0.15,
    p_symbolic: float = 0.08,
    p_no_acan: float = 0.2,
    p_indel: float = 0.2,
) -> list[VcfRecord]:
    """Generate sorted synthetic records exercising all matcher branches."""
    records = []
    pos = start
    for _ in range(n):
        pos += rng.randint(1, spacing)
        ref = _random_seq(rng, 1, 1) if rng.random() > p_indel else _random_seq(rng, 1, 6)
        n_alts = 2 if rng.random() < p_multiallelic else 1
        alts = []
        for _ in range(n_alts):
            r = rng.random()
            if r < p_symbolic:
                alts.append(rng.choice(SYMBOLIC_ALTS))
            elif r < p_symbolic + 0.1 and len(ref) <= 3:
                # duplication-shaped alt: ref repeated k times
                alts.append(ref * rng.randint(2, 3))
            else:
                alt = _random_seq(rng, 1, 6)
                while alt == ref:
                    alt = _random_seq(rng, 1, 6)
                alts.append(alt)
        # genotypes: diploid calls over alleles 0..n_alts
        genotypes = []
        for _ in range(n_samples):
            a = rng.randint(0, n_alts)
            b = rng.randint(0, n_alts)
            sep = rng.choice("|/")
            genotypes.append(f"{a}{sep}{b}")
        vt = rng.choice(["SNP", "INDEL", "SV", "N/A"])
        rec = VcfRecord(
            chrom=chrom,
            pos=pos,
            ref=ref,
            alts=alts,
            ac=None,
            an=None,
            vt=vt,
            genotypes=genotypes,
        )
        if rng.random() >= p_no_acan:
            # derive INFO AC/AN through the one shared implementation
            rec.ac = rec.effective_ac()
            rec.an = rec.effective_an()
        records.append(rec)
    return records


def synthetic_shard(
    n_rows: int,
    *,
    n_samples: int = 0,
    seed: int = 0,
    dataset_id: str = "synth",
    chroms: list[str] | None = None,
    p_multiallelic: float = 0.08,
    p_indel: float = 0.12,
    p_symbolic: float = 0.01,
    with_gt_planes: bool = False,
    plane_density: float = 0.01,
):
    """Directly-constructed ``VariantIndexShard`` at arbitrary scale.

    Pure vectorised numpy — no VCF text, no per-record Python — so a
    2e7-row 1000-Genomes-shaped index builds in seconds. This is the
    query-side scale corpus for benchmarks (the ingest pipeline is
    proven separately through real VCF text); the column *contents* are
    semantically valid (sorted positions per chromosome, contiguous
    multi-alt records sharing pos/AN, correct flags/hashes/prefixes for
    every allele string, AC drawn from a 1/x allele-frequency spectrum,
    blobs materialisable), so host-matcher parity and response
    materialisation work exactly as on ingested data.

    Rows spread uniformly across each chromosome's real GRCh38 length.
    All rows carry AC_INFO/AN_INFO (INFO-sourced counts, the common
    case for cohort VCFs) with AN ``2 * n_samples`` (5008, the
    2504-sample cohort, when ``n_samples`` is 0), so genotype planes —
    generated when ``with_gt_planes`` with about ``plane_density`` bits
    set — affect only sample extraction, exactly as for bcftools-INFO
    data. The JAX package's generator also makes clustered positions,
    which are not ported. At every seed this function gives the JAX
    generator's shard, planes included.
    """
    import numpy as np

    from .index.columnar import (
        FLAG,
        N_CHROM_CODES,
        VariantIndexShard,
        _alt_flags,
        _ref_repeat_k,
        fnv1a32,
        pack_prefix16,
    )
    from .utils.chrom import CHROMOSOME_LENGTHS, chromosome_code

    rng = np.random.default_rng(seed)
    chroms = chroms or [str(i) for i in range(1, 23)]
    lengths = np.array([CHROMOSOME_LENGTHS[c] for c in chroms], np.float64)
    weights = lengths / lengths.sum()

    # records -> rows: multi-allelic records carry 2-3 alts. Generate
    # one candidate record per requested row (always enough, each
    # record yields >= 1 row), cut at the record whose rows reach
    # n_rows.
    n_rec_est = n_rows + 8
    n_alts = np.where(
        rng.random(n_rec_est) < p_multiallelic,
        rng.integers(2, 4, n_rec_est),
        1,
    ).astype(np.int64)
    total = np.cumsum(n_alts)
    n_rec = min(int(np.searchsorted(total, n_rows, side="left")) + 1, n_rec_est)
    n_alts = n_alts[:n_rec]
    n = int(n_alts.sum())

    # per-record chromosome + position (sorted within chrom)
    rec_chrom = rng.choice(len(chroms), size=n_rec, p=weights)
    u = rng.random(n_rec)
    rec_pos = (u * (lengths[rec_chrom] - 1)).astype(np.int64) + 1

    # sort records by (chromosome CODE, pos) — shard layout is ordered
    # by code, which need not match the chroms list's order
    codes = np.array([chromosome_code(c) for c in chroms], np.int32)
    order = np.lexsort((rec_pos, codes[rec_chrom]))
    rec_chrom = rec_chrom[order]
    rec_pos = rec_pos[order]
    n_alts = n_alts[order]
    row_rec = np.repeat(np.arange(n_rec, dtype=np.int64), n_alts)

    # allele vocabulary: single bases, short indel strings, symbolic
    vocab = ["A", "C", "G", "T"]
    indel_rng = random.Random(seed + 1)
    for _ in range(60):
        vocab.append(_random_seq(indel_rng, 2, 24))
    vocab += ["<DEL>", "<DUP>", "<CN0>", "<CN2>", "<INS>", "."]
    V = len(vocab)
    v_bytes = [v.encode() for v in vocab]
    v_len = np.array([len(v) for v in vocab], np.int64)
    v_hash = np.array([fnv1a32(v.upper().encode()) for v in vocab], np.int32)
    v_flags = np.array([_alt_flags(v) for v in vocab], np.int32)
    v_prefix = np.stack([pack_prefix16(b) for b in v_bytes]).astype(np.uint32)

    kind = rng.random(n)
    is_sym = kind < p_symbolic
    is_indel = (~is_sym) & (kind < p_symbolic + p_indel)
    alt_id = np.where(
        is_sym,
        rng.integers(64, 64 + 6, n),
        np.where(is_indel, rng.integers(4, 64, n), rng.integers(0, 4, n)),
    )
    ref_id = np.repeat(
        np.where(
            rng.random(n_rec) < p_indel / 2,
            rng.integers(4, 64, n_rec),
            rng.integers(0, 4, n_rec),
        ),
        n_alts,
    )

    pos_row = rec_pos[row_rec].astype(np.int32)
    ref_len = v_len[ref_id].astype(np.int32)
    alt_len = v_len[alt_id].astype(np.int32)

    # AC from a heavy-tailed spectrum; AN constant per record
    an_val = 2 * n_samples if n_samples else 5008
    ac = np.minimum(
        (1.0 / np.maximum(rng.random(n), 1e-6)).astype(np.int64), an_val
    ).astype(np.int32)
    ac[rng.random(n) < 0.02] = 0  # monomorphic-in-subset rows

    # repeat-k: vocab pair lookup (cached per unique pair id)
    pair = ref_id * V + alt_id
    uniq_pair, inv = np.unique(pair, return_inverse=True)
    k_u = np.array(
        [
            _ref_repeat_k(vocab[int(p) // V], vocab[int(p) % V])
            for p in uniq_pair
        ],
        np.int32,
    )
    flags = (
        v_flags[alt_id]
        | np.int32(FLAG.AC_INFO)
        | np.int32(FLAG.AN_INFO)
    )

    cols = {
        "pos": pos_row,
        "rec_end": (pos_row.astype(np.int64) + ref_len - 1).astype(np.int32),
        "ref_len": ref_len,
        "alt_len": alt_len,
        "ref_hash": v_hash[ref_id],
        "alt_hash": v_hash[alt_id],
        "ref_repeat_k": k_u[inv],
        "flags": flags,
        "ac": ac,
        "an": np.full(n, an_val, np.int32),
        "rec_id": row_rec.astype(np.int32),
        "alt_prefix": v_prefix[alt_id],
    }

    row_code = codes[rec_chrom[row_rec]]
    chrom_offsets = np.zeros(N_CHROM_CODES + 1, np.int32)
    for c in range(N_CHROM_CODES + 1):
        chrom_offsets[c] = np.searchsorted(row_code, c, side="left")

    # blobs: fixed-width vocab matrix -> masked flatten (vectorised)
    maxw = int(v_len.max())
    v_mat = np.zeros((V, maxw), np.uint8)
    for i, b in enumerate(v_bytes):
        v_mat[i, : len(b)] = np.frombuffer(b, np.uint8)
    lane = np.arange(maxw)

    def blob_of(ids, lens):
        mat = v_mat[ids]
        mask = lane[None, :] < lens[:, None]
        off = np.zeros(n + 1, np.uint32)
        np.cumsum(lens, out=off[1:] if n else None)
        return mat[mask], off

    ref_blob, ref_off = blob_of(ref_id, v_len[ref_id])
    alt_blob, alt_off = blob_of(alt_id, v_len[alt_id])

    planes = {}
    if n_samples and with_gt_planes:
        words = (n_samples + 31) // 32
        # about plane_density bits set: the AND of k random words thins
        # them by 2^-k
        k_and = max(1, int(round(-np.log2(max(plane_density, 2**-16)))))
        g = rng.integers(0, 2**32, (n, words), dtype=np.uint32)
        for _ in range(k_and - 1):
            g &= rng.integers(0, 2**32, (n, words), dtype=np.uint32)
        tail = n_samples % 32
        if tail:
            g[:, -1] &= np.uint32((1 << tail) - 1)
        planes = {
            "gt_bits": g,
            "gt_bits2": (
                g & rng.integers(0, 2**32, (n, words), dtype=np.uint32)
            ),
            "tok_bits1": np.full((n, words), 0xFFFFFFFF, np.uint32),
            "tok_bits2": np.full((n, words), 0xFFFFFFFF, np.uint32),
            "gt_overflow": np.zeros((0, 3), np.int64),
            "tok_overflow": np.zeros((0, 3), np.int64),
        }
        if tail:
            planes["tok_bits1"][:, -1] = np.uint32((1 << tail) - 1)
            planes["tok_bits2"][:, -1] = np.uint32((1 << tail) - 1)

    meta = {
        "dataset_id": dataset_id,
        "vcf_location": f"synthetic://{dataset_id}",
        "sample_names": [f"S{i}" for i in range(n_samples)],
        "vt_vocab": ["N/A"],
        "n_rows": n,
        "n_records": n_rec,
        "dropped_records": 0,
        "variant_count": n,
        "call_count": int(an_val) * n_rec,
        "sample_count": n_samples,
        "chrom_native": {c: c for c in chroms},
        "format_version": 1,
        "synthetic": True,
        "position_model": "uniform",
    }
    return VariantIndexShard(
        meta=meta,
        cols=cols,
        chrom_offsets=chrom_offsets,
        ref_blob=ref_blob.astype(np.uint8),
        ref_off=ref_off,
        alt_blob=alt_blob.astype(np.uint8),
        alt_off=alt_off,
        vt_codes=np.zeros(n, np.int16),
        **planes,
    )


def subset_shard(shard, rows, *, dataset_id: str):
    """A shard of the given rows of ``shard`` (ascending row ids): the
    same sites submitted again in a further VCF, the duplication the
    distinct-variant count removes. Columns, chromosome offsets, REF/ALT
    blobs and variant-type codes are cut by numpy row selection; the
    genotype planes are left out."""
    import dataclasses

    import numpy as np

    rows = np.asarray(rows, dtype=np.int64)

    def blob_rows(blob, off):
        starts = off[rows].astype(np.int64)
        lens = off[rows + 1].astype(np.int64) - starts
        new_off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=new_off[1:])
        src = np.repeat(starts - new_off[:-1], lens) + np.arange(
            int(new_off[-1]), dtype=np.int64
        )
        return blob[src], new_off.astype(off.dtype)

    ref_blob, ref_off = blob_rows(shard.ref_blob, shard.ref_off)
    alt_blob, alt_off = blob_rows(shard.alt_blob, shard.alt_off)
    meta = dict(shard.meta, dataset_id=dataset_id,
                vcf_location=f"synthetic://{dataset_id}", n_rows=len(rows))
    return dataclasses.replace(
        shard,
        meta=meta,
        cols={k: v[rows] for k, v in shard.cols.items()},
        chrom_offsets=np.searchsorted(rows, shard.chrom_offsets).astype(
            shard.chrom_offsets.dtype
        ),
        ref_blob=ref_blob,
        ref_off=ref_off,
        alt_blob=alt_blob,
        alt_off=alt_off,
        vt_codes=shard.vt_codes[rows],
        gt_bits=None,
        gt_bits2=None,
        tok_bits1=None,
        tok_bits2=None,
        gt_overflow=None,
        tok_overflow=None,
    )


def distinct_key_cases(seed: int = 3) -> dict:
    """Crafted [n, 6] int32 key sets for the distinct count, by name:
    every key equal (all threads contend for one slot), keys differing in
    one column only, high-bit patterns (INT32_MIN, -1 and INT32_MAX in
    every column, column 0 included but never INT32_MAX there), ``_PAD``
    rows (column 0 alone marks one), INT32_MAX in the other columns of
    real rows, and 0, 1, 2 and 1000 keys."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i32 = np.int32
    lo, hi = np.iinfo(i32).min, np.iinfo(i32).max
    row = np.array([[3, 7, -5, 9, 1, 1]], i32)
    one_col = np.tile(row, (6 * 50, 1))
    for c in range(6):
        one_col[c * 50 : (c + 1) * 50, c] = np.arange(50) - 25
    high = rng.choice(np.array([lo, -1, hi, 0, 1], i32), size=(4000, 6))
    high[:, 0] = rng.choice(np.array([lo, -1, 0, 5], i32), 4000)
    padded = rng.integers(0, 4, size=(3000, 6)).astype(i32)
    padded[::3] = hi  # whole pad rows, as partition_keys writes them
    padded[1::7, 0] = hi
    pad_other = rng.integers(0, 3, size=(2000, 6)).astype(i32)
    pad_other[:, 1:][rng.random((2000, 5)) < 0.3] = hi
    return {
        "all_equal": np.tile(row, (5000, 1)),
        "one_column_differs": one_col,
        "high_bits": high.astype(i32),
        "padded": padded,
        "pad_in_other_columns": pad_other,
        "empty": np.zeros((0, 6), i32),
        "one": row.copy(),
        "two": np.concatenate([row, row + 1]),
        "two_equal": np.concatenate([row, row]),
        "thousand": rng.integers(-2, 2, size=(1000, 6)).astype(i32),
    }


def _edge_records(rng, sizes, chrom, start):
    """Records of the given alt counts at increasing positions (gaps of 2
    or more, so a window can end on any record), AC and AN near the int32
    ends now and then."""
    pool = ["".join(p) for n in (1, 2, 3)
            for p in itertools.product(BASES, repeat=n)]
    recs, pos = [], start
    for k in sizes:
        pos += rng.choice([2, 2, 3, 6])
        recs.append(VcfRecord(
            chrom=chrom, pos=pos, ref="A", alts=pool[:k], vt="N/A",
            ac=[rng.choice([0, 1, 3, 2**31 - 1, -7]) for _ in range(k)],
            an=rng.choice([10, 2**31 - 5, 77]), genotypes=[]))
    return recs


def window_edge_shards(n: int, seed: int = 31) -> list:
    """n shards of chromosome 3 for the bisection query's window edges:
    even ones of 4000 single-row records (a window of any lane count),
    odd ones of 400 records of 1, 12 and 40 rows (records cut by every
    256-lane chunk and cluster-rank edge)."""
    from .index.columnar import build_index

    rng = random.Random(seed)
    out = []
    for d in range(n):
        sizes = ([1] * 4000 if d % 2 == 0
                 else [rng.choice([1, 12, 40]) for _ in range(400)])
        out.append(build_index(_edge_records(rng, sizes, "3", 1000 + 7 * d),
                               dataset_id=f"e{d}"))
    return out


def window_edge_specs(shards, seed: int):
    """(specs, shard ids) over ``window_edge_shards``: windows of exactly
    1, 255, 256, 257, 1400, 2048, 2049, 3000 and 3500 lanes on the
    single-row shards, six of 1-4000 rows on the others, in any-base,
    exact, INS and length-bounded modes."""
    from .ops.kernel import QuerySpec

    rng = random.Random(seed)
    specs, sids = [], []
    modes = [dict(alternate_bases="N"), dict(alternate_bases="A"),
             dict(variant_type="INS"),
             dict(alternate_bases="N", variant_max_length=2)]
    for sid, sh in enumerate(shards):
        pos = sh.cols["pos"]
        widths = ((1, 255, 256, 257, 1400, 2048, 2049, 3000, 3500)
                  if sid % 2 == 0
                  else tuple(rng.choice([1, 3, 255, 300, 1500, 2100, 4000])
                             for _ in range(6)))
        for n in widths:
            a = rng.randrange(0, max(1, len(pos) - n))
            b = min(a + n - 1, len(pos) - 1)
            specs.append(QuerySpec(chrom="3", start_min=int(pos[a]),
                                   start_max=int(pos[b]), end_min=1,
                                   end_max=1 << 30, **rng.choice(modes)))
            sids.append(sid)
    return specs, sids


def l0_tail_keys(n_keys: int, shards_per_key: int, seed: int = 41,
                 max_records: int = 500) -> list:
    """Delta tails for the L0 index: ``n_keys`` lists of
    ``shards_per_key`` small shards on chromosome 3 (records of 1, 12
    and 40 rows at dense positions, 1 to ``max_records`` records a
    shard), each key's shards interleaved in position like a stream of
    publishes."""
    from .index.columnar import build_index

    rng = random.Random(seed)
    keys = []
    for k in range(n_keys):
        shards = []
        for d in range(shards_per_key):
            n = rng.randint(1, max_records)
            sizes = [rng.choice([1, 1, 12, 40]) for _ in range(n)]
            shards.append(build_index(
                _edge_records(rng, sizes, "3", 1000 + 5 * d + 3 * k),
                dataset_id=f"k{k}", vcf_location=f"k{k}.vcf"))
        keys.append(shards)
    return keys


def l0_tail_specs(composite, keys, seed: int, n_per_block: int = 12):
    """(specs, shard ids) over a ``CompositeL0DeviceIndex`` of
    ``l0_tail_keys``: windows of 1 to 5000 rows on the real shards of
    every block (its first and last shard among them), in any-base,
    exact, INS and length-bounded modes, and a query on a pad row of
    each block that has one (an empty segment: nothing matches)."""
    from .ops.kernel import QuerySpec

    rng = random.Random(seed)
    modes = [dict(alternate_bases="N"), dict(alternate_bases="A"),
             dict(variant_type="INS"),
             dict(alternate_bases="N", variant_max_length=2)]
    specs, sids = [], []
    for off, shards, block in zip(composite.block_sid_offsets, keys,
                                  composite.blocks):
        picks = [0, len(shards) - 1] + [
            rng.randrange(len(shards)) for _ in range(n_per_block - 2)]
        for j in picks:
            pos = shards[j].cols["pos"]
            n = rng.choice([1, 40, 255, 256, 257, 1000, 2048, 2500, 5000])
            a = rng.randrange(0, max(1, len(pos) - n))
            b = min(a + n - 1, len(pos) - 1)
            specs.append(QuerySpec(chrom="3", start_min=int(pos[a]),
                                   start_max=int(pos[b]), end_min=1,
                                   end_max=1 << 30, **rng.choice(modes)))
            sids.append(off + j)
        if block.n_shards_padded > block.n_shards:
            specs.append(QuerySpec(chrom="3", start_min=1, start_max=1 << 29,
                                   end_min=1, end_max=1 << 30,
                                   alternate_bases="N"))
            sids.append(off + block.n_shards_padded - 1)
    return specs, sids
