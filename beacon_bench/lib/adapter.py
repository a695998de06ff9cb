"""Hand the benchmark's rows to the program: one
``sbeacon_tpu_torch.index.columnar.VariantIndexShard`` per dataset,
built as ``sbeacon_tpu_torch.testing.synthetic_shard`` builds its
shard (the program's own encoders for hashes, flags, prefixes and
repeat counts; every row's AC and AN from INFO), with the dataset's
genotype plane as its ``gt_bits``. Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np

from .datagen import CHROMS, Dataset


def to_shard(ds: Dataset):
    from sbeacon_tpu_torch.index.columnar import (
        FLAG,
        N_CHROM_CODES,
        VariantIndexShard,
        _alt_flags,
        _ref_repeat_k,
        fnv1a32,
        pack_prefix16,
    )
    from sbeacon_tpu_torch.utils.chrom import chromosome_code

    vocab = ds.vocab
    V = len(vocab)
    v_bytes = [v.encode() for v in vocab]
    v_len = np.array([len(v) for v in vocab], np.int64)
    v_hash = np.array([fnv1a32(v.upper().encode()) for v in vocab], np.int32)
    v_flags = np.array([_alt_flags(v) for v in vocab], np.int32)
    v_prefix = np.stack([pack_prefix16(b) for b in v_bytes]).astype(np.uint32)
    k_tab = np.array([[_ref_repeat_k(r, a) for a in vocab] for r in vocab],
                     np.int32)

    ref_id = ds.ref_id.astype(np.int64)
    alt_id = ds.alt_id.astype(np.int64)
    n = ds.n_rows
    pos = ds.pos.astype(np.int32)
    ref_len = v_len[ref_id].astype(np.int32)
    cols = {
        "pos": pos,
        "rec_end": (pos.astype(np.int64) + ref_len - 1).astype(np.int32),
        "ref_len": ref_len,
        "alt_len": v_len[alt_id].astype(np.int32),
        "ref_hash": v_hash[ref_id],
        "alt_hash": v_hash[alt_id],
        "ref_repeat_k": k_tab[ref_id, alt_id],
        "flags": (v_flags[alt_id] | np.int32(FLAG.AC_INFO)
                  | np.int32(FLAG.AN_INFO)).astype(np.int32),
        "ac": ds.ac.astype(np.int32),
        "an": ds.an.astype(np.int32),
        "rec_id": ds.rec_id.astype(np.int32),
        "alt_prefix": v_prefix[alt_id],
    }
    codes = np.array([chromosome_code(c) for c in CHROMS], np.int64)
    if not (np.diff(codes) > 0).all():
        raise ValueError("chromosome codes must ascend in CHROMS order")
    row_code = codes[ds.chrom.astype(np.int64)]
    chrom_offsets = np.searchsorted(
        row_code, np.arange(N_CHROM_CODES + 1), side="left").astype(np.int32)

    concat = np.frombuffer(b"".join(v_bytes), np.uint8)
    v_start = np.concatenate([[0], np.cumsum(v_len)[:-1]])

    def blob_of(ids):
        lens = v_len[ids]
        off = np.zeros(n + 1, np.uint32)
        np.cumsum(lens, out=off[1:])
        within = np.arange(int(off[-1]), dtype=np.int64) - np.repeat(
            off[:-1].astype(np.int64), lens)
        return concat[np.repeat(v_start[ids], lens) + within], off

    ref_blob, ref_off = blob_of(ref_id)
    alt_blob, alt_off = blob_of(alt_id)
    n_samples = len(ds.sample_names)
    planes = {}
    if ds.gt is not None:
        empty = np.zeros((0, 3), np.int64)
        planes = {"gt_bits": ds.gt, "gt_overflow": empty,
                  "tok_overflow": empty}
    an_val = int(ds.an[0]) if n else 0
    meta = {
        "dataset_id": ds.dataset_id,
        "vcf_location": f"synthetic://{ds.dataset_id}",
        "sample_names": list(ds.sample_names),
        "vt_vocab": ["N/A"],
        "n_rows": n,
        "n_records": ds.n_records,
        "dropped_records": 0,
        "variant_count": n,
        "call_count": an_val * ds.n_records,
        "sample_count": n_samples,
        "chrom_native": {c: c for c in CHROMS},
        "format_version": 1,
        "synthetic": True,
        "position_model": "uniform",
    }
    return VariantIndexShard(
        meta=meta, cols=cols, chrom_offsets=chrom_offsets,
        ref_blob=ref_blob, ref_off=ref_off, alt_blob=alt_blob,
        alt_off=alt_off, vt_codes=np.zeros(n, np.int16), **planes)
