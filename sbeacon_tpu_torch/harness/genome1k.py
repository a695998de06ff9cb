"""1000-Genomes-scale cohort generation and a full-pipeline ingest run.

Counterpart of ``sbeacon_tpu/harness/genome1k.py``, copied whole. The
reference demonstrates scale through its simulation harness (1000
datasets x 1000-sample template = 1M individuals, reference:
simulations/USER_GUIDE.md:13-17) and designs for multi-GB VCFs (750 MB
range packing main.tf:16, <=1000-slice fan-outs summariseVcf:25). This
module generates chr1-22 VCF text at real cohort shape — 2504 genotype
columns whose AC/AN INFO stays exactly consistent with the GT carriers
— and pushes it through the real ingest pipeline (BGZF -> tabix ->
slice planner -> native tokenizer -> genotype planes -> merge),
recording wall times in a manifest (``build_corpus``). Its writer is
not ``testing.write_cohort_vcf``: that one draws ``random_records``'
site mix, this one AC/AN from painted carriers.

Generation is vectorised per chunk: the genotype block starts as a
tiled ``\\t0|0`` byte matrix and carriers are painted by fancy
indexing (a het carrier flips one byte), so a 2504-sample line costs
numpy work, not Python. Disk stays bounded: each chromosome's VCF is
deleted as soon as its shard is persisted.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from ..genomics.bgzf import BgzfWriter
from ..utils.chrom import CHROMOSOME_LENGTHS

HEADER = (
    "##fileformat=VCFv4.3\n"
    '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">\n'
    '##INFO=<ID=AN,Number=1,Type=Integer,Description="Allele number">\n'
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
)

_BASES = np.frombuffer(b"ACGT", np.uint8)


def write_cohort_vcf(
    path: str | Path,
    *,
    chrom: str,
    n_records: int,
    n_samples: int,
    seed: int = 0,
    start_pos: int = 1,
    end_pos: int | None = None,
    p_multiallelic: float = 0.06,
    p_indel: float = 0.10,
    chunk: int = 8192,
    level: int = 1,
    position_model: str = "uniform",
) -> dict:
    """Generate one chromosome's bgzipped VCF with real GT columns.

    AC/AN INFO is derived FROM the painted carriers (AC = het carriers
    per alt, AN = 2*n_samples), so genotype-plane ingestion and
    INFO-based counting agree exactly — the parity bar for the real
    pipeline. Returns {records, bytes_raw, bytes_compressed, seconds}.
    """
    rng = np.random.default_rng(seed)
    path = Path(path)
    end_pos = end_pos or CHROMOSOME_LENGTHS.get(chrom, 100_000_000)
    t0 = time.perf_counter()
    raw = 0
    names = "\t".join(f"S{i}" for i in range(n_samples))
    head = (
        HEADER
        + f"##contig=<ID={chrom}>\n"
        + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + names
        + "\n"
    ).encode()

    # sorted positions across the whole chromosome
    u = rng.random(n_records)
    if position_model == "clustered":
        hot = rng.random(n_records) < 0.3
        centers = rng.random(48)
        idx = rng.integers(0, 48, n_records)
        u = np.where(
            hot,
            np.clip(centers[idx] + rng.normal(0, 0.004, n_records), 0, 1),
            u,
        )
    positions = np.sort(
        (start_pos + u * (end_pos - start_pos)).astype(np.int64)
    )

    gt_cell = np.frombuffer(b"\t0|0", np.uint8)
    an = 2 * n_samples
    with BgzfWriter(path, level=level) as out:
        out.write(head)
        raw += len(head)
        for base in range(0, n_records, chunk):
            m = min(chunk, n_records - base)
            pos = positions[base : base + m]
            multi = rng.random(m) < p_multiallelic
            indel = rng.random(m) < p_indel
            ref_i = rng.integers(0, 4, m)
            ref_b = _BASES[ref_i]
            # alt bases distinct from ref by +d1 rotation (d1 in 1..3);
            # the second alt uses a DIFFERENT rotation d2 != d1, so it
            # can never equal the ref or the first alt
            d1 = rng.integers(1, 4, m)
            d2 = 1 + (d1 - 1 + rng.integers(1, 3, m)) % 3
            alt_b = _BASES[(ref_i + d1) % 4]
            alt2_b = _BASES[(ref_i + d2) % 4]
            # carriers: heavy-tailed AF; each carrier is one painted het
            k1 = np.minimum(
                (1.0 / np.maximum(rng.random(m), 1e-4)).astype(np.int64),
                max(1, n_samples // 3),
            )
            k2 = np.where(
                multi, np.maximum(k1 // 3, 1), 0
            )  # alt-2 carriers
            gt = np.tile(gt_cell, (m, n_samples))  # [m, 4*n_samples]
            for kvec, digit in ((k1, ord("1")), (k2, ord("2"))):
                total = int(kvec.sum())
                if not total:
                    continue
                rows = np.repeat(np.arange(m), kvec)
                # sample slot per carrier (collisions harmless: a later
                # paint overwrites an earlier one and AC is recomputed
                # from the painted bytes below)
                slots = rng.integers(0, n_samples, total)
                gt[rows, slots * 4 + 3] = digit
            # recompute AC from the painted bytes (exact consistency)
            alt_digit = gt[:, 3::4]
            ac1 = (alt_digit == ord("1")).sum(axis=1)
            ac2 = (alt_digit == ord("2")).sum(axis=1)

            parts = []
            for i in range(m):
                ref = chr(ref_b[i])
                if indel[i]:
                    ref = ref + "ACGT"[int(pos[i]) % 4] * (
                        1 + int(pos[i]) % 5
                    )
                alt = chr(alt_b[i])
                info_ac = str(int(ac1[i]))
                if multi[i]:
                    alt = f"{alt},{chr(alt2_b[i])}"
                    info_ac = f"{int(ac1[i])},{int(ac2[i])}"
                parts.append(
                    f"{chrom}\t{int(pos[i])}\t.\t{ref}\t{alt}\t.\t.\t"
                    f"AC={info_ac};AN={an}\tGT".encode()
                    + gt[i].tobytes()
                    + b"\n"
                )
            blob = b"".join(parts)
            raw += len(blob)
            out.write(blob)
    return {
        "records": n_records,
        "bytes_raw": raw,
        "bytes_compressed": path.stat().st_size,
        "seconds": round(time.perf_counter() - t0, 2),
    }


def chrom_record_counts(total: int, chroms: list[str]) -> dict[str, int]:
    """Split a total record budget across chromosomes proportionally to
    their real GRCh38 lengths (1000G variant counts roughly track
    chromosome length)."""
    lens = np.array([CHROMOSOME_LENGTHS[c] for c in chroms], np.float64)
    share = lens / lens.sum()
    counts = (share * total).astype(np.int64)
    counts[0] += total - int(counts.sum())
    return {c: int(n) for c, n in zip(chroms, counts)}


def build_corpus(
    root: str | Path,
    *,
    total_records: int = 20_000_000,
    n_samples: int = 2504,
    chroms: list[str] | None = None,
    seed: int = 1000,
    dataset_id: str = "genomes1k",
    keep_vcfs: bool = False,
    manifest_path: str | Path | None = None,
    config=None,
) -> dict:
    """Generate + ingest the full corpus through the real pipeline.

    Per chromosome: write bgzipped VCF -> tabix -> SummarisationPipeline
    .summarise_vcf (slice planner + native tokenizer + genotype planes)
    -> persist shard -> delete VCF. Resumable: chromosomes whose shard
    already exists are skipped. The manifest records per-chromosome
    generation/ingest wall times and the totals the judge needs.
    """
    from ..config import BeaconConfig, StorageConfig
    from ..genomics.tabix import ensure_index
    from ..index.columnar import save_index
    from ..ingest.pipeline import SummarisationPipeline

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    chroms = chroms or [str(i) for i in range(1, 23)]
    counts = chrom_record_counts(total_records, chroms)
    config = config or BeaconConfig(storage=StorageConfig(root=root / "store"))
    config.storage.ensure()
    pipe = SummarisationPipeline(config)
    manifest_path = Path(manifest_path or root / "manifest.json")
    manifest = (
        json.loads(manifest_path.read_text())
        if manifest_path.exists()
        else {"chroms": {}}
    )
    manifest.update(
        total_records=total_records,
        n_samples=n_samples,
        dataset_id=dataset_id,
    )

    for ci, chrom in enumerate(chroms):
        shard_path = root / f"shard_chr{chrom}.npz"
        if chrom in manifest["chroms"] and shard_path.exists():
            continue
        vcf = root / f"chr{chrom}.vcf.gz"
        gen = write_cohort_vcf(
            vcf,
            chrom=chrom,
            n_records=counts[chrom],
            n_samples=n_samples,
            seed=seed + ci,
        )
        ensure_index(vcf)
        t0 = time.perf_counter()
        shard = pipe.summarise_vcf(dataset_id, str(vcf))
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_index(shard, shard_path, compress=True)
        save_s = time.perf_counter() - t0
        manifest["chroms"][chrom] = {
            **gen,
            "rows": shard.n_rows,
            "n_records_ingested": shard.meta["n_records"],
            "ingest_seconds": round(ingest_s, 2),
            "ingest_rec_per_s": round(counts[chrom] / max(ingest_s, 1e-9), 1),
            "ingest_raw_mb_per_s": round(
                gen["bytes_raw"] / 1e6 / max(ingest_s, 1e-9), 1
            ),
            "save_seconds": round(save_s, 2),
        }
        manifest_path.write_text(json.dumps(manifest, indent=1))
        if not keep_vcfs:
            vcf.unlink(missing_ok=True)
            Path(str(vcf) + ".tbi").unlink(missing_ok=True)
    c = manifest["chroms"]
    manifest["totals"] = {
        "rows": int(sum(v["rows"] for v in c.values())),
        "records": int(sum(v["records"] for v in c.values())),
        "bytes_raw": int(sum(v["bytes_raw"] for v in c.values())),
        "gen_seconds": round(sum(v["seconds"] for v in c.values()), 1),
        "ingest_seconds": round(
            sum(v["ingest_seconds"] for v in c.values()), 1
        ),
        "ingest_rec_per_s": round(
            sum(v["records"] for v in c.values())
            / max(sum(v["ingest_seconds"] for v in c.values()), 1e-9),
            1,
        ),
        "ingest_raw_mb_per_s": round(
            sum(v["bytes_raw"] for v in c.values())
            / 1e6
            / max(sum(v["ingest_seconds"] for v in c.values()), 1e-9),
            1,
        ),
    }
    manifest_path.write_text(json.dumps(manifest, indent=1))
    return manifest


def load_merged(root: str | Path, chroms: list[str] | None = None):
    """Load + merge the per-chromosome shards into the one serving shard
    (engine layout: single shard, chrom_offsets spanning chr1-22)."""
    from ..index.columnar import load_index, merge_shards

    root = Path(root)
    chroms = chroms or [str(i) for i in range(1, 23)]
    shards = [
        load_index(root / f"shard_chr{c}.npz")
        for c in chroms
        if (root / f"shard_chr{c}.npz").exists()
    ]
    return merge_shards(shards)
