"""Synthetic population generator — the simulation harness.

Counterpart of ``sbeacon_tpu/harness/simulate.py``, copied whole. Plays the role of the reference's ``simulations/simulate.py`` (1181 LoC of
random entity generators seeded straight into DynamoDB/S3 ORC) but goes
through the REAL ingestion path: every dataset is a full ``/submit``
payload (entities + a generated bgzipped VCF), so the simulator also
exercises submission validation, the slice pipeline, the ledger and the
indexer — the de-facto integration test the reference's harness was
(SURVEY.md §4).

Ontology terms are drawn from small realistic pools (HP phenotypes, NCIT
sexes, SNOMED-ish diseases) so filtering-term queries have structure to
chew on, mirroring the reference's get_random_individual/biosample/... term
sampling.
"""

from __future__ import annotations

import random
from pathlib import Path

from ..genomics.tabix import ensure_index
from ..genomics.vcf import write_vcf
from ..testing import random_records

SEX_TERMS = [
    ("NCIT:C16576", "female"),
    ("NCIT:C20197", "male"),
]
PHENOTYPE_TERMS = [
    ("HP:0000118", "Phenotypic abnormality"),
    ("HP:0001626", "Abnormality of the cardiovascular system"),
    ("HP:0000707", "Abnormality of the nervous system"),
    ("HP:0002086", "Abnormality of the respiratory system"),
    ("HP:0011024", "Abnormality of the gastrointestinal tract"),
]
DISEASE_TERMS = [
    ("SNOMED:38341003", "Hypertensive disorder"),
    ("SNOMED:73211009", "Diabetes mellitus"),
    ("SNOMED:195967001", "Asthma"),
    ("SNOMED:53741008", "Coronary arteriosclerosis"),
]
BIOSAMPLE_STATUS = [
    ("EFO:0009654", "reference sample"),
    ("EFO:0009655", "abnormal sample"),
]
PLATFORMS = ["Illumina NovaSeq 6000", "Illumina HiSeq X", "PacBio Sequel"]


def _term(pair):
    return {"id": pair[0], "label": pair[1]}


def random_submission(
    rng: random.Random,
    dataset_id: str,
    vcf_path: str | Path,
    *,
    n_individuals: int = 8,
    assembly_id: str = "GRCh38",
    index: bool = False,
) -> dict:
    """One /submit payload with coherent entity links (individual ->
    biosample -> run -> analysis -> VCF sample), term-rich metadata."""
    samples = [f"{dataset_id}-S{i}" for i in range(n_individuals)]
    individuals = [
        {
            "id": f"{dataset_id}-I{i}",
            "sex": _term(rng.choice(SEX_TERMS)),
            "karyotypicSex": rng.choice(["XX", "XY"]),
            "diseases": [
                {"diseaseCode": _term(rng.choice(DISEASE_TERMS))}
                for _ in range(rng.randint(0, 2))
            ],
            "phenotypicFeatures": [
                {"featureType": _term(rng.choice(PHENOTYPE_TERMS))}
                for _ in range(rng.randint(0, 2))
            ],
            "ethnicity": _term(
                ("SNOMED:413490006", "Other ethnic, mixed origin")
            ),
        }
        for i in range(n_individuals)
    ]
    biosamples = [
        {
            "id": f"{dataset_id}-B{i}",
            "individualId": f"{dataset_id}-I{i}",
            "biosampleStatus": _term(rng.choice(BIOSAMPLE_STATUS)),
            "sampleOriginType": _term(("UBERON:0000178", "blood")),
        }
        for i in range(n_individuals)
    ]
    runs = [
        {
            "id": f"{dataset_id}-R{i}",
            "individualId": f"{dataset_id}-I{i}",
            "biosampleId": f"{dataset_id}-B{i}",
            "libraryLayout": "PAIRED",
            "librarySource": _term(("GENEPIO:0001966", "genomic source")),
            "platform": rng.choice(PLATFORMS),
        }
        for i in range(n_individuals)
    ]
    analyses = [
        {
            "id": f"{dataset_id}-A{i}",
            "individualId": f"{dataset_id}-I{i}",
            "biosampleId": f"{dataset_id}-B{i}",
            "runId": f"{dataset_id}-R{i}",
            "vcfSampleId": samples[i],
            "aligner": "bwa-mem2",
            "variantCaller": "GATK4",
        }
        for i in range(n_individuals)
    ]
    return {
        "datasetId": dataset_id,
        "assemblyId": assembly_id,
        "vcfLocations": [str(vcf_path)],
        "dataset": {
            "name": f"Synthetic dataset {dataset_id}",
            "description": "simulation harness dataset",
            "version": "v1",
        },
        "cohortId": f"{dataset_id}-cohort",
        "cohort": {
            "name": f"Cohort of {dataset_id}",
            "cohortType": "study-defined",
        },
        "individuals": individuals,
        "biosamples": biosamples,
        "runs": runs,
        "analyses": analyses,
        "index": index,
    }


def populate(
    app,
    root: str | Path,
    *,
    n_datasets: int = 2,
    n_individuals: int = 8,
    records_per_chrom: int = 300,
    chroms: tuple[str, ...] = ("1", "22"),
    seed: int = 42,
) -> dict:
    """Generate datasets end-to-end through POST /submit; returns a summary
    {dataset_id: records}. The last submission runs the indexer, matching
    the reference flow (simulate then index, USER_GUIDE.md:33-35)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = random.Random(seed)
    out = {}
    for d in range(n_datasets):
        ds = f"sim{d}"
        recs = []
        for chrom in chroms:
            recs.extend(
                random_records(
                    rng,
                    chrom=chrom,
                    n=records_per_chrom,
                    n_samples=n_individuals,
                )
            )
        vcf = root / f"{ds}.vcf.gz"
        write_vcf(
            vcf,
            recs,
            sample_names=[f"{ds}-S{i}" for i in range(n_individuals)],
        )
        ensure_index(vcf)
        sub = random_submission(
            rng,
            ds,
            vcf,
            n_individuals=n_individuals,
            index=(d == n_datasets - 1),
        )
        status, body = app.handle("POST", "/submit", body=sub)
        if status != 200:
            raise RuntimeError(f"submit failed for {ds}: {body}")
        out[ds] = recs
    return out
