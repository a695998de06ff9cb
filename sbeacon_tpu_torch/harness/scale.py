"""Metadata-plane scale harness: 1M individuals / 1000 datasets.

Counterpart of ``sbeacon_tpu/harness/scale.py``, copied whole but for
``run_metadata_scale``'s ``device`` and its closing of the app it
builds. The reference demonstrates its metadata plane at 1M synthetic
individuals by seeding DynamoDB/S3-ORC directly with its simulation
generator (reference: simulations/simulate.py + USER_GUIDE.md:13-17 —
the harness bypasses the API on the write side, then runs the indexer
and measures queries against the deployed API). This module is the
same shape for our stack, as the DOCUMENTED BULK PATH: entity
documents go through ``MetadataStore.upsert`` — the exact write call
``/submit`` uses (api/submit.py:211-232), minus request-schema
validation — in large batches; then ``rebuild_indexes`` (the indexer
lambda equivalent) and the filtered-query surface are measured through
the REAL HTTP route handlers (``BeaconApp.handle``), so the read path
exercises the filter compiler, ontology expansion, relations joins and
response envelopes end-to-end.

Driven out-of-band; unit tests pin the harness at small scale.
"""

from __future__ import annotations

import json
import random
import statistics
import time
from pathlib import Path

from .simulate import (
    BIOSAMPLE_STATUS,
    DISEASE_TERMS,
    PHENOTYPE_TERMS,
    PLATFORMS,
    SEX_TERMS,
    _term,
)


def populate_metadata_bulk(
    store,
    *,
    n_datasets: int = 1000,
    individuals_per: int = 1000,
    seed: int = 7,
    batch: int = 20_000,
) -> dict:
    """Seed datasets/cohorts/individuals/biosamples/runs/analyses with
    coherent links and term-rich metadata at arbitrary scale.

    Returns {entities, seconds, entities_per_s}. Documents match
    ``harness.simulate.random_submission``'s shapes (the /submit form),
    with `_datasetid`/`_cohortid` linkage columns populated exactly as
    the submit handler stores them.
    """
    rng = random.Random(seed)
    t0 = time.perf_counter()
    total = 0

    datasets, cohorts = [], []
    for d in range(n_datasets):
        ds = f"sim{d}"
        datasets.append(
            {
                "id": ds,
                "name": f"Synthetic dataset {ds}",
                "description": "metadata scale harness",
                "version": "v1",
                "_assemblyId": "GRCh38",
                "_vcfLocations": [f"synthetic://{ds}.vcf.gz"],
            }
        )
        cohorts.append(
            {
                "id": f"{ds}-cohort",
                "name": f"Cohort of {ds}",
                "cohortType": "study-defined",
                "_datasetId": ds,
            }
        )
    store.upsert("datasets", datasets)
    store.upsert("cohorts", cohorts)
    total += len(datasets) + len(cohorts)

    buf = {k: [] for k in ("individuals", "biosamples", "runs", "analyses")}

    def flush():
        nonlocal total
        for kind, docs in buf.items():
            if docs:
                store.upsert(kind, docs)
                total += len(docs)
                buf[kind] = []

    for d in range(n_datasets):
        ds = f"sim{d}"
        for i in range(individuals_per):
            iid = f"{ds}-I{i}"
            buf["individuals"].append(
                {
                    "id": iid,
                    "_datasetId": ds,
                    "_cohortId": f"{ds}-cohort",
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
                }
            )
            buf["biosamples"].append(
                {
                    "id": f"{ds}-B{i}",
                    "individualId": iid,
                    "_datasetId": ds,
                    "biosampleStatus": _term(rng.choice(BIOSAMPLE_STATUS)),
                    "sampleOriginType": _term(("UBERON:0000178", "blood")),
                }
            )
            buf["runs"].append(
                {
                    "id": f"{ds}-R{i}",
                    "individualId": iid,
                    "biosampleId": f"{ds}-B{i}",
                    "_datasetId": ds,
                    "libraryLayout": "PAIRED",
                    "platform": rng.choice(PLATFORMS),
                }
            )
            buf["analyses"].append(
                {
                    "id": f"{ds}-A{i}",
                    "individualId": iid,
                    "biosampleId": f"{ds}-B{i}",
                    "runId": f"{ds}-R{i}",
                    "_datasetId": ds,
                    "_vcfSampleId": f"{ds}-S{i}",
                    "aligner": "bwa-mem2",
                    "variantCaller": "GATK4",
                }
            )
            if len(buf["individuals"]) >= batch:
                flush()
    flush()
    dt = time.perf_counter() - t0
    return {
        "entities": total,
        "individuals": n_datasets * individuals_per,
        "seconds": round(dt, 2),
        "entities_per_s": round(total / dt, 1),
    }


def seed_phenotype_closure(ontology) -> None:
    """Minimal HP closure so ontology-expanded filters have descendants
    (the indexer's OLS role, exercised without network)."""
    root = "HP:0000118"
    ontology.register_edges(
        (child[0], root) for child in PHENOTYPE_TERMS if child[0] != root
    )


def _lat(handle, method, path, body=None, reps=5):
    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        status, out = handle(method, path, body=body)
        times.append(time.perf_counter() - t0)
        assert status == 200, (path, status, str(out)[:200])
    return {
        "p50_ms": round(statistics.median(times) * 1e3, 2),
        "best_ms": round(min(times) * 1e3, 2),
    }, out


def measure_metadata_plane(app, *, reps: int = 5) -> dict:
    """Filtered-query latency through the real route handlers.

    Covers boolean/count/record granularities, ontology-expanded
    filters, and cross-entity routes.
    """
    report = {}

    def post_body(gran, filters=None):
        q: dict = {"query": {"requestedGranularity": gran}}
        if filters:
            q["query"]["filters"] = filters
        return q

    sex_filter = [{"id": SEX_TERMS[0][0]}]
    pheno_root = [{"id": "HP:0000118", "includeDescendantTerms": True}]
    for gran in ("boolean", "count", "record"):
        report[f"individuals_sex_{gran}"], _ = _lat(
            app.handle,
            "POST",
            "/individuals",
            post_body(gran, sex_filter),
            reps,
        )
    report["individuals_ontology_count"], out = _lat(
        app.handle, "POST", "/individuals", post_body("count", pheno_root), reps
    )
    report["ontology_count_result"] = out.get("responseSummary", {}).get(
        "numTotalResults"
    )
    report["biosamples_count"], _ = _lat(
        app.handle,
        "POST",
        "/biosamples",
        post_body("count", [{"id": BIOSAMPLE_STATUS[0][0]}]),
        reps,
    )
    # cross-entity: one individual's biosamples; one dataset's individuals
    report["individual_biosamples"], _ = _lat(
        app.handle, "GET", "/individuals/sim0-I0/biosamples", None, reps
    )
    report["dataset_individuals_record"], _ = _lat(
        app.handle,
        "POST",
        "/datasets/sim0/individuals",
        post_body("record"),
        reps,
    )
    report["filtering_terms"], _ = _lat(
        app.handle, "GET", "/filtering_terms", None, reps
    )
    return report


def run_metadata_scale(
    root: str | Path,
    *,
    n_datasets: int = 1000,
    individuals_per: int = 1000,
    report_path: str | Path | None = None,
    device=None,
) -> dict:
    """End-to-end scale run: bulk seed -> rebuild_indexes -> measured
    query surface; writes the report JSON. The app's engine serves on
    ``device`` (the card unless the caller passes ``"cpu"``); the app,
    its store and its ontology are closed at the end."""
    from ..api import BeaconApp
    from ..config import BeaconConfig, StorageConfig
    from ..metadata import MetadataStore, OntologyStore

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    config = BeaconConfig(storage=StorageConfig(root=root))
    config.storage.ensure()
    ontology = OntologyStore(config.storage.ontology_db)
    store = MetadataStore(config.storage.metadata_db, ontology=ontology)
    seed_phenotype_closure(ontology)

    report: dict = {
        "n_datasets": n_datasets,
        "individuals_per_dataset": individuals_per,
    }
    report["populate"] = populate_metadata_bulk(
        store, n_datasets=n_datasets, individuals_per=individuals_per
    )
    t0 = time.perf_counter()
    store.rebuild_indexes()
    report["rebuild_indexes_seconds"] = round(time.perf_counter() - t0, 2)
    report["terms_rows"] = int(
        store.query("SELECT COUNT(*) FROM terms")[0][0]
    )
    report["terms_index_rows"] = int(
        store.query("SELECT COUNT(*) FROM terms_index")[0][0]
    )
    report["relations_rows"] = int(
        store.query("SELECT COUNT(*) FROM relations")[0][0]
    )

    app = BeaconApp(config, store=store, ontology=ontology, device=device)
    try:
        report["queries"] = measure_metadata_plane(app)
    finally:
        app.close()
        app.engine.close()
        store.close()
        ontology.close()
    out = Path(report_path or root / "metadata_report.json")
    out.write_text(json.dumps(report, indent=1))
    return report
