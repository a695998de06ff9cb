"""Shared fixtures of the port's HTTP-surface parity tests.

A data root is written by the JAX package's own ``/submit`` (the port
serves no ingest yet), then served by both packages: the JAX app on the
root itself, the port's app on a COPY of its index, metadata and
ontology only. The job table (``query-jobs.sqlite``) is never copied:
the runner keys its results on the query hash and the index
fingerprint, which are the same strings in both packages, so a port app
on the JAX root could answer from the JAX package's cached results.

Bodies are compared as ``json.dumps`` strings, key order kept, after
masking exactly the fields that differ by nature: ``meta.traceId``,
``meta.elapsedTimeMs``, and the creation and update times of ``/`` and
``/info``.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import torch

from sbeacon_tpu.api import BeaconApp as JBeaconApp
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import StorageConfig as JStorageConfig
from sbeacon_tpu_torch.api import BeaconApp
from sbeacon_tpu_torch.config import BeaconConfig, StorageConfig
from sbeacon_tpu_torch.engine import VariantEngine

CPU = torch.device("cpu")
SAMPLES = [f"S{i}" for i in range(6)]
SEX_TERMS = ["NCIT:C16576", "NCIT:C20197"]  # female, male
#: what a port app may copy from a data root the JAX package wrote
COPIED = ("variant-index", "metadata.sqlite", "ontology.sqlite")


def submission(dataset_id, cohort_id, vcf, sex_of, samples=SAMPLES):
    """The /submit body of tests/test_api.py: one individual, biosample,
    run and analysis per sample, the analysis naming its VCF sample."""
    individuals = [
        {
            "id": f"I{i}",
            "sex": {"id": sex_of(i), "label": "-"},
            "diseases": [{"diseaseCode": {"id": f"HP:000{i % 2}"}}],
        }
        for i in range(len(samples))
    ]
    biosamples = [
        {
            "id": f"B{i}",
            "individualId": f"I{i}",
            "biosampleStatus": {"id": "EFO:0009654", "label": "reference"},
        }
        for i in range(len(samples))
    ]
    runs = [
        {"id": f"R{i}", "biosampleId": f"B{i}", "individualId": f"I{i}"}
        for i in range(len(samples))
    ]
    analyses = [
        {
            "id": f"A{i}",
            "runId": f"R{i}",
            "biosampleId": f"B{i}",
            "individualId": f"I{i}",
            "vcfSampleId": samples[i],
        }
        for i in range(len(samples))
    ]
    return {
        "datasetId": dataset_id,
        "assemblyId": "GRCh38",
        "vcfLocations": [str(vcf)],
        "dataset": {"name": dataset_id, "description": "test"},
        "cohortId": cohort_id,
        "cohort": {"name": f"cohort-{dataset_id}"},
        "individuals": individuals,
        "biosamples": biosamples,
        "runs": runs,
        "analyses": analyses,
        "index": True,
    }


def close_jax(app) -> None:
    """Stop everything a JAX app runs: its runner, canary, compactor,
    engine batcher, and its sqlite handles."""
    app.close()
    app.engine.close()
    app.store.close()
    app.ontology.close()


def jax_ingest(root: Path, submissions, *, edges=()) -> None:
    """Write a data root through the JAX app's /submit (ontology
    ``edges`` registered first), then close the app."""
    config = JBeaconConfig(storage=JStorageConfig(root=root))
    config.storage.ensure()
    app = JBeaconApp(config)
    try:
        if edges:
            app.ontology.register_edges(list(edges))
        for sub in submissions:
            status, body = app.handle("POST", "/submit", body=sub)
            assert status == 200, body
    finally:
        close_jax(app)


def copy_root(src: Path, dst: Path) -> Path:
    """``dst`` holding the index, metadata and ontology of ``src``."""
    dst.mkdir(parents=True)
    for name in COPIED:
        p = src / name
        if p.is_dir():
            shutil.copytree(p, dst / name)
        elif p.exists():
            shutil.copy2(p, dst / name)
    assert not (dst / "query-jobs.sqlite").exists()
    return dst


def open_jax(root: Path, **config_kw):
    """The JAX app over ``root``, every persisted shard loaded."""
    app = JBeaconApp(
        JBeaconConfig(storage=JStorageConfig(root=root), **config_kw)
    )
    app.ingest.load_all()
    return app


def open_port(root: Path, **config_kw):
    """The port's app over ``root`` on a CPU engine, every persisted
    shard loaded."""
    config = BeaconConfig(storage=StorageConfig(root=root), **config_kw)
    app = BeaconApp(config, engine=VariantEngine(config, device=CPU))
    app.ingest.load_all()
    return app


def close_port(app) -> None:
    app.close()
    app.engine.close()
    app.store.close()
    app.ontology.close()


def masked(body, path: str):
    """``body`` with the fields that differ by nature replaced."""
    body = copy.deepcopy(body)
    if isinstance(body, dict):
        meta = body.get("meta")
        if isinstance(meta, dict):
            for key in ("traceId", "elapsedTimeMs"):
                if key in meta:
                    meta[key] = "<masked>"
        resp = body.get("response")
        if path.strip("/") in ("", "info") and isinstance(resp, dict):
            for key in ("createDateTime", "updateDateTime"):
                if key in resp:
                    resp[key] = "<masked>"
    return body


def dumped(body, path: str) -> str:
    return json.dumps(masked(body, path))


def both(japp, papp, method, path, query_params=None, body=None,
         headers=None):
    """The same request through both apps' ``handle``; asserts equal
    status and equal masked bytes, returns the port's (status, body)."""
    js, jb = japp.handle(method, path, copy.deepcopy(query_params),
                         copy.deepcopy(body), headers=dict(headers or {}))
    ps, pb = papp.handle(method, path, copy.deepcopy(query_params),
                         copy.deepcopy(body), headers=dict(headers or {}))
    assert ps == js, (method, path, ps, js, pb, jb)
    assert dumped(pb, path) == dumped(jb, path), (method, path)
    return ps, pb
