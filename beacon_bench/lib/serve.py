"""The system under test: the program's Beacon HTTP server
(``sbeacon_tpu_torch.api.server.start_background``) over a
``BeaconApp`` whose engine holds the configuration's datasets in
memory, on a localhost port of this process.

The app runs the program's ``BeaconConfig`` defaults with the
departures the configuration file lists under ``server``: shaping off,
the canary off, the runner's pending cap raised. Its job table and
spilled result sets go to a fresh directory under ``TMPDIR``, removed
on close; the metadata (dataset documents and, where the configuration
has them, one individual, biosample, run and analysis a sample) is an
in-memory store.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

from .datagen import Dataset
from .traffic import HP_PARENT, HP_TERMS


def dataset_doc(ds: Dataset) -> dict:
    vcf = f"synthetic://{ds.dataset_id}"
    return {"id": ds.dataset_id, "name": ds.dataset_id,
            "description": "benchmark dataset", "_assemblyId": "GRCh38",
            "_vcfLocations": [vcf], "_vcfGroups": [[vcf]],
            "_vcfGroupsExplicit": False, "_vcfChromosomeMap": []}


def metadata_store(datasets: list[Dataset], people: dict | None):
    from sbeacon_tpu_torch.metadata import MetadataStore, OntologyStore

    onto = OntologyStore()
    onto.register_edges([(t, HP_PARENT) for t in HP_TERMS])
    store = MetadataStore(ontology=onto)
    store.upsert("datasets", [dataset_doc(d) for d in datasets])
    if people:
        ds_id = datasets[0].dataset_id
        own = {"_datasetId": ds_id}
        docs = {"individuals": [], "biosamples": [], "runs": [],
                "analyses": []}
        for ind, (name, sex, disease) in people.items():
            k = ind[1:]
            docs["individuals"].append(
                {"id": ind, "sex": {"id": sex, "label": sex},
                 "diseases": [{"diseaseCode": {"id": disease,
                                               "label": disease}}], **own})
            docs["biosamples"].append(
                {"id": f"BS{k}", "individualId": ind, **own})
            docs["runs"].append({"id": f"R{k}", "biosampleId": f"BS{k}",
                                 "individualId": ind, **own})
            docs["analyses"].append(
                {"id": f"A{k}", "runId": f"R{k}", "biosampleId": f"BS{k}",
                 "individualId": ind, "vcfSampleId": name, **own})
        for kind, kind_docs in docs.items():
            store.upsert(kind, kind_docs)
        store.rebuild_indexes()
    return store, onto


class Server:
    """Engine, app and HTTP server; ``close`` stops and frees them."""

    def __init__(self, shards, datasets, people, server_cfg: dict, device):
        from sbeacon_tpu_torch.api import BeaconApp
        from sbeacon_tpu_torch.api.server import start_background
        from sbeacon_tpu_torch.config import (
            BeaconConfig,
            ObservabilityConfig,
            ResilienceConfig,
            ShapingConfig,
            StorageConfig,
        )
        from sbeacon_tpu_torch.engine import VariantEngine

        self.root = tempfile.mkdtemp(prefix="beacon-bench-")
        config = BeaconConfig(
            storage=StorageConfig(root=Path(self.root)),
            resilience=ResilienceConfig(
                runner_max_pending=server_cfg["runner_max_pending"]),
            shaping=ShapingConfig(enabled=server_cfg["shaping"]),
            observability=ObservabilityConfig(
                canary_enabled=server_cfg["canary"]),
        )
        self.times = {}
        t0 = time.perf_counter()
        self.engine = VariantEngine(config, device=device)
        for shard in shards:
            self.engine.add_index(shard)
        self.times["index_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.engine.warmup()
        self.times["warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.store, self.onto = metadata_store(datasets, people)
        self.times["metadata_s"] = time.perf_counter() - t0
        self.app = BeaconApp(config, store=self.store, ontology=self.onto,
                             engine=self.engine)
        self.window_cap = config.engine.window_cap
        self.http, self._thread = start_background(self.app, "127.0.0.1", 0)
        self.port = self.http.server_address[1]

    def close(self):
        self.http.shutdown()
        self.http.server_close()
        self._thread.join(timeout=30)
        self.app.close()
        self.engine.close()
        self.store.close()
        self.onto.close()
        shutil.rmtree(self.root, ignore_errors=True)
