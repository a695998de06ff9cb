"""Cells cut to a size a CPU test run holds: a few thousand rows, 70
samples, at most four datasets, four clients in two processes, a warm-up
of 40 cache lookups (half a second at least). The program serves on the
CPU (``device="cpu"``: the kernels' plain PyTorch twins).

Besides the cells of ``BENCHMARK.json``, the tests run
``sbeacon_sim32.all_datasets``, whose files (configuration, mix, readers)
are in the tree but whose entries are not (PERF.md, Open questions):
``with_later_cells`` adds them as a later change would, entries alone."""

from __future__ import annotations

import torch

from beacon_bench import run as R

CELLS = ("g1k_gt.variants", "sbeacon_sim32.all_datasets")
SEED = 2**33 + 7

LATER = {
    "configs": [{
        "name": "sbeacon_sim32", "file": "beacon_bench/configs/"
        "sbeacon_sim32.json", "reduced": ["datasets", "rows_per_dataset"]}],
    "workloads": [{
        "name": "sbeacon_sim32.all_datasets", "config": "sbeacon_sim32",
        "traffic": "all_datasets", "chips": 1}],
    "per_layer": [
        {"name": "launches_per_req.bisect_query", "unit": "launches",
         "better": "lower", "source": "program_counter", "layer": "dispatch",
         "moves": "setup_s",
         "workloads": ["sbeacon_sim32.all_datasets"]},
        {"name": "bisect_query_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels",
         "moves": "setup_s",
         "workloads": ["sbeacon_sim32.all_datasets"]}],
}


def with_later_cells(spec: dict) -> dict:
    return {k: v + [e for e in LATER.get(k, [])
                    if e["name"] not in {x["name"] for x in v}]
            if isinstance(v, list) and k in LATER else v
            for k, v in spec.items()}


def tiny_cell(workload: str, spec=None, **kw) -> dict:
    c = R.cell_of(with_later_cells(spec or R.load_spec()), workload, **kw)
    c["config"] = dict(c["config"], rows_per_dataset=20_000, samples=70,
                       datasets=min(c["config"]["datasets"], 4))
    c["traffic"] = dict(c["traffic"], clients=4)
    return c


def tiny_run(c: dict, *, seconds: float = 2.0, trace: bool = False,
             faults=None, seed: int = SEED, warm_lookups: int = 40) -> dict:
    return R.run_cell(c, seed, seconds, trace, torch.device("cpu"),
                      faults=faults, warm_lookups=warm_lookups,
                      warm_min_s=0.5, client_processes=2)
