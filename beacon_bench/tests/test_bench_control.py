"""The correctness check fails what it must: the control (the reference
with a guarantee of the configuration broken, in the program's place)
at a size a test run holds, and a whole run with the timed path broken
underneath (an answer altered where it is produced; half of each batch
left out)."""

import dataclasses

import numpy as np
import pytest
import torch

from beacon_bench.control import control_readings
from beacon_bench.tests.tiny import CELLS, SEED, tiny_cell, tiny_run


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_wrong(workload):
    c = tiny_cell(workload)
    if workload == "sbeacon_sim32.all_datasets":
        c["config"]["datasets"] = 8
    else:
        # wide windows need rows enough to exceed the device cap
        c["config"]["rows_per_dataset"] = 200_000
    out = control_readings(c, SEED, 300, torch.device("cpu"))
    assert out["control_wrong_answers"] > out["limit"] == 0


def alter_answers(server):
    """Each dataset's answer loses its last listed variant."""
    import sbeacon_tpu_torch.engine as eng

    real = eng.materialize_response

    def altered(*a, **kw):
        resp = real(*a, **kw)
        if resp.variants:
            resp = dataclasses.replace(resp, variants=resp.variants[:-1])
        return resp

    server.restore = [(eng, "materialize_response", real)]
    eng.materialize_response = altered


def drop_half_batch(server):
    """The batcher's launches answer only the first half of each batch
    (rounded down): the rest read as no match."""
    import sbeacon_tpu_torch.serving as serving

    real = serving.run_queries_auto

    class Half:
        def __init__(self, pending):
            self.pending = pending

        def fetch(self):
            res = self.pending.fetch()
            b = len(res.exists)
            keep = np.arange(b) < b // 2
            return dataclasses.replace(
                res, exists=res.exists & keep,
                call_count=np.where(keep, res.call_count, 0),
                n_variants=np.where(keep, res.n_variants, 0),
                all_alleles_count=np.where(keep, res.all_alleles_count, 0),
                n_matched=np.where(keep, res.n_matched, 0),
                rows=np.where(keep[:, None], res.rows, -1))

    def half(*a, **kw):
        out = real(*a, **kw)
        return Half(out) if kw.get("async_fetch") else Half(
            _Ready(out)).fetch()

    class _Ready:
        def __init__(self, res):
            self.res = res

        def fetch(self):
            return self.res

    server.restore = [(serving, "run_queries_auto", real)]
    serving.run_queries_auto = half


@pytest.mark.parametrize("fault", [alter_answers, drop_half_batch])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_reads_incorrect(workload, fault):
    holder = {}

    def install(server):
        fault(server)
        holder["restore"] = server.restore

    try:
        res = tiny_run(tiny_cell(workload), faults=install)
    finally:
        for mod, name, fn in holder.get("restore", []):
            setattr(mod, name, fn)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0
