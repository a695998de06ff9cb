"""The reference against the program's CPU path, a whole run of each
cell at a tiny size: every answer of the window equals the plain
reference's, and the reference itself answers with hits."""

import pytest

from beacon_bench.lib import datagen, traffic
from beacon_bench.reference.check import Judge
from beacon_bench.tests.tiny import CELLS, SEED, tiny_cell, tiny_run


@pytest.mark.parametrize("workload", CELLS)
def test_cell_agrees_with_reference(workload):
    res = tiny_run(tiny_cell(workload))
    assert res["attempted"] > 20
    assert res["checks"]["wrong_answers"]["value"] == 0, res["_first_bad"]
    assert res["failed"] == 0 and res["correct"] is True
    # device_memory_gb is the card's reading: a CPU run leaves it out
    assert set(res["metrics"]) == {"setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_traced_run_reads_the_host_layers():
    """A traced run reports every per-layer metric of the cell that a
    CPU run has something to read for: all but the card's."""
    res = tiny_run(tiny_cell("g1k_gt.variants"), trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {
        "requests_per_s.window", "p50_ms.window", "p95_ms.window",
        "server_cpu_ms_per_req", "gc_pause_pct", "runner_wait_ms",
        "queries_per_launch", "launches_per_req.scatter_match"}
    # four clients barely queue and barely collect, and the launch
    # counter counts the card's launches: those three may read 0 here
    maybe_0 = ("gc_pause_pct", "runner_wait_ms",
               "launches_per_req.scatter_match")
    assert all(m["value"] > 0 for k, m in res["metrics"].items()
               if k not in maybe_0)
    assert all(m["value"] >= 0 for m in res["metrics"].values())
    m = res["metrics"]
    assert m["p95_ms.window"]["value"] >= m["p50_ms.window"]["value"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_answers_have_hits(workload):
    """Most requests of each mix find something, and the counts the
    check compares are not all 0 or 1."""
    c = tiny_cell(workload)
    dss = datagen.make_deployment(c["config"], SEED, "cpu")
    gen = traffic.Generator(c["traffic"], dss, 2048)
    judge = Judge(dss, window_cap=2048)
    answers = [judge.expected(r["check"])
               for r in traffic.draw_requests(gen, SEED + 2, 200)]
    hits = [a for a in answers if a.get("exists") or a.get("count")]
    assert len(hits) > 100
    assert any(a.get("count", 0) > 1 for a in answers)
