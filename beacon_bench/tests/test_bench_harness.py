"""The harness: found by name from data, the result line, the import
guard, the refusal without a card, the clients' imports, and a run on
the card (marked ``cuda``; skipped here)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from beacon_bench import run as R
from beacon_bench.tests.tiny import tiny_cell, tiny_run

ROOT = Path(R.__file__).resolve().parent.parent
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_new_mix_and_metric_from_data_alone(tmp_path):
    """A later change adds a cell, a traffic mix and a per-layer metric
    by adding files and entries: the harness finds them by name."""
    bench = tmp_path / "beacon_bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "beacon_bench" / sub, bench / sub)
    mix = json.loads((bench / "traffic" / "variants.json").read_text())
    mix["kinds"] = [dict(mix["kinds"][0], share=1.0)]
    (bench / "traffic" / "points_only.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy_specs_per_req.py").write_text(
        "from beacon_bench.lib.readers import delta\n\n"
        "def read(w):\n"
        "    return delta(w, 'batcher', 'specs') / max(w.completed, 1)\n")
    spec = R.load_spec()
    spec["workloads"].append({"name": "g1k_gt.points_only",
                              "config": "g1k_gt", "traffic": "points_only",
                              "chips": 1, "why": "a dummy cell"})
    spec["per_layer"].append({
        "name": "dummy_specs_per_req", "unit": "queries", "better": "lower",
        "source": "program_counter", "layer": "batcher",
        "moves": "setup_s", "workloads": ["g1k_gt.points_only"]})
    c = tiny_cell("g1k_gt.points_only", spec=spec, root=ROOT,
                  bench_dir=bench)
    assert [m["name"] for m in c["per_layer"]][-1] == "dummy_specs_per_req"
    assert "scatter_match_roofline" not in {m["name"]
                                            for m in c["per_layer"]}
    res = tiny_run(c, trace=True)
    assert res["correct"] is True
    assert res["metrics"]["dummy_specs_per_req"]["value"] > 0
    # the metrics that list only g1k_gt.variants stay out of this cell
    assert set(res["metrics"]) == {"dummy_specs_per_req"}
    assert "breakdown" in res


def test_result_line_keys(capsys):
    res = tiny_run(tiny_cell("g1k_gt.variants"))
    assert R.emit(res) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert line["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert err.strip().splitlines()[-1].startswith("check ")
    setup = json.loads(next(ln for ln in err.splitlines()
                            if ln.startswith("beacon_bench: set-up "))
                       .split(" ", 2)[2])
    # the window opened once the warm-up had filled the response cache
    assert setup["warm_lookups"] >= setup["warm_target"] == 40
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_import_guard(monkeypatch, capsys):
    assert R.forbidden_modules() == []
    assert "sbeacon_tpu_torch" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "sbeacon_tpu", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert R.forbidden_modules() == ["jax", "sbeacon_tpu"]
    res = {"correct": True, "checks": {}, "_first_bad": [], "_errors": []}
    assert R.emit(res) == 4
    out, err = capsys.readouterr()
    assert out == "" and "sbeacon_tpu" in err


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "beacon_bench/run.py", "--workload",
         "g1k_gt.variants", "--seed", str(2**33), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert p.returncode == 3 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_refuses_in_a_tree_without_the_program(tmp_path):
    shutil.copytree(ROOT / "beacon_bench", tmp_path / "beacon_bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "beacon_bench/run.py", "--workload",
         "g1k_gt.variants", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_client_processes_import_only_the_standard_library():
    code = ("import runpy, sys; runpy.run_path(sys.argv[1]); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run(
        [sys.executable, "-I", "-c", code,
         str(ROOT / "beacon_bench" / "lib" / "client.py")],
        capture_output=True, text=True, timeout=60)
    mods = set(json.loads(p.stdout.replace("'", '"')))
    assert not mods & {"torch", "numpy", "sbeacon_tpu_torch", "beacon_bench",
                       "jax"}


@pytest.mark.cuda
def test_a_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures only there")
    p = subprocess.run(
        [sys.executable, "beacon_bench/run.py", "--workload",
         "g1k_gt.variants", "--seed", str(2**33 + 1), "--seconds", "5",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
