"""Boundaries of the PyTorch port.

The port imports neither JAX nor anything of the JAX package (checked
in a fresh interpreter, since this test process has JAX loaded), its
entry points run on the GPU unless the caller passes ``device="cpu"``,
no engine option is refused, and the kernel wrappers never catch around
a launch.
"""

import ast
import inspect
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from sbeacon_tpu_torch import ops as t_ops
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.ops import gather_kernel as tg
from sbeacon_tpu_torch.ops import plane_kernel as tpk
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.ops import scatter_kernel as tsk
from sbeacon_tpu_torch.ops import timing
from sbeacon_tpu_torch.parallel import distinct as td
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.parallel.dispatch import MeshDispatchTier
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.testing import synthetic_shard

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_and_no_reference_package():
    code = textwrap.dedent(
        """
        import importlib, json, pkgutil, sys
        import sbeacon_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            sbeacon_tpu_torch.__path__, "sbeacon_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(
            k for k in sys.modules
            if k == "jax" or k.startswith("jax.") or k == "jaxlib"
            or k.startswith("jaxlib.")
            or k == "sbeacon_tpu" or k.startswith("sbeacon_tpu.")
            or k == "jsonschema" or k.startswith("jsonschema.")
        )
        print(json.dumps([names, leaked]))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    names, leaked = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) >= 27  # every module of the slices was imported
    assert {"sbeacon_tpu_torch.harness.faults",
            "sbeacon_tpu_torch.resilience",
            "sbeacon_tpu_torch.plan",
            "sbeacon_tpu_torch.response_cache",
            "sbeacon_tpu_torch.utils.trace",
            "sbeacon_tpu_torch.telemetry",
            "sbeacon_tpu_torch.serving",
            "sbeacon_tpu_torch.ops.plane_kernel",
            "sbeacon_tpu_torch.ops.gather_kernel",
            "sbeacon_tpu_torch.parallel.dispatch",
            "sbeacon_tpu_torch.ops.scatter_kernel",
            "sbeacon_tpu_torch.ops.timing",
            "sbeacon_tpu_torch.parallel.distinct",
            "sbeacon_tpu_torch.parallel.mesh",
            "sbeacon_tpu_torch.ingest.pipeline",
            "sbeacon_tpu_torch.ingest.service",
            "sbeacon_tpu_torch.index.columnar",
            "sbeacon_tpu_torch.metadata.entities",
            "sbeacon_tpu_torch.metadata.filters",
            "sbeacon_tpu_torch.metadata.ontology",
            "sbeacon_tpu_torch.metadata.store",
            "sbeacon_tpu_torch.query_jobs",
            "sbeacon_tpu_torch.api.app",
            "sbeacon_tpu_torch.api.framework",
            "sbeacon_tpu_torch.api.model_schemas",
            "sbeacon_tpu_torch.api.server",
            "sbeacon_tpu_torch.api.variants",
            "sbeacon_tpu_torch.config",
            "sbeacon_tpu_torch.slo",
            "sbeacon_tpu_torch.shaping",
            "sbeacon_tpu_torch.accounting",
            "sbeacon_tpu_torch.canary",
            "sbeacon_tpu_torch.engine",
            "sbeacon_tpu_torch.api.submit",
            "sbeacon_tpu_torch.io.sources",
            "sbeacon_tpu_torch.io.sigv4",
            "sbeacon_tpu_torch.genomics.bgzf",
            "sbeacon_tpu_torch.genomics.tabix",
            "sbeacon_tpu_torch.genomics.vcf",
            "sbeacon_tpu_torch.native",
            "sbeacon_tpu_torch.index.portable",
            "sbeacon_tpu_torch.ingest.planner",
            "sbeacon_tpu_torch.ingest.ledger",
            "sbeacon_tpu_torch.metadata.resolvers",
            "sbeacon_tpu_torch.metadata.udfs",
            "sbeacon_tpu_torch.parallel.migration",
            "sbeacon_tpu_torch.parallel.transport",
            "sbeacon_tpu_torch.oracle",
            "sbeacon_tpu_torch.oracle.cpu_oracle",
            "sbeacon_tpu_torch.harness.bench_cache",
            "sbeacon_tpu_torch.harness.genome1k",
            "sbeacon_tpu_torch.harness.latency",
            "sbeacon_tpu_torch.harness.scale",
            "sbeacon_tpu_torch.harness.simulate"} <= set(names)
    assert leaked == []


def test_port_sources_name_no_reference_import():
    """No module of the port imports ``sbeacon_tpu``, ``jax`` or
    ``jsonschema`` (absent on the GPU host), even lazily inside a
    function, and none reads a path of the JAX package (the native
    sources are copies under ``sbeacon_tpu_torch/native/src/``)."""
    for path in (REPO / "sbeacon_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "sbeacon_tpu", "jsonschema"} & set(
                roots
            ), (path, node.lineno)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert node.value != "sbeacon_tpu" and (
                    "sbeacon_tpu/" not in node.value
                    or "``sbeacon_tpu/" in node.value
                ), (path, node.lineno)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(no_gpu):
    shard = synthetic_shard(500, seed=1, chroms=["1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VariantEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ops.make_device_index(shard)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VariantEngine(device="cuda")
    eng = VariantEngine(device="cpu")
    try:
        eng.add_index(shard)
        assert eng.datasets() == ["synth"]
    finally:
        eng.close()
    assert t_ops.make_device_index(shard, "cpu").tiles.device.type == "cpu"


def test_beacon_app_and_server_need_a_gpu_unless_cpu_is_asked(no_gpu,
                                                              tmp_path):
    from sbeacon_tpu_torch.api import BeaconApp
    from sbeacon_tpu_torch.api.server import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        BeaconApp()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--data-root", str(tmp_path / "root")])
    app = BeaconApp(device="cpu")
    try:
        assert app.engine.device.type == "cpu"
        status, body = app.handle("GET", "/info")
        assert status == 200 and body["response"]["id"] == "org.tpu.beacon"
        assert app.handle("GET", "/ready")[1]["shards"] == 0
    finally:
        app.close()
        app.engine.close()


def test_fleet_and_harness_entries_need_a_gpu_unless_cpu_is_asked(
        no_gpu, tmp_path):
    """The worker entry and the metadata scale harness serve on the card
    unless asked for the CPU; the migration controller and the scan pool
    hold no device of their own."""
    from sbeacon_tpu_torch.harness.scale import run_metadata_scale
    from sbeacon_tpu_torch.parallel.dispatch import main as worker_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker_main(["--data-root", str(tmp_path / "w")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_metadata_scale(tmp_path / "s", n_datasets=1, individuals_per=2)
    rep = run_metadata_scale(tmp_path / "c", n_datasets=1,
                             individuals_per=2, device="cpu")
    assert rep["populate"]["individuals"] == 2


@pytest.mark.parametrize("option", ["use_mesh", "response_cache"])
def test_unported_options_are_refused(option):
    """No engine option is refused any more: ``use_mesh`` and the
    response cache build an engine (both on by default, as in the JAX
    package), and the refusal list is gone."""
    import sbeacon_tpu_torch.engine as t_engine

    assert not hasattr(t_engine, "_UNPORTED")
    assert getattr(EngineConfig(), option) is True
    eng = VariantEngine(
        BeaconConfig(engine=EngineConfig(**{option: True})), device="cpu"
    )
    try:
        if option == "response_cache":
            assert eng.cache_stats()["entries"] == 0
    finally:
        eng.close()


def test_device_planes_option_builds_and_serves():
    """``device_planes`` is ported: the engine uploads a shard's planes
    (to the CPU here) and serves a selected-samples request from them."""
    shard = synthetic_shard(
        800, seed=2, chroms=["1"], n_samples=40, with_gt_planes=True,
        plane_density=0.3,
    )
    eng = VariantEngine(
        BeaconConfig(engine=EngineConfig(device_planes=True)), device="cpu"
    )
    try:
        eng.add_index(shard)
        (_ds, _vcf, (_s, _i, planes)), = eng.indexes_for([])
        assert planes is not None and planes.gt.device.type == "cpu"
        p = int(shard.cols["pos"][100])
        (resp,) = eng.search(VariantQueryPayload(
            dataset_ids=["synth"], reference_name="1", start_min=p - 1000,
            start_max=p + 1000, end_min=0, end_max=1 << 30,
            alternate_bases="N", requested_granularity="record",
            include_datasets="HIT", include_samples=True,
            sample_names={"synth": ["S1", "S5", "S30"]},
            selected_samples_only=True,
        ))
        assert resp.exists and set(resp.sample_names) <= {"S1", "S5", "S30"}
    finally:
        eng.close()


@pytest.mark.parametrize(
    "fn",
    [tsk.scatter_match, tsk._launch_tier, tsk.run_queries_scattered,
     tk.bisect_query, tk.run_queries, t_ops.run_queries_auto,
     tsk.scatter_selected, tsk.run_selected_scattered, tpk.plane_stats,
     tpk.plane_row_stats, VariantEngine._fused_selected, td.distinct_count,
     td.distinct_count_device, tsk._probe_one_tier, tsk.device_time_probe,
     tpk.device_plane_probe, timing.device_ms, timing.cold_device_ms,
     tm.stacked_query, tm.stacked_selected, tm.sharded_query,
     tm.sharded_selected_query, VariantEngine._mesh_search,
     tm.mesh_fused, tm.MeshFusedIndex.run_mesh_queries,
     tm.MeshPendingResults.fetch, tg.ring_step, tg.ring_gather,
     tg.gather_partials, tg.gather_partials_many, MeshDispatchTier.search,
     VariantEngine.l0_pre_rows, VariantEngine._l0_pre_rows,
     VariantEngine._l0_warm, VariantEngine.warmup, VariantEngine._warmup,
     tk.L0DeviceIndex.__init__, tk.CompositeL0DeviceIndex.__init__],
)
def test_kernel_path_never_catches(fn):
    """The kernel path has no try/except: a CUDA tensor launches the
    kernel or raises, it never falls back to the twin or the host."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_run_queries_auto_refuses_foreign_index():
    with pytest.raises(TypeError):
        t_ops.run_queries_auto(object(), [])
