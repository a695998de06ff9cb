"""The telemetry plane's three static lints on the port's sources.

``tools/check_metric_names.py``, ``tools/check_annotation_keys.py`` and
``tools/check_plan_stages.py`` each ``scan`` a package tree and ``lint``
what they found; here they scan ``sbeacon_tpu_torch/``, with the port's
own registries (``telemetry.ANNOTATION_KEYS``, ``plan.PLAN_STAGES`` and
``PLAN_REASONS``). Every registration and call site must pass as the
JAX package's do. The one rule restated here is the metric catalogue's
two-way parity: DEPLOYMENT.md documents the JAX package's series, so
every port series must be in it, and the catalogue names the port lacks
are exactly the deliberate difference (the tier's fallback counter,
which the port does not have: its tier raises). Each
lint's violation case repeats on a temporary port tree.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sbeacon_tpu_torch"
#: catalogue series of the JAX package only: the port's pod tier raises
#: instead of falling back
JAX_ONLY_SERIES = {"mesh.fallbacks"}


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import check_annotation_keys
        import check_metric_names
        import check_plan_stages
    finally:
        sys.path.pop(0)
    return check_metric_names, check_annotation_keys, check_plan_stages


def test_port_metric_names_pass_the_lint(tools):
    metric_names = tools[0]
    regs = metric_names.scan(PORT)
    assert regs and metric_names.lint(regs) == []
    registered = {r[0] for r in regs}
    catalogue = metric_names.catalogue_names()
    assert registered - catalogue == set()
    assert catalogue - registered == JAX_ONLY_SERIES


def test_port_annotation_keys_pass_the_lint(tools):
    annotation_keys = tools[1]
    used, errors = annotation_keys.scan(PORT)
    assert errors == []
    registry = annotation_keys.registry_keys(PORT / "telemetry.py")
    assert annotation_keys.lint(used, registry) == []


def test_port_plan_stages_pass_the_lint(tools):
    plan_stages = tools[2]
    stages, reasons, errors = plan_stages.scan(PORT)
    assert errors == []
    assert plan_stages.lint(
        stages, reasons, plan_stages.registry("PLAN_STAGES", PORT / "plan.py"),
        plan_stages.registry("PLAN_REASONS", PORT / "plan.py")) == []


@pytest.mark.parametrize("rogue, what", [
    ('def bad(registry, n):\n'
     '    return registry.counter(f"serve.{n}")\n', "f-string"),
    ('def bad(reg):\n'
     '    return reg.gauge("Bad-Name")\n', "grammar"),
    ('def bad(registry):\n'
     '    registry.counter("serve.requests")\n'
     '    registry.counter("serve.requests")\n', "duplicate"),
])
def test_metric_lint_catches_violations_in_a_port_tree(tools, tmp_path,
                                                       rogue, what):
    metric_names = tools[0]
    pkg = tmp_path / "sbeacon_tpu_torch"
    pkg.mkdir()
    (pkg / "rogue.py").write_text(rogue)
    errors = metric_names.lint(metric_names.scan(pkg))
    assert errors and all("rogue.py" in e for e in errors), (what, errors)


@pytest.mark.parametrize("rogue, what", [
    ("def bad(annotate):\n    annotate(unregistered_key=1)\n", "unregistered"),
    ("def bad(annotate, kw):\n    annotate(**kw)\n", "dynamic"),
    ("def bad(annotate):\n    annotate(1)\n", "positional"),
])
def test_annotation_lint_catches_violations_in_a_port_tree(tools, tmp_path,
                                                           rogue, what):
    annotation_keys = tools[1]
    pkg = tmp_path / "sbeacon_tpu_torch"
    pkg.mkdir()
    (pkg / "telemetry.py").write_text(
        'ANNOTATION_KEYS = frozenset({"lane"})\n'
        "def ok(annotate):\n    annotate(lane='x')\n")
    (pkg / "rogue.py").write_text(rogue)
    used, errors = annotation_keys.scan(pkg)
    errors += annotation_keys.lint(
        used, annotation_keys.registry_keys(pkg / "telemetry.py"))
    assert len(errors) == 1 and "rogue.py" in errors[0], (what, errors)


@pytest.mark.parametrize("rogue, what", [
    ("def bad(plan_stage):\n    plan_stage('nowhere')\n", "stage"),
    ("def bad(plan_stage, r):\n    plan_stage('mesh', reason=r)\n",
     "computed reason"),
    ("def bad(plan_stage):\n    plan_stage('mesh', reason='why')\n",
     "reason"),
])
def test_plan_lint_catches_violations_in_a_port_tree(tools, tmp_path,
                                                     rogue, what):
    plan_stages = tools[2]
    pkg = tmp_path / "sbeacon_tpu_torch"
    pkg.mkdir()
    (pkg / "plan.py").write_text(
        'PLAN_STAGES = frozenset({"mesh"})\n'
        'PLAN_REASONS = frozenset({"stale"})\n'
        "def ok(plan_stage):\n    plan_stage('mesh', reason='stale')\n")
    (pkg / "rogue.py").write_text(rogue)
    stages, reasons, errors = plan_stages.scan(pkg)
    errors += plan_stages.lint(
        stages, reasons, plan_stages.registry("PLAN_STAGES", pkg / "plan.py"),
        plan_stages.registry("PLAN_REASONS", pkg / "plan.py"))
    assert len(errors) == 1 and "rogue.py" in errors[0], (what, errors)
