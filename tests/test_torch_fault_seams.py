"""``tools/check_fault_seams.py`` on the port's sources.

The tool's AST walk (``code_sites`` with its ``PKG`` pointed at
``sbeacon_tpu_torch/``, the tool itself unedited) finds every
``fault_point`` call of the port. Every port site is a row of
``DEPLOYMENT.md``'s fault-plan table, every site name is a literal, and
the port's set of sites equals the JAX package's: ROADMAP Queue 3 lists
no fault site as a deliberate difference. The lint's violation cases
repeat on a temporary port tree.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sbeacon_tpu_torch"

#: the sites a chaos plan can name in both packages
SITES = {
    "worker.http", "kernel.launch", "sqlite.commit", "admission.queue",
    "mesh.dispatch", "compaction.fold", "migration:copy",
    "migration:dual_serve", "migration:verify", "migration:cutover",
}


@pytest.fixture()
def cfs():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import check_fault_seams
    finally:
        sys.path.pop(0)
    return check_fault_seams


def _port_sites(cfs, monkeypatch, pkg=PORT):
    monkeypatch.setattr(cfs, "PKG", pkg)
    return cfs.code_sites()


def test_port_sites_are_documented_and_equal_jax(cfs, monkeypatch):
    jax_sites, jax_errors = cfs.code_sites()
    sites, errors = _port_sites(cfs, monkeypatch)
    assert errors == [] and jax_errors == []
    documented, doc_errors = cfs.documented_sites()
    assert doc_errors == []
    assert set(sites) <= documented, set(sites) - documented
    assert set(sites) == set(jax_sites) == SITES
    # every migration seam is hit by the controller's phase entries
    for site in SITES:
        if site.startswith("migration:"):
            (where,) = sites[site]
            assert where.startswith("sbeacon_tpu_torch/parallel/migration.py")


def test_port_lint_catches_violations(cfs, monkeypatch, tmp_path):
    pkg = tmp_path / "sbeacon_tpu_torch"
    (pkg / "harness").mkdir(parents=True)
    (pkg / "mod.py").write_text(
        "from .harness.faults import fault_point\n"
        "def f(name):\n"
        "    fault_point('migration:copy', 'd')\n"
        "    fault_point('rogue.site')\n"
        "    fault_point(name)\n"
    )
    monkeypatch.setattr(cfs, "REPO", tmp_path)
    sites, errors = _port_sites(cfs, monkeypatch, pkg)
    assert set(sites) == {"migration:copy", "rogue.site"}
    assert len(errors) == 1 and "string literal" in errors[0]
    monkeypatch.setattr(cfs, "REPO", REPO)
    documented, _ = cfs.documented_sites()
    assert set(sites) - documented == {"rogue.site"}
