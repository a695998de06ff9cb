"""``tools/check_transport_usage.py`` on the port's sources.

The tool's ``scan(root)`` over ``sbeacon_tpu_torch/``: no direct
``urlopen`` outside the transport module and the external-service
clients, no route-table subscript that bypasses the replica selector,
and ``sharded_selected_query`` only in the engine and the mesh module.
Its violation case repeats on a temporary port tree.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sbeacon_tpu_torch"


@pytest.fixture(scope="module")
def scan():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from check_transport_usage import scan
    finally:
        sys.path.pop(0)
    return scan


def test_port_sources_pass_the_transport_lint(scan):
    assert scan(PORT) == []
    # the owner exists: an empty scan is not a deleted transport
    assert (PORT / "parallel" / "transport.py").exists()


@pytest.mark.parametrize("rogue, what", [
    ("import urllib.request\n"
     "def bad(u):\n"
     "    return urllib.request.urlopen(u)\n", "urlopen"),
    ("def bad(engine, ds):\n"
     "    return engine.routes()[ds]\n", "route table"),
])
def test_transport_lint_catches_violations_in_a_port_tree(scan, tmp_path,
                                                          rogue, what):
    pkg = tmp_path / "sbeacon_tpu_torch"
    (pkg / "parallel").mkdir(parents=True)
    (pkg / "parallel" / "transport.py").write_text(
        "import urllib.request\n"
        "def ok(u):\n"
        "    return urllib.request.urlopen(u)\n"
    )
    (pkg / "rogue.py").write_text(rogue)
    hits = scan(pkg)
    assert len(hits) == 1 and "rogue.py" in hits[0], (what, hits)
