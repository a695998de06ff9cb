"""The port's twin of the probe-route lint (``tools/check_probe_routes.py``).

Three request-path lists of the port must agree on "what is a probe":
the SLO budget exclusion (``slo.EXCLUDED_ROUTES`` and
``_EXCLUDED_HEADS``), the API layer's auth/admission bypass set
(``api/app.py`` ``PROBE_PATHS``) and the latency histogram's named
diagnostic route labels. All derive from ``sbeacon_tpu_torch.slo
.PROBE_ROUTE_LABELS``: the static checks run the lint's own functions
on the port's ``slo.py`` and ``api/app.py``, and the behavioural checks
hold every probe label excluded from budgets and labelled back to
itself by the port app's router.
"""

from pathlib import Path

import pytest

from sbeacon_tpu_torch import slo as tslo
from sbeacon_tpu_torch.api import app as tapp
from sbeacon_tpu_torch.api.app import BeaconApp

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sbeacon_tpu_torch"


@pytest.fixture
def lint(monkeypatch):
    """``tools/check_probe_routes.py`` pointed at the port's sources."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    import check_probe_routes as cpr

    monkeypatch.setattr(cpr, "SLO_PY", PORT / "slo.py")
    monkeypatch.setattr(cpr, "APP_PY", PORT / "api" / "app.py")
    return cpr


def test_port_sources_derive_from_one_literal(lint):
    errors, labels, non_path = lint.lint_source()
    assert not errors, errors
    assert labels == set(tslo.PROBE_ROUTE_LABELS) and non_path <= labels
    assert not lint.lint_app(labels), lint.lint_app(labels)
    assert tapp.PROBE_PATHS is tslo.PROBE_BYPASS_PATHS


def test_lint_catches_a_hand_list(lint, tmp_path, monkeypatch):
    bad = tmp_path / "app.py"
    bad.write_text('PROBES = ("health", "ops/events")\n'
                   "def handle(self, route):\n"
                   "    return route in PROBES\n")
    monkeypatch.setattr(lint, "APP_PY", bad)
    errors = lint.lint_app(set(tslo.PROBE_ROUTE_LABELS))
    assert any("collection literal" in e for e in errors)
    assert any("slo.tracked" in e for e in errors)


def test_runtime_parity():
    shim = object.__new__(BeaconApp)
    for label in sorted(tslo.PROBE_ROUTE_LABELS):
        assert not tslo.SloEngine.tracked(label), label
    for route in ("info", "g_variants", "submit", "datasets.id"):
        assert tslo.SloEngine.tracked(route), route
    for label in sorted(tslo.PROBE_ROUTE_LABELS
                        - tslo.NON_PATH_PROBE_LABELS):
        path = "/" + label.replace(".", "/")
        assert BeaconApp._route_label(shim, path) == label
        assert path.strip("/") in tapp.PROBE_PATHS
    for junk in ("/ops/whatever", "/debug/whatever", "/fleet/whatever",
                 "/device/whatever"):
        assert BeaconApp._route_label(shim, junk) == "other"
    assert "_trace" not in tapp.PROBE_PATHS  # behind the admission gate
