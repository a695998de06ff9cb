"""``tools/check_launch_recording.py`` and ``tools/check_native_seam.py``
on the port's sources.

The launch-recording lint's functions (``lint_module``,
``lint_jit_bypass``, ``lint_seam``, ``lint_l0_family``) run over every
module of ``sbeacon_tpu_torch/``: no module assigns a launch counter,
and every module that loads a kernel library (``_build.load``) keeps its
module ``__getattr__`` counters and reports its launches through
``record_device_launch``. The launch/fetch split adds a rule the tool
states for the JAX package's one handle: every pending handle of the
port (a class with a ``fetch`` that carries its launch record's
``flight_seq``) reports its
readback through ``note_device_stage``, so moving the readback out of
the launch cannot move it out of the flight recorder. The native-seam
lint's ``scan`` / ``lint`` run on the port's tree: ``ingest/pipeline.py``
``native_slice_text`` is the one native decode entry. Each lint's
violation cases repeat on a temporary port tree.
"""

import ast
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sbeacon_tpu_torch"

#: the port's kernel seams: each loads a kernel library and launches it
SEAMS = {
    "ops/kernel.py", "ops/scatter_kernel.py", "ops/plane_kernel.py",
    "ops/gather_kernel.py", "parallel/mesh.py", "parallel/distinct.py",
}
#: the port's pending handles (their fetch reads a launch back)
HANDLES = {"PendingQueryResults", "MeshPendingResults"}


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import check_launch_recording
        import check_native_seam
    finally:
        sys.path.pop(0)
    return check_launch_recording, check_native_seam


def _modules(root=PORT):
    return {p.relative_to(root).as_posix(): p.read_text()
            for p in sorted(root.rglob("*.py"))}


def _calls(tree) -> set:
    return {n.func.id if isinstance(n.func, ast.Name) else n.func.attr
            for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, (ast.Name, ast.Attribute))}


def launching_modules(mods: dict) -> set:
    """Modules that load a kernel library (``_build.load``)."""
    out = set()
    for rel, src in mods.items():
        for n in ast.walk(ast.parse(src)):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "load"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == "_build"):
                out.add(rel)
    return out


def pending_handles(mods: dict) -> dict:
    """{class name: (module, its fetch reports through note_device_stage)}
    for every class with a ``fetch`` method that carries a launch
    record's ``flight_seq`` (a handle that reads a launch back)."""
    out = {}
    for rel, src in mods.items():
        for cls in ast.walk(ast.parse(src)):
            if not isinstance(cls, ast.ClassDef):
                continue
            fetch = next((f for f in cls.body if isinstance(f, ast.FunctionDef)
                          and f.name == "fetch"), None)
            seq = any(isinstance(n, ast.Attribute) and n.attr == "flight_seq"
                      for n in ast.walk(cls))
            if fetch is not None and seq:
                out[cls.name] = (rel, "note_device_stage" in _calls(fetch))
    return out


def test_port_modules_pass_the_launch_recording_lint(tools):
    clr = tools[0]
    mods = _modules()
    errors = []
    for rel, src in mods.items():
        errors += clr.lint_module(rel, src)
        errors += clr.lint_jit_bypass(rel, src)
    assert errors == []
    assert launching_modules(mods) == SEAMS
    for rel in sorted(SEAMS):
        assert clr.lint_seam(rel, mods[rel]) == [], rel
    assert clr.lint_l0_family(mods["ops/kernel.py"],
                              mods["telemetry.py"]) == []


def test_port_pending_handles_report_their_readback():
    handles = pending_handles(_modules())
    assert set(handles) == HANDLES
    assert all(reports for _rel, reports in handles.values()), handles


def test_launch_recording_lint_catches_violations(tools, tmp_path):
    clr = tools[0]
    pkg = tmp_path / "sbeacon_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "ops" / "rogue.py").write_text(
        "from . import _build\n"
        "N_LAUNCHES = 0\n"
        "class LatePending:\n"
        "    def __init__(self, out, seq):\n"
        "        self._out, self.flight_seq = out, seq\n"
        "    def fetch(self):\n"
        "        host = self._out.cpu()\n"
        "        return host\n"
        "def launch(x):\n"
        "    global N_LAUNCHES\n"
        "    N_LAUNCHES += 1\n"
        "    return _build.load('rogue').rogue_launch(x)\n"
    )
    mods = _modules(pkg)
    src = mods["ops/rogue.py"]
    assert len(clr.lint_module("ops/rogue.py", src)) == 3
    assert launching_modules(mods) == {"ops/rogue.py"}
    seam = clr.lint_seam("ops/rogue.py", src)
    assert len(seam) == 2 and "__getattr__" in seam[0]
    assert "record_device_launch" in seam[1]
    assert pending_handles(mods) == {"LatePending": ("ops/rogue.py", False)}
    assert clr.lint_l0_family("class L0DeviceIndex:\n    pass\n",
                              "DEVICE_FAMILIES = ('fused',)\n") != []


def test_port_native_decode_has_one_seam(tools):
    cns = tools[1]
    scanned = cns.scan(PORT)
    assert cns.lint(scanned) == []
    assert scanned["seam_defined"]
    assert scanned["seam_entries"] == {"inflate_range", "inflate_buffer"}
    # the callers of the seam are the pipeline's own slice readers
    assert {loc.split(":")[0] for loc, _g in scanned["seam_calls"]} == {
        cns.SEAM_MODULE}
    jax_scanned = cns.scan()
    assert len(scanned["seam_calls"]) == len(jax_scanned["seam_calls"])


def test_native_seam_lint_catches_violations(tools, tmp_path):
    cns = tools[1]
    pkg = tmp_path / "sbeacon_tpu_torch"
    seam_src = (PORT / "ingest" / "pipeline.py").read_text()
    (pkg / "ingest").mkdir(parents=True)
    (pkg / "ingest" / "pipeline.py").write_text(seam_src)
    (pkg / "rogue.py").write_text(
        "from . import native\n"
        "from .ingest.pipeline import native_slice_text\n"
        "def read(blob, path):\n"
        "    native_slice_text(path, 0, 1)\n"
        "    return native.inflate_buffer(blob, 0, 1)\n"
    )
    errors = cns.lint(cns.scan(pkg))
    assert len(errors) == 2
    assert any("direct inflate_buffer() call" in e for e in errors)
    assert any("without a try/except" in e for e in errors)
