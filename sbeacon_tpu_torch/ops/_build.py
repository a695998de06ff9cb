"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each source under ``sbeacon_tpu_torch/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library under ``build/kernels/`` of the
checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags so an edited source or header rebuilds.
The build happens at first use, never at import: the CPU tests import
every module. A missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry points per source: name -> (argtypes, restype)
SIGNATURES = {
    "scatter_match": {
        "scatter_match_launch": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
            ctypes.c_int,
        ),
        "scatter_match_smem": ([_I, _I], ctypes.c_longlong),
    },
    "bisect_query": {
        "bisect_query_launch": (
            [_P, _L, _P, _P, _I, _P, _P, _I, _I, _I, _P],
            ctypes.c_int,
        ),
        "bisect_query_smem": ([_I, _I], ctypes.c_longlong),
    },
    "scatter_selected": {
        "scatter_selected_launch": (
            [_P] * 13 + [_I] * 8 + [_L, _I, _P],
            ctypes.c_int,
        ),
        "scatter_selected_smem": ([_I, _I, _I, _I], ctypes.c_longlong),
    },
    "plane_stats": {
        "plane_stats_launch": (
            [_P] * 11 + [_I, _I, _L, _I, _I, _I, _P],
            ctypes.c_int,
        ),
        "plane_stats_clusters": ([_I, _I, _I], ctypes.c_int),
    },
    "distinct_count": {
        "distinct_count_launch": (
            [_P, _L, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
            ctypes.c_int,
        ),
    },
    "stacked_query": {
        "stacked_query_launch": (
            [_P, _L, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P],
            ctypes.c_int,
        ),
    },
    "stacked_selected": {
        "stacked_selected_launch": (
            [_P, _L] + [_P] * 7 + [_I, _P, _I] + [_P] * 6 + [_I] * 5 + [_P],
            ctypes.c_int,
        ),
        "stacked_selected_smem": ([_I, _I], ctypes.c_longlong),
    },
    "mesh_fused": {
        "mesh_fused_launch": (
            [_P, _L, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I,
             _P],
            ctypes.c_int,
        ),
        "mesh_fused_planes_launch": (
            [_P, _L, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P]
            + [_P] * 9 + [_I] * 4 + [_P],
            ctypes.c_int,
        ),
        "mesh_fused_smem": ([_I] * 4, ctypes.c_longlong),
    },
    "ring_gather": {
        "ring_step_launch": ([_P, _P, _P, _P, _L, _P], ctypes.c_int),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: compiler report (``-Xptxas -v``) and wall seconds of each build
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build only where the CUDA toolkit is installed"
    )


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": proc.stderr.strip(),
    }
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with its C signatures
    declared (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def build_all() -> dict[str, Path]:
    """Compile every source of ``SIGNATURES`` at once, one ``nvcc``
    process each; returns name -> library path. Raises the first
    failure."""
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        futures = {name: pool.submit(build, name) for name in SIGNATURES}
        return {name: f.result() for name, f in futures.items()}
