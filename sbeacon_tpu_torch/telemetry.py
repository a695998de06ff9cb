"""Device-launch accounting for the port's kernels.

Counterpart of the launch seam of ``sbeacon_tpu/telemetry.py``
(``record_device_launch`` / ``note_device_stage``), trimmed to a launch
count per kernel and a short ring of recent launch records. The flight
recorder, the metrics registry and request contexts are not ported.

A kernel wrapper calls ``record_device_launch`` exactly where it
launches its CUDA kernel and nowhere else, so ``launch_count(name)``
counts real device launches: a run can show that its main path went
through the kernel. The plain-PyTorch twins never record.
"""

from __future__ import annotations

import threading
from collections import deque

_lock = threading.Lock()
_counts: dict[str, int] = {}
_seq = 0
#: the most recent launch records, newest last (bounded)
_recent: deque = deque(maxlen=4096)
#: cumulative per-name totals that are not launch counts (e.g. the mesh
#: tier's evaluated (entry, query-slot) pairs)
_totals: dict[str, int] = {}


def record_device_launch(kernel: str, **kw) -> int:
    """Count one launch of ``kernel`` and keep its record (``kw``:
    shapes, slot counts, launch ms). Returns the record's sequence
    number for :func:`note_device_stage`."""
    global _seq
    with _lock:
        _counts[kernel] = _counts.get(kernel, 0) + 1
        _seq += 1
        _recent.append({"seq": _seq, "kernel": kernel, **kw})
        return _seq


def note_device_stage(seq, **kw) -> None:
    """Attach stage timings (e.g. ``fetch_ms``) to a recorded launch;
    ``seq=None`` (a CPU run, which launched nothing) no-ops."""
    if seq is None:
        return
    with _lock:
        for rec in reversed(_recent):
            if rec["seq"] == seq:
                rec.update(kw)
                return


def launch_count(kernel: str) -> int:
    with _lock:
        return _counts.get(kernel, 0)


def add_total(name: str, n: int = 1) -> None:
    """Add ``n`` to the cumulative total ``name``."""
    with _lock:
        _totals[name] = _totals.get(name, 0) + int(n)


def total(name: str) -> int:
    with _lock:
        return _totals.get(name, 0)


def reset_launch_counts() -> None:
    """Zero every kernel's count and every total, and drop the launch
    records."""
    with _lock:
        _counts.clear()
        _totals.clear()
        _recent.clear()


def percentiles(xs) -> dict:
    """{'p50', 'p90', 'p99'} of a sample (empty dict when empty)."""
    xs = sorted(xs)
    if not xs:
        return {}
    pick = lambda p: xs[min(len(xs) - 1, int(p * len(xs)))]
    return {"p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99)}


def recent_launches() -> list[dict]:
    with _lock:
        return [dict(r) for r in _recent]
