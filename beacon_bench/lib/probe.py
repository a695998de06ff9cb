"""What the benchmark reads from the program, from its own side.

- ``counters()``: the program's counters at one instant (kernel
  launches by kernel, the batcher's occupancy, the runner's queue-wait
  histogram) and this process's CPU time; a window's reading is the
  difference of two.
- ``cache_lookups()``, ``server_state()``: what the traffic has filled
  in the server (the response cache, the runner's result handoffs, the
  objects the collector tracks); the warm-up ends on the first.
- ``GcWatch``: the interpreter's garbage-collector pauses, by
  generation, from ``gc.callbacks``.
- ``Instruments``: for the traced run, wrappers placed from the
  benchmark's files around the program's layer boundaries (host spans
  under ``torch.profiler.record_function``) and around the launch
  entries of the kernels the roofline shares read (recording each
  launch's own inputs), and a ``torch.profiler`` capture with CPU and
  CUDA activity on every thread.
- ``reduce_trace``: the capture's device intervals, busy time, kernel
  time by name and the idle gaps named by the host span open then.

Nothing is recorded inside the program.
"""

from __future__ import annotations

import resource
import threading
import time

#: span name -> (module path, attribute path); the wrapped callables
SPANS = {
    "app.handle": ("sbeacon_tpu_torch.api.app", "BeaconApp.handle"),
    "engine.search": ("sbeacon_tpu_torch.engine", "VariantEngine.search"),
    "materialize_response": ("sbeacon_tpu_torch.engine",
                             "materialize_response"),
    "batcher.launch": ("sbeacon_tpu_torch.serving", "MicroBatcher._execute"),
    "batcher.fetch": ("sbeacon_tpu_torch.serving",
                      "MicroBatcher._fetch_batch"),
    "runner.persist": ("sbeacon_tpu_torch.query_jobs",
                       "QueryJobTable.put_response"),
}
#: the range that marks the window in the capture
WINDOW = "bench.window"
#: the spans an idle gap is named by, most specific first
GAP_ORDER = ("materialize_response", "batcher.launch", "batcher.fetch",
             "runner.persist", "engine.search", "app.handle")
#: kernel -> (module, launch entry)
LAUNCHES = {
    "scatter_match": ("sbeacon_tpu_torch.ops.scatter_kernel",
                      "scatter_match"),
    "bisect_query": ("sbeacon_tpu_torch.ops.kernel", "bisect_query"),
}


def server_state(app) -> dict:
    """What the traffic fills in the server: the response cache's
    entries and lookups, the runner's in-memory result handoffs (kept
    for the job table's query TTL), and the objects the collector
    tracks (a walk of the heap: read only at the window's ends)."""
    import gc

    cache = app.engine.cache_stats() or {}
    return {"cache_entries": cache.get("entries", 0),
            "cache_lookups": cache.get("hits", 0) + cache.get("misses", 0),
            "handoffs": len(app.query_runner._results),
            "gc_tracked": len(gc.get_objects())}


def cache_lookups(app) -> tuple[int, int]:
    """(lookups so far, capacity) of the program's response cache;
    (0, 0) when it is off."""
    cache = app.engine.cache_stats()
    if cache is None:
        return 0, 0
    return cache["hits"] + cache["misses"], cache["max_entries"]


def counters(app) -> dict:
    from sbeacon_tpu_torch import telemetry

    ru = resource.getrusage(resource.RUSAGE_SELF)
    batcher = app.engine.batcher
    hist = app.query_runner._wait_hist
    return {
        "t": time.monotonic(),
        "cpu_s": ru.ru_utime + ru.ru_stime,
        "launches": telemetry.launch_counts(),
        "batcher": batcher.occupancy() if batcher is not None else {},
        "runner_wait": (hist.collect().get("", {}) if hist is not None
                        else {}),
    }


class GcWatch:
    """Pauses of the interpreter's cyclic garbage collector, by
    generation, from ``gc.callbacks`` (host clock)."""

    def __init__(self):
        self.pauses = []  # (generation, start, seconds)
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"], time.monotonic(),
                                time.perf_counter() - self._t))

    def install(self):
        import gc

        gc.callbacks.append(self)

    def uninstall(self):
        import gc

        if self in gc.callbacks:
            gc.callbacks.remove(self)

    def between(self, t0, t1) -> dict:
        """{generation: [count, seconds]} of the pauses that ended in
        [t0, t1]."""
        out = {}
        for gen, t, dt in self.pauses:
            if t0 <= t <= t1:
                c = out.setdefault(gen, [0, 0.0])
                c[0] += 1
                c[1] += dt
        return out


def _resolve(mod_name, attr):
    import importlib

    obj = importlib.import_module(mod_name)
    parts = attr.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


class Instruments:
    """Spans and launch records for one traced window."""

    def __init__(self, kernels: list[str], cuda: bool = True):
        self.kernels = kernels
        self.cuda = cuda
        self.records = {k: [] for k in kernels}
        self.recording = False
        self._lock = threading.Lock()
        self._saved = []
        self.prof = None
        self.t_start = self.t_stop = None

    def install(self):
        import torch

        for name, (mod, attr) in SPANS.items():
            owner, key = _resolve(mod, attr)
            fn = getattr(owner, key)
            self._saved.append((owner, key, fn))

            def spanned(*a, _fn=fn, _name=name, **kw):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **kw)

            setattr(owner, key, spanned)
        for kernel in self.kernels:
            owner, key = _resolve(*LAUNCHES[kernel])
            fn = getattr(owner, key)
            self._saved.append((owner, key, fn))
            setattr(owner, key, self._recorder(kernel, fn))

    def uninstall(self):
        for owner, key, fn in reversed(self._saved):
            setattr(owner, key, fn)
        self._saved.clear()

    def _recorder(self, kernel, fn):
        def launch(*a, **kw):
            out = fn(*a, **kw)
            if self.recording:
                rec = _launch_record(kernel, a, kw)
                with self._lock:
                    self.records[kernel].append(rec)
            return out
        return launch

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            pass
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, **kw)
        self.prof.start()

    def open_window(self):
        """Mark the window's start in the capture (a ``bench.window``
        range on this thread) and start recording launches."""
        import torch

        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.t_start = time.monotonic()
        self.recording = True

    def close_window(self):
        self.recording = False
        self.t_stop = time.monotonic()
        self._mark.__exit__(None, None, None)

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()


def _launch_record(kernel, a, kw) -> dict:
    """The inputs (references, no copies: a launch allocates its own
    query tensors) the kernel's bound is computed from."""
    if kernel == "scatter_match":
        ids, q8 = a[1:3]
        T, cap = kw["T"], kw["CAP"]
        C = kw.get("C") or cap // T + 1
        return {"ids": ids, "q8": q8, "T": T, "C": C, "cap": cap}
    columns, _alt_prefix, offsets, qpack = a[:4]
    return {"columns": columns, "offsets": offsets, "q": qpack,
            "W": kw["window_cap"], "R": kw["record_cap"]}


def kernel_name(signature: str) -> str:
    """A kernel's bare name from the signature a trace gives it."""
    bare = signature.replace("(anonymous namespace)::", "")
    return bare.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


def _union(intervals):
    """Sorted disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(prof) -> dict:
    """The capture within the window's range: device busy intervals
    (us, their union), busy seconds, device seconds and event counts by
    kernel name, the host spans (name, start, end), and the window's
    ends and seconds on the capture's clock."""
    events = list(prof.events())
    marks = [ev.time_range for ev in events if ev.name == WINDOW]
    if not marks:
        raise RuntimeError("the capture holds no window mark")
    w_lo, w_hi = marks[0].start, marks[0].end
    device, spans = [], []
    by_name, n_by_name = {}, {}
    for ev in events:
        tr = ev.time_range
        lo, hi = max(tr.start, w_lo), min(tr.end, w_hi)
        if ev.name in SPANS or ev.name == WINDOW:
            # a host range; the trace repeats it on the device's
            # timeline as an annotation, which is no device work
            if (ev.name in SPANS and hi > lo
                    and not str(ev.device_type).endswith("CUDA")):
                spans.append((ev.name, lo, hi))
            continue
        if str(ev.device_type).endswith("CUDA"):
            if tr.start < w_lo or tr.start >= w_hi:
                continue
            device.append((lo, hi))
            key = (ev.name if "emcpy" in ev.name or "emset" in ev.name
                   else kernel_name(ev.name))
            by_name[key] = by_name.get(key, 0.0) + (tr.end - tr.start) / 1e6
            n_by_name[key] = n_by_name.get(key, 0) + 1
    busy = _union(device)
    return {"busy": busy,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "device_s_by_name": by_name, "kernel_launches": n_by_name,
            "spans": spans, "t_lo": w_lo, "t_hi": w_hi,
            "window_s": (w_hi - w_lo) / 1e6}


def idle_gaps(reduced: dict) -> list:
    """[[span name, idle seconds], ...]: the device's idle time between
    its busy intervals (and before the first and after the last, within
    the capture), each gap named by the most specific benchmark span
    open on any host thread at the gap's midpoint ("none" when no span
    is open), summed by name, longest first, at most 10."""
    import numpy as np

    busy = reduced["busy"]
    if not busy:
        return []
    t_lo_us, t_hi_us = reduced["t_lo"], reduced["t_hi"]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if t_lo_us is not None and t_lo_us < busy[0][0]:
        gaps.insert(0, (t_lo_us, busy[0][0]))
    if t_hi_us is not None and t_hi_us > busy[-1][1]:
        gaps.append((busy[-1][1], t_hi_us))
    if not gaps:
        return []
    mid = np.array([(s + e) / 2 for s, e in gaps])
    length = np.array([(e - s) / 1e6 for s, e in gaps])
    name = np.full(len(gaps), "none", dtype=object)
    for span in reversed(GAP_ORDER):
        starts = np.sort([s for n, s, _e in reduced["spans"] if n == span])
        ends = np.sort([e for n, _s, e in reduced["spans"] if n == span])
        if not len(starts):
            continue
        open_ = (np.searchsorted(starts, mid, side="right")
                 - np.searchsorted(ends, mid, side="right")) > 0
        name[open_] = span
    total = {}
    for n, x in zip(name, length):
        total[n] = total.get(n, 0.0) + float(x)
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:10]
