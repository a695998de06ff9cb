"""The arithmetic the per-layer metric files share. Each reader takes a
``Window`` (the counters at the window's two ends, its completed
requests and seconds, and in a traced run the reduced trace and the
launches' bounds) and returns a number, or None where it finds nothing
to read."""

from __future__ import annotations


class Window:
    def __init__(self, before, after, completed, seconds):
        self.before = before
        self.after = after
        self.completed = completed
        self.seconds = seconds
        self.trace = None  # probe.reduce_trace of the capture
        self.window_s = None  # the capture's length, host clock
        self.bounds = {}  # kernel -> [(bound s, bound_by), ...]
        self.power_limit = None
        self.gc = {}  # generation -> [pauses, seconds] in the window
        self.latencies_ms = []  # every request sent in the window


def delta(w: Window, key: str, sub: str) -> float:
    return w.after[key].get(sub, 0) - w.before[key].get(sub, 0)


def percentile(xs, p):
    """The p-th quantile (0..1) by the nearest rank below (frozen copy
    of ``chip_smoke.percentile``)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def requests_per_s(w: Window):
    """Correct answers completed in the window, over its seconds."""
    if not w.completed or not w.seconds:
        return None
    return w.completed / w.seconds


def latency_ms(w: Window, p: float):
    """The p-th quantile of the client-clock latency, send to last
    byte, of every request sent in the window."""
    if not w.latencies_ms:
        return None
    return percentile(w.latencies_ms, p)


def server_cpu_ms_per_req(w: Window):
    if not w.completed:
        return None
    return (w.after["cpu_s"] - w.before["cpu_s"]) / w.completed * 1e3


def hist_median(before: dict, after: dict):
    """Median of the observations between two readings of a cumulative
    bucket histogram, linear within its bucket."""
    if not after or not after.get("buckets"):
        return None
    les = list(after["buckets"])
    cum = [after["buckets"][le] - (before.get("buckets", {}).get(le, 0)
                                   if before else 0) for le in les]
    n = cum[-1]
    if n <= 0:
        return None
    half = n / 2
    lo_edge, below = 0.0, 0
    for le, c in zip(les, cum):
        hi_edge = float("inf") if le == "+Inf" else float(le)
        if c >= half:
            if hi_edge == float("inf"):
                return lo_edge
            inside = c - below
            return lo_edge + (hi_edge - lo_edge) * (half - below) / inside
        lo_edge, below = hi_edge, c
    return None


def runner_wait_ms(w: Window):
    return hist_median(w.before["runner_wait"], w.after["runner_wait"])


def queries_per_launch(w: Window):
    launches = delta(w, "batcher", "launches")
    if launches <= 0:
        return None
    return delta(w, "batcher", "specs") / launches


def launches_per_req(w: Window, kernel: str):
    if not w.completed:
        return None
    return delta(w, "launches", kernel) / w.completed


def roofline_pct(w: Window, kernel: str):
    """The launches' mean bound over the kernel's mean device time in
    the trace, in percent; (value, bound_by) or None."""
    if w.trace is None:
        return None
    recs = w.bounds.get(kernel) or []
    names = [n for n in w.trace["device_s_by_name"]
             if n.startswith(kernel)]
    dev_s = sum(w.trace["device_s_by_name"][n] for n in names)
    n_dev = sum(w.trace["kernel_launches"].get(n, 0) for n in names)
    if not recs or dev_s <= 0 or not n_dev:
        return None
    mean_bound = sum(b for b, _by in recs) / len(recs)
    by_bytes = sum(1 for _b, by in recs if by == "bytes")
    bound_by = "bytes" if by_bytes * 2 >= len(recs) else "operations"
    return 100.0 * mean_bound / (dev_s / n_dev), bound_by


def device_idle_pct(w: Window):
    if w.trace is None or not w.window_s or not w.trace["busy"]:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.window_s)


def gc_pause_pct(w: Window):
    """Share of the window the server process spent paused in the
    cyclic garbage collector, every generation, in percent."""
    if not w.seconds:
        return None
    return 100.0 * sum(sec for _n, sec in w.gc.values()) / w.seconds
