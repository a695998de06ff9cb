"""The per-layer metrics the program's own spans give: the capture log
of ``sbeacon_tpu_torch.utils.trace``, read after the traced window
through the program's public ``capture_records(t0, t1)``.

The program records a span while a ``torch.profiler`` capture runs (the
traced run's): name, trace id, span id, parent span id, start and end on
``time.monotonic()`` (the clock the window's ends are stamped with), the
thread's CPU seconds over it, the thread and its notes. Nothing here
wraps or patches the program. A program without the capture log (or a
window it recorded nothing in) gives every reader None, and the result
line leaves the metric out.

Each span is clipped to the window ``[w.before["t"], w.after["t"]]``;
"per request" divides by the requests completed in the window
(``w.completed``), as ``launches_per_req`` does.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right


def records(w):
    """The window's spans (the program's ``CaptureRecord``s), or None
    where the program keeps no capture log or logged nothing. Read once
    a window."""
    cached = getattr(w, "_program_spans", False)
    if cached is not False:
        return cached
    recs = None
    try:
        from sbeacon_tpu_torch.utils import trace
    except ImportError:
        trace = None
    read = getattr(trace, "capture_records", None)
    if read is not None and w.before and w.after:
        recs = list(read(w.before["t"], w.after["t"])) or None
    w._program_spans = recs
    return recs


def window(w) -> tuple[float, float]:
    return w.before["t"], w.after["t"]


def clipped(r, t0: float, t1: float) -> float:
    """Seconds of span ``r`` inside [t0, t1]."""
    return max(0.0, min(r.end, t1) - max(r.start, t0))


def of(recs, name: str) -> list:
    return [r for r in recs if r.name == name]


def per_req_ms(w, seconds: float):
    if not w.completed:
        return None
    return seconds / w.completed * 1e3


def span_ms_per_req(w, name: str):
    """The named spans' seconds inside the window, per completed
    request, in ms; None without spans or requests."""
    recs = records(w)
    if recs is None:
        return None
    t0, t1 = window(w)
    return per_req_ms(w, sum(clipped(r, t0, t1) for r in of(recs, name)))


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Cover:
    """Seconds of a union of intervals inside any [a, b], by prefix
    sums."""

    def __init__(self, intervals):
        u = _union(intervals)
        self.starts = [s for s, _e in u]
        self.ends = [e for _s, e in u]
        self.prefix = [0.0]
        for s, e in u:
            self.prefix.append(self.prefix[-1] + (e - s))

    def inside(self, a: float, b: float) -> float:
        if b <= a:
            return 0.0
        lo = bisect_right(self.ends, a)   # first interval ending after a
        hi = bisect_left(self.starts, b)  # intervals starting before b
        if hi <= lo:
            return 0.0
        total = self.prefix[hi] - self.prefix[lo]
        # trim the first and last intervals to [a, b]
        total -= max(0.0, a - self.starts[lo])
        total -= max(0.0, self.ends[hi - 1] - b)
        return total


def gc_ms_per_req(w):
    """Per completed request, the collector's pause time (``host.gc``)
    that overlaps the request's ``http.request`` span, both clipped to
    the window: a pause stops every request in flight, so each is
    charged all of it."""
    recs = records(w)
    if recs is None:
        return None
    t0, t1 = window(w)
    cover = _Cover((r.start, r.end) for r in of(recs, "host.gc"))
    total = sum(cover.inside(max(r.start, t0), min(r.end, t1))
                for r in of(recs, "http.request"))
    return per_req_ms(w, total)


def wake_ms_per_req(w):
    """Per completed request, the hand-off from the runner's worker to
    the waiting handler: each ``runner.await`` span's end less the
    latest ``runner.done`` instant of the same ``query_id`` before it,
    counted from the await's start where the job was done before the
    handler began to wait (a hit in the handed-off results waits for
    nothing), clipped to the window."""
    recs = records(w)
    if recs is None:
        return None
    t0, t1 = window(w)
    done: dict = {}
    for r in of(recs, "runner.done"):
        qid = (r.notes or {}).get("query_id")
        done.setdefault(qid, []).append(r.end)
    for ts in done.values():
        ts.sort()
    total = 0.0
    for r in of(recs, "runner.await"):
        ts = done.get((r.notes or {}).get("query_id"))
        if not ts:
            continue
        i = bisect_right(ts, r.end)
        if not i:
            continue
        lo = max(ts[i - 1], r.start, t0)
        total += max(0.0, min(r.end, t1) - lo)
    return per_req_ms(w, total)


def handler_lock_ms_per_req(w):
    """Per completed request, the waits for the job table's lock
    (``jobs.lock``) made on a request's critical path: inside an
    ``http.request`` span on the same thread, clipped to the window."""
    recs = records(w)
    if recs is None:
        return None
    t0, t1 = window(w)
    by_thread: dict = {}
    for r in of(recs, "http.request"):
        by_thread.setdefault(r.thread, []).append((r.start, r.end))
    covers = {t: _Cover(iv) for t, iv in by_thread.items()}
    total = 0.0
    for r in of(recs, "jobs.lock"):
        cover = covers.get(r.thread)
        if cover is None:
            continue
        a, b = max(r.start, t0), min(r.end, t1)
        if cover.inside(a, b) >= (b - a) - 1e-12:
            total += max(0.0, b - a)
    return per_req_ms(w, total)


def oncpu_pct(w, name: str):
    """The named spans' thread-CPU seconds over their wall seconds,
    each clipped to the window (its CPU pro rata), in percent."""
    recs = records(w)
    if recs is None:
        return None
    t0, t1 = window(w)
    wall = cpu = 0.0
    for r in of(recs, name):
        inside = clipped(r, t0, t1)
        if inside <= 0 or r.end <= r.start:
            continue
        wall += inside
        cpu += r.cpu_s * inside / (r.end - r.start)
    if wall <= 0:
        return None
    return 100.0 * cpu / wall
