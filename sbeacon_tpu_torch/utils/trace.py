"""The program's one span system.

Counterpart of ``sbeacon_tpu/utils/trace.py``: ``Span`` (with
``to_dict``), ``Tracer`` (with ``wrap``, the decorator form, at
``:228`` there, and ``recent_trees(trace_id=)`` at ``:251``, which backs
the ``/_trace`` route), the process-global ``tracer``, ``span`` and the
``SBEACON_TRACE`` switch with its exit report (``:117``, ``:298``). The
JAX package's ``graft_launch_span`` has no counterpart: nothing read it.

``span("name")`` is the program's only way to mark a region (a context
manager; ``tracer.wrap(name)`` the decorator form). It records while
``SBEACON_TRACE=1``, ``tracer.enable()`` or the thread-scoped
``tracer.enabled(True)`` is on, and while a ``torch.profiler`` capture
runs in this process (any capture: ``SBEACON_PROFILE``'s, see
``telemetry.profiler``, or one a caller starts). Otherwise it returns a
shared no-op object: a flag check, no clock read, no allocation.

A recorded span:

- sits on the tracer's per-thread span stack and, while the tracer is
  on, enters its per-name statistics (count / total / min / max) and
  the most recent complete span trees, indexed by trace id
  (``report()``, ``/_trace``); a process enabled by ``SBEACON_TRACE=1``
  prints the report to stderr at exit;
- carries the trace id of the ambient request context
  (``telemetry.RequestContext``), a span id of its own, and its
  parent's: the span open beneath it on this thread, or, for the first
  span of work handed to a pool thread, the span open where it was
  handed off (``telemetry.request_context(ctx, span_id=)`` with
  :func:`current_span_id` taken at the hand-off);
- while a capture runs, opens a ``sbeacon.<name>`` range in it, on the
  capture's own clock and on every thread, and at its end appends one
  :class:`CaptureRecord` to the **capture log**: name, trace id, span
  id, parent span id, start and end on ``time.monotonic()``, the
  thread's CPU seconds over the span (``time.thread_time()``), the
  thread and the span's notes.

The range is a function-scope range (``_RecordFunctionFast``), not the
user-scope one of ``torch.profiler.record_function``: the profiler
repeats the innermost user-scope range around each kernel on the
device's timeline as a ``gpu_user_annotation``, which a reader of the
device timeline would count as device work.

Spans whose ends the caller took (:func:`record`, :func:`instant`) land
in the statistics and the capture log alike, with no range; so do the
collector's pauses while a capture runs (``host.gc``, from a
``gc.callbacks`` hook installed once at import, noting the generation;
the log only).

Whether anything records is decided in one place,
:meth:`Tracer.recording`. The capture log is cleared when a capture
starts (at the first span or record that sees it running), kept when it
stops, and read with :func:`capture_records`.
"""

from __future__ import annotations

import functools
import gc
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

# torch keeps a process-wide flag of a running capture here
import torch.autograd.profiler as _profiler_state
from torch._C._profiler import _RecordFunctionFast

from ..telemetry import current_context, handoff_span_id, new_span_id

#: the prefix of the program's ranges in a ``torch.profiler`` capture
RANGE_PREFIX = "sbeacon."
#: the capture log's bound, in records (a traced benchmark window
#: writes about 1e5)
CAPTURE_LOG_SIZE = 1 << 20


@dataclass(eq=False)  # identity equality: `in`-checks on the span stack
class Span:
    """One finished timed region. ``children`` preserves call structure.

    ``trace_id`` ties the span to the distributed request identity the
    telemetry plane carries (telemetry.RequestContext): every span
    opened while a request context is ambient — including on a worker
    host that received the id via the ``X-Beacon-Trace`` header —
    shares that request's trace id, so one fan-out query's spans
    correlate across processes. ``span_id`` names this span itself.
    ``t_start`` and ``t_end`` are on ``time.monotonic()``.
    """

    name: str
    t_start: float
    t_end: float = 0.0
    meta: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)
    trace_id: str = ""
    span_id: str = ""

    @property
    def elapsed(self) -> float:
        return self.t_end - self.t_start

    def flatten(self):
        yield self
        for c in self.children:
            yield from c.flatten()

    def to_dict(self) -> dict:
        """JSON-ready form for the /_trace debug endpoint."""
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "elapsedMs": round(1e3 * self.elapsed, 3),
            "meta": dict(self.meta),
            "children": [c.to_dict() for c in self.children],
        }


class CaptureRecord(NamedTuple):
    """One span of the capture log; ``start``/``end`` on
    ``time.monotonic()`` (equal for an instant)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str
    start: float
    end: float
    cpu_s: float
    thread: int
    notes: dict | None


def _flat(notes: dict):
    """A span's notes as the log keeps them: key, value, key, value."""
    for kv in notes.items():
        yield from kv


class _Capture:
    """The capture log and whether the running capture has been seen.
    A record is one flat tuple, :class:`CaptureRecord`'s first eight
    fields and then the notes' keys and values: the collector stops
    tracking a plain tuple of atomic values the first time it sees it,
    where it would track a dict or a tuple subclass for good and walk
    the whole log in every collection."""

    def __init__(self):
        self.live = False
        self.log: deque = deque(maxlen=CAPTURE_LOG_SIZE)
        self.lock = threading.Lock()

    def begin(self) -> None:
        with self.lock:
            if not self.live:
                self.log.clear()
                self.live = True


_capture = _Capture()


def _capturing() -> bool:
    """Whether a capture runs; notes a capture's start or end."""
    if _profiler_state._is_profiler_enabled:
        if not _capture.live:
            _capture.begin()
        return True
    if _capture.live:
        _capture.live = False
    return False


class _NullSpan:
    """No-op context manager handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **kw):
        pass


_NULL = _NullSpan()


class _ActiveSpan:
    __slots__ = ("tracer", "span", "parent_id", "cpu0", "range", "keep")

    def __init__(self, tracer, span, parent_id, cpu0, rng, keep):
        self.tracer = tracer
        self.span = span
        self.parent_id = parent_id
        self.cpu0 = cpu0
        self.range = rng
        #: into the statistics and trees (the tracer is on here); a
        #: span recorded for a capture alone goes to the capture log
        self.keep = keep

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        sp = self.span
        self.tracer._finish(sp, self.keep)
        if self.range is not None:
            self.range.__exit__(None, None, None)
            _capture.log.append((
                sp.name, sp.trace_id, sp.span_id, self.parent_id,
                sp.t_start, sp.t_end, time.thread_time() - self.cpu0,
                threading.get_ident(), *_flat(sp.meta)))
        return False

    def note(self, **kw):
        """Attach metadata (bytes scanned, batch size, ...) to the span."""
        self.span.meta.update(kw)


class Tracer:
    def __init__(self, enabled: bool | None = None, keep_trees: int = 32):
        if enabled is None:
            enabled = os.environ.get("SBEACON_TRACE", "") not in ("", "0")
        self._enabled = enabled
        self._keep_trees = keep_trees
        self._local = threading.local()
        self._lock = threading.Lock()
        # name -> [count, total, min, max]
        self.stats: dict[str, list[float]] = {}
        self.trees: list[Span] = []
        # trace_id -> [root Span, ...] over the SAME retained trees:
        # /_trace?trace_id= resolves in O(trees-for-id) instead of
        # re-serialising and filtering the whole ring per lookup
        # (exemplar-to-trace resolution is a per-dashboard-click path)
        self._by_trace: dict[str, list[Span]] = {}

    # -- gating -------------------------------------------------------------

    @property
    def is_enabled(self) -> bool:
        override = getattr(self._local, "override", None)
        return self._enabled if override is None else override

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @contextmanager
    def enabled(self, on: bool = True):
        """Thread-scoped override: ``with tracer.enabled(): ...``. The
        override lives in thread-local state so concurrent scopes in other
        threads neither see it nor clobber the process-wide flag."""
        prev = getattr(self._local, "override", None)
        self._local.override = on
        try:
            yield self
        finally:
            self._local.override = prev

    def recording(self) -> bool:
        """The one gate of :meth:`span`, :meth:`record` and the module's
        functions: whether what this thread marks now records — while a
        capture runs, else while this tracer is on for the thread."""
        return _capturing() or self.is_enabled

    # -- span recording -----------------------------------------------------

    def span(self, name: str, **meta):
        if not self.recording():
            return _NULL
        return self._open(name, meta)

    def _open(self, name: str, meta: dict):
        ctx = current_context()
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent_id = stack[-1].span_id if stack else handoff_span_id()
        sp = Span(name=name, t_start=time.monotonic(), meta=meta,
                  trace_id=ctx.trace_id if ctx is not None else "",
                  span_id=new_span_id())
        stack.append(sp)
        rng = None
        if _capture.live:
            rng = _RecordFunctionFast(RANGE_PREFIX + name)
            rng.__enter__()
        return _ActiveSpan(self, sp, parent_id, time.thread_time(), rng,
                           self.is_enabled)

    def current_span_id(self) -> str:
        """The innermost span open on this thread, else the hand-off's
        span (``telemetry.handoff_span_id()``), else ""."""
        stack = getattr(self._local, "stack", None)
        if stack:
            return stack[-1].span_id
        return handoff_span_id()

    def _stat(self, name: str, el: float) -> None:
        """Call holding ``self._lock``."""
        st = self.stats.get(name)
        if st is None:
            self.stats[name] = [1, el, el, el]
        else:
            st[0] += 1
            st[1] += el
            st[2] = min(st[2], el)
            st[3] = max(st[3], el)

    def _finish(self, sp: Span, keep: bool = True) -> None:
        sp.t_end = time.monotonic()
        # a span entered on one thread may be exited on another (the
        # batcher's launcher/fetcher pools hand work across threads):
        # the finishing thread then has no span stack at all — record
        # stats only instead of raising AttributeError mid-request
        stack = getattr(self._local, "stack", None) or ()
        was_root = False
        if sp in stack:
            # spans still open above sp were opened inside its scope: a
            # mis-ordered exit adopts them as children rather than
            # discarding them (or sp's own ancestors)
            while stack[-1] is not sp:
                sp.children.append(stack.pop())
            stack.pop()
            # spans beneath that already finished were exited on
            # ANOTHER thread (stats-only, never popped here): they can
            # never be popped by their own exit, so left in place they
            # would adopt every later tree on this thread and grow
            # unboundedly — drop them; their stats are already recorded
            while stack and stack[-1].t_end:
                stack.pop()
            if stack:
                stack[-1].children.append(sp)
            else:
                was_root = True
        # else: sp was already adopted by a mis-ordered ancestor exit —
        # record stats only, leave the stack alone
        if not keep:
            return
        with self._lock:
            self._stat(sp.name, sp.elapsed)
            if was_root:  # a completed root tree
                self.trees.append(sp)
                if sp.trace_id:
                    self._by_trace.setdefault(sp.trace_id, []).append(sp)
                if len(self.trees) > self._keep_trees:
                    evicted = self.trees[: -self._keep_trees]
                    del self.trees[: -self._keep_trees]
                    for old in evicted:
                        bucket = self._by_trace.get(old.trace_id)
                        if bucket is None:
                            continue
                        try:
                            bucket.remove(old)
                        except ValueError:
                            pass
                        if not bucket:
                            del self._by_trace[old.trace_id]

    def record(self, name: str, start: float, end: float, *,
               trace_id: str | None = None, parent_id: str | None = None,
               cpu_s: float = 0.0, **notes) -> None:
        """A span whose ends the caller took (``time.monotonic()``):
        into the statistics while the tracer is on, and into the capture
        log while a capture runs.
        The trace id and parent default to the ambient request's and
        :meth:`current_span_id`."""
        if not self.recording():
            return
        if trace_id is None:
            ctx = current_context()
            trace_id = ctx.trace_id if ctx is not None else ""
        if parent_id is None:
            parent_id = self.current_span_id()
        if self.is_enabled:
            with self._lock:
                self._stat(name, end - start)
        if _capture.live:
            _capture.log.append((
                name, trace_id, new_span_id(), parent_id, start, end,
                cpu_s, threading.get_ident(), *_flat(notes)))

    def wrap(self, name: str | None = None):
        """Decorator form: ``@tracer.wrap("kernel.run")``."""

        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*a, **kw):
                with self.span(label):
                    return fn(*a, **kw)

            return inner

        return deco

    # -- reporting ----------------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()
            self.trees.clear()
            self._by_trace.clear()

    def recent_trees(self, trace_id: str | None = None) -> list[dict]:
        """The retained complete span trees as JSON-ready dicts (the
        /_trace payload), newest last; ``trace_id`` filters to one
        distributed request's spans via the maintained per-trace index
        — O(matching trees), not a serialise-and-scan of the whole
        ring (the exemplar-click resolution path)."""
        with self._lock:
            if trace_id is not None:
                trees = list(self._by_trace.get(trace_id, ()))
            else:
                trees = list(self.trees)
        return [t.to_dict() for t in trees]

    def report(self) -> str:
        """Aggregate table + the most recent span tree."""
        with self._lock:
            lines = [
                f"{'span':<40} {'count':>7} {'total_s':>10} "
                f"{'mean_ms':>9} {'min_ms':>9} {'max_ms':>9}"
            ]
            for name in sorted(self.stats):
                n, tot, mn, mx = self.stats[name]
                lines.append(
                    f"{name:<40} {int(n):>7} {tot:>10.4f} "
                    f"{1e3 * tot / n:>9.3f} {1e3 * mn:>9.3f} {1e3 * mx:>9.3f}"
                )
            if self.trees:
                lines.append("")
                lines.extend(self._render(self.trees[-1], 0))
        return "\n".join(lines)

    def _render(self, sp: Span, depth: int):
        meta = (
            " " + " ".join(f"{k}={v}" for k, v in sp.meta.items())
            if sp.meta
            else ""
        )
        yield f"{'  ' * depth}{sp.name}: {1e3 * sp.elapsed:.3f}ms{meta}"
        for c in sp.children:
            yield from self._render(c, depth + 1)


#: process-global tracer — modules do ``from ..utils.trace import tracer``
tracer = Tracer()

if tracer.is_enabled:
    # enabled-by-env processes print the aggregate report at exit, so
    # SBEACON_TRACE=1 always yields output even without the /_trace route
    import atexit
    import sys

    atexit.register(
        lambda: print(
            "\n== sbeacon trace report ==\n" + tracer.report(),
            file=sys.stderr,
        )
    )


def span(name: str, **meta):
    """``with span("engine.search") as sp: ... sp.note(batch=n)``."""
    return tracer.span(name, **meta)


def record(name: str, start: float, end: float, **kw) -> None:
    """:meth:`Tracer.record` on the process tracer."""
    tracer.record(name, start, end, **kw)


def instant(name: str, **notes) -> None:
    """A span of no length, now."""
    if tracer.recording():
        t = time.monotonic()
        tracer.record(name, t, t, **notes)


def current_span_id() -> str:
    """The span to hand off with work for another thread (see
    :meth:`Tracer.current_span_id`); "" while nothing records."""
    return tracer.current_span_id()


def capture_records(t0: float = float("-inf"),
                    t1: float = float("inf")) -> list[CaptureRecord]:
    """The capture log's spans that overlap ``[t0, t1]``
    (``time.monotonic()``), in the order they ended."""
    _capturing()
    with _capture.lock:
        log = list(_capture.log)
    return [CaptureRecord(*r[:8], dict(zip(r[8::2], r[9::2])) or None)
            for r in log if r[5] >= t0 and r[4] <= t1]


# -- the collector's pauses ---------------------------------------------------

_gc_start: tuple | None = None


def _gc_hook(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: while a capture runs, each collection is a
    ``host.gc`` record on the thread the collector ran on, noting its
    generation. It takes no lock (a collection may start while this
    thread holds any of them), so it reads the capture's state without
    the gate, which may clear the log under one, and keeps out of the
    statistics."""
    global _gc_start
    if phase == "start":
        if _profiler_state._is_profiler_enabled and _capture.live:
            _gc_start = (time.monotonic(), time.thread_time())
        return
    if _gc_start is None:
        return
    t0, c0 = _gc_start
    _gc_start = None
    _capture.log.append((
        "host.gc", "", new_span_id(), "", t0, time.monotonic(),
        time.thread_time() - c0, threading.get_ident(),
        "generation", info.get("generation")))


gc.callbacks.append(_gc_hook)
