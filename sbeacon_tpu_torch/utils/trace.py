"""Flag-gated hierarchical tracing.

Counterpart of ``sbeacon_tpu/utils/trace.py``, all of it: ``Span``
(with ``to_dict``), ``Tracer`` (with ``wrap``, the decorator form, at
``:228`` there, and ``recent_trees(trace_id=)`` at ``:251``, which backs
the ``/_trace`` route), the process-global ``tracer``, ``span``,
``graft_launch_span`` and the ``SBEACON_TRACE`` switch with its exit
report (``:117``, ``:298``).

One process-global :class:`Tracer` holds a thread-local span stack.
``span("name")`` is a context manager (``tracer.wrap(name)`` the
decorator form); nested spans record parent-child structure. When
disabled (the default) ``span`` returns a no-op singleton — no
allocation, no clock read. Enable via ``SBEACON_TRACE=1``,
``tracer.enable()``, or the thread-scoped ``enabled(True)`` override.
Finished spans aggregate into per-name statistics (count / total / min
/ max) and retain the most recent N complete span trees, indexed by
trace id; ``report()`` renders both, and a process enabled via
``SBEACON_TRACE=1`` prints the report to stderr at exit. Spans opened
under a request context (``telemetry.RequestContext``) carry its trace
id.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..telemetry import current_context, new_span_id


@dataclass(eq=False)  # identity equality: `in`-checks on the span stack
class Span:
    """One finished timed region. ``children`` preserves call structure.

    ``trace_id`` ties the span to the distributed request identity the
    telemetry plane carries (telemetry.RequestContext): every span
    opened while a request context is ambient — including on a worker
    host that received the id via the ``X-Beacon-Trace`` header —
    shares that request's trace id, so one fan-out query's spans
    correlate across processes. ``span_id`` names this span itself.
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


class _NullSpan:
    """No-op context manager handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **kw):
        pass


_NULL = _NullSpan()


class _ActiveSpan:
    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tracer._finish(self.span)
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

    # -- span recording -----------------------------------------------------

    def span(self, name: str, **meta):
        if not self.is_enabled:
            return _NULL
        sp = Span(name=name, t_start=time.perf_counter(), meta=dict(meta))
        ctx = current_context()
        if ctx is not None:
            sp.trace_id = ctx.trace_id
        sp.span_id = new_span_id()
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(sp)
        return _ActiveSpan(self, sp)

    def _finish(self, sp: Span) -> None:
        sp.t_end = time.perf_counter()
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
        with self._lock:
            st = self.stats.get(sp.name)
            el = sp.elapsed
            if st is None:
                self.stats[sp.name] = [1, el, el, el]
            else:
                st[0] += 1
                st[1] += el
                st[2] = min(st[2], el)
                st[3] = max(st[3], el)
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
    return tracer.span(name, **meta)


def graft_launch_span(active, *, elapsed_ms: float = 0.0, **meta) -> None:
    """Adopt one device launch as a ``device.launch`` child span of an
    open span — the in-process twin of the coordinator's worker-span
    graft (parallel/dispatch.py ``_graft_worker_spans``): the launch
    already happened inside ``active``'s scope, so it lays out as the
    trailing ``elapsed_ms`` of it. No-op while tracing is disabled
    (``active`` is the null span) — the kernel hot path pays one
    getattr."""
    sp = getattr(active, "span", None)
    if sp is None:
        return
    now = time.perf_counter()
    sp.children.append(
        Span(
            name="device.launch",
            t_start=now - elapsed_ms / 1e3,
            t_end=now,
            meta=dict(meta),
            trace_id=sp.trace_id,
            span_id=new_span_id(),
        )
    )
