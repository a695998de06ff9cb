"""Shared pieces of the port's ingest parity tests.

``no_thread_leak`` is imported into each port test file that builds
engines, apps, runners, batchers, workers or ingest services, as an
autouse fixture: an ingest service starts a compactor thread by default,
and a thread a test leaves running (a compactor, a batcher, a runner
pool, a worker server) inflates the process-wide launch counters other
tests in the same worker read. ``assert_shards_equal`` holds a port shard against a JAX
one (or two port shards) at tolerance 0, every column, blob, plane and
meta key.
"""

from __future__ import annotations

import gc
import threading
import time
import types
import weakref

import numpy as np
import pytest

#: the plane arrays a shard may carry
PLANES = ("gt_bits", "gt_bits2", "tok_bits1", "tok_bits2", "gt_overflow",
          "tok_overflow")
#: the other arrays of a shard
ARRAYS = ("chrom_offsets", "ref_blob", "ref_off", "alt_blob", "alt_off",
          "vt_codes")


def _pool_of(thread):
    """The pool a worker thread serves, or None for a plain thread: a
    ``ThreadPoolExecutor`` (its workers hold a weakref to it) or an
    object whose bound method is the thread's target (a launch pool)."""
    owner = getattr(getattr(thread, "_target", None), "__self__", None)
    if owner is not None:
        return owner
    args = getattr(thread, "_args", ())
    if args and isinstance(args[0], weakref.ReferenceType):
        return args[0]()
    return None


#: objects not walked when looking for a longer-lived owner
_OPAQUE = (types.ModuleType, type, types.FunctionType,
           types.BuiltinFunctionType, str, bytes, np.ndarray)


def _reachable(roots, wanted: set, budget: int = 200_000) -> set:
    """The ids in ``wanted`` reachable from ``roots`` through
    ``gc.get_referents`` (modules, classes and functions not walked)."""
    found, seen, stack = set(), set(), list(roots)
    while stack and len(seen) < budget and found != wanted:
        obj = stack.pop()
        if id(obj) in seen or isinstance(obj, _OPAQUE):
            continue
        seen.add(id(obj))
        if id(obj) in wanted:
            found.add(id(obj))
        stack.extend(gc.get_referents(obj))
    return found


def _long_lived_roots(request) -> list:
    """The test module's globals and the values of the test's fixtures
    of module or wider scope: what outlives the test."""
    roots = list(vars(request.module).values())
    info = getattr(request.node, "_fixtureinfo", None)
    defs = getattr(info, "name2fixturedefs", {})
    for name, value in getattr(request.node, "funcargs", {}).items():
        fdefs = defs.get(name)
        if fdefs and getattr(fdefs[-1], "scope", "function") != "function":
            roots.append(value)
    return roots


@pytest.fixture(autouse=True)
def no_thread_leak(monkeypatch, request):
    """Fail the test if a thread it started is still alive after it
    (after a grace of up to 30 s for pools already told to stop). A
    thread counts as the test's when the test's own thread, or a thread
    the test started, started it: threads that other files' leftover
    apps start meanwhile (their canary or compactor rounds) are theirs,
    not this test's. A worker of a pool that outlives the test (held by
    the module's globals or a module-scoped fixture, which close it in
    their own teardown) is not the test's either."""
    ours = {threading.current_thread()}
    lock = threading.Lock()
    real_start = threading.Thread.start

    def start(self, *args, **kwargs):
        with lock:
            if threading.current_thread() in ours:
                ours.add(self)
        return real_start(self, *args, **kwargs)

    monkeypatch.setattr(threading.Thread, "start", start)
    yield
    monkeypatch.setattr(threading.Thread, "start", real_start)
    deadline = time.monotonic() + 30.0
    left = []
    with lock:
        started = [t for t in ours if t is not threading.current_thread()]
    pools = {id(p): p for p in map(_pool_of, started) if p is not None}
    if pools:
        kept = _reachable(_long_lived_roots(request), set(pools))
        started = [t for t in started if id(_pool_of(t)) not in kept]
    for t in started:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            left.append(t.name)
    assert not left, f"threads left running: {left}"


def assert_shards_equal(a, b, *, meta: bool = True) -> None:
    """Two shards (any package) equal at tolerance 0."""
    if meta:
        assert a.meta == b.meta
    assert sorted(a.cols) == sorted(b.cols)
    for k in a.cols:
        np.testing.assert_array_equal(a.cols[k], b.cols[k], err_msg=k)
        assert a.cols[k].dtype == b.cols[k].dtype, k
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    for k in PLANES:
        pa, pb = getattr(a, k), getattr(b, k)
        assert (pa is None) == (pb is None), k
        if pa is not None:
            np.testing.assert_array_equal(pa, pb, err_msg=k)
            assert pa.dtype == pb.dtype, k


def close_service(svc) -> None:
    """Stop an ingest service's compactor and close its ledger."""
    svc.close()
    svc.ledger.close()
