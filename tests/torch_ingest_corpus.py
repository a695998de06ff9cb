"""Shared pieces of the port's ingest parity tests.

``no_thread_leak`` is imported into each ingest test file as an autouse
fixture: an ingest service starts a compactor thread by default, and a
thread a test leaves running (a compactor, a batcher, a runner pool)
inflates the process-wide launch counters other tests in the same
worker read. ``assert_shards_equal`` holds a port shard against a JAX
one (or two port shards) at tolerance 0, every column, blob, plane and
meta key.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

#: the plane arrays a shard may carry
PLANES = ("gt_bits", "gt_bits2", "tok_bits1", "tok_bits2", "gt_overflow",
          "tok_overflow")
#: the other arrays of a shard
ARRAYS = ("chrom_offsets", "ref_blob", "ref_off", "alt_blob", "alt_off",
          "vt_codes")


@pytest.fixture(autouse=True)
def no_thread_leak(monkeypatch):
    """Fail the test if a thread it started is still alive after it
    (after a grace of up to 30 s for pools already told to stop). A
    thread counts as the test's when the test's own thread, or a thread
    the test started, started it: threads that other files' leftover
    apps start meanwhile (their canary or compactor rounds) are theirs,
    not this test's."""
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
