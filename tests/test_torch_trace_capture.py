"""The port's one span system (``sbeacon_tpu_torch.utils.trace``) under a
``torch.profiler`` capture, on the CPU.

With nothing recording, ``span`` hands out the shared null object and a
request through the port's HTTP server adds nothing to the capture log.
Under a capture (CPU activity, every thread), one ``/g_variants``
request through that server leaves every boundary span in the log under
one trace id, on the handler's, the runner's and the batcher's threads,
each hand-off's span the parent of the first span on the next thread,
with a matching ``sbeacon.*`` range in the capture; a forced collection
leaves a ``host.gc`` record. The log outlives the app and clears when
the next capture starts. ``SBEACON_PROFILE``'s process capture starts
at the batcher's first launch and exports the ranges to its Chrome
trace. The runner's finer queue-wait buckets
put the interpolated median within a bucket of a known sample's.
"""

from __future__ import annotations

import gc
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.api import BeaconApp
from sbeacon_tpu_torch.api.server import start_background
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    ObservabilityConfig,
    ShapingConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.metadata import MetadataStore, OntologyStore
from sbeacon_tpu_torch.query_jobs import RUNNER_WAIT_BUCKETS_MS
from sbeacon_tpu_torch.testing import synthetic_shard
from sbeacon_tpu_torch.utils import trace
from torch_ingest_corpus import no_thread_leak  # noqa: F401  (autouse)

#: the spans one variant request leaves, by the thread they run on
HANDLER = ("http.request", "api.handle", "runner.submit", "runner.await",
           "jobs.lock")
WORKER = ("runner.queue_wait", "query_jobs.run", "engine.search",
          "runner.done", "jobs.lock")
LAUNCHER = ("kernel.launch", "batcher.wait")
FETCHER = ("kernel.fetch",)
#: spans whose ends the caller took: no range in the capture
NO_RANGE = {"runner.queue_wait", "runner.done", "batcher.wait", "host.gc"}


def _capture():
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    return profile(activities=[ProfilerActivity.CPU], **kw)


@pytest.fixture
def served(tmp_path):
    """The port's app over a 4000-row shard on the CPU behind its HTTP
    server; yields (port, shard, app)."""
    shard = synthetic_shard(4000, seed=5, dataset_id="d1")
    config = BeaconConfig(
        storage=StorageConfig(root=tmp_path),
        shaping=ShapingConfig(enabled=False),
        observability=ObservabilityConfig(canary_enabled=False),
    )
    engine = VariantEngine(config, device="cpu")
    engine.add_index(shard)
    onto = OntologyStore()
    store = MetadataStore(ontology=onto)
    vcf = "synthetic://d1"
    store.upsert("datasets", [{
        "id": "d1", "name": "d1", "_assemblyId": "GRCh38",
        "_vcfLocations": [vcf], "_vcfGroups": [[vcf]],
        "_vcfGroupsExplicit": False, "_vcfChromosomeMap": []}])
    app = BeaconApp(config, store=store, ontology=onto, engine=engine)
    http, thread = start_background(app)
    try:
        yield http.server_address[1], shard, app
    finally:
        http.shutdown()
        http.server_close()
        thread.join(timeout=30)
        app.close()
        engine.close()
        store.close()
        onto.close()


def _ask(port, shard, k: int, trace_id: str | None = None) -> dict:
    """A count query for the bracket around row ``k``'s position."""
    pos = int(shard.cols["pos"][k])
    body = {"meta": {"apiVersion": "2.0"},
            "query": {"requestedGranularity": "count",
                      "requestParameters": {
                          "assemblyId": "GRCh38",
                          "referenceName": shard.row_chrom(k),
                          "start": [max(pos - 2000, 0), pos + 2000],
                          "end": [pos - 1, pos + 4000]}}}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/datasets/d1/g_variants",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 **({"X-Beacon-Trace": trace_id} if trace_id else {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        return json.loads(r.read())


def _settle(app, timeout_s: float = 30.0) -> None:
    """Wait until the runner's job has persisted its result: the job
    runs on after it has released the request."""
    t_end = time.monotonic() + timeout_s
    while app.query_runner.metrics()["active"]:
        assert time.monotonic() < t_end
        time.sleep(0.005)


def test_nothing_records_without_a_capture(served):
    port, shard, _app = served
    assert not trace.tracer.is_enabled
    assert trace.span("engine.search") is trace._NULL
    before = trace.capture_records()
    for k in (10, 900, 2500):
        _ask(port, shard, k)
    gc.collect()
    assert trace.capture_records() == before
    assert trace.current_span_id() == ""


def test_one_request_spans_every_boundary_under_one_trace_id(served):
    port, shard, app = served
    _ask(port, shard, 100)  # warm: the first request pays no set-up
    prof = _capture()
    prof.start()
    try:
        doc = _ask(port, shard, 200, trace_id="capture-t1")
        _settle(app)
        gc.collect()
    finally:
        prof.stop()
    assert doc["meta"]["traceId"] == "capture-t1"
    recs = trace.capture_records()
    mine = [r for r in recs if r.trace_id == "capture-t1"]
    names = {r.name for r in mine}
    assert set(HANDLER + WORKER + LAUNCHER + FETCHER) <= names, names
    by_id = {r.span_id: r for r in recs}

    def thread_of(*wanted):
        return {r.thread for r in mine if r.name in wanted}

    handler, worker = thread_of("http.request"), thread_of("query_jobs.run")
    launcher, fetcher = thread_of("kernel.launch"), thread_of("kernel.fetch")
    assert len(handler | worker | launcher | fetcher) == 4
    for r in mine:
        if r.name == "http.request":
            assert r.parent_id == ""
        else:
            assert r.parent_id in by_id, r.name
    parent = {r.name: by_id[r.parent_id].name for r in mine
              if r.parent_id in by_id}
    # the hand-offs: handler -> runner -> batcher -> fetcher
    assert parent["query_jobs.run"] == parent["runner.queue_wait"] \
        == "runner.submit"
    assert parent["kernel.launch"] == parent["batcher.wait"] \
        == "engine.search"
    assert parent["kernel.fetch"] == "kernel.launch"
    assert parent["runner.submit"] == "api.handle"
    assert parent["api.handle"] == "http.request"
    # the job table's lock, waited for on the handler's thread and on
    # the worker's
    locks = {by_id[r.parent_id].name for r in mine if r.name == "jobs.lock"}
    assert "runner.submit" in locks and "query_jobs.run" in locks, locks
    # the runner's hand-off: done before the handler's await ended
    qid = next(r.notes["query_id"] for r in mine if r.name == "runner.await")
    done = [r for r in mine if r.name == "runner.done"]
    assert done and done[0].notes["query_id"] == qid
    wait = next(r for r in mine if r.name == "runner.await")
    assert done[0].end <= wait.end
    http_span = next(r for r in mine if r.name == "http.request")
    assert all(http_span.start <= r.start and r.end <= http_span.end
               for r in mine if r.thread in handler)
    assert all(r.cpu_s >= 0 and r.end >= r.start for r in recs)
    # the capture's ranges: one sbeacon.<name> for each span with both
    # ends taken by the span itself
    ranges = {e.name for e in prof.events()}
    for name in names - NO_RANGE:
        assert trace.RANGE_PREFIX + name in ranges, name
    gcs = [r for r in recs if r.name == "host.gc"]
    assert any(r.notes["generation"] == 2 for r in gcs)
    assert all(r.trace_id == "" for r in gcs)


def test_the_log_outlives_the_app_and_clears_on_the_next_capture(served):
    port, shard, app = served
    prof = _capture()
    prof.start()
    try:
        _ask(port, shard, 300, trace_id="capture-t2")
        _settle(app)
    finally:
        prof.stop()
    app.close()
    kept = [r for r in trace.capture_records() if r.trace_id == "capture-t2"]
    assert kept and trace.capture_records() == trace.capture_records()
    # a capture in which nothing of the program runs: the old records go
    prof = _capture()
    prof.start()
    try:
        with trace.span("kernel.launch"):
            pass
    finally:
        prof.stop()
    assert [r.name for r in trace.capture_records()] == ["kernel.launch"]


def test_capture_records_clips_to_the_window():
    prof = _capture()
    prof.start()
    try:
        trace.record("a", 10.0, 20.0)
        trace.record("b", 30.0, 40.0)
        trace.instant("c")
    finally:
        prof.stop()
    names = [r.name for r in trace.capture_records(15.0, 25.0)]
    assert names == ["a"]
    assert [r.name for r in trace.capture_records(20.0, 30.0)] == ["a", "b"]


def test_the_log_holds_nothing_the_collector_walks():
    """Every record is a tuple of atomic values, which the collector
    stops tracking once it has seen it: a traced window's log (about
    1e5 records) adds nothing to each later collection's walk."""
    prof = _capture()
    prof.start()
    try:
        for i in range(200):
            with trace.span("jobs.start", query_id="q") as sp:
                sp.note(n=i)
            trace.record("batcher.wait", 0.0, 1.0, query_id="q")
            trace.instant("runner.done", query_id="q")
        gc.collect()
    finally:
        prof.stop()
    gc.collect()
    assert len(trace._capture.log) >= 600
    assert not any(gc.is_tracked(r) for r in trace._capture.log)
    notes = [r.notes for r in trace.capture_records()
             if r.name == "jobs.start"]
    assert notes[:2] == [{"query_id": "q", "n": 0}, {"query_id": "q", "n": 1}]


def test_a_recorded_span_costs_no_state_when_off():
    """Off: the null object, no stack, no record; an explicit record or
    an instant is dropped."""
    before = trace.capture_records()
    with trace.span("x") as sp:
        sp.note(k=1)
        assert trace.current_span_id() == ""
    trace.record("y", 0.0, 1.0)
    trace.instant("z")
    assert trace.capture_records() == before
    assert "x" not in trace.tracer.stats


def test_tracer_enable_records_stats_but_no_capture_log():
    before = trace.capture_records()
    trace.tracer.enable()
    try:
        with trace.span("only.stats"):
            inner = trace.current_span_id()
            assert inner
    finally:
        trace.tracer.disable()
    assert trace.tracer.stats["only.stats"][0] >= 1
    assert trace.capture_records() == before
    trace.tracer.reset()


def test_process_capture_exports_the_ranges(tmp_path):
    """``SBEACON_PROFILE``'s capture (``telemetry._Profiler``): a span
    on another thread lands in the exported Chrome trace as a
    ``sbeacon.`` range."""
    prof = telemetry._Profiler(str(tmp_path))
    assert prof.pending and prof.start() and not prof.pending

    def launch():
        with trace.span("kernel.launch"):
            torch.ones(64).sum()

    t = threading.Thread(target=launch)
    t.start()
    t.join()
    path = prof.stop()
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sbeacon.kernel.launch" for e in evs)
    assert "kernel.launch" in {r.name for r in trace.capture_records()}


def test_process_capture_starts_at_the_first_launch(served, tmp_path,
                                                    monkeypatch):
    """An armed ``SBEACON_PROFILE`` capture waits for the batcher's first
    kernel launch: serving starts outside it, and the launch that
    starts it is in the export."""
    from sbeacon_tpu_torch import serving

    port, shard, app = served
    prof = telemetry._Profiler(str(tmp_path))
    monkeypatch.setattr(serving, "profiler", prof)
    assert prof.pending
    try:
        _ask(port, shard, 400)
        _settle(app)
        assert not prof.pending
    finally:
        path = prof.stop()
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sbeacon.kernel.launch" for e in evs)


def _interpolated_median(buckets: dict) -> float:
    les = list(buckets)
    n = buckets["+Inf"]
    half, lo, below = n / 2, 0.0, 0
    for le in les:
        c = buckets[le]
        if c >= half:
            return lo + (float(le) - lo) * (half - below) / (c - below)
        lo, below = float(le), c
    raise AssertionError("no median")


@pytest.mark.parametrize("scale_ms", [3.0, 120.0, 900.0])
def test_runner_wait_buckets_hold_the_median_within_a_bucket(scale_ms):
    bounds = RUNNER_WAIT_BUCKETS_MS
    assert bounds[0] == 0.5 and bounds[-1] == 10000.0
    assert all(b / a <= 1.25 for a, b in zip(bounds, bounds[1:]))
    reg = telemetry.MetricsRegistry()
    h = reg.histogram("runner.queue_wait_ms", "", buckets=bounds)
    rng = np.random.default_rng(7)
    sample = rng.lognormal(np.log(scale_ms), 0.8, 4001)
    for v in sample:
        h.observe(float(v))
    got = _interpolated_median(h.collect()[""]["buckets"])
    true = float(np.median(sample))
    i = int(np.searchsorted(bounds, true))
    lo = bounds[i - 1] if i else 0.0
    width = bounds[i] - lo
    assert abs(got - true) <= width
    assert abs(got - true) / true <= 0.25
