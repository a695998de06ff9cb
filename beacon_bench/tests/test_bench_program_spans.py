"""The readers of the program's spans (``lib/program_spans.py``) on a
synthetic capture log with known answers, and a traced run of the cell
at a tiny size on the CPU that reports all seven."""

from collections import namedtuple

import pytest

from beacon_bench.lib import program_spans as ps
from beacon_bench.lib import readers
from beacon_bench.tests.tiny import tiny_cell, tiny_run

Rec = namedtuple("Rec", "name trace_id span_id parent_id start end cpu_s "
                        "thread notes")
NEW = ("req_ms.server", "req_ms.gc", "req_ms.runner_queue", "req_ms.wake",
       "req_ms.jobs_lock", "runner_oncpu_pct", "req_ms.batcher_wait")


def rec(name, start, end, *, thread=1, cpu_s=0.0, **notes):
    return Rec(name, "t", "s", "", start, end, cpu_s, thread, notes or None)


def window(recs, completed=2, t0=10.0, t1=20.0):
    """A window [10, 20] s whose capture log is ``recs``."""
    w = readers.Window({"t": t0}, {"t": t1}, completed, t1 - t0)
    w._program_spans = recs
    return w


def test_spans_are_clipped_to_the_window():
    w = window([
        rec("http.request", 9.0, 11.0),    # 1 s inside
        rec("http.request", 12.0, 13.5),   # 1.5 s
        rec("http.request", 19.5, 22.0),   # 0.5 s
        rec("runner.queue_wait", 8.0, 9.0),  # outside
        rec("batcher.wait", 15.0, 15.25),
    ])
    assert ps.span_ms_per_req(w, "http.request") == pytest.approx(
        3000.0 / 2)
    assert ps.span_ms_per_req(w, "runner.queue_wait") == 0.0
    assert ps.span_ms_per_req(w, "batcher.wait") == pytest.approx(125.0)


def test_gc_pauses_charge_every_request_they_overlap():
    w = window([
        rec("http.request", 11.0, 13.0, thread=1),
        rec("http.request", 12.0, 16.0, thread=2),
        rec("http.request", 9.0, 10.5, thread=3),
        rec("host.gc", 12.5, 12.75, generation=2),  # in requests 1 and 2
        rec("host.gc", 15.9, 16.2, generation=0),   # 0.1 s in request 2
        rec("host.gc", 9.5, 10.2, generation=1),    # 0.2 s in the window
        rec("host.gc", 17.0, 17.5, generation=0),   # in no request
    ])
    # 0.25 + 0.25 + 0.1 + 0.2 s over 2 requests
    assert ps.gc_ms_per_req(w) == pytest.approx(800.0 / 2)


def test_cover_of_a_union():
    c = ps._Cover([(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)])
    assert c.inside(0.0, 10.0) == pytest.approx(3.0)
    assert c.inside(2.5, 5.5) == pytest.approx(1.0)
    assert c.inside(3.0, 5.0) == 0.0
    assert c.inside(1.2, 1.4) == pytest.approx(0.2)


def test_wake_joins_each_await_to_its_jobs_done():
    w = window([
        rec("runner.done", 12.0, 12.0, query_id="a"),
        rec("runner.await", 11.0, 12.3, query_id="a"),   # 0.3 s
        rec("runner.await", 11.5, 12.1, query_id="a"),   # a follower: 0.1
        # an older done of the same query id, and a hit that waited for
        # a job done long before: from the await's start
        rec("runner.done", 5.0, 5.0, query_id="b"),
        rec("runner.await", 14.0, 14.05, query_id="b"),  # 0.05 s
        # no done for this one (the job is still running at the end)
        rec("runner.await", 19.0, 20.5, query_id="c"),
        # the latest done before the await's end wins
        rec("runner.done", 15.0, 15.0, query_id="d"),
        rec("runner.done", 16.0, 16.0, query_id="d"),
        rec("runner.await", 14.0, 16.5, query_id="d"),   # 0.5 s
        rec("runner.done", 19.8, 19.8, query_id="e"),
        rec("runner.await", 19.0, 21.0, query_id="e"),   # 0.2 s inside
    ])
    assert ps.wake_ms_per_req(w) == pytest.approx(1150.0 / 2)


def test_jobs_lock_counts_only_waits_under_a_handler():
    w = window([
        rec("http.request", 11.0, 13.0, thread=1),
        rec("jobs.lock", 11.5, 11.7, thread=1),   # a handler's: 0.2 s
        rec("jobs.lock", 11.5, 12.5, thread=2),   # a worker's
        rec("http.request", 14.0, 15.0, thread=2),
        rec("jobs.lock", 15.5, 15.6, thread=2),   # after its request
        rec("jobs.lock", 14.2, 14.3, thread=2),   # inside it: 0.1 s
    ])
    assert ps.handler_lock_ms_per_req(w) == pytest.approx(300.0 / 2)


def test_oncpu_share_is_cpu_over_wall():
    w = window([
        rec("query_jobs.run", 11.0, 12.0, cpu_s=0.25),
        rec("query_jobs.run", 19.0, 21.0, cpu_s=1.0),  # half inside
        rec("query_jobs.run", 5.0, 6.0, cpu_s=1.0),    # outside
    ])
    # (0.25 + 0.5) / (1 + 1)
    assert ps.oncpu_pct(w, "query_jobs.run") == pytest.approx(37.5)


def test_nothing_to_read_reads_none():
    empty = window(None)
    for name in NEW:
        mod = _reader(name)
        assert mod.read(empty) is None
    assert ps.oncpu_pct(window([rec("http.request", 11.0, 12.0)]),
                        "query_jobs.run") is None
    assert ps.span_ms_per_req(window([rec("http.request", 11.0, 12.0)],
                                     completed=0), "http.request") is None


def test_a_program_without_the_log_reads_none(monkeypatch):
    from sbeacon_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "capture_records")
    w = readers.Window({"t": 0.0}, {"t": 1.0}, 5, 1.0)
    assert all(_reader(name).read(w) is None for name in NEW)


def _reader(name):
    from beacon_bench import run as R

    return R.load_reader(R.HERE, name)


def test_traced_run_reports_the_program_spans():
    res = tiny_run(tiny_cell("g1k_gt.variants"), trace=True)
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert all(res["metrics"][k]["unit"] == ("%" if k.endswith("_pct")
                                             else "ms") for k in NEW)
    assert m["req_ms.server"] > 0 and 0 < m["runner_oncpu_pct"] <= 100
    assert all(m[k] >= 0 for k in NEW)
    assert m["req_ms.runner_queue"] + m["req_ms.wake"] <= m["req_ms.server"]
    assert m["req_ms.batcher_wait"] <= m["req_ms.server"]
