"""The trace reduction and the device metrics on a synthetic trace."""

from types import SimpleNamespace

import pytest

from beacon_bench.lib import probe, readers


def ev(name, start, end, cuda=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if cuda else "DeviceType.CPU")


def synthetic():
    """A 1 s window (us clock 1e6..2e6): kernels of 100 us and 50 us, a
    copy overlapping the second, a kernel before the window (left out),
    and the span annotations on both timelines."""
    return SimpleNamespace(events=lambda: [
        ev(probe.WINDOW, 1_000_000, 2_000_000),
        ev("void (anonymous namespace)::scatter_match_kernel<true, 2>(int)",
           1_100_000, 1_100_100, cuda=True),
        ev("bisect_query_kernel(int const*)", 1_500_000, 1_500_050,
           cuda=True),
        ev("Memcpy DtoH (Device -> Pinned)", 1_500_040, 1_500_080,
           cuda=True),
        ev("scatter_match_kernel<false, 0>", 900_000, 900_100, cuda=True),
        ev("batcher.launch", 1_099_000, 1_100_050),
        ev("batcher.launch", 1_099_000, 1_100_050, cuda=True),
        ev("runner.persist", 1_200_000, 1_900_000),
    ])


def test_reduce_trace_keeps_the_window_and_device_work():
    red = probe.reduce_trace(synthetic())
    assert red["window_s"] == pytest.approx(1.0)
    # union: 100 us + (1_500_000..1_500_080) 80 us
    assert red["busy_s"] == pytest.approx(180e-6)
    assert red["kernel_launches"]["scatter_match_kernel"] == 1
    assert red["device_s_by_name"]["bisect_query_kernel"] == pytest.approx(
        50e-6)
    assert "batcher.launch" not in red["device_s_by_name"]
    assert {s[0] for s in red["spans"]} == {"batcher.launch",
                                           "runner.persist"}


def test_device_idle_pct_and_gaps():
    red = probe.reduce_trace(synthetic())
    w = readers.Window({}, {}, 10, 1.0)
    w.trace, w.window_s = red, red["window_s"]
    assert readers.device_idle_pct(w) == pytest.approx(100 * (1 - 180e-6))
    gaps = dict(probe.idle_gaps(red))
    # the gaps 1.1001..1.5 s and 1.50008..2 s have runner.persist open
    # at their midpoints; the gap before the first kernel has no span
    assert gaps["runner.persist"] == pytest.approx(0.3999 + 0.49992)
    assert gaps["none"] == pytest.approx(0.1)
    assert sum(gaps.values()) == pytest.approx(1.0 - 180e-6, abs=1e-6)


def test_no_device_work_reads_nothing():
    red = probe.reduce_trace(SimpleNamespace(events=lambda: [
        ev(probe.WINDOW, 0, 1_000_000)]))
    w = readers.Window({}, {}, 10, 1.0)
    w.trace, w.window_s = red, red["window_s"]
    assert readers.device_idle_pct(w) is None
    assert readers.roofline_pct(w, "scatter_match") is None


def test_roofline_share_is_mean_bound_over_mean_time():
    red = probe.reduce_trace(synthetic())
    w = readers.Window({}, {}, 10, 1.0)
    w.trace, w.window_s = red, red["window_s"]
    w.bounds = {"scatter_match": [(1e-6, "bytes"), (3e-6, "operations"),
                                  (2e-6, "bytes")]}
    share, by = readers.roofline_pct(w, "scatter_match")
    assert share == pytest.approx(100 * 2e-6 / 100e-6)
    assert by == "bytes"


def test_runner_wait_median_from_buckets():
    before = {"buckets": {"10": 2, "100": 2, "1000": 2, "+Inf": 2}}
    after = {"buckets": {"10": 2, "100": 6, "1000": 12, "+Inf": 12}}
    # 10 new: 4 in (10, 100], 6 in (100, 1000]; the 5th lies in the
    # second bucket, one sixth of the way
    assert readers.hist_median(before, after) == pytest.approx(
        100 + 900 * (5 - 4) / 6)
