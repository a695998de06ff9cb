"""The 95th percentile of the client-clock latency, send to last byte,
of every request sent in the window. Per layer, not end to end: on the
card's host it spreads by more than half of the largest bound the
benchmark may set (PERF.md)."""

from beacon_bench.lib.readers import latency_ms


def read(w):
    return latency_ms(w, 0.95)
