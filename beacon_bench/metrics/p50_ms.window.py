"""The median client-clock latency, send to last byte, of every request
sent in the window. Per layer, not end to end: in a closed loop it is
the throughput's mirror, and as noisy (PERF.md)."""

from beacon_bench.lib.readers import latency_ms


def read(w):
    return latency_ms(w, 0.50)
