"""Correct 200 answers completed in the window, over its seconds: the
server's throughput under the cell's closed loop, as its clients see it.
Per layer, not end to end: on the card's host it spreads by more than
half of the largest bound the benchmark may set (PERF.md)."""

from beacon_bench.lib.readers import requests_per_s


def read(w):
    return requests_per_s(w)
