"""Queries the micro-batcher (``serving.MicroBatcher``) hands to one
batched launch call, over the window: the difference of its
``occupancy()`` ``specs`` over that of its ``launches``."""

from beacon_bench.lib.readers import queries_per_launch


def read(w):
    return queries_per_launch(w)
