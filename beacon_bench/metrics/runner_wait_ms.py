"""Median wait of a query job from its submit to the start of its
execution on the async runner's pool (``query_jobs.AsyncQueryRunner``),
over the window: the ``runner.queue_wait_ms`` histogram's bucket counts
differenced across the window, the median interpolated within its
bucket."""

from beacon_bench.lib.readers import runner_wait_ms


def read(w):
    return runner_wait_ms(w)
