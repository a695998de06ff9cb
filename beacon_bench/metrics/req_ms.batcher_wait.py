"""The micro-batcher's queue: the seconds of the program's
``batcher.wait`` spans (a submission's submit to its batch's launch,
the wait for a pipeline slot included) inside the window, per
completed request, in ms."""

from beacon_bench.lib.program_spans import span_ms_per_req


def read(w):
    return span_ms_per_req(w, "batcher.wait")
