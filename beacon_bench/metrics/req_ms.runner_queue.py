"""The async runner's queue: the seconds of the program's
``runner.queue_wait`` spans (a query job's submit to the start of its
execution on the runner's pool) inside the window, per completed
request, in ms."""

from beacon_bench.lib.program_spans import span_ms_per_req


def read(w):
    return span_ms_per_req(w, "runner.queue_wait")
