"""The job table's lock on the critical path: the program's
``jobs.lock`` spans (waits for ``QueryJobTable``'s lock) made on a
request's handler thread, inside its ``http.request`` span, within the
window, per completed request, in ms."""

from beacon_bench.lib.program_spans import handler_lock_ms_per_req


def read(w):
    return handler_lock_ms_per_req(w)
