"""The collector's pauses a request sat through: per completed request,
the program's ``host.gc`` spans (each collection, from its
``gc.callbacks`` hook) that overlap the request's ``http.request``
span inside the window, in ms. One pause stops every request in
flight, so each is charged all of it."""

from beacon_bench.lib.program_spans import gc_ms_per_req


def read(w):
    return gc_ms_per_req(w)
