"""The server's share of a request's latency: the seconds of the
program's ``http.request`` spans (the HTTP handler, from the parsed
request to the last byte written) inside the window, per request
completed in it, in ms. Read from the program's capture log
(``lib/program_spans.py``)."""

from beacon_bench.lib.program_spans import span_ms_per_req


def read(w):
    return span_ms_per_req(w, "http.request")
